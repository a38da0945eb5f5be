#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (multigrid_petsc_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero):
  1. build the CUDA kernels from the package's csrc/ and name the card;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the 8193^2 / 11-level main path, with times;
  3. the whole solve on the card against the same solve on the CPU
     (plain versions) at 1025^2 / 8 levels;
  4. the main path: the 8193^2 / 11-level f32 mg-CG solve on the card,
     with launch counts, error norms and ms per iteration.
The last line is the result object; with no CUDA device the script exits
non-zero without printing it.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

TOL_ARRAY = 1e-5  # max|kernel - plain| <= TOL_ARRAY * max|plain|
TOL_DOT = 1e-4    # relative, on each inner product
REPS = 10


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median over REPS runs of fn, timed with CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name, got, want, record):
    """Assert kernel outputs against plain outputs; track the worst error."""
    if isinstance(want, torch.Tensor) and want.dim() == 0:
        err = abs(float(got) - float(want))
        lim = TOL_DOT * abs(float(want))
    else:
        err = float((got - want).abs().max())
        lim = TOL_ARRAY * float(want.abs().max())
    print(f"  {name}: max|kernel - plain| = {err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"({err:.3e} > {lim:.3e})")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)


def phase_kernels(torch, dev):
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk
    from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.coarse import dense_from_stencil
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(1234)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    def st_of(n):
        return stencil_coefficients(MeshType.UNIFORM, n, n, f32, dev)

    steps = jacobi_step_coeffs(3, 0.8)
    rec = {k: {} for k in ("cg_papply_u", "cg_visit_down", "visit_down",
                           "visit_up", "coarse_tree")}

    def timed(key, n, nbytes, kern, plain):
        ms, pms = time_ms(torch, kern), time_ms(torch, plain)
        print(f"  {key} {n}^2: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
              f"GB/s effective), plain {pms:.4f} ms")
        if "ms" not in rec[key]:  # the first timing is the largest shape
            rec[key].update(ms=ms, plain_ms=pms)

    n = 8191
    st = st_of(n)
    z, p, u, r, ap = (rnd(n, n) for _ in range(5))
    a_prev = torch.tensor(0.21, device=dev)
    beta = torch.tensor(0.43, device=dev)
    alpha = torch.tensor(0.37, device=dev)
    print(f"K1 cg_papply_u at {n}^2")
    got = mdma.cg_papply_u(st, z, p, u, a_prev, beta)
    want = mdma.cg_papply_u_plain(st, z, p, u, a_prev, beta)
    for nm, g, w in zip(("p'", "Ap'", "u'", "<p',Ap'>"), got, want):
        compare(torch, nm, g, w, rec["cg_papply_u"])
    timed("cg_papply_u", n, 6 * n * n * 4,
          lambda: mdma.cg_papply_u(st, z, p, u, a_prev, beta),
          lambda: mdma.cg_papply_u_plain(st, z, p, u, a_prev, beta))

    print(f"K2a cg_visit_down at {n}^2")
    got = mdma.cg_visit_down(st, r, ap, alpha, steps)
    want = mdma.cg_visit_down_plain(st, r, ap, alpha, steps)
    for nm, g, w in zip(("u0", "rc", "r'", "||r'||^2"), got, want):
        compare(torch, nm, g, w, rec["cg_visit_down"])
    timed("cg_visit_down", n, 4.25 * n * n * 4,
          lambda: mdma.cg_visit_down(st, r, ap, alpha, steps),
          lambda: mdma.cg_visit_down_plain(st, r, ap, alpha, steps))
    del z, p, ap

    for n in (8191, 4095, 2047):
        st = st_of(n)
        b, u = (r, rnd(n, n)) if n == 8191 else (rnd(n, n), rnd(n, n))
        e = rnd((n - 1) // 2, (n - 1) // 2)
        if n != 8191:
            print(f"K2b visit_down at {n}^2")
            got = mdma.visit_down(st, b, steps)
            want = mdma.visit_down_plain(st, b, steps)
            for nm, g, w in zip(("u0", "rc"), got, want):
                compare(torch, nm, g, w, rec["visit_down"])
            timed("visit_down", n, 2.25 * n * n * 4,
                  lambda: mdma.visit_down(st, b, steps),
                  lambda: mdma.visit_down_plain(st, b, steps))
        for emit_dot in (True, False):
            print(f"K3 visit_up at {n}^2, emit_dot={emit_dot}")
            got = mdma.visit_up(st, b, u, e, steps, emit_dot)
            want = mdma.visit_up_plain(st, b, u, e, steps, emit_dot)
            if not emit_dot:
                got, want = (got,), (want,)
            for nm, g, w in zip(("z", "<b,z>"), got, want):
                compare(torch, nm, g, w, rec["visit_up"])
            if emit_dot or n != 8191:
                timed("visit_up", n, 3.25 * n * n * 4,
                      lambda: mdma.visit_up(st, b, u, e, steps, emit_dot),
                      lambda: mdma.visit_up_plain(st, b, u, e, steps,
                                                  emit_dot))
    del r, b, u, e

    shapes = [(n, n) for n in (1023, 511, 255, 127, 63, 31, 15, 7)]
    sts = [st_of(s[0]) for s in shapes]
    steps_list = [jacobi_step_coeffs(3, 0.8)] * len(shapes)
    a_inv = np.linalg.inv(dense_from_stencil(sts[-1], 7, 7))
    solver = ctk.make_coarse_tree_solver(sts, shapes, steps_list, a_inv)
    a_inv_t = torch.as_tensor(a_inv, dtype=f32, device=dev)
    b = rnd(1023, 1023)
    print("K4 coarse_tree 1023^2 -> 7^2")
    compare(torch, "u", solver(b),
            ctk.coarse_tree_plain(sts, steps_list, a_inv_t, b),
            rec["coarse_tree"])
    timed("coarse_tree", 1023, 2 * 1023 * 1023 * 4, lambda: solver(b),
          lambda: ctk.coarse_tree_plain(sts, steps_list, a_inv_t, b))
    return rec


def phase_parity(torch):
    import numpy as np

    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    cfg = SolverConfig(npts=1025, grids=8, levels=8, cycle=CycleType.MGCG,
                       dtype="float32", rtol=1e-5, max_iter=100)
    g = solve(cfg, device="cuda")
    c = solve(cfg, device="cpu")
    err = float(np.abs(g.u_fine - c.u_fine).max() / np.abs(c.u_fine).max())
    print(f"parity 1025^2/8: iters cuda {g.iters} cpu {c.iters}; rnorm cuda "
          f"{g.rnorm.tolist()} cpu {c.rnorm.tolist()}; max|du|/max|u| "
          f"{err:.3e}; paths {g.path}/{c.path}")
    assert g.path == "cuda" and c.path == "torch"
    assert g.converged and c.converged
    assert g.iters == c.iters
    # rtol 0.05, plus an absolute floor for the entries near the f32
    # roundoff floor of the recursive residual: at 1023^2 the stencil's
    # 4/h^2 ~ 4e6 terms cancel to O(|b|), so each A p carries ~1e-2
    # relative f32 noise, and the card's FMA rounding differs from the
    # CPU's (measured: 1.76e-5 vs 1.58e-5 at the 4th entry, H100).
    np.testing.assert_allclose(g.rnorm, c.rnorm, rtol=0.05, atol=5e-6)
    assert err <= 1e-3


def phase_main(torch):
    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import launches
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    cfg = SolverConfig(npts=8193, grids=11, levels=11, cycle=CycleType.MGCG,
                       dtype="float32", rtol=1e-5, max_iter=100)
    launches.clear()
    res = solve(cfg, device="cuda", timed=True)  # the solve runs twice
    counts = dict(launches)
    precs = 2 * (res.iters + 1)
    print(f"main path 8193^2/11 levels: iters {res.iters}, converged "
          f"{res.converged}, path {res.path}, wall {res.wall_time:.6f} s")
    print(f"  residual history {res.rnorm.tolist()}")
    print(f"  launches {counts} over {precs} preconditioner applications")
    assert res.converged and res.path == "cuda"
    assert np.all(np.isfinite(res.rnorm)) and res.u.shape == (8191, 8191)
    assert bool(torch.isfinite(res.u).all())
    for k in ("cg_papply_u", "cg_visit_down", "visit_down", "visit_up",
              "coarse_tree"):
        assert counts.get(k, 0) > 0, f"kernel {k} never launched"
    assert counts["coarse_tree"] == precs == counts["cg_visit_down"]
    assert abs(res.iters - 5) <= 1, f"{res.iters} iterations, expected 5 +- 1"
    errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u)
    print("  error vs exact (max, L1, L2): "
          + " ".join(f"{e:.6e}" for e in errs))

    # Device ms per iteration by differencing forced-length runs (the
    # bench.py method): the difference cancels the fixed per-solve costs.
    forced = dataclasses.replace(cfg, rtol=1e-30, divtol=1e30)
    est = max(res.wall_time / max(res.iters, 1), 1e-6)
    k1 = 3
    k2 = k1 + min(200, max(10, int(0.25 / est)))
    pairs = []
    for _ in range(3):
        t1 = solve(dataclasses.replace(forced, max_iter=k1), device="cuda",
                   timed=True).wall_time
        t2 = solve(dataclasses.replace(forced, max_iter=k2), device="cuda",
                   timed=True).wall_time
        pairs.append((t2 - t1) / (k2 - k1))
    ms = 1e3 * statistics.median(pairs)
    print(f"  ms per iteration (median of 3 differenced pairs, {k1} vs {k2} "
          f"iterations): {ms:.4f}; samples "
          f"{[round(1e3 * p, 4) for p in pairs]}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from multigrid_petsc_tpu_torch.ops.cuda._build import BUILD_DIR, load_library

    t0 = time.perf_counter()
    load_library()
    print(f"build + load of the CUDA kernels: {time.perf_counter() - t0:.2f} s")
    log = BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas: " + line.strip())
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {nvidia_smi_line()}")

    rec = phase_kernels(torch, dev)
    phase_parity(torch)
    counts = phase_main(torch)

    src = "multigrid_petsc_tpu_torch/csrc/"
    tpu = "multigrid_petsc_tpu/ops/pallas/"
    meta = {
        "cg_papply_u": ("visit.cu", "mdma_kernel.py:973"),
        "cg_visit_down": ("visit.cu", "mdma_kernel.py:471"),
        "visit_down": ("visit.cu", "mdma_kernel.py:628"),
        "visit_up": ("visit.cu", "mdma_kernel.py:796"),
        "coarse_tree": ("coarse_tree.cu", "coarse_tree_kernel.py:92"),
    }
    kernels = [{"name": k, "route": "cuda", "source": src + s,
                "replaces": tpu + r, "launches": counts[k],
                "max_abs_err": rec[k]["max_abs_err"], "ms": rec[k]["ms"],
                "plain_ms": rec[k]["plain_ms"]}
               for k, (s, r) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

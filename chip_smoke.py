#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (multigrid_petsc_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero):
  1. build the CUDA kernels from the package's csrc/ and name the card;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the 8193^2 / 11-level paths, with times: the mg-CG kernels
     K1-K4, then K6, K7 (Jacobi and Chebyshev) and K9 in each mode the
     V-cycle family uses, and a k = 8 visit;
  3. whole solves on the card against the same solves on the CPU (plain
     versions) at 1025^2 / 8 levels: mg-CG (Jacobi and Chebyshev), the
     V-cycle (Jacobi, Chebyshev, v = 8,8), MG-Richardson, FMG, Additive;
  4. the mg-CG path: the 8193^2 / 11-level f32 solve on the card, with
     launch counts, error norms and ms per iteration;
  5. the V-cycle family at 8193^2 / 11 levels, f32: V-cycle, FMG, the
     Chebyshev V-cycle, MG-Richardson, Additive, and the 3-level V-cycle
     that smooths its 2047^2 coarsest level (K7), each with launch
     counts, error norms and ms per iteration.
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


def phase_kernels_vcycle(torch, dev, rec):
    """K6, K7 and K9 (every mode of the V-cycle family) at 8191^2."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.smoothers import (
        chebyshev_step_coeffs,
        jacobi_step_coeffs,
    )

    gen = torch.Generator(device=dev).manual_seed(4321)
    n = 8191
    arr = n * n * 4  # bytes of one f32 level-0 array
    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, dev)
    b, u = (torch.randn((n, n), generator=gen, device=dev) for _ in range(2))
    e = torch.randn(((n - 1) // 2, (n - 1) // 2), generator=gen, device=dev)
    for key in ("apply_stencil5", "residual5", "smooth_sweeps",
                "fused_level_visit"):
        rec[key] = {}

    def check(key, label, nbytes, kern, plain, names):
        print(f"{label} at {n}^2")
        got, want = kern(), plain()
        if not isinstance(want, tuple):
            got, want = (got,), (want,)
        for nm, g, w in zip(names, got, want):
            compare(torch, nm, g, w, rec[key])
        ms, pms = time_ms(torch, kern), time_ms(torch, plain)
        print(f"  {label}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s "
              f"effective), plain {pms:.4f} ms")
        if "ms" not in rec[key]:  # the first timing of each kernel is kept
            rec[key].update(ms=ms, plain_ms=pms)

    check("apply_stencil5", "K6 apply_stencil5", 2 * arr,
          lambda: sk.apply_stencil5(st, u),
          lambda: sk.apply_stencil5_plain(st, u), ("Au",))
    jac = jacobi_step_coeffs(3, 0.8)
    cheb = chebyshev_step_coeffs(3, 1.9)
    for name, steps in (("Jacobi", jac), ("Chebyshev", cheb)):
        check("smooth_sweeps", f"K7 smooth_sweeps {name} k=3", 3 * arr,
              lambda: sk.smooth_sweeps(st, b, u, steps),
              lambda: sk.smooth_sweeps_plain(st, b, u, steps), ("u'",))
    modes = (  # label, (u, steps, emit, e_coarse), bytes, output names
        ("K9 nonzero-guess rc", (u, jac, "rc", None), 3.25, ("u'", "rc")),
        ("K9 zero-guess rc (K2b)", (None, jac, "rc", None), 2.25,
         ("u'", "rc")),
        ("K9 correct + u (K3)", (u, jac, "u", e), 3.25, ("u'",)),
        ("K9 correct + ur", (u, jac, "ur", e), 4.25, ("u'", "r")),
        ("K9 nonzero-guess rc, k=8", (u, jacobi_step_coeffs(8, 0.8), "rc",
                                      None), 3.25, ("u'", "rc")),
    )
    for label, (u_in, steps, emit, e_c), nb, names in modes:
        check("fused_level_visit", label, nb * arr,
              lambda: sk.fused_level_visit(st, b, u_in, steps, emit, e_c),
              lambda: sk.fused_level_visit_plain(st, b, u_in, steps, emit,
                                                 e_c), names)
    check("residual5", "K9 r (residual5)", 3 * arr,
          lambda: sk.residual5(st, b, u),
          lambda: sk.residual5_plain(st, b, u), ("r",))


def phase_parity(torch):
    """Each cycle on the card against the same cycle on the CPU.  The
    V-cycle family runs a forced count: in f32 its true residual b - A u
    stalls at the roundoff floor (~7.6e-3 relative at 1025^2, the JAX
    package's f32 behaviour too), so it never meets rtol 1e-5."""
    import numpy as np

    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import (
        CycleType,
        SmootherType,
        SolverConfig,
    )

    jac, cheb = SmootherType.JACOBI, SmootherType.CHEBYSHEV
    runs = (  # cycle, smoother, max_iter, extra
        (CycleType.MGCG, jac, 100, {}),
        (CycleType.MGCG, cheb, 100, {}),
        (CycleType.VCYCLE, jac, 6, {}),
        (CycleType.VCYCLE, cheb, 6, {}),
        (CycleType.VCYCLE, jac, 4, {"v": (8, 8)}),
        (CycleType.PCMG, jac, 6, {}),
        (CycleType.FMG, jac, 4, {}),
        (CycleType.ADDITIVE, jac, 6, {}),
    )
    for cycle, smoother, max_iter, extra in runs:
        cfg = SolverConfig(npts=1025, grids=8, levels=8, cycle=cycle,
                           smoother=smoother, dtype="float32", rtol=1e-5,
                           max_iter=max_iter, **extra)
        g = solve(cfg, device="cuda")
        c = solve(cfg, device="cpu")
        err = float(np.abs(g.u_fine - c.u_fine).max()
                    / np.abs(c.u_fine).max())
        print(f"parity 1025^2/8 {cycle.name} {smoother.value} {extra}: "
              f"iters cuda {g.iters} cpu {c.iters}; rnorm cuda "
              f"{g.rnorm.tolist()} cpu {c.rnorm.tolist()}; max|du|/max|u| "
              f"{err:.3e}; paths {g.path}/{c.path}")
        assert g.path == "cuda" and c.path == "torch"
        assert g.converged == c.converged
        assert cycle != CycleType.MGCG or g.converged
        assert g.iters == c.iters
        # rtol 0.05, plus an absolute floor for the entries near the f32
        # roundoff floor of the residual: at 1023^2 the stencil's 4/h^2
        # ~ 4e6 terms cancel to O(|b|), so each A u carries ~1e-2
        # relative f32 noise, and the card's FMA rounding differs from
        # the CPU's (measured: 1.76e-5 vs 1.58e-5 at the 4th entry of
        # mg-CG, H100).
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
    ms_per_iteration(res, cfg)
    return counts, res.u


def ms_per_iteration(res, cfg):
    """Device ms per outer iteration by differencing forced-length runs on
    one context (bench.py's method): the difference cancels the fixed
    per-solve costs (FMG's start, the first residual)."""
    from multigrid_petsc_tpu_torch.solvers.solve import solve

    forced = dataclasses.replace(cfg, rtol=1e-30, divtol=1e30)
    est = max(res.wall_time / max(res.iters, 1), 1e-6)
    k1 = 3
    k2 = k1 + min(200, max(10, int(0.25 / est)))
    pairs = []
    for _ in range(3):
        t = [solve(forced, ctx=dataclasses.replace(
                 res.ctx, config=dataclasses.replace(forced, max_iter=k)),
                 device="cuda", timed=True).wall_time for k in (k1, k2)]
        pairs.append((t[1] - t[0]) / (k2 - k1))
    ms = 1e3 * statistics.median(pairs)
    print(f"  ms per iteration (median of 3 differenced pairs, {k1} vs {k2} "
          f"iterations): {ms:.4f}; samples "
          f"{[round(1e3 * p, 4) for p in pairs]}")


def phase_vcycle(torch, u_ref):
    """The V-cycle family at full width.  Expected iterations are the JAX
    package's own for these f32 configs (backend="xla" on the CPU): at
    1025^2, 2049^2 and 4097^2 every one of them stalls at the f32 floor of
    its true residual (7.6e-3, 3.0e-2, 1.2e-1 relative for the V-cycle,
    growing 4x per doubling) and runs to max_iter, as FMG did at 8193^2 on
    the TPU (0.986 after 8 cycles, benchmarks/results/baseline_r02.json).
    So the count is max_iter here, and correctness is read from the
    solution of every cycle that converges in the forced count: within
    1e-2 of the exact solution in the max norm.  That is the f32
    attainable accuracy at this size with room (the converged mg-CG
    solution of phase 4 is 4.7e-3 from it, H100); an unconverged solve is
    off by O(1).  Additive and the 3-level cycle (slow by design) must
    lower their residual.  Phase 3 holds every one of them against the
    CPU at 1025^2."""
    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import launches
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import (
        CycleType,
        SmootherType,
        SolverConfig,
    )

    visits = {"fused_level_visit", "visit_down", "visit_up", "residual5"}
    runs = (  # label, config changes, expected kernels, near u_ref
        ("V-cycle", {}, visits, True),
        ("FMG", {"cycle": CycleType.FMG}, visits, True),
        ("V-cycle Chebyshev", {"smoother": SmootherType.CHEBYSHEV},
         visits | {"apply_stencil5"}, True),
        ("MG-Richardson", {"cycle": CycleType.PCMG, "max_iter": 5},
         {"visit_down", "visit_up", "residual5"}, True),
        ("Additive", {"cycle": CycleType.ADDITIVE, "max_iter": 5},
         {"smooth_sweeps", "residual5"}, False),
        ("V-cycle, 3 levels, smoothed 2047^2 coarsest",
         {"grids": 3, "levels": 3, "coarse_solver": "smooth",
          "max_iter": 5},
         visits | {"smooth_sweeps"}, False),
    )
    total = {}
    for label, changes, expect, near in runs:
        cfg = dataclasses.replace(
            SolverConfig(npts=8193, grids=11, levels=11,
                         cycle=CycleType.VCYCLE, dtype="float32", rtol=1e-5,
                         max_iter=10), **changes)
        launches.clear()
        res = solve(cfg, device="cuda")
        counts = dict(launches)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        du = float((res.u - u_ref).abs().max() / u_ref.abs().max())
        print(f"{label} 8193^2/{cfg.levels} levels: iters {res.iters} "
              f"(expected {cfg.max_iter} +- 1), converged {res.converged}, "
              f"path {res.path}, wall {res.wall_time:.6f} s")
        print(f"  residual history {res.rnorm.tolist()}")
        print(f"  launches {counts}")
        print(f"  max|u - u_mgcg|/max|u_mgcg| {du:.3e}")
        errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u)
        print("  error vs exact (max, L1, L2): "
              + " ".join(f"{e:.6e}" for e in errs))
        assert res.path == "cuda" and res.u.shape == (8191, 8191)
        assert np.all(np.isfinite(res.rnorm))
        assert bool(torch.isfinite(res.u).all())
        for k in expect:
            assert counts.get(k, 0) > 0, f"{label}: kernel {k} never launched"
        assert abs(res.iters - cfg.max_iter) <= 1, (
            f"{label}: {res.iters} iterations, expected {cfg.max_iter} +- 1")
        if near:
            assert errs[0] <= 1e-2, f"{label}: max error {errs[0]:.3e}"
        else:  # slow cycles: the residual must still have fallen
            assert res.rnorm[-1] < 1, f"{label}: no descent"
        ms_per_iteration(res, cfg)
    for k in ("apply_stencil5", "smooth_sweeps", "fused_level_visit",
              "residual5"):
        assert total.get(k, 0) > 0, f"kernel {k} never launched in phase 5"
    return total


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
    phase_kernels_vcycle(torch, dev, rec)
    phase_parity(torch)
    counts, u_ref = phase_main(torch)
    vcounts = phase_vcycle(torch, u_ref)
    for k in ("apply_stencil5", "smooth_sweeps", "fused_level_visit",
              "residual5"):
        counts[k] = vcounts[k]

    src = "multigrid_petsc_tpu_torch/csrc/"
    tpu = "multigrid_petsc_tpu/ops/pallas/"
    meta = {  # launches: phase 4 for K1-K4, phase 5 for the others
        "cg_papply_u": ("visit.cu", "mdma_kernel.py:973"),
        "cg_visit_down": ("visit.cu", "mdma_kernel.py:471"),
        "visit_down": ("visit.cu", "mdma_kernel.py:628"),
        "visit_up": ("visit.cu", "mdma_kernel.py:796"),
        "coarse_tree": ("coarse_tree.cu", "coarse_tree_kernel.py:92"),
        "apply_stencil5": ("visit.cu", "stencil_kernel.py:141"),
        "smooth_sweeps": ("visit.cu", "stencil_kernel.py:286"),
        "fused_level_visit": ("visit.cu", "stencil_kernel.py:687"),
        "residual5": ("visit.cu", "stencil_kernel.py:846"),
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

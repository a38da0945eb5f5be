"""Time the 5-point strip visit and K12's strip kernel on one card, each
held to its plain version first; with --ab, A/B a constant of
csrc/visit.cuh in one call.

    python scripts/time_5pt_visits.py [--n 8191] [--cases whole,k17]
    python scripts/time_5pt_visits.py --ab [--variant nopair] [--cases k17]

Cases "whole", at n^2 in f32 (the main path's storage type): K7 (u k = 3
from a guess, Jacobi), K9 nonzero-guess rc k = 3, K3 (correct + u +
<b, u>), K2a (the CG flag set), the zero-guess rc visit (K2b's flag set)
for k = 1, 2, 3, 5, 6, 7 and 8 Jacobi steps (6 and 7: halos 8 and 9, on
either side of the region rule V5_SHORT_MAX_H), and K12 (apply) on a
stencil of nine scalars and on the anisotropic (1,1,1,2,0.4) stencil.
The zero-guess series on the short region (k = 1, 2, 3, 5, 6) is fitted
by least squares as us of device time per tile = once + k * per step
(the tiles follow the halo H = k + 2), which separates what a block pays
once (staging, loads, residual, restriction, stores) from its steps.

Cases "k17", K17's 5-point visit on a block of the n^2 level as the bf16
preconditioner's split levels run it, in bf16 storage and in f32 and f64
beside it: a row block (block 1 of 4, 2048 x 8191 at n = 8191, halo rows cut
from its neighbours) and a 2-D block (block 1 of 2x2, 4096^2, its ring
cut from its neighbours), each for zero-guess rc and correct + u at
k = 3; the bf16 zero-guess rc series k = 1, 2, 3, 5, 6 on both blocks,
fitted as above; and the whole-grid bf16 K2b (zero-guess rc) and K3
(correct + u + <b, u>) at k = 3 beside f32's and f64's.  Every case is held to its
plain version first (bf16: one bf16 ulp of each entry or TOL_ARRAY of
max|plain|) and then timed as device time: 20 launches queued behind a
sleep (``device_ms``), no wrapper host time.  The build's registers and
spills of every bf16 5-point visit instantiation are printed (the
``ptxas`` key).

--ab builds a variant tree of this checkout's package under _archive/ab5/
(listed in .gitignore) with constants of csrc/visit.cuh changed:
  tall      V5_SHORT_MAX_H = 0: every f32 visit on the 128 x 128 region
  nopair    V5_PAIR_MAX_H = 0: every bf16 visit on visit5_kernel's step
  pairs     V5P_NC = 2, V5P_GY = 8, V5P_RS = 8: the bf16 step with two
            columns a thread (a column pair)
  quad8     V5P_GY = 8, V5P_RS = 8: the bf16 step with 8-row strips (256
            threads a block)
and times it against the tree as it is in the order A B B A (one process
per run), then prints one JSON line with every run (card name and power
limit included).  Exits non-zero if a kernel disagrees with its plain
version.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TOL_ARRAY = 1e-5  # max|kernel - plain| <= TOL_ARRAY * max|plain|
REPS = 20
FIT_STEPS = (1, 2, 3, 5, 6)  # halos 3..8: the short region
EDGE_STEPS = (7, 8)
K17_FIT = (1, 2, 3, 5, 6)  # the bf16 zero-guess rc series on K17's blocks
VARIANTS = {  # name: ((constant, value), ...)
    "tall": (("V5_SHORT_MAX_H", "0"),),
    "nopair": (("V5_PAIR_MAX_H", "0"),),
    "pairs": (("V5P_NC", "2"), ("V5P_GY", "8"), ("V5P_RS", "8")),
    "quad8": (("V5P_GY", "8"), ("V5P_RS", "8")),
}
CASES = ("whole", "k17")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def device_ms(torch, fn, n: int = 20) -> float:
    """Device ms per call of ``fn``: ``n`` calls queued behind a sleeping
    kernel, so that the events bracket the kernels' back-to-back run and
    none of the wrappers' host work (chip_smoke.py's ``device_ms``)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10**6)
    probe[1].record()
    probe[1].synchronize()
    cycles_per_ms = 10**6 / probe[0].elapsed_time(probe[1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    cover = 2 * host_ms + 1.0  # ms of sleep ahead of the queued calls
    while len(times) < 3:
        torch.cuda._sleep(int(cycles_per_ms * cover))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if queued_ms < cover:
            times.append(start.elapsed_time(end) / n)
            continue
        # A slow enqueue (the host is shared): the run is not kept, and
        # the next sleeps longer.
        cover *= 2
        if cover > 64 * (2 * host_ms + 1.0):
            raise RuntimeError("the sleep did not cover the queued calls")
    return statistics.median(times)


def ulp_err(got, want) -> float:
    """The worst entry's error as a share of its limit: TOL_ARRAY of
    max|plain| in f32 and f64, one bf16 ulp of the entry (or TOL_ARRAY of
    max|plain|) in bf16.  At most 1 passes."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        lim = TOL_ARRAY * max(float(w.abs().max()), 1e-300)
        if want[0].dtype == torch.bfloat16:
            def ulp(x):
                return torch.exp2(torch.floor(torch.log2(
                    x.abs().clamp_min(1e-30))) - 7)
            lim = torch.maximum(torch.maximum(ulp(g), ulp(w)),
                                torch.full_like(w, lim))
        worst = max(worst, float(((g - w).abs() / lim).max()))
    return worst


def ptxas_bf16(log: str) -> list[str]:
    """Registers and spills of each bf16 5-point visit instantiation, from
    the build's -Xptxas -v output: its flags (GUESS, CORRECT, EMIT, DOT,
    ROWS) and region."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"visit5_kernelI13__nv_bfloat16Lb0ELb(\d)ELb(\d)E"
                          r"Li(\d)ELb(\d)ELb(\d)E\w*?Region5ILi(\d+)E"
                          r"Li(\d+)ELi(\d+)E", m.group(1))
            p = re.search(r"visit5p_kernelI13__nv_bfloat16Lb(\d)ELb(\d)E"
                          r"Li(\d)ELb(\d)ELb(\d)E", m.group(1))
            name = (None if k is None and p is None else
                    "visit5_kernel guess={} correct={} emit={} dot={} "
                    "rows={} Region5<{},{},{}>".format(*k.groups())
                    if k is not None else
                    "visit5p_kernel guess={} correct={} emit={} dot={} "
                    "rows={}".format(*p.groups()))
            continue
        if name is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores", line)
        if sp:
            spill = sp.group(1)
        u = re.search(r"Used (\d+) registers", line)
        if u:
            out.append(f"{name}: {u.group(1)} registers, {spill or 0} B "
                       f"spilled")
            name = spill = None
    return out


def run_k17(n: int) -> dict:
    """The "k17" cases (module docstring)."""
    import numpy as np
    import torch

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import _build
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.parallel.block_ops import cut_halo
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    # The library counts a visit's blocks (mg_visit5_blocks), keyed on
    # the storage type's size: its region follows the halo and the type.
    lib = _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    nxc = (n - 1) // 2
    out, ok = {}, True

    def rows(x, p, P, h):
        """Row block p of P of x (its pad row appended) and its halo rows
        cut from its neighbours (zeros past the edges)."""
        xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        R = xp.shape[0] // P
        z = x.new_zeros((h, x.shape[1]))
        ext = torch.cat([z, xp, z])
        return xp[p * R:(p + 1) * R], dk.Halo(
            ext[p * R:p * R + h].contiguous(),
            ext[h + (p + 1) * R:2 * h + (p + 1) * R].contiguous())

    def case(name, kern, plain, **extra):
        nonlocal ok
        err = ulp_err(kern(), plain())
        ok &= err <= 1.0
        out[name] = {"device_ms": device_ms(torch, kern), "err": err,
                     **extra}
        print(f"  {name}: {out[name]['device_ms']:.4f} ms device, "
              f"{err:.2f} of the limit", file=sys.stderr)

    for dt in (torch.bfloat16, torch.float32, torch.float64):
        tag = {torch.bfloat16: "bf16", torch.float32: "f32",
               torch.float64: "f64"}[dt]
        st = stencil_coefficients(MeshType.UNIFORM, n, n, dt, dev)
        b = torch.randn((n, n), generator=gen, device=dev).to(dt)
        u = torch.randn((n, n), generator=gen, device=dev).to(dt)
        e = torch.randn((nxc, nxc), generator=gen, device=dev).to(dt)
        modes = [("zero-guess rc", False, k, "rc")
                 for k in (K17_FIT if dt == torch.bfloat16 else (3,))]
        modes.append(("correct + u", True, 3, "u"))
        for label, corr, k, emit in modes:
            steps = jacobi_step_coeffs(k, 0.8)
            h = dk.halo_rows(k, emit)
            hc = dk.coarse_halo_rows(h)
            R = (n + 1) // 4
            bb, bh = rows(b, 1, 4, h)
            ub, uh = rows(u, 1, 4, h)
            eb, eh = rows(e, 1, 4, hc)
            kw = dict(row0=R, ny=n, b_halo=bh,
                      u_halo=uh if corr else None,
                      e=eb[:R // 2] if corr else None,
                      e_halo=eh if corr else None)
            args = (st, bb, ub if corr else None, steps, emit)
            tiles = lib.mg_visit5_blocks(R, n, h, dt.itemsize)
            case(f"K17 rows {tag} {label} k={k}",
                 lambda: dk.row_visit(*args, **kw),
                 lambda: dk.row_visit_plain(*args, **kw), tiles=tiles)
            del bb, ub, eb, bh, uh, eh, kw, args
            R2 = (n + 1) // 2
            r0, c0, bb, bh = 0, R2, *cut_halo(b, 0, R2, R2, R2, h)
            _, _, ub, uh = 0, 0, *cut_halo(u, 0, R2, R2, R2, h)
            eb, eh = cut_halo(e, 0, R2 // 2, R2 // 2, R2 // 2, hc)
            kw = dict(row0=r0, col0=c0, ny=n, nx=n, b_halo=bh,
                      u_halo=uh if corr else None,
                      e=eb if corr else None, e_halo=eh if corr else None)
            args = (st, bb, ub if corr else None, steps, emit)
            tiles = lib.mg_visit5_blocks(R2, R2, h, dt.itemsize)
            case(f"K17 2-D {tag} {label} k={k}",
                 lambda: dk.block_visit(*args, **kw),
                 lambda: dk.block_visit_plain(*args, **kw), tiles=tiles)
            del bb, ub, eb, bh, uh, eh, kw, args
        jac3 = jacobi_step_coeffs(3, 0.8)
        case(f"K2b {tag} zero-guess rc k=3",
             lambda: sk.fused_level_visit(st, b, None, jac3, "rc"),
             lambda: sk.fused_level_visit_plain(st, b, None, jac3, "rc"))
        case(f"K3 {tag} correct + u + dot k=3",
             lambda: sk.fused_level_visit(st, b, u, jac3, "u", e, True),
             lambda: sk.fused_level_visit_plain(st, b, u, jac3, "u", e,
                                                True))
        del st, b, u, e
        torch.cuda.empty_cache()
    for mode in ("rows", "2-D"):
        ks = np.array(K17_FIT)
        us = np.array([1e3 * out[f"K17 {mode} bf16 zero-guess rc k={k}"]
                       ["device_ms"] / out[f"K17 {mode} bf16 zero-guess rc "
                                           f"k={k}"]["tiles"] for k in ks])
        per_step, once = np.polyfit(ks, us, 1)
        out[f"fit_us_per_block K17 {mode} bf16"] = {
            "once": float(once), "per_step": float(per_step)}
    log = _build.BUILD_DIR / "build.log"
    out["ptxas"] = ptxas_bf16(log.read_text()) if log.exists() else []
    out["ok"] = bool(ok)
    return out


def run_cases(n: int) -> dict:
    import numpy as np
    import torch

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda._build import load_library
    from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
        stencil_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    def time_ms(fn) -> float:
        for _ in range(3):
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

    def rel_err(got, want) -> float:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return max(float((g.double() - w.double()).abs().max())
                   / max(float(w.double().abs().max()), 1e-300)
                   for g, w in zip(got, want))

    lib = load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(777)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, dev)
    b, u, ap = rnd(n, n), rnd(n, n), rnd(n, n)
    e = rnd((n - 1) // 2, (n - 1) // 2)
    alpha = torch.tensor(0.37, device=dev)
    jac3 = jacobi_step_coeffs(3, 0.8)
    out, ok = {}, True

    def case(name, kern, plain, blocks=None):
        nonlocal ok
        err = rel_err(kern(), plain())
        ok &= err <= TOL_ARRAY
        out[name] = {"ms": time_ms(kern), "err": err}
        if blocks is not None:
            out[name]["blocks"] = blocks

    case("K7 u k=3", lambda: sk.smooth_sweeps(st, b, u, jac3),
         lambda: sk.smooth_sweeps_plain(st, b, u, jac3))
    case("K9 rc k=3", lambda: sk.fused_level_visit(st, b, u, jac3, "rc"),
         lambda: sk.fused_level_visit_plain(st, b, u, jac3, "rc"))
    case("K3 correct + u + dot k=3",
         lambda: mdma.visit_up(st, b, u, e, jac3),
         lambda: mdma.visit_up_plain(st, b, u, e, jac3))
    case("K2a CG rc k=3",
         lambda: mdma.cg_visit_down(st, b, ap, alpha, jac3),
         lambda: mdma.cg_visit_down_plain(st, b, ap, alpha, jac3))
    series = []
    for k in FIT_STEPS + EDGE_STEPS:
        steps = jacobi_step_coeffs(k, 0.8)
        tiles = lib.mg_visit5_blocks(n, n, k + 2, 4)
        case(f"zero-guess rc k={k}",
             lambda: sk.fused_level_visit(st, b, None, steps, "rc"),
             lambda: sk.fused_level_visit_plain(st, b, None, steps, "rc"),
             tiles)
        if k in FIT_STEPS:
            series.append((k, 1e3 * out[f"zero-guess rc k={k}"]["ms"]
                           / tiles))
    ks = np.array([s[0] for s in series])
    us = np.array([s[1] for s in series])
    per_step, once = np.polyfit(ks, us, 1)
    out["fit_us_per_block"] = {"once": float(once),
                               "per_step": float(per_step)}
    del ap, e
    mixed = stencil9_coefficients(AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), n,
                                  n, torch.float32, dev)
    scal = Stencil9(*(x.reshape(-1)[:1].reshape(1, 1) for x in
                      stencil9_coefficients(
                          AnisoProblem(1.0, 0.0, 100.0, 0.0, 0.3), n, n,
                          torch.float32, dev)))
    for name, s9 in (("scalars", scal), ("aniso", mixed)):
        case(f"K12 apply ({name})", lambda: k9.apply_stencil9(s9, u),
             lambda: k9.apply_stencil9_plain(s9, u))
    out["ok"] = bool(ok)
    return out


def make_variant(name: str) -> Path:
    """A copy of the package with constants of csrc/visit.cuh set."""
    root = REPO / "_archive" / "ab5" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "multigrid_petsc_tpu_torch",
                    root / "multigrid_petsc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / "multigrid_petsc_tpu_torch" / "csrc" / "visit.cuh"
    text = src.read_text()
    for const, value in VARIANTS[name]:
        text, count = re.subn(rf"(constexpr \w+ (?:\w+ = [^,;]+, )*{const} = )"
                              rf"[^,;]+([,;])", rf"\g<1>{value}\g<2>", text)
        if count != 1:
            raise RuntimeError(f"{const} not found once in {src}")
    src.write_text(text)
    return root


def ab(n: int, variants: list, cases: str) -> int:
    trees = {"base": REPO, **{v: make_variant(v) for v in variants}}
    build = {name: subprocess.Popen(
        [sys.executable, "-c", "from multigrid_petsc_tpu_torch.ops.cuda."
         "_build import load_library; load_library()"],
        env=dict(os.environ, PYTHONPATH=str(t)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, t in trees.items()}
    failed = [name for name, p in build.items()
              if p.communicate()[0] is not None and p.returncode != 0]
    for name in failed:
        print(f"{name}: build failed", file=sys.stderr)
    if "base" in failed:
        return 1
    runs, ok = [], True
    for v in variants:
        if v in failed:
            continue
        for name in ("base", v, v, "base"):
            res = subprocess.run(
                [sys.executable, __file__, "--n", str(n), "--label", name,
                 "--cases", cases],
                env=dict(os.environ, PYTHONPATH=str(trees[name])),
                capture_output=True, text=True)
            if res.returncode not in (0, 1) or not res.stdout.strip():
                print(res.stdout, res.stderr, file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            ok &= line["ok"]
            runs.append({"pair": v, **line})
    print(json.dumps({"n": n, "card": card(), "runs": runs, "ok": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8191)
    ap.add_argument("--label", default="")
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS),
                    help="the --ab variants (default: all)")
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated, of {CASES}")
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"--cases: one or more of {CASES}")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.ab:
        return ab(args.n, args.variant or sorted(VARIANTS), args.cases)
    out = {"label": args.label, "n": args.n, "card": card()}
    ok = True
    for name, run in (("whole", run_cases), ("k17", run_k17)):
        if name in cases:
            res = run(args.n)
            ok &= res.pop("ok")
            out[name] = res
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

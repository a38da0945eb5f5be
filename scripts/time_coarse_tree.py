"""Time K4, the single-launch coarse sub-V-cycle, on one card, each tree
held to ``coarse_tree_plain`` first; with --ab, A/B the tail constant.

    python scripts/time_coarse_tree.py [--tail-max-n N] [--label L]
    python scripts/time_coarse_tree.py --ab
    PYTHONPATH=<other checkout> python scripts/time_coarse_tree.py [--mgcg]

The package is imported from PYTHONPATH where it is set, so another
checkout (a parent commit unpacked with git archive) is timed by the
same cases; a solver of a tree with no launch plan (``solve.plan``)
reports no plan and no probe.

Trees (f32, Jacobi omega 0.8; ``TREE_CASES``): the main path's 1023^2 ->
7^2 (Poisson, k = 3, the direct coarsest solve); 255^2 -> 7^2 (the
513^2 / 7-level split); 63^2 -> 7^2 (at the constant 63 all of it in
block 0); 255^2 -> 15^2, 1023^2 -> 127^2 and 1023^2 -> 63^2 smoothing
their coarsest level (at 63: the second with no level in block 0's tail,
the third with the coarsest alone in it); 1023^2 -> 7^2 with k = 1 on
every level (no merged steps).  All but the main path's
tree run on random diagonally dominant stencils, whose columns all
differ.  Each is held to coarse_tree_plain within TOL_ARRAY of
max|plain|.

The main path's tree is timed in two readings: one call between two CUDA
events (median of REPS; the host's checks and launch included, as
``chip_smoke.py`` times every kernel), and device time: CALLS calls
enqueued between two events, over CALLS (median of REPS).  The grid-sync
probe (``scripts/grid_sync_probe.cu``, built here with nvcc beside the
package's library, not into it) times a cooperative launch of the same
grid that does only N grid.sync(), N = 16 and 64: one barrier costs the
difference over 48.

--mgcg adds the main path's end-to-end reading, chip_smoke.py's phase 4:
the 8193^2 / 11-level f32 mg-CG solve to rtol 1e-5 (iterations, max
error) and its ms per iteration, the median of MGCG_PAIRS differences
of forced-length solves (3 and 3 + MGCG_EXTRA iterations).

--ab runs the module's TREE_TAIL_MAX_N against 31 and against 127 in the
order A B B A, one process per run, and prints one JSON line with every
run (the card's name and power limit included).  Exits non-zero if a
tree disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, NamedTuple

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.append(str(REPO))  # after PYTHONPATH: another tree may be timed

TOL_ARRAY = 1e-5  # max|kernel - plain| <= TOL_ARRAY * max|plain|
REPS = 20
CALLS = 20
PROBE_SYNCS = (16, 64)
AB_TAILS = (31, 127)
MGCG_PAIRS = 3
MGCG_EXTRA = 80
# name: (entry n, coarsest n, k per level, direct coarsest solve, Poisson)
TREE_CASES = {
    "main 1023->7": (1023, 7, 3, True, True),
    "513/7 split 255->7": (255, 7, 3, True, False),
    "entry in the tail 63->7": (63, 7, 3, True, False),
    "smoothed coarsest 255->15": (255, 15, 3, False, False),
    "smoothed coarsest 1023->127": (1023, 127, 3, False, False),
    "smoothed coarsest 1023->63": (1023, 63, 3, False, False),
    "k=1 1023->7": (1023, 7, 1, True, False),
}


class Tree(NamedTuple):
    name: str
    shapes: list
    solve: Callable
    plain: Callable
    b: object


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def random_stencil(torch, n: int, gen, dev):
    """A Stencil5 of (n, 1) columns: off-diagonals in -[0.5, 1.5), the
    centre 1.05-1.25 times their magnitudes' sum."""
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil5

    off = [-(0.5 + torch.rand((n, 1), generator=gen, device=dev))
           for _ in range(4)]
    cc = (sum(c.abs() for c in off)
          * (1.05 + 0.2 * torch.rand((n, 1), generator=gen, device=dev)))
    cs, cw, ce, cn = off
    return Stencil5(cs, cw, cc, ce, cn)


def tree_cases(torch, dev, dtype=None) -> list[Tree]:
    """TREE_CASES' solvers (made with the module's TREE_TAIL_MAX_N as it
    is when called), their plain versions and right-hand sides, in the
    storage type ``dtype`` (f32 by default, or bf16: the stencils and b
    rounded to it, the solver's inverse rounded to it as it stores it)."""
    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.coarse import dense_from_stencil
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    dtype = torch.float32 if dtype is None else dtype
    gen = torch.Generator(device=dev).manual_seed(2024)
    trees = []
    for name, (n0, nl, k, direct, poisson) in TREE_CASES.items():
        ns = [n0]
        while ns[-1] > nl:
            ns.append((ns[-1] - 1) // 2)
        shapes = [(n, n) for n in ns]
        sts = [stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32,
                                    dev) if poisson
               else random_stencil(torch, n, gen, dev) for n in ns]
        sts = [type(st)(*(c.to(dtype) for c in st)) for st in sts]
        steps_list = [jacobi_step_coeffs(k, 0.8)] * len(ns)
        a_inv = (np.linalg.inv(dense_from_stencil(sts[-1], nl, nl))
                 if direct else None)
        b = torch.randn(shapes[0], generator=gen, device=dev).to(dtype)
        solve = ctk.make_coarse_tree_solver(sts, shapes, steps_list, a_inv)
        trees.append(Tree(
            name, shapes, solve,
            lambda sts=sts, s=steps_list, a=solve.a_inv, b=b:
                ctk.coarse_tree_plain(sts, s, a, b), b))
    return trees


def event_ms(torch, fn) -> float:
    """Median over REPS of one call between two CUDA events."""
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


def device_ms(torch, fn, calls: int = CALLS) -> float:
    """Median over REPS of ``calls`` calls enqueued between two CUDA
    events, over ``calls``."""
    return event_ms(torch, lambda: [fn() for _ in range(calls)]) / calls


def load_probe() -> ctypes.CDLL:
    """Build (if needed) and load ``grid_sync_probe.cu`` into the
    package's build directory, keyed on its source and the flags."""
    from multigrid_petsc_tpu_torch.ops.cuda._build import (
        BUILD_DIR,
        NVCC_FLAGS,
        _nvcc,
    )

    src = Path(__file__).with_name("grid_sync_probe.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    lib = BUILD_DIR / f"libgridsync_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                              str(tmp), str(src)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    cdll.mg_grid_sync_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    cdll.mg_grid_sync_probe.restype = ctypes.c_int
    return cdll


def sync_cost_us(torch, probe, blocks: int) -> float:
    """One grid.sync() of a ``blocks`` x 256 cooperative grid, in us: the
    probe's device time at PROBE_SYNCS barriers, differenced."""
    from multigrid_petsc_tpu_torch.ops.cuda._build import check

    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        check(probe.mg_grid_sync_probe(blocks, n, stream), "grid-sync probe")

    lo, hi = PROBE_SYNCS
    t = [device_ms(torch, lambda n=n: run(n)) for n in (lo, hi)]
    return 1e3 * (t[1] - t[0]) / (hi - lo)


def run_cases(tail_max_n: int | None) -> dict:
    import torch

    from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk

    if tail_max_n is not None:  # None: a tree without the constant
        ctk.TREE_TAIL_MAX_N = tail_max_n
    dev = torch.device("cuda", 0)
    out, ok = {"cases": {}}, True
    trees = tree_cases(torch, dev)
    for t in trees:
        got, want = t.solve(t.b), t.plain()
        err = float((got - want).abs().max() / want.abs().max())
        ok &= err <= TOL_ARRAY
        plan = getattr(t.solve, "plan", None)
        out["cases"][t.name] = {"err": err, **({
            "tail_from": plan.tail_from, "grid_syncs": plan.grid_syncs,
            "blocks": plan.blocks} if plan is not None else {})}
    main = trees[0]
    out["event_ms"] = event_ms(torch, lambda: main.solve(main.b))
    out["device_ms"] = device_ms(torch, lambda: main.solve(main.b))
    out["plain_ms"] = event_ms(torch, main.plain)
    plan = getattr(main.solve, "plan", None)
    out["grid_sync_us"] = (None if plan is None else
                           sync_cost_us(torch, load_probe(), plan.blocks))
    out["ok"] = bool(ok)
    return out


def mgcg() -> dict:
    """The main path: 8193^2 / 11 levels, f32 mg-CG to rtol 1e-5."""
    import dataclasses

    import torch

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    cfg = SolverConfig(npts=8193, grids=11, levels=11, cycle=CycleType.MGCG,
                       dtype="float32", rtol=1e-5, max_iter=100)
    res = solve(cfg, device="cuda", timed=True)
    err = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u)[0]
    forced = dataclasses.replace(cfg, rtol=1e-30, divtol=1e30)

    def wall(k):
        ctx = dataclasses.replace(
            res.ctx, config=dataclasses.replace(forced, max_iter=k))
        return solve(forced, ctx=ctx, device="cuda", timed=True).wall_time

    pairs = [(wall(3 + MGCG_EXTRA) - wall(3)) / MGCG_EXTRA
             for _ in range(MGCG_PAIRS)]
    torch.cuda.synchronize()
    return {"mgcg_iters": res.iters, "mgcg_converged": bool(res.converged),
            "mgcg_max_error": float(err),
            "mgcg_ms_per_iteration": 1e3 * statistics.median(pairs),
            "mgcg_samples_ms": [1e3 * x for x in pairs]}


def ab() -> int:
    from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk

    base = ctk.TREE_TAIL_MAX_N
    runs, ok = [], True
    for other in AB_TAILS:
        for n in (base, other, other, base):
            res = subprocess.run(
                [sys.executable, __file__, "--tail-max-n", str(n), "--label",
                 f"{base} vs {other}"], capture_output=True, text=True)
            if res.returncode not in (0, 1) or not res.stdout.strip():
                print(res.stdout, res.stderr, file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            ok &= line["ok"]
            runs.append(line)
    print(json.dumps({"card": card(), "runs": runs, "ok": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tail-max-n", type=int, default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--mgcg", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.ab:
        return ab()
    from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk

    n = (getattr(ctk, "TREE_TAIL_MAX_N", None) if args.tail_max_n is None
         else args.tail_max_n)
    out = {"label": args.label, "tail_max_n": n, "card": card(),
           **run_cases(n), **(mgcg() if args.mgcg else {})}
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

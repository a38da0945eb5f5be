"""CLI entry point (PyTorch counterpart of
``multigrid_petsc_tpu/poisson.py``):

    python -m multigrid_petsc_tpu_torch.poisson [options_file] \\
        [-key value ...] [-device cuda|cpu]

Reads a poisson.in-style options file (default ./poisson.in if present),
applies the command-line ``-key value`` overrides, runs the configured
cycle (any ``-cycle`` id: V 0, I 1, E 2, D1 3, D2 4, D1PS 7,
MG-Richardson 8, Additive 9, Additive2 10, mg-CG 101, mg-FGMRES 102, FMG
103) for the configured problem (``-problem poisson``, or ``-problem
aniso -aniso a0,a2,c0,c2,b``, the 9-point family) and operator form
(matrix-free, or ``-backend sparse``: assembled matrices) on the device
and prints iterations, residual, error norms on the finest grid and
timing; ``-moreNorm 1`` adds the per-grid residual monitors of the
merged-grid cycles.  ``-device`` defaults to ``cuda``, which without a
card is an error; ``-device cpu`` runs the plain PyTorch versions of the
kernels.
"""

from __future__ import annotations

import sys
from pathlib import Path

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.postprocess import error_norms
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SolverConfig,
    parse_options,
    parse_options_file,
)

CYCLE_NAMES = {
    CycleType.VCYCLE: "V-cycle",
    CycleType.ICYCLE: "I-cycle",
    CycleType.ECYCLE: "E-cycle",
    CycleType.D1CYCLE: "D1-cycle",
    CycleType.D2CYCLE: "D2-cycle",
    CycleType.D1PSCYCLE: "D1PS-cycle",
    CycleType.PCMG: "MG-Richardson",
    CycleType.ADDITIVE: "Additive",
    CycleType.ADDITIVE2: "Additive2",
    CycleType.MGCG: "mg-CG",
    CycleType.MGFGMRES: "mg-FGMRES",
    CycleType.FMG: "FMG",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "-device" in argv:
        i = argv.index("-device")
        if i + 1 >= len(argv):
            print("usage: -device cuda|cpu", file=sys.stderr)
            return 2
        device = argv[i + 1]
        del argv[i : i + 2]

    cfg = SolverConfig()
    if argv and not argv[0].startswith("-"):
        cfg = parse_options_file(argv.pop(0), cfg)
    elif Path("poisson.in").exists():
        cfg = parse_options_file("poisson.in", cfg)
    try:
        cfg = parse_options(
            [f"{argv[j]} {argv[j + 1]}" for j in range(0, len(argv) - 1, 2)],
            cfg)
    except ValueError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 1

    res = solve(cfg, device=device)
    errs = error_norms(res.ctx.problem, MeshType(cfg.mesh), res.u)
    problem = cfg.problem
    if problem == "aniso":
        problem += "(" + ",".join(f"{a:g}" for a in cfg.aniso) + ")"
    print(f"{CYCLE_NAMES[cfg.cycle]} (cycle {cfg.cycle.value}) "
          f"smoother={cfg.smoother.value} problem={problem} "
          f"npts={cfg.npts} grids={cfg.grids} levels={cfg.levels} "
          f"dtype={cfg.dtype} backend={cfg.backend} device={device} "
          f"path={res.path}"
          + (f" route={res.route}" if res.route else "")
          + (f" outer_dtype={res.outer_dtype}" if res.outer_dtype else ""))
    if cfg.backend == "sparse":
        print("sparse level forms: " + " ".join(
            "/".join(f"{n}:{op.form}" for n, op in (
                ("A", lc.sparse_full), ("A1", lc.sparse_diag),
                ("A2", lc.sparse_coup)) if op is not None)
            for lc in res.ctx.levels))
    print(f"iterations: {res.iters}  converged: {res.converged}")
    print(f"relative residual: {res.rnorm[-1]:.6e}")
    if res.aux is not None:
        print("moreNorm r_global: " + " ".join(
            f"{v:.6e}" for v in res.aux["r_global"]))
        for g, row in enumerate(res.aux["r_grid"]):
            print(f"moreNorm r_grid[{g}]: "
                  + " ".join(f"{v:.6e}" for v in row))
    print("error (max, L1, L2): " + " ".join(f"{e:.6e}" for e in errs))
    print(f"solve wall time: {res.wall_time:.6f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

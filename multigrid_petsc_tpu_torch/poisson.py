"""CLI entry point (PyTorch counterpart of
``multigrid_petsc_tpu/poisson.py``):

    python -m multigrid_petsc_tpu_torch.poisson [options_file] \\
        [-key value ...] -device cpu|cuda

Reads a poisson.in-style options file (default ./poisson.in if present),
applies the command-line ``-key value`` overrides, runs the configured
cycle (V-cycle, MG-Richardson, FMG, Additive or mg-CG) on the named
device and prints iterations, residual, error norms and timing.
``-device`` is required; ``cuda`` without a card is an error.
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
    CycleType.PCMG: "MG-Richardson",
    CycleType.FMG: "FMG",
    CycleType.ADDITIVE: "Additive",
    CycleType.MGCG: "mg-CG",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-device" not in argv or argv.index("-device") + 1 >= len(argv):
        print("usage: -device cpu|cuda is required", file=sys.stderr)
        return 2
    i = argv.index("-device")
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
    print(f"{CYCLE_NAMES[cfg.cycle]} (cycle {cfg.cycle.value}) "
          f"smoother={cfg.smoother.value} npts={cfg.npts} "
          f"levels={cfg.levels} dtype={cfg.dtype} device={device} "
          f"path={res.path}")
    print(f"iterations: {res.iters}  converged: {res.converged}")
    print(f"relative residual: {res.rnorm[-1]:.6e}")
    print("error (max, L1, L2): " + " ".join(f"{e:.6e}" for e in errs))
    print(f"solve wall time: {res.wall_time:.6f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

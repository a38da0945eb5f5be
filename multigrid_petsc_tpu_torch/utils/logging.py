"""Run-configuration banner and diagnostics printing (PyTorch counterpart
of ``multigrid_petsc_tpu/utils/logging.py``; reference: PrintInfo,
src/poisson.c:165-214, the timing printout src/solver.c:1571-1573 and the
error report src/solver.c:1332-1335).

Every line is the JAX package's except ``Devices:``, which names the
torch device the solve ran on: ``1 x cuda (<card name>)``, ``1 x cpu``,
or under a plan the ranks and their transport.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.hierarchy import grid_interior
from multigrid_petsc_tpu_torch.utils.config import SolverConfig

_MESH_NAMES = {0: "Uniform", 1: "Non-uniform (cosine)", 2: "Non-uniform (exp)"}


def total_unknowns(npts: int, total_grids: int) -> int:
    """Sum of interior unknowns over all grids (src/poisson.c:152-163)."""
    return sum(grid_interior(npts, g) ** 2 for g in range(total_grids))


def device_line(ctx) -> str:
    """The devices a solve of ``ctx`` ran on, in words."""
    dev = ctx.device
    if ctx.plan is not None:
        return (f"{ctx.plan.size} ranks x {dev.type} "
                f"(transport {ctx.plan.transport})")
    if dev.type == "cuda":
        return f"1 x cuda ({torch.cuda.get_device_name(dev)})"
    return f"1 x {dev.type}"


def print_info(cfg: SolverConfig, res, errs) -> None:
    n0 = cfg.npts - 2
    print("=" * 65)
    print(f"Mesh size:                 {cfg.npts} x {cfg.npts}")
    print(f"Mesh type:                 {_MESH_NAMES.get(cfg.mesh, cfg.mesh)}")
    print(f"Number of grids:           {cfg.grids}")
    print(f"Number of levels:          {cfg.levels}")
    print(f"Cycle:                     {cfg.cycle.name}")
    per_level = (cfg.level_smoothers is not None or cfg.level_v is not None
                 or cfg.fine_smoother is not None
                 or cfg.levels_smoother is not None
                 or cfg.coarse_smoother is not None)
    if per_level:
        sm = ",".join(cfg.smoother_at(l, cfg.levels).value
                      for l in range(cfg.levels))
        sw = ",".join(str(cfg.sweeps_at(l, cfg.levels))
                      for l in range(cfg.levels))
        print(f"Smoother:                  per-level [{sm}] (v = [{sw}])")
    else:
        print(f"Smoother:                  {cfg.smoother.value} (v = {cfg.v})")
    print(f"Total unknowns:            {total_unknowns(cfg.npts, cfg.grids)}"
          f" (fine grid: {n0 * n0})")
    print(f"Devices:                   {device_line(res.ctx)}")
    print("-" * 65)
    for i, e in enumerate(errs):
        print(f"error[{i}] = {e:.16e}")
    print(f"Relative residual = {res.rnorm[-1]:.16e}")
    print(f"Iterations = {res.iters} (converged: {res.converged})")
    print(f"Solver cputime:  {res.cpu_time:f}")
    print(f"Solver walltime: {res.wall_time:f}")
    print("=" * 65)

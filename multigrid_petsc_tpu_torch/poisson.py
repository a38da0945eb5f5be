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
(matrix-free, or ``-backend sparse``: assembled matrices) on the device.
It prints the port's summary (path, route, sparse forms, distribution,
iterations, residual, error norms on the finest grid, timing), then the
JAX CLI's run banner (``utils.logging.print_info``) and, with ``-view
1``, its per-level solver dump (``utils.views.view_solver``), and writes
the reference's artifact files into the working directory
(``uData.dat rData.dat eData.dat XgridData.dat YgridData.dat``, with
``-moreNorm 1`` also ``rGlobal.dat rGrid<i>.dat``;
``postprocess.write_artifacts``).  ``-moreNorm 1`` also prints the
per-grid residual monitors of the merged-grid cycles.  ``-device``
defaults to ``cuda``, which without a card is an error; ``-device cpu``
runs the plain PyTorch versions of the kernels.

Distributed (JAX poisson.py:53-75; the reference's ``mpirun -n P``):

    python -m torch.distributed.run --nproc_per_node P \
        -m multigrid_petsc_tpu_torch.poisson ... -map 2 [-device cpu]

Under ``torchrun`` (WORLD_SIZE > 1) each rank initialises the process
group, NCCL when every rank has a card of its own, gloo otherwise (the
CPU, or ranks sharing a card: halos staged through the host); ``-map 2``
(the default) solves under ``row_plan()``, ``-map 0`` and ``-map 1`` under
``blocks_plan()``, the 2-D blocks layout over the most-square rank mesh
(JAX maps both styles to its one blocks plan).  Rank 0 prints, the
summary naming the ranks, the mesh (blocks), the transport and the
sharded levels, and writes the artifact files from the gathered
solution.
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.parallel import blocks_plan, row_plan
from multigrid_petsc_tpu_torch.postprocess import error_norms, write_artifacts
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SolverConfig,
    parse_options,
    parse_options_file,
)
from multigrid_petsc_tpu_torch.utils.logging import print_info
from multigrid_petsc_tpu_torch.utils.views import view_solver

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

    plan, own_group = None, False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        own_group = not dist.is_initialized()
        plan = _init_plan(device, cfg.map_style)
    try:
        return _run(cfg, device, plan)
    finally:
        if own_group:
            dist.destroy_process_group()


def _init_plan(device: str, map_style: int):
    """The process group of a ``torchrun`` launch (one the caller has
    initialised is kept) and its plan (``-map 2``: the rows layout, ``-map
    0/1``: the blocks layout): NCCL when every rank of the node has a card
    of its own, else gloo."""
    if not dist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        own_card = (device != "cpu" and torch.cuda.is_available()
                    and torch.cuda.device_count() >= local)
        dist.init_process_group("nccl" if own_card else "gloo",
                                timeout=timedelta(seconds=600))
    if map_style == 2:
        return row_plan(device=device)
    return blocks_plan(device=device)


def _run(cfg: SolverConfig, device: str, plan) -> int:
    res = solve(cfg, plan=plan, device=device)
    # Under a plan the solution is gathered on every rank (a collective).
    u = res.u if plan is None else torch.as_tensor(res.u_fine)
    if plan is not None and plan.rank != 0:
        return 0
    errs = error_norms(res.ctx.problem, MeshType(cfg.mesh), u)
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
    if plan is not None:
        # Each sharded level's sharded grids (a merged level's joined by /).
        mesh = (f" mesh={plan.mesh[0]}x{plan.mesh[1]}"
                if plan.layout == "blocks" else "")
        print(f"distributed: ranks={plan.size}{mesh} "
              f"transport={plan.transport} sharded levels=" + ",".join(
                  "/".join(str(g.ny) for g, s in zip(lc.spec.grids,
                                                     lc.split) if s)
                  for lc in res.ctx.levels if lc.sharded))
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
    print_info(cfg, res, errs)
    if cfg.view_solver:
        # The per-level solver dump; the reference prints KSPView for
        # every level after the solve (src/solver.c:1560-1564).
        print(view_solver(res.ctx))
    r_global = r_grid = None
    if res.aux is not None:
        r_global = res.aux["r_global"]
        r_grid = dict(enumerate(res.aux["r_grid"]))
    write_artifacts(".", MeshType(cfg.mesh), u, res.rnorm, errs,
                    r_global=r_global, r_grid=r_grid)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Solve dispatch: config -> cycle driver -> result (PyTorch counterpart
of ``multigrid_petsc_tpu/solvers/solve.py``; reference: src/solver.c:
2617-2630): every cycle id, the reference's nine (V, I, E, D1, D2, D1PS,
PCMG as MG-Richardson, Additive, Additive2) and the framework's mg-CG,
mg-FGMRES and FMG.

``wall_time`` brackets the solve only (set-up excluded), synchronising the
device on both sides; ``timed=True`` re-runs the solve and reports the
re-run, so first-launch costs (kernel build and load) stay out.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from multigrid_petsc_tpu_torch.solvers import cycles as cy
from multigrid_petsc_tpu_torch.solvers import delayed as dl
from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.solvers import vcycle as vc
from multigrid_petsc_tpu_torch.solvers.context import (
    MGContext,
    build_context,
    primary,
)
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

_DRIVERS = {
    CycleType.VCYCLE: vc.solve_vcycle,
    CycleType.PCMG: vc.solve_mg_richardson,
    CycleType.FMG: vc.solve_fmg,
    CycleType.ADDITIVE: cy.solve_additive,
    CycleType.ICYCLE: cy.solve_icycle,
    CycleType.ECYCLE: cy.solve_ecycle,
    CycleType.ADDITIVE2: cy.solve_additive2,
    CycleType.MGCG: kr.solve_mgcg,
    CycleType.MGFGMRES: kr.solve_mgfgmres,
    **{c: (lambda ctx, b0, _c=c: dl.solve_delayed(ctx, _c, b0))
       for c in (CycleType.D1CYCLE, CycleType.D2CYCLE, CycleType.D1PSCYCLE)},
}


@dataclass
class SolveResult:
    u: torch.Tensor  # level-0 primary-grid solution, on the solve's device
    rnorm: np.ndarray  # normalized residual history, entries 0..iters
    iters: int
    converged: bool
    wall_time: float  # solve seconds, device synchronised
    cpu_time: float
    ctx: MGContext
    # "cuda" when the hand-written kernels ran (every level operation on
    # a CUDA tensor launches one; none falls back), "torch" when the
    # plain PyTorch versions did.
    path: str
    # Every grid of the level-0 state (one entry unless level 0 is merged).
    u_grids: tuple = ()
    # -moreNorm: the monitors' arrays, cut to the iterations run (numpy).
    aux: dict | None = None

    @property
    def u_fine(self) -> np.ndarray:
        return self.u.detach().cpu().numpy()


def solve(cfg: SolverConfig, problem=None, ctx: MGContext | None = None, *,
          device: torch.device | str = "cuda",
          timed: bool = False) -> SolveResult:
    """Set up on ``device`` (unless given a context; the card unless the
    caller names the CPU) and run the configured cycle."""
    cfg = cfg.validate()
    if ctx is None:
        ctx = build_context(cfg, problem, device=device)
    dev = ctx.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run():
        sync()
        t0w, t0c = time.perf_counter(), time.process_time()
        res = _DRIVERS[ctx.config.cycle](ctx, ctx.b0)
        sync()
        return res, time.perf_counter() - t0w, time.process_time() - t0c

    res, wall, cpu = run()
    if timed:
        res, wall, cpu = run()
    aux = None
    if res.aux is not None:
        # The delayed cycles record v + 1 entries per outer iteration, the
        # I/E monitors one per iteration and the initial state.
        delayed = ctx.config.cycle in (CycleType.D1CYCLE, CycleType.D2CYCLE,
                                       CycleType.D1PSCYCLE)
        n = res.iters * (ctx.config.v[0] + 1) if delayed else res.iters + 1
        aux = {"r_global": res.aux["r_global"][:n].cpu().numpy(),
               "r_grid": res.aux["r_grid"][:, :n].cpu().numpy()}
    return SolveResult(
        u=primary(res.u),
        u_grids=(res.u,) if isinstance(res.u, torch.Tensor) else res.u,
        aux=aux,
        rnorm=res.rnorm_history[: res.iters + 1].cpu().numpy(),
        iters=res.iters,
        converged=res.converged,
        wall_time=wall,
        cpu_time=cpu,
        ctx=ctx,
        path="cuda" if dev.type == "cuda" else "torch",
    )

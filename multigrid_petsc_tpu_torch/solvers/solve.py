"""Solve dispatch: config -> cycle driver -> result (PyTorch counterpart
of ``multigrid_petsc_tpu/solvers/solve.py``; reference: src/solver.c:
2617-2630).  Ported drivers: V-cycle, MG-Richardson (PCMG), FMG, Additive,
mg-CG and mg-FGMRES; the others raise ``NotImplementedError``.

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
from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.solvers import vcycle as vc
from multigrid_petsc_tpu_torch.solvers.context import (
    MGContext,
    _not_ported,
    build_context,
)
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

_DRIVERS = {
    CycleType.VCYCLE: vc.solve_vcycle,
    CycleType.PCMG: vc.solve_mg_richardson,
    CycleType.FMG: vc.solve_fmg,
    CycleType.ADDITIVE: cy.solve_additive,
    CycleType.MGCG: kr.solve_mgcg,
    CycleType.MGFGMRES: kr.solve_mgfgmres,
}


@dataclass
class SolveResult:
    u: torch.Tensor  # level-0 solution, on the solve's device
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

    @property
    def u_fine(self) -> np.ndarray:
        return self.u.detach().cpu().numpy()


def solve(cfg: SolverConfig, problem=None, ctx: MGContext | None = None, *,
          device: torch.device | str = "cuda",
          timed: bool = False) -> SolveResult:
    """Set up on ``device`` (unless given a context; the card unless the
    caller names the CPU) and run the configured cycle."""
    cfg = cfg.validate()
    if cfg.cycle not in _DRIVERS:
        raise _not_ported(f"cycle {cfg.cycle.name}", "the cycle zoo")
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
    return SolveResult(
        u=res.u,
        rnorm=res.rnorm_history[: res.iters + 1].cpu().numpy(),
        iters=res.iters,
        converged=res.converged,
        wall_time=wall,
        cpu_time=cpu,
        ctx=ctx,
        path="cuda" if dev.type == "cuda" else "torch",
    )

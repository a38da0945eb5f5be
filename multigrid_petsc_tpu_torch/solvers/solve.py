"""Solve dispatch: config -> mg-CG driver -> result (PyTorch counterpart
of ``multigrid_petsc_tpu/solvers/solve.py``, mg-CG only).

``wall_time`` brackets the solve only (set-up excluded), synchronising the
device on both sides; ``timed=True`` re-runs the solve and reports the
re-run, so first-launch costs (kernel build and load) stay out.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.solvers.context import MGContext, build_context
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig


@dataclass
class SolveResult:
    u: torch.Tensor  # level-0 solution, on the solve's device
    rnorm: np.ndarray  # normalized residual history, entries 0..iters
    iters: int
    converged: bool
    wall_time: float  # solve seconds, device synchronised
    cpu_time: float
    ctx: MGContext
    # "cuda" when the hand-written kernels ran, "torch" when the plain
    # PyTorch versions did.
    path: str

    @property
    def u_fine(self) -> np.ndarray:
        return self.u.detach().cpu().numpy()


def solve(cfg: SolverConfig, problem=None, ctx: MGContext | None = None, *,
          device: torch.device | str, timed: bool = False) -> SolveResult:
    """Set up on ``device`` (unless given a context) and run mg-CG."""
    cfg = cfg.validate()
    if cfg.cycle != CycleType.MGCG:
        raise NotImplementedError(
            f"cycle {cfg.cycle.name} is not ported yet (ROADMAP.md, modules "
            "left behind: the V-cycle/FMG/Richardson drivers, the cycle zoo)")
    if ctx is None:
        ctx = build_context(cfg, problem, device=device)
    dev = ctx.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run():
        sync()
        t0w, t0c = time.perf_counter(), time.process_time()
        res = kr.solve_mgcg(ctx, ctx.b0)
        sync()
        return res, time.perf_counter() - t0w, time.process_time() - t0c

    res, wall, cpu = run()
    if timed:
        res, wall, cpu = run()
    kernels = dev.type == "cuda" and len(ctx.levels) > 1
    return SolveResult(
        u=res.u,
        rnorm=res.rnorm_history[: res.iters + 1].cpu().numpy(),
        iters=res.iters,
        converged=res.converged,
        wall_time=wall,
        cpu_time=cpu,
        ctx=ctx,
        path="cuda" if kernels else "torch",
    )

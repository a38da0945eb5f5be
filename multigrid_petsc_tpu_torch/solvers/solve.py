"""Solve dispatch: config -> cycle driver -> result (PyTorch counterpart
of ``multigrid_petsc_tpu/solvers/solve.py``; reference: src/solver.c:
2617-2630): every cycle id, the reference's nine (V, I, E, D1, D2, D1PS,
PCMG as MG-Richardson, Additive, Additive2) and the framework's mg-CG,
mg-FGMRES and FMG.

``wall_time`` brackets the solve only (set-up excluded), synchronising the
device on both sides; ``timed=True`` re-runs the solve and reports the
re-run, so first-launch costs (kernel build and load) stay out.
``SolveResult.phases`` holds the solve's seconds (``"solve"``; the port
has no compile step), and with ``profile_phases=True`` the level-0
building blocks' (``utils.profiling.phase_breakdown``).

mg-CG with ``outer_dtype`` runs the mixed-precision outer
(``krylov.solve_mgcg_mixed``) on the right-hand side evaluated in f64.
``u0`` warm-starts a solve (a checkpoint's resume: a tuple of one grid is
that grid): the mixed outer starts from it directly; every other driver
solves A e = b - A u0 from zero to the rtol that keeps the stop target
rtol * ||b||, and u0 is added back (JAX solve.py:121-180).

Under a plan (``plan=``, every rank calling ``solve`` alike) the solve
runs on the plan's device; ``u0`` is the whole level-0 grid, of which each
rank takes its rows; ``SolveResult.u`` is this rank's block of the
solution (its real rows), and ``u_fine`` the whole grid, gathered from
every rank (a collective: every rank reads it).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from multigrid_petsc_tpu_torch.solvers import cycles as cy
from multigrid_petsc_tpu_torch.solvers import delayed as dl
from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.ops.norms import tree_map
from multigrid_petsc_tpu_torch.parallel.gather import gather_solution
from multigrid_petsc_tpu_torch.solvers import vcycle as vc
from multigrid_petsc_tpu_torch.solvers.context import (
    MGContext,
    build_context,
    primary,
)
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig
from multigrid_petsc_tpu_torch.utils.profiling import phase_breakdown

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
    # The mg-CG route ("mdma", "fused", "generic"; krylov.mgcg_route), None
    # for the other drivers and the mixed outer.
    route: str | None = None
    # The outer dtype the mixed outer ran in ("float64", also for
    # outer_dtype="float32x2"), None without one.
    outer_dtype: str | None = None
    # Every grid of the level-0 state (one entry unless level 0 is merged).
    u_grids: tuple = ()
    # -moreNorm: the monitors' arrays, cut to the iterations run (numpy).
    aux: dict | None = None
    # Seconds per phase: "solve", and with profile_phases the level-0
    # building blocks (smooth_v, residual, restrict, prolong, norm).
    phases: dict | None = None
    _whole: np.ndarray | None = None

    @property
    def u_fine(self) -> np.ndarray:
        """The level-0 primary-grid solution as a numpy array; under a
        plan gathered from every rank's block, once (a collective)."""
        if self.ctx.plan is None or self.ctx.levels[0].dist is None:
            return self.u.detach().cpu().numpy()
        if self._whole is None:
            self._whole = gather_solution(self.u, self.ctx.plan,
                                          self.ctx.levels[0].shape[0])
        return self._whole


def solve(cfg: SolverConfig, problem=None, ctx: MGContext | None = None, *,
          plan=None, device: torch.device | str | None = None, u0=None,
          timed: bool = False, profile_phases: bool = False) -> SolveResult:
    """Set up on ``device`` (unless given a context; None: the card, or
    under ``plan`` the plan's device) and run the configured cycle, from
    ``u0`` (the level-0 state, a tensor or array; a tuple on a merged
    level 0; under a plan the whole grid) when given."""
    cfg = cfg.validate()
    if ctx is None:
        ctx = build_context(cfg, problem, plan=plan, device=device)
    dev = ctx.device
    ccfg = ctx.config
    lvl0 = ctx.levels[0]
    mixed = ccfg.outer_dtype is not None and ccfg.cycle == CycleType.MGCG
    b_in = kr.outer_rhs(ctx, torch.float64) if mixed else ctx.b0
    if u0 is not None:
        if isinstance(u0, (tuple, list)) and not lvl0.merged:
            (u0,) = u0  # a checkpoint's one grid (utils.checkpoint.load)
        if isinstance(u0, np.ndarray):  # one grid's array, not a tuple
            u0 = torch.from_numpy(u0)
        u0 = tree_map(lambda x: torch.as_tensor(
            x, dtype=torch.float64 if mixed else ctx.dtype, device=dev), u0)
        if lvl0.dist is not None:
            u0 = lvl0.dist.block_of(u0)
        if not mixed:
            bn_orig = float(lvl0.norm2(b_in))
            b_in = lvl0.residual(b_in, u0)
            bn_new = float(lvl0.norm2(b_in))
            eff = min(1.0, ccfg.rtol * bn_orig / max(bn_new, 1e-300))
            ctx = dataclasses.replace(
                ctx, config=dataclasses.replace(ccfg, rtol=eff))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run():
        sync()
        ctx.route = None
        t0w, t0c = time.perf_counter(), time.process_time()
        if mixed:
            res = kr.solve_mgcg_mixed(ctx, b_in, u0)
        else:
            res = _DRIVERS[ctx.config.cycle](ctx, b_in)
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
    phases = {"solve": wall}
    if profile_phases:
        phases.update(phase_breakdown(ctx))
    u = res.u
    if u0 is not None and not mixed:
        u = tree_map(lambda a, b: a + b, u, u0)
    if lvl0.dist is not None:  # this rank's real rows, the pad row cut
        u = u[:max(0, min(lvl0.dist.R, lvl0.shape[0] - lvl0.dist.row0))]
    return SolveResult(
        u=primary(u),
        u_grids=(u,) if isinstance(u, torch.Tensor) else u,
        aux=aux,
        phases=phases,
        rnorm=res.rnorm_history[: res.iters + 1].cpu().numpy(),
        iters=res.iters,
        converged=res.converged,
        wall_time=wall,
        cpu_time=cpu,
        ctx=ctx,
        path="cuda" if dev.type == "cuda" else "torch",
        route=ctx.route,
        outer_dtype="float64" if mixed else None,
    )

"""Solve dispatch: config -> cycle driver -> result (PyTorch counterpart
of ``multigrid_petsc_tpu/solvers/solve.py``; reference: src/solver.c:
2617-2630): every cycle id, the reference's nine (V, I, E, D1, D2, D1PS,
PCMG as MG-Richardson, Additive, Additive2) and the framework's mg-CG,
mg-FGMRES and FMG.

``wall_time`` brackets the solve only (set-up excluded), synchronising the
device on both sides; ``timed=True`` re-runs the solve and reports the
re-run, so first-launch costs (kernel build and load) stay out.

mg-CG with ``outer_dtype`` runs the mixed-precision outer
(``krylov.solve_mgcg_mixed``) on the right-hand side evaluated in f64.
``u0`` warm-starts a solve: the mixed outer starts from it directly; every
other driver solves A e = b - A u0 from zero to the rtol that keeps the
stop target rtol * ||b||, and u0 is added back (JAX solve.py:121-180).
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
from multigrid_petsc_tpu_torch.ops.norms import tree_map, tree_norm2
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

    @property
    def u_fine(self) -> np.ndarray:
        return self.u.detach().cpu().numpy()


def solve(cfg: SolverConfig, problem=None, ctx: MGContext | None = None, *,
          device: torch.device | str = "cuda", u0=None,
          timed: bool = False) -> SolveResult:
    """Set up on ``device`` (unless given a context; the card unless the
    caller names the CPU) and run the configured cycle, from ``u0`` (the
    level-0 state, a tensor or array; a tuple on a merged level 0) when
    given."""
    cfg = cfg.validate()
    if ctx is None:
        ctx = build_context(cfg, problem, device=device)
    dev = ctx.device
    ccfg = ctx.config
    mixed = ccfg.outer_dtype is not None and ccfg.cycle == CycleType.MGCG
    b_in = kr.outer_rhs(ctx, torch.float64) if mixed else ctx.b0
    if u0 is not None:
        u0 = tree_map(lambda x: torch.as_tensor(
            x, dtype=torch.float64 if mixed else ctx.dtype, device=dev), u0)
        if not mixed:
            bn_orig = float(tree_norm2(b_in))
            b_in = ctx.levels[0].residual(b_in, u0)
            bn_new = float(tree_norm2(b_in))
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
    u = res.u
    if u0 is not None and not mixed:
        u = tree_map(lambda a, b: a + b, u, u0)
    return SolveResult(
        u=primary(u),
        u_grids=(u,) if isinstance(u, torch.Tensor) else u,
        aux=aux,
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

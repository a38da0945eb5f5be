"""The non-V cycle zoo: I, E, Additive and Additive2 (PyTorch
counterpart of ``multigrid_petsc_tpu/solvers/cycles.py``; the delayed
cycles are in ``solvers/delayed.py``).

  * I-cycle (src/solver.c:1991-2060): one smoother sweep per iteration
    on the ONE merged system whose matrix holds every inter-grid
    coupling (block Gauss-Seidel on a merged level).
  * E-cycle (src/solver.c:2062-2152): A = A1 (grid-diagonal blocks) + A2
    (couplings); iterate u <- smooth_v(A1, b - A2 u), with the
    reference's own norm ||b - A1 u|| (src/solver.c:2126-2128).
  * Additive (src/solver.c:1754-1800): BPX-style; every level smooths
    its own share of the residual (the part its coarser level cannot
    see, r - P R r) and the corrections are summed on the way up.
  * Additive2 (src/solver.c:1577-1720): two levels with the step length
    lambda = <r0, r1> / <r0, r0> (src/solver.c:1674-1675).

Smoothing and operator applications go through the levels (K6/K7 per
grid, or the assembled operator's K8 / K16 / ELL gather on the card);
the filters and transfers are plain PyTorch, as in the JAX package.
Every cycle here runs under a plan too: its reductions go through level
0 (``LevelCtx.dot`` / ``norm2`` / ``grid_norm``: a sharded grid's summed
over the ranks, a replicated grid's counted once), its transfers are
block-local between sharded sizes, and a merged level 0's operations run
through its operator set (K17 on a sharded grid's block).
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.norms import tree_map
from multigrid_petsc_tpu_torch.solvers import smoothers as smod
from multigrid_petsc_tpu_torch.solvers.context import MGContext
from multigrid_petsc_tpu_torch.solvers.outer import (
    OuterResult,
    keep_going,
    outer_iterate,
)
from multigrid_petsc_tpu_torch.utils.config import SmootherType


def _grids(state) -> tuple:
    return (state,) if isinstance(state, torch.Tensor) else tuple(state)


def _grid_monitor(ctx: MGContext, residual_fn, b):
    """The moreNorm monitor of the one-level merged cycles: per outer
    iteration (0: the initial state) the global residual norm and each
    grid's residual 2-norm (the rNormGridMonitor analogue, reference
    src/solver.c:1382-1399, 2017-2018)."""
    cfg = ctx.config
    lvl = ctx.levels[0]
    G = len(lvl.spec.grids)
    length = min(cfg.max_iter, cfg.hist_len) + 1
    r_global = torch.zeros(length, dtype=ctx.dtype, device=ctx.device)
    r_grid = torch.zeros((G, length), dtype=ctx.dtype, device=ctx.device)

    def record(i, u, rn):
        idx = min(i, length - 1)
        r_global[idx] = rn
        for g, rg in enumerate(_grids(residual_fn(b, u))):
            r_grid[g, idx] = lvl.grid_norm(g, rg)

    record.aux = lambda: {"r_global": r_global, "r_grid": r_grid}
    return record


def _residual_diag(lvl):
    """b - A1 u, the E- and delayed cycles' own residual."""
    return lambda b, u: tree_map(lambda bk, ak: bk - ak, b,
                                 lvl.apply_diag(u))


def _diag_smoother(ctx: MGContext, lvl):
    """The smoother over the grid-diagonal blocks A1 only (Chebyshev with
    the lmax of D^-1 A1, estimated on the whole grids at set-up, or damped
    Jacobi)."""
    cfg = ctx.config
    if cfg.smoother == SmootherType.CHEBYSHEV:
        def smooth(b, u, sweeps):
            return smod.chebyshev(lvl.apply_diag, lvl.dinv, b, u, sweeps,
                                  lvl.lmax)
    else:
        def smooth(b, u, sweeps):
            return smod.jacobi(lvl.apply_diag, lvl.dinv, b, u, sweeps,
                               cfg.omega)
    return smooth


def solve_icycle(ctx: MGContext, b0=None) -> OuterResult:
    """One smoother sweep per outer iteration on the full merged operator
    (couplings included in its residual)."""
    cfg = ctx.config
    lvl = ctx.levels[0]
    b = ctx.b0 if b0 is None else b0

    def step(b, u):
        return lvl.smooth(b, u, 1)

    mon = _grid_monitor(ctx, lvl.residual, b) if cfg.more_norm else None
    return outer_iterate(step, lvl.residual, b, lvl.zeros(), cfg,
                         monitor=mon, norm=lvl.norm2)


def solve_ecycle(ctx: MGContext, b0=None) -> OuterResult:
    """Block Jacobi across grids: v sweeps on the diagonal blocks with the
    couplings moved to the rhs each outer iteration.  Its own norm
    ||b - A1 u|| plateaus at ||R f|| / ||b|| (at the merged fixed point
    the coarse variables vanish while their rhs R f stays), as the
    reference's does; the fine iterate converges."""
    cfg = ctx.config
    v0 = cfg.v[0]
    lvl = ctx.levels[0]
    smooth = _diag_smoother(ctx, lvl)
    residual_diag = _residual_diag(lvl)
    b = ctx.b0 if b0 is None else b0

    def step(b, u):
        rhs = tree_map(lambda bk, ck: bk - ck, b, lvl.apply_couplings(u))
        return smooth(rhs, u, v0)

    mon = _grid_monitor(ctx, residual_diag, b) if cfg.more_norm else None
    return outer_iterate(step, residual_diag, b, lvl.zeros(), cfg,
                         monitor=mon, norm=lvl.norm2)


def solve_additive(ctx: MGContext, b0: torch.Tensor | None = None) -> OuterResult:
    """Additive cycle with the P R filter (matrix-free)."""
    cfg = ctx.config
    v0, v1 = cfg.v
    L = len(ctx.levels)
    if L < 2:
        raise ValueError("the Additive cycle requires levels >= 2 "
                         "(src/solver.c:1754)")

    def filter_l(l: int, r):
        """F_l r = P_l (R_l r) (src/solver.c:1758-1761)."""
        return ctx.prolong_from_next(l, ctx.restrict_to_next(l, r))

    def step(b, u):
        # Down: the fine pre-smooth continues from the current u.
        us, es, bs = [None] * L, [None] * L, [b] + [None] * (L - 1)
        us[0] = ctx.levels[0].smooth(b, u, v0)
        for l in range(L - 1):
            lvl, nxt = ctx.levels[l], ctx.levels[l + 1]
            r = lvl.residual(bs[l], us[l])
            ef = filter_l(l, r)
            bs[l + 1] = ctx.restrict_to_next(l, ef)
            es[l] = lvl.smooth(r - ef, lvl.zeros(), v0)
            us[l + 1] = nxt.smooth(bs[l + 1], nxt.zeros(),
                                   v0 if l + 1 < L - 1 else v1)
        # Up: add the complement correction and the prolonged coarse one.
        for l in range(L - 2, -1, -1):
            corr = ctx.prolong_from_next(l, us[l + 1])
            us[l] = ctx.levels[l].smooth(bs[l], us[l] + es[l] + corr, v0)
        return us[0]

    return outer_iterate(step, ctx.levels[0].residual,
                         ctx.b0 if b0 is None else b0, ctx.levels[0].zeros(),
                         cfg, norm=ctx.levels[0].norm2)


def solve_additive2(ctx: MGContext, b0=None) -> OuterResult:
    """Two-level additive cycle with the step length
    lambda = <r0, r1> / <r0, r0> (src/solver.c:1670-1693): the coarse rhs
    comes from the residual before the fine smoothing."""
    cfg = ctx.config
    v0, v1 = cfg.v
    if len(ctx.levels) != 2:
        raise ValueError("Additive2 requires exactly 2 levels")
    lvl0, lvl1 = ctx.levels
    b = ctx.b0 if b0 is None else b0
    hist_len = min(cfg.hist_len, cfg.max_iter)
    bnorm = float(lvl0.norm2(b))
    u = lvl0.zeros()
    r0 = lvl0.residual(b, u)
    rn_t = lvl0.norm2(r0)
    hist = torch.zeros(hist_len + 1, dtype=rn_t.dtype, device=rn_t.device)
    hist[0] = rn_t
    rn, i = float(rn_t), 0
    while keep_going(cfg, i, rn, bnorm):
        b1 = ctx.restrict_to_next(0, r0)
        u = lvl0.smooth(b, u, v0)
        r1 = lvl0.residual(b, u)
        lam = lvl0.dot(r0, r1) / (rn_t * rn_t)
        u1 = lvl1.smooth(b1, lvl1.zeros(), v1)
        u = u + lam * ctx.prolong_from_next(0, u1)
        r0 = lvl0.residual(b, u)
        rn_t = lvl0.norm2(r0)
        hist[min(i + 1, hist_len)] = rn_t
        i += 1
        rn = float(rn_t)  # the stop test: the one host read per iteration
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=rn <= cfg.rtol * bnorm)

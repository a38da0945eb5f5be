"""The delayed cycles D1, D2 and D1PS on one merged level (PyTorch
counterpart of ``multigrid_petsc_tpu/solvers/delayed.py``; reference
restricted to levels == 1, src/poisson.c:61-65).

  * The level matrix is the grid-diagonal A1 only (src/solver.c:1167-1168
    assembles levelMatrixA1 for the delayed cycles): on the card an
    assembled A1 runs through K16, a matrix-free one through K6 per grid.
  * Delayed restriction feeds each grid g >= 1 the one-gap full-weighting
    restriction of the residual on grid g - 1 (src/solver.c:879-953);
    delayed prolongation corrects each grid g <= G - 2 with the one-gap
    bilinear prolongation of grid g + 1's iterate (src/solver.c:955-1033).
    Both go through the level's operator set: under a plan block-local
    between two sharded grids, gathered ("agglomerate") from a sharded
    grid onto a replicated one, cut from a replicated grid into a sharded
    one; the norms through the level (a sharded grid's over the ranks).
  * The residual the transfers read is the one computed at the END of the
    previous outer iteration: stale on purpose, that is the delay
    (src/solver.c:2562-2571).

Per-iteration orders (v = v[0] sweeps of the A1 smoother):
  D1   (src/solver.c:2562-2571): restrict, prolong-correct, smooth
  D2   (src/solver.c:2252-2261): restrict, smooth, prolong-correct
  D1PS (src/solver.c:2407-2417): prolong-correct, smooth, restrict, smooth
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.solvers import smoothers as smod
from multigrid_petsc_tpu_torch.solvers.context import MGContext
from multigrid_petsc_tpu_torch.solvers.cycles import (
    _diag_smoother,
    _residual_diag,
)
from multigrid_petsc_tpu_torch.solvers.outer import OuterResult, keep_going
from multigrid_petsc_tpu_torch.utils.config import CycleType


def _restrict_delayed(ops, b: tuple, r: tuple) -> tuple:
    """b[0] kept (f on the finest grid); every coarser grid gets the
    one-gap restriction of the stale residual on the next finer grid."""
    return (b[0],) + tuple(ops.restrict(r[g - 1], g - 1, g)
                           for g in range(1, len(r)))


def _prolong_correct(ops, u: tuple) -> tuple:
    """Every grid but the last corrected by the one-gap prolongation of
    the next coarser grid's current iterate."""
    G = len(u)
    return tuple(u[g] + ops.prolong(u[g + 1], g + 1, g) if g < G - 1
                 else u[g] for g in range(G))


def solve_delayed(ctx: MGContext, kind: CycleType, b0=None) -> OuterResult:
    cfg = ctx.config
    if len(ctx.levels) != 1:
        raise ValueError("delayed cycles require levels == 1")
    lvl = ctx.levels[0]
    G = len(lvl.spec.grids)
    if G < 2:
        raise ValueError("delayed cycles need at least 2 merged grids")
    v = cfg.v[0]
    smooth = _diag_smoother(ctx, lvl)
    residual_diag = _residual_diag(lvl)
    b = ctx.b0 if b0 is None else b0
    ops, norm = lvl.grid_ops, lvl.norm2
    bnorm = float(norm(b))
    u = lvl.zeros()
    r = residual_diag(b, u)
    rn_t = norm(r)
    hist_len = min(cfg.hist_len, cfg.max_iter)
    hist = torch.zeros(hist_len + 1, dtype=rn_t.dtype, device=rn_t.device)
    hist[0] = rn_t

    # moreNorm (reference src/solver.c:1382-1399, 2534-2536): the global
    # and per-grid A1 residual norms before each Jacobi sweep of the first
    # smoothing of every outer iteration and after its last, v + 1 entries
    # per iteration (the reference's max_iter * (v + 1) sizing).
    more = cfg.more_norm
    mon_len = hist_len * (v + 1)
    if more:
        r_global = torch.zeros(mon_len, dtype=rn_t.dtype, device=rn_t.device)
        r_grid = torch.zeros((G, mon_len), dtype=rn_t.dtype,
                             device=rn_t.device)

    def do_smooth(b, u, i, record):
        if not (more and record):
            return smooth(b, u, v)
        for s in range(v + 1):
            rr = residual_diag(b, u)
            idx = min(i * (v + 1) + s, mon_len - 1)
            r_global[idx] = norm(rr)
            for g in range(G):
                r_grid[g, idx] = lvl.grid_norm(g, rr[g])
            if s < v:
                u = smod.jacobi(lvl.apply_diag, lvl.dinv, b, u, 1, cfg.omega)
        return u

    rn, i = float(rn_t), 0
    while keep_going(cfg, i, rn, bnorm):
        if kind == CycleType.D1CYCLE:
            b = _restrict_delayed(ops, b, r)
            u = _prolong_correct(ops, u)
            u = do_smooth(b, u, i, True)
        elif kind == CycleType.D2CYCLE:
            b = _restrict_delayed(ops, b, r)
            u = do_smooth(b, u, i, True)
            u = _prolong_correct(ops, u)
        elif kind == CycleType.D1PSCYCLE:
            u = _prolong_correct(ops, u)
            u = do_smooth(b, u, i, True)
            b = _restrict_delayed(ops, b, r)
            u = do_smooth(b, u, i, False)
        else:
            raise ValueError(f"not a delayed cycle: {kind}")
        r = residual_diag(b, u)
        rn_t = norm(r)
        hist[min(i + 1, hist_len)] = rn_t
        i += 1
        rn = float(rn_t)  # the stop test: the one host read per iteration
    aux = None
    if more:
        # Normalized by the first entry, like the reference
        # (src/solver.c:2593-2603).
        aux = {"r_global": r_global / r_global[0],
               "r_grid": r_grid / r_grid[:, :1]}
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=rn <= cfg.rtol * bnorm, aux=aux)

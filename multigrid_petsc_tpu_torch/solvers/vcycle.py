"""Zero-guess V-cycle: the mg-CG preconditioner (PyTorch counterpart of
``v_cycle``, ``_cycle`` and ``mg_apply`` in
``multigrid_petsc_tpu/solvers/vcycle.py``; reference:
src/solver.c:1414-1575).

Down leg: zero-guess smooth + restricted residual per level (one fused
visit); coarsest: direct solve; up leg: prolong + correct + post-smooth
(one fused visit).  v0 sweeps on fine/mid levels, v1 on the coarsest.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.solvers.context import MGContext


def _visit_sweeps(ctx, l: int, v0: int, v1: int) -> int:
    """Sweeps of level ``l``'s visits: ``cfg.level_v`` when set, else
    (v0 fine/mid, v1 coarsest)."""
    lv = ctx.config.level_v
    L = len(ctx.levels)
    if lv is not None:
        return int(lv[l])
    return v1 if (l == L - 1 and L > 1) else v0


def _cycle(ctx: MGContext, l: int, b: torch.Tensor, v0: int, v1: int,
           tree=None) -> torch.Tensor:
    """Zero-guess V-cycle from level ``l`` down.  ``tree`` =
    (start_level, solver) hands every level from ``start_level`` on to
    the single-launch coarse-tree solver."""
    L = len(ctx.levels)
    lvl = ctx.levels[l]
    k = _visit_sweeps(ctx, l, v0, v1)
    if tree is not None and l == tree[0]:
        return tree[1](b)
    if l == L - 1:
        if L > 1 and lvl.coarse_solve is not None:
            return lvl.coarse_solve(b)
        return lvl.smooth(b, lvl.zeros(), k)
    u, rc1 = lvl.visit_down(b, k)
    u_next = _cycle(ctx, l + 1, ctx.restrict_rc1(l, rc1), v0, v1, tree)
    return lvl.visit_up(b, u, ctx.prolong_half(l, u_next), k)


def v_cycle(ctx: MGContext, b0: torch.Tensor, u0, v0: int, v1: int):
    """One V-cycle on level 0; only the zero initial guess is ported (the
    preconditioner's case)."""
    if u0 is not None:
        raise NotImplementedError(
            "V-cycles from a nonzero guess are not ported yet (ROADMAP.md, "
            "modules left behind: the V-cycle/FMG/Richardson drivers)")
    return _cycle(ctx, 0, b0, v0, v1)


def mg_apply(ctx: MGContext, r: torch.Tensor, v0: int, v1: int):
    """M r: one zero-guess V-cycle (the Krylov preconditioner)."""
    return v_cycle(ctx, r, None, v0, v1)

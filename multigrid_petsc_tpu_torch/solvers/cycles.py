"""The Additive cycle (PyTorch counterpart of ``solve_additive`` in
``multigrid_petsc_tpu/solvers/cycles.py``; reference: src/solver.c:1754-1800).

BPX-style: every level smooths its own share of the residual (the part
its coarser level cannot see, r - P R r) and the corrections are summed
on the way up.  Each smoothing is one K7 launch on the card; the filter
P R and the transfers are plain PyTorch, as in the JAX package.  The I,
E and Additive2 cycles are not ported (ROADMAP, the cycle zoo).
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.solvers.context import MGContext
from multigrid_petsc_tpu_torch.solvers.outer import OuterResult, outer_iterate


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
                         cfg)

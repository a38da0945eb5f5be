"""Multiplicative V-cycle, MG-preconditioned Richardson and FMG drivers
(PyTorch counterpart of ``multigrid_petsc_tpu/solvers/vcycle.py``;
reference: src/solver.c:1414-1575 MultigridVcycle).

Per outer iteration: pre-smooth v0 sweeps on the fine level continuing
from the current u, down leg residual -> restrict -> zero-guess smooth
(v0 sweeps on mid levels, v1 on the coarsest, or the direct solve), up
leg prolong + correct + post-smooth v0 sweeps.  Each level visit is one
fused kernel launch on the card (``LevelCtx.visit_down`` /
``visit_up``); the level-0 up visit also emits the residual the stop test
needs.  The V-cycle drivers use the per-level visits down to the
coarsest level; the single-launch coarse tree serves mg-CG only
(``krylov.mdma_plan``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from multigrid_petsc_tpu_torch.ops.norms import tree_map
from multigrid_petsc_tpu_torch.solvers.context import MGContext
from multigrid_petsc_tpu_torch.solvers.outer import OuterResult, outer_iterate


def _visit_sweeps(ctx, l: int, v0: int, v1: int) -> int:
    """Sweeps of level ``l``'s visits: ``cfg.level_v`` when set, else
    (v0 fine/mid, v1 coarsest)."""
    lv = ctx.config.level_v
    L = len(ctx.levels)
    if lv is not None:
        return int(lv[l])
    return v1 if (l == L - 1 and L > 1) else v0


def _cycle(ctx, l: int, b: torch.Tensor, u: torch.Tensor | None, v0: int,
           v1: int, emit: bool = False, tree=None):
    """The V-cycle recursion from level ``l`` down; ``u=None`` is the zero
    guess.  ``emit`` also returns the final residual b - A u.  ``tree`` =
    (start_level, solver) hands every level from ``start_level`` on to the
    single-launch coarse-tree solver (zero guess, no emit)."""
    L = len(ctx.levels)
    lvl = ctx.levels[l]
    k = _visit_sweeps(ctx, l, v0, v1)
    if tree is not None and l == tree[0]:
        return tree[1](b)
    if l == L - 1:
        if L > 1 and lvl.coarse_solve is not None:
            u = lvl.coarse_solve(b)
        else:
            u = lvl.smooth(b, lvl.zeros() if u is None else u, k)
        return (u, lvl.residual(b, u)) if emit else u
    u, rc1 = lvl.visit_down(b, u, k)
    u_next = _cycle(ctx, l + 1, ctx.restrict_rc1(l, rc1), None, v0, v1,
                    tree=tree)
    return lvl.visit_up(b, u, ctx.prolong_half(l, u_next), k, emit)


def v_cycle(ctx, b0: torch.Tensor, u0: torch.Tensor | None, v0: int,
            v1: int, emit_r: bool = False):
    """One V-cycle on level 0 from ``u0`` (None: zero guess); with
    ``emit_r`` returns (u, b0 - A u)."""
    return _cycle(ctx, 0, b0, u0, v0, v1, emit_r)


def mg_apply(ctx: MGContext, r: torch.Tensor, v0: int, v1: int):
    """M r: one zero-guess V-cycle (the Krylov and Richardson
    preconditioner)."""
    return v_cycle(ctx, r, None, v0, v1)


def mg_apply_dot(ctx: MGContext, r: torch.Tensor, v0: int, v1: int):
    """(M r, <r, M r>): the preconditioner application with its CG inner
    product emitted by the level-0 up visit (K9's correcting u visit with
    its dot; JAX vcycle.py:87-103).  Only for contexts whose level 0 has
    the fused CG kernels (the fused mg-CG route)."""
    lvl0 = ctx.levels[0]
    k = _visit_sweeps(ctx, 0, v0, v1)
    u, rc1 = lvl0.visit_down(r, None, k)
    u_next = _cycle(ctx, 1, ctx.restrict_rc1(0, rc1), None, v0, v1)
    return lvl0.visit_up_dot(r, u, ctx.prolong_half(0, u_next), k)


def mg_apply_cgdown(ctx: MGContext, r, ap, alpha, v0: int, v1: int):
    """One fused-CG preconditioner application with the CG residual update
    folded into the level-0 down visit (K10):

        r' = r - alpha ap;  z = M r';  returns (z, <r', z>, r', ||r'||^2)

    Only for contexts whose level 0 has the fused CG kernels (JAX
    vcycle.py:106-122)."""
    lvl0 = ctx.levels[0]
    k = _visit_sweeps(ctx, 0, v0, v1)
    u0, rc1, r_new, rn2 = lvl0.cg_visit_down(r, ap, alpha, k)
    u_next = _cycle(ctx, 1, ctx.restrict_rc1(0, rc1), None, v0, v1)
    z, rz = lvl0.visit_up_dot(r_new, u0, ctx.prolong_half(0, u_next), k)
    return z, rz, r_new, rn2


def solve_vcycle(ctx: MGContext, b0: torch.Tensor | None = None) -> OuterResult:
    cfg = ctx.config
    v0, v1 = cfg.v

    def step(b, u):
        return v_cycle(ctx, b, u, v0, v1, emit_r=True)

    return outer_iterate(step, ctx.levels[0].residual,
                         ctx.b0 if b0 is None else b0, ctx.levels[0].zeros(),
                         cfg, step_emits_residual=True,
                         norm=ctx.levels[0].norm2)


def solve_mg_richardson(ctx: MGContext,
                        b0: torch.Tensor | None = None) -> OuterResult:
    """MG-preconditioned Richardson, u += M (b - A u): the equivalent of
    the reference's PCMG cross-check (src/solver.c:1884-1989).  For linear
    smoothers it is algebraically the V-cycle iteration, kept separate so
    the two can be tested against each other."""
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]

    def step(b, u):
        return tree_map(lambda uk, ek: uk + ek, u,
                        mg_apply(ctx, lvl0.residual(b, u), v0, v1))

    return outer_iterate(step, lvl0.residual, ctx.b0 if b0 is None else b0,
                         lvl0.zeros(), cfg, norm=lvl0.norm2)


class _TruncatedCtx:
    """View of an MGContext from level ``start`` down (for FMG): the
    subset of MGContext that ``v_cycle`` uses."""

    def __init__(self, ctx: MGContext, start: int):
        self._ctx = ctx
        self._start = start
        self.levels = ctx.levels[start:]
        lv = ctx.config.level_v
        self.config = (ctx.config if lv is None else dataclasses.replace(
            ctx.config, level_v=tuple(lv[start:])))

    def restrict_rc1(self, l, rc1):
        return self._ctx.restrict_rc1(self._start + l, rc1)

    def prolong_half(self, l, u_next):
        return self._ctx.prolong_half(self._start + l, u_next)


def fmg_initial_guess(ctx: MGContext, b0: torch.Tensor | None = None,
                      n_coarse_cycles: int = 1) -> torch.Tensor:
    """Full-multigrid start: restrict the right-hand side to every level,
    solve the coarsest, then prolong upward with ``n_coarse_cycles``
    V-cycles on each truncated hierarchy (nonzero guesses throughout)."""
    cfg = ctx.config
    v0, v1 = cfg.v
    L = len(ctx.levels)
    bs = [ctx.b0 if b0 is None else b0]
    for l in range(L - 1):
        bs.append(ctx.restrict_to_next(l, bs[l]))
    last = ctx.levels[L - 1]
    if L > 1 and last.coarse_solve is not None:
        u = last.coarse_solve(bs[L - 1])
    else:
        u = last.smooth(bs[L - 1], last.zeros(),
                        _visit_sweeps(ctx, L - 1, v0, v1))
    for l in range(L - 2, -1, -1):
        u = ctx.prolong_from_next(l, u)
        sub = _TruncatedCtx(ctx, l)
        for _ in range(n_coarse_cycles):
            u = v_cycle(sub, bs[l], u, v0, v1)
    return u


def solve_fmg(ctx: MGContext, b0: torch.Tensor | None = None) -> OuterResult:
    """FMG start followed by V-cycle iteration to tolerance."""
    cfg = ctx.config
    v0, v1 = cfg.v

    def step(b, u):
        return v_cycle(ctx, b, u, v0, v1, emit_r=True)

    b = ctx.b0 if b0 is None else b0
    return outer_iterate(step, ctx.levels[0].residual, b,
                         fmg_initial_guess(ctx, b), cfg,
                         step_emits_residual=True, norm=ctx.levels[0].norm2)

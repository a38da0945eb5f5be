"""Preconditioned CG with one V-cycle as M (PyTorch counterpart of
``solve_mgcg``, ``build_coarse_tree``, ``mdma_plan`` and
``_solve_mgcg_fused_mdma`` in ``multigrid_petsc_tpu/solvers/krylov.py``;
reference analogue: the PCMG cross-check path, src/solver.c:1884-1989).

The standard PCG formulas hold verbatim for the negative-definite
discrete Laplacian (both inner products flip sign, ratios stay positive).
The loop runs on the host; alpha, beta, the inner products and ||r|| stay
0-d tensors on the device, which the kernels read by pointer, so the only
host read per iteration is the stop test.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.ops.norms import tree_dot, tree_norm2
from multigrid_petsc_tpu_torch.solvers.coarse import dense_from_stencil
from multigrid_petsc_tpu_torch.solvers.context import MGContext
from multigrid_petsc_tpu_torch.solvers.outer import OuterResult, keep_going
from multigrid_petsc_tpu_torch.solvers.vcycle import _cycle, _visit_sweeps, mg_apply


def solve_mgcg(ctx: MGContext, b0: torch.Tensor | None = None) -> OuterResult:
    """mg-CG.  Hierarchies of two or more levels run the fused plan
    (``_solve_mgcg_fused_mdma``); a 1-level hierarchy runs the generic
    PCG loop (A p through K6, the smoother through K7 on the card)."""
    b = ctx.b0 if b0 is None else b0
    if len(ctx.levels) > 1:
        return _solve_mgcg_fused_mdma(ctx, b)
    return _solve_mgcg_generic(ctx, b)


def _solve_mgcg_generic(ctx: MGContext, b: torch.Tensor) -> OuterResult:
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    hist_len = cfg.hist_len
    bnorm = float(tree_norm2(b))
    u = lvl0.zeros()
    r = lvl0.residual(b, u)
    rn = tree_norm2(r)
    z = mg_apply(ctx, r, v0, v1)
    p = z
    rz = tree_dot(r, z)
    zero = torch.zeros((), dtype=rz.dtype, device=rz.device)
    hist = torch.zeros(hist_len + 1, dtype=rn.dtype, device=rn.device)
    hist[0] = rn
    i = 0
    while keep_going(cfg, i, float(rn), bnorm):
        ap = lvl0.apply(p)
        # Breakdown guards: once the f32 residual floors, pap/rz can hit
        # exact 0; guarded ratios turn that into a harmless stall.
        pap = tree_dot(p, ap)
        alpha = torch.where(pap != 0, rz / pap, zero)
        u = u + alpha * p
        r = r - alpha * ap
        rn = tree_norm2(r)
        z = mg_apply(ctx, r, v0, v1)
        rz_new = tree_dot(r, z)
        beta = torch.where(rz != 0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
        hist[min(i + 1, hist_len)] = rn
        i += 1
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=float(rn) <= cfg.rtol * bnorm)


def build_coarse_tree(ctx: MGContext):
    """(start_level, solver) for the single-launch coarse-tree kernel, or
    None: the earliest level from which every remaining level passes
    ``coarse_tree_viable`` (the JAX package's rule, so the split matches
    it call for call: level 3 at 8193^2/11 levels, level 1 at 513^2/7)."""
    cfg = ctx.config
    v0, v1 = cfg.v
    L = len(ctx.levels)
    itemsize = torch.empty((), dtype=ctx.dtype).element_size()
    for l_t in range(1, L - 1):
        lv = ctx.levels[l_t:]
        shapes = [l.shape for l in lv]
        if not ctk.coarse_tree_viable(shapes, itemsize):
            continue
        steps_list = [l.steps_fn(_visit_sweeps(ctx, l_t + j, v0, v1))
                      for j, l in enumerate(lv)]
        a_inv = None
        if lv[-1].coarse_solve is not None:
            if not ctk.coarse_tree_viable(shapes, itemsize, direct=True):
                continue  # coarsest too large for the in-kernel dense solve
            a_inv = np.linalg.inv(dense_from_stencil(lv[-1].stencil,
                                                     *shapes[-1]))
        fn = ctk.make_coarse_tree_solver([l.stencil for l in lv], shapes,
                                         steps_list, a_inv=a_inv)
        return l_t, fn
    return None


def mdma_plan(ctx: MGContext) -> dict:
    """The fused solve's data plan as named closures.

    ``precond(r, ap, alpha)`` = (z, <r', z>, r', ||r'||^2) with
    r' = r - alpha ap and z = M r': level 0 runs the CG down visit (K2a)
    and the dot-emitting up visit (K3); levels 1.. run the zero-guess
    visits (K2b, K3) down to the coarse tree (K4), which solves the rest.
    """
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    st = lvl0.stencil
    steps = lvl0.steps_fn(_visit_sweeps(ctx, 0, v0, v1))
    tree = build_coarse_tree(ctx)

    def coarse_correction(rc):
        """Everything between the level-0 down and up visits."""
        return ctx.prolong_half(
            0, _cycle(ctx, 1, ctx.restrict_rc1(0, rc), None, v0, v1,
                      tree=tree))

    def precond(r, ap, alpha):
        u0, rc, r_new, rn2 = mdma.cg_visit_down(st, r, ap, alpha, steps)
        z, rz = mdma.visit_up(st, r_new, u0, coarse_correction(rc), steps,
                              emit_dot=True)
        return z, rz, r_new, rn2

    return {"precond": precond, "coarse_correction": coarse_correction}


def _solve_mgcg_fused_mdma(ctx: MGContext, b: torch.Tensor) -> OuterResult:
    """PCG over the fused visit kernels.  Algebraically identical to the
    generic loop: the CG residual update rides the level-0 down visit,
    the preconditioner inner product the level-0 up visit, and the
    solution update u += alpha p rides the NEXT iteration's direction
    kernel with the lagged alpha (flushed once after the loop).
    Differences from the generic path are reduction order only."""
    cfg = ctx.config
    st = ctx.levels[0].stencil
    hist_len = cfg.hist_len
    precond = mdma_plan(ctx)["precond"]

    bnorm_t = tree_norm2(b)
    bnorm = float(bnorm_t)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    z, rz, r, _ = precond(b, torch.zeros_like(b), zero)
    u = torch.zeros_like(b)
    p = torch.zeros_like(b)
    beta = alpha_prev = zero
    hist = torch.zeros(hist_len + 1, dtype=b.dtype, device=b.device)
    hist[0] = bnorm_t  # u0 = 0 -> r0 = b exactly
    rn = bnorm
    i = 0
    while keep_going(cfg, i, rn, bnorm):
        p, ap, u, pap = mdma.cg_papply_u(st, z, p, u, alpha_prev, beta)
        alpha = torch.where(pap != 0, rz / pap, zero)  # breakdown guard
        z, rz_new, r, rn2 = precond(r, ap, alpha)
        rn_t = torch.sqrt(rn2)
        beta = torch.where(rz != 0, rz_new / rz, zero)
        hist[min(i + 1, hist_len)] = rn_t
        rz, alpha_prev = rz_new, alpha
        i += 1
        rn = float(rn_t)  # the stop test: the one host read per iteration
    # Flush the lagged update: the last alpha was never applied in-loop.
    u = u + alpha_prev * p
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=rn <= cfg.rtol * bnorm)

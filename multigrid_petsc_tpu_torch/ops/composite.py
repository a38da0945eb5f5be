"""Merged-grid ("composite") level operators (PyTorch counterpart of
``multigrid_petsc_tpu/ops/composite.py``; reference: src/solver.c:255-556
fillRestrictionPortion / fillProlongationPortion / levelMatrixA, A1, A2).

A merged level holds several grids in one linear system whose matrix has
each grid's own 5-point block plus the coupling blocks R A_f (restriction
of a finer grid's operator) and A_f P (a finer operator times
prolongation).  Matrix-free, over a tuple of per-grid tensors:

    y_f  = A_f u_f                  (diagonal block, every grid)
    y_c += R_{f->c} (A_f u_f)       (restriction portion, f finer than c)
    y_f += A_f (P_{c->f} u_c)       (prolongation portion)

Each A_f runs through K6 (``stencil_kernel.apply_stencil5``) on the card,
its plain version on the CPU; the multi-gap transfers are plain PyTorch,
as the JAX package runs them outside its kernels.  ``include_diag`` /
``include_couplings`` select A, A1 (diagonal blocks only) or A2
(couplings only), as the E-cycle splits them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from multigrid_petsc_tpu_torch.ops.cuda.stencil_kernel import apply_stencil5
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5
from multigrid_petsc_tpu_torch.ops.transfer import prolong_multi, restrict_multi


def composite_apply(stencils: Sequence[Stencil5], gids: tuple[int, ...], u,
                    include_diag: bool = True,
                    include_couplings: bool = True) -> tuple:
    """The merged level's matvec over the tuple ``u`` (grids ascending by
    id, ``stencils[k]`` grid k's operator)."""
    k = len(u)
    au = [apply_stencil5(stencils[i], u[i]) for i in range(k)]
    y = list(au) if include_diag else [torch.zeros_like(x) for x in u]
    if include_couplings:
        for kf in range(k):
            for kc in range(kf + 1, k):
                gap = gids[kc] - gids[kf]
                y[kc] = y[kc] + restrict_multi(au[kf], gap)
                y[kf] = y[kf] + apply_stencil5(stencils[kf],
                                               prolong_multi(u[kc], gap))
    return tuple(y)


def composite_residual(stencils, gids, b, u, **kw) -> tuple:
    au = composite_apply(stencils, gids, u, **kw)
    return tuple(bb - aa for bb, aa in zip(b, au))


def composite_rhs(f_fine: torch.Tensor, gids: tuple[int, ...]) -> tuple:
    """A merged level-0 rhs: f on the primary grid, the composed
    restrictions of f on the coarser grids (src/solver.c:558-620)."""
    return (f_fine,) + tuple(restrict_multi(f_fine, g - gids[0])
                             for g in gids[1:])

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

The grid operations come from an operator set (``GridOps``): on one
device each A_f runs through K6 (``stencil_kernel.apply_stencil5``) on the
card, its plain version on the CPU, and the multi-gap transfers are plain
PyTorch, as the JAX package runs them outside its kernels.  Under a plan
``parallel.dist_ops.DistMergedOps`` is the same set on the ranks' blocks,
row blocks under the rows layout and 2-D blocks under the blocks layout
(K17 on a sharded grid), so one body serves all three.
``include_diag`` / ``include_couplings`` select A, A1 (diagonal blocks
only) or A2 (couplings only), as the E-cycle splits them.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda.stencil_kernel import (
    apply_stencil5,
    smooth_sweeps,
)
from multigrid_petsc_tpu_torch.ops.norms import tree_dot, tree_norm2
from multigrid_petsc_tpu_torch.ops.transfer import prolong_multi, restrict_multi


class GridOps:
    """A merged level's per-grid operations on one device, grid k of
    ``stencils`` with id ``gids[k]``: A_k (K6), k Jacobi-type steps on
    grid k's own block (K7), the multi-gap transfers between two of its
    grids, the level's inner product and one grid's norm."""

    def __init__(self, stencils, gids):
        self.stencils = tuple(stencils)
        self.gids = tuple(gids)

    @property
    def sharded(self) -> tuple[bool, ...]:
        return (False,) * len(self.gids)

    def apply(self, k: int, x):
        return apply_stencil5(self.stencils[k], x)

    def smooth(self, k: int, b, x, steps):
        return smooth_sweeps(self.stencils[k], b, x, steps)

    def restrict(self, x, kf: int, kc: int):
        """x on grid kf restricted onto the coarser grid kc."""
        return restrict_multi(x, self.gids[kc] - self.gids[kf])

    def prolong(self, x, kc: int, kf: int):
        """x on grid kc prolonged onto the finer grid kf."""
        return prolong_multi(x, self.gids[kc] - self.gids[kf])

    def dot(self, x, y):
        return tree_dot(x, y)

    def grid_norm(self, k: int, x):
        return tree_norm2(x)

    def local(self, state):
        return state

    def real_rows(self, state):
        return state

    def gathered(self, solve):
        return solve


def composite_apply(ops: GridOps, u, include_diag: bool = True,
                    include_couplings: bool = True) -> tuple:
    """The merged level's matvec over the tuple ``u`` (grids ascending by
    id)."""
    k = len(u)
    au = [ops.apply(i, u[i]) for i in range(k)]
    y = list(au) if include_diag else [torch.zeros_like(x) for x in u]
    if include_couplings:
        for kf in range(k):
            for kc in range(kf + 1, k):
                y[kc] = y[kc] + ops.restrict(au[kf], kf, kc)
                y[kf] = y[kf] + ops.apply(kf, ops.prolong(u[kc], kc, kf))
    return tuple(y)


def composite_residual(ops: GridOps, b, u, **kw) -> tuple:
    au = composite_apply(ops, u, **kw)
    return tuple(bb - aa for bb, aa in zip(b, au))


def composite_rhs(f_fine: torch.Tensor, gids: tuple[int, ...]) -> tuple:
    """A merged level-0 rhs: f on the primary grid, the composed
    restrictions of f on the coarser grids (src/solver.c:558-620)."""
    return (f_fine,) + tuple(restrict_multi(f_fine, g - gids[0])
                             for g in gids[1:])

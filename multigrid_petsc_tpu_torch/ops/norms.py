"""Inner products and norms over level states (PyTorch counterpart of
``multigrid_petsc_tpu/ops/norms.py``).  A state is one tensor for a
single-grid level and a tuple of per-grid tensors for a merged level;
norms run over all grids, as the reference's VecNorm over the whole
composite vector (src/solver.c:1512, 2237)."""

from __future__ import annotations

import torch


def _vec(x: torch.Tensor) -> torch.Tensor:
    """x flat, bf16 storage upcast to f32: a dot of bf16 states comes out
    in f32, as the kernels' dots do."""
    x = x.reshape(-1)
    return x.float() if x.dtype == torch.bfloat16 else x


def tree_dot(x, y) -> torch.Tensor:
    """<x, y> as a 0-d tensor on the operands' device (f32 for bf16
    storage)."""
    if isinstance(x, torch.Tensor):
        return torch.dot(_vec(x), _vec(y))
    total = None
    for a, b in zip(x, y):
        s = torch.dot(_vec(a), _vec(b))
        total = s if total is None else total + s
    return total


def tree_norm2(x) -> torch.Tensor:
    """l2 norm over all grids (reference: VecNorm NORM_2)."""
    return torch.sqrt(tree_dot(x, x))


def tree_map(fn, x, *rest):
    """``fn`` per grid over one or more states of the same kind."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    return tuple(fn(*z) for z in zip(x, *rest))


def flatten(x) -> torch.Tensor:
    """A state as one flat vector, grid after grid."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)
    return torch.cat([g.reshape(-1) for g in x])


def unflatten(vec: torch.Tensor, shapes):
    """The inverse of ``flatten``: a tensor for one grid, a tuple for
    several."""
    if len(shapes) == 1:
        return vec.reshape(shapes[0])
    out, off = [], 0
    for ny, nx in shapes:
        out.append(vec[off : off + ny * nx].reshape(ny, nx))
        off += ny * nx
    return tuple(out)

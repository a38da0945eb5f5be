"""Matrix-free 5-point stencil operator on dense interior grids.

PyTorch counterpart of ``multigrid_petsc_tpu/ops/stencil.py`` (the
Stencil5 slice).  The operator acts on an (ny, nx) array of interior
unknowns with the homogeneous-Dirichlet boundary eliminated: out-of-range
neighbours contribute zero (reference: src/solver.c:239-251).

Convention (src/solver.c:218-252): row index i = y, column j = x; ``cs``
multiplies u[i-1, j] (south), ``cw`` u[i, j-1] (west), ``cc`` u[i, j],
``ce`` u[i, j+1] (east), ``cn`` u[i+1, j] (north).  Coefficients are
(ny, 1) columns: the metrics of the tensor-product meshes depend on y
only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Stencil5(NamedTuple):
    """5-point stencil coefficients, each an (ny, 1) column."""

    cs: torch.Tensor
    cw: torch.Tensor
    cc: torch.Tensor
    ce: torch.Tensor
    cn: torch.Tensor


def from_numpy_stencil(cols, device: torch.device | str,
                       dtype: torch.dtype) -> Stencil5:
    """Stencil5 from five host arrays in (cs, cw, cc, ce, cn) order, each
    broadcastable to an (ny, 1) column — e.g. coefficients computed by the
    JAX package and carried over as numpy arrays."""
    arrs = [np.asarray(c) for c in cols]
    ny = max(a.reshape(-1, 1).shape[0] for a in arrs)
    return Stencil5(*(
        torch.as_tensor(np.broadcast_to(a.reshape(-1, 1), (ny, 1)).copy(),
                        dtype=dtype, device=device)
        for a in arrs
    ))


def apply_stencil5(st: Stencil5, u: torch.Tensor) -> torch.Tensor:
    """y = A u (zero Dirichlet ring, same term order as the JAX package)."""
    p = F.pad(u[None, None], (1, 1, 1, 1))[0, 0]
    return (
        st.cc * u
        + st.cs * p[:-2, 1:-1]
        + st.cn * p[2:, 1:-1]
        + st.cw * p[1:-1, :-2]
        + st.ce * p[1:-1, 2:]
    )


def residual(st: Stencil5, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r = b - A u."""
    return b - apply_stencil5(st, u)

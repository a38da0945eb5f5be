"""Inter-grid transfers: full-weighting restriction and bilinear
prolongation, one gap and composed over several (PyTorch counterpart of
``multigrid_petsc_tpu/ops/transfer.py``; reference stencils
src/matbuild.c:355-431).

A grid with n interior points per dim coarsens to (n - 1)/2; coarse point
(I, J) coincides with fine point (2I+1, 2J+1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The 3x3 stencils (src/matbuild.c:398-431).
RESTRICT_3x3 = np.array(
    [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16.0
PROLONG_3x3 = np.array(
    [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 4.0


def restrict_fw(r: torch.Tensor) -> torch.Tensor:
    """Full weighting [1,2,1]x[1,2,1]/16, fine (2n+1, 2m+1) -> coarse
    (n, m); y pass first, then x (the JAX package's order)."""
    rows = r[0:-2:2, :] + 2.0 * r[1::2, :] + r[2::2, :]
    out = rows[:, 0:-2:2] + 2.0 * rows[:, 1::2] + rows[:, 2::2]
    return 0.0625 * out


def prolong_bilinear(e: torch.Tensor) -> torch.Tensor:
    """Bilinear prolongation, coarse (n, m) -> fine (2n+1, 2m+1), with a
    zero Dirichlet ring around the coarse grid: odd fine rows/columns copy
    the coarse value, even ones average their two coarse neighbours."""
    n, m = e.shape
    p = F.pad(e[None, None], (1, 1, 1, 1))[0, 0]
    ph = (p[:, :-1] + p[:, 1:]) * 0.5  # horizontal midpoints (n+2, m+1)
    pv = (p[:-1, :] + p[1:, :]) * 0.5  # vertical midpoints (n+1, m+2)
    pc = (p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]) * 0.25
    out = e.new_empty((2 * n + 1, 2 * m + 1))
    out[0::2, 0::2] = pc
    out[0::2, 1::2] = pv[:, 1:-1]
    out[1::2, 0::2] = ph[1:-1, :]
    out[1::2, 1::2] = e
    return out


def restrict_multi(r: torch.Tensor, gap: int) -> torch.Tensor:
    """Restriction across ``gap`` grid levels: ``gap`` full weightings
    (the reference's composed stencil, src/matbuild.c:355-396)."""
    for _ in range(gap):
        r = restrict_fw(r)
    return r


def prolong_multi(e: torch.Tensor, gap: int) -> torch.Tensor:
    """Prolongation across ``gap`` grid levels: ``gap`` bilinears."""
    for _ in range(gap):
        e = prolong_bilinear(e)
    return e


def composed_transfer_stencil(base3x3: np.ndarray, gap: int) -> np.ndarray:
    """The explicit transfer stencil of a ``gap``-level jump, sizes 3, 7,
    15, ..., 2^(gap+1) - 1: the reference's stencil composition
    (src/matbuild.c:355-396), on the host, as the JAX package makes it."""
    w = np.asarray(base3x3, dtype=np.float64)
    cur = w.copy()
    for _ in range(gap - 1):
        nl = cur.shape[0]
        nxt = np.zeros((2 * nl + 1, 2 * nl + 1))
        for il in range(nl):
            for jl in range(nl):
                nxt[2 * il:2 * il + 3, 2 * jl:2 * jl + 3] += w * cur[il, jl]
        cur = nxt
    return cur

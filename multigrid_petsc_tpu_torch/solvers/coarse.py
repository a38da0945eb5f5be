"""Coarsest-level direct solver (PyTorch counterpart of the single-grid
slice of ``multigrid_petsc_tpu/solvers/coarse.py``), for the 5- and the
9-point stencil.

The dense operator is assembled analytically on the host and inverted
there in f64 with numpy, once at setup; each application is one small
dense matvec ``a_inv @ b`` on the level's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def dense_from_stencil(st, ny: int, nx: int) -> np.ndarray:
    """Dense (N, N) f64 matrix of a 5- or 9-point stencil with the
    Dirichlet boundary eliminated (reference analogue:
    src/solver.c:185-253)."""
    N = ny * nx
    a = np.zeros((N, N))
    ii, jj = np.mgrid[0:ny, 0:nx]
    rows = (ii * nx + jj).ravel()

    def bcast(c):
        c = c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else c
        return np.broadcast_to(np.asarray(c, np.float64), (ny, nx)).ravel()

    # (name, dy, dx); a Stencil5 lacks the corners.
    for name, dy, dx in (("cc", 0, 0), ("cs", -1, 0), ("cn", 1, 0),
                         ("cw", 0, -1), ("ce", 0, 1), ("csw", -1, -1),
                         ("cse", -1, 1), ("cnw", 1, -1), ("cne", 1, 1)):
        if not hasattr(st, name):
            continue
        i2, j2 = ii + dy, jj + dx
        ok = ((i2 >= 0) & (i2 < ny) & (j2 >= 0) & (j2 < nx)).ravel()
        cols = (i2 * nx + j2).ravel()
        a[rows[ok], cols[ok]] = bcast(getattr(st, name))[ok]
    return a


def build_direct_solver(st, shape: tuple[int, int]) -> Callable:
    """b -> A^-1 b for the level with stencil ``st`` and ``shape``; the
    inverse is taken on the host in f64 and stored in the stencil's dtype
    on the stencil's device."""
    ny, nx = shape
    a_inv = torch.as_tensor(np.linalg.inv(dense_from_stencil(st, ny, nx)),
                            dtype=st.cc.dtype, device=st.cc.device)

    def solve(b: torch.Tensor) -> torch.Tensor:
        return (a_inv @ b.reshape(-1)).reshape(ny, nx)

    solve.a_inv = a_inv
    return solve

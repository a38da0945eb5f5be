"""Coarsest-level solvers (PyTorch counterpart of
``multigrid_petsc_tpu/solvers/coarse.py``).

Direct: the dense operator is assembled on the host (analytically from a
5- or 9-point stencil, or, for a merged level, from its assembled CSR)
and inverted there in f64 with numpy, once at setup; each application is
one small dense matvec ``a_inv @ b`` on the level's device.  On bf16
storage (the bf16 working dtype's coarsest level, matrix-free or sparse)
the inverse is rounded to bf16 once at set-up and each matvec sums in
f32, its result rounded once.  CG: a fixed
number of matrix-free CG iterations over the level's operator, for a
coarsest level too large to densify.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.norms import flatten, unflatten


def dense_from_stencil(st, ny: int, nx: int) -> np.ndarray:
    """Dense (N, N) f64 matrix of a 5- or 9-point stencil with the
    Dirichlet boundary eliminated (reference analogue:
    src/solver.c:185-253)."""
    N = ny * nx
    a = np.zeros((N, N))
    ii, jj = np.mgrid[0:ny, 0:nx]
    rows = (ii * nx + jj).ravel()

    def bcast(c):
        if isinstance(c, torch.Tensor):  # any storage type, bf16 included
            c = c.detach().cpu().to(torch.float64).numpy()
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


def dense_from_csr(indptr, indices, data) -> np.ndarray:
    """Dense (N, N) f64 matrix of a host CSR triple (a merged coarsest
    level's assembled operator)."""
    n = len(indptr) - 1
    a = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    a[rows, np.asarray(indices)] = np.asarray(data)
    return a


def dense_solver(a: np.ndarray, shapes, dtype: torch.dtype,
                 device: torch.device) -> Callable:
    """b -> A^-1 b over a state of grids ``shapes`` (a tensor for one
    grid, a tuple for several); the inverse is taken on the host in f64
    and stored in ``dtype`` (the level's: f32, f64 or bf16, as JAX's
    build_direct_solver) on ``device``, where each application is one
    matmul in that type (its sums in f32 for bf16)."""
    a_inv = torch.as_tensor(np.linalg.inv(a), dtype=dtype, device=device)

    def solve(b):
        return unflatten(a_inv @ flatten(b), shapes)

    solve.a_inv = a_inv
    return solve


def build_direct_solver(st, shape: tuple[int, int]) -> Callable:
    """b -> A^-1 b for the single-grid level with stencil ``st`` and
    ``shape``."""
    return dense_solver(dense_from_stencil(st, *shape), [shape], st.cc.dtype,
                        st.cc.device)


def build_cg_solver(apply_fn: Callable, shapes, iters: int = 64,
                    dot: Callable | None = None) -> Callable:
    """Fixed-iteration CG over ``apply_fn`` (valid for the
    negative-definite operator: both inner products flip sign), as the
    JAX package runs it.  The fixed count keeps the coarse solve linear,
    so the Krylov outers stay consistent.  ``dot(x, y)`` over states (the
    level's: each sharded grid's summed over the ranks that hold its
    distinct blocks) defaults to the local one."""

    def vdot(x, y):
        if dot is None:
            return torch.dot(x, y)
        return dot(unflatten(x, shapes), unflatten(y, shapes))

    def solve(b_state):
        b = flatten(b_state)
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        x = torch.zeros_like(b)
        r = p = b
        rr = vdot(r, r)
        for _ in range(iters):
            ap = flatten(apply_fn(unflatten(p, shapes)))
            denom = vdot(p, ap)
            alpha = torch.where(denom != 0, rr / denom, zero)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = vdot(r, r)
            beta = torch.where(rr != 0, rr_new / rr, zero)
            p = r + beta * p
            rr = rr_new
        return unflatten(x, shapes)

    return solve

"""Matrix-free 5- and 9-point stencil operators on dense interior grids,
and the y-line relaxation built on them.

PyTorch counterpart of ``multigrid_petsc_tpu/ops/stencil.py`` (Stencil5,
Stencil9, PCR, red-black Gauss-Seidel and the y- and x-line Jacobi
smoothers).  The operators act on an
(ny, nx) array of interior unknowns with the homogeneous-Dirichlet
boundary eliminated: out-of-range neighbours contribute zero (reference:
src/solver.c:239-251).

Convention (src/solver.c:218-252): row index i = y, column j = x; ``cs``
multiplies u[i-1, j] (south), ``cw`` u[i, j-1] (west), ``cc`` u[i, j],
``ce`` u[i, j+1] (east), ``cn`` u[i+1, j] (north); the 9-point corners
``csw``, ``cse``, ``cnw``, ``cne`` u[i-1, j-1], u[i-1, j+1], u[i+1, j-1],
u[i+1, j+1].  Stencil5 coefficients are (ny, 1) columns (the metrics of
the tensor-product meshes depend on y only); Stencil9 coefficients keep
their broadcast shape: (1, 1), (1, nx), (ny, 1) or (ny, nx).
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


class Stencil9(NamedTuple):
    """9-point stencil coefficients, each broadcastable to (ny, nx):
    c[dy][dx] for dy, dx in {-1, 0, +1} (s = i-1, n = i+1, w = j-1,
    e = j+1)."""

    csw: torch.Tensor
    cs: torch.Tensor
    cse: torch.Tensor
    cw: torch.Tensor
    cc: torch.Tensor
    ce: torch.Tensor
    cnw: torch.Tensor
    cn: torch.Tensor
    cne: torch.Tensor


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


def from_numpy_stencil9(arrs, device: torch.device | str,
                        dtype: torch.dtype) -> Stencil9:
    """Stencil9 from nine host arrays in (csw, cs, cse, cw, cc, ce, cnw,
    cn, cne) order, each keeping its broadcast shape (a scalar becomes
    (1, 1)) — the JAX package's coefficients carried over as numpy."""
    return Stencil9(*(
        torch.as_tensor(np.array(a, ndmin=2).copy(), dtype=dtype,
                        device=device)
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


def apply_stencil9(st: Stencil9, u: torch.Tensor) -> torch.Tensor:
    """y = A u, 9-point (the JAX package's term order: cc, s, n, w, e,
    sw, se, nw, ne)."""
    p = F.pad(u[None, None], (1, 1, 1, 1))[0, 0]
    return (
        st.cc * u
        + st.cs * p[:-2, 1:-1]
        + st.cn * p[2:, 1:-1]
        + st.cw * p[1:-1, :-2]
        + st.ce * p[1:-1, 2:]
        + st.csw * p[:-2, :-2]
        + st.cse * p[:-2, 2:]
        + st.cnw * p[2:, :-2]
        + st.cne * p[2:, 2:]
    )


def apply_stencil(st, u: torch.Tensor) -> torch.Tensor:
    """y = A u for a Stencil5 or a Stencil9."""
    return (apply_stencil9 if isinstance(st, Stencil9)
            else apply_stencil5)(st, u)


def residual(st, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r = b - A u."""
    return b - apply_stencil(st, u)


def redblack_dinv(st: Stencil5, shape, omega: float):
    """(red, black): omega / cc on the points of one colour of the
    checkerboard ((i + j) even is red), 0 on the others, each (ny, nx)."""
    ny, nx = shape
    ii = torch.arange(ny, device=st.cc.device)[:, None]
    jj = torch.arange(nx, device=st.cc.device)[None, :]
    red = (ii + jj) % 2 == 0
    d = (omega / st.cc).expand(ny, nx)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.where(red, d, zero), torch.where(red, zero, d)


def sor_redblack_sweeps(st: Stencil5, b: torch.Tensor, u: torch.Tensor,
                        sweeps: int, omega: float = 1.0,
                        residual_fn=residual,
                        dinv_rb: tuple | None = None) -> torch.Tensor:
    """Red-black Gauss-Seidel / SOR: two masked half-sweeps per sweep, red
    first, each u + (omega / cc) (b - A u) on its colour (the JAX
    package's arithmetic).  A half-sweep is one ``residual_fn(st, b, u)``
    and one multiply-add with that colour's masked D^-1 (``dinv_rb``,
    ``redblack_dinv``; made here when not given), which is 0 on the other
    colour."""
    if dinv_rb is None:
        dinv_rb = redblack_dinv(st, u.shape, omega)
    for _ in range(sweeps):
        for d in dinv_rb:
            u = torch.addcmul(u, d, residual_fn(st, b, u))
    return u


def _shift_fwd(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """y[i] = x[i - s] (rows shifted toward larger i), ``fill`` outside."""
    pad = torch.full((s,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:-s]], dim=0)


def _shift_bwd(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """y[i] = x[i + s], ``fill`` outside."""
    pad = torch.full((s,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[s:], pad], dim=0)


class PCRFactor(NamedTuple):
    """Parallel-cyclic-reduction factorization of tridiagonal systems:
    the per-step elimination multipliers (step k uses stride 2**k) and
    the inverse of the fully reduced diagonal."""

    alphas: tuple  # per-step -a_i / d_{i-s}, broadcastable to (n, w)
    gammas: tuple  # per-step -c_i / d_{i+s}
    dinv: torch.Tensor  # 1 / fully-reduced diagonal


def pcr_factor(dl, d, du, n: int) -> PCRFactor:
    """The PCR elimination for the n x n tridiagonal systems (dl, d, du)
    (each broadcastable to (n, w); dl[0], du[n-1] ignored), computed as
    the JAX package computes it."""
    shape = torch.broadcast_shapes(dl.shape, d.shape, du.shape, (n, 1))
    a = dl.broadcast_to(shape).clone()
    a[0] = 0.0
    dd = d.broadcast_to(shape).clone()
    c = du.broadcast_to(shape).clone()
    c[-1] = 0.0
    alphas, gammas = [], []
    s = 1
    while s < n:
        # Equations at i-s / i+s; out-of-range rows are identity equations
        # (d=1, a=c=0, r=0), which leave eq i unchanged there.
        alpha = -a / _shift_fwd(dd, s, 1.0)
        gamma = -c / _shift_bwd(dd, s, 1.0)
        dd = (dd + alpha * _shift_fwd(c, s, 0.0)
              + gamma * _shift_bwd(a, s, 0.0))
        a = alpha * _shift_fwd(a, s, 0.0)
        c = gamma * _shift_bwd(c, s, 0.0)
        alphas.append(alpha)
        gammas.append(gamma)
        s *= 2
    return PCRFactor(tuple(alphas), tuple(gammas), 1.0 / dd)


def pcr_solve(fac: PCRFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the factored tridiagonal systems for ``rhs`` (n, m):
    ceil(log2 n) shift + FMA passes, all columns at once."""
    r = rhs
    s = 1
    for alpha, gamma in zip(fac.alphas, fac.gammas):
        r = r + alpha * _shift_fwd(r, s, 0.0) + gamma * _shift_bwd(r, s, 0.0)
        s *= 2
    return fac.dinv * r


def off_line_y(st: Stencil9, u: torch.Tensor) -> torch.Tensor:
    """Every 9-point term but the y-line tridiagonal (cs, cc, cn), in the
    JAX package's order."""
    p = F.pad(u[None, None], (1, 1, 1, 1))[0, 0]
    return (
        st.cw * p[1:-1, :-2]
        + st.ce * p[1:-1, 2:]
        + st.csw * p[:-2, :-2]
        + st.cse * p[:-2, 2:]
        + st.cnw * p[2:, :-2]
        + st.cne * p[2:, 2:]
    )


def line_jacobi_sweeps_y(st: Stencil9, b: torch.Tensor, u: torch.Tensor,
                         sweeps: int, omega: float = 1.0,
                         fac: PCRFactor | None = None) -> torch.Tensor:
    """Damped y-line Jacobi: each sweep solves, for every column at once,
    the tridiagonal system coupling u[i-1, j], u[i, j], u[i+1, j], with
    the off-line terms moved to the right-hand side from the previous
    iterate, then blends u <- (1 - omega) u + omega u_line.  ``fac`` is
    the PCR factor of (cs, cc, cn), computed here when not given."""
    ny = u.shape[0]
    if fac is None:
        fac = pcr_factor(st.cs, st.cc, st.cn, ny)
    for _ in range(sweeps):
        u_line = pcr_solve(fac, b - off_line_y(st, u))
        u = (1.0 - omega) * u + omega * u_line
    return u


def transpose_stencil9(st: Stencil9) -> Stencil9:
    """The stencil of the transposed grid (row index x, column index y):
    every coefficient transposed, the roles of s and w, n and e, se and nw
    swapped (JAX ``line_jacobi_sweeps_x``)."""
    return Stencil9(csw=st.csw.T, cs=st.cw.T, cse=st.cnw.T, cw=st.cs.T,
                    cc=st.cc.T, ce=st.cn.T, cnw=st.cse.T, cn=st.ce.T,
                    cne=st.cne.T)


def line_jacobi_sweeps_x(st: Stencil9, b: torch.Tensor, u: torch.Tensor,
                         sweeps: int, omega: float = 1.0,
                         fac: PCRFactor | None = None) -> torch.Tensor:
    """Damped x-line Jacobi: the y-line smoother on the transposed grid.
    ``fac`` is the PCR factor of the transposed stencil's lines
    (``transpose_stencil9(st)``'s cs, cc, cn over nx points)."""
    return line_jacobi_sweeps_y(transpose_stencil9(st), b.T, u.T, sweeps,
                                omega, fac).T

"""Smoothers and their static step schedules (PyTorch counterpart of
``multigrid_petsc_tpu/solvers/smoothers.py`` and the host functions
``jacobi_step_coeffs`` / ``chebyshev_step_coeffs`` of
``multigrid_petsc_tpu/ops/pallas/stencil_kernel.py``).

Every fused visit kernel runs a polynomial smoother as a static list of
(alpha_s, beta_s) pairs:

    z_s = D^-1 (b - A u_s);  p_{s+1} = beta_s p_s + alpha_s z_s;
    u_{s+1} = u_s + p_{s+1}

Damped Jacobi is (omega, 0) repeated; Chebyshev-accelerated Jacobi is
the theta/delta/rho recurrence on [0.1 lmax, 1.05 lmax], with lmax from
``estimate_dinv_a_lmax`` once per level at set-up.  The smoothers run as
these schedules (``ops.cuda.stencil_kernel.smooth_sweeps``: K7 on the
card, its plain version on the CPU).

Levels the fused kernels do not take (the explicit sparse backend's, and
merged-grid levels) smooth with the generic ``jacobi`` / ``chebyshev``
over the level's operator, or with ``composite_block_gs`` on a merged
level, over states that are a tensor or a tuple of per-grid tensors.  On
bf16 storage (the sparse backend's bf16 levels) ``jacobi``'s sweep is an
RBGS half-sweep without the colours: r = b - A u from the operator's
stored A u (K8's output, rounded once), rounded once, then
``torch.addcmul`` (u + omega D^-1 r in f32, rounded once);
``chebyshev``'s updates are PyTorch ops on the bf16 tensors, each
rounding its result (the generic route's rule, ``solvers/krylov.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from multigrid_petsc_tpu_torch.ops.norms import tree_map


def estimate_dinv_a_lmax(apply_fn: Callable, dinv, shapes,
                         iters: int = 20) -> float:
    """Power iteration for the largest eigenvalue of D^-1 A, in the dtype
    and on the device of ``dinv``, read to the host once at the end.  A
    single-grid level passes ``dinv`` as a tensor and ``shapes`` as its
    (ny, nx); a merged level a tuple of both, one per grid.  The
    deterministic constant-plus-checkerboard start of the JAX package has
    components on both smooth and oscillatory modes."""
    single = isinstance(dinv, torch.Tensor)
    d0 = dinv if single else dinv[0]

    def start(shape):
        ny, nx = shape
        ii = torch.arange(ny, device=d0.device)[:, None]
        jj = torch.arange(nx, device=d0.device)[None, :]
        return (1.0 + 0.5 * ((ii + jj) % 2)).to(d0.dtype)

    v = start(shapes) if single else tuple(start(s) for s in shapes)
    nrm = torch.ones((), dtype=d0.dtype, device=d0.device)
    for _ in range(iters):
        w = tree_map(lambda d, a: d * a, dinv, apply_fn(v))
        nrm = torch.sqrt(torch.sum(w * w) if single
                         else sum(torch.sum(x * x) for x in w))
        v = tree_map(lambda x: x / nrm, w)
    return float(nrm)


def jacobi(apply_fn: Callable, dinv, b, u, sweeps: int, omega: float = 0.8):
    """``sweeps`` damped-Jacobi iterations u += omega D^-1 (b - A u) over
    any operator (the explicit backend's, a merged level's): one
    ``apply_fn`` per sweep, the update one ``torch.addcmul`` (on bf16
    storage r and u each rounded once: the module docstring)."""
    for _ in range(sweeps):
        au = apply_fn(u)
        u = tree_map(lambda uk, dk, bk, ak:
                     torch.addcmul(uk, dk, bk - ak, value=omega),
                     u, dinv, b, au)
    return u


def chebyshev(apply_fn: Callable, dinv, b, u, sweeps: int, lmax: float,
              lmin_frac: float = 0.1, lmax_scale: float = 1.05):
    """Chebyshev-accelerated Jacobi on [lmin_frac lmax, lmax_scale lmax]
    over any operator, the JAX package's recurrence."""
    lo = lmin_frac * lmax
    hi = lmax_scale * lmax
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta

    def dinv_res(u):
        return tree_map(lambda dk, bk, ak: dk * (bk - ak), dinv, b,
                        apply_fn(u))

    p = tree_map(lambda zk: zk / theta, dinv_res(u))
    u = tree_map(lambda uk, pk: uk + pk, u, p)
    rho = 1.0 / sigma
    for _ in range(sweeps - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = dinv_res(u)
        p = tree_map(lambda pk, zk: rho_new * rho * pk
                     + (2.0 * rho_new / delta) * zk, p, z)
        u = tree_map(lambda uk, pk: uk + pk, u, p)
        rho = rho_new
    return u


def composite_block_gs(ops, b, u, sweeps: int, inner: int = 3,
                       omega: float = 0.8) -> tuple:
    """Grid-ordered block Gauss-Seidel on a merged level (the JAX
    package's ``composite_block_gs``; the reference smooths the merged
    matrix with Richardson + PETSc's default ILU, src/solver.c:2011-2020,
    which point Jacobi cannot replace: the coupling blocks break diagonal
    dominance).  One sweep visits the grids fine to coarse, moves the
    couplings to the rhs with the latest iterates, and runs ``inner``
    damped-Jacobi steps on the grid's own block (u += omega D^-1 (rhs -
    A u)).  ``ops`` is the level's operator set (``ops.composite.
    GridOps``): on one device K7 for the steps and K6 for the couplings'
    A_f; under a plan K17 on a sharded grid's block."""
    G = len(u)
    steps = jacobi_step_coeffs(inner, omega)
    for _ in range(sweeps):
        u = list(u)
        for k in range(G):
            rhs = b[k]
            for kf in range(k):  # couplings from finer grids (R A_f rows)
                rhs = rhs - ops.restrict(ops.apply(kf, u[kf]), kf, k)
            for kc in range(k + 1, G):  # from coarser grids (A_f P rows)
                rhs = rhs - ops.apply(k, ops.prolong(u[kc], kc, k))
            u[k] = ops.smooth(k, rhs, u[k], steps)
        u = tuple(u)
    return u


def jacobi_step_coeffs(sweeps: int, omega: float):
    return tuple((omega, 0.0) for _ in range(sweeps))


def chebyshev_step_coeffs(sweeps: int, lmax: float,
                          lmin_frac: float = 0.1, lmax_scale: float = 1.05):
    """Static (alpha, beta) sequence of Chebyshev-accelerated Jacobi on
    [lmin_frac*lmax, lmax_scale*lmax] (same theta/delta/rho recurrence as
    the JAX package)."""
    lo = lmin_frac * lmax
    hi = lmax_scale * lmax
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    steps = [(1.0 / theta, 0.0)]
    rho = 1.0 / sigma
    for _ in range(sweeps - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        steps.append((2.0 * rho_new / delta, rho_new * rho))
        rho = rho_new
    return tuple(steps)

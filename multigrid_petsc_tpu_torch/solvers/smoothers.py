"""Smoothers and their static step schedules (PyTorch counterpart of
``multigrid_petsc_tpu/solvers/smoothers.py`` and the host functions
``jacobi_step_coeffs`` / ``chebyshev_step_coeffs`` of
``multigrid_petsc_tpu/ops/pallas/stencil_kernel.py``).

Every fused visit kernel runs a polynomial smoother as a static list of
(alpha_s, beta_s) pairs:

    z_s = D^-1 (b - A u_s);  p_{s+1} = beta_s p_s + alpha_s z_s;
    u_{s+1} = u_s + p_{s+1}

Damped Jacobi is (omega, 0) repeated.  Only Jacobi is wired into the
solver so far; the Chebyshev schedule is kept for its host-side parity.
"""

from __future__ import annotations

from typing import Callable

import torch


def jacobi(apply_fn: Callable[[torch.Tensor], torch.Tensor],
           dinv: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
           sweeps: int, omega: float = 0.8) -> torch.Tensor:
    """``sweeps`` damped-Jacobi iterations u += omega D^-1 (b - A u)."""
    for _ in range(sweeps):
        u = u + omega * dinv * (b - apply_fn(u))
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

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
"""

from __future__ import annotations

from typing import Callable

import torch


def estimate_dinv_a_lmax(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                         dinv: torch.Tensor, shape: tuple[int, int],
                         iters: int = 20) -> float:
    """Power iteration for the largest eigenvalue of D^-1 A, in the dtype
    and on the device of ``dinv``, read to the host once at the end.  The
    deterministic constant-plus-checkerboard start of the JAX package has
    components on both smooth and oscillatory modes."""
    ny, nx = shape
    ii = torch.arange(ny, device=dinv.device)[:, None]
    jj = torch.arange(nx, device=dinv.device)[None, :]
    v = (1.0 + 0.5 * ((ii + jj) % 2)).to(dinv.dtype)
    nrm = torch.ones((), dtype=dinv.dtype, device=dinv.device)
    for _ in range(iters):
        w = dinv * apply_fn(v)
        nrm = torch.sqrt(torch.sum(w * w))
        v = w / nrm
    return float(nrm)


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

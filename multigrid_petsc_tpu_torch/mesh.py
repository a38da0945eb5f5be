"""Structured tensor-product meshes on [0,1]^2 with analytic metric terms.

PyTorch counterpart of ``multigrid_petsc_tpu/mesh.py`` (reference:
src/mesh.c).  Coordinates are evaluated on the host in f64 with numpy,
exactly as the JAX package does, then moved to the requested device and
dtype; the metric terms are evaluated there with torch ops.

Metric vector convention (reference: src/mesh.c:29-43):
  m0 = (xi_x)^2 + (xi_y)^2        -- multiplies x-direction second difference
  m1 = (eta_x)^2 + (eta_y)^2      -- multiplies y-direction second difference
  m2 = xi_xx + xi_yy              -- multiplies x-direction first difference
  m3 = eta_xx + eta_yy            -- multiplies y-direction first difference
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch


class MeshType(enum.Enum):
    """Mesh families of the reference (src/mesh.h:19)."""

    UNIFORM = 0
    NONUNIFORM1 = 1  # cosine stretch in y
    NONUNIFORM2 = 2  # exponential stretch in y


def physical_coords(
    mesh_type: MeshType, npts: int, axis: int, dtype: torch.dtype,
    device: torch.device | str,
) -> torch.Tensor:
    """Physical coordinates of ALL npts points along ``axis`` (0=x, 1=y).

    x is always uniform; y is stretched for NONUNIFORM1/2
    (reference: src/mesh.c:144-175 stretches only direction 1).
    """
    xi = np.arange(npts, dtype=np.float64) / (npts - 1)
    if axis == 0 or mesh_type == MeshType.UNIFORM:
        c = xi
    elif mesh_type == MeshType.NONUNIFORM1:
        # y = 1 - cos(pi/2 * eta) on [0,1] (src/mesh.c:165)
        c = 1.0 - np.cos(np.pi * 0.5 * xi)
    elif mesh_type == MeshType.NONUNIFORM2:
        # y = (exp(2 eta) - 1)/(e^2 - 1) on [0,1] (src/mesh.c:166-169)
        c = (np.exp(2.0 * xi) - 1.0) / (math.exp(2.0) - 1.0)
    else:  # pragma: no cover
        raise ValueError(mesh_type)
    return torch.as_tensor(c, dtype=dtype, device=device)


def metric_terms(mesh_type: MeshType, y: torch.Tensor):
    """Metric coefficients (m0, m1, m2, m3) at physical height(s) y, each
    shaped like ``y`` (all three families depend on y only)."""
    if mesh_type == MeshType.UNIFORM:
        one = torch.ones_like(y)
        zero = torch.zeros_like(y)
        return one, one, zero, zero
    if mesh_type == MeshType.NONUNIFORM1:
        # temp = 1 - (1-y)^2 ; m1 = 4/(pi^2 temp); m3 = -2(1-y)/(pi temp^{3/2})
        # (src/mesh.c:69-74 with bounds [0,1])
        t = 1.0 - (1.0 - y) ** 2
        m1 = 4.0 / (math.pi**2 * t)
        m3 = -2.0 * (1.0 - y) / (math.pi * torch.sqrt(t**3))
        return torch.ones_like(y), m1, torch.zeros_like(y), m3
    if mesh_type == MeshType.NONUNIFORM2:
        # temp = (e^2-1)^2 / (y (e^2-1) + 1)^2 ; m1 = temp/4 ; m3 = -temp/2
        # (src/mesh.c:101-106 with bounds [0,1])
        e2m1 = math.exp(2.0) - 1.0
        t = e2m1**2 / (y * e2m1 + 1.0) ** 2
        return torch.ones_like(y), 0.25 * t, torch.zeros_like(y), -0.5 * t
    raise ValueError(mesh_type)  # pragma: no cover

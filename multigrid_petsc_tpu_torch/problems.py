"""Problem definitions: the manufactured Poisson problem and its 5-point
stencil coefficients (PyTorch counterpart of the Poisson family of
``multigrid_petsc_tpu/problems.py``; reference: src/problem.c:3-46).

    laplacian(u) = f,   u(x,y) = sin(pi x) sin(pi y),
    f(x,y) = -2 pi^2 sin(pi x) sin(pi y),

with homogeneous Dirichlet data on [0,1]^2 and the metric-weighted
5-point stencil (src/problem.c:3-22 ``OpA``):

    A_s = m1/hy^2 - m3/(2 hy)     A_n = m1/hy^2 + m3/(2 hy)
    A_w = m0/hx^2 - m2/(2 hx)     A_e = m0/hx^2 + m2/(2 hx)
    A_c = -2 (m0/hx^2 + m1/hy^2)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from multigrid_petsc_tpu_torch.mesh import MeshType, metric_terms, physical_coords
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5


@dataclass(frozen=True)
class Problem:
    """An analytic test problem (RHS + exact solution)."""

    f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    u_exact: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    name: str = "poisson-sin"


def poisson_sin_problem() -> Problem:
    """The reference's manufactured problem (src/problem.c:24-34)."""

    def f(x, y):
        return -2.0 * math.pi**2 * torch.sin(math.pi * x) * torch.sin(math.pi * y)

    def u_exact(x, y):
        return torch.sin(math.pi * x) * torch.sin(math.pi * y)

    return Problem(f=f, u_exact=u_exact)


def stencil_coefficients(
    mesh_type: MeshType, ny: int, nx: int, dtype: torch.dtype,
    device: torch.device | str,
) -> Stencil5:
    """5-point coefficients for a grid with (ny, nx) interior points, as
    (ny, 1) columns; hx = 1/(nx+1), hy = 1/(ny+1) in computational space
    (src/matbuild.c:99-104), metrics at each row's physical height."""
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    y = physical_coords(mesh_type, ny + 2, 1, dtype, device)[1:-1].reshape(ny, 1)
    m0, m1, m2, m3 = metric_terms(mesh_type, y)
    hx2 = hx * hx
    hy2 = hy * hy
    return Stencil5(
        cs=m1 / hy2 - m3 / (2.0 * hy),
        cw=m0 / hx2 - m2 / (2.0 * hx),
        cc=-2.0 * (m0 / hx2 + m1 / hy2),
        ce=m0 / hx2 + m2 / (2.0 * hx),
        cn=m1 / hy2 + m3 / (2.0 * hy),
    )


def _interior_xy(mesh_type: MeshType, ny: int, nx: int, dtype, device):
    x = physical_coords(mesh_type, nx + 2, 0, dtype, device)[1:-1].reshape(1, nx)
    y = physical_coords(mesh_type, ny + 2, 1, dtype, device)[1:-1].reshape(ny, 1)
    return x, y


def rhs_grid(problem: Problem, mesh_type: MeshType, ny: int, nx: int,
             dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """f at the interior points of an (ny, nx)-interior grid
    (src/solver.c:593-597)."""
    return problem.f(*_interior_xy(mesh_type, ny, nx, dtype, device))


def exact_grid(problem: Problem, mesh_type: MeshType, ny: int, nx: int,
               dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """u_exact at the interior points of an (ny, nx)-interior grid."""
    return problem.u_exact(*_interior_xy(mesh_type, ny, nx, dtype, device))

"""Problem definitions: the manufactured Poisson problem and its 5-point
stencil coefficients, and the anisotropic 9-point family (PyTorch
counterpart of ``multigrid_petsc_tpu/problems.py``; reference:
src/problem.c:3-46).

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
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5, Stencil9


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


# --------------------------------------------------------------------------
# Anisotropic / variable-coefficient 9-point family (BASELINE.md config 4;
# ``multigrid_petsc_tpu/problems.py:125-218``):
#
#     L u = a u_xx + a_x u_x + c u_yy + c_y u_y + 2 b u_xy
#
# with a = a(x), c = c(y) and a constant mixed coefficient b (b^2 < a c),
# on a uniform grid; u_xy is the corner cross (NE - NW - SE + SW)/(4 h^2).
# Manufactured solution: sin(pi x) sin(pi y).  The fields are computed on
# the CPU and moved to ``device``, so a CPU and a CUDA set-up hold the same
# values.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AnisoProblem:
    """a(x) = ax0 + ax2 x^2,  c(y) = cy0 + cy2 y^2,  b constant."""

    ax0: float = 1.0
    ax2: float = 0.0
    cy0: float = 1.0
    cy2: float = 0.0
    b: float = 0.0
    name: str = "aniso-9pt"

    def coeffs(self, x, y):
        a = self.ax0 + self.ax2 * x * x
        a_x = 2.0 * self.ax2 * x
        c = self.cy0 + self.cy2 * y * y
        c_y = 2.0 * self.cy2 * y
        return a, a_x, c, c_y

    def u_exact(self, x, y):
        return torch.sin(math.pi * x) * torch.sin(math.pi * y)

    def f(self, x, y):
        pi = math.pi
        sx, sy = torch.sin(pi * x), torch.sin(pi * y)
        cx, cy = torch.cos(pi * x), torch.cos(pi * y)
        u = sx * sy
        u_x = pi * cx * sy
        u_y = pi * sx * cy
        u_xy = pi * pi * cx * cy
        a, a_x, c, c_y = self.coeffs(x, y)
        return (
            -a * pi * pi * u + a_x * u_x
            - c * pi * pi * u + c_y * u_y
            + 2.0 * self.b * u_xy
        )


def _uniform_xy(ny: int, nx: int, dtype: torch.dtype):
    """Interior coordinates of the uniform grid on the CPU: x (1, nx),
    y (ny, 1)."""
    x = (torch.arange(1, nx + 1, dtype=dtype) * (1.0 / (nx + 1))).reshape(1, nx)
    y = (torch.arange(1, ny + 1, dtype=dtype) * (1.0 / (ny + 1))).reshape(ny, 1)
    return x, y


def stencil9_coefficients(prob: AnisoProblem, ny: int, nx: int,
                          dtype: torch.dtype,
                          device: torch.device | str) -> Stencil9:
    """9-point coefficients of the anisotropic operator on a uniform
    (ny, nx)-interior grid, in the JAX package's broadcast shapes: the
    corners (1, 1), cw/ce (1, nx), cs/cn (ny, 1), cc a (ny, nx) field
    (a (1, nx) row plus a (ny, 1) column, summed as JAX sums them)."""
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    x, y = _uniform_xy(ny, nx, dtype)
    a, a_x, c, c_y = prob.coeffs(x, y)
    zero = torch.zeros((1, 1), dtype=dtype)
    bq = torch.full((1, 1), prob.b / (2.0 * hx * hy), dtype=dtype)
    ce = a / (hx * hx) + a_x / (2.0 * hx)
    cw = a / (hx * hx) - a_x / (2.0 * hx)
    cn = c / (hy * hy) + c_y / (2.0 * hy)
    cs = c / (hy * hy) - c_y / (2.0 * hy)
    cc = (-2.0 * a / (hx * hx) + zero) + (-2.0 * c / (hy * hy))
    st = Stencil9(csw=bq, cs=cs + zero, cse=-bq, cw=cw + zero, cc=cc,
                  ce=ce + zero, cnw=-bq, cn=cn + zero, cne=bq)
    return Stencil9(*(t.to(device) for t in st))


def aniso_rhs_grid(prob: AnisoProblem, ny: int, nx: int, dtype: torch.dtype,
                   device: torch.device | str) -> torch.Tensor:
    """f at the interior points of the uniform (ny, nx)-interior grid."""
    return prob.f(*_uniform_xy(ny, nx, dtype)).to(device)


def aniso_exact_grid(prob: AnisoProblem, ny: int, nx: int,
                     dtype: torch.dtype,
                     device: torch.device | str) -> torch.Tensor:
    """u_exact at the interior points of the uniform (ny, nx) grid."""
    return prob.u_exact(*_uniform_xy(ny, nx, dtype)).to(device)

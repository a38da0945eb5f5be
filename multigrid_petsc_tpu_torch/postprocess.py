"""Discrete error norms of a solution (PyTorch counterpart of
``error_norms`` in ``multigrid_petsc_tpu/postprocess.py``; reference:
src/solver.c:1211-1237)."""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.problems import (
    AnisoProblem,
    Problem,
    aniso_exact_grid,
    exact_grid,
)


def error_norms(problem: Problem | AnisoProblem, mesh_type: MeshType,
                u_fine: torch.Tensor):
    """(max, L1, L2) of |u - u_exact| on the fine interior grid (L1/L2
    are unnormalized sums, as in the reference), on ``u_fine``'s device;
    a merged state (a tuple of grids) is read on its primary grid.
    The anisotropic family lives on the uniform grid
    (``aniso_exact_grid``); ``mesh_type`` is then not used."""
    if not isinstance(u_fine, torch.Tensor):
        u_fine = u_fine[0]
    ny, nx = u_fine.shape
    if isinstance(problem, AnisoProblem):
        ue = aniso_exact_grid(problem, ny, nx, u_fine.dtype, u_fine.device)
    else:
        ue = exact_grid(problem, mesh_type, ny, nx, u_fine.dtype,
                        u_fine.device)
    diff = torch.abs(u_fine - ue)
    return (
        float(torch.max(diff)),
        float(torch.sum(diff)),
        float(torch.sqrt(torch.sum(diff * diff))),
    )

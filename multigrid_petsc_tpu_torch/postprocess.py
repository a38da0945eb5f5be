"""Post-processing: discrete error norms and the reference's artifact files
(PyTorch counterpart of ``multigrid_petsc_tpu/postprocess.py``; reference:
src/solver.c:151-166, 1211-1237, 1329-1376).

``write_artifacts`` writes the JAX package's files byte for byte:
uData.dat (the solution, ``%.16e``), rData.dat (the residual history),
eData.dat (the three error norms), XgridData.dat / YgridData.dat (the
coordinates, ``%f``), and with ``-moreNorm`` rGlobal.dat / rGrid<i>.dat.
The solution and grid files grow with the grid (3.35 GB at 8191^2: 26
bytes a positive value, 12 a coordinate), so they are written in blocks
of rows, never built as one string; the solution's rows are formatted by a pool of processes when
the grid is large.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from multigrid_petsc_tpu_torch.mesh import MeshType, physical_coords
from multigrid_petsc_tpu_torch.problems import (
    AnisoProblem,
    Problem,
    aniso_exact_grid,
    exact_grid,
)

# Rows a block of the solution file holds; the number of values from which
# its blocks are formatted by a process pool (2049^2 and up), and the
# pool's size at most.
ROWS_PER_BLOCK = 64
PARALLEL_MIN_VALUES = 1 << 22
MAX_WORKERS = 8
SEP = "    "


def error_norms(problem: Problem | AnisoProblem, mesh_type: MeshType,
                u_fine: torch.Tensor):
    """(max, L1, L2) of |u - u_exact| on the fine interior grid (L1/L2
    are unnormalized sums, as in the reference), on ``u_fine``'s device;
    a merged state (a tuple of grids) is read on its primary grid.
    The anisotropic family lives on the uniform grid
    (``aniso_exact_grid``); ``mesh_type`` is then not used."""
    if not isinstance(u_fine, torch.Tensor):
        u_fine = u_fine[0]
    if u_fine.dtype == torch.bfloat16:  # bf16 storage: the error in f32
        u_fine = u_fine.float()
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


def format_rows(rows: np.ndarray) -> bytes:
    """Rows of the solution file: each value ``%.16e`` followed by the
    four-space separator, one line per row."""
    fmt = "{:.16e}".format
    return "".join(SEP.join(map(fmt, r.tolist())) + SEP + "\n"
                   for r in rows).encode()


def _history_line(values) -> str:
    return " ".join(f"{v:.16e}" for v in np.asarray(values).tolist()) + " \n"


def _write_solution(path: Path, u: np.ndarray) -> None:
    blocks = [u[i:i + ROWS_PER_BLOCK] for i in range(0, u.shape[0],
                                                     ROWS_PER_BLOCK)]
    workers = (min(MAX_WORKERS, os.cpu_count() or 1)
               if u.size >= PARALLEL_MIN_VALUES else 1)
    with open(path, "wb") as f:
        if workers <= 1:
            for blk in blocks:
                f.write(format_rows(blk))
            return
        # Fresh interpreters: the caller may hold a CUDA context and
        # threads, which a forked child would inherit.
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            for text in pool.map(format_rows, blocks):
                f.write(text)


def write_artifacts(outdir: str | Path, mesh_type: MeshType, u_fine,
                    rnorm, errors: tuple[float, float, float],
                    r_global=None, r_grid: dict | None = None) -> None:
    """Write the reference's artifact files into ``outdir`` (same names
    and layout as the JAX package's ``write_artifacts``).  ``u_fine`` is
    the fine-grid solution (a numpy array or a tensor on any device); from
    ``PARALLEL_MIN_VALUES`` values on, a process a CPU core (at most
    ``MAX_WORKERS``) formats its rows."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if isinstance(u_fine, torch.Tensor):
        u_fine = u_fine.detach().cpu()
        if u_fine.dtype == torch.bfloat16:  # numpy has no bf16: f32, exact
            u_fine = u_fine.float()
        u_fine = u_fine.numpy()
    u_fine = np.asarray(u_fine)
    ny, nx = u_fine.shape
    xs = physical_coords(mesh_type, nx + 2, 0, torch.float64, "cpu").tolist()
    ys = physical_coords(mesh_type, ny + 2, 1, torch.float64, "cpu").tolist()

    with open(outdir / "eData.dat", "w") as f:
        for e in errors:
            f.write(f"{e:.16e}\n")
    with open(outdir / "rData.dat", "w") as f:
        f.write(_history_line(rnorm))
    _write_solution(outdir / "uData.dat", u_fine)
    # Each grid file holds a coordinate per interior point, row-major, as
    # the JAX writer (and the reference's per-point dump,
    # src/solver.c:1339-1348) indexes them: x from coord[0][j], y from
    # coord[1][i], j < nx and i < ny.
    xrow = "".join(f"{v:f}" + SEP for v in xs[:nx]) + "\n"
    with open(outdir / "XgridData.dat", "w") as f:
        for i in range(0, ny, ROWS_PER_BLOCK):
            f.write(xrow * min(ROWS_PER_BLOCK, ny - i))
    with open(outdir / "YgridData.dat", "w") as f:
        for i in range(ny):
            f.write((f"{ys[i]:f}" + SEP) * nx + "\n")
    if r_global is not None:
        with open(outdir / "rGlobal.dat", "w") as f:
            f.write(_history_line(r_global))
    if r_grid is not None:
        for g, vals in r_grid.items():
            with open(outdir / f"rGrid{g}.dat", "w") as f:
                f.write(_history_line(vals))

"""Diagnostic views: human-readable dumps of meshes, hierarchies,
operators and the solver (PyTorch counterpart of
``multigrid_petsc_tpu/utils/views.py``; reference: the View* debug
functions, src/poisson.c:216-425, and the per-level KSPView after the
solve, src/solver.c:1560-1564).

The output is the JAX package's line for line, but for the ``op=`` token
of ``view_solver``, which names the port's operator, and its ``layout=``
token under a plan.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.mesh import MeshType, physical_coords
from multigrid_petsc_tpu_torch.ops.sparse import assemble_level_csr
from multigrid_petsc_tpu_torch.ops.transfer import (
    PROLONG_3x3,
    RESTRICT_3x3,
    composed_transfer_stencil,
)


def view_mesh(mesh_type: MeshType, npts: int) -> str:
    """Mesh coordinates + max spacing (ViewMeshInfo)."""
    xs, ys = (physical_coords(mesh_type, npts, a, torch.float64,
                              "cpu").numpy() for a in (0, 1))
    lines = [f"mesh type={mesh_type.name} npts={npts}"]
    lines.append(f"x: {np.array2string(xs, precision=4, threshold=12)}")
    lines.append(f"y: {np.array2string(ys, precision=4, threshold=12)}")
    lines.append(
        f"max spacing: dx={np.max(np.diff(xs)):.5f} dy={np.max(np.diff(ys)):.5f}"
    )
    return "\n".join(lines)


def view_hierarchy(specs) -> str:
    """Grids-per-level layout (ViewGridsInfo / ViewRangesInfo)."""
    lines = []
    for l, spec in enumerate(specs):
        gs = ", ".join(
            f"g{g.g}:{g.ny}x{g.nx}(h={g.hy:.4g})" for g in spec.grids
        )
        lines.append(f"level {l}: [{gs}]"
                     + ("  <- composite" if spec.is_composite else ""))
    return "\n".join(lines)


def view_transfer_operators(max_gap: int = 3) -> str:
    """Composed transfer stencils (ViewOperatorInfo)."""
    lines = []
    for gap in range(1, max_gap + 1):
        r = composed_transfer_stencil(RESTRICT_3x3, gap)
        p = composed_transfer_stencil(PROLONG_3x3, gap)
        lines.append(f"gap {gap}: res {r.shape} sum={r.sum():.4f}, "
                     f"pro {p.shape} sum={p.sum():.4f}")
    return "\n".join(lines)


def view_operator(ctx, level: int = 0, max_rows: int = 8) -> str:
    """First rows of the level operator from the CSR assembly
    (ViewLinSysMatsInfo)."""
    spec = ctx.levels[level].spec
    indptr, indices, data = assemble_level_csr(
        ctx.config.npts, ctx.config.mesh, spec.gids)
    lines = [f"level {level} operator: {len(indptr)-1} rows, {len(data)} nnz"]
    for r in range(min(max_rows, len(indptr) - 1)):
        lo, hi = indptr[r], indptr[r + 1]
        ents = " ".join(
            f"({c},{v:.3g})" for c, v in zip(indices[lo:hi], data[lo:hi])
        )
        lines.append(f"  row {r}: {ents}")
    return "\n".join(lines)


def _level_op(ctx, lvl, level: int) -> str:
    """What applies a level's operator: ``K17(ranks xP, R=.., pad=..)`` on
    a row-sharded level, ``sparse(<form>, nnz=..)`` on an assembled one,
    else ``cuda`` (the hand-written kernels; on level 0 with the mg-CG
    route the last solve took) or ``torch`` (their plain versions)."""
    if lvl.dist is not None:
        return (f"K17(ranks x{lvl.dist.plan.size}, R={lvl.dist.R}, "
                f"pad={lvl.pad_rows})")
    if lvl.sparse_full is not None:
        return f"sparse({lvl.sparse_full.form}, nnz={lvl.sparse_full.nnz})"
    op = "cuda" if ctx.device.type == "cuda" else "torch"
    return f"{op}({ctx.route})" if level == 0 and ctx.route else op


def view_solver(ctx) -> str:
    """Per-level solver dump, the KSPView analogue: each level's grids,
    operator, smoother configuration and sweeps, its layout under a plan,
    and the coarsest level's solver.  The tokens but ``op=`` and
    ``layout=`` are the JAX package's, letter for letter (its smoother
    token names the configured smoother of every level)."""
    cfg = ctx.config
    lines = [
        f"solver: cycle={cfg.cycle.name} v={cfg.v} rtol={cfg.rtol:g} "
        f"divtol={cfg.divtol:g} dtype={cfg.dtype}"
        + (f" outer_dtype={cfg.outer_dtype}" if cfg.outer_dtype else "")
        + (f" path={ctx.route}" if ctx.route else "")
    ]
    L = len(ctx.levels)
    for l, lvl in enumerate(ctx.levels):
        gs = ", ".join(f"g{g.g}:{g.ny}x{g.nx}" for g in lvl.spec.grids)
        if lvl.spec.is_composite:
            smoother = f"{cfg.composite_smoother}(inner={cfg.v[0]})"
        else:
            smoother = cfg.smoother.value
            if cfg.smoother.value == "chebyshev" and lvl.lmax is not None:
                smoother += f"(lmax={lvl.lmax:.4g})"
            elif cfg.smoother.value == "jacobi":
                smoother += f"(omega={cfg.omega})"
        sweeps = cfg.v[1] if (l == L - 1 and L > 1) else cfg.v[0]
        layout = ""
        if ctx.plan is not None:
            layout = " layout=" + ("rows" if lvl.dist is not None
                                   else "replicated")
        coarse = ""
        if l == L - 1 and L > 1:
            coarse = (" coarse=smooth" if lvl.coarse_solve is None
                      else f" coarse={cfg.coarse_solver}")
        lines.append(
            f"level {l}: [{gs}] op={_level_op(ctx, lvl, l)} "
            f"smoother={smoother} sweeps={sweeps}{layout}{coarse}"
        )
    return "\n".join(lines)

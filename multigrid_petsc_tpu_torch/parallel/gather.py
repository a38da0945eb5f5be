"""Solution gather: the sharded fine-grid solution as one numpy array on
every rank (PyTorch counterpart of ``multigrid_petsc_tpu/parallel/
gather.py`` :18-34; reference: src/solver.c:1239-1315 GetSol, a rank-0
gather through the global index map, here an all-gather)."""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.parallel.halo import (
    all_gather_blocks,
    all_gather_rows,
)


def gather_solution(u: torch.Tensor, plan, ny: int,
                    nx: int | None = None) -> np.ndarray:
    """The (ny, nx) grid whose blocks the ranks hold in ``u``, on every
    rank: row blocks of R rows (the pad row on the last rank, or already
    stripped there), or under the blocks layout (R, C) blocks (their pad
    row and column, or already stripped).  A collective: every rank of
    the plan must call it."""
    nx = u.shape[1] if nx is None else nx
    if plan.layout == "blocks":
        blk = plan.block(ny, nx)
        if tuple(u.shape) != (blk.R, blk.C):  # the pads stripped
            u = torch.nn.functional.pad(
                u, (0, blk.C - u.shape[1], 0, blk.R - u.shape[0]))
        whole = all_gather_blocks(u, plan, "solution", blk.split)
        return whole[:ny, :nx].cpu().numpy()
    R = (ny + 1) // plan.size
    if u.shape[0] == R - 1:  # the last rank's block without its pad row
        u = torch.cat([u, u.new_zeros((1, u.shape[1]))])
    return all_gather_rows(u, plan, "solution")[:ny].cpu().numpy()

"""Solution gather: the row-sharded fine-grid solution as one numpy array
on every rank (PyTorch counterpart of ``multigrid_petsc_tpu/parallel/
gather.py`` :18-34; reference: src/solver.c:1239-1315 GetSol, a rank-0
gather through the global index map, here an all-gather)."""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.parallel.halo import all_gather_rows


def gather_solution(u: torch.Tensor, plan, ny: int) -> np.ndarray:
    """The (ny, nx) grid whose row blocks the ranks hold in ``u`` (R rows
    each, the pad row on the last rank or already stripped there), on
    every rank.  A collective: every rank of the plan must call it."""
    R = (ny + 1) // plan.size
    if u.shape[0] == R - 1:  # the last rank's block without its pad row
        u = torch.cat([u, u.new_zeros((1, u.shape[1]))])
    return all_gather_rows(u, plan, "solution")[:ny].cpu().numpy()

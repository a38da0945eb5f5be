"""Checkpoint / resume for long solves (PyTorch counterpart of
``multigrid_petsc_tpu/utils/checkpoint.py``; the reference persists only
the final solution).

State saved: the level-0 iterate (one array per grid), the residual
history so far, the iteration count and the configuration's fingerprint
(a mismatched configuration refuses to resume), as a plain ``.npz`` with
the JAX package's keys.  Both packages' ``SolverConfig`` have the same
fields, so the fingerprints agree and a checkpoint written by either
loads in the other.  A resume goes through ``solve(u0=...)``.

Under a plan (``plan=``; JAX ``_to_host``, utils/checkpoint.py:31-76) each
grid of the level-0 state the plan shards is the ranks' blocks, row
blocks or, under the blocks layout, 2-D blocks: ``save`` gathers each
such grid (``parallel.gather_solution``; every rank calls it, a
collective) and rank 0 writes the whole grids; ``load`` gives each rank
its block of each sharded grid (``DistLevelOps.block_of``'s rows or
``BlockLevelOps.block_of``'s points, the pad row and column 0) and the
replicated grids whole, which ``solve(u0=...)`` under the same plan
resumes from.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from multigrid_petsc_tpu_torch.hierarchy import build_hierarchy
from multigrid_petsc_tpu_torch.parallel.gather import gather_solution


def _fingerprint(cfg) -> str:
    d = dataclasses.asdict(cfg)
    d["cycle"] = cfg.cycle.name
    d["smoother"] = cfg.smoother.value
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save(path: str | Path, cfg, u, rnorm, iters: int, plan=None) -> None:
    """Write the checkpoint of level-0 state ``u`` (a tensor or array, a
    tuple of them on a merged level 0).  Under ``plan`` ``u`` is this
    rank's part of it (``SolveResult.u_local``; ``SolveResult.u`` on a
    single-grid level 0): every rank calls ``save``, each sharded grid's
    blocks are gathered and rank 0 writes."""
    if isinstance(u, (torch.Tensor, np.ndarray)):
        u = (u,)
    if plan is not None:
        grids = build_hierarchy(cfg.npts, cfg.grids, cfg.levels)[0].grids
        if len(u) != len(grids):
            raise ValueError(f"level 0 has {len(grids)} grids; the state "
                             f"holds {len(u)}")
        u = tuple(gather_solution(torch.as_tensor(x), plan, g.ny, g.nx)
                  if plan.shards(g.ny, g.nx) else x
                  for x, g in zip(u, grids))
        if plan.rank != 0:
            return
    # numpy has no bf16: a bf16 state is saved as f32 (exact).
    arrays = {f"u{i}": ((x.detach().cpu().float()
                         if x.dtype == torch.bfloat16 else x.detach().cpu())
                        .numpy()
                        if isinstance(x, torch.Tensor) else np.asarray(x))
              for i, x in enumerate(u)}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        fingerprint=np.bytes_(_fingerprint(cfg)),
        iters=np.int64(iters),
        rnorm=np.asarray(rnorm),
        n_grids=np.int64(len(u)),
        **arrays,
    )


def load(path: str | Path, cfg, plan=None):
    """-> (u tuple of numpy arrays, rnorm, iters); raises on a
    configuration mismatch.  Under ``plan`` u holds this rank's block of
    each saved grid the plan shards (the rows layout's (R, nx) rows, R =
    (ny + 1) / ranks; the blocks layout's (R, C) points), the others
    whole."""
    with np.load(Path(path)) as z:
        fp = z["fingerprint"].item()
        fp = fp.decode() if isinstance(fp, bytes) else str(fp)
        if fp != _fingerprint(cfg):
            raise ValueError(
                "checkpoint config fingerprint mismatch: refusing to resume"
            )
        n = int(z["n_grids"])
        u = tuple(z[f"u{i}"] for i in range(n))
        if plan is not None:
            u = tuple(_block(x, plan) if plan.shards(*x.shape) else x
                      for x in u)
        return u, z["rnorm"], int(z["iters"])


def _block(x: np.ndarray, plan) -> np.ndarray:
    """This rank's block of a whole (ny, nx) grid, the pad row (and
    column) 0: its (R, nx) rows, or under the blocks layout its (R, C)
    points from (row0, col0)."""
    if plan.layout == "blocks":
        R, C, row0, col0, _ = plan.block(*x.shape)
        blk = np.zeros((R, C), x.dtype)
        pts = x[row0:row0 + R, col0:col0 + C]
        blk[:pts.shape[0], :pts.shape[1]] = pts
        return blk
    R = (x.shape[0] + 1) // plan.size
    blk = np.zeros((R, x.shape[1]), x.dtype)
    rows = x[plan.rank * R:(plan.rank + 1) * R]
    blk[:rows.shape[0]] = rows
    return blk

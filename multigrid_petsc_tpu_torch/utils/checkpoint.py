"""Checkpoint / resume for long solves (PyTorch counterpart of
``multigrid_petsc_tpu/utils/checkpoint.py``; the reference persists only
the final solution).

State saved: the level-0 iterate (one array per grid), the residual
history so far, the iteration count and the configuration's fingerprint
(a mismatched configuration refuses to resume), as a plain ``.npz`` with
the JAX package's keys.  Both packages' ``SolverConfig`` have the same
fields, so the fingerprints agree and a checkpoint written by either
loads in the other.  A resume goes through ``solve(u0=...)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from multigrid_petsc_tpu_torch.utils.config import not_ported


def _fingerprint(cfg) -> str:
    d = dataclasses.asdict(cfg)
    d["cycle"] = cfg.cycle.name
    d["smoother"] = cfg.smoother.value
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save(path: str | Path, cfg, u, rnorm, iters: int) -> None:
    """Write the checkpoint of level-0 state ``u`` (a tensor or array, a
    tuple of them on a merged level 0).  In a process group of more than
    one rank (under a plan) the state is sharded, which this checkpoint
    does not gather: it raises."""
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise not_ported("a checkpoint of a solve under a plan",
                         "distribution, the sharding-aware checkpoint")
    if isinstance(u, (torch.Tensor, np.ndarray)):
        u = (u,)
    arrays = {f"u{i}": (x.detach().cpu().numpy()
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


def load(path: str | Path, cfg):
    """-> (u tuple of numpy arrays, rnorm, iters); raises on a
    configuration mismatch."""
    with np.load(Path(path)) as z:
        fp = z["fingerprint"].item()
        fp = fp.decode() if isinstance(fp, bytes) else str(fp)
        if fp != _fingerprint(cfg):
            raise ValueError(
                "checkpoint config fingerprint mismatch: refusing to resume"
            )
        n = int(z["n_grids"])
        u = tuple(z[f"u{i}"] for i in range(n))
        return u, z["rnorm"], int(z["iters"])

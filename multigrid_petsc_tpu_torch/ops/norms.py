"""Inner products and norms over level states (PyTorch counterpart of
``multigrid_petsc_tpu/ops/norms.py``).  A state here is one tensor: the
port has single-grid levels only."""

from __future__ import annotations

import torch


def tree_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> as a 0-d tensor on the operands' device."""
    return torch.dot(x.reshape(-1), y.reshape(-1))


def tree_norm2(x: torch.Tensor) -> torch.Tensor:
    """l2 norm (reference: VecNorm NORM_2)."""
    return torch.sqrt(tree_dot(x, x))

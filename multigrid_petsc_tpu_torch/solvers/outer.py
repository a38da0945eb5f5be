"""Outer-iteration result (PyTorch counterpart of ``OuterResult`` in
``multigrid_petsc_tpu/solvers/outer.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class OuterResult(NamedTuple):
    u: torch.Tensor
    rnorm_history: torch.Tensor  # normalized by entry 0; length hist_len+1
    iters: int
    converged: bool

"""K16: SpMV of a DIA-stored matrix over a flat vector.

Counterpart of ``multigrid_petsc_tpu/ops/pallas/spmv_dia.py``
``dia_spmv_pallas``:

    y[r] = sum_k vals[k, r] * x[r + offsets[k]]   (x outside [0, n) is 0)

with at most 16 static offsets, summed in their order.  The explicit
sparse backend (``ops/sparse.py``) routes here every banded level matrix
that is not one grid's stencil, above all the grid-diagonal A1 of a
merged level.  The kernel is ``csrc/spmv_dia.cu`` (one thread per row).

``dia_spmv`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors (f32, contiguous; anything else raises), never
falling back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _check_cuda,
    _on_cpu,
    _stream,
)

MAX_DIAGS = 16  # csrc/spmv_dia.cu: the offsets ride the parameter block


def dia_spmv_plain(offsets, vals: torch.Tensor, x: torch.Tensor):
    """The shifted multiply-adds in the offsets' order, as the TPU kernel
    sums them."""
    n = x.shape[0]
    y = None
    for k, d in enumerate(offsets):
        sh = torch.zeros_like(x)
        lo, hi = max(0, -d), min(n, n - d)
        if lo < hi:
            sh[lo:hi] = x[lo + d : hi + d]
        term = vals[k] * sh
        y = term if y is None else y + term
    return y


def dia_spmv(offsets, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x, A in DIA form: ``vals`` (K, n), ``offsets`` K ints."""
    offsets = tuple(int(d) for d in offsets)
    if len(offsets) != vals.shape[0]:
        raise ValueError(f"{len(offsets)} offsets for {vals.shape[0]} "
                         f"diagonals")
    if _on_cpu(x):
        return dia_spmv_plain(offsets, vals, x)
    n, k = x.shape[0], len(offsets)
    if not 1 <= k <= MAX_DIAGS:
        raise ValueError(f"the DIA kernel takes 1 to {MAX_DIAGS} diagonals, "
                         f"got {k}")
    _check_cuda(x.device, {"x": (x, (n,)), "vals": (vals, (k, n))})
    lib = load_library()
    y = torch.empty_like(x)
    offs = np.asarray(offsets, np.int32)
    err = lib.mg_dia_spmv(vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                          offs.ctypes.data, k, _stream(x.device))
    check(err, "DIA SpMV launch")
    launches["dia_spmv"] += 1
    return y

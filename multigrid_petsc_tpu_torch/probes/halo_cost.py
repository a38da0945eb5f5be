"""Probe ``halo_cost``: the visit kernel alone beside the transfers
(counterpart of ``benchmarks/probe_halo_cost.py``).

The TPU visits take their k-row overlap from halo windows gathered by
strided slices outside the kernel; the JAX probe times those gathers, the
x halves of the transfers and the kernel alone.  The card builds no
window: its visits read their halo rows and columns in place from b, u
and e (``csrc/visit.cuh``, the Block notes), so ``halo_wins`` and
``gather_e`` have no counterpart and print as such.  In place of the x
halves, the port's transfers (``ops/transfer.py``: ``restrict_fw`` on the
8191^2 residual, ``prolong_bilinear`` of the 4095^2 correction; plain
PyTorch, as the visits do these inside the kernel); ``kernel_only`` is
K9's zero-guess rc visit (``stencil_kernel.fused_level_visit(...,
emit="rc")``, K2b's launch) at k = 3, the counterpart of the probe's
``raw_visit``.  Differenced between k1 = 2 and k2 = 12 calls (median of 3
pairs), GB/s against each call's bytes, beside K18a's rate.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw
from multigrid_petsc_tpu_torch.probes import (
    differenced,
    header,
    rate_line,
    stream_rate,
)
from multigrid_petsc_tpu_torch.problems import stencil_coefficients
from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

N, K = 8191, 3


def run(device="cuda", n: int | None = None, quick: bool = False):
    device = torch.device(device)
    n = n or N
    nyc = (n - 1) // 2
    k1, k2, pairs = (1, 2, 1) if quick else (2, 12, 3)
    rate = stream_rate(device)
    header("halo_cost", device, rate,
           "part: ms per call (GB/s vs its bytes, share of K18a's rate)",
           n=n, k=K, k1=k1, k2=k2, pairs=pairs)
    for part in ("halo_wins", "gather_e"):
        print(f"{part:11s}: none -- the card's visits read their halos in "
              f"place (csrc/visit.cuh), no window is gathered")
    gen = torch.Generator(device=device).manual_seed(0)
    b = torch.randn((n, n), generator=gen, device=device)
    e = torch.randn((nyc, nyc), generator=gen, device=device)
    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, device)
    steps = jacobi_step_coeffs(K, 0.8)
    fine, coarse = 4 * n * n, 4 * nyc * nyc
    parts = (
        ("restrict_fw", lambda: restrict_fw(b), fine + coarse),
        ("prolong_bilinear", lambda: prolong_bilinear(e), coarse + fine),
        ("kernel_only", lambda: sk.fused_level_visit(st, b, None, steps,
                                                     emit="rc"),
         2 * fine + coarse),
    )
    rows = []
    for name, fn, nbytes in parts:
        s = differenced(fn, k1, k2, device, pairs)
        rows.append({"part": name, "ms": 1e3 * s, "GBps": nbytes / s / 1e9})
        print(rate_line(f"{name:11s}", s, nbytes, rate), flush=True)
    return rows

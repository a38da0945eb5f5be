"""Probe ``mdma_vpu``: what inside K2b's down visit costs the time
(counterpart of ``benchmarks/probe_mdma_vpu.py``).

At 8191^2 f32, k = 3, the modes of the JAX probe on KP1
(``ops/cuda/probe_kernel.py``): full (the production body), norestrict
(rc = the y-restricted rows, no x pass), nosweep (one step of the three)
and dmaonly (the port's loadstore: u = b, rc = b's odd-odd points, no
arithmetic: the visit's load and store floor as its region stages them).
Differenced between k1 = 2 and k2 = 77 visits, median of 3 pairs, as the
JAX probe; rows as ``visit_vpu``'s.  The header gives the region a block
stages (tile plus halo) and the passes over b that staging reads.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.probes.visit_vpu import K, N, ablation_rows

MODES = ("full", "norestrict", "nosweep", "dmaonly")


def run(device="cuda", n: int | None = None, quick: bool = False):
    device = torch.device(device)
    n = n or N
    h = K + 2
    sh, sw = mdma.visit5_region(h)
    gx, gy, ty, tx = mdma.visit5_grid(n, n, h)
    staged = gx * gy * sh * sw / (n * n)
    k1, k2, pairs = (1, 2, 1) if quick else (2, 77, 3)
    return ablation_rows(
        "mdma_vpu", MODES, device, n, k1, k2, pairs,
        {"region": f"{sh}x{sw}", "tile": f"{ty}x{tx}",
         "blocks": gx * gy, "passes_staged": round(staged + 1.25, 3)})

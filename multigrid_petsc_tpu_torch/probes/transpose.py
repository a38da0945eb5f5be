"""Probe ``transpose``: the x-transfer passes on a resident slab
(counterpart of ``benchmarks/probe_transpose.py``).

The JAX probe times what the down visit's x-restriction
(``_restrict_x_pad``: [1, 2, 1] in lane form, then the transpose trick
for the even-lane compaction) and the up visit's x-prolongation
(``_prolong_x_pad``) cost on a VMEM-resident slab, G = 86 passes (the
8191^2 tile count) with no device-memory traffic, and their parts.  The
card has no transpose trick: its x-restriction is a pass over shared
memory.  Here K18b-R (``xfer_probe_kernel.xfer_restrict``,
on a (48, 8192) f32 slab) runs each mode in the JAX order (noop, apply8,
arith, shuffle, full) and K18b-P (``xfer_prolong``, (57, 4096) -> (57,
8192)) the prolongation, each warp holding its span of a slab row in
shared memory for the G passes (``csrc/probe_xfer.cu``).  Each row: ms
per G-block pass (one launch), device time differenced between k1 = 2
and k2 = 300 launches queued behind a sleep (median of 3 pairs), that
time less noop's, the mode's bound (``xfer_probe_kernel.xfer_bound``:
the JAX function's operations at 128 instructions a clock an SM, or its
slab's input columns once a pass at 128 B of shared memory a clock an
SM, at the SM clock's maximum) with what binds it and its share of the
time, and the bytes the kernel's design reads from shared memory.  Each
kernel is first held to its plain version bit for bit.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import xfer_probe_kernel as xk
from multigrid_petsc_tpu_torch.probes import (
    differenced,
    header,
    smem_rate,
    stream_rate,
)

TH, NXP, G, T2 = 48, 8192, 86, 112  # the JAX probe's slab and passes
MODES = ("noop", "apply8", "arith", "shuffle", "full")


def run(device="cuda", n: int | None = None, quick: bool = False):
    """The slab's fine width nxp = NXP, or n rounded up to even."""
    device = torch.device(device)
    nxp = n + n % 2 if n else NXP
    rows_p = T2 // 2 + 1
    k1, k2, pairs = (1, 2, 1) if quick else (2, 300, 3)
    rate, peak = stream_rate(device), smem_rate(device)
    header("transpose", device, rate,
           f"mode: ms per {G}-block pass | less noop's | bound (what binds "
           f"it; share of the time) | the design's shared-memory bytes",
           rows=TH, nxp=nxp, G=G, prolong_rows=rows_p, k1=k1, k2=k2,
           pairs=pairs,
           per_second=("not measured (cpu)" if peak is None
                       else f"{peak / 1e12:.2f} T"))
    gen = torch.Generator(device=device).manual_seed(22)
    x = torch.randn((TH, nxp), generator=gen, device=device)
    e = torch.randn((rows_p, nxp // 2), generator=gen, device=device)
    cases = [(m, TH, lambda m=m: xk.xfer_restrict(x, m, G),
              lambda m=m: xk.xfer_restrict_plain(x, m, G)) for m in MODES]
    cases.append(("prolong", rows_p, lambda: xk.xfer_prolong(e, G),
                  lambda: xk.xfer_prolong_plain(e, G)))
    for mode, _, fn, plain in cases:
        got, want = fn(), plain()
        assert torch.equal(got, want), \
            f"{mode}: kernel against plain " \
            f"{float((got - want).abs().max()):.3e}"
    rows, noop = [], None
    for mode, nrows, fn, _ in cases:
        s = differenced(fn, k1, k2, device, pairs, queued=True)
        noop = s if mode == "noop" else noop
        nbytes = xk.smem_read_bytes(mode, nrows, nxp, G)
        if peak is None:
            bound = "not measured (cpu)"
        else:
            b = xk.xfer_bound(mode, nrows, nxp, G, peak)
            bound = (f"{b['bound_ms']:.4f} ms ({b['bound_by']}; "
                     f"{100 * 1e-3 * b['bound_ms'] / s:.1f}% of the time)")
        rows.append({"mode": mode, "ms": 1e3 * s, "smem_bytes": nbytes})
        print(f"{mode:8s}: {1e3 * s:.4f} ms per {G}-block pass | less noop "
              f"{1e3 * (s - noop):.4f} ms | bound {bound} | shared memory "
              f"{nbytes / 1e6:.1f} MB", flush=True)
    return rows

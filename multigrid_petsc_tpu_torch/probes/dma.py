"""Probe ``dma``: the stream rates of fresh, in-place and staged copies
(counterpart of ``benchmarks/probe_dma.py``).

At 8192^2 f32, each rate against the bytes one pass moves (2 n^2 4):
  D  the library triad c <- 0.999 c + 1e-9 (one ``torch.add`` call into the
     other buffer, loop-differenced between k = 4 and 68 calls)
  A  K18a ``scale_copy`` o = 1.0001 u into a fresh output each call (k = 2
     and 18)
  B  KP2 ``scale_copy_`` u <- 1.0001 u in place (k = 2 and 18)
  C  KP3 ``staged_copy``: k passes in one launch through shared memory,
     the launch of k = 8 less that of k = 1 over 7 passes (and k = 1 alone)
each the median of 3 differenced pairs, beside K18a's stream rate.  B and
C are first held to their plain versions bit for bit.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import pipeline_kernel as pk
from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as sk
from multigrid_petsc_tpu_torch.probes import (
    differenced,
    feeding,
    header,
    rate_line,
    stream_rate,
    sync,
)

N = 8192


def run(device="cuda", n: int | None = None, quick: bool = False):
    device = torch.device(device)
    n = n or N
    pairs = 1 if quick else 3
    rate = stream_rate(device)
    header("dma", device, rate,
           "probe: ms per pass (GB/s vs 2 n^2 4 B, share of K18a's rate)",
           n=n, pairs=pairs)
    nbytes = 2 * 4 * n * n
    x = torch.ones((n, n), device=device)
    y = torch.empty_like(x)
    c = torch.tensor(1e-9, device=device)
    # Exact checks first: the in-place and the staged copies.
    gen = torch.Generator(device=device).manual_seed(3)
    r = torch.randn((n, n), generator=gen, device=device)
    want = sk.scale_copy_plain(r, 1.0001)
    assert torch.equal(sk.scale_copy_(r.clone(), 1.0001), want), "B"
    for k in (1, 2, 3):
        assert torch.equal(pk.staged_copy(r, k), r), f"C k={k}"
    del r, want
    sync(device)
    bufs = [x, y]

    def triad():
        torch.add(c, bufs[0], alpha=0.999, out=bufs[1])
        bufs.reverse()

    rows = []

    def row(name, s, what):
        rows.append({"probe": name, "ms": 1e3 * s,
                     "GBps": nbytes / s / 1e9})
        print(f"{rate_line(f'{name} {what}', s, nbytes, rate)}", flush=True)

    q = quick
    row("D", differenced(triad, *((1, 2) if q else (4, 68)), device, pairs),
        "library triad (torch.add)")
    row("A", differenced(feeding(lambda v: sk.scale_copy(v, 1.0001), x),
                         *((1, 2) if q else (2, 18)), device, pairs),
        "K18a copy, fresh output")
    row("B", differenced(lambda: sk.scale_copy_(x, 1.0001),
                         *((1, 2) if q else (2, 18)), device, pairs),
        "KP2 copy in place")
    s1 = differenced(lambda: pk.staged_copy(x, 1), 0, 1, device, pairs)
    s8 = differenced(lambda: pk.staged_copy(x, 8), 0, 1, device, pairs)
    row("C", (s8 - s1) / 7, "KP3 staged copy, k = 8 less k = 1")
    row("C1", s1, "KP3 staged copy, one launch of k = 1")
    return rows

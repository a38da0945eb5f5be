"""Probe ``dma_parts``: the compute-free visit pipeline, part by part
(counterpart of ``benchmarks/probe_dma_parts.py``).

At 8191^2 f32 (the JAX probe pads its rows to 8192; the card's rows keep
their 8191 values, so three rows in four start off 16-byte alignment and
their heads and tails go by plain loads), KP3's
``staged_visit_pipeline`` in the JAX probe's modes (v_full, v_norc,
v_nocarry, v_direct, v_bare; ``ops/cuda/pipeline_kernel.py``) over tiles
of t rows x 256 columns with 8 halo rows, t from shared memory (every
mode at 32 and 16, then 48 and 64 where they fit; the TPU's 96-256 rows
of 8192 do not fit).  Each row: ms per call differenced between k1 = 2
and k2 = 77 calls (median of 3 pairs), GB/s against the bytes the mode
must move (b in, u out: 2 passes; rc out: 0.25 more), the share of
K18a's rate; then the bytes it does move on the card's plan, the halo
rows it reads again included (``pipe_bytes``), and its ring; each mode
first held to its plain version bit for bit.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import pipeline_kernel as pk
from multigrid_petsc_tpu_torch.probes import (
    differenced,
    header,
    rate_line,
    stream_rate,
)

N = 8191
CASES = (("v_full", 32), ("v_norc", 32), ("v_nocarry", 32),
         ("v_direct", 32), ("v_bare", 32), ("v_full", 16), ("v_norc", 16),
         ("v_nocarry", 16), ("v_direct", 16), ("v_bare", 16),
         ("v_full", 48), ("v_direct", 48), ("v_bare", 48), ("v_direct", 64))


def run(device="cuda", n: int | None = None, quick: bool = False):
    device = torch.device(device)
    n = n or N
    nyc = (n - 1) // 2
    k1, k2, pairs = (1, 2, 1) if quick else (2, 77, 3)
    cases = CASES[:5] if quick else CASES
    rate = stream_rate(device)
    header("dma_parts", device, rate,
           "mode t: ms per call (GB/s vs b in + u out [+ rc out], share of "
           "K18a's rate) | bytes moved on the card's plan (re-read) | "
           "shared memory a block, ring stages",
           n=n, halo=pk.HALO, tile_cols=pk.TILE_COLS, warps=pk.PIPE_WARPS,
           k1=k1, k2=k2, pairs=pairs)
    gen = torch.Generator(device=device).manual_seed(5)
    b = torch.randn((n, n), generator=gen, device=device)
    rows = []
    for mode, t in cases:
        u, rc = pk.staged_visit_pipeline(b, t, mode)
        pu, prc = pk.staged_visit_pipeline_plain(b, t, mode)
        assert torch.equal(u, pu), f"{mode} t={t}: u"
        assert (rc is None) == (prc is None), f"{mode} t={t}: rc"
        assert rc is None or torch.equal(rc, prc), f"{mode} t={t}: rc"
        del u, rc, pu, prc
        nbytes = 4 * (2 * n * n
                      + (nyc * nyc if pk.PIPE_MODES[mode][2] else 0))
        s = differenced(lambda m=mode, tt=t: pk.staged_visit_pipeline(b, tt, m),
                        k1, k2, device, pairs)
        row = {"mode": mode, "t": t, "ms": 1e3 * s, "GBps": nbytes / s / 1e9}
        moved = "- (no card)"
        if device.type == "cuda":
            blocks, bands = pk.pipe_plan((n, n), t, mode)
            row.update(pk.pipe_bytes(n, n, t, mode, bands), blocks=blocks,
                       bands=bands)
            moved = (f"{row['moved'] / 1e6:.2f} MB ({row['reread'] / 1e6:.2f}"
                     f" MB re-read) on {blocks} blocks, {bands} bands")
        rows.append(row)
        print(f"{rate_line(f'{mode:9s} t={t:3d}', s, nbytes, rate)} | "
              f"{moved} | {pk.pipe_smem_bytes(t, mode)} B shared, "
              f"{pk.pipe_stages(t, mode)} stages", flush=True)
    return rows

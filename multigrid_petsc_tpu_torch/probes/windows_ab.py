"""Probe ``windows_ab``: what the TPU's halo windows would cost a
preconditioner apply (counterpart of ``benchmarks/probe_windows_ab.py``).

The TPU's fused visits take their row halos from windows gathered
outside the kernel, (g, h, nx) arrays of the rows above and below each
tile of t rows; the JAX probe builds them by strided slices (A) or by
one Pallas pass (B) inside the preconditioner and compares the applies.
The card's visits read their halos in place (``csrc/visit.cuh``), so
here the windows are an extra cost, timed beside the apply they would
join: at 8193^2 / 11 levels f32 (Poisson, v = 3, 3), the windows JAX's
fused visits gather on the levels the port visits outside the coarse
tree (``krylov.build_coarse_tree``: levels 0-2, 8191^2, 4095^2, 2047^2):
on each, the down visit's b windows (h = k + 2) and the up visit's u and
b windows (h = k), t JAX's tile (``tile_rows``).  Each round prints
  apply      ``vcycle.mg_apply_dot(ctx, b, 3, 3)``, ms per apply
  A(gather)  those windows built by strided slices
             (``xfer_probe_kernel.halo_windows_plain``), ms per apply
  B(kernel)  the same windows built by K18b-W (``halo_windows``), ms per
             apply, GB/s against their bytes (rows read and written)
differenced between k1 = 2 and k2 = 10 calls on the host clock (the JAX
probe takes one pair; here the median of 3), four rounds interleaved as
the JAX probe runs them; B's windows are held to A's bit for bit first.
The JAX probe's e windows stay on strided slices in both of its variants
and are left out here.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import xfer_probe_kernel as xk
from multigrid_petsc_tpu_torch.probes import differenced, header, stream_rate
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.krylov import build_coarse_tree
from multigrid_petsc_tpu_torch.solvers.vcycle import mg_apply_dot
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

NPTS, K, ROUNDS = 8193, 3, 4


def tile_rows(ny: int, nx: int, h: int, itemsize: int = 4) -> int | None:
    """JAX's row tile t of a fused visit with halo h on an ny x nx level
    (``stencil_kernel._pick_tile(nx, dtype, bufs=12, cap=256)``, shrunk as
    ``stencil_kernel.py:725-733`` shrinks it); None where the fused visit
    refuses the level."""
    t = max(16, min(256, (64 * 2**20) // (12 * max(1, nx) * itemsize)))
    t = max(16, (t // 16) * 16)
    if ny < t + 2 * h:
        t = max(16, ((ny - 2 * h) // 16) * 16)
        if ny < t + 2 * h:
            return None
    return t if -(-ny // t) >= 2 else None


def apply_windows(ctx) -> list[tuple[int, int, int, int, str]]:
    """(level, t, g, h, which array) of every window pair an apply
    gathers on the levels outside the coarse tree."""
    tree = build_coarse_tree(ctx)
    out = []
    for lvl in range(tree[0] if tree else len(ctx.levels)):
        ny, nx = ctx.levels[lvl].shape
        for h, arr in ((K + 2, "b"), (K, "u"), (K, "b")):
            t = tile_rows(ny, nx, h)
            if t is not None:
                out.append((lvl, t, -(-ny // t), h, arr))
    return out


def run(device="cuda", n: int | None = None, quick: bool = False):
    """At npts^2: npts the grid size 2^m + 1 next above n (default 8193),
    the levels down to a 7^2 coarsest grid (8193^2: 11)."""
    device = torch.device(device)
    npts = 2 ** (n - 1).bit_length() + 1 if n else NPTS
    levels = (npts - 1).bit_length() - 3
    k1, k2, rounds, pairs = (1, 2, 1, 1) if quick else (2, 10, ROUNDS, 3)
    cfg = SolverConfig(npts=npts, grids=levels, levels=levels,
                       cycle=CycleType.MGCG, dtype="float32")
    ctx = build_context(cfg, device=device)
    wins = apply_windows(ctx)
    gen = torch.Generator(device=device).manual_seed(22)
    arrays = {}
    for lvl, _, _, _, arr in wins:
        if (lvl, arr) not in arrays:
            arrays[lvl, arr] = torch.randn(ctx.levels[lvl].shape,
                                           generator=gen, device=device)
    nbytes = sum(xk.windows_bytes(*arrays[lvl, arr].shape, t, g, h, h)
                 for lvl, t, g, h, arr in wins)
    rate = stream_rate(device)
    header("windows_ab", device, rate,
           "round: apply ms per apply | A(gather) ms per apply | B(kernel) "
           "ms per apply (GB/s vs the windows' bytes, share of K18a's "
           "rate)", npts=npts, levels=levels, k=K, k1=k1, k2=k2,
           pairs=pairs,
           windows=" ".join(f"L{lvl}:{arr}(t={t},g={g},h={h})"
                            for lvl, t, g, h, arr in wins),
           window_MB=f"{nbytes / 1e6:.2f}")

    def build(fn):
        return [fn(arrays[lvl, arr], t, g, h, h)
                for lvl, t, g, h, arr in wins]

    for got, want in zip(build(xk.halo_windows),
                         build(xk.halo_windows_plain)):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            "halo_windows: kernel against plain"
    b = ctx.b0
    steps = {"apply": lambda: mg_apply_dot(ctx, b, K, K),
             "A": lambda: build(xk.halo_windows_plain),
             "B": lambda: build(xk.halo_windows)}
    rows = []
    for r in range(rounds):
        s = {name: differenced(fn, k1, k2, device, pairs)
             for name, fn in steps.items()}
        gbs = nbytes / max(s["B"], 1e-12) / 1e9
        share = ("K18a's rate not measured" if rate is None else
                 f"{100 * gbs * 1e9 / rate:.1f}% of K18a's "
                 f"{rate / 1e9:.1f} GB/s")
        rows.append({"round": r, **{f"{k}_ms": 1e3 * v
                                    for k, v in s.items()}})
        print(f"round {r}: apply {1e3 * s['apply']:.4f} ms per apply | "
              f"A(gather) {1e3 * s['A']:.4f} ms per apply | B(kernel) "
              f"{1e3 * s['B']:.4f} ms per apply ({gbs:.1f} GB/s vs "
              f"{nbytes / 1e6:.2f} MB, {share})", flush=True)
    return rows

"""Halo exchange and reductions of a partitioned level over
``torch.distributed`` (PyTorch counterpart of JAX ``dist_kernel.
_edge_exchange`` :378-385, of ``halo.py`` ``halo_pad_local`` :31-60 and of
the collectives GSPMD inserts for the JAX package; reference: the scatter
under every MatMult, src/solver.c:1516,1535,1540, and VecNorm / VecDot).

Neighbours swap their edges by point-to-point send and receive; a rank
without a neighbour on one side gets zeros there, the eliminated Dirichlet
boundary, as JAX's ppermute delivers zeros for missing pairs.  The rows
layout swaps edge rows (``edge_exchange``); the blocks layout swaps a
block's edge columns with its mesh-row neighbours, then the rows of the
column-extended block with its mesh-column neighbours, so the corners
travel too (``block_exchange``; a fused k-sweep visit reads them, where
JAX's one-apply 5-point exchange zero-pads them).  Under NCCL the CUDA
tensors travel as they are; under gloo a CUDA tensor's edges are copied
to the host first (the copy waits for the stream) and the received ones
copied back (the plan's transport "gloo-host").  gloo and NCCL send
contiguous buffers only, so a block's edge columns are packed first.

Every all-gather is counted by what it gathers (``gathers``, and its
bytes as this rank sends them in ``gathered_bytes``; cleared by the
caller, as ``ops.cuda.launches``):
  "agglomerate"  the restricted blocks of a sharded level or grid onto the
                 level or grid below it where that one is replicated (or,
                 under blocks, split along fewer axes: the blocks gathered
                 along the axis that stops being split; JAX's
                 agglomeration; inside a merged level too);
  "line"         the line smoothers' segment carries across the ranks
                 (on the CPU: the line right-hand sides): the y-lines' of
                 the rows layout over every rank, under blocks the
                 y-lines' over the mesh column and the x-lines' over the
                 mesh row (``all_gather_lines``);
  "coarsest"     a sharded coarsest level solved directly (where JAX
                 runs it through GSPMD and densifies it; a small level),
                 or the sharded grids of a directly solved merged one;
  "solution"     the level-0 solution or a checkpoint's state.
No cycle gathers a sharded level's or grid's own points whole: a solve's
gathers inside its iterations are "agglomerate", "line" and "coarsest"
only, which the tests and ``chip_smoke.py`` assert.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch
import torch.distributed as dist

from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo, Halo2

GATHERS = ("agglomerate", "line", "coarsest", "solution")
gathers: Counter = Counter()
gathered_bytes: Counter = Counter()


def _staged(x: torch.Tensor, plan) -> bool:
    """Does ``x`` travel through the host (gloo with a CUDA tensor)?"""
    return x.is_cuda and plan.backend != "nccl"


def edge_exchange(x, n: int, plan):
    """(from_prev, from_next): the last ``n`` rows of the previous rank's
    block and the first ``n`` of the next rank's, zeros at the global
    edges.  ``x`` is this rank's (R, w) block, or a tuple of blocks of one
    width, whose rows travel in one message each way; then a list of
    ``Halo`` (top = from_prev, bot = from_next), one per block."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    w = xs[0].shape[1]
    if n > xs[0].shape[0]:
        raise ValueError(f"a halo of {n} rows exceeds the {xs[0].shape[0]}-"
                         f"row block: rows come from the neighbours only")
    stage = _staged(xs[0], plan)
    dev = torch.device("cpu") if stage else xs[0].device
    rank, size = plan.rank, plan.size
    m = n * len(xs)
    from_prev = torch.zeros((m, w), dtype=xs[0].dtype, device=dev)
    from_next = torch.zeros((m, w), dtype=xs[0].dtype, device=dev)
    reqs = []
    if rank > 0:
        peer = plan.global_rank(rank - 1)
        first = torch.cat([t[:n] for t in xs]).to(dev)
        reqs += [dist.isend(first, peer, group=plan.group),
                 dist.irecv(from_prev, peer, group=plan.group)]
    if rank < size - 1:
        peer = plan.global_rank(rank + 1)
        last = torch.cat([t[-n:] for t in xs]).to(dev)
        reqs += [dist.isend(last, peer, group=plan.group),
                 dist.irecv(from_next, peer, group=plan.group)]
    for r in reqs:
        r.wait()
    if stage:
        from_prev = from_prev.to(xs[0].device)
        from_next = from_next.to(xs[0].device)
    halos = [Halo(from_prev[i * n:(i + 1) * n], from_next[i * n:(i + 1) * n])
             for i in range(len(xs))]
    return halos[0] if isinstance(x, torch.Tensor) else halos


def allreduce_sum(x: torch.Tensor, plan, group=None) -> torch.Tensor:
    """The sum of ``x`` over the plan's ranks (or over ``group``, a
    subgroup of them), on every rank (the same value everywhere, so every
    rank takes the same branch of a stop test)."""
    y = x.detach().cpu() if _staged(x, plan) else x.detach().clone()
    dist.all_reduce(y, group=plan.group if group is None else group)
    return y.to(x.device)


def all_gather_rows(x: torch.Tensor, plan, what: str) -> torch.Tensor:
    """Every rank's (R, w) block stacked in rank order, on every rank;
    counted under ``what`` (one of ``GATHERS``)."""
    _count(x, what)
    return torch.cat(_gather(x, plan, None)).to(x.device)


def block_exchange(x, h: int, plan, split=(True, True)):
    """The depth-``h`` halo of this rank's (R, C) block under the blocks
    layout (``halo_pad_local`` with corners): a ``Halo2`` of the ``h``
    columns left and right of the block, (R, h) each, and the ``h`` rows
    above and below the column-extended block, (h, C + 2h) each, corners
    included; zeros at the global edges and along an axis the level is
    not split on (``split``: (y, x)).  Two passes: the edge columns with
    the mesh-row neighbours, then the rows of [left | x | right] with the
    mesh-column neighbours.  ``x`` may be a tuple of blocks of one shape,
    whose edges travel in one message each way; then a list of
    ``Halo2``, one per block."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    R, C = xs[0].shape
    sy, sx = split
    if (sy and h > R) or (sx and h > C):
        raise ValueError(f"a halo of {h} exceeds the {R} x {C} block: "
                         f"points come from the neighbours only")
    stage = _staged(xs[0], plan)
    dev = torch.device("cpu") if stage else xs[0].device
    n = len(xs)
    rank = plan.rank
    iy, ix = plan.coords
    my, mx = plan.mesh
    new = functools.partial(torch.zeros, dtype=xs[0].dtype, device=dev)

    def swap(lo_peer, hi_peer, first, last, recv_lo, recv_hi):
        reqs = []
        for peer, out, into in ((lo_peer, first, recv_lo),
                                (hi_peer, last, recv_hi)):
            if peer is not None:
                peer = plan.global_rank(peer)
                reqs += [dist.isend(out().contiguous(), peer,
                                    group=plan.group),
                         dist.irecv(into, peer, group=plan.group)]
        for r in reqs:
            r.wait()

    # Pass 1: the edge columns, packed as (n R, h), with the x neighbours.
    left, right = new((n * R, h)), new((n * R, h))
    if sx:
        swap(rank - 1 if ix > 0 else None, rank + 1 if ix < mx - 1 else None,
             lambda: torch.cat([t[:, :h] for t in xs]).to(dev),
             lambda: torch.cat([t[:, C - h:] for t in xs]).to(dev),
             left, right)
    lefts, rights = left.split(R), right.split(R)
    # Pass 2: the rows of the column-extended blocks with the y neighbours.
    top, bot = new((n * h, C + 2 * h)), new((n * h, C + 2 * h))
    if sy:
        def rows(lo):
            sl = slice(0, h) if lo else slice(R - h, R)
            return torch.cat([torch.cat([lt[sl], t[sl].to(dev), rt[sl]], 1)
                              for t, lt, rt in zip(xs, lefts, rights)])

        swap(rank - mx if iy > 0 else None,
             rank + mx if iy < my - 1 else None,
             lambda: rows(True), lambda: rows(False), top, bot)
    to = xs[0].device
    halos = [Halo2(*(p.to(to) for p in (tp, bt, lt, rt)))
             for tp, bt, lt, rt in zip(top.split(h), bot.split(h), lefts,
                                       rights)]
    return halos[0] if isinstance(x, torch.Tensor) else halos


def _count(x: torch.Tensor, what: str) -> None:
    if what not in GATHERS:
        raise ValueError(f"unknown gather {what!r}")
    gathers[what] += 1
    gathered_bytes[what] += x.numel() * x.element_size()


def _gather(x: torch.Tensor, plan, group) -> list:
    """Every rank's ``x`` in ``group`` (None: the plan's), in rank order,
    on the host when ``x`` travels through it."""
    src = x.detach().cpu() if _staged(x, plan) else x.detach().contiguous()
    g = plan.group if group is None else group
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, src, group=g)
    return parts


def all_gather_blocks(x: torch.Tensor, plan, what: str,
                      axes=(True, True)) -> torch.Tensor:
    """The blocks of every rank along ``axes`` ((y, x)) joined, on every
    rank, pad rows and columns kept (both axes: the whole level): along
    both axes one all-gather of the world, along one axis the mesh
    column's (y) or row's (x); counted once, under ``what`` (one of
    ``GATHERS``)."""
    sy, sx = axes
    if not (sy or sx):
        return x
    _count(x, what)
    if sy and sx:
        parts = _gather(x, plan, None)
        mx = plan.mesh[1]
        whole = torch.cat([torch.cat(parts[i:i + mx], 1)
                           for i in range(0, len(parts), mx)])
    elif sy:
        whole = torch.cat(_gather(x, plan, plan.col_group))
    else:
        whole = torch.cat(_gather(x, plan, plan.row_group), 1)
    return whole.to(x.device)


def all_gather_lines(x: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """The line smoother's gather under the blocks layout: every ``x`` of
    the ranks a line spans, stacked along x's rows in mesh order, on
    every rank; the mesh column's for a y-line (``axis`` 0), the mesh
    row's for an x-line (``axis`` 1; its blocks run transposed, so their
    rows are the level's columns).  Counted under "line"."""
    _count(x, "line")
    group = plan.col_group if axis == 0 else plan.row_group
    return torch.cat(_gather(x, plan, group)).to(x.device)

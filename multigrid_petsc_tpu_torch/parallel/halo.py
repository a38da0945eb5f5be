"""Halo exchange and reductions of a row-partitioned level over
``torch.distributed`` (PyTorch counterpart of JAX ``dist_kernel.
_edge_exchange`` :378-385 and of the collectives GSPMD inserts for the JAX
package; reference: the scatter under every MatMult, src/solver.c:1516,
1535,1540, and VecNorm / VecDot).

Neighbours swap their edge rows by point-to-point send and receive; a rank
without a neighbour on one side gets zeros there, the eliminated Dirichlet
boundary, as JAX's ppermute delivers zeros for missing pairs.  Under NCCL
the CUDA tensors travel as they are; under gloo a CUDA tensor's rows are
copied to the host first (the copy waits for the stream) and the received
rows copied back (the plan's transport "gloo-host").  JAX's 2-D block
halo (``halo.py`` ``halo_pad_local``) serves the blocks layout, which is
not ported.

Every all-gather is counted by what it gathers (``gathers``, and its
bytes as this rank sends them in ``gathered_bytes``; cleared by the
caller, as ``ops.cuda.launches``):
  "agglomerate"  the restricted rows of a sharded level or grid onto the
                 replicated level or grid below it (JAX's
                 agglomeration; inside a merged level too);
  "line"         the y-line smoother's segment carries across the ranks
                 (on the CPU: the line right-hand sides);
  "coarsest"     a sharded coarsest level solved directly (where JAX
                 runs it through GSPMD and densifies it; a small level),
                 or the sharded grids of a directly solved merged one;
  "solution"     the level-0 solution or a checkpoint's state.
No cycle gathers a sharded level's or grid's own rows whole: a solve's
gathers inside its iterations are "agglomerate", "line" and "coarsest"
only, which the tests and ``chip_smoke.py`` assert.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo

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


def allreduce_sum(x: torch.Tensor, plan) -> torch.Tensor:
    """The sum of ``x`` over the plan's ranks, on every rank (the same
    value everywhere, so every rank takes the same branch of a stop
    test)."""
    y = x.detach().cpu() if _staged(x, plan) else x.detach().clone()
    dist.all_reduce(y, group=plan.group)
    return y.to(x.device)


def all_gather_rows(x: torch.Tensor, plan, what: str) -> torch.Tensor:
    """Every rank's (R, w) block stacked in rank order, on every rank;
    counted under ``what`` (one of ``GATHERS``)."""
    if what not in GATHERS:
        raise ValueError(f"unknown gather {what!r}")
    gathers[what] += 1
    gathered_bytes[what] += x.numel() * x.element_size()
    stage = _staged(x, plan)
    src = x.detach().cpu() if stage else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(plan.size)]
    dist.all_gather(parts, src, group=plan.group)
    return torch.cat(parts).to(x.device)

"""The sharding plans over a ``torch.distributed`` process group (PyTorch
counterpart of ``multigrid_petsc_tpu/parallel/device_mesh.py``:
``_factor2`` :27-32, ``make_device_mesh`` :35-48, ``ShardingPlan``
:52-105, ``row_plan`` :116-120).

Each rank is one process.  Two layouts, as in the JAX package:

"rows"    (``-map 2``, ``row_plan``) the reference's block-row partition
          (src/matbuild.c:120-144 GetRanges): a row-sharded level keeps
          its ``ny + 1`` rows (one pad row) as P blocks of R = (ny + 1) /
          P rows, block p on rank p.  The split rule is JAX's rows branch
          (:79-84), per grid: the grids of a merged level are split one by
          one, so a merged level may hold sharded and replicated grids
          side by side.
"blocks"  (``-map 0/1``, ``blocks_plan``) the 2-D block partition over a
          (my, mx) rank mesh, the most-square factorisation of the rank
          count with my <= mx (``mesh_shape``); rank r sits at (iy, ix) =
          divmod(r, mx), row-major as JAX lays its devices out.  A level
          is split along y where ny // my >= min_local and along x where
          nx // mx >= min_local (JAX's ``spec``, letter for letter); an
          axis of mesh size 1 is never split.  A split axis carries one
          pad row (or pad column), as the rows layout does: ny + 1 rows in
          my blocks, on any rank count.  The blocks are nested and even
          (``block_sides``): the coarsest level split along an axis is cut
          into balanced blocks of even sides, and each finer split level
          takes exactly twice those blocks, so every side and origin is
          even and the coarse block under a fine block is the coarse
          level's own block (128 = 44 + 42 + 42 on three ranks; JAX's
          GSPMD pads uneven shards instead, the reference's GetRanges
          splits any rank count).

Levels too small to split are replicated: every rank holds them whole and
computes them redundantly, the JAX package's agglomeration
(device_mesh.py:11-15); under blocks a level split along one axis only is
replicated across the other.

The plan knows its rank, world size, its rank's device and its transport:
  "nccl"       CUDA tensors sent by NCCL (one card per rank);
  "gloo"       CPU tensors (the CPU tests);
  "gloo-host"  CUDA tensors whose halos and reductions are staged through
               the host: ranks that share one card, where NCCL refuses two
               ranks on one device.
The transport follows the process group's backend and the device only;
nothing picks it silently.  A plan's device is the rank's card unless the
caller names the CPU.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.distributed as dist


def rank_device(device: torch.device | str, backend: str) -> torch.device:
    """This rank's device: the CPU, a CUDA device the caller named, or for
    ``"cuda"`` cuda:LOCAL_RANK under NCCL and cuda:(LOCAL_RANK mod the
    card count) under gloo (ranks sharing the cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if backend == "nccl" or n == 0:
        return torch.device("cuda", local)
    return torch.device("cuda", local % n)


def _factor2(n: int) -> tuple[int, int]:
    """Most-square factorisation a * b = n with a <= b (JAX's)."""
    a = math.isqrt(n)
    while n % a:
        a -= 1
    return a, n // a


def mesh_shape(size: int, shape: tuple[int, int] | None = None
               ) -> tuple[int, int]:
    """The (my, mx) rank mesh of ``size`` ranks: ``shape``, or the
    most-square factorisation (``make_device_mesh(shape=)``'s rule)."""
    if shape is None:
        return _factor2(size)
    my, mx = shape
    if my * mx != size:
        raise ValueError(f"mesh shape {shape} != {size} ranks")
    return my, mx


class Block(NamedTuple):
    """A rank's block of an (ny, nx) level under the blocks layout: R x C
    points from the global (row0, col0); ``split`` says along which axes
    (y, x) the level is split (a split axis counts its pad row or
    column; an axis not split holds the level's whole extent)."""

    R: int
    C: int
    row0: int
    col0: int
    split: tuple[bool, bool]


@dataclass(frozen=True)
class ShardingPlan:
    """Which levels a solve shards over ``group`` (None: the default
    process group), and where the rank's data lives.

    ``min_local`` is the fewest rows (blocks: rows or columns) per rank
    below which a level is replicated instead.  ``layout`` is "rows" (the
    1-D block-row partition, ``row_plan``) or "blocks" (the 2-D block
    partition over the ``mesh`` (my, mx), by default the most-square
    one; ``blocks_plan``).  ``device`` None is the rank's card
    (``rank_device``); the CPU only when named."""

    group: object = None
    min_local: int = 32
    layout: str = "rows"
    device: torch.device | None = None
    mesh: tuple[int, int] | None = None
    # Blocks: this rank's mesh row and mesh column (the ranks that share
    # its iy, and its ix), made once, at construction, by every rank.
    row_group: object = field(default=None, init=False, compare=False,
                              repr=False)
    col_group: object = field(default=None, init=False, compare=False,
                              repr=False)

    def __post_init__(self):
        if self.layout not in ("rows", "blocks"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if not dist.is_initialized():
            raise RuntimeError("a sharding plan needs an initialised "
                               "torch.distributed process group")
        dev = rank_device("cuda" if self.device is None else self.device,
                          self.backend)
        object.__setattr__(self, "device", dev)
        if self.layout == "rows":
            if self.mesh is not None:
                raise ValueError("the rows layout takes no mesh")
            return
        my, mx = mesh_shape(self.size, self.mesh)
        object.__setattr__(self, "mesh", (my, mx))
        # Every rank creates every group, in the same order.
        for iy in range(my):
            g = dist.new_group([self.global_rank(iy * mx + ix)
                                for ix in range(mx)])
            if iy == self.coords[0]:
                object.__setattr__(self, "row_group", g)
        for ix in range(mx):
            g = dist.new_group([self.global_rank(iy * mx + ix)
                                for iy in range(my)])
            if ix == self.coords[1]:
                object.__setattr__(self, "col_group", g)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def transport(self) -> str:
        if self.backend == "nccl":
            return "nccl"
        return "gloo-host" if self.device.type == "cuda" else "gloo"

    @property
    def coords(self) -> tuple[int, int]:
        """(iy, ix): the rank's place on the blocks mesh."""
        return divmod(self.rank, self.mesh[1])

    def global_rank(self, r: int) -> int:
        """Rank ``r`` of the plan's group in the default group."""
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def spec(self, ny: int, nx: int):
        """Rows: "rows" if an (ny, nx) level is row-sharded (its ny + 1
        rows, the pad row counted, split evenly with at least
        ``min_local`` per rank), else "replicated".  Blocks: JAX's
        partition spec as a tuple, ('y', 'x'), ('y', None), (None, 'x')
        or (None, None) (an axis of mesh size 1 keeps its letter, but is
        not split: ``split``)."""
        if self.layout == "blocks":
            my, mx = self.mesh
            return ("y" if ny // my >= self.min_local else None,
                    "x" if nx // mx >= self.min_local else None)
        P = self.size
        if (ny + 1) % P == 0 and (ny + 1) // P >= self.min_local:
            return "rows"
        return "replicated"

    def split(self, ny: int, nx: int) -> tuple[bool, bool]:
        """Along which axes (y, x) the plan splits an (ny, nx) level over
        the ranks: the spec's, on two ranks or more of that axis."""
        if self.layout == "rows":
            return (self.shards(ny, nx), False)
        sy, sx = self.spec(ny, nx)
        my, mx = self.mesh
        return (sy is not None and my > 1, sx is not None and mx > 1)

    def shards(self, ny: int, nx: int) -> bool:
        """Does a solve under the plan shard an (ny, nx) grid?  Rows: where
        ``spec`` says "rows", on two ranks or more; blocks: where it is
        split along either axis."""
        if self.layout == "blocks":
            return any(self.split(ny, nx))
        return self.size > 1 and self.spec(ny, nx) == "rows"

    def extents(self, ny: int, nx: int
                ) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """The block extents of an (ny, nx) level under the blocks layout:
        (the rows of mesh rows 0 .. my - 1, the columns of mesh columns 0
        .. mx - 1); ``block_sides`` along a split axis, the whole extent
        on every rank along the other."""
        my, mx = self.mesh
        sy, sx = self.split(ny, nx)
        return (block_sides(ny, my, self.min_local) if sy else (ny,) * my,
                block_sides(nx, mx, self.min_local) if sx else (nx,) * mx)

    def block(self, ny: int, nx: int) -> Block:
        """The rank's block of an (ny, nx) level under the blocks layout
        (``extents``): a pure function of the plan and the level's size."""
        ys, xs = self.extents(ny, nx)
        iy, ix = self.coords
        split = self.split(ny, nx)
        return Block(ys[iy], xs[ix], sum(ys[:iy]) if split[0] else 0,
                     sum(xs[:ix]) if split[1] else 0, split)


def block_sides(n: int, m: int, min_local: int) -> tuple[int, ...]:
    """The extents of the m blocks an axis of n points (+ 1 pad) is split
    into under the blocks layout (``min_local``: the plan's), nested and
    even: the coarsest size n_K = (n + 1) / 2^K - 1 of n's coarsening
    chain still split (n_K // m >= min_local) is cut into balanced
    blocks of whole pairs of points (the first ones one pair larger), and
    n takes each of them times 2^K.  Every side and origin is even (an
    odd n + 1, which no coarser level follows, gives its last block the
    odd point), and the blocks of (n - 1) / 2 are exactly half of n's."""
    k, scale = n, 1
    while k % 2 and ((k - 1) // 2) // m >= min_local:
        k, scale = (k - 1) // 2, 2 * scale
    q, r = divmod((k + 1) // 2, m)
    if q == 0:
        raise ValueError(f"{k} points + 1 pad over {m} ranks leave a block "
                         f"without a pair of points (min_local "
                         f"{min_local})")
    sides = [2 * (q + 1)] * r + [2 * q] * (m - r)
    sides[-1] += (k + 1) % 2
    return tuple(scale * e for e in sides)


def row_plan(group=None, min_local: int = 32,
             device: torch.device | str = "cuda") -> ShardingPlan:
    """The row-partition plan on ``group`` (default: the whole world), its
    rank's data on ``device`` (``rank_device``): the card unless the
    caller names the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("row_plan needs an initialised torch.distributed "
                           "process group")
    return ShardingPlan(group=group, min_local=min_local, layout="rows",
                        device=device)


def blocks_plan(group=None, min_local: int = 32,
                shape: tuple[int, int] | None = None,
                device: torch.device | str = "cuda") -> ShardingPlan:
    """The 2-D blocks plan on ``group`` (default: the whole world) over
    the (my, mx) rank mesh ``shape`` (default: the most-square one,
    ``mesh_shape``), its rank's data on ``device`` (``rank_device``): the
    card unless the caller names the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("blocks_plan needs an initialised "
                           "torch.distributed process group")
    return ShardingPlan(group=group, min_local=min_local, layout="blocks",
                        device=device, mesh=shape)

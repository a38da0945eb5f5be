"""The row-partition sharding plan over a ``torch.distributed`` process
group (PyTorch counterpart of ``multigrid_petsc_tpu/parallel/
device_mesh.py``: ``ShardingPlan`` :52-105, ``row_plan`` :116-120).

The reference runs ``mpirun -n P ./poisson`` over PETSc's block-row
partition (reference: src/matbuild.c:120-144 GetRanges).  Here each rank is
one process: a row-sharded level keeps its ``ny + 1`` rows (one pad row)
as P blocks of R = (ny + 1) / P rows, block p on rank p, and levels too
small to shard are replicated: every rank holds them whole and computes
them redundantly, the JAX package's agglomeration (device_mesh.py:11-15).
The split rule is JAX's rows branch (:79-84), per grid: the grids of a
merged level are split one by one, so a merged level may hold sharded
and replicated grids side by side (a coarser grid is sharded only if a
finer one is, (ny + 1) halving per grid).

The plan knows its rank, world size, its rank's device and its transport:
  "nccl"       CUDA tensors sent by NCCL (one card per rank);
  "gloo"       CPU tensors (the CPU tests);
  "gloo-host"  CUDA tensors whose halo rows and reductions are staged
               through the host: ranks that share one card, where NCCL
               refuses two ranks on one device.
The transport follows the process group's backend and the device only;
nothing picks it silently.  JAX's 2-D block layout (``-map 0/1``) is not
ported (ROADMAP).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from multigrid_petsc_tpu_torch.utils.config import not_ported


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


@dataclass(frozen=True)
class ShardingPlan:
    """Which levels a solve row-shards over ``group`` (None: the default
    process group), and where the rank's data lives.

    ``min_local`` is the fewest rows per rank below which a level is
    replicated instead.  ``layout`` "rows" is the 1-D block-row partition
    (JAX's ``layout="rows"``, built by ``row_plan``); "blocks" raises."""

    group: object = None
    min_local: int = 32
    layout: str = "rows"
    device: torch.device = field(default=torch.device("cpu"))

    def __post_init__(self):
        if self.layout == "blocks":
            raise not_ported("the 2-D blocks layout (-map 0/1)",
                             "distribution, the blocks layout")
        if self.layout != "rows":
            raise ValueError(f"unknown layout {self.layout!r}")
        if not dist.is_initialized():
            raise RuntimeError("a sharding plan needs an initialised "
                               "torch.distributed process group")

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

    def global_rank(self, r: int) -> int:
        """Rank ``r`` of the plan's group in the default group."""
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def spec(self, ny: int, nx: int) -> str:
        """"rows" if an (ny, nx) level is row-sharded (its ny + 1 rows,
        the pad row counted, split evenly with at least ``min_local`` per
        rank), else "replicated"."""
        P = self.size
        if (ny + 1) % P == 0 and (ny + 1) // P >= self.min_local:
            return "rows"
        return "replicated"

    def shards(self, ny: int, nx: int) -> bool:
        """Does a solve under the plan row-shard an (ny, nx) grid?  Where
        ``spec`` says "rows", on two ranks or more."""
        return self.size > 1 and self.spec(ny, nx) == "rows"


def row_plan(group=None, min_local: int = 32,
             device: torch.device | str = "cuda") -> ShardingPlan:
    """The row-partition plan on ``group`` (default: the whole world), its
    rank's data on ``device`` (``rank_device``): the card unless the
    caller names the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("row_plan needs an initialised torch.distributed "
                           "process group")
    return ShardingPlan(group=group, min_local=min_local, layout="rows",
                        device=rank_device(device, dist.get_backend(group)))

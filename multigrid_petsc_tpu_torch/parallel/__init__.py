"""Distribution over ``torch.distributed``: the row-partition plan, the
halo exchange and reductions, the solution gather and the row-sharded
level's operators (PyTorch counterpart of ``multigrid_petsc_tpu/parallel``)."""

from multigrid_petsc_tpu_torch.parallel.device_mesh import ShardingPlan, row_plan
from multigrid_petsc_tpu_torch.parallel.dist_ops import (
    DistLevelOps,
    DistMergedOps,
    dist_viable,
)
from multigrid_petsc_tpu_torch.parallel.gather import gather_solution
from multigrid_petsc_tpu_torch.parallel.halo import allreduce_sum, edge_exchange

__all__ = [
    "ShardingPlan",
    "row_plan",
    "DistLevelOps",
    "DistMergedOps",
    "dist_viable",
    "gather_solution",
    "allreduce_sum",
    "edge_exchange",
]

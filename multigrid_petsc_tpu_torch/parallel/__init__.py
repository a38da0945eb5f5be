"""Distribution over ``torch.distributed``: the row-partition and 2-D
blocks plans, the halo exchanges and reductions, the solution gather and
the sharded level's operators (PyTorch counterpart of
``multigrid_petsc_tpu/parallel``)."""

from multigrid_petsc_tpu_torch.parallel.block_ops import BlockLevelOps
from multigrid_petsc_tpu_torch.parallel.device_mesh import (
    ShardingPlan,
    blocks_plan,
    mesh_shape,
    row_plan,
)
from multigrid_petsc_tpu_torch.parallel.dist_ops import (
    DistLevelOps,
    DistMergedOps,
    dist_viable,
)
from multigrid_petsc_tpu_torch.parallel.gather import gather_solution
from multigrid_petsc_tpu_torch.parallel.halo import (
    allreduce_sum,
    block_exchange,
    edge_exchange,
)

__all__ = [
    "ShardingPlan",
    "row_plan",
    "blocks_plan",
    "mesh_shape",
    "BlockLevelOps",
    "block_exchange",
    "DistLevelOps",
    "DistMergedOps",
    "dist_viable",
    "gather_solution",
    "allreduce_sum",
    "edge_exchange",
]

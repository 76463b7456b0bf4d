"""Distribution over ``torch.distributed``: the ('row', 'block', 'scenario')
mesh and the sharded solve (counterpart of ``bsls_tpu/parallel``)."""
from .mesh import BLOCK_AXIS, ROW_AXIS, SCENARIO_AXIS, Mesh, init_distributed, make_mesh
from .sharding import shard_problem, shard_problem_2d, shard_problem_rows, solve_sharded

__all__ = [
    "BLOCK_AXIS",
    "ROW_AXIS",
    "SCENARIO_AXIS",
    "Mesh",
    "init_distributed",
    "make_mesh",
    "shard_problem",
    "shard_problem_2d",
    "shard_problem_rows",
    "solve_sharded",
]

from jaxvo.parallel.mesh import local_mesh, maybe_distributed_init
from jaxvo.parallel.match_sharded import sharded_match_descriptors
from jaxvo.parallel.ba_sharded import shard_ba_problem, sharded_ba_solve, sharded_ba_step
from jaxvo.parallel.posegraph_sharded import shard_edges, sharded_pgo_solve

__all__ = [
    "local_mesh",
    "maybe_distributed_init",
    "sharded_match_descriptors",
    "shard_ba_problem",
    "sharded_ba_solve",
    "sharded_ba_step",
    "shard_edges",
    "sharded_pgo_solve",
]

"""Several devices from one process (cuopt_tpu/parallel counterpart)."""

from cuopt_torch.parallel.sharding import (
    DCN_AXIS,
    ROW_AXIS,
    Mesh,
    ShardComm,
    gather_state,
    hierarchical_psum,
    make_mesh,
    make_mesh_2d,
    run_spmd,
    shard_problem_and_state,
)

__all__ = ["DCN_AXIS", "ROW_AXIS", "Mesh", "ShardComm", "gather_state",
           "hierarchical_psum", "make_mesh", "make_mesh_2d", "run_spmd",
           "shard_problem_and_state"]

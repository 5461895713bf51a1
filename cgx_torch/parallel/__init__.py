"""cgx_torch.parallel: the sharded route on ``torch.distributed``
(counterpart of ``cgx/parallel``): meshes of ranks, start-up, row-block
partitions, the sharded CG solver and its s-step, refinement, MG-PCG and
triple-word solves."""

from cgx_torch.parallel.mesh import ROWS_AXIS, Mesh, make_mesh
from cgx_torch.parallel.multihost import (
    global_mesh,
    initialize_from_env,
    is_multihost,
    process_local_rows,
)
from cgx_torch.parallel.partition import padded_size, partition
from cgx_torch.parallel.sharded_cg import (
    ShardedCGSolver,
    make_sharded_solver,
    sharded_block_cg_solve,
    sharded_block_deflated_cg_solve,
    sharded_cg_solve,
    sharded_cg_solve_batched,
    sharded_deflated_cg_solve,
    sharded_refine_fixed_sweeps,
)
from cgx_torch.parallel.mg_sharded import sharded_mg_block_cg_solve, sharded_mg_cg_solve
from cgx_torch.parallel.sstep_fused import fused_plane_geometry
from cgx_torch.parallel.tw_sharded import TWShardedResult, sharded_tw_solve

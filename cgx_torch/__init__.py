"""cgx_torch: the PyTorch and CUDA port of cgx, for an NVIDIA H100.

It sits beside ``cgx`` (the JAX package, which stays the reference) and
never imports it or JAX. Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``. The hand-written CUDA kernels build with
``nvcc`` on their first CUDA call, never at import (``cgx_torch._build``).
"""

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO, SolveConfig
from cgx_torch.mats.containers import (
    COOMatrix,
    CSRMatrix,
    DenseMatrix,
    DIAMatrix,
    ELLMatrix,
)
from cgx_torch.mats.generators import (
    lap2d_aniso,
    lap2d_fd,
    lap2d_reference,
    lap3d_fd,
    poisson2d_var,
    poisson3d_var,
    source_term,
)
from cgx_torch.mats.device import lap2d_operator, lap3d_operator, source_term_device
from cgx_torch.ops.cg_kernel import dia_cg_solve_vmem
from cgx_torch.ops.cg_stream import dia_cg_solve_stream, dia_cg_solve_stream_pcg
from cgx_torch.ops.dia_powers import dia_sstep_basis
from cgx_torch.ops.matvec import dense_matvec, dense_matvec_dot
from cgx_torch.ops.ozaki import OzakiDenseOperator, ozaki_matvec
from cgx_torch.ops.sstep_stream import dia_sstep_stream_solve
from cgx_torch.parallel import (
    ShardedCGSolver,
    make_mesh,
    make_mesh2d,
    make_sharded_solver,
    sharded_block_cg_solve,
    sharded_block_deflated_cg_solve,
    sharded_cg_solve,
    sharded_cg_solve_batched,
    sharded_cg_solve_harvest,
    sharded_deflated_cg_solve,
    sharded_mg_block_cg_solve,
)
from cgx_torch.solver.api import solve, solve_sequence
from cgx_torch.solver.autodiff import block_cg_solve_differentiable, cg_solve_differentiable
from cgx_torch.solver.batched import cg_solve_batched
from cgx_torch.solver.blockcg import BlockCGResult, block_cg_solve, block_deflated_cg_solve
from cgx_torch.solver.cg import CGResult, cg_solve
from cgx_torch.solver.chebyshev import chebyshev_solve
from cgx_torch.solver.deflated import (
    DeflationBasis,
    cg_solve_harvest,
    deflated_cg_solve,
    lanczos_ritz,
)
from cgx_torch.solver.gvpipe import gv_cg_solve
from cgx_torch.solver.fast import dia_cg_solve_pallas
from cgx_torch.solver.multigrid import MGPreconditioner, mg_preconditioner
from cgx_torch.solver.pipelined import pipelined_cg_solve
from cgx_torch.solver.operators import (
    CsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    GridDiaOperator,
    PallasDenseOperator,
    as_operator,
    basis_from_cgx,
    densify_on_device,
    operator_from_cgx,
    operator_from_numpy,
)
from cgx_torch.solver.precond import block_jacobi, jacobi, neumann_banded
from cgx_torch.solver.refine import (
    DDRefineResult,
    RefineResult,
    TWRefineResult,
    iterative_refinement,
    refine_fixed_sweeps,
    refine_pcg_sweeps,
    refine_pcg_sweeps_dd,
    refine_pcg_sweeps_tw,
)
from cgx_torch.solver.sstep import sstep_cg_solve
from cgx_torch.utils.checkpoint import (
    CGCheckpoint,
    cg_solve_resumable,
    sharded_cg_solve_resumable,
)
from cgx_torch.utils.records import SolveRecord
from cgx_torch.utils.timer import PhaseTimer, trace

__version__ = "0.1.0"

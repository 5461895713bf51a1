"""cgx_torch.utils: checkpoint and resume, solve records, the phase timer
and profiler hook, and the collectives of the sharded route (counterpart
of ``cgx/utils``)."""

from cgx_torch.utils.checkpoint import (
    CGCheckpoint,
    cg_solve_resumable,
    sharded_cg_solve_resumable,
)
from cgx_torch.utils.records import SolveRecord
from cgx_torch.utils.timer import PhaseTimer, trace

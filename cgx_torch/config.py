"""Configuration and reference-parity constants (counterpart of
``cgx/config.py``).

- ``NEARZERO`` guards the alpha denominator: ``alpha = rsold /
  max(conj, rsold * NEARZERO)`` (reference MPI cg.cc:8, CUDA cg.cu:11).
- ``DEFAULT_TOLERANCE`` is the *absolute* residual-norm tolerance
  ``sqrt(<r, r>) < tol`` (reference cg.hh:56 MPI / cg.hh:40 CUDA).
- ``maxiter`` defaults to the problem size N.

:class:`SolveConfig` keeps every field and default of cgx's, so a cgx
configuration reads the same here. ``cgx_torch.solve`` raises
``NotImplementedError`` for the values whose path is not ported yet,
naming the ROADMAP item; the field comments say which.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

NEARZERO: float = 1.0e-14
DEFAULT_TOLERANCE: float = 1.0e-10
# The port's counterpart of cgx's VMEM_BUDGET_BYTES (a TPU number, not
# copied): banded fp32 use_pallas solves, and the fp32 inner solves of
# precision="mixed", run the whole-solve kernel (cgx_torch.ops.cg_kernel)
# while cgx_torch.ops.cg_kernel.resident_state_bytes is at most this, and
# the streaming kernels (cgx_torch.ops.cg_stream) above it. Set by
# chip_smoke.py's crossover sweep on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit (5 bands, fp32, us an iteration): the whole-solve kernel beat
# the streaming kernel with bf16 bands at N = 250,000 and 1e6 (16.9 against
# 24.2, 40.8 against 43.3) and lost at 1,999,396 and 4e6 (95.4 against 77.9,
# 196.2 against 129.8), so the budget is the largest state at which it still
# won, that of N = 1,000,000 with the preconditioner (whose state is the
# larger). With the Neumann preconditioner the whole-solve kernel also won
# above it, against the streaming PCG as it then stood (PERF.md).
RESIDENT_BUDGET_BYTES: int = 40_024_640


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Configuration of a CG solve (field for field as in cgx)."""

    tolerance: float = DEFAULT_TOLERANCE
    maxiter: Optional[int] = None  # None -> problem size N
    nearzero: float = NEARZERO
    # Residual-history trace length (0 disables the trace buffer).
    history: int = 0
    # "fp64", "fp32" (dots accumulate in fp64), "mixed" (fp64
    # refinement sweeps around fp32 inner solves; tolerance relative to
    # ||b||) or "tw" (triple-word float32 sweeps around an fp32 MG-PCG
    # inner; tolerance relative to ||b||, judged on the tw-evaluated true
    # residual). "bf16" (ROADMAP A6) is not ported yet.
    precision: str = "fp64"
    # Banded fp32 problems run the whole-solve kernel within
    # RESIDENT_BUDGET_BYTES, and above it the path large_banded names
    # (see cgx_torch.solver.api.solve).
    use_pallas: bool = False
    # Above the budget: "stream" (the streaming kernels B4, or B6 with
    # precond="neumann") or "xla" (the plain loop, with the configured
    # preconditioner).
    large_banded: str = "stream"
    # "reference", "pipelined" (Chronopoulos-Gear) or "sstep" (s-step CG,
    # with the sstep_* fields below); "gvpipe" and "chebyshev" (A11) are
    # not ported yet. Of the fields below, check_every, multi_rhs and
    # gv_replace_every select no ported path yet; they keep cgx's
    # defaults so that a cgx configuration reads the same.
    method: str = "reference"
    # None, "jacobi", "neumann" (with use_pallas: the whole-solve
    # kernel's in-kernel Neumann PCG), "block_jacobi" (blocks of
    # precond_block_size rows), "chebyshev" (degree 3) or "mg" (a V-cycle
    # with mg_smoother, in mg_cycle_precision).
    precond: Optional[str] = None
    precond_block_size: Optional[int] = None
    mg_smoother: str = "richardson"
    mg_cycle_precision: str = "fp64"
    check_every: int = 32
    sstep_s: int = 4
    sstep_basis: str = "chebyshev"
    # Dense fp64 operators: "auto" and "emulated" keep the fp64 product
    # (the H100's fp64 is native, so cgx's "auto" = Ozaki on an
    # accelerator does not carry over), "ozaki" runs the int8 slices.
    dense_fp64: str = "auto"
    local_kernel: str = "auto"
    sstep_replace_every: Optional[int] = None
    multi_rhs: str = "block"
    gv_replace_every: int = 25
    sstep_powers: str = "auto"
    sstep_fallback: str = "auto"

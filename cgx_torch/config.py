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


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Configuration of a CG solve (field for field as in cgx)."""

    tolerance: float = DEFAULT_TOLERANCE
    maxiter: Optional[int] = None  # None -> problem size N
    nearzero: float = NEARZERO
    # Residual-history trace length (0 disables the trace buffer).
    history: int = 0
    # "fp64" or "fp32" (dots accumulate in fp64). "bf16", "mixed"
    # (ROADMAP A9) and "tw" (A12) are not ported yet.
    precision: str = "fp64"
    # Banded fp32 problems run the three-kernel loop of
    # cgx_torch.solver.fast (see cgx_torch.solver.api.solve).
    use_pallas: bool = False
    # The fields below select paths that are not ported yet; they keep
    # cgx's defaults so that a cgx configuration reads the same.
    large_banded: str = "stream"  # B4 / B6
    method: str = "reference"  # others: A7, A11
    precond: Optional[str] = None  # A7, A10; B5/B6 with use_pallas
    precond_block_size: Optional[int] = None
    mg_smoother: str = "richardson"
    mg_cycle_precision: str = "fp64"
    check_every: int = 32
    sstep_s: int = 4
    sstep_basis: str = "chebyshev"
    dense_fp64: str = "auto"
    local_kernel: str = "auto"
    sstep_replace_every: Optional[int] = None
    multi_rhs: str = "block"
    gv_replace_every: int = 25
    sstep_powers: str = "auto"
    sstep_fallback: str = "auto"

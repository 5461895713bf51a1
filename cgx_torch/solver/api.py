"""High-level solve entry point (counterpart of ``cgx.solve``, for one
device and one right-hand side).

    import cgx_torch
    res = cgx_torch.solve(matrix, b)                       # fp64 reference CG
    res = cgx_torch.solve(matrix, b, cgx_torch.SolveConfig(
        precision="fp32", use_pallas=True))                # three-kernel loop

Dispatch:
- host containers, ndarrays and 2-D tensors become their natural
  operator (:func:`cgx_torch.solver.operators.as_operator`);
- ``use_pallas`` + banded + fp32 + no x0 runs the three-kernel loop
  (:func:`cgx_torch.solver.fast.dia_cg_solve_pallas`);
- everything else that is ported runs the plain reference loop;
- what is not ported yet raises ``NotImplementedError`` naming its
  ROADMAP item, rather than running some other path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cgx_torch.config import SolveConfig
from cgx_torch.ops._util import resolve_device
from cgx_torch.solver.cg import CGResult, as_vector, cg_solve
from cgx_torch.solver.fast import dia_cg_solve_pallas
from cgx_torch.solver.operators import DiaOperator, as_operator

_DTYPES = {"fp64": torch.float64, "fp32": torch.float32}
_UNPORTED_PRECISION = {
    "bf16": "bf16 storage (ROADMAP A6, with B4)",
    "mixed": "mixed-precision refinement (ROADMAP A9)",
    "tw": "triple-word refinement (ROADMAP A12)",
}


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported to cgx_torch yet")


def solve(
    mat,
    b,
    config: Optional[SolveConfig] = None,
    *,
    n_devices: Optional[int] = None,
    mesh=None,
    method: Optional[str] = None,
    x0=None,
    device="cuda",
) -> CGResult:
    """Solve ``A x = b`` on one device with the configuration's path.

    ``mat`` is a host container (``DIAMatrix``, ``DenseMatrix``,
    ``ELLMatrix``, ``CSRMatrix``, ``COOMatrix``), a scipy.sparse matrix,
    an ndarray, a 2-D tensor or a port operator; tensors must already be
    on ``device``."""
    cfg = config or SolveConfig()
    method = cfg.method if method is None else method
    dev = resolve_device(device)
    if (n_devices is not None and n_devices > 1) or mesh is not None:
        raise _unported("sharded solves (n_devices / mesh, ROADMAP A14)")
    if np.ndim(b) == 2:
        raise _unported("multi-RHS solves of a 2-D b (ROADMAP A11)")
    if cfg.precision in _UNPORTED_PRECISION:
        raise _unported(f"precision={cfg.precision!r}: {_UNPORTED_PRECISION[cfg.precision]}")
    if cfg.precision not in _DTYPES:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    if method != "reference":
        raise _unported(f"method={method!r} (ROADMAP A7, A11)")
    if cfg.precond is not None:
        item = "B5/B6" if cfg.use_pallas and cfg.precond == "neumann" else "A7/A10"
        raise _unported(f"precond={cfg.precond!r} (ROADMAP {item})")
    dtype = _DTYPES[cfg.precision]

    op = mat if hasattr(mat, "matvec") else as_operator(mat, dtype=dtype, device=dev)
    b_dev = as_vector(b, dev, "b", dtype)
    maxiter = b_dev.shape[0] if cfg.maxiter is None else cfg.maxiter

    if cfg.use_pallas and isinstance(op, DiaOperator) and cfg.precision != "fp64" and x0 is None:
        # cgx routes here by on-chip budget to the whole-solve kernel
        # (B5) or the streaming kernel (B4), api.py:329-381. Until those
        # kernels are ported, every banded fp32 use_pallas solve runs the
        # three-kernel loop; the budget routing arrives with them.
        return dia_cg_solve_pallas(
            op, b_dev, tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero,
            history=cfg.history, device=dev,
        )
    return cg_solve(
        op, b_dev, x0,
        tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero, history=cfg.history,
        # fp32 vectors with fp64 dots, as cgx does whenever x64 is on
        dot_precision=torch.float64 if dtype != torch.float64 else None,
        device=dev,
    )

"""High-level solve entry point (counterpart of ``cgx.solve``, for one
device and one right-hand side).

    import cgx_torch
    res = cgx_torch.solve(matrix, b)                       # fp64 reference CG
    res = cgx_torch.solve(matrix, b, cgx_torch.SolveConfig(
        precision="fp32", use_pallas=True))                # B5, or B4 above the budget
    res = cgx_torch.solve(matrix, b, cgx_torch.SolveConfig(
        precision="mixed"))                                # fp64 refinement sweeps

Dispatch (cgx api.py:322-403):
- host containers, ndarrays and 2-D tensors become their natural
  operator (:func:`cgx_torch.solver.operators.as_operator`);
- ``use_pallas`` + banded + fp32 + ``precond in (None, "neumann")`` + no
  x0 runs the whole-solve kernel (:func:`cgx_torch.ops.cg_kernel.
  dia_cg_solve_vmem`, ``layout="2d"``) while its state fits
  :data:`cgx_torch.config.RESIDENT_BUDGET_BYTES`. Above it
  ``cfg.large_banded`` decides: ``"stream"`` (the default) runs the
  streaming kernels of :mod:`cgx_torch.ops.cg_stream`, B4 with
  ``bands_dtype="auto"`` without a preconditioner and B6 with
  ``"neumann"``; ``"xla"`` runs the plain loop below, with the
  configured preconditioner; any other value raises ``ValueError``.
  cgx's fallback when a TPU compile service refuses the kernel is not
  ported: a failed launch raises;
- ``method="pipelined"`` runs :func:`cgx_torch.solver.pipelined.
  pipelined_cg_solve`, with float64 dots for fp32;
- ``precision="mixed"`` runs fp64 refinement around fp32 inner solves
  (:mod:`cgx_torch.solver.refine`);
- everything else that is ported runs the plain reference loop, with
  the configured preconditioner;
- what is not ported yet raises ``NotImplementedError`` naming its
  ROADMAP item, rather than running some other path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cgx_torch import config as settings
from cgx_torch.config import SolveConfig
from cgx_torch.mats.containers import DIAMatrix
from cgx_torch.ops._util import resolve_device
from cgx_torch.ops.cg_kernel import dia_cg_solve_vmem, resident_state_bytes
from cgx_torch.ops.cg_stream import dia_cg_solve_stream, dia_cg_solve_stream_pcg
from cgx_torch.solver.cg import CGResult, as_vector, cg_solve
from cgx_torch.solver.operators import DiaOperator, as_operator
from cgx_torch.solver.pipelined import pipelined_cg_solve
from cgx_torch.solver.precond import jacobi, neumann_banded
from cgx_torch.solver.refine import iterative_refinement, refine_fixed_sweeps

_DTYPES = {"fp64": torch.float64, "fp32": torch.float32}
_UNPORTED_PRECISION = {
    "bf16": "bf16 vectors (ROADMAP A6)",
    "tw": "triple-word refinement (ROADMAP A12)",
}
_UNPORTED_PRECOND = {
    "block_jacobi": "A7",
    "chebyshev": "A7",
    "mg": "A10",
}


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported to cgx_torch yet")


def _build_precond(cfg: SolveConfig, op):
    """The configured preconditioner's ``apply`` (cgx api.py:39-79)."""
    if cfg.precond is None:
        return None
    if cfg.precond == "jacobi":
        return jacobi(op.diagonal())
    if cfg.precond == "neumann":
        if not isinstance(op, DiaOperator):
            raise ValueError("precond='neumann' needs a banded operator")
        return neumann_banded(op.bands, op.offsets, sweeps=2)
    if cfg.precond in _UNPORTED_PRECOND:
        raise _unported(f"precond={cfg.precond!r} (ROADMAP {_UNPORTED_PRECOND[cfg.precond]})")
    raise ValueError(f"unknown precond {cfg.precond!r}")


def _solve_mixed(mat, b, cfg: SolveConfig, method: str, dev: torch.device) -> CGResult:
    """precision="mixed" (cgx api.py:406-468): fp32 inner solves and fp64
    refinement sweeps on a banded operator. ``cfg.tolerance`` is relative
    to ||b|| here, and ``cfg.maxiter`` caps each inner solve."""
    if method != "reference" or cfg.precond is not None:
        raise ValueError(
            "precision='mixed' runs the reference recurrence without an outer preconditioner "
            "(the fp32 inner solve is the acceleration)")
    if isinstance(mat, DIAMatrix):
        op64 = as_operator(mat, torch.float64, device=dev)
    elif isinstance(mat, DiaOperator):
        op64 = DiaOperator(mat.bands.to(torch.float64), tuple(mat.offsets))
    else:
        raise TypeError(f"precision='mixed' needs a banded operator, got {type(mat)}")
    b64 = as_vector(b, dev, "b", torch.float64)
    n, ndiag = b64.shape[0], op64.bands.shape[0]
    if resident_state_bytes(ndiag, n, 4, 4, precond=True) <= settings.RESIDENT_BUDGET_BYTES:
        res = refine_fixed_sweeps(op64, b64, rtol=cfg.tolerance, inner_maxiter=cfg.maxiter,
                                  layout="2d", device=dev)
    else:
        res = iterative_refinement(op64, b64, tol=0.0, rtol=cfg.tolerance,
                                   inner_maxiter=cfg.maxiter, use_pallas=dev.type == "cuda",
                                   device=dev)
    return CGResult(
        x=res.x,
        iterations=torch.tensor(res.outer_iterations, dtype=torch.int32, device=dev),
        residual_norm=res.residual_norm,
        converged=res.converged,
        rsold=res.residual_norm ** 2,
        history=torch.zeros((0,), dtype=torch.float64, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
    )


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
    if x0 is not None and cfg.precision == "mixed":
        raise ValueError("precision='mixed' manages its own inner starts; x0 is not supported")
    if np.ndim(b) == 2:
        raise _unported("multi-RHS solves of a 2-D b (ROADMAP A11)")
    if cfg.precision == "mixed":
        return _solve_mixed(mat, b, cfg, method, dev)
    if cfg.precision in _UNPORTED_PRECISION:
        raise _unported(f"precision={cfg.precision!r}: {_UNPORTED_PRECISION[cfg.precision]}")
    if cfg.precision not in _DTYPES:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    if method not in ("reference", "pipelined"):
        raise _unported(f"method={method!r} (ROADMAP A7, A11)")
    dtype = _DTYPES[cfg.precision]
    # fp32 vectors with fp64 dots, as cgx does whenever x64 is on
    dot_precision = torch.float64 if dtype != torch.float64 else None

    op = mat if hasattr(mat, "matvec") else as_operator(mat, dtype=dtype, device=dev)
    b_dev = as_vector(b, dev, "b", dtype)
    n = b_dev.shape[0]
    maxiter = n if cfg.maxiter is None else cfg.maxiter
    if method == "pipelined":  # cgx api.py:302-309
        return pipelined_cg_solve(
            op, b_dev, x0, tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero,
            history=cfg.history, dot_precision=dot_precision,
            precond=_build_precond(cfg, op), device=dev,
        )

    if (cfg.use_pallas and isinstance(op, DiaOperator) and cfg.precision != "fp64"
            and cfg.precond in (None, "neumann") and x0 is None):  # the kernels start from 0
        neumann = cfg.precond == "neumann"
        state = resident_state_bytes(op.bands.shape[0], n, op.bands.element_size(),
                                     b_dev.element_size(), precond=neumann)
        if state <= settings.RESIDENT_BUDGET_BYTES:
            # whole-solve kernel; its in-kernel PCG is neumann_banded(sweeps=2)
            return dia_cg_solve_vmem(
                op, b_dev, tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero,
                precond=neumann, layout="2d", device=dev,
            )
        # above the budget (cgx api.py:365-391)
        common = dict(tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero, device=dev)
        if cfg.large_banded == "stream" and not neumann:
            # bf16 band planes when, and only when, the round trip is exact
            return dia_cg_solve_stream(op, b_dev, bands_dtype="auto", **common)
        if cfg.large_banded == "stream":
            # the kernel's in-launch PCG is neumann_banded(sweeps=2)
            return dia_cg_solve_stream_pcg(op, b_dev, **common)
        if cfg.large_banded != "xla":
            raise ValueError(f"unknown large_banded {cfg.large_banded!r}")
    return cg_solve(
        op, b_dev, x0,
        tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero, history=cfg.history,
        dot_precision=dot_precision,
        precond=_build_precond(cfg, op),
        device=dev,
    )

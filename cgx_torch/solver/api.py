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
- ``method="sstep"`` runs :func:`cgx_torch.solver.sstep.sstep_cg_solve`
  with the configuration's ``sstep_*`` fields; ``sstep_powers="auto"``
  resolves by :func:`_single_powers` (cgx api.py:104-137): the fused
  kernels B10 for a banded non-fp64 operator on the card with
  ``sstep_s <= 6``, else the plain basis;
- ``precision="mixed"`` runs fp64 refinement around fp32 inner solves
  (:mod:`cgx_torch.solver.refine`);
- ``n_devices > 1`` or ``mesh=`` runs the sharded route on
  ``torch.distributed`` (:mod:`cgx_torch.parallel.sharded_cg`), with
  ``strategy``; there ``precond="mg"``, ``precision="mixed"`` and
  ``method="sstep"`` (A14) raise, and so do ``"block_jacobi"`` and
  ``"chebyshev"`` (the sharded part of A7);
- everything else that is ported runs the plain reference loop, with
  the configured preconditioner: ``jacobi``, ``neumann``,
  ``block_jacobi`` (``precond_block_size``, default min(32, N)),
  ``chebyshev`` (degree 3 on Lanczos bounds) or ``mg`` (a V-cycle, with
  ``mg_smoother`` and ``mg_cycle_precision``);
- what is not ported yet raises ``NotImplementedError`` naming its
  ROADMAP item, rather than running some other path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cgx_torch import config as settings
from cgx_torch.config import SolveConfig
from cgx_torch.mats.containers import COOMatrix, CSRMatrix, DenseMatrix, DIAMatrix, ELLMatrix
from cgx_torch.ops._util import resolve_device
from cgx_torch.ops.cg_kernel import dia_cg_solve_vmem, resident_state_bytes
from cgx_torch.ops.cg_stream import dia_cg_solve_stream, dia_cg_solve_stream_pcg
from cgx_torch.solver.cg import CGResult, as_vector, cg_solve
from cgx_torch.solver.chebyshev import spectral_bounds
from cgx_torch.solver.multigrid import infer_grid_ndim, mg_preconditioner
from cgx_torch.solver.operators import DiaOperator, as_operator
from cgx_torch.solver.pipelined import pipelined_cg_solve
from cgx_torch.solver.precond import block_jacobi, chebyshev_poly, jacobi, neumann_banded
from cgx_torch.solver.refine import iterative_refinement, refine_fixed_sweeps
from cgx_torch.solver.sstep import sstep_cg_solve

_DTYPES = {"fp64": torch.float64, "fp32": torch.float32}
_UNPORTED_PRECISION = {
    "bf16": "bf16 vectors (ROADMAP A6)",
    "tw": "triple-word refinement (ROADMAP A12)",
}


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported to cgx_torch yet")


def _build_precond(cfg: SolveConfig, op):
    """The configured preconditioner's ``apply`` (cgx api.py:39-79).
    ``"mg"`` builds a V-cycle on the operator's grid (2-D or 3-D by
    :func:`infer_grid_ndim`); ``mg_cycle_precision="fp32"`` under an fp64
    operator runs the cycle in fp32 (``apply_mixed``)."""
    if cfg.precond is None:
        return None
    n = op.shape[0]
    if cfg.precond == "jacobi":
        return jacobi(op.diagonal())
    if cfg.precond == "block_jacobi":
        return block_jacobi(op, cfg.precond_block_size or min(32, n), dtype=op.dtype)
    if cfg.precond == "neumann":
        if not isinstance(op, DiaOperator):
            raise ValueError("precond='neumann' needs a banded operator")
        return neumann_banded(op.bands, op.offsets, sweeps=2)
    if cfg.precond == "chebyshev":
        lo, hi = spectral_bounds(op, n)
        return chebyshev_poly(op.matvec, lo, hi, degree=3)
    if cfg.precond == "mg":
        if not isinstance(op, DiaOperator):
            raise ValueError("precond='mg' needs a banded grid operator")
        nd = infer_grid_ndim(n, op.offsets)
        if cfg.mg_cycle_precision == "fp32" and op.dtype == torch.float64:
            return mg_preconditioner(op, ndim=nd, smoother=cfg.mg_smoother,
                                     dtype=torch.float32).apply_mixed
        return mg_preconditioner(op, ndim=nd, smoother=cfg.mg_smoother).apply
    raise ValueError(f"unknown precond {cfg.precond!r}")


def _single_powers(cfg: SolveConfig, op) -> str:
    """The single-device ``powers`` mode of an s-step solve (cgx
    ``_single_powers``): "auto" is "fused" for a banded operator of
    float32 on CUDA with ``sstep_s <= 6`` (cgx: on an accelerator; the
    fp32 basis-conditioning cap), else "off"."""
    if cfg.sstep_powers == "auto":
        if (isinstance(op, DiaOperator) and op.dtype != torch.float64 and int(cfg.sstep_s) <= 6
                and op.bands.device.type == "cuda"):
            return "fused"
        return "off"
    if cfg.sstep_powers in ("off", "pallas", "interpret", "fused"):
        return cfg.sstep_powers
    if cfg.sstep_powers == "deephalo":
        raise ValueError("sstep_powers='deephalo' is a sharded mode (needs a device mesh); use "
                         "sstep_powers='pallas' single-device")
    raise ValueError(f"unknown sstep_powers {cfg.sstep_powers!r}")


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


def _host_matrix(mat):
    """The host form of ``mat`` for the sharded route, which cuts its
    own row blocks (cgx's ``_to_host``): containers and ndarrays as they
    are, a port operator or a 2-D tensor read back from its device."""
    if isinstance(mat, (DIAMatrix, DenseMatrix, ELLMatrix, CSRMatrix, COOMatrix, np.ndarray)):
        return mat
    if isinstance(mat, DiaOperator):
        bands = mat.bands.cpu().numpy()
        return DIAMatrix((bands.shape[1],) * 2, tuple(mat.offsets), bands)
    if isinstance(mat, torch.Tensor):
        return mat.cpu().numpy()
    if hasattr(mat, "a"):  # DenseOperator, PallasDenseOperator
        return mat.a.cpu().numpy()
    if hasattr(mat, "tocoo") and hasattr(mat, "shape"):  # scipy.sparse
        return COOMatrix.from_scipy(mat)
    raise TypeError(f"the sharded route takes a host matrix or a banded or dense operator, "
                    f"not {type(mat)}")


def _solve_sharded(mat, b, cfg: SolveConfig, method: str, dev: torch.device, *, n_devices,
                   mesh, strategy: str, x0) -> CGResult:
    """The sharded route (cgx api.py:210-270):
    :func:`cgx_torch.parallel.sharded_cg.sharded_cg_solve` with the
    configuration's method, preconditioner, tolerance, history and
    maxiter, fp32 with float64 dots. Run it on every rank of the mesh,
    with the same arguments."""
    from cgx_torch.parallel.sharded_cg import sharded_cg_solve

    if cfg.precond == "mg":
        raise _unported("precond='mg' on the sharded route (mg_sharded, ROADMAP A14)")
    if cfg.precision == "mixed":
        raise _unported("precision='mixed' on the sharded route (sharded_refine_fixed_sweeps, "
                        "ROADMAP A14)")
    if cfg.precision in _UNPORTED_PRECISION:
        raise _unported(f"precision={cfg.precision!r}: {_UNPORTED_PRECISION[cfg.precision]}")
    if cfg.precision not in _DTYPES:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    b_np = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b))
    if b_np.ndim == 2:
        raise _unported("multi-RHS solves of a 2-D b (ROADMAP A11)")
    b_np = b_np.astype(np.float64 if cfg.precision == "fp64" else np.float32)
    if x0 is not None:
        x0 = x0.detach().cpu().numpy() if isinstance(x0, torch.Tensor) else np.asarray(x0)
    return sharded_cg_solve(
        _host_matrix(mat), b_np, x0=x0, mesh=mesh, n_devices=n_devices, strategy=strategy,
        method=method, precond=cfg.precond,
        tol=cfg.tolerance, maxiter=b_np.shape[0] if cfg.maxiter is None else cfg.maxiter,
        nearzero=cfg.nearzero, history=cfg.history,
        dot_precision=None if cfg.precision == "fp64" else torch.float64,
        dense_fp64=cfg.dense_fp64, local_kernel=cfg.local_kernel, device=dev,
    )


def solve(
    mat,
    b,
    config: Optional[SolveConfig] = None,
    *,
    n_devices: Optional[int] = None,
    mesh=None,
    strategy: str = "auto",
    method: Optional[str] = None,
    x0=None,
    device="cuda",
) -> CGResult:
    """Solve ``A x = b`` with the configuration's path.

    ``mat`` is a host container (``DIAMatrix``, ``DenseMatrix``,
    ``ELLMatrix``, ``CSRMatrix``, ``COOMatrix``), a scipy.sparse matrix,
    an ndarray, a 2-D tensor or a port operator; tensors must already be
    on ``device``. ``n_devices > 1`` or a ``mesh`` takes the sharded
    route (:func:`_solve_sharded`), on every rank of the mesh."""
    cfg = config or SolveConfig()
    method = cfg.method if method is None else method
    dev = resolve_device(device)
    if (n_devices is not None and n_devices > 1) or mesh is not None:
        return _solve_sharded(mat, b, cfg, method, dev, n_devices=n_devices, mesh=mesh,
                              strategy=strategy, x0=x0)
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
    if method in ("gvpipe", "chebyshev"):
        raise _unported(f"method={method!r} (ROADMAP A11)")
    if method not in ("reference", "pipelined", "sstep"):
        raise ValueError(f"unknown method {method!r}")
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

    if method == "sstep":  # cgx api.py:289-301
        if cfg.precond is not None:
            raise ValueError("sstep_cg_solve does not take a preconditioner")
        return sstep_cg_solve(
            op, b_dev, x0, tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero,
            s=cfg.sstep_s, basis=cfg.sstep_basis, replace_every=cfg.sstep_replace_every,
            powers=_single_powers(cfg, op), fallback=cfg.sstep_fallback, device=dev,
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

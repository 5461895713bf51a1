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
- ``use_pallas`` + banded + fp32 or bf16 + ``precond in (None, "neumann")`` + no
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
- ``method="gvpipe"`` runs :func:`cgx_torch.solver.gvpipe.gv_cg_solve`
  with ``gv_replace_every`` and the configured preconditioner, float64
  dots for fp32; ``method="chebyshev"`` runs
  :func:`cgx_torch.solver.chebyshev.chebyshev_solve` with
  ``check_every`` and no preconditioner (``ValueError``), its default
  maxiter 4N;
- ``method="sstep"`` runs :func:`cgx_torch.solver.sstep.sstep_cg_solve`
  with the configuration's ``sstep_*`` fields; ``sstep_powers="auto"``
  resolves by :func:`_single_powers` (cgx api.py:104-137): the fused
  kernels B10 for a banded non-fp64 operator on the card with
  ``sstep_s <= 6``, else the plain basis;
- ``precision="mixed"`` runs fp64 refinement around fp32 inner solves
  (:mod:`cgx_torch.solver.refine`);
- ``precision="tw"`` runs triple-word float32 refinement sweeps around an
  fp32 MG-PCG inner (:func:`_solve_tw`);
- a dense fp64 operator runs as ``cfg.dense_fp64`` says
  (:func:`_maybe_ozaki`): the fp64 product, or the Ozaki int8 slices;
- ``n_devices > 1`` or ``mesh=`` runs the sharded route on
  ``torch.distributed`` (:mod:`cgx_torch.parallel.sharded_cg`), with
  ``strategy``: every method (``method="sstep"`` with
  :func:`_sharded_powers`), ``precond="mg"`` (:mod:`cgx_torch.parallel.
  mg_sharded`), ``precision="mixed"`` (``sharded_refine_fixed_sweeps``)
  and ``precision="tw"`` (:mod:`cgx_torch.parallel.tw_sharded`);
- a 2-D ``b`` of shape (n, s) solves every column: ``multi_rhs="block"``
  (the default) in one breakdown-free block-CG Krylov space with the
  configured preconditioner (:func:`_solve_block`), ``"batched"`` by
  independent reference recurrences (:func:`_solve_batched_rhs`); an
  ``x0`` of the same shape warm-starts by the shift identity;
  :func:`solve_sequence` solves a sequence with spectral recycling. On a
  mesh they run :mod:`cgx_torch.parallel`'s block, block MG, 2-D batched,
  harvest and deflated solves;
- everything else that is ported runs the plain reference loop, with
  the configured preconditioner: ``jacobi``, ``neumann``,
  ``block_jacobi`` (``precond_block_size``, default min(32, N)),
  ``chebyshev`` (degree 3 on Lanczos bounds) or ``mg`` (a V-cycle, with
  ``mg_smoother`` and ``mg_cycle_precision``);
- ``precision="bf16"`` keeps the vectors in bfloat16 with float64 dots
  on one device (the kernel routes on their bfloat16 builds, the fused
  s-step among them); on a mesh it solves b in float32, as cgx does;
  multi-RHS solves and the s-step's ``"off"`` and ``"pallas"`` routes
  refuse it, as cgx's do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cgx_torch import config as settings
from cgx_torch.config import SolveConfig
from cgx_torch.mats.containers import COOMatrix, CSRMatrix, DenseMatrix, DIAMatrix, ELLMatrix
from cgx_torch.ops._util import resolve_device
from cgx_torch.ops.ozaki import OzakiDenseOperator
from cgx_torch.ops.cg_kernel import dia_cg_solve_vmem, resident_state_bytes
from cgx_torch.ops.cg_stream import dia_cg_solve_stream, dia_cg_solve_stream_pcg
from cgx_torch.solver.batched import cg_solve_batched
from cgx_torch.solver.blockcg import BlockCGResult, block_cg_solve, block_matvec
from cgx_torch.solver.cg import CGResult, as_vector, cg_solve
from cgx_torch.solver.chebyshev import chebyshev_solve, spectral_bounds
from cgx_torch.solver.deflated import DeflationBasis, cg_solve_harvest, deflated_cg_solve
from cgx_torch.solver.gvpipe import gv_cg_solve
from cgx_torch.solver.multigrid import infer_grid_ndim, mg_preconditioner
from cgx_torch.solver.operators import DenseOperator, DiaOperator, as_operator
from cgx_torch.solver.pipelined import pipelined_cg_solve
from cgx_torch.solver.precond import block_jacobi, chebyshev_poly, jacobi, neumann_banded
from cgx_torch.solver.refine import iterative_refinement, refine_fixed_sweeps, refine_pcg_sweeps_tw
from cgx_torch.solver.sstep import sstep_cg_solve

_DTYPES = {"fp64": torch.float64, "fp32": torch.float32, "bf16": torch.bfloat16}
_MULTI_RHS_PRECISIONS = ("fp64", "fp32")


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
    float32 or bfloat16 on CUDA with ``sstep_s <= 6`` (cgx: on an
    accelerator; the fp32 basis-conditioning cap), else "off"."""
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


def _solve_mixed(mat, b, cfg: SolveConfig, method: str, dev: torch.device, *,
                 sharded: bool = False, n_devices=None, mesh=None,
                 strategy: str = "auto") -> CGResult:
    """precision="mixed" (cgx api.py:406-468): fp32 inner solves and fp64
    refinement sweeps on a banded operator. ``cfg.tolerance`` is relative
    to ||b|| here, and ``cfg.maxiter`` caps each inner solve (cgx's
    sharded branch keeps its own cap, N). On a mesh
    :func:`cgx_torch.parallel.sharded_cg.sharded_refine_fixed_sweeps`;
    its ``history`` holds each sweep's inner count."""
    if method != "reference" or cfg.precond is not None:
        raise ValueError(
            "precision='mixed' runs the reference recurrence without an outer preconditioner "
            "(the fp32 inner solve is the acceleration)")
    if sharded:  # cgx api.py:428-434
        from cgx_torch.parallel.sharded_cg import sharded_refine_fixed_sweeps

        host = _host_matrix(mat)
        if not isinstance(host, DIAMatrix):
            raise ValueError("precision='mixed' needs a banded operator")
        b_np = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        return sharded_refine_fixed_sweeps(host, b_np.astype(np.float64), mesh=mesh,
                                           n_devices=n_devices, strategy=strategy,
                                           rtol=cfg.tolerance, device=dev)
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


def _solve_tw(mat, b, cfg: SolveConfig, method: str, dev: torch.device, *,
              sharded: bool, n_devices=None, mesh=None) -> CGResult:
    """precision="tw" (cgx api.py:471-561): triple-word float32 refinement
    sweeps (:func:`cgx_torch.solver.refine.refine_pcg_sweeps_tw`) around an
    fp32 inner: MG-PCG (an fp32 V-cycle) where the banded operator decodes
    on a grid, else, with ``precond=None``, plain fp32 CG. ``cfg.tolerance``
    is relative to ||b||, judged on the tw-evaluated true residual;
    ``cfg.maxiter`` caps each inner solve (80 with MG, else N). On a mesh
    :func:`cgx_torch.parallel.tw_sharded.sharded_tw_solve` runs the same
    sweeps over the sharded MG-PCG (or halo CG) inner."""
    if method != "reference":
        raise ValueError("precision='tw' runs the reference recurrence")
    if cfg.precond not in (None, "mg"):
        raise ValueError(f"precision='tw' supports precond=None or 'mg' (got {cfg.precond!r})")
    if sharded:  # cgx api.py:497-521
        from cgx_torch.parallel.tw_sharded import sharded_tw_solve

        host = _host_matrix(mat)
        if isinstance(host, COOMatrix):
            host = DIAMatrix.from_coo(host)
        if not isinstance(host, DIAMatrix):
            raise ValueError("precision='tw' needs a banded operator")
        b_np = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        res = sharded_tw_solve(host, b_np.astype(np.float64), mesh=mesh, n_devices=n_devices,
                               rtol=cfg.tolerance,
                               precond="mg" if cfg.precond == "mg" else "auto",
                               smoother=cfg.mg_smoother,
                               inner_maxiter=int(cfg.maxiter) if cfg.maxiter else None,
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
    if isinstance(mat, DIAMatrix):
        op64 = as_operator(mat, torch.float64, device=dev)
    elif isinstance(mat, DiaOperator):
        op64 = DiaOperator(mat.bands.to(torch.float64), tuple(mat.offsets))
    else:
        raise TypeError(f"precision='tw' needs a banded operator, got {type(mat)}")
    b64 = as_vector(b, dev, "b", torch.float64)
    pc = None
    try:
        nd = infer_grid_ndim(op64.shape[0], op64.offsets)
        pc = mg_preconditioner(op64, ndim=nd, smoother=cfg.mg_smoother,
                               dtype=torch.float32).apply
    except ValueError:
        if cfg.precond == "mg":
            raise  # a non-grid operator: the plain fp32 inner only without "mg"
    inner_maxiter = cfg.maxiter if cfg.maxiter else (80 if pc is not None else b64.shape[0])
    res = refine_pcg_sweeps_tw(op64, b64, precond=pc, rtol=cfg.tolerance,
                               inner_maxiter=int(inner_maxiter), device=dev)
    return CGResult(
        x=res.x,
        iterations=torch.tensor(res.outer_iterations, dtype=torch.int32, device=dev),
        residual_norm=res.residual_norm,
        converged=res.converged,
        rsold=res.residual_norm ** 2,
        history=torch.zeros((0,), dtype=torch.float64, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _maybe_ozaki(op, cfg: SolveConfig):
    """A dense fp64 operator as ``cfg.dense_fp64`` says (cgx api.py:564-582):
    ``"ozaki"`` slices it into an :class:`~cgx_torch.ops.ozaki.
    OzakiDenseOperator`; ``"emulated"`` and ``"auto"`` keep the fp64
    product. cgx's ``"auto"`` takes Ozaki on an accelerator because fp64
    is emulated on the TPU; on the H100, as on the CPU, fp64 is hardware
    and slicing would only slow it (a departure by design, ``ROADMAP.md``
    §C). Anything else raises, as cgx does."""
    if not isinstance(op, DenseOperator) or op.dtype != torch.float64:
        return op
    if cfg.dense_fp64 in ("auto", "emulated"):
        return op
    if cfg.dense_fp64 != "ozaki":
        raise ValueError(f"unknown dense_fp64 mode {cfg.dense_fp64!r}")
    return OzakiDenseOperator.from_dense(op.a)


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

    if cfg.precision == "mixed":
        return _solve_mixed(mat, b, cfg, method, dev, sharded=True, n_devices=n_devices,
                            mesh=mesh, strategy=strategy)
    if cfg.precision not in _DTYPES:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    # a bf16 request runs in float32 on the mesh, as cgx's does (api.py:233-234, :248)
    b_np = (b.detach().cpu().to(torch.float64).numpy() if isinstance(b, torch.Tensor)
            else np.asarray(b))
    b_np = b_np.astype(np.float64 if cfg.precision == "fp64" else np.float32)
    if x0 is not None:
        x0 = x0.detach().cpu().numpy() if isinstance(x0, torch.Tensor) else np.asarray(x0)
    host = _host_matrix(mat)
    maxiter = _default_maxiter(cfg, method, b_np.shape[0])
    if cfg.precond == "mg":  # cgx api.py:217-245
        from cgx_torch.parallel.mg_sharded import sharded_mg_cg_solve

        if method != "reference":
            raise ValueError("precond='mg' sharded runs the reference recurrence")
        if not isinstance(host, DIAMatrix):
            raise ValueError("precond='mg' needs a banded grid operator")
        if x0 is not None:
            raise ValueError("x0 warm starts are not supported on the sharded MG path")
        return sharded_mg_cg_solve(
            host, b_np, mesh=mesh, n_devices=n_devices, tol=cfg.tolerance, maxiter=maxiter,
            nearzero=cfg.nearzero, history=cfg.history, smoother=cfg.mg_smoother,
            cycle_precision=cfg.mg_cycle_precision,
            ndim=infer_grid_ndim(host.shape[0], host.offsets), device=dev)
    return sharded_cg_solve(
        host, b_np, x0=x0, mesh=mesh, n_devices=n_devices, strategy=strategy,
        method=method, precond=cfg.precond, precond_block_size=cfg.precond_block_size,
        tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero, history=cfg.history,
        dot_precision=None if cfg.precision == "fp64" else torch.float64,
        check_every=cfg.check_every, sstep_s=cfg.sstep_s, sstep_basis=cfg.sstep_basis,
        sstep_replace_every=cfg.sstep_replace_every, sstep_powers=_sharded_powers(cfg),
        sstep_fallback=cfg.sstep_fallback, gv_replace_every=cfg.gv_replace_every,
        dense_fp64=cfg.dense_fp64, local_kernel=cfg.local_kernel, device=dev,
    )


def _sharded_powers(cfg: SolveConfig) -> str:
    """The sharded ``sstep_powers`` (cgx ``_sharded_powers``, api.py:81-101):
    "auto" is "off" on a mesh (per-mat-vec halos; "deephalo" trades
    message count for a halo depth of s h, a choice of the caller's);
    "off", "deephalo" and "fused" pass; the single-device modes raise."""
    if cfg.sstep_powers == "auto":
        return "off"
    if cfg.sstep_powers in ("off", "deephalo", "fused"):
        return cfg.sstep_powers
    if cfg.sstep_powers in ("pallas", "interpret"):
        raise ValueError(f"sstep_powers={cfg.sstep_powers!r} is a single-device mode; use "
                         "sstep_powers='deephalo' or 'fused' for sharded solves")
    raise ValueError(f"unknown sstep_powers {cfg.sstep_powers!r}")


def _default_maxiter(cfg: SolveConfig, method: str, n: int) -> int:
    """``cfg.maxiter``, else N, or 4N for the Chebyshev iteration, which
    trades iterations for reductions (cgx api.py:201-205)."""
    if cfg.maxiter is not None:
        return cfg.maxiter
    return 4 * n if method == "chebyshev" else n


def _multi_rhs_dtype(cfg: SolveConfig) -> torch.dtype:
    if cfg.precision not in _MULTI_RHS_PRECISIONS:
        raise ValueError(f"multi-RHS solves support fp64/fp32, not {cfg.precision!r}")
    return _DTYPES[cfg.precision]


def _block_x0(x0, b: torch.Tensor, dev: torch.device):
    """x0 as an (n, s) float64 array or tensor of b's shape, or None."""
    if x0 is None:
        return None
    x0 = as_vector(x0, dev, "x0", torch.float64) if isinstance(x0, torch.Tensor) else (
        np.asarray(x0, np.float64))
    if tuple(x0.shape) != tuple(b.shape):
        raise ValueError(f"x0 must match b's shape {tuple(b.shape)}; got {tuple(x0.shape)}")
    return x0


def _operator_of(mat, dtype, dev):
    """A port operator as it is; anything else as its natural operator."""
    return mat if hasattr(mat, "matvec") else as_operator(mat, dtype=dtype, device=dev)


def _shifted_host(b_np: np.ndarray, x0, host) -> tuple:
    """cgx's shift identity for a warm start on the sharded route: ``B - A
    X0`` with ``A X0`` on the host in float64 (cgx api.py:749-760), and X0
    to add back (None without ``x0``)."""
    if x0 is None:
        return b_np, None
    x0_np = x0.detach().cpu().numpy() if isinstance(x0, torch.Tensor) else np.asarray(x0)
    x0_np = x0_np.astype(np.float64)
    ax0 = host @ x0_np if isinstance(host, np.ndarray) else np.stack(
        [host.mat_vec(x0_np[:, j]) for j in range(x0_np.shape[1])], axis=1)
    return b_np - ax0.astype(b_np.dtype), x0_np


def _solve_batched_rhs(mat, b, cfg: SolveConfig, method: str, dev: torch.device, x0, *,
                       sharded: bool, n_devices=None, mesh=None) -> CGResult:
    """multi_rhs="batched" (cgx api.py:610-716): an independent recurrence a
    column of the (n, s) b; the result's x is (n, s) and its other fields
    carry a leading column axis. On one device the reference recurrence
    (:func:`cgx_torch.solver.batched.cg_solve_batched`); on a mesh
    :func:`cgx_torch.parallel.batched2d.sharded_cg_solve_batched` over a
    (rows x rhs) mesh, ``make_mesh2d(n_devices, 1)`` unless one is given (a
    1-D rows mesh becomes (rows x 1)), with ``method`` "reference",
    "pipelined" or "gvpipe", ``jacobi`` or ``neumann``, and ``x0`` by the
    shift identity."""
    dtype = _multi_rhs_dtype(cfg)
    b_dev = as_vector(b, dev, "b", dtype)
    x0 = _block_x0(x0, b_dev, dev)
    if sharded:  # cgx api.py:630-690
        from cgx_torch.parallel.batched2d import Mesh2D, make_mesh2d, sharded_cg_solve_batched
        from cgx_torch.parallel.mesh import Mesh

        host = _host_matrix(mat)
        if not isinstance(host, DIAMatrix):
            raise ValueError("multi_rhs='batched' sharded needs a banded (DIA) matrix")
        if mesh is None:
            mesh = make_mesh2d(int(n_devices), 1, device=dev)
        elif isinstance(mesh, Mesh):  # a 1-D rows mesh adapts to (rows x 1)
            mesh = make_mesh2d(mesh.size, 1, mesh.group, device=dev)
        elif not isinstance(mesh, Mesh2D):
            raise ValueError("multi_rhs='batched' needs a (rows x rhs) mesh or a 1-D rows mesh; "
                             f"got {type(mesh)}")
        if cfg.history > 0:
            raise ValueError("the sharded batched loop carries no history buffer; use "
                             "multi_rhs='block' or history=0")
        cast = np.float64 if cfg.precision == "fp64" else np.float32
        b_np = b_dev.cpu().numpy().astype(cast)
        b_np, shift = _shifted_host(b_np, x0, host)
        x_t, iters, resn, conv, brk = sharded_cg_solve_batched(
            host, b_np.T, mesh=mesh, tol=cfg.tolerance,
            maxiter=_default_maxiter(cfg, method, b_np.shape[0]), nearzero=cfg.nearzero,
            method=method, precond=cfg.precond, gv_replace_every=cfg.gv_replace_every,
            device=dev)
        x = x_t.mT if shift is None else x_t.mT + torch.as_tensor(shift, device=dev).to(dtype)
        return CGResult(x=x, iterations=iters, residual_norm=resn, converged=conv,
                        rsold=resn * resn, history=torch.zeros((0,), dtype=x.dtype, device=dev),
                        breakdown=brk)
    if method != "reference":
        raise ValueError("single-device multi_rhs='batched' runs the batched reference "
                         f"recurrence; method={method!r} needs a mesh")
    if cfg.precond is not None:
        raise ValueError("single-device multi_rhs='batched' takes no preconditioner (use the "
                         "sharded path or multi_rhs='block')")
    x0_t = None if x0 is None else torch.as_tensor(x0, device=dev).to(dtype).mT
    res = cg_solve_batched(
        _operator_of(mat, dtype, dev), b_dev.mT, x0_t, tol=cfg.tolerance,
        maxiter=_default_maxiter(cfg, method, b_dev.shape[0]), nearzero=cfg.nearzero,
        history=cfg.history, device=dev)
    return res._replace(x=res.x.mT)


def _solve_block(mat, b, cfg: SolveConfig, method: str, dev: torch.device, x0, *,
                 sharded: bool, n_devices=None, mesh=None, strategy: str = "auto"
                 ) -> BlockCGResult:
    """multi_rhs="block" (cgx api.py:718-841): every column of the (n, s)
    b in one breakdown-free block-CG Krylov space, with the configured
    preconditioner applied to every column. ``x0`` warm-starts by the
    shift identity: solve ``A D = B - A X0`` from zero and return ``X0 +
    D``, ``A X0`` on the host in float64 for a host matrix (as cgx), by
    the operator itself for a port operator. On a mesh (cgx api.py:761-803)
    ``precond="mg"`` runs :func:`cgx_torch.parallel.mg_sharded.
    sharded_mg_block_cg_solve` (the grid's dimension by
    :func:`infer_grid_ndim`), anything else :func:`cgx_torch.parallel.
    sharded_cg.sharded_block_cg_solve` with ``strategy`` and
    ``dense_fp64``; the shift on the host."""
    if method != "reference":
        raise ValueError("multi-RHS solves use the breakdown-free block recurrence; "
                         f"method={method!r} applies to single-RHS solves only")
    dtype = _multi_rhs_dtype(cfg)
    b_dev = as_vector(b, dev, "b", dtype if x0 is None else torch.float64)
    x0 = _block_x0(x0, b_dev, dev)
    maxiter = b_dev.shape[0] if cfg.maxiter is None else cfg.maxiter
    if sharded:
        host = _host_matrix(mat)
        cast = np.float64 if cfg.precision == "fp64" else np.float32
        b_np, shift = _shifted_host(b_dev.cpu().numpy().astype(cast), x0, host)
        if cfg.precond == "mg":
            from cgx_torch.parallel.mg_sharded import sharded_mg_block_cg_solve

            if not isinstance(host, DIAMatrix):
                raise ValueError("precond='mg' needs a banded grid operator")
            res = sharded_mg_block_cg_solve(
                host, b_np, mesh=mesh, n_devices=n_devices, tol=cfg.tolerance, maxiter=maxiter,
                smoother=cfg.mg_smoother, cycle_precision=cfg.mg_cycle_precision,
                ndim=infer_grid_ndim(host.shape[0], host.offsets), device=dev)
        else:
            from cgx_torch.parallel.sharded_cg import sharded_block_cg_solve

            res = sharded_block_cg_solve(
                host, b_np, mesh=mesh, n_devices=n_devices, strategy=strategy,
                tol=cfg.tolerance, maxiter=maxiter, precond=cfg.precond,
                dense_fp64=cfg.dense_fp64, device=dev)
        return res if shift is None else res._replace(
            x=res.x + torch.as_tensor(shift, device=dev).to(res.x.dtype))
    op = _operator_of(mat, dtype, dev)
    if dtype == torch.float64:
        op = _maybe_ozaki(op, cfg)
    pc = _build_precond(cfg, op)
    shift = None
    if x0 is not None:
        if hasattr(mat, "mat_vec") or isinstance(mat, np.ndarray):
            x0_np = x0.cpu().numpy() if isinstance(x0, torch.Tensor) else x0
            ax0 = (mat @ x0_np if isinstance(mat, np.ndarray) else np.stack(
                [mat.mat_vec(x0_np[:, j]) for j in range(x0_np.shape[1])], axis=1))
            ax0 = torch.as_tensor(ax0, dtype=torch.float64, device=dev)
        else:
            ax0 = block_matvec(op)(torch.as_tensor(x0, device=dev).to(dtype)).to(torch.float64)
        b_dev = b_dev - ax0
        shift = torch.as_tensor(x0, device=dev).to(dtype)
    res = block_cg_solve(op, b_dev.to(dtype), tol=cfg.tolerance, maxiter=maxiter, precond=pc,
                         device=dev)
    return res if shift is None else res._replace(x=res.x + shift)


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
    if x0 is not None and cfg.precision in ("mixed", "tw"):
        raise ValueError(f"precision={cfg.precision!r} manages its own inner starts; x0 is "
                         "not supported there")
    sharded = (n_devices is not None and n_devices > 1) or mesh is not None
    if np.ndim(b) == 2:
        if cfg.multi_rhs == "batched":
            return _solve_batched_rhs(mat, b, cfg, method, dev, x0, sharded=sharded,
                                      n_devices=n_devices, mesh=mesh)
        if cfg.multi_rhs != "block":
            raise ValueError(f"unknown multi_rhs {cfg.multi_rhs!r}")
        return _solve_block(mat, b, cfg, method, dev, x0, sharded=sharded, n_devices=n_devices,
                            mesh=mesh, strategy=strategy)
    if cfg.precision == "tw":
        return _solve_tw(mat, b, cfg, method, dev, sharded=sharded, n_devices=n_devices,
                         mesh=mesh)
    if sharded:
        return _solve_sharded(mat, b, cfg, method, dev, n_devices=n_devices, mesh=mesh,
                              strategy=strategy, x0=x0)
    if cfg.precision == "mixed":
        return _solve_mixed(mat, b, cfg, method, dev)
    if cfg.precision not in _DTYPES:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    if method not in ("reference", "pipelined", "gvpipe", "chebyshev", "sstep"):
        raise ValueError(f"unknown method {method!r}")
    dtype = _DTYPES[cfg.precision]
    # fp32 and bf16 vectors with fp64 dots, as cgx does whenever x64 is on
    dot_precision = torch.float64 if dtype != torch.float64 else None

    op = _maybe_ozaki(_operator_of(mat, dtype, dev), cfg)
    b_dev = as_vector(b, dev, "b", dtype)
    n = b_dev.shape[0]
    maxiter = _default_maxiter(cfg, method, n)
    if method == "chebyshev":  # cgx api.py:280-288
        if cfg.precond is not None:
            raise ValueError("chebyshev_solve does not take a preconditioner")
        return chebyshev_solve(op, b_dev, x0, tol=cfg.tolerance, maxiter=maxiter,
                               check_every=cfg.check_every, device=dev)
    if method == "gvpipe":  # cgx api.py:310-318
        return gv_cg_solve(
            op, b_dev, x0, tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero,
            history=cfg.history, dot_precision=dot_precision,
            precond=_build_precond(cfg, op), replace_every=cfg.gv_replace_every, device=dev,
        )
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


def solve_sequence(
    mat,
    bs,
    config: Optional[SolveConfig] = None,
    *,
    k: int = 16,
    window: Optional[int] = None,
    warm_start: bool = False,
    n_devices: Optional[int] = None,
    mesh=None,
    strategy: str = "auto",
    device="cuda",
) -> list:
    """Solve a sequence ``A x_t = b_t`` with spectral recycling (cgx
    ``solve_sequence``, api.py:843): the first solve runs plain CG and
    harvests up to ``k`` converged Ritz vectors from its own iterates
    (:func:`cgx_torch.solver.deflated.cg_solve_harvest`), and every later
    one runs deflated CG on that basis, with the configured preconditioner
    (deflated PCG). ``mat`` may be a list of matrices, one a step: the
    harvested W is kept and only A_t W and the (k, k) inverse are rebuilt.
    ``warm_start`` starts each solve from the one before. A harvest that
    finds no converged Ritz pair leaves the rest of the sequence to plain
    CG. Returns the list of results. With ``mesh=`` or ``n_devices=`` the
    sharded route runs the same sequence (:func:`_sequence_sharded`)."""
    cfg = config or SolveConfig()
    dev = resolve_device(device)
    if cfg.precision not in _DTYPES:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    if cfg.method != "reference":
        raise ValueError(
            "solve_sequence runs the reference recurrence (plain harvesting first solve + "
            f"deflated PCG remainder); method={cfg.method!r} is not supported here - solve "
            "those systems individually via cgx_torch.solve")
    dtype = _DTYPES[cfg.precision]
    sharded = (n_devices is not None and n_devices > 1) or mesh is not None
    # the mesh solves a bf16 request's b as float32, unrounded (cgx api.py:935)
    bs = [as_vector(b, dev, "b", torch.float32 if sharded and dtype == torch.bfloat16 else dtype)
          for b in bs]
    if not bs:
        return []
    varying = isinstance(mat, (list, tuple))
    mats = list(mat) if varying else [mat] * len(bs)
    if len(mats) != len(bs):
        raise ValueError(f"got {len(mats)} matrices for {len(bs)} right-hand sides")
    if sharded:
        return _sequence_sharded(mats, bs, cfg, varying, k=k, window=window,
                                 warm_start=warm_start, n_devices=n_devices, mesh=mesh,
                                 strategy=strategy, dev=dev)
    n = bs[0].shape[0]
    maxiter = n if cfg.maxiter is None else cfg.maxiter
    common = dict(tol=cfg.tolerance, maxiter=maxiter, nearzero=cfg.nearzero, device=dev)
    op0 = _operator_of(mats[0], dtype, dev)
    res0, basis = cg_solve_harvest(op0, bs[0], k=k, window=window, strict=False, **common)
    results = [res0]
    pc = None if basis is None else _build_precond(cfg, op0)
    for m, b in zip(mats[1:], bs[1:]):
        op_t = _operator_of(m, dtype, dev) if varying else op0
        x_prev = results[-1].x if warm_start else None
        if basis is None:
            results.append(cg_solve(op_t, b, x_prev, **common))
        else:
            # a varying A keeps the harvested W; A_t W and the inverse are rebuilt
            basis_t = DeflationBasis(op_t, basis.w) if varying else basis
            results.append(deflated_cg_solve(op_t, b, basis_t, x_prev, precond=pc, **common))
    return results


def _sequence_sharded(mats, bs, cfg: SolveConfig, varying: bool, *, k: int, window, warm_start,
                      n_devices, mesh, strategy: str, dev: torch.device) -> list:
    """:func:`solve_sequence` on a mesh (cgx api.py:919-984): the sharded
    harvest (:func:`cgx_torch.parallel.sharded_cg.sharded_cg_solve_harvest`),
    then :func:`~cgx_torch.parallel.sharded_cg.sharded_deflated_cg_solve`
    with ``w=`` and the configured preconditioner for every later step (a
    varying A rebuilds only A_t W and the inverse, in the call). A harvest
    that finds no converged Ritz pair leaves the rest to one
    :func:`~cgx_torch.parallel.sharded_cg.make_sharded_solver` built once
    for the sequence, or to ``sharded_cg_solve`` a step for a varying A."""
    from cgx_torch.parallel.sharded_cg import (
        make_sharded_solver,
        sharded_cg_solve,
        sharded_cg_solve_harvest,
        sharded_deflated_cg_solve,
    )

    cast = np.float64 if cfg.precision == "fp64" else np.float32
    bs = [b.cpu().numpy().astype(cast) for b in bs]
    n = bs[0].shape[0]
    maxiter = n if cfg.maxiter is None else cfg.maxiter
    common = dict(mesh=mesh, n_devices=n_devices, strategy=strategy, tol=cfg.tolerance,
                  maxiter=maxiter, nearzero=cfg.nearzero, device=dev)
    host0 = _host_matrix(mats[0])
    # strict=False: a failed Ritz extraction keeps the completed first solve
    res0, w = sharded_cg_solve_harvest(host0, bs[0], k=k, window=window, strict=False, **common)
    results = [res0]
    plain = None
    if w is None and not varying:  # the operator's shards built once for the sequence
        plain = make_sharded_solver(host0, n, dtype=cast, **common)
    for m, b in zip(mats[1:], bs[1:]):
        host_t = _host_matrix(m) if varying else host0
        x_prev = results[-1].x.cpu().numpy() if warm_start else None
        if plain is not None:
            results.append(plain.solve(b, x0=x_prev))
        elif w is None:
            results.append(sharded_cg_solve(host_t, b, x0=x_prev, **common))
        else:
            results.append(sharded_deflated_cg_solve(host_t, b, w=w, precond=cfg.precond,
                                                     x0=x_prev, **common))
    return results

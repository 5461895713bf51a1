"""Spectral bounds by Lanczos (the bounds half of ``cgx/solver/chebyshev.py``).

s-step CG builds its Krylov basis on the spectral interval
``[lmin, lmax]`` (:mod:`cgx_torch.solver.sstep`); these functions
estimate it as cgx does: ``m``-step Lanczos with full
reorthogonalisation from a seeded NumPy start vector, safety factors
``(0.5, 1.05)`` on the extreme Ritz values, then the Gershgorin bounds
where they are sharper.

The host path is cgx's NumPy code, so for a host matrix or a CPU
operator the port's ``(lmin, lmax)`` equals cgx's bit for bit. For an
operator on the card the same steps run there in float64, from the same
NumPy start vector: at N = 10,240,000 the host's 64 steps keep a
(64, N) float64 basis (5.2 GB) and move about 340 GB through the full
reorthogonalisation, which the card does in a fraction of a second.
The two paths agree to rounding (``tests/test_torch_sstep.py`` holds
them to 1e-12 relative). :func:`host_spectral_bounds` is the host path
for a host matrix (the coarsest level of a multigrid hierarchy, the
sharded route's Chebyshev preconditioner).

:func:`chebyshev_solve` is cgx's Chebyshev iteration (chebyshev.py:245-371):
given ``[lmin, lmax]`` its recurrence needs no reduction, only one dot
every ``check_every`` iterations for the convergence test, which is also
the loop's only host read. Its scalars depend on the bounds alone, so
the host computes them, in the vectors' dtype, as cgx's device does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cgx_torch.config import DEFAULT_TOLERANCE
from cgx_torch.mats.containers import CSRMatrix, DenseMatrix, DIAMatrix, ELLMatrix
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.dia_spmv import dia_matvec_ref
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.cg import CGResult, _as_matvec, as_vector
from cgx_torch.solver.operators import DenseOperator, DiaOperator


def gershgorin_bounds(mat) -> Tuple[float, float]:
    """Gershgorin disc bounds of a host matrix (cgx's): ``(min_i a_ii -
    sum_j |a_ij|, max_i a_ii + sum_j |a_ij|)`` for a DIA matrix with a
    main diagonal, an ELL matrix, a dense container or a 2-D ndarray;
    ``ValueError`` for anything else."""
    if isinstance(mat, DIAMatrix):
        d0 = mat.offsets.index(0)  # ValueError without a main diagonal
        diag = mat.bands[d0]
        off = sum(np.abs(mat.bands[d]) for d in range(len(mat.offsets)) if d != d0)
    elif isinstance(mat, ELLMatrix):
        on_diag = mat.indices == np.arange(mat.shape[0])[:, None]
        diag = np.where(on_diag, mat.values, 0.0).sum(axis=1)
        off = np.abs(np.where(on_diag, 0.0, mat.values)).sum(axis=1)
    elif isinstance(mat, (DenseMatrix, np.ndarray)):
        a = mat.a if isinstance(mat, DenseMatrix) else mat
        if a.ndim != 2:
            raise ValueError(f"no Gershgorin bounds for a {a.ndim}-D array")
        diag = np.diagonal(a)
        off = np.abs(a).sum(axis=1) - np.abs(diag)
    else:
        raise ValueError(f"no Gershgorin bounds for {type(mat)}")
    return float((diag - off).min()), float((diag + off).max())


def _host_dia(op: DiaOperator) -> DIAMatrix:
    return DIAMatrix(op.shape, tuple(op.offsets),
                     op.bands.detach().to("cpu", torch.float64).numpy())


def host_matvec(op):
    """A NumPy float64 mat-vec for an operator or a host matrix (cgx's): a
    banded operator's bands in float64 on the host, a CSR matrix's rows
    summed by ``bincount``, a dense matrix's product, a DIA or ELL
    matrix's own ``mat_vec``, any other operator through its
    ``.matvec``."""
    if isinstance(op, DiaOperator):
        return _host_dia(op).mat_vec
    if isinstance(op, CSRMatrix):  # its mat_vec loops over rows in Python
        row_ids = np.repeat(np.arange(op.shape[0]), np.diff(op.indptr))
        values, indices = np.asarray(op.values, np.float64), np.asarray(op.indices)
        return lambda x: np.bincount(row_ids, weights=values * x[indices],
                                     minlength=op.shape[0])
    if isinstance(op, (DenseMatrix, np.ndarray)):
        a = np.asarray(op.a if isinstance(op, DenseMatrix) else op, np.float64)
        return lambda x: a @ x
    if isinstance(op, (DIAMatrix, ELLMatrix)):
        return op.mat_vec
    dev = getattr(op, "device", torch.device("cpu"))
    return lambda x: op.matvec(torch.as_tensor(x, dtype=op.dtype, device=dev)).to(
        "cpu", torch.float64).numpy()


def device_matvec(op: DiaOperator):
    """The float64 mat-vec of a banded operator on its own device (the
    plain banded product), for Lanczos on the card."""
    bands = op.bands.to(torch.float64)
    offsets = tuple(op.offsets)
    return lambda x: dia_matvec_ref(bands, x, offsets=offsets)


def lanczos_tridiag(mv, n: int, m: int, *, seed: int = 0, device=None):
    """``m``-step Lanczos with full reorthogonalisation (cgx's
    ``lanczos_tridiag``). Returns ``(V (j, n), alphas (j,), betas (j-1,),
    beta_last)`` with ``j <= m`` (early exit on an invariant subspace).

    ``device=None`` runs cgx's NumPy code, ``mv`` a NumPy mat-vec.
    Otherwise the same steps run in float64 torch on ``device`` from the
    same NumPy start vector, ``mv`` a mat-vec of tensors there; ``V`` is
    then a tensor and the scalars are floats."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    xp = np if device is None else torch
    if device is None:
        vs, v_prev = np.empty((m, n)), np.zeros(n)
    else:
        v = torch.as_tensor(v, dtype=torch.float64, device=device)
        vs = torch.empty((m, n), dtype=torch.float64, device=device)
        v_prev = torch.zeros(n, dtype=torch.float64, device=device)
    alphas: list = []
    betas: list = []
    beta = 0.0
    for j in range(m):
        vs[j] = v
        w = np.asarray(mv(v), np.float64) if xp is np else mv(v).to(torch.float64)
        alpha = float(v @ w)
        w = w - alpha * v - beta * v_prev
        # full reorthogonalisation (tiny m: O(m n) per step)
        w -= vs[: j + 1].T @ (vs[: j + 1] @ w)
        alphas.append(alpha)
        beta = float(np.linalg.norm(w)) if xp is np else float(torch.linalg.norm(w))
        if beta < 1e-12 * max(abs(alpha), 1.0):
            break  # invariant subspace: the Ritz values are exact
        betas.append(beta)
        v_prev = v
        v = w / beta
    j = len(alphas)
    return vs[:j], np.asarray(alphas), np.asarray(betas[: j - 1]), beta


def ritz_values(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Eigenvalues of the Lanczos tridiagonal, ascending."""
    t = np.diag(alphas)
    if len(alphas) > 1:
        t += np.diag(betas, 1) + np.diag(betas, -1)
    return np.linalg.eigvalsh(t)


def lanczos_bounds(
    matvec,
    n: int,
    *,
    m: int = 64,
    safety: Tuple[float, float] = (0.5, 1.05),
    lmin_floor_ratio: float = 1e-4,
    seed: int = 0,
    device=None,
) -> Tuple[float, float]:
    """``(safety[0] * theta_min, safety[1] * theta_max)`` from ``m``-step
    Lanczos (Ritz values lie inside the spectrum, hence the asymmetric
    factors); ``lmin`` falls back to ``lmin_floor_ratio * lmax`` when not
    positive. ``device`` as in :func:`lanczos_tridiag`."""
    m = min(m, n)
    _, alphas, betas, _ = lanczos_tridiag(matvec, n, m, seed=seed, device=device)
    ritz = ritz_values(alphas, betas)
    lmax = safety[1] * float(ritz[-1])
    lmin = safety[0] * float(ritz[0])
    if lmin <= 0:
        lmin = lmin_floor_ratio * lmax
    return lmin, lmax


def host_spectral_bounds(
    mat, *, m: int = 64, lmin_floor_ratio: float = 1e-4
) -> Tuple[float, float]:
    """``(lmin, lmax)`` of a host matrix, on the host in NumPy (cgx's
    ``host_spectral_bounds``): Lanczos (:func:`lanczos_bounds`) at both
    ends, then the Gershgorin bounds where they are sharper (lmin raised
    to the Gershgorin floor, lmax clamped to its ceiling) where the
    matrix has them (:func:`gershgorin_bounds`)."""
    lmin, lmax = lanczos_bounds(host_matvec(mat), mat.shape[0], m=m,
                                lmin_floor_ratio=lmin_floor_ratio)
    try:
        g_lo, g_hi = gershgorin_bounds(mat)
    except ValueError:  # no main diagonal, or a format without them (CSR)
        return lmin, lmax
    return max(lmin, g_lo), min(lmax, g_hi)


def spectral_bounds(
    op, n: int, *, m: int = 64, lmin_floor_ratio: float = 1e-4
) -> Tuple[float, float]:
    """``(lmin, lmax)`` for an operator: Lanczos (:func:`lanczos_bounds`),
    on the host for a CPU operator and on the card for a banded operator
    there, tightened with Gershgorin for a banded operator."""
    if not hasattr(op, "matvec"):
        raise TypeError("spectral_bounds needs an operator with .matvec; wrap bare callables "
                        "in an operator or pass bounds= explicitly")
    if isinstance(op, DiaOperator) and op.bands.device.type == "cuda":
        lmin, lmax = lanczos_bounds(device_matvec(op), n, m=m, lmin_floor_ratio=lmin_floor_ratio,
                                    device=op.bands.device)
    else:
        lmin, lmax = lanczos_bounds(host_matvec(op), n, m=m, lmin_floor_ratio=lmin_floor_ratio)
    if isinstance(op, DiaOperator) and 0 in tuple(op.offsets):
        g_lo, g_hi = gershgorin_bounds(_host_dia(op))
        lmin = max(lmin, g_lo)
        lmax = min(lmax, g_hi)
    return lmin, lmax


def _host_scalar(dtype: torch.dtype) -> Callable:
    """A host scalar of ``dtype`` whose arithmetic rounds as cgx's device
    rounds it in that dtype (cgx chebyshev.py:263-301, :365-367): a NumPy
    scalar for float64 and float32, a 0-d CPU tensor for bfloat16, which
    NumPy does not have."""
    if dtype == torch.float64:
        return np.float64
    if dtype == torch.bfloat16:
        return lambda v: torch.tensor(v, dtype=torch.bfloat16)
    return np.float32


def cheby_loop(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    lmin: float,
    lmax: float,
    tol: torch.Tensor,
    *,
    maxiter: int,
    check_every: int,
    dot: Optional[Callable] = None,
    marks=None,
) -> CGResult:
    """The Chebyshev iteration from ``x0`` on ``[lmin, lmax]`` (cgx
    ``cheby_loop``, chebyshev.py:245). ``tol`` is a 0-d tensor of the
    dot's dtype; ``dot(u, v)`` defaults to a local
    :func:`cgx_torch.ops.reduce.vdot` (the sharded solver all-reduces
    it). The dot runs, and the host reads ``converged``, only on the
    iterations ``k`` with ``(k + 1) % check_every == 0``, so on
    convergence ``k`` is a multiple of ``check_every``. ``marks`` as for
    :func:`cgx_torch.solver.cg.run_recurrence`."""
    if dot is None:
        dot = vdot
    dev = b.device
    t = _host_scalar(b.dtype)
    # the scalars in b's dtype, rounded as cgx's device rounds them
    lo, hi, two, unit = t(lmin), t(lmax), t(2.0), t(1.0)
    theta = (hi + lo) / two
    delta = (hi - lo) / two
    sigma1 = theta / delta
    r = b - matvec(x0)
    rr = dot(r, r)
    conv = (torch.sqrt(rr) < tol) | (rr == 0)
    x = x0
    # a true division (a CUDA tensor divided by a host scalar is multiplied
    # by its reciprocal instead)
    p = r / torch.tensor(float(theta), dtype=b.dtype, device=dev)
    rho_old = unit / sigma1
    k = 0
    if not bool(conv):
        while k < maxiter:
            if marks is not None:
                marks.next_iteration()
            x = x + p
            r = r - matvec(p)
            rho = unit / (two * sigma1 - rho_old)
            p = float(rho * rho_old) * p + float(two * rho / delta) * r
            rho_old = rho
            k += 1
            if k % check_every == 0:  # the loop's only reduction and host read
                rr = dot(r, r)
                conv = torch.sqrt(rr) < tol
                if bool(conv):
                    break
    if marks is not None:
        marks.end_loop()
    rr_final = dot(r, r)
    return CGResult(
        x=x,
        iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        residual_norm=torch.sqrt(rr_final),
        converged=torch.sqrt(rr_final) < tol,
        rsold=rr,
        history=torch.zeros((0,), dtype=b.dtype, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
    )


def chebyshev_solve(
    a,
    b,
    x0=None,
    *,
    bounds: Optional[Tuple[float, float]] = None,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    check_every: int = 32,
    device="cuda",
) -> CGResult:
    """Solve SPD ``A x = b`` by the Chebyshev iteration (cgx
    ``chebyshev_solve``, chebyshev.py:323).

    Args:
      a: an operator with ``.matvec``, a 2-D tensor, or a callable (which
        then needs ``bounds``).
      bounds: ``(lmin, lmax)``; by default :func:`spectral_bounds` of the
        operator. ``0 < lmin < lmax`` or ``ValueError``.
      maxiter: defaults to 4N (the method trades iterations for
        reductions).
      check_every: iterations between convergence checks.
      device: where the solve runs; ``"cuda"`` unless ``"cpu"`` is asked.
    """
    dev = resolve_device(device)
    b = as_vector(b, dev, "b")
    n = b.shape[0]
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        a = DenseOperator(a)
    if bounds is None:
        if not hasattr(a, "matvec"):
            raise ValueError("bounds= is required for bare-callable operators")
        bounds = spectral_bounds(a, n)
    lmin, lmax = bounds
    if not (0 < lmin < lmax):
        raise ValueError(f"invalid spectral bounds {bounds}")
    with f32_exact():
        return cheby_loop(
            _as_matvec(a, dev), b, x0, float(lmin), float(lmax),
            torch.tensor(tol, dtype=b.dtype, device=dev),
            maxiter=4 * n if maxiter is None else int(maxiter),
            check_every=int(check_every),
        )

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
for a host DIA matrix (the coarsest level of a multigrid hierarchy).
``chebyshev_solve`` itself is not ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cgx_torch.mats.containers import DIAMatrix
from cgx_torch.ops.dia_spmv import dia_matvec_ref
from cgx_torch.solver.operators import DiaOperator


def gershgorin_bounds(mat: DIAMatrix) -> Tuple[float, float]:
    """Gershgorin disc bounds of a host DIA matrix with a main diagonal
    (cgx's DIA branch): ``(min_i a_ii - sum_j |a_ij|, max_i a_ii +
    sum_j |a_ij|)``."""
    d0 = mat.offsets.index(0)
    diag = mat.bands[d0]
    off = sum(np.abs(mat.bands[d]) for d in range(len(mat.offsets)) if d != d0)
    return float((diag - off).min()), float((diag + off).max())


def _host_dia(op: DiaOperator) -> DIAMatrix:
    return DIAMatrix(op.shape, tuple(op.offsets),
                     op.bands.detach().to("cpu", torch.float64).numpy())


def host_matvec(op):
    """A NumPy float64 mat-vec for an operator or a host DIA matrix: a
    banded operator's bands in float64 on the host (cgx's), the matrix's
    own ``mat_vec``, any other operator through its ``.matvec``."""
    if isinstance(op, DiaOperator):
        return _host_dia(op).mat_vec
    if isinstance(op, DIAMatrix):
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
    """``(lmin, lmax)`` of a host DIA matrix, on the host in NumPy (cgx's
    ``host_spectral_bounds``): Lanczos (:func:`lanczos_bounds`) at both
    ends, then the Gershgorin bounds where they are sharper (lmin raised
    to the Gershgorin floor, lmax clamped to its ceiling) when there is a
    main diagonal."""
    lmin, lmax = lanczos_bounds(host_matvec(mat), mat.shape[0], m=m,
                                lmin_floor_ratio=lmin_floor_ratio)
    if 0 not in tuple(mat.offsets):
        return lmin, lmax
    g_lo, g_hi = gershgorin_bounds(mat)
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

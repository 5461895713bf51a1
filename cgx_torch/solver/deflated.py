"""Deflated CG: recycled spectral information across solve sequences
(counterpart of ``cgx/solver/deflated.py``).

Given a basis W whose columns approximate the lowest eigenvectors,
deflated CG (Saad, Yeung, Erhel and Guyomarc'h 2000) keeps every search
direction A-orthogonal to range(W), so its convergence is governed by
the spectrum above the deflated part. The basis comes from a Lanczos
pass (:func:`lanczos_ritz`, m mat-vecs once per operator) or, at no
extra mat-vec, from a plain CG solve's own iterates
(:func:`cg_solve_harvest`). As cgx's docstring measures, it pays on
operators whose low spectrum is sparse; on a Laplacian, whose low end
is dense, it may cost more than it saves.

The loop is the reference recurrence with the projector and a range(W)
drift guard, on the operator's device; its tall (n, k) products are
``torch.matmul`` at full float32. The host reads ``converged`` once per
``_CHUNK`` iterations, as the other loops do, and iterations after
convergence inside a chunk are frozen. The harvest's Ritz extraction
runs on the host in NumPy, as cgx's does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.blockcg import block_matvec
from cgx_torch.solver.cg import _CHUNK, CGResult, as_vector
from cgx_torch.solver.chebyshev import host_matvec, lanczos_tridiag


def lanczos_ritz(op, n: int, k: int, *, m: Optional[int] = None, seed: int = 0,
                 ritz_tol: float = 1e-3) -> np.ndarray:
    """Up to ``k`` converged lowest Ritz vectors of a symmetric operator
    from an ``m``-step Lanczos pass with full reorthogonalisation on the
    host (cgx ``lanczos_ritz``, deflated.py:52). Returns W (n, k'),
    orthonormal, k' <= k. Only pairs whose residual bound ``beta_m
    |s_{m,i}|`` is within ``ritz_tol`` of the spectral width are kept;
    ``m`` defaults to max(8k, 64)."""
    if m is None:
        m = max(8 * k, 64)
    m = min(m, n)
    if k > m:
        raise ValueError(f"k={k} needs at least m={m} Lanczos steps")
    vs, alphas, betas, beta = lanczos_tridiag(host_matvec(op), n, m, seed=seed)
    j = len(alphas)
    t = np.diag(alphas)
    if j > 1:
        t += np.diag(betas, 1) + np.diag(betas, -1)
    evals, evecs = np.linalg.eigh(t)
    res_bound = abs(beta) * np.abs(evecs[j - 1, :])
    width = max(float(evals[-1] - evals[0]), np.finfo(np.float64).tiny)
    keep = np.flatnonzero(res_bound <= ritz_tol * width)[: min(k, j)]
    if keep.size == 0:
        raise ValueError(f"no Ritz pair converged in {j} Lanczos steps (ritz_tol={ritz_tol}); "
                         "raise m")
    q, _ = np.linalg.qr(vs[:j].T @ evecs[:, keep])  # re-orthonormalised
    return q


class DeflationBasis:
    """Deflation data of one operator (cgx's ``DeflationBasis``): W, AW,
    the inverse of W^T A W (inverted on the host in float64) and
    (AW)^T AW, on the operator's device in its dtype. ``w`` is an (n, k)
    array or tensor, e.g. the W of a cgx basis read with ``np.asarray``."""

    def __init__(self, op, w):
        dev = op.device
        w = (w.to(dev, op.dtype) if isinstance(w, torch.Tensor)
             else torch.tensor(np.asarray(w), dtype=op.dtype, device=dev))
        with f32_exact():
            aw = block_matvec(op)(w)
            m = torch.einsum("nk,nl->kl", w, aw)
            self.awtaw = torch.einsum("nk,nl->kl", aw, aw)
        self.w, self.aw, self.op = w, aw, op
        self.minv = torch.tensor(np.linalg.inv(m.to("cpu", torch.float64).numpy()),
                                 dtype=op.dtype, device=dev)

    @classmethod
    def from_lanczos(cls, op, k: int = 8, *, m: Optional[int] = None,
                     seed: int = 0) -> "DeflationBasis":
        return cls(op, lanczos_ritz(op, op.shape[0], k, m=m, seed=seed))


def deflated_cg_loop(mv: Callable, b: torch.Tensor, x0: torch.Tensor, w, aw, minv, awtaw,
                     tol: torch.Tensor, nearzero: torch.Tensor, *, maxiter: int,
                     history: int = 0, dot: Optional[Callable] = None,
                     tallT: Optional[Callable] = None, fuse: Optional[Callable] = None,
                     precond: Optional[Callable] = None, marks=None) -> CGResult:
    """Deflated (P)CG from ``x0`` (cgx ``deflated_cg_loop``,
    deflated.py:108). Without a preconditioner one fused ``[W, AW]^T r``
    contraction feeds both the drift guard and the projector; with one,
    the guard contracts ``W^T r`` and the projector ``(AW)^T z``.

    ``tallT`` is cgx's hook, ``(M (n, j), v (n,)) -> (j,) M^T v`` (the
    sharded route's reduces over the mesh). ``fuse``, if given, takes the
    preconditioned iteration's last three reductions, the dots ``<r, z>``
    and ``<r, r>`` and the contraction ``(AW)^T z``, as ``fuse([(r, z),
    (r, r)], [(aw, z)])`` and returns them in that order: the sharded
    route reduces them in one launch, as XLA's combiner does cgx's
    (tests/test_collective_counts.py:496-526). ``marks`` as for
    :func:`cgx_torch.solver.cg.cg_loop`."""
    dot = vdot if dot is None else dot
    tall = _local_tallT if tallT is None else tallT
    dev, kdim = b.device, w.shape[1]
    wa = torch.cat([w, aw], dim=1)
    has_pc = precond is not None

    def pc(v):
        return precond(v) if has_pc else v

    def last_three(r_n, z):
        if fuse is not None:
            return fuse([(r_n, z), (r_n, r_n)], [(aw, z)])
        return dot(r_n, z), dot(r_n, r_n), tall(aw, z)

    # the deflation start: shift x so that W^T r = 0
    r = b - mv(x0)
    x = x0 + w @ (minv @ tall(w, r))
    r = b - mv(x)
    z = pc(r)
    p = z - w @ (minv @ tall(aw, z))
    rsold = dot(r, z)
    rr0 = dot(r, r) if has_pc else rsold
    rr = rr0
    converged = (torch.sqrt(rr0) < tol) | (rr0 == 0)
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    trash = torch.full((), history, dtype=torch.int32, device=dev)
    hist = torch.full((history + 1,), float("nan"), dtype=rr0.dtype, device=dev)

    done = 0
    while done < maxiter and not bool(converged):  # the one host sync per chunk
        steps = min(_CHUNK, maxiter - done)
        for _ in range(steps):
            if marks is not None:
                marks.next_iteration()
            live = ~converged
            ap = mv(p)
            conj = dot(p, ap)
            brk = brk | (live & (conj <= 0))
            alpha = rsold / torch.maximum(conj, rsold * nearzero)
            x_n = x + alpha * p
            r_n = r - alpha * ap
            # the drift guard: re-eliminate the range(W) component each iteration
            if has_pc:
                corr = minv @ tall(w, r_n)
            else:
                c2 = tall(wa, r_n)
                corr = minv @ c2[:kdim]
            x_n = x_n + w @ corr
            r_n = r_n - aw @ corr
            if has_pc:
                z = pc(r_n)
                rsnew, rr_n, awz = last_three(r_n, z)
                zproj = z - w @ (minv @ awz)
            else:
                rsnew = dot(r_n, r_n)
                rr_n = rsnew
                zproj = r_n - w @ (minv @ (c2[kdim:] - awtaw @ corr))
            res = torch.sqrt(rr_n)
            if history:
                slot = torch.where(live, torch.clamp(k, max=history), trash)
                hist.index_put_((slot.long().reshape(1),), res.to(hist.dtype).reshape(1))
            conv = res < tol
            upd = live & ~conv
            x = torch.where(live, x_n, x)
            r = torch.where(live, r_n, r)
            p = torch.where(upd, zproj + (rsnew / rsold) * p, p)
            rsold = torch.where(upd, rsnew, rsold)
            k = torch.where(upd, k + 1, k)
            rr = torch.where(live, rr_n, rr)
            converged = converged | (live & conv)
        done += steps
    if marks is not None:
        marks.end_loop()
    return CGResult(x=x, iterations=k, residual_norm=torch.sqrt(rr), converged=converged,
                    rsold=rsold, history=hist[:history], breakdown=brk)


def _local_tallT(m_, v):  # M^T v
    return torch.matmul(m_.mT, v)


def _harvest_cg_loop(mv: Callable, b: torch.Tensor, x0: torch.Tensor, tol: torch.Tensor,
                     nearzero: torch.Tensor, *, maxiter: int, window: int,
                     dot: Optional[Callable] = None, marks=None):
    """The reference recurrence that also keeps the first ``window``
    Lanczos vectors ``v_j = (-1)^j r_j / ||r_j||`` and the recurrence's
    alpha and beta (cgx ``_harvest_cg_loop``, deflated.py:285): the
    harvest costs no extra mat-vec. Returns (result, window, alphas,
    betas), the window a (window, n) tensor. ``marks`` as for
    :func:`cgx_torch.solver.cg.cg_loop`."""
    dot = vdot if dot is None else dot
    dev, dtype = b.device, b.dtype
    r = b - mv(x0)
    x, p = x0, r
    rsold = dot(r, r)
    rsnew = rsold
    converged = (torch.sqrt(rsold) < tol) | (rsold == 0)
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    # one row past the window takes the writes that cgx drops
    win = torch.zeros((window + 1, b.shape[0]), dtype=dtype, device=dev)
    av = torch.zeros(window + 1, dtype=dtype, device=dev)
    bv = torch.zeros(window + 1, dtype=dtype, device=dev)
    trash = torch.full((), window, dtype=torch.int32, device=dev)

    done = 0
    while done < maxiter and not bool(converged):  # the one host sync per chunk
        steps = min(_CHUNK, maxiter - done)
        for _ in range(steps):
            if marks is not None:
                marks.next_iteration()
            live = ~converged
            slot = torch.where(live, torch.clamp(k, max=window), trash).long().reshape(1)
            sign = 1.0 - 2.0 * (k % 2).to(dtype)
            win.index_put_((slot,), ((sign / torch.sqrt(rsold)).to(dtype) * r).reshape(1, -1))
            ap = mv(p)
            conj = dot(p, ap)
            brk = brk | (live & (conj <= 0))
            alpha = rsold / torch.maximum(conj, rsold * nearzero)
            x_n = x + alpha * p
            r_n = r - alpha * ap
            rr = dot(r_n, r_n)
            beta = rr / rsold
            av.index_put_((slot,), alpha.to(dtype).reshape(1))
            bv.index_put_((slot,), beta.to(dtype).reshape(1))
            conv = torch.sqrt(rr) < tol
            upd = live & ~conv
            x = torch.where(live, x_n, x)
            r = torch.where(live, r_n, r)
            p = torch.where(upd, r_n + beta * p, p)
            rsold = torch.where(upd, rr, rsold)
            rsnew = torch.where(live, rr, rsnew)
            k = torch.where(upd, k + 1, k)
            converged = converged | (live & conv)
        done += steps
    if marks is not None:
        marks.end_loop()
    res = CGResult(x=x, iterations=k, residual_norm=torch.sqrt(rsnew), converged=converged,
                   rsold=rsold, history=torch.zeros((0,), dtype=dtype, device=dev),
                   breakdown=brk)
    return res, win[:window], av[:window], bv[:window]


def _ritz_from_cg_window(win: np.ndarray, av: np.ndarray, bv: np.ndarray, steps: int, k: int,
                         ritz_tol: float) -> np.ndarray:
    """The lowest converged Ritz vectors of a CG-harvested Lanczos window,
    on the host (cgx ``_ritz_from_cg_window``, deflated.py:376): the
    tridiagonal from the CG scalars, its eigh, the residual-bound filter,
    then one SVD that collapses ghost directions and orthonormalises."""
    mm = int(steps)
    if mm < 2:
        raise ValueError(f"only {mm} CG steps captured; nothing to harvest")
    a = np.asarray(av[:mm], np.float64)
    bb = np.asarray(bv[:mm], np.float64)
    d = 1.0 / a
    d[1:] += bb[:-1] / a[:-1]
    e = np.sqrt(np.maximum(bb[:-1], 0.0)) / a[:-1]
    t = np.diag(d)
    if mm > 1:
        t += np.diag(e, 1) + np.diag(e, -1)
    evals, evecs = np.linalg.eigh(t)
    tail = np.sqrt(max(float(bb[mm - 1]), 0.0)) / float(a[mm - 1])
    res_bound = tail * np.abs(evecs[mm - 1, :])
    width = max(float(evals[-1] - evals[0]), np.finfo(np.float64).tiny)
    keep = np.flatnonzero(res_bound <= ritz_tol * width)[: min(k, mm)]
    if keep.size == 0:
        raise ValueError(f"no Ritz pair converged in the {mm}-step CG window "
                         f"(ritz_tol={ritz_tol}); raise the window or ritz_tol")
    w_mat = np.asarray(win[:mm], np.float64).T @ evecs[:, keep]
    u, s, _ = np.linalg.svd(w_mat, full_matrices=False)
    rank = int(np.sum(s > 1e-6 * s[0]))
    return u[:, :rank]


def cg_solve_harvest(
    a,
    b,
    x0=None,
    *,
    k: int = 8,
    window: Optional[int] = None,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    ritz_tol: float = 1e-3,
    strict: bool = True,
    device="cuda",
) -> Tuple[CGResult, Optional[DeflationBasis]]:
    """Solve ``A x = b`` by plain CG and harvest a deflation basis from
    the solve's own iterates (cgx ``cg_solve_harvest``, deflated.py:421).
    ``window`` (default max(8k, 64), capped by maxiter and n) bounds the
    (window, n) capture. With ``strict=False`` a harvest that finds no
    converged Ritz pair returns ``(result, None)`` instead of raising."""
    dev = resolve_device(device)
    if not hasattr(a, "matvec"):
        raise TypeError("cg_solve_harvest needs an operator with .matvec")
    b = as_vector(b, dev, "b")
    n = b.shape[0]
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    maxiter = n if maxiter is None else int(maxiter)
    window = int(min(max(8 * k, 64) if window is None else window, maxiter, n))
    with f32_exact():
        res, win, av, bv = _harvest_cg_loop(
            a.matvec, b, x0, torch.tensor(tol, dtype=b.dtype, device=dev),
            torch.tensor(nearzero, dtype=b.dtype, device=dev), maxiter=maxiter, window=window)
    steps = min(int(res.iterations) + 1, window)
    try:
        w = _ritz_from_cg_window(win[:steps].cpu().numpy(), av.cpu().numpy(),
                                 bv.cpu().numpy(), steps, k, ritz_tol)
    except ValueError:
        if strict:
            raise
        return res, None
    return res, DeflationBasis(a, w)


def deflated_cg_solve(
    a,
    b,
    basis: DeflationBasis,
    x0=None,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    history: int = 0,
    precond: Optional[Callable] = None,
    device="cuda",
) -> CGResult:
    """Solve ``A x = b`` by CG deflated by ``basis`` (cgx
    ``deflated_cg_solve``, deflated.py:483); ``precond`` is an optional
    ``r -> M^-1 r`` (deflated PCG)."""
    dev = resolve_device(device)
    if not hasattr(a, "matvec"):
        raise TypeError("deflated_cg_solve needs an operator with .matvec")
    b = as_vector(b, dev, "b")
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    with f32_exact():
        return deflated_cg_loop(
            a.matvec, b, x0, basis.w, basis.aw, basis.minv, basis.awtaw,
            torch.tensor(tol, dtype=b.dtype, device=dev),
            torch.tensor(nearzero, dtype=b.dtype, device=dev),
            maxiter=b.shape[0] if maxiter is None else int(maxiter), history=int(history),
            precond=precond)

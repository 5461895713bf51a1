"""Block CG: one Krylov space shared by all right-hand sides (counterpart
of ``cgx/solver/blockcg.py``).

Each search direction is an (n, s) block, and the scalars alpha and beta
become (s, s) matrices from block Gram systems, so information flows
between the right-hand sides (O'Leary 1980). Two recurrences, as in cgx:

* ``method="breakdown_free"`` (the default): Ji and Li's breakdown-free
  block CG (BIT 2017) with static shapes. The direction block is kept
  orthonormal by an eigh-based rank-revealing transform that zeroes
  dependent or converged directions, the Gram systems are solved by a
  thresholded pseudo-inverse, and every inner product of an iteration
  comes from one (3s, 3s) Gram of ``[P, AP, R]`` (one more (3s, s) strip
  with a preconditioner).
* ``method="oleary"``: the textbook recurrence with jittered Cholesky
  Gram solves.

The tall products (the block mat-vec, the Grams, ``P @ alpha``) run on
the operator's device. The small (s, s) and (3s, 3s) algebra (eigh,
pseudo-inverse, Cholesky) runs on the host, in the Gram's dtype: a
Gram crosses to the host once (twice with a preconditioner, and twice
in the O'Leary recurrence) an iteration, the one host round trip there,
so the rank decisions near ``rank_tol`` are the host LAPACK's on the
card as in the CPU tests, and the loop's exit is read there too. cgx's
float32 refinements stay: the Grams are compensated across chunks
(:func:`cgx_torch.ops.tw32.comp_block_gram`), and the float32 eigh gets
two Newton-Schulz polish steps and two refinement sweeps on compensated
small products. The loops run at full float32 (TF32 off), cgx's
``_f32_exact`` pinning.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from cgx_torch.config import DEFAULT_TOLERANCE
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.dia_spmv import dia_matvec_ref
from cgx_torch.ops.tw32 import comp_block_gram, comp_small_matmul
from cgx_torch.solver.cg import as_vector
from cgx_torch.solver.multigrid import MGPreconditioner
from cgx_torch.solver.operators import DenseOperator, DiaOperator

_HOST = torch.device("cpu")


class BlockCGResult(NamedTuple):
    """A block solve's record, field for field as cgx's."""

    x: torch.Tensor  # (n, s) solutions
    iterations: torch.Tensor  # int32: the shared block-iteration count
    residual_norms: torch.Tensor  # (s,) final per-column ||r||
    converged: torch.Tensor  # (s,) bool
    breakdown: torch.Tensor  # bool


# ---------------------------------------------------------------------------
# Block operators and preconditioners, (n, s) -> (n, s)
# ---------------------------------------------------------------------------


def block_matvec(a) -> Callable:
    """``A P`` for an (n, s) block: a dense operator's one (n, n) @ (n, s)
    product, a banded operator's plain product over the columns as a
    batch, a callable taking blocks as it is, any other operator column
    by column (cgx vmaps its ``matvec``)."""
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        a = DenseOperator(a)
    if isinstance(a, DenseOperator):
        return lambda p: torch.matmul(a.a, p)
    if isinstance(a, DiaOperator):
        return lambda p: dia_matvec_ref(a.bands, p.mT, offsets=a.offsets).mT
    if hasattr(a, "matvec"):
        return lambda p: torch.stack([a.matvec(c) for c in p.unbind(1)], dim=1)
    if callable(a):
        return a
    raise TypeError(f"cannot interpret {type(a)} as a linear operator")


def columnwise(precond: Callable) -> Callable:
    """A single-vector ``r -> M^-1 r`` applied to every column of an
    (n, s) block (cgx's ``_ColumnwisePrecond``): a multigrid cycle takes
    the columns as one batch (the same per-column arithmetic, one
    cycle's launches for all of them), anything else runs column by
    column."""
    owner = getattr(precond, "__self__", None)
    if isinstance(owner, MGPreconditioner):
        return lambda r: precond(r.mT).mT
    return lambda r: torch.stack([precond(c) for c in r.unbind(1)], dim=1)


# ---------------------------------------------------------------------------
# The small algebra, on the host
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.to(_HOST)


def _gram_solve(g: torch.Tensor, rhs: torch.Tensor, eps: float):
    """Solve the SPD (s, s) system ``G Y = rhs`` by jittered Cholesky
    (cgx ``_gram_solve``). Returns ``(Y, ok)``; a failed factor gives a
    zero Y and ``ok`` False."""
    s = g.shape[0]
    jitter = eps * (torch.trace(g) / s + torch.finfo(g.dtype).tiny)
    c, info = torch.linalg.cholesky_ex(g + jitter * torch.eye(s, dtype=g.dtype))
    ok = bool(info == 0) and bool(torch.isfinite(c).all())
    if not ok:
        return torch.zeros_like(rhs), False
    return torch.cholesky_solve(rhs, c), True


def _orth_coeffs(g: torch.Tensor, rank_tol: torch.Tensor):
    """Rank-revealing orthonormalisation coefficients from a Gram matrix
    (cgx ``_orth_coeffs``, blockcg.py:160): ``(w, keep)`` with ``Z @ w``
    orthonormal on Z's numerical range and the dropped directions exact
    zeros. In float32 two Newton-Schulz inverse-square-root steps on the
    compensated transformed Gram polish the eigh's rounding."""
    g = 0.5 * (g + g.T)
    d, v = torch.linalg.eigh(g)
    dmax = torch.clamp(d[-1], min=torch.finfo(g.dtype).tiny)
    keep = d > rank_tol * dmax
    inv = torch.where(keep, torch.rsqrt(torch.where(keep, d, torch.ones_like(d))),
                      torch.zeros_like(d))
    w = v * inv[None, :]
    if g.dtype == torch.float32:
        eye_keep = torch.diag(keep.to(g.dtype))
        for _ in range(2):
            thi, tlo = comp_small_matmul(g, w)
            g1hi, g1lo = comp_small_matmul(w.T, thi)
            g1 = g1hi + (g1lo + w.T @ tlo)
            g1 = 0.5 * (g1 + g1.T)
            # h = I - E/2 on the kept subspace; dropped rows and columns stay zero
            w = w @ (1.5 * eye_keep - 0.5 * g1)
    return w, keep


def _pinv_apply(g: torch.Tensor, rhs: torch.Tensor, rank_tol: torch.Tensor,
                refine: int = 2) -> torch.Tensor:
    """``G Y = rhs`` for an SPSD (s, s) G by the thresholded-eigh
    pseudo-inverse (cgx ``_pinv_apply``, blockcg.py:197); in float32,
    ``refine`` sweeps of iterative refinement on compensated residuals."""
    g = 0.5 * (g + g.T)
    d, v = torch.linalg.eigh(g)
    dmax = torch.clamp(d[-1].abs(), min=torch.finfo(g.dtype).tiny)
    dinv = torch.where(d > rank_tol * dmax, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                       torch.zeros_like(d))

    def apply(r):
        return v @ (dinv[:, None] * (v.T @ r))

    y = apply(rhs)
    if g.dtype == torch.float32 and refine:
        for _ in range(refine):
            hi, lo = comp_small_matmul(g, y)
            y = y + apply((rhs - hi) - lo)
    return y


def _rank_tol(dtype: torch.dtype, rank_tol: float) -> torch.Tensor:
    """The rank threshold, kept above the Gram's own rounding floor (64
    eps: cgx's 1e-12 default is below float32's eps)."""
    return torch.tensor(max(float(rank_tol), 64.0 * torch.finfo(dtype).eps), dtype=dtype)


def _true_report(mv, gram, b, x, conv: bool, res0: torch.Tensor, tol: torch.Tensor):
    """cgx's report from the true residual (blockcg.py:356-383): a column
    converged if ``||b - A x|| < tol``, or the recursion stopped and the
    true residual is below 10 tol or has lost at most half the working
    digits relative to ``||r0||``."""
    r_true = b - mv(x)
    res = torch.sqrt(torch.clamp(torch.diagonal(_host(gram(r_true, r_true))), min=0))
    half_digits = torch.sqrt(torch.tensor(torch.finfo(b.dtype).eps, dtype=b.dtype)) * res0
    ok = (res < tol) | (conv & (res < 10.0 * tol)) | (conv & (res < half_digits))
    return res, ok


def _alpha_step(g: torch.Tensor, s: int, rt: torch.Tensor):
    """From the fused (3s, 3s) Gram of ``[P, AP, R]``: the blocks, the
    A-Gram ``delta = P^T A P``, ``alpha`` solving ``delta alpha = P^T R``,
    and the updated residual's Gram and norms by the same algebra."""
    gpp, gpq, gpr = g[:s, :s], g[:s, s:2 * s], g[:s, 2 * s:]
    gqq, gqr, grr = g[s:2 * s, s:2 * s], g[s:2 * s, 2 * s:], g[2 * s:, 2 * s:]
    delta = 0.5 * (gpq + gpq.T)  # SPD on the active rank
    alpha = _pinv_apply(delta, gpr, rt)
    grr_n = grr - gqr.T @ alpha - alpha.T @ gqr + alpha.T @ gqq @ alpha
    res = torch.sqrt(torch.clamp(torch.diagonal(grr_n), min=0))
    return gpp, gpq, gpr, gqq, gqr, grr_n, delta, alpha, res


def _next_direction(z, p, delta, gpp, gpz, gqz, gzz, rt, conv_now: bool):
    """The next direction block: beta makes ``z + P beta`` A-conjugate to
    P, then the rank-revealing orthonormalisation; a block that lost all
    rank while columns remain restarts from ``orth(z)``. Returns (P, a
    rank-zero restart: the breakdown)."""
    beta = -_pinv_apply(delta, gqz, rt)
    gww = gzz + beta.T @ gpz + gpz.T @ beta + beta.T @ gpp @ beta
    wz, keepz = _orth_coeffs(gww, rt)
    wr, keepr = _orth_coeffs(gzz, rt)
    restart = not bool(keepz.any()) and not conv_now
    if not conv_now:
        dev = z.device
        p = z @ wr.to(dev) if restart else (z + p @ beta.to(dev)) @ wz.to(dev)
    return p, restart and not bool(keepr.any())


def _next(marks) -> None:
    if marks is not None:
        marks.next_iteration()


def _end(marks) -> None:
    if marks is not None:
        marks.end_loop()


def _result(x, k: int, res, ok, brk: bool) -> BlockCGResult:
    dev = x.device
    return BlockCGResult(x=x, iterations=torch.tensor(k, dtype=torch.int32, device=dev),
                         residual_norms=res.to(dev), converged=ok.to(dev),
                         breakdown=torch.tensor(brk, device=dev))


# ---------------------------------------------------------------------------
# The loops
# ---------------------------------------------------------------------------


def block_cg_loop(mv: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float, *,
                  maxiter: int, jitter_eps: float = 1e-15,
                  gram: Optional[Callable] = None, marks=None) -> BlockCGResult:
    """O'Leary's block CG (cgx ``block_cg_loop``, blockcg.py:75) with
    jittered Cholesky Gram solves; a failed factor is a breakdown.
    ``marks`` as for :func:`cgx_torch.solver.cg.cg_loop`."""
    gram = comp_block_gram if gram is None else gram
    dev, dtype = b.device, b.dtype
    tol_t = torch.tensor(tol, dtype=dtype)
    eps = float(torch.tensor(jitter_eps, dtype=dtype))

    x = x0
    r = b - mv(x0)
    gamma = _host(gram(r, r))
    res0 = torch.sqrt(torch.diagonal(gamma))
    conv = bool(((res0 < tol_t) | (res0 == 0)).all())
    brk = False
    p = r
    k = 0
    while k < maxiter and not (conv or brk):
        _next(marks)
        q = mv(p)
        delta = _host(gram(p, q))  # SPD while P has full rank
        alpha, ok1 = _gram_solve(delta, gamma, eps)
        alpha_d = alpha.to(dev)
        x = x + p @ alpha_d
        r = r - q @ alpha_d
        gamma_new = _host(gram(r, r))
        res = torch.sqrt(torch.diagonal(gamma_new))
        conv = bool((res < tol_t).all())
        beta, ok2 = _gram_solve(gamma, gamma_new, eps)
        if not conv:
            p = r + p @ beta.to(dev)
        brk = brk or not (ok1 and ok2)
        gamma = gamma_new
        k += 1
    _end(marks)
    res = torch.sqrt(torch.diagonal(_host(gram(r, r))))
    return _result(x, k, res, res < tol_t, brk)


def bf_block_cg_loop(mv: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float, *,
                     maxiter: int, rank_tol: float = 1e-12, gram: Optional[Callable] = None,
                     precond: Optional[Callable] = None, marks=None) -> BlockCGResult:
    """Breakdown-free block CG (cgx ``bf_block_cg_loop``, blockcg.py:227).
    ``precond`` is a block ``(n, s) -> (n, s)`` SPD apply, or None; with
    it each iteration adds one apply and one (3s, s) Gram strip. If the
    direction block loses all rank while columns remain unconverged it
    restarts from ``orth(Z)``; only a rank-zero restart is a breakdown.
    ``marks`` as for :func:`cgx_torch.solver.cg.cg_loop`."""
    gram = comp_block_gram if gram is None else gram
    dev, dtype = b.device, b.dtype
    s = b.shape[1]
    rt = _rank_tol(dtype, rank_tol)
    tol_t = torch.tensor(tol, dtype=dtype)

    r = b - mv(x0)
    grr0 = _host(gram(r, r))
    res0 = torch.sqrt(torch.clamp(torch.diagonal(grr0), min=0))
    conv = bool(((res0 < tol_t) | (res0 == 0)).all())
    if precond is None:
        z, gzz = r, grr0
    else:
        z = precond(r)
        gzz = _host(gram(z, z))
    w0, keep0 = _orth_coeffs(gzz, rt)
    p = z @ w0.to(dev)
    brk = not bool(keep0.any()) and not conv
    x = x0
    k = 0
    while k < maxiter and not (conv or brk):
        _next(marks)
        q = mv(p)
        cat = torch.cat([p, q, r], dim=1)  # (n, 3s)
        g = _host(gram(cat, cat))  # the alpha and residual reduction
        del cat
        gpp, gpq, gpr, gqq, gqr, grr_n, delta, alpha, res = _alpha_step(g, s, rt)
        alpha_d = alpha.to(dev)
        x = x + p @ alpha_d
        r_new = r - q @ alpha_d
        conv_now = bool((res < tol_t).all())
        if precond is None:
            z_new = r_new
            gzz_n, gpz_n, gqz_n = grr_n, gpr - gpq @ alpha, gqr - gqq @ alpha
        else:
            z_new = precond(r_new)
            g2 = _host(gram(torch.cat([p, q, z_new], dim=1), z_new))
            gpz_n, gqz_n, gzz_n = g2[:s], g2[s:2 * s], g2[2 * s:]
        p, lost = _next_direction(z_new, p, delta, gpp, gpz_n, gqz_n, gzz_n, rt, conv_now)
        brk = brk or lost or not bool(torch.isfinite(res).all())
        conv = conv or conv_now
        r = r_new
        k += 1
    _end(marks)
    res, ok = _true_report(mv, gram, b, x, conv, res0, tol_t)
    return _result(x, k, res, ok, brk)


def bf_block_deflated_cg_loop(mv: Callable, b: torch.Tensor, x0: torch.Tensor, w, aw, minv,
                              awtaw, tol: float, *, maxiter: int, rank_tol: float = 1e-12,
                              gram: Optional[Callable] = None, marks=None) -> BlockCGResult:
    """Deflated breakdown-free block CG (cgx ``bf_block_deflated_cg_loop``,
    blockcg.py:407): one shared block-Krylov space for every column, its
    directions A-orthogonal to range(W). Each iteration: one block
    mat-vec, the (3s, 3s) Gram, the fused (2k, s) ``[W, AW]^T R``
    contraction (the range(W) drift guard and the projector) and the
    (3s, s) strip against the projected block. ``marks`` as for
    :func:`cgx_torch.solver.cg.cg_loop`."""
    gram = comp_block_gram if gram is None else gram
    dev, dtype = b.device, b.dtype
    s, kdim = b.shape[1], w.shape[1]
    rt = _rank_tol(dtype, rank_tol)
    tol_t = torch.tensor(tol, dtype=dtype)
    wa = torch.cat([w, aw], dim=1)  # (n, 2k)

    def guard(x, r):
        """Eliminate the range(W) component of r (and of the error):
        returns (x, r, (AW)^T r_new) from one fused contraction."""
        c2 = gram(wa, r)  # (2k, s)
        corr = minv @ c2[:kdim]
        x = x + w @ corr
        r = r - aw @ corr
        return x, r, c2[kdim:] - awtaw @ corr

    def proj_from(awr, v):
        return v - w @ (minv @ awr)

    r = b - mv(x0)
    x, r, _ = guard(x0, r)
    r = b - mv(x)  # the exact residual after the deflation shift
    grr0 = _host(gram(r, r))
    res0 = torch.sqrt(torch.clamp(torch.diagonal(grr0), min=0))
    conv = bool(((res0 < tol_t) | (res0 == 0)).all())
    z = proj_from(gram(aw, r), r)
    w0, keep0 = _orth_coeffs(_host(gram(z, z)), rt)
    p = z @ w0.to(dev)
    brk = not bool(keep0.any()) and not conv
    k = 0
    while k < maxiter and not (conv or brk):
        _next(marks)
        q = mv(p)
        cat = torch.cat([p, q, r], dim=1)
        g = _host(gram(cat, cat))
        del cat
        gpp, _, _, _, _, _, delta, alpha, res = _alpha_step(g, s, rt)
        alpha_d = alpha.to(dev)
        x = x + p @ alpha_d
        r_new = r - q @ alpha_d
        conv_now = bool((res < tol_t).all())
        # the range(W) drift guard and the projector's contraction; the
        # projection breaks the [P, Q, R] algebra for z, so one (3s, s) strip
        x, r_new, awr = guard(x, r_new)
        z = proj_from(awr, r_new)
        g2 = _host(gram(torch.cat([p, q, z], dim=1), z))
        p, lost = _next_direction(z, p, delta, gpp, g2[:s], g2[s:2 * s], g2[2 * s:], rt,
                                  conv_now)
        brk = brk or lost or not bool(torch.isfinite(res).all())
        conv = conv or conv_now
        r = r_new
        k += 1
    _end(marks)
    res, ok = _true_report(mv, gram, b, x, conv, res0, tol_t)
    return _result(x, k, res, ok, brk)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _as_block(b_block, x0, dev):
    b_block = as_vector(b_block, dev, "b_block")
    if b_block.dim() != 2:
        raise ValueError("b_block must be (n, s); use cg_solve for one RHS")
    x0 = torch.zeros_like(b_block) if x0 is None else as_vector(x0, dev, "x0", b_block.dtype)
    return b_block, x0


def block_cg_solve(
    a,
    b_block,
    x0=None,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    jitter_eps: float = 1e-15,
    method: str = "breakdown_free",
    rank_tol: float = 1e-12,
    precond: Optional[Callable] = None,
    device="cuda",
) -> BlockCGResult:
    """Solve ``A X = B`` for every column of B in one block-Krylov
    iteration (cgx ``block_cg_solve``, blockcg.py:610).

    Args:
      a: an operator with ``.matvec`` (a dense one as one (n, n) @ (n, s)
        product), a 2-D tensor, or a callable taking (n, s) blocks.
      b_block: (n, s) right-hand sides.
      tol: per-column absolute residual tolerance.
      method: ``"breakdown_free"`` (default) or ``"oleary"``.
      rank_tol: relative eigenvalue threshold of the rank reveal.
      precond: a single-vector ``r -> M^-1 r``, applied to every column
        (breakdown_free only; see :func:`columnwise`).
      device: where the solve runs; ``"cuda"`` unless ``"cpu"`` is asked.
    """
    dev = resolve_device(device)
    b_block, x0 = _as_block(b_block, x0, dev)
    if method not in ("breakdown_free", "oleary"):
        raise ValueError(f"unknown block CG method {method!r}")
    if precond is not None and method != "breakdown_free":
        raise ValueError("precond requires method='breakdown_free'")
    maxiter = b_block.shape[0] if maxiter is None else int(maxiter)
    mv = block_matvec(a)
    with f32_exact():
        if method == "breakdown_free":
            return bf_block_cg_loop(mv, b_block, x0, tol, maxiter=maxiter, rank_tol=rank_tol,
                                    precond=None if precond is None else columnwise(precond))
        return block_cg_loop(mv, b_block, x0, tol, maxiter=maxiter, jitter_eps=jitter_eps)


def block_deflated_cg_solve(
    a,
    b_block,
    basis,
    x0=None,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    rank_tol: float = 1e-12,
    device="cuda",
) -> BlockCGResult:
    """Solve ``A X = B`` in one deflated block-Krylov space (cgx
    ``block_deflated_cg_solve``, blockcg.py:558): ``basis`` is a
    :class:`~cgx_torch.solver.deflated.DeflationBasis` of the operator."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        a = DenseOperator(a)
    if not hasattr(a, "matvec"):
        raise TypeError("block_deflated_cg_solve needs an operator")
    b_block = as_vector(b_block, dev, "b_block")
    if b_block.dim() != 2:
        raise ValueError("b_block must be (n, s)")
    b_block, x0 = _as_block(b_block, x0, dev)
    maxiter = b_block.shape[0] if maxiter is None else int(maxiter)
    with f32_exact():
        return bf_block_deflated_cg_loop(block_matvec(a), b_block, x0, basis.w, basis.aw,
                                         basis.minv, basis.awtaw, tol, maxiter=maxiter,
                                         rank_tol=rank_tol)

"""s-step (communication-avoiding) CG: s iterations per Gram reduction
(counterpart of ``cgx/solver/sstep.py``).

Per outer block of s iterations:

  1. build the (2s+1)-column Krylov basis
     ``V = [T_0(A)p .. T_s(A)p, T_0(A)r .. T_{s-1}(A)r]``, Chebyshev on
     the Lanczos interval ``[lmin, lmax]`` (or scaled Newton with s
     Leja-ordered Ritz shifts);
  2. form the Gram matrix ``G = V V^T``;
  3. replay s reference-recurrence CG iterations in coefficient space
     (:func:`replay_block`: alpha and beta from quadratic forms of G);
  4. recover ``x += xc V``, ``r = d V``, ``p = c V``.

In exact arithmetic the iterates are classic CG's. ``powers`` picks how
the basis is built: ``"off"`` from 2s-1 plain mat-vecs, ``"pallas"``
(``"interpret"`` is a synonym) by the matrix-powers kernel B9
(:mod:`cgx_torch.ops.dia_powers`), ``"fused"`` by the two-kernel
streaming block B10 (:mod:`cgx_torch.ops.sstep_stream`), whose basis
never reaches device memory.

Two arithmetics:

- cgx's (``gram_precision=None``, ``powers="off"``): the Gram in the
  vectors' dtype and, in float32, the replay's quadratic forms
  compensated (:func:`_qf_comp`, from :mod:`cgx_torch.ops.tw32`); what
  the CPU tests hold against cgx;
- the kernels' (``gram_precision=torch.float64``, and always with
  ``"pallas"`` and ``"fused"``): the Gram and the replay in float64,
  the coefficients rounded to the vectors' dtype only where they scale
  vectors (the lesson of B4-B6, ROADMAP C). The kernel routes replay by
  one code, the one-block kernel ``sstep_replay``.

As in :mod:`cgx_torch.solver.cg`, ``k``, ``converged`` and
``breakdown`` stay on the device; the host reads the stop flag once per
``_BLOCKS`` blocks. A block after the stop replays with every iteration
frozen, whose coefficients leave x, r and p as they are, so the result
does not depend on ``_BLOCKS``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import f32_exact, pow2_rhs_scale, resolve_device
from cgx_torch.ops.tw32 import two_prod32, two_sum32
from cgx_torch.solver.cg import CGResult, _as_matvec, as_vector, cg_solve
from cgx_torch.solver.operators import DenseOperator, DiaOperator

_BLOCKS = 8  # s-step blocks between host reads of the stop flag
POWERS = ("off", "pallas", "interpret", "fused")


def _basis_matrix(s: int, theta: float, delta: float, dtype,
                  shifts: Tuple[float, ...] = ()) -> np.ndarray:
    """The (2s+1)x(2s+1) matrix B with ``A V = V B`` on every column the
    recurrences touch (the top-degree columns excluded): Chebyshev's
    three-term structure, or with ``shifts`` the scaled-Newton
    bidiagonal ``A v_i = shifts[i] v_i + (delta/2) v_{i+1}``."""
    m = 2 * s + 1
    b = np.zeros((m, m))
    if shifts:
        sigma = delta / 2.0

        def fill(base: int, width: int):
            for i in range(width - 1):
                b[base + i, base + i] = shifts[i]
                b[base + i + 1, base + i] = sigma
    else:

        def fill(base: int, width: int):
            if width >= 2:
                b[base + 0, base + 0] = theta
                b[base + 1, base + 0] = delta
            for i in range(1, width - 1):
                b[base + i - 1, base + i] = delta / 2.0
                b[base + i, base + i] = theta
                b[base + i + 1, base + i] = delta / 2.0

    fill(0, s + 1)  # p-part: degrees 0..s
    fill(s + 1, s)  # r-part: degrees 0..s-1
    return b.astype(dtype)


def leja_order(vals: np.ndarray) -> np.ndarray:
    """Greedy Leja ordering: the largest-magnitude point first, then the
    point maximising the product of distances to those chosen."""
    vals = np.asarray(vals, np.float64)
    if vals.size == 0:
        return vals
    tiny = np.finfo(np.float64).tiny
    chosen = [int(np.argmax(np.abs(vals)))]
    rest = [j for j in range(vals.size) if j != chosen[0]]
    while rest:
        logs = [float(np.sum(np.log(np.abs(vals[j] - vals[chosen]) + tiny))) for j in rest]
        k = int(np.argmax(logs))
        chosen.append(rest.pop(k))
    return vals[chosen]


def newton_shifts(a, n: int, s: int, bounds: Tuple[float, float]) -> Tuple[float, ...]:
    """s Leja-ordered Ritz values from ``max(2s, 16)`` Lanczos steps (on
    the card for a banded operator there, else on the host), thinned to s
    points over the Ritz range; Chebyshev points of ``bounds`` if Lanczos
    ends early."""
    from cgx_torch.solver.chebyshev import (
        device_matvec, host_matvec, lanczos_tridiag, ritz_values)

    m = min(max(2 * s, 16), n)
    if isinstance(a, DiaOperator) and a.bands.device.type == "cuda":
        _, alphas, betas, _ = lanczos_tridiag(device_matvec(a), n, m, device=a.bands.device)
    else:
        _, alphas, betas, _ = lanczos_tridiag(host_matvec(a), n, m)
    ritz = ritz_values(alphas, betas)
    if ritz.size >= s:
        idx = np.round(np.linspace(0, ritz.size - 1, s)).astype(int)
        pts = ritz[idx]
    else:
        lmin, lmax = bounds
        th, dl = (lmax + lmin) / 2.0, (lmax - lmin) / 2.0
        j = np.arange(s)
        pts = th + dl * np.cos((2 * j + 1) * np.pi / (2 * s))
    return tuple(float(v) for v in leja_order(pts))


def basis_columns_fn(mv: Callable, dtype, theta: float, delta: float, shifts=()):
    """The column builder ``cols(v0, width) -> [T_0(A)v0 .. T_{width-1}(A)v0]``:
    Chebyshev on (theta, delta), or scaled Newton
    ``N_{i+1} = (A - shifts_i) N_i / (delta/2)``. The kernels B9 and B10
    evaluate each column by these same operations, in this order."""
    def const(v, like):
        return torch.tensor(v, dtype=dtype, device=like.device)

    def cols(v0: torch.Tensor, width: int):
        out = [v0]
        sg = const(delta / 2.0, v0)
        if shifts:
            for i in range(width - 1):
                out.append((mv(out[-1]) - const(shifts[i], v0) * out[-1]) / sg)
            return out
        th, dl = const(theta, v0), const(delta, v0)
        if width >= 2:
            out.append((mv(v0) - th * v0) / dl)
        for _ in range(2, width):
            t_prev, t_cur = out[-2], out[-1]
            out.append(2.0 * (mv(t_cur) - th * t_cur) / dl - t_prev)
        return out

    return cols


def _local_gram(v: torch.Tensor) -> torch.Tensor:
    """``V V^T`` in V's dtype, at full float32 (the caller runs inside
    :func:`cgx_torch.ops._util.f32_exact`)."""
    return v @ v.T


def _qf_comp(a: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T G b`` with double-float32 accuracy from float32 alone: exact
    Dekker products and a compensated binary-tree sum (cgx's
    ``_qf_comp``). In float64 the plain form."""
    if g.dtype == torch.float64:
        return a @ g @ b
    q, f = two_prod32(a[:, None], b[None, :])  # outer products, exact
    p1, e1 = two_prod32(g, q)  # G * q, exact
    p2 = g * f  # |f| <= eps |q|: its own rounding is ~eps^2 of the scale
    terms = torch.cat([p1.reshape(-1), e1.reshape(-1), p2.reshape(-1)])
    n = terms.shape[0]
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    s_ = F.pad(terms, (0, pow2 - n))
    e_ = torch.zeros_like(s_)
    while s_.shape[0] > 1:
        s1, e1_ = two_sum32(s_[0::2], s_[1::2])
        e_ = e_[0::2] + e_[1::2] + e1_
        s_ = s1
    return s_[0] + e_[0]


def replay_block(g, bmat, s: int, k, rsnew, conv, brk, *, tol, nearzero, maxiter: int):
    """Replay s reference-recurrence CG iterations in coefficient space
    from the block's Gram matrix ``g`` (cgx's ``replay_block``, with its
    break and freeze semantics: ``conj <= 0`` freezes the firing
    iteration and sets breakdown; on convergence x and r advance while
    p, rsold and k freeze). ``tol`` and ``nearzero`` are 0-d tensors of
    g's dtype, ``k`` an int32 0-d tensor, ``conv`` and ``brk`` bool ones.

    Returns ``(xc, d, c, k, rs, rsnew, conv, brk)``: the recovery
    coefficients of x, r and p in basis coordinates and the advanced
    scalars (``rs`` is the block-final rsold). This is also the plain
    version of the kernel replay (``csrc/sstep_basis.cuh``) in float64."""
    dtype, dev = g.dtype, g.device
    m = 2 * s + 1
    eye = torch.eye(m, dtype=dtype, device=dev)
    c = eye[0].clone()  # p in basis coordinates
    d = eye[s + 1].clone()  # r in basis coordinates
    xc = torch.zeros(m, dtype=dtype, device=dev)
    rs = _qf_comp(d, g, d)
    for _ in range(s):
        live = ~conv & ~brk & (k < maxiter)
        bc = bmat @ c  # A p_j in basis coordinates
        conj = _qf_comp(c, g, bc)
        bad = live & (conj <= 0)
        brk = brk | bad
        active = live & ~bad
        alpha = rs / torch.maximum(conj, rs * nearzero)
        xc_n = xc + alpha * c
        d_n = d - alpha * bc
        rr = _qf_comp(d_n, g, d_n)
        conv_now = torch.sqrt(rr) < tol
        adv = active & ~conv_now
        beta = rr / rs
        c_n = d_n + beta * c
        xc = torch.where(active, xc_n, xc)
        d = torch.where(active, d_n, d)
        rsnew = torch.where(active, rr, rsnew)
        c = torch.where(adv, c_n, c)
        rs = torch.where(active, torch.where(adv, rr, rs), rs)
        k = torch.where(adv, k + 1, k)
        conv = conv | (active & conv_now)
    return xc, d, c, k, rs, rsnew, conv, brk


def sstep_cg_loop(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float,
    nearzero: float,
    *,
    s: int,
    maxiter: int,
    theta: float,
    delta: float,
    shifts: Tuple[float, ...] = (),
    basis_fn: Optional[Callable] = None,
    replace_every: int = 0,
    gram_precision: Optional[torch.dtype] = None,
    replay: Optional[Callable] = None,
    gram: Optional[Callable] = None,
    marks=None,
) -> CGResult:
    """The s-step recurrence from ``x0`` (cgx ``sstep_cg_loop``).

    ``basis_fn(p, r)`` returns the (2s+1, n) basis (B9), or None for the
    2s-1 plain mat-vecs; ``gram_precision`` the Gram's and the replay's
    dtype (None: the vectors', cgx's arithmetic); ``replay(g, k, rsnew,
    conv, brk)`` replaces :func:`replay_block` (the kernel replay);
    ``gram(v)`` maps the (m, n) basis in the Gram's dtype to ``V V^T``
    (default the local product; the sharded route all-reduces it, one
    collective a block, as cgx's ``gram`` hook does). ``marks`` as for
    :func:`cgx_torch.solver.cg.run_recurrence`, a block an iteration.
    ``replace_every`` > 0 replaces ``r = b - A x`` every that many blocks
    while ``||r||^2 > eps ||r_0||^2`` (cgx's guarded replacement; here
    the mat-vec runs in every such block and the replacement is
    selected on the device)."""
    dtype, dev = b.dtype, b.device
    gdt = dtype if gram_precision is None else gram_precision
    bmat = torch.as_tensor(_basis_matrix(s, theta, delta, np.float64, shifts), dtype=gdt,
                           device=dev)
    cols = basis_columns_fn(matvec, dtype, theta, delta, shifts)
    tol_t = torch.tensor(tol, dtype=gdt, device=dev)
    nz_t = torch.tensor(nearzero, dtype=gdt, device=dev)

    gram_of = _local_gram if gram is None else gram

    def gram(v):
        return gram_of(v.to(gdt))

    if replay is None:
        def replay(g, k, rsnew, conv, brk):
            return replay_block(g, bmat, s, k, rsnew, conv, brk, tol=tol_t, nearzero=nz_t,
                                maxiter=maxiter)

    x = x0
    r = b - matvec(x0)
    p = r
    rs0 = gram(r[None, :])[0, 0]
    rsold = rsnew = rs0
    conv = (torch.sqrt(rs0) < tol_t) | (rs0 == 0)
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    rr_floor = torch.finfo(dtype).eps * rs0
    blk = 0
    while not bool(conv | brk | (k >= maxiter)):  # the one host read per _BLOCKS blocks
        for _ in range(_BLOCKS):
            if marks is not None:
                marks.next_iteration()
            if replace_every > 0 and blk > 0 and blk % replace_every == 0:
                live = ~conv & ~brk & (k < maxiter)
                r = torch.where(live & (rsnew > rr_floor), b - matvec(x), r)
            v = basis_fn(p, r) if basis_fn is not None else torch.stack(cols(p, s + 1) + cols(r, s))
            live = ~conv & ~brk & (k < maxiter)
            xc, d, c, k, rs, rsnew, conv, brk = replay(gram(v), k, rsnew, conv, brk)
            # cgx's loop ends at the stop: rsold is its last live block's
            rsold = torch.where(live, rs, rsold)
            # one stacked (3, m) @ (m, n) product, the coefficients in the vectors' dtype
            rec = torch.stack([xc, d, c]).to(dtype) @ v
            x = x + rec[0]
            r, p = rec[1], rec[2]
            blk += 1
    if marks is not None:
        marks.end_loop()
    return CGResult(
        x=x,
        iterations=k,
        residual_norm=torch.sqrt(rsnew).to(dtype),
        converged=conv,
        rsold=rsold.to(dtype),
        history=torch.zeros((0,), dtype=dtype, device=dev),
        breakdown=brk,
    )


class _DiaPowersBasis:
    """basis_fn through the matrix-powers kernel B9: the operator's bands
    prepared once per solve (cgx's ``prepare``), then one launch a block."""

    def __init__(self, op: DiaOperator, s: int, theta: float, delta: float, shifts, rows: int,
                 cols: int):
        from cgx_torch.ops.dia_powers import sstep_powers_band_planes

        self.offsets = tuple(int(o) for o in op.offsets)
        self.kw = dict(offsets=self.offsets, s=int(s), theta=float(theta), delta=float(delta),
                       shifts=tuple(shifts), rows=int(rows), cols=int(cols))
        self.planes = sstep_powers_band_planes(op.bands, offsets=self.offsets, s=int(s),
                                               rows=int(rows), cols=int(cols))

    def __call__(self, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        from cgx_torch.ops.dia_powers import dia_sstep_basis_planes

        return dia_sstep_basis_planes(self.planes, p, r, **self.kw)


def _kernel_replay(s: int, theta: float, delta: float, shifts, tol: float, nearzero: float,
                   maxiter: int, dev: torch.device) -> Callable:
    """A ``replay`` for :func:`sstep_cg_loop` through ``sstep_replay``
    (the one-block kernel on a card, its plain version on the CPU), on
    a packed float64 state (:mod:`cgx_torch.ops.sstep_stream`)."""
    from cgx_torch.ops import sstep_stream as ss

    m = 2 * s + 1
    st = torch.zeros(ss.STATE_LEN, dtype=torch.float64, device=dev)
    bmat = torch.as_tensor(_basis_matrix(s, theta, delta, np.float64, shifts), device=dev)
    kw = dict(s=s, tol=tol, nearzero=nearzero, maxiter=maxiter)

    def replay(g, k, rsnew, conv, brk):
        st[ss.GRAM:ss.GRAM + m * m].copy_(g.reshape(-1))
        st[ss.K:ss.BRK + 1].copy_(torch.stack([k.to(torch.float64), rsnew, rsnew,
                                               conv.to(torch.float64), brk.to(torch.float64)]))
        ss.sstep_replay(st, bmat, **kw)
        coef = st[ss.COEF:ss.COEF + 3 * m].view(3, m)
        return (coef[0], coef[1], coef[2], st[ss.K].to(torch.int32), st[ss.RSOLD].clone(),
                st[ss.RSNEW].clone(), st[ss.CONV] != 0, st[ss.BRK] != 0)

    return replay


def sstep_cg_solve(
    a,
    b,
    x0=None,
    *,
    s: int = 4,
    bounds: Optional[Tuple[float, float]] = None,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    basis: str = "chebyshev",
    replace_every: Optional[int] = None,
    powers: str = "off",
    powers_block: Tuple[int, int] = (512, 512),
    fallback: str = "auto",
    gram_precision: Optional[torch.dtype] = None,
    device="cuda",
) -> CGResult:
    """Solve SPD ``A x = b`` by s-step CG (cgx's ``sstep_cg_solve``).

    Arguments as cgx's: ``bounds`` (lmin, lmax), estimated by
    :func:`cgx_torch.solver.chebyshev.spectral_bounds` when omitted;
    ``basis`` "chebyshev" or "newton"; ``replace_every`` the residual
    replacement cadence in blocks (None: 0 for s <= 8, else 1);
    ``powers`` "off", "pallas" or "interpret" (kernel B9), or "fused"
    (kernels B10, which refuse residual replacement); ``powers_block``
    cgx's TPU tile (validated by the fused route, otherwise unused);
    ``fallback`` "auto" (after a replay breakdown finish on B4 for a
    banded non-fp64 operator, else on classic CG), "adaptive" (halve s
    down to 2 first) or "off". ``gram_precision`` applies to
    ``powers="off"``: None for cgx's arithmetic, ``torch.float64`` for
    the kernels'. float64 runs on every route (cgx's TPU kernels refuse
    it), bfloat16 on ``"fused"`` only (cgx's loop, and so its ``"off"`` and
    ``"pallas"`` routes, does not carry it). ``b`` is prescaled by an exact
    power of two."""
    if fallback not in ("auto", "adaptive", "off"):
        raise ValueError(f"unknown fallback {fallback!r}")
    if powers not in POWERS:
        raise ValueError(f"unknown powers mode {powers!r}")
    if basis not in ("chebyshev", "newton"):
        raise ValueError(f"unknown s-step basis {basis!r}")
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        a = DenseOperator(a)
    if not hasattr(a, "matvec"):
        raise TypeError("sstep_cg_solve needs an operator with .matvec")
    s = int(s)
    if replace_every is None:
        replace_every = 1 if s > 8 else 0
    b = as_vector(b, dev, "b")
    if b.dtype == torch.bfloat16 and powers != "fused":  # the fused block runs bfloat16
        raise TypeError(f"powers={powers!r}: cgx's s-step loop does not carry bfloat16 vectors "
                        "(its loop state changes dtype); use precision='fp32' or powers='fused'")
    n = b.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    if bounds is None:
        from cgx_torch.solver.chebyshev import spectral_bounds

        bounds = spectral_bounds(a, n)
    lmin, lmax = float(bounds[0]), float(bounds[1])
    if not 0 < lmin < lmax:
        raise ValueError(f"invalid spectral bounds {bounds}")
    common = dict(tol=tol, maxiter=maxiter, nearzero=nearzero, fallback=fallback, s=s,
                  bounds=(lmin, lmax), basis=basis, powers=powers, powers_block=powers_block,
                  gram_precision=gram_precision, device=dev)
    if powers == "fused":
        from cgx_torch.ops.sstep_stream import dia_sstep_stream_solve

        if not isinstance(a, DiaOperator):
            raise TypeError("powers='fused' needs a banded DiaOperator")
        if replace_every:
            raise ValueError("powers='fused' does not support residual replacement (the fused "
                             "block never materializes r explicitly)")
        res = dia_sstep_stream_solve(a, b, x0, s=s, bounds=(lmin, lmax), tol=tol,
                                     maxiter=maxiter, nearzero=nearzero, basis=basis,
                                     rows=int(powers_block[0]), cols=int(powers_block[1]),
                                     device=dev)
        return _sstep_fallback(a, b, res, **common)
    theta, delta = (lmax + lmin) / 2.0, (lmax - lmin) / 2.0
    shifts = newton_shifts(a, n, s, (lmin, lmax)) if basis == "newton" else ()
    mv = _as_matvec(a, dev)
    down, up = (float(v) for v in pow2_rhs_scale(b, x0))
    basis_fn = replay = None
    if powers != "off":
        if not isinstance(a, DiaOperator):
            raise TypeError(f"powers={powers!r} needs a banded DiaOperator, got "
                            f"{type(a).__name__}")
        basis_fn = _DiaPowersBasis(a, s, theta, delta, shifts, *powers_block)
        replay = _kernel_replay(s, theta, delta, shifts, tol * down, nearzero, maxiter, dev)
        gram_precision = torch.float64
    with f32_exact():
        res = sstep_cg_loop(mv, b * down, x0 * down, tol * down, nearzero, s=s, maxiter=maxiter,
                            theta=theta, delta=delta, shifts=shifts, basis_fn=basis_fn,
                            replace_every=int(replace_every), gram_precision=gram_precision,
                            replay=replay)
    res = res._replace(x=res.x * up, residual_norm=res.residual_norm * up,
                       rsold=res.rsold * (up * up))
    return _sstep_fallback(a, b, res, **common)


def _sstep_fallback(a, b, res: CGResult, *, tol, maxiter, nearzero, fallback, s, bounds,
                    basis, powers, powers_block, gram_precision, device) -> CGResult:
    """The restart after a replay breakdown (cgx's ``_sstep_fallback``):
    from the frozen iterate, for the iterations left. "adaptive" first
    walks the s-ladder (s//2, down to 2); then a banded non-fp64 operator
    finishes on the streaming kernel B4 (``bands_dtype="auto"``) through
    the exact shift identity ``x = x_f + A^-1 (b - A x_f)``, anything
    else on classic CG from x_f."""
    if fallback == "off" or not bool(res.breakdown) or bool(res.converged):
        return res
    used = int(res.iterations)
    left = int(maxiter) - used
    if left <= 0:
        return res
    if fallback == "adaptive" and s >= 4:
        res2 = sstep_cg_solve(a, b, res.x, s=s // 2, bounds=bounds, tol=tol, maxiter=left,
                              nearzero=nearzero, basis=basis, powers=powers,
                              powers_block=powers_block, fallback="adaptive",
                              gram_precision=gram_precision, device=device)
        return res2._replace(iterations=res2.iterations + used)
    x_f = res.x
    if isinstance(a, DiaOperator) and a.dtype != torch.float64:
        from cgx_torch.ops.cg_stream import dia_cg_solve_stream

        fres = dia_cg_solve_stream(a, b - a.matvec(x_f), tol=tol, maxiter=left,
                                   nearzero=nearzero, bands_dtype="auto", device=device)
        fres = fres._replace(x=x_f + fres.x)
    else:
        fres = cg_solve(a, b, x_f, tol=tol, maxiter=left, nearzero=nearzero, device=device)
    return fres._replace(iterations=fres.iterations + used)

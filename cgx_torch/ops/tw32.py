"""Triple-word float32 arithmetic (counterpart of ``cgx/ops/tw32.py``).

A value is carried as an unevaluated triple ``(w0, w1, w2)`` of float32
tensors, ``|w0| >= |w1| >= |w2|`` and adjacent words non-overlapping
after renormalisation (Shewchuk expansions of fixed length 3): about 71
mantissa bits, beyond fp64's 53. The error-free transforms
(:func:`two_sum32`, :func:`two_prod32`, Knuth's sum and Dekker's
product with the 4097 splitter, exact without FMA) build everything
from float32 operations alone.

cgx built this because its TPU's fp64 is an emulation that is not
correctly rounded. The H100's fp64 is IEEE, so :mod:`cgx_torch.ops.dd`
is valid there too; this module is the port of cgx's route and serves
:func:`cgx_torch.solver.refine.refine_pcg_sweeps_tw` (``solve(precision=
"tw")``), the s-step replay's compensated quadratic forms
(:func:`cgx_torch.solver.sstep._qf_comp`) and, later, block CG's Gram
(:func:`comp_block_gram`, :func:`comp_small_matmul`).

Each operation is its own PyTorch operation, so nothing contracts a
multiply and an add into an FMA: the transforms stay exact on the CPU
and on the card alike. No fused operation (``addcmul``, ``lerp``,
``torch.add(..., alpha=)``) may take the place of a product and a sum
here. The words equal cgx's bit for bit wherever the operations match
(everything but the fp64 norm of :func:`residual_tw` and the per-chunk
products of :func:`comp_block_gram`, whose summation order is the
library's).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cgx_torch.ops._util import f32_exact

_F32 = torch.float32
_SPLIT32 = 4097.0  # 2**12 + 1, Dekker's splitter for binary32

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def two_sum32(a: torch.Tensor, b: torch.Tensor):
    """``a + b = s + e`` exactly (Knuth; round-to-nearest float32)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum32(a: torch.Tensor, b: torch.Tensor):
    """``a + b = s + e`` exactly, given ``|a| >= |b|`` (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod32(a: torch.Tensor, b: torch.Tensor):
    """``a * b = p + e`` exactly (Dekker's split)."""
    p = a * b
    ta = _SPLIT32 * a
    a_hi = ta - (ta - a)
    a_lo = a - a_hi
    tb = _SPLIT32 * b
    b_hi = tb - (tb - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def tw_renorm(c0, c1, c2) -> Triple:
    """Three roughly ordered terms as a canonical non-overlapping triple
    (the VecSum cascade of Ogita, Rump and Oishi)."""
    s, e2 = two_sum32(c1, c2)
    w0, e1 = two_sum32(c0, s)
    w1, w2 = two_sum32(e1, e2)
    return w0, w1, w2


def tw_zero_like(v: torch.Tensor) -> Triple:
    z = torch.zeros_like(v, dtype=_F32)
    return z, torch.zeros_like(z), torch.zeros_like(z)


def tw_add_f32(x: Triple, v) -> Triple:
    """Triple + float32, renormalised (cascaded two-sums)."""
    s0, e0 = two_sum32(x[0], v)
    s1, e1 = two_sum32(x[1], e0)
    s2 = x[2] + e1
    return tw_renorm(s0, s1, s2)


def tw_add_tw(x: Triple, y: Triple) -> Triple:
    """Triple + triple, renormalised. The term the cascade drops is
    O(eps^3) of the leading word (cgx's documented floor)."""
    s0, e0 = two_sum32(x[0], y[0])
    s1, e1 = two_sum32(x[1], y[1])
    t1, f1 = two_sum32(s1, e0)
    s2 = (x[2] + y[2]) + (e1 + f1)
    return tw_renorm(s0, t1, s2)


def tw_neg(x: Triple) -> Triple:
    return -x[0], -x[1], -x[2]


def tw_scale_f32(x: Triple, a) -> Triple:
    """Triple * float32 scalar or tensor, renormalised; ``x[2] * a`` is a
    plain product (its rounding is O(eps^3) of the result)."""
    p0, q0 = two_prod32(x[0], a)
    p1, q1 = two_prod32(x[1], a)
    t1, f1 = two_sum32(p1, q0)
    p2 = x[2] * a + (q1 + f1)
    return tw_renorm(p0, t1, p2)


def tw_from_f64(x64: torch.Tensor) -> Triple:
    """An fp64 tensor as an exact float32 triple: 53 mantissa bits fit in
    three 24-bit words, and each residual subtraction is exact in IEEE
    fp64."""
    w0 = x64.to(_F32)
    r = x64 - w0.to(x64.dtype)
    w1 = r.to(_F32)
    r = r - w1.to(x64.dtype)
    w2 = r.to(_F32)
    return w0, w1, w2


def tw_to_f64(x: Triple, dtype=torch.float64) -> torch.Tensor:
    """The triple evaluated in ``dtype``, summed in word order (for norms
    and views: the sum rounds to fp64)."""
    return x[0].to(dtype) + x[1].to(dtype) + x[2].to(dtype)


def _shift32(v: torch.Tensor, off: int) -> torch.Tensor:
    """``shift(v, off)[i] = v[i + off]`` with zero fill (the banded
    product's alignment)."""
    if off == 0:
        return v
    if off > 0:
        return F.pad(v[off:], (0, off))
    return F.pad(v[:off], (-off, 0))


def split_bands_tw(bands64) -> torch.Tensor:
    """The exact three-word float32 split of fp64 bands: a ``(3, ndiag,
    n)`` stack with ``c0 + c1 + c2 == bands64`` bit for bit, so that the
    triple-word product treats the true fp64 operator where the bands do
    not round-trip float32 (``poisson2d_var``'s harmonic means)."""
    b64 = torch.as_tensor(bands64, dtype=torch.float64)
    c0 = b64.to(_F32)
    r1 = b64 - c0.to(torch.float64)
    c1 = r1.to(_F32)
    c2 = (r1 - c1.to(torch.float64)).to(_F32)
    return torch.stack([c0, c1, c2])


def bands_f32_exact(bands64) -> bool:
    """True when the fp64 bands round-trip float32 bit for bit (then the
    single float32 plane is the true operator). Reads one bool back from
    the bands' device."""
    if isinstance(bands64, torch.Tensor):
        return bool(torch.equal(bands64.to(_F32).to(bands64.dtype), bands64))
    b = np.asarray(bands64)
    return bool(np.all(b.astype(np.float32).astype(b.dtype) == b))


def banded_matvec_tw(bands32: torch.Tensor, offsets, x: Triple) -> Triple:
    """``y = A (x0 + x1 + x2)`` in triple-word float32.

    ``bands32`` is the ``(ndiag, n)`` float32 bands (the operator is then
    the float32-rounded bands, exact for integer stencils) or a ``(3,
    ndiag, n)`` stack from :func:`split_bands_tw`, whose product carries
    the full fp64 operator to about 2^-71. Band products enter through
    :func:`two_prod32`, the accumulation through :func:`tw_add_tw`, in
    offset order."""
    planes = bands32.dim() == 3
    acc = None
    for d, off in enumerate(offsets):
        t0 = _shift32(x[0], off)
        t1 = _shift32(x[1], off)
        t2 = _shift32(x[2], off)
        if planes:
            c0, c1, c2 = bands32[0, d], bands32[1, d], bands32[2, d]
            p00, q00 = two_prod32(c0, t0)
            p01, q01 = two_prod32(c0, t1)
            p10, q10 = two_prod32(c1, t0)
            # the eps^2-relative terms: plain float32 sums suffice
            lo = c0 * t2 + c1 * t1 + c2 * t0 + q01 + q10
            s1, e1 = two_sum32(p01, q00)
            s2, e2 = two_sum32(s1, p10)
            term = tw_renorm(p00, s2, lo + e1 + e2)
        else:
            bd = bands32[d]
            p0, q0 = two_prod32(bd, t0)
            p1, q1 = two_prod32(bd, t1)
            p2 = bd * t2 + q1
            s1, e1 = two_sum32(p1, q0)
            term = tw_renorm(p0, s1, p2 + e1)
        acc = term if acc is None else tw_add_tw(acc, term)
    return acc


def residual_tw(bands32: torch.Tensor, offsets, b: Triple, x: Triple):
    """``r = b - A x`` as a float32 triple, and ``||r||`` (the fp64 norm of
    the first two words: the norm needs only a few digits)."""
    ax = banded_matvec_tw(bands32, offsets, x)
    r = tw_add_tw(b, tw_neg(ax))
    rv = r[0].to(torch.float64) + r[1].to(torch.float64)
    return r, torch.sqrt(torch.sum(rv * rv))


# ---------------------------------------------------------------------------
# Compensated block contractions (cgx's, for block CG's Gram)
# ---------------------------------------------------------------------------


def _comp_tree_sum32(s_: torch.Tensor, e_: torch.Tensor):
    """Compensated binary-tree sum over axis 0 of value/error pairs,
    zero-padded to a power of two; returns ``(hi, lo)``."""
    n = s_.shape[0]
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    if pow2 != n:
        pad = (0, 0) * (s_.dim() - 1) + (0, pow2 - n)
        s_ = F.pad(s_, pad)
        e_ = F.pad(e_, pad)
    while s_.shape[0] > 1:
        s1, e1 = two_sum32(s_[::2], s_[1::2])
        e_ = e_[::2] + e_[1::2] + e1
        s_ = s1
    return s_[0], e_[0]


def comp_block_gram(a: torch.Tensor, b: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """``A^T B`` over a long first axis: float32 products a chunk at a
    time (full float32: TF32 off), the chunks combined by the compensated
    tree (:func:`_comp_tree_sum32`), so the error is a chunk's and not the
    whole reduction's. fp64 inputs take the plain product."""
    with f32_exact():
        if a.dtype != _F32 or b.dtype != _F32:
            return torch.einsum("ns,nt->st", a, b)
        n, ma = a.shape
        mb = b.shape[1]
        nc = -(-n // chunk)
        if nc <= 1:
            return torch.einsum("ns,nt->st", a, b)
        n_p = nc * chunk
        if n_p != n:
            a = F.pad(a, (0, 0, 0, n_p - n))
            b = F.pad(b, (0, 0, 0, n_p - n))
        part = torch.einsum("cns,cnt->cst", a.reshape(nc, chunk, ma), b.reshape(nc, chunk, mb))
    hi, lo = _comp_tree_sum32(part, torch.zeros_like(part))
    return hi + lo


def comp_small_matmul(a: torch.Tensor, b: torch.Tensor):
    """``A @ B`` of small float32 matrices as an unevaluated ``(hi, lo)``:
    each term product exact by :func:`two_prod32`, the contraction axis
    summed by the compensated tree."""
    p, e = two_prod32(a[:, :, None], b[None, :, :])  # (m, k, t)
    return _comp_tree_sum32(p.movedim(1, 0), e.movedim(1, 0))

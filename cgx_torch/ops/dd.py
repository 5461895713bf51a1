"""Double-double arithmetic (counterpart of ``cgx/ops/dd.py``).

A value is carried as an unevaluated pair ``(hi, lo)`` of fp64 tensors,
so that a residual ``b - A x`` can be evaluated to about eps^2 and
refinement can push the true residual below fp64's evaluation floor,
about eps * kappa at large N (:func:`cgx_torch.solver.refine.
refine_pcg_sweeps_dd`).

The error-free transforms need correctly rounded fp64 addition and
multiplication. cgx's TPU emulates fp64 without that, so there the
module degrades to fp64 accuracy (cgx's docstring); the H100's fp64 is
IEEE, like the CPU's, and the transforms are exact on both. Each
operation is its own PyTorch operation, so nothing contracts into an
FMA; :func:`two_prod` uses Veltkamp's split, which needs none.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_SPLITTER = 134217729.0  # 2**27 + 1, Dekker's splitter for fp64

Pair = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """``a + b = s + e`` exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor):
    """``a + b = s + e`` exactly, given ``|a| >= |b|`` (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a: torch.Tensor):
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor):
    """``a * b = p + e`` exactly (Dekker, no FMA)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def dd_add(x: Pair, y: Pair) -> Pair:
    """Pair + pair, renormalised."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return fast_two_sum(s, e)


def dd_add_fp(x: Pair, a) -> Pair:
    """Pair + plain fp64, renormalised."""
    s, e = two_sum(x[0], a)
    return fast_two_sum(s, e + x[1])


def dd_neg(x: Pair) -> Pair:
    return -x[0], -x[1]


def dd_scale_fp(x: Pair, a) -> Pair:
    """Pair * plain fp64 ``a`` (``a`` taken as exact)."""
    p, e = two_prod(x[0], a)
    return fast_two_sum(p, e + x[1] * a)


def dd_from_fp(a: torch.Tensor) -> Pair:
    return a, torch.zeros_like(a)


def _shift(v: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """``shift(v, off)[i] = v[i + off]`` with zero fill (the banded
    product's alignment)."""
    if off == 0:
        return v
    if off > 0:
        return F.pad(v[off:], (0, off))
    return F.pad(v[:off], (-off, 0))


def banded_matvec_dd(bands: torch.Tensor, offsets, x_hi: torch.Tensor,
                     x_lo: torch.Tensor) -> Pair:
    """``y = A (x_hi + x_lo)`` in double-double: every band product of the
    leading word through :func:`two_prod`, every accumulation through
    :func:`dd_add`, in offset order, so the pair carries the product to
    about eps^2."""
    n = x_hi.shape[0]
    acc = None
    for d, off in enumerate(offsets):
        sh = _shift(x_hi, off, n)
        sl = _shift(x_lo, off, n)
        p, e = two_prod(bands[d], sh)
        term = fast_two_sum(p, e + bands[d] * sl)
        acc = term if acc is None else dd_add(acc, term)
    return acc


def residual_dd(bands: torch.Tensor, offsets, b: torch.Tensor, x_hi: torch.Tensor,
                x_lo: torch.Tensor):
    """``r = b - A x`` as a pair, and ``||r||`` (the fp64 norm of the
    leading word, far below the pair's accuracy)."""
    ax = banded_matvec_dd(bands, offsets, x_hi, x_lo)
    r = dd_add(dd_neg(ax), dd_from_fp(b))
    return r, torch.sqrt(torch.sum(r[0] * r[0]))


def dd_norm(x_hi: torch.Tensor, x_lo: torch.Tensor) -> torch.Tensor:
    """``||x_hi + x_lo||`` to fp64 accuracy."""
    return torch.sqrt(torch.sum((x_hi + x_lo) ** 2))

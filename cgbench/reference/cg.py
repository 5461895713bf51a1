"""Conjugate gradient in plain PyTorch: the benchmark's reference solve.

The recurrence of the upstream solver (``cg.cc``): from ``x = 0``, stop
when ``sqrt(<r, r>) < tol`` (an absolute tolerance) and count in ``k``
the iterations that did not reach it, with ``alpha = <r, z> / max(<p,
Ap>, <r, z> * nearzero)``. ``precond="neumann"`` applies the truncated
Neumann series of two terms, ``z = 2 D^-1 r - D^-1 A D^-1 r``.

Vectors are stored in the dtype of ``b``; each vector operation is
computed in float32 for a 16-bit dtype and in the dtype itself otherwise,
and rounded on store. Dots accumulate in float64.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

NEARZERO = 1.0e-14


class Solution(NamedTuple):
    x: torch.Tensor
    k: int
    converged: bool
    residual: float  # sqrt(<r, r>) of the recurrence at the stop


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def matvec(bands: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """``A x`` for ``bands[d, i] = A[i, i + offsets[d]]``, computed in the
    bands' dtype and rounded to ``x``'s."""
    xa, ba = x.to(bands.dtype), bands
    y = ba[offsets.index(0)] * xa
    for d, o in enumerate(offsets):
        if o > 0:
            y[:-o].addcmul_(ba[d, :-o], xa[o:])
        elif o < 0:
            y[-o:].addcmul_(ba[d, -o:], xa[:o])
    return y.to(x.dtype)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(u.to(torch.float64), v.to(torch.float64))


def _axpy_(y: torch.Tensor, a: torch.Tensor, x: torch.Tensor) -> None:
    """``y += a x`` in place, ``a`` a 0-d tensor."""
    acc = _acc(y.dtype)
    if acc == y.dtype:
        y.addcmul_(x, a.to(acc))
    else:
        y.copy_(torch.addcmul(y.to(acc), x.to(acc), a.to(acc)))


def _neumann(bands: torch.Tensor, offsets, r: torch.Tensor) -> torch.Tensor:
    acc = _acc(r.dtype)
    d = bands[offsets.index(0)].to(acc)
    c = (r.to(acc) / d).to(r.dtype)
    return (2 * c.to(acc) - matvec(bands, offsets, c).to(acc) / d).to(r.dtype)


def cg(bands: torch.Tensor, offsets, b: torch.Tensor, tol: float, maxiter: int, *,
       precond: Optional[str] = None, nearzero: float = NEARZERO) -> Solution:
    """Solve ``A x = b`` from ``x = 0``, the bands taken in the dtype the
    vector operations are computed in. The host reads ``<r, r>`` once an
    iteration for the stopping rule; a non-finite one ends the solve
    unconverged."""
    if precond not in (None, "neumann"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    offsets = tuple(int(o) for o in offsets)
    bands = bands.to(_acc(b.dtype))
    x = torch.zeros_like(b)
    r = b.clone()
    rr = _dot(r, r)
    z = _neumann(bands, offsets, r) if precond else r
    p = z.clone()
    rz = _dot(r, z) if precond else rr
    rr_host = float(rr)
    converged = math.sqrt(rr_host) < tol or rr_host == 0.0
    k = 0
    while not converged and k < maxiter:
        ap = matvec(bands, offsets, p)
        pap = _dot(p, ap)
        alpha = rz / torch.maximum(pap, rz * nearzero)
        _axpy_(x, alpha, p)
        _axpy_(r, -alpha, ap)
        rr = _dot(r, r)
        rr_host = float(rr)
        if not math.isfinite(rr_host):
            break
        if math.sqrt(rr_host) < tol:
            converged = True
            break
        k += 1
        if precond:
            z = _neumann(bands, offsets, r)
            rz_new = _dot(r, z)
        else:
            z, rz_new = r, rr
        beta = rz_new / rz
        p.copy_(torch.addcmul(z.to(_acc(p.dtype)), p.to(_acc(p.dtype)),
                              beta.to(_acc(p.dtype))))
        rz = rz_new
    return Solution(x, k, converged, math.sqrt(rr_host) if rr_host >= 0 else math.nan)


def true_residual(bands64: torch.Tensor, offsets, x: torch.Tensor, b: torch.Tensor) -> float:
    """``||b - A x|| / ||b||`` in float64, from float64 bands; infinity for
    a non-finite ``x``."""
    x64, b64 = x.to(torch.float64), b.to(torch.float64)
    if not bool(torch.isfinite(x64).all()):
        return math.inf
    r = b64 - matvec(bands64, tuple(int(o) for o in offsets), x64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))

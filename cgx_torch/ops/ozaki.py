"""Ozaki split-precision dense fp64 mat-vec (counterpart of
``cgx/ops/ozaki.py``).

The scheme (Ozaki et al., "Error-free transformations of matrix
multiplication", Numer. Algorithms 2012):

1. Scale each row of A by a power of two so that ``|A_hat| <= 1/2`` and
   cut its mantissa into S = 8 slices of BETA = 7 bits by floor: the
   leading slice an integer in [-64, 64], the others in [0, 127], all
   int8.
2. Scale and slice each right-hand column of x the same way.
3. One int8 product, ``(S n, m) @ (m, S ncols) -> int32``, gives every
   slice pair's partial exactly: a product is below 2^14 and a sum of
   up to NMAX = 2^17 of them below 2^31.
4. Combine the S^2 partials in fp64 with the exact weights
   ``2^(-BETA (s + t + 2))`` and undo the scalings.

The error is the dropped slicing tail, about 2^-56 of each dot's mass
for S = 8, below an fp64 mat-vec's own rounding.

cgx took this route on the TPU because fp64 products there are
emulated. On the H100 fp64 is native and ``solve(dense_fp64="auto")``
keeps the plain fp64 operator (``ROADMAP.md`` §C); ``"ozaki"`` runs this
one. The int8 product is a library call, as cgx's is outside any Pallas
kernel (``jnp.dot(..., preferred_element_type=jnp.int32)``):
``torch._int_mm`` (:func:`int8_matmul`), whose shape rules (more than
16 rows, a contraction length and a column count that are multiples of
8) are met by zero slices, which are exact. Its plain version
(:func:`int8_matmul_ref`) is a float64 product of the same slices,
exact in any order, so the two are equal bit for bit. A failed
``_int_mm`` raises; nothing falls back to the float64 product.

Powers of two come from a host table, as in cgx (an ``exp2`` may be
inexact on some backends): the exponent of a bound is read exactly by
``frexp``. The slices are cgx's bit for bit; the fp64 combine sums the
partials in the library's order, so the result equals cgx's within fp64
rounding, not bitwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

BETA = 7  # mantissa bits a slice (int8)
NMAX = 1 << 17  # 2 BETA + log2(NMAX) = 31: the int32 sums are exact

_EMIN, _EMAX = -1022, 1023
_POW2_TABLE = np.ldexp(1.0, np.arange(_EMIN, _EMAX + 1))
_MM_ALIGN = 8  # torch._int_mm: K and N multiples of 8
_MM_MIN_ROWS = 17  # torch._int_mm: more than 16 rows


def _pow2_bound(v: torch.Tensor) -> torch.Tensor:
    """Twice the smallest power of two >= ``v``, elementwise (zeros map to
    1): ``|v| / result <= 1/2``, and dividing by it is exact."""
    safe = torch.where(v > 0, v, torch.ones_like(v))
    mant, e = torch.frexp(safe)  # safe = mant 2^e, mant in [0.5, 1)
    e = torch.where(mant == 0.5, e - 1, e)  # an exact power: 2^(e-1) is safe itself
    e = torch.clamp(e, _EMIN, _EMAX - 1).long()
    p = torch.as_tensor(_POW2_TABLE, dtype=safe.dtype, device=safe.device)[e - _EMIN]
    p = torch.where(p < safe, p * 2.0, p)  # out of the table's range: clamp upwards
    return torch.where(v > 0, 2.0 * p, torch.ones_like(p))


def _slice_mantissa(r: torch.Tensor, num_slices: int) -> list:
    """Floor-split ``|r| <= 1/2`` into int8 slices of BETA bits:
    ``r = sum_s C_s 2^(-BETA (s + 1)) + tail``, ``0 <= tail < 2^(-BETA S)``.
    A tiny negative entry whose remainder fp64 absorbs to exactly
    ``2^(-BETA s)`` would floor to 2^BETA, one past int8: the clamp leaves
    that remainder to the next slice (cgx's boundary fix)."""
    slices = []
    for s in range(num_slices):
        scale = 2.0 ** ((s + 1) * BETA)
        c = torch.floor(r * scale)
        c = torch.clamp(c, max=2.0**BETA - 1.0)
        slices.append(c.to(torch.int8))
        r = r - c / scale
    return slices


def _build_slices(a: torch.Tensor, num_slices: int):
    """``(c, sigma)``: the ``(S, n, m)`` int8 slices of A's rows and the
    ``(n,)`` power-of-two row scales."""
    sigma = _pow2_bound(torch.amax(torch.abs(a), dim=1))
    c = torch.stack(_slice_mantissa(a / sigma[:, None], num_slices))
    return c, sigma


def _slice_vector(x: torch.Tensor, num_slices: int):
    """``(d, tau)``: the ``(T, m, ncols)`` int8 slices of an ``(m, ncols)``
    block of vectors and its per-column power-of-two scales."""
    tau = _pow2_bound(torch.amax(torch.abs(x), dim=0))
    return torch.stack(_slice_mantissa(x / tau[None, :], num_slices)), tau


def _pad_cols(c: torch.Tensor) -> torch.Tensor:
    """The slices with zero columns up to a multiple of 8 (int8 products
    of zeros are exact)."""
    m = c.shape[-1]
    m_p = -(-m // _MM_ALIGN) * _MM_ALIGN
    return c if m_p == m else F.pad(c, (0, m_p - m))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 matrices in int32, exactly: ``torch._int_mm``.
    ``a`` has more than 16 rows; its columns and ``b``'s are multiples of
    8. Raises where the library refuses."""
    return torch._int_mm(a, b)


def int8_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`int8_matmul`: a float64 product of the
    same values, exact in any summation order (every partial sum is an
    integer below 2^31 < 2^53), cast to int32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _int8_operands(c: torch.Tensor, d: torch.Tensor):
    """The two operands of the one int8 product: A's slices stacked
    ``(S n, m_c)`` and x's ``(m_c, T ncols)``, zero-padded to
    ``torch._int_mm``'s shapes (``c`` may carry zero columns past x's
    length m already)."""
    s_tot, n, _ = c.shape
    t_tot, m, ncols = d.shape
    c_cat = _pad_cols(c).reshape(s_tot * n, -1)
    if c_cat.shape[0] < _MM_MIN_ROWS:
        c_cat = F.pad(c_cat, (0, 0, 0, _MM_MIN_ROWS - c_cat.shape[0]))
    cols = t_tot * ncols
    d_cat = d.permute(1, 0, 2).reshape(m, cols)
    d_cat = F.pad(d_cat, (0, -(-cols // _MM_ALIGN) * _MM_ALIGN - cols, 0, c_cat.shape[1] - m))
    return c_cat, d_cat


def _ozaki_apply(c: torch.Tensor, sigma: torch.Tensor, x: torch.Tensor, *,
                 num_slices: int) -> torch.Tensor:
    """``A x`` from A's slices ``c`` (``(S, n, m_c)``, ``m_c >= m``: extra
    columns are zero) and row scales ``sigma``, for ``x`` of shape
    ``(m,)`` or ``(m, ncols)``, in ``sigma``'s dtype (fp64)."""
    f64 = sigma.dtype
    squeeze = x.dim() == 1
    x2 = x[:, None] if squeeze else x
    d, tau = _slice_vector(x2.to(f64), num_slices)
    s_tot, n, _ = c.shape
    ncols = x2.shape[1]
    # ONE int8 product gives every (s, t) pair's partial exactly
    p = int8_matmul(*_int8_operands(c, d))[: s_tot * n, : s_tot * ncols]
    p = p.reshape(s_tot, n, s_tot, ncols)
    # the fp64 combine, the one inexact step; the weights are exact powers of two
    w = torch.tensor([[2.0 ** (-(s + t + 2) * BETA) for t in range(s_tot)]
                      for s in range(s_tot)], dtype=f64, device=sigma.device)
    y = torch.einsum("sntc,st->nc", p.to(f64), w)
    y = sigma[:, None] * y * tau[None, :]
    return y[:, 0] if squeeze else y


class OzakiDenseOperator:
    """Dense fp64-quality operator from int8 slices (cgx's): ``matvec``
    of one vector or an ``(n, s)`` block through one int8 product, error
    about 2^(-7 S) of each dot's mass. ``c`` holds the slices with zero
    columns up to a multiple of 8."""

    def __init__(self, c: torch.Tensor, sigma: torch.Tensor, diag: torch.Tensor,
                 num_slices: int, n_cols: int):
        self.c = c  # (S, n, m rounded up to 8) int8
        self.sigma = sigma  # (n,) fp64 power-of-two row scales
        self._diag = diag  # (n,) fp64
        self.num_slices = num_slices
        self.n_cols = n_cols

    @classmethod
    def from_dense(cls, a: torch.Tensor, num_slices: int = 8) -> "OzakiDenseOperator":
        """Slice the dense fp64 ``a`` on its device."""
        if a.shape[1] > NMAX:
            raise ValueError(
                f"OzakiDenseOperator supports n <= {NMAX} (int32-exact accumulation); a "
                f"{a.shape[1]}-column dense matrix is {8 * a.shape[0] * a.shape[1] / 1e9:.0f} GB "
                "— use a sparse/banded operator instead")
        a = a.to(torch.float64)
        c, sigma = _build_slices(a, num_slices)
        return cls(_pad_cols(c), sigma, torch.diagonal(a).clone(), num_slices, a.shape[1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.c.shape[1], self.n_cols)

    @property
    def dtype(self):
        return self.sigma.dtype

    @property
    def device(self) -> torch.device:
        return self.sigma.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _ozaki_apply(self.c, self.sigma, x, num_slices=self.num_slices).to(x.dtype)

    def diagonal(self) -> torch.Tensor:
        return self._diag


def ozaki_matvec(a: torch.Tensor, x: torch.Tensor, *, num_slices: int = 8) -> torch.Tensor:
    """One-shot fp64-quality ``A @ x`` by the Ozaki split; slices A on
    every call (:class:`OzakiDenseOperator` slices once)."""
    a = a.to(torch.float64)
    if a.shape[1] > NMAX:
        raise ValueError(f"ozaki_matvec supports n <= {NMAX}")
    c, sigma = _build_slices(a, num_slices)
    return _ozaki_apply(c, sigma, x, num_slices=num_slices).to(x.dtype)


def build_slices_np(a, num_slices: int = 8):
    """The host (NumPy) slicing of :func:`_build_slices`, bit for bit:
    the sharded dense route slices A before its shards go to the device
    (int8, an eighth of the fp64 bytes a slice)."""
    a = np.asarray(a, np.float64)
    n, m = a.shape
    if m > NMAX:
        raise ValueError(f"Ozaki slicing supports n <= {NMAX}")
    row_max = np.max(np.abs(a), axis=1)
    safe = np.where(row_max > 0, row_max, 1.0)
    mant, e = np.frexp(safe)  # safe = mant 2^e, mant in [0.5, 1)
    # the smallest power of two >= safe, doubled so that |a_hat| <= 1/2
    pow2ceil = np.ldexp(1.0, np.where(mant == 0.5, e - 1, e))
    sigma = 2.0 * pow2ceil
    r = a / sigma[:, None]
    slices = np.empty((num_slices, n, m), np.int8)
    for s in range(num_slices):
        scale = 2.0 ** ((s + 1) * BETA)
        c = np.floor(r * scale)
        np.minimum(c, 2.0**BETA - 1.0, out=c)  # the boundary clamp of _slice_mantissa
        slices[s] = c.astype(np.int8)
        r = r - c / scale
    return slices, sigma

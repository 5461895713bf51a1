"""Device-side linear operators (counterpart of ``cgx/solver/operators.py``).

- :class:`DiaOperator`: banded ``y = sum_d bands[d] * shift(x, offsets[d])``
  in plain torch, with the zero-outside-``[0, n)`` semantics of cgx's
  ``banded_matvec`` (cgx leaves this mat-vec to XLA). The solvers that
  want the CUDA kernel call :mod:`cgx_torch.ops.dia_spmv` on its bands.
  :class:`GridDiaOperator` is one whose mat-vec shifts along the axes of
  its grid (cgx's, a subclass with the same results).
- :class:`DenseOperator`: ``A @ x`` through ``torch.matmul``.
- :class:`PallasDenseOperator`: ``A @ x`` through the dense CUDA kernel
  (:mod:`cgx_torch.ops.matvec`), with cgx's name so that a reader finds
  the counterpart; :func:`densify_on_device` builds a dense operator
  from a banded one on the device.
- :class:`EllOperator` and :class:`CsrOperator`: gather, multiply and a
  row sum in plain torch (cgx leaves both to XLA). The CSR row sum is a
  padded-row gather, so it is the same on every run: no ``index_add_``
  or ``scatter_add_``, which add floats atomically on a card.

Operators are plain dataclasses over tensors; they have nothing to
train, so they are not ``nn.Module``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.mats.containers import (
    COOMatrix,
    CSRMatrix,
    DenseMatrix,
    DIAMatrix,
    ELLMatrix,
)
from cgx_torch.ops._util import check_device, resolve_device
from cgx_torch.ops.dia_spmv import dia_matvec_ref
from cgx_torch.ops.matvec import dense_matvec

_NP_TO_TORCH = {np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32}


@dataclasses.dataclass
class DenseOperator:
    """Dense operator: ``A @ x``."""

    a: torch.Tensor  # (n, n)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.a, x)

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.a)


@dataclasses.dataclass
class DiaOperator:
    """Banded operator: ``bands[d, i] = A[i, i + offsets[d]]``."""

    bands: torch.Tensor  # (ndiag, n)
    offsets: Tuple[int, ...] = ()

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.bands.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def device(self) -> torch.device:
        return self.bands.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return dia_matvec_ref(self.bands, x, offsets=self.offsets)

    def diagonal(self) -> torch.Tensor:
        return self.bands[self.offsets.index(0)]


def _decode_grid_offsets(offsets, g: int, ndim: int, max_reach: int = 8):
    """Flat DIA offsets -> per-axis deltas on a row-major g^ndim grid
    (slowest axis first, matching the mat-vec's reshape), or None (cgx
    ``operators.py:277``, copied)."""
    out = []
    for o in offsets:
        o = int(o)
        coords = []
        rem = o
        # peel from the SLOWEST axis (stride g^(ndim-1)) down
        for axis in range(ndim - 1, 0, -1):
            step = g**axis
            d = int(round(rem / step))
            if abs(d) > max_reach:
                return None
            coords.append(d)
            rem -= d * step
        if abs(rem) > max_reach:
            return None
        coords.append(rem)
        out.append(tuple(coords))
    return out


def _wrap_positions_zero(bands: np.ndarray, offsets, deltas, g: int, ndim: int) -> bool:
    """True iff every band value at a flat position whose grid decode
    would WRAP (a per-axis coordinate leaves [0, g)) is exactly zero: the
    condition under which per-axis shifts give the flat banded mat-vec
    bit for bit (cgx ``_wrap_positions_zero``, copied)."""
    n = g**ndim
    idx = np.arange(n)
    coords = []
    rem = idx
    for axis in range(ndim):
        step = g ** (ndim - 1 - axis)
        coords.append(rem // step)
        rem = rem % step
    bands = np.asarray(bands)
    for k, (off, delta) in enumerate(zip(offsets, deltas)):
        lo, hi = max(0, -int(off)), min(n, n - int(off))
        rows = idx[lo:hi]
        ok = np.ones(hi - lo, bool)
        for axis in range(ndim):
            c = coords[axis][lo:hi] + delta[axis]
            ok &= (c >= 0) & (c < g)
        wrap = ~ok
        if wrap.any() and np.any(bands[k, rows[wrap]] != 0.0):
            return False
    return True


def _axis_shift(a: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    """shifted[c] = a[c + d] along one axis, zero (Dirichlet) fill."""
    if d == 0:
        return a
    out = torch.zeros_like(a)
    n = a.shape[axis]
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(axis, 0, n - d).copy_(a.narrow(axis, d, n - d))
    else:
        out.narrow(axis, -d, n + d).copy_(a.narrow(axis, 0, n + d))
    return out


@dataclasses.dataclass
class GridDiaOperator(DiaOperator):
    """Banded grid-stencil operator with per-axis shifts (cgx's
    ``GridDiaOperator``).

    A :class:`DiaOperator` (the same ``bands``/``offsets``, so every
    isinstance gate and banded preconditioner takes it) whose mat-vec
    shifts x along each axis of its (g,)*ndim grid, with zero fill,
    instead of along the flat vector. :func:`cgx_torch.solver.cg.cg_solve`
    keeps every vector grid-shaped when handed one and no preconditioner,
    as cgx's does; the refinement keeps the class when it lowers the
    bands; :func:`as_operator` still gives the flat :class:`DiaOperator`.

    Exactness: per-axis shifts zero the cross-row neighbours, which
    equals the flat banded product iff every band value at a would-wrap
    flat position is zero: true for the lap2d_fd / lap3d_fd families and
    every Galerkin coarse level, false for lap2d_reference's
    quasi-stencil (its +-1 band wraps). ``from_host`` checks the
    condition and refuses otherwise, with cgx's message. The sums run
    band by band in cgx's order, so the product is the flat one bit for
    bit.
    """

    g: int = 0
    ndim: int = 2
    deltas: Tuple[Tuple[int, ...], ...] = ()

    def matvec_grid(self, a: torch.Tensor) -> torch.Tensor:
        """y = A x with x and y in the (g,)*ndim layout."""
        shape = (self.g,) * self.ndim
        y = torch.zeros(shape, dtype=a.dtype, device=a.device)
        for k, delta in enumerate(self.deltas):
            s = a
            for axis, d in enumerate(delta):
                s = _axis_shift(s, axis, d)
            y = y + self.bands[k].reshape(shape) * s
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        shape = (self.g,) * self.ndim
        return self.matvec_grid(x.reshape(shape)).reshape(-1)

    @classmethod
    def from_host(cls, mat: DIAMatrix, dtype=None, *, g=None, ndim=None,
                  device="cuda") -> "GridDiaOperator":
        """From a host ``DIAMatrix`` on a square or cubic grid (``g`` and
        ``ndim`` found from N and the offsets unless given), its bands
        on ``device`` in ``dtype`` (default float64)."""
        dev = resolve_device(device)
        n = mat.shape[0]
        if ndim is None:
            for nd in (2, 3):
                s = round(n ** (1.0 / nd))
                if s**nd == n and _decode_grid_offsets(mat.offsets, s, nd):
                    ndim = nd
                    g = s
                    break
            else:
                raise ValueError(
                    f"offsets {mat.offsets} do not decode on a square/"
                    f"cubic grid of {n} points"
                )
        if g is None:
            g = round(n ** (1.0 / ndim))
        deltas = _decode_grid_offsets(mat.offsets, g, ndim)
        if deltas is None:
            raise ValueError(
                f"offsets {mat.offsets} do not decode on the {g}^{ndim} grid"
            )
        if not _wrap_positions_zero(mat.bands, mat.offsets, deltas, g, ndim):
            raise ValueError(
                "band values at wrapping flat positions are nonzero "
                "(e.g. lap2d_reference's quasi-stencil) — the grid "
                "shifts would change the product; use DiaOperator"
            )
        return cls(
            torch.tensor(np.asarray(mat.bands), dtype=_torch_dtype(dtype, torch.float64),
                         device=dev).contiguous(),
            tuple(int(o) for o in mat.offsets),
            int(g),
            int(ndim),
            tuple(tuple(int(d) for d in dd) for dd in deltas),
        )


@dataclasses.dataclass
class PallasDenseOperator:
    """Dense operator through the hand-written dense mat-vec kernel; the
    tile sizes fix its summation grouping (cgx's ``PallasDenseOperator``,
    whose name it keeps)."""

    a: torch.Tensor  # (n, n), contiguous
    block_rows: int = 256
    block_cols: int = 512

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return dense_matvec(self.a, x, block_rows=self.block_rows, block_cols=self.block_cols)

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.a)


def densify_on_device(op: DiaOperator, dtype=None) -> DenseOperator:
    """A banded operator as a dense (n, n) matrix built on its own
    device from the bands: O(ndiag n) bytes cross to the device instead
    of O(n^2)."""
    bands = op.bands if dtype is None else op.bands.to(_torch_dtype(dtype, None))
    n = bands.shape[1]
    a = torch.zeros((n, n), dtype=bands.dtype, device=bands.device)
    for d, off in enumerate(op.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        a.diagonal(off).add_(bands[d, lo:hi])
    return DenseOperator(a)


@dataclasses.dataclass
class EllOperator:
    """ELLPACK operator: gather, multiply, and a sum over each (n, K) row."""

    values: torch.Tensor  # (n, K)
    indices: torch.Tensor  # int64 (n, K)

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.values.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.values * x[self.indices], dim=1)

    def diagonal(self) -> torch.Tensor:
        rows = torch.arange(self.values.shape[0], device=self.indices.device)[:, None]
        return torch.sum(torch.where(self.indices == rows, self.values, 0.0), dim=1)

    @classmethod
    def from_host(cls, mat: ELLMatrix, dtype=None, *, device="cuda") -> "EllOperator":
        dev = resolve_device(device)
        return cls(
            torch.tensor(mat.values, dtype=_torch_dtype(dtype, torch.float64), device=dev),
            torch.tensor(mat.indices, dtype=torch.int64, device=dev),
        )


@dataclasses.dataclass
class CsrOperator:
    """CSR operator: ``values * x[indices]`` summed by row.

    cgx sums by row with ``segment_sum`` over the expanded row ids. Here
    each row's products are gathered into a padded (n, K) table (K the
    longest row; the pad points at a zero) and summed along it, which
    fixes the order of every sum."""

    values: torch.Tensor  # (nnz,)
    indices: torch.Tensor  # int64 (nnz,) column ids
    row_ids: torch.Tensor  # int64 (nnz,) expanded row ids, ascending
    n: int
    slots: Optional[torch.Tensor] = None  # int64 (n, K) into the products; nnz is the pad

    def __post_init__(self):
        if self.slots is None:
            nnz = self.values.shape[0]
            counts = torch.bincount(self.row_ids, minlength=self.n)
            start = torch.cumsum(counts, 0) - counts
            width = max(int(counts.max()), 1) if self.n else 1
            slots = torch.full((self.n, width), nnz, dtype=torch.int64, device=self.values.device)
            pos = torch.arange(nnz, device=self.values.device)
            slots[self.row_ids, pos - start[self.row_ids]] = pos
            self.slots = slots

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def _row_sum(self, prods: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.cat([prods, prods.new_zeros(1)])[self.slots], dim=1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._row_sum(self.values * x[self.indices])

    def diagonal(self) -> torch.Tensor:
        return self._row_sum(torch.where(self.indices == self.row_ids, self.values, 0.0))

    @classmethod
    def from_host(cls, mat: CSRMatrix, dtype=None, *, device="cuda") -> "CsrOperator":
        dev = resolve_device(device)
        lengths = np.diff(mat.indptr)
        row_ids = np.repeat(np.arange(mat.shape[0]), lengths)
        return cls(
            torch.tensor(mat.values, dtype=_torch_dtype(dtype, torch.float64), device=dev),
            torch.tensor(mat.indices, dtype=torch.int64, device=dev),
            torch.tensor(row_ids, dtype=torch.int64, device=dev),
            n=mat.shape[0],
        )


def _torch_dtype(dtype, default: torch.dtype) -> torch.dtype:
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def operator_from_numpy(
    arr: np.ndarray,
    offsets: Optional[Tuple[int, ...]] = None,
    *,
    dtype=None,
    device="cuda",
):
    """The port's operator from the NumPy arrays of a cgx operator, on
    an explicit device and dtype (default: the array's own dtype).

    - ``operator_from_numpy(np.asarray(op.bands), op.offsets)`` for a
      cgx ``DiaOperator``;
    - ``operator_from_numpy(np.asarray(op.a))`` for a cgx ``DenseOperator``.
    """
    dev = resolve_device(device)
    arr = np.asarray(arr)
    own = _NP_TO_TORCH.get(arr.dtype, torch.float64)
    t = torch.tensor(arr, dtype=_torch_dtype(dtype, own), device=dev)  # a copy
    if offsets is None:
        if t.dim() != 2 or t.shape[0] != t.shape[1]:
            raise ValueError(f"a dense operator needs a square matrix, got {tuple(t.shape)}")
        return DenseOperator(t)
    offsets = tuple(int(o) for o in offsets)
    if t.dim() != 2 or t.shape[0] != len(offsets):
        raise ValueError(f"bands of shape {tuple(t.shape)} do not match {len(offsets)} offsets")
    return DiaOperator(t.contiguous(), offsets)


def as_operator(mat, dtype=None, *, device="cuda"):
    """The natural device operator for a host container, an ndarray or a
    2-D tensor (counterpart of ``cgx.as_operator``). A tensor must
    already be on ``device``."""
    dev = resolve_device(device)
    if isinstance(mat, DIAMatrix):
        return operator_from_numpy(mat.bands, mat.offsets, dtype=dtype or torch.float64,
                                   device=dev)
    if isinstance(mat, (DenseMatrix, np.ndarray)):
        a = mat.a if isinstance(mat, DenseMatrix) else mat
        return operator_from_numpy(a, dtype=dtype or torch.float64, device=dev)
    if isinstance(mat, torch.Tensor) and mat.dim() == 2:
        check_device(mat, dev, "the matrix")
        return DenseOperator(mat if dtype is None else mat.to(_torch_dtype(dtype, None)))
    if isinstance(mat, ELLMatrix):
        return EllOperator.from_host(mat, dtype, device=dev)
    if isinstance(mat, CSRMatrix):
        return CsrOperator.from_host(mat, dtype, device=dev)
    if isinstance(mat, COOMatrix):
        return CsrOperator.from_host(CSRMatrix.from_coo(mat), dtype, device=dev)
    # scipy.sparse, duck-typed on tocoo as cgx does (no scipy import)
    if hasattr(mat, "tocoo") and hasattr(mat, "shape"):
        coo = COOMatrix.from_scipy(mat)
        return CsrOperator.from_host(CSRMatrix.from_coo(coo), dtype, device=dev)
    raise TypeError(f"no operator mapping for {type(mat)}")


def operator_from_cgx(op, *, dtype=None, device="cuda"):
    """The port's counterpart of a cgx operator, from its arrays (read
    with ``np.asarray``; nothing of cgx is imported): ``DiaOperator``,
    ``DenseOperator``, ``PallasDenseOperator`` (tiles kept),
    ``EllOperator`` and ``CsrOperator``. The dtype defaults to the
    arrays' own."""
    dev = resolve_device(device)

    def values(arr):
        arr = np.asarray(arr)
        return torch.tensor(arr, dtype=_torch_dtype(dtype, _NP_TO_TORCH.get(arr.dtype,
                                                                            torch.float64)),
                            device=dev)

    def ints(arr):
        return torch.tensor(np.asarray(arr), dtype=torch.int64, device=dev)

    if hasattr(op, "bands"):
        return operator_from_numpy(op.bands, op.offsets, dtype=dtype, device=dev)
    if hasattr(op, "block_rows"):
        return PallasDenseOperator(values(op.a).contiguous(), int(op.block_rows),
                                   int(op.block_cols))
    if hasattr(op, "a"):
        return operator_from_numpy(op.a, dtype=dtype, device=dev)
    if hasattr(op, "row_ids"):
        return CsrOperator(values(op.values), ints(op.indices), ints(op.row_ids), n=int(op.n))
    if hasattr(op, "indices"):
        return EllOperator(values(op.values), ints(op.indices))
    raise TypeError(f"no port counterpart for {type(op)}")


def basis_from_cgx(basis, op):
    """The port's :class:`~cgx_torch.solver.deflated.DeflationBasis` of
    ``op`` (a port operator, on its device) from a cgx
    ``DeflationBasis``: its W read with ``np.asarray`` (nothing of cgx is
    imported), and AW, the (k, k) inverse and (AW)^T AW rebuilt here in
    the operator's dtype."""
    from cgx_torch.solver.deflated import DeflationBasis

    return DeflationBasis(op, np.asarray(basis.w))

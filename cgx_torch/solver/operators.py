"""Device-side linear operators (counterpart of ``cgx/solver/operators.py``).

- :class:`DiaOperator`: banded ``y = sum_d bands[d] * shift(x, offsets[d])``
  in plain torch, with the zero-outside-``[0, n)`` semantics of cgx's
  ``banded_matvec`` (cgx leaves this mat-vec to XLA). The solvers that
  want the CUDA kernel call :mod:`cgx_torch.ops.dia_spmv` on its bands.
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

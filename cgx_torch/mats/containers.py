"""Matrix containers (reference L1) as host-side NumPy structures.

A NumPy copy of ``cgx/mats/containers.py``: the port cannot import the
original without importing JAX.

The reference has two containers — a COO triplet store with a serial
SpMV oracle (matrix_coo.hh:22-34, never called from the hot path) and a
row-major dense matrix produced by a COO->dense scatter with symmetric
mirror fill (matrix.cc:12-21). We keep both, and add the formats that
actually map well to TPU compute:

- ``CSR``      — classic compressed rows (host-side / interop).
- ``ELLPACK``  — fixed-width (N, K) data+index planes: dense-shaped, so
                 the SpMV becomes a gather + VPU multiply-reduce.
- ``DIA``      — diagonal/banded storage: for stencil matrices (the
                 reference's only matrices — 5-point Laplacians) the
                 SpMV is a handful of shifted element-wise AXPYs: no
                 gather at all, pure VPU streaming. This is the
                 TPU-native flagship format.

Device-side operators over these containers live in
:mod:`cgx_torch.solver.operators`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

from cgx_torch.io import mmio


@dataclasses.dataclass
class COOMatrix:
    """COO triplets, stored-triangle only for symmetric inputs
    (mirrors MatrixCOO: irn/jcn/a matrix_coo.hh:36-38 + is_sym flag)."""

    shape: Tuple[int, int]
    rows: np.ndarray  # int32 (nnz,)
    cols: np.ndarray  # int32 (nnz,)
    values: np.ndarray  # float64 (nnz,)
    symmetric: bool = False

    @classmethod
    def read(cls, filename) -> "COOMatrix":
        """Load from a MatrixMarket file (MatrixCOO::read parity,
        matrix_coo.cc:7-58: requires a sparse coordinate matrix)."""
        data = mmio.mmread(filename)
        if not data.typecode.is_sparse:
            raise mmio.MMIOError("expected a sparse (coordinate) matrix")
        if data.typecode.is_skew:
            # the container's mirror fill is +value (matrix.cc:18-20
            # parity); silently reconstructing a skew matrix with it
            # would be wrong, and CG needs SPD anyway
            raise mmio.MMIOError(
                "skew-symmetric matrices are not supported by COOMatrix "
                "(CG requires symmetric positive definite input)"
            )
        return cls(
            shape=data.shape,
            rows=data.rows,
            cols=data.cols,
            values=data.values,
            symmetric=data.typecode.is_symmetric,
        )

    def mat_vec(self, x: np.ndarray) -> np.ndarray:
        """Serial COO SpMV oracle with the symmetric double-update
        (matrix_coo.hh:22-34). Used as a correctness oracle in tests."""
        y = np.zeros(self.shape[0], dtype=np.result_type(self.values, x))
        np.add.at(y, self.rows, self.values * x[self.cols])
        if self.symmetric:
            off = self.rows != self.cols
            np.add.at(y, self.cols[off], self.values[off] * x[self.rows[off]])
        return y

    @classmethod
    def from_scipy(cls, sp) -> "COOMatrix":
        """Convert any ``scipy.sparse`` matrix (the de-facto host
        sparse interchange format). The full matrix is stored
        (symmetric=False): scipy formats carry both triangles."""
        coo = sp.tocoo()
        return cls(
            shape=tuple(int(d) for d in coo.shape),
            rows=np.asarray(coo.row, np.int32),
            cols=np.asarray(coo.col, np.int32),
            values=np.asarray(coo.data, np.float64),
            symmetric=False,
        )

    def to_scipy(self):
        """As ``scipy.sparse.coo_matrix`` (mirrored if symmetric —
        scipy carries both triangles explicitly)."""
        import scipy.sparse as sps

        exp = self.expanded()
        return sps.coo_matrix(
            (exp.values, (exp.rows, exp.cols)), shape=self.shape
        )

    def to_dense(self) -> np.ndarray:
        """COO -> dense scatter with symmetric mirror (Matrix::read parity,
        matrix.cc:12-21)."""
        m, n = self.shape
        a = np.zeros((m, n), dtype=np.float64)
        a[self.rows, self.cols] = self.values
        if self.symmetric:
            a[self.cols, self.rows] = self.values
        return a

    def expanded(self) -> "COOMatrix":
        """Return a general (non-symmetric-storage) COO with both triangles."""
        if not self.symmetric:
            return self
        off = self.rows != self.cols
        rows = np.concatenate([self.rows, self.cols[off]])
        cols = np.concatenate([self.cols, self.rows[off]])
        vals = np.concatenate([self.values, self.values[off]])
        return COOMatrix(self.shape, rows.astype(np.int32), cols.astype(np.int32), vals, False)

    def write(self, filename, comment: str = "") -> None:
        mmio.mmwrite(
            filename,
            self.shape,
            self.rows,
            self.cols,
            self.values,
            symmetry="symmetric" if self.symmetric else "general",
            comment=comment,
        )


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse rows (always fully expanded, no symmetric storage)."""

    shape: Tuple[int, int]
    indptr: np.ndarray  # int32 (m+1,)
    indices: np.ndarray  # int32 (nnz,)
    values: np.ndarray  # float64 (nnz,)

    @classmethod
    def from_coo(cls, coo: COOMatrix) -> "CSRMatrix":
        coo = coo.expanded()
        m, n = coo.shape
        order = np.lexsort((coo.cols, coo.rows))
        rows = coo.rows[order]
        cols = coo.cols[order]
        vals = coo.values[order]
        counts = np.bincount(rows, minlength=m)
        indptr = np.zeros(m + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return cls((m, n), indptr, cols.astype(np.int32), vals)

    def mat_vec(self, x: np.ndarray) -> np.ndarray:
        y = np.empty(self.shape[0], dtype=np.result_type(self.values, x))
        prod = self.values * x[self.indices]
        for i in range(self.shape[0]):
            y[i] = prod[self.indptr[i] : self.indptr[i + 1]].sum()
        return y

    @property
    def max_row_nnz(self) -> int:
        return int(np.max(np.diff(self.indptr))) if self.shape[0] else 0


@dataclasses.dataclass
class ELLMatrix:
    """ELLPACK: fixed-width (m, K) planes — dense-shaped sparse storage.

    Rows shorter than K are padded with value 0 pointing at column 0
    (harmless in the multiply because the padded value is zero).
    """

    shape: Tuple[int, int]
    indices: np.ndarray  # int32 (m, K)
    values: np.ndarray  # float64 (m, K)

    @classmethod
    def from_coo(cls, coo: COOMatrix) -> "ELLMatrix":
        csr = CSRMatrix.from_coo(coo)
        m, n = csr.shape
        k = max(csr.max_row_nnz, 1)
        idx = np.zeros((m, k), dtype=np.int32)
        val = np.zeros((m, k), dtype=np.float64)
        lengths = np.diff(csr.indptr)
        cols_of_row = np.arange(len(csr.indices)) - np.repeat(csr.indptr[:-1], lengths)
        row_of = np.repeat(np.arange(m), lengths)
        idx[row_of, cols_of_row] = csr.indices
        val[row_of, cols_of_row] = csr.values
        return cls((m, n), idx, val)

    def mat_vec(self, x: np.ndarray) -> np.ndarray:
        return (self.values * x[self.indices]).sum(axis=1)


@dataclasses.dataclass
class DIAMatrix:
    """Diagonal (banded) storage: ``bands[d, i] = A[i, i + offsets[d]]``.

    The TPU-native format for stencil matrices: the SpMV is
    ``sum_d bands[d] * shift(x, offsets[d])`` — static shifts the XLA
    fuses into a single VPU pass, no gathers, no atomics (the Pallas
    kernel lives in cgx_torch/ops/dia_spmv.py).

    Entries of ``bands`` that fall outside the matrix (i + off < 0 or
    >= n) are stored as zero.
    """

    shape: Tuple[int, int]
    offsets: Tuple[int, ...]  # static diagonal offsets, sorted
    bands: np.ndarray  # float64 (ndiag, n)

    @classmethod
    def from_coo(cls, coo: COOMatrix) -> "DIAMatrix":
        coo = coo.expanded()
        m, n = coo.shape
        if m != n:
            raise ValueError("DIA storage requires a square matrix")
        offs = np.unique(coo.cols.astype(np.int64) - coo.rows.astype(np.int64))
        bands = np.zeros((len(offs), n), dtype=np.float64)
        pos = np.searchsorted(offs, coo.cols.astype(np.int64) - coo.rows.astype(np.int64))
        bands[pos, coo.rows] = coo.values
        return cls((m, n), tuple(int(o) for o in offs), bands)

    def mat_vec(self, x: np.ndarray) -> np.ndarray:
        n = self.shape[0]
        y = np.zeros(n, dtype=np.result_type(self.bands, x))
        for d, off in enumerate(self.offsets):
            lo = max(0, -off)
            hi = min(n, n - off)
            y[lo:hi] += self.bands[d, lo:hi] * x[lo + off : hi + off]
        return y

    def to_dense(self) -> np.ndarray:
        n = self.shape[0]
        a = np.zeros((n, n), dtype=np.float64)
        for d, off in enumerate(self.offsets):
            lo = max(0, -off)
            hi = min(n, n - off)
            rows = np.arange(lo, hi)
            a[rows, rows + off] = self.bands[d, lo:hi]
        return a


class DenseMatrix:
    """Row-major dense matrix (Matrix parity: matrix.hh:7-29).

    ``read`` performs the COO->dense conversion with symmetric mirror
    fill exactly as Matrix::read (matrix.cc:6-22)."""

    def __init__(self, a: np.ndarray | None = None):
        self.a = np.zeros((0, 0), dtype=np.float64) if a is None else np.asarray(a, dtype=np.float64)

    @classmethod
    def read(cls, filename) -> "DenseMatrix":
        return cls(COOMatrix.read(filename).to_dense())

    def resize(self, m: int, n: int) -> None:
        self.a = np.zeros((m, n), dtype=np.float64)

    @property
    def m(self) -> int:
        return self.a.shape[0]

    @property
    def n(self) -> int:
        return self.a.shape[1]

    def __call__(self, i: int, j: int) -> float:
        return self.a[i, j]

    def mat_vec(self, x: np.ndarray) -> np.ndarray:
        return self.a @ x


AnyMatrix = Union[COOMatrix, CSRMatrix, ELLMatrix, DIAMatrix, DenseMatrix]

"""MatrixMarket I/O: a NumPy copy of ``cgx/io/mmio.py``.

The port keeps its own copy because importing anything of ``cgx`` runs
``cgx/__init__.py``, which imports JAX.

A from-scratch MatrixMarket (``.mtx``) reader/writer with the same
surface as the NIST ``mmio`` C library used by the reference
(reference: code/{MPI,CUDA}/mmio.{c,h} — banner state machine
``mm_read_banner`` mmio.c:96-179, size line ``mm_read_mtx_crd_size``
mmio.c:189, typecode queries mmio.h:30-47) and the subset consumed by
the reference loader (``MatrixCOO::read`` matrix_coo.cc:7-58: sparse
coordinate real matrices, general or symmetric, 1-based indices).

Parsing is vectorised with NumPy. The native C++ parser,
:mod:`cgx_torch.io.native`, takes large files when it builds; this
module is its fallback.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Tuple, Union

import numpy as np

_BANNER_PREFIX = "%%MatrixMarket"

_OBJECTS = ("matrix", "vector")
_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "complex", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


class MMIOError(Exception):
    """Malformed MatrixMarket input (the reference aborts with exit(1),
    matrix_coo.cc:16-33; we raise instead)."""


@dataclasses.dataclass(frozen=True)
class Typecode:
    """Parsed banner typecode — the analogue of the 4-char ``MM_typecode``
    state machine in mmio.h:50-66."""

    object: str = "matrix"
    format: str = "coordinate"
    field: str = "real"
    symmetry: str = "general"

    @property
    def is_matrix(self) -> bool:
        return self.object == "matrix"

    @property
    def is_sparse(self) -> bool:
        return self.format == "coordinate"

    @property
    def is_dense(self) -> bool:
        return self.format == "array"

    @property
    def is_real(self) -> bool:
        return self.field == "real"

    @property
    def is_integer(self) -> bool:
        return self.field == "integer"

    @property
    def is_pattern(self) -> bool:
        return self.field == "pattern"

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"

    @property
    def is_skew(self) -> bool:
        return self.symmetry == "skew-symmetric"

    @property
    def is_general(self) -> bool:
        return self.symmetry == "general"

    def banner(self) -> str:
        return f"{_BANNER_PREFIX} {self.object} {self.format} {self.field} {self.symmetry}"


def read_banner(line: str) -> Typecode:
    """Parse the ``%%MatrixMarket`` banner line (mm_read_banner parity)."""
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != _BANNER_PREFIX:
        raise MMIOError(f"not a MatrixMarket banner: {line!r}")
    obj, fmt, field, sym = (p.lower() for p in parts[1:])
    if obj not in _OBJECTS:
        raise MMIOError(f"unsupported object {obj!r}")
    if fmt not in _FORMATS:
        raise MMIOError(f"unsupported format {fmt!r}")
    if field not in _FIELDS:
        raise MMIOError(f"unsupported field {field!r}")
    if sym not in _SYMMETRIES:
        raise MMIOError(f"unsupported symmetry {sym!r}")
    return Typecode(obj, fmt, field, sym)


@dataclasses.dataclass
class MMData:
    """Result of reading a MatrixMarket file.

    For ``coordinate`` format, ``rows``/``cols`` are 0-based int32 index
    arrays (the reference converts 1-based to 0-based at
    matrix_coo.cc:48-50) and ``values`` are float64 (ones for
    ``pattern`` files). Only the stored triangle is kept for symmetric
    files — mirroring is the container's job (matrix.cc:12-21).
    For ``array`` format, ``dense`` holds the column-major-read matrix.
    """

    typecode: Typecode
    shape: Tuple[int, int]
    nnz: int
    rows: np.ndarray | None = None
    cols: np.ndarray | None = None
    values: np.ndarray | None = None
    dense: np.ndarray | None = None


def _iter_data_lines(f) -> Tuple[str, list]:
    banner = f.readline()
    if not banner:
        raise MMIOError("empty file")
    return banner, f


def mmread(source: Union[str, os.PathLike, _io.IOBase]) -> MMData:
    """Read a MatrixMarket file (sparse coordinate or dense array)."""
    if hasattr(source, "read"):
        return _mmread_stream(source)
    with open(source, "r") as f:
        return _mmread_stream(f)


def _mmread_stream(f) -> MMData:
    banner_line = f.readline()
    tc = read_banner(banner_line)
    if not tc.is_matrix:
        raise MMIOError("only 'matrix' objects are supported")
    if tc.field == "complex":
        raise MMIOError("complex matrices are not supported")

    # Skip comment lines ('%') and blank lines; next token line is sizes.
    size_line = ""
    for line in f:
        s = line.strip()
        if s and not s.startswith("%"):
            size_line = s
            break
    if not size_line:
        raise MMIOError("missing size line")

    rest = f.read()
    if tc.is_sparse:
        parts = size_line.split()
        if len(parts) != 3:
            raise MMIOError(f"bad coordinate size line: {size_line!r}")
        m, n, nnz = (int(p) for p in parts)
        if tc.is_pattern:
            try:
                flat = np.fromiter((int(t) for t in rest.split()), dtype=np.int64)
            except ValueError as e:
                raise MMIOError(f"bad pattern entry: {e}") from e
            if flat.size != 2 * nnz:
                raise MMIOError(f"expected {2*nnz} indices, got {flat.size}")
            ij = flat.reshape(nnz, 2)
            rows = (ij[:, 0] - 1).astype(np.int32)
            cols = (ij[:, 1] - 1).astype(np.int32)
            vals = np.ones(nnz, dtype=np.float64)
        else:
            try:
                flat = np.fromiter((float(t) for t in rest.split()), dtype=np.float64)
            except ValueError as e:
                raise MMIOError(f"bad matrix entry: {e}") from e
            if flat.size != 3 * nnz:
                raise MMIOError(f"expected {3*nnz} tokens, got {flat.size}")
            tri = flat.reshape(nnz, 3)
            rows = (tri[:, 0].astype(np.int64) - 1).astype(np.int32)
            cols = (tri[:, 1].astype(np.int64) - 1).astype(np.int32)
            vals = np.ascontiguousarray(tri[:, 2])
        if nnz and (rows.min() < 0 or cols.min() < 0 or rows.max() >= m or cols.max() >= n):
            raise MMIOError("index out of bounds")
        return MMData(tc, (m, n), nnz, rows=rows, cols=cols, values=vals)

    # dense "array" format: column-major listing of m*n entries
    parts = size_line.split()
    if len(parts) != 2:
        raise MMIOError(f"bad array size line: {size_line!r}")
    m, n = (int(p) for p in parts)
    try:
        flat = np.fromiter((float(t) for t in rest.split()), dtype=np.float64)
    except ValueError as e:
        raise MMIOError(f"bad matrix entry: {e}") from e
    if flat.size != m * n:
        raise MMIOError(f"expected {m*n} entries, got {flat.size}")
    dense = flat.reshape(n, m).T  # column-major on disk
    if tc.is_symmetric or tc.is_skew:
        # stored triangle only is also legal for array format; we require full
        raise MMIOError("symmetric dense array files are not supported")
    return MMData(tc, (m, n), m * n, dense=dense)


def mmwrite(
    target: Union[str, os.PathLike, _io.IOBase],
    shape: Tuple[int, int],
    rows: np.ndarray,
    cols: np.ndarray,
    values: np.ndarray,
    symmetry: str = "general",
    comment: str = "",
) -> None:
    """Write a sparse coordinate real MatrixMarket file (mm_write_banner /
    crd parity, mmio.h:24-26). Indices are 0-based in memory, 1-based on
    disk. For ``symmetry='symmetric'`` the caller passes the lower
    triangle only (the convention of the reference's test matrix
    lap2D_5pt_n100.mtx)."""
    if symmetry not in _SYMMETRIES:
        raise MMIOError(f"unsupported symmetry {symmetry!r}")
    tc = Typecode("matrix", "coordinate", "real", symmetry)
    own = not hasattr(target, "write")
    f = open(target, "w") if own else target
    try:
        f.write(tc.banner() + "\n")
        for line in comment.splitlines():
            f.write(f"%{line}\n")
        f.write(f"{shape[0]} {shape[1]} {len(values)}\n")
        r1 = np.asarray(rows, dtype=np.int64) + 1
        c1 = np.asarray(cols, dtype=np.int64) + 1
        v = np.asarray(values, dtype=np.float64)
        chunks = []
        for i in range(0, len(v), 65536):
            sl = slice(i, i + 65536)
            chunks.append(
                "\n".join(
                    f"{a} {b} {c:.17g}" for a, b, c in zip(r1[sl], c1[sl], v[sl])
                )
            )
        body = "\n".join(ch for ch in chunks if ch)
        if body:
            f.write(body + "\n")
    finally:
        if own:
            f.close()

"""ctypes bindings for the native MatrixMarket parser (counterpart of
``cgx/io/native.py``).

The reference's L0 is native code (NIST mmio.c, vendored in both build
trees). The port keeps its own copy of cgx's C++ parser,
``cgx_torch/_native/mmio.cc``, and builds it with ``g++`` (cgx's
Makefile flags) at its first use into ``build/cgx_torch/``, under a name
keyed by a hash of the source and the flags; nothing is written beside
the source. The library is compiled to a temporary name in that
directory and renamed into place, so a process that loads it while
another builds it sees a whole file. :mod:`cgx_torch.io.mmio` is the
NumPy fallback: :func:`mmread_auto` takes the native parser for files
of 1 MiB and more when the library builds, and the NumPy one otherwise.

Set ``CGX_NO_NATIVE=1`` (cgx's variable) to force the NumPy parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from cgx_torch import _build
from cgx_torch.io import mmio as _py

SOURCE = Path(__file__).resolve().parent.parent / "_native" / "mmio.cc"
CXXFLAGS = ("-O3", "-Wall", "-Wextra", "-Werror", "-std=c++17", "-fPIC", "-shared")
BUILD_DIR = _build.BUILD_DIR  # where the library goes; tests point it elsewhere
_NATIVE_THRESHOLD_BYTES = 1 << 20  # prefer native above 1 MiB

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


class _CgxMMData(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int32),
        ("n", ctypes.c_int32),
        ("nnz", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int32)),
        ("cols", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("is_sparse", ctypes.c_int32),
        ("is_symmetric", ctypes.c_int32),
        ("is_skew", ctypes.c_int32),
        ("is_pattern", ctypes.c_int32),
        ("error", ctypes.c_char * 256),
    ]


def library_path() -> Path:
    """The library's path in :data:`BUILD_DIR`, named by a hash of the
    source and the compiler flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(BUILD_DIR) / f"libcgxmmio_{h.hexdigest()[:16]}.so"


def _compile(lib: Path) -> None:
    """g++ into a temporary name beside ``lib``, then an atomic rename."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=lib.name + ".", suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *CXXFLAGS, "-o", tmp, str(SOURCE)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _build_failed
    if os.environ.get("CGX_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists():
            try:
                _compile(path)
            except (subprocess.SubprocessError, OSError):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.cgx_mm_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_CgxMMData)]
        lib.cgx_mm_read.restype = ctypes.c_int
        lib.cgx_mm_free.argtypes = [ctypes.POINTER(_CgxMMData)]
        lib.cgx_mm_free.restype = None
        lib.cgx_mm_write.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
            ctypes.c_char_p,
        ]
        lib.cgx_mm_write.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def mmread_native(path) -> _py.MMData:
    """Read a MatrixMarket file through the C++ parser."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native mmio library unavailable")
    data = _CgxMMData()
    rc = lib.cgx_mm_read(os.fspath(path).encode(), ctypes.byref(data))
    if rc != 0:
        msg = data.error.decode(errors="replace") or f"error {rc}"
        raise _py.MMIOError(f"{msg} ({path})")
    try:
        sym = (
            "symmetric"
            if data.is_symmetric
            else ("skew-symmetric" if data.is_skew else "general")
        )
        if data.is_sparse:
            tc = _py.Typecode(
                "matrix",
                "coordinate",
                "pattern" if data.is_pattern else "real",
                sym,
            )
            nnz = int(data.nnz)
            rows = np.ctypeslib.as_array(data.rows, shape=(nnz,)).copy() if nnz else np.empty(0, np.int32)
            cols = np.ctypeslib.as_array(data.cols, shape=(nnz,)).copy() if nnz else np.empty(0, np.int32)
            vals = np.ctypeslib.as_array(data.values, shape=(nnz,)).copy() if nnz else np.empty(0, np.float64)
            return _py.MMData(
                tc, (int(data.m), int(data.n)), nnz, rows=rows, cols=cols, values=vals
            )
        tc = _py.Typecode("matrix", "array", "real", sym)
        m, n = int(data.m), int(data.n)
        flat = np.ctypeslib.as_array(data.values, shape=(m * n,)).copy()
        return _py.MMData(tc, (m, n), m * n, dense=flat.reshape(n, m).T)
    finally:
        lib.cgx_mm_free(ctypes.byref(data))


def mmwrite_native(path, shape, rows, cols, values, symmetric=False, comment=""):
    lib = _load()
    if lib is None:
        raise RuntimeError("native mmio library unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    rc = lib.cgx_mm_write(
        os.fspath(path).encode(),
        shape[0],
        shape[1],
        len(values),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        1 if symmetric else 0,
        comment.encode(),
    )
    if rc != 0:
        raise _py.MMIOError(f"native writer failed with code {rc}")


def mmread_auto(path) -> _py.MMData:
    """Native parser for large files when available, NumPy otherwise."""
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if size >= _NATIVE_THRESHOLD_BYTES and native_available():
        return mmread_native(path)
    return _py.mmread(path)

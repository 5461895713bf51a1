"""Build and bind the hand-written CUDA kernels of ``cgx_torch/csrc``.

Each ``.cu`` source compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The libraries go to
``build/cgx_torch/`` at the root of the checkout, named by a hash of
the sources, headers and flags, so an edited source rebuilds. All
sources compile at once, one ``nvcc`` process each. Nothing here runs
at import time: :func:`load` builds on the first CUDA call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cgx_torch"
# -fmad=false: each product and each sum rounds on its own, as in the
# plain versions and in cgx's XLA code, so a kernel's vectors equal its
# plain version's bit for bit and the recurrence departs from the
# reference only through the dots' summation order. Near the fp64
# floor that matters: with contraction on, lap2d_fd(100) at tol 1e-10
# took k=459 on an H100 against the golden 488. The kernels are
# memory-bound, so the separate roundings cost nothing measurable.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Must be at least the kMaxBlocks of csrc/common.cuh: the dot kernels
# write one partial per block. The C entries refuse a smaller buffer.
PARTIALS = 1024

_p = ctypes.c_void_p
_n = ctypes.c_longlong
_offs = ctypes.POINTER(ctypes.c_longlong)
_i = ctypes.c_int
_d = ctypes.c_double
_i_out = ctypes.POINTER(ctypes.c_int)
_d_in = ctypes.POINTER(ctypes.c_double)
# C signature of each entry point (both _f32 and _f64 unless _ONLY says), by source.
_SIGNATURES = {
    "dia_spmv": {
        "cgx_dia_matvec": (_p, _p, _p, _n, _offs, _i, _p),
        "cgx_dia_matvec_dot": (_p, _p, _p, _p, _n, _p, _p, _n, _offs, _i, _p),
    },
    "dia_stream": {
        "cgx_dia_matvec_stream": (_p, _n, _p, _p, _n, _offs, _i, _offs, _i, _i, _p),
        "cgx_dia_matvec_stream_dot": (_p, _n, _p, _p, _n, _offs, _i, _offs, _i, _i, _p, _n, _p,
                                      _p, _p),
    },
    "axpy": {
        "cgx_fused_update_rs": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _p, _n, _p),
        "cgx_fused_axpby": (_p, _p, _p, _p, _p, _n, _p),
    },
    "matvec": {
        "cgx_dense_matvec": (_p, _p, _p, _n, _n, _n, _n, _n, _i, _i, _i, _i, _p),
        "cgx_dense_matvec_dot": (_p, _p, _p, _n, _n, _n, _n, _n, _i, _i, _i, _i, _p, _p, _p, _p,
                                 _n, _p),
    },
    "cg_kernel": {
        "cgx_dia_cg_chunk": (_p, _p, _p, _p, _p, _p, _p, _n, _p, _p, _n, _offs, _i, _i,
                             _d, _d, _d, _i, _i, _i_out, _p),
        "cgx_dia_cg_resident": (_p, _p, _p, _p, _p, _p, _n, _p, _p, _p, _n, _offs, _i, _i, _d, _d,
                                _d, _i, _i, _offs, _i, _i, _i, _p),
    },
    "cg_stream": {
        "cgx_cg_stream": (_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _p, _n, _offs,
                          _i, _i, _d, _d, _d, _i, _i_out, _p),
        "cgx_pcg_wave": (_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _p, _n, _offs, _i,
                         _d, _d, _d, _offs, _i, _i, _p),
    },
    "dia_powers": {
        "cgx_dia_sstep_basis": (_p, _p, _p, _p, _p, _n, _n, _offs, _i, _i, _d, _d, _d_in, _i,
                                _n, _i, _p),
        "cgx_dia_sstep_basis_wave": (_p, _p, _p, _p, _n, _offs, _i, _i, _d, _d, _d_in, _i, _offs,
                                     _i, _i, _p),
    },
    "sstep_stream": {
        "cgx_sstep_gram": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _n, _p, _n, _offs, _i, _i, _d,
                           _d, _d_in, _i, _d, _d, _d, _n, _i, _p),
        "cgx_sstep_gram_wave": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _n, _offs, _i, _i, _d,
                                _d, _d_in, _i, _d, _d, _d, _offs, _i, _i, _p),
        "cgx_sstep_replay": (_p, _p, _i, _d, _d, _d, _p),
    },
    "sstep_recover": {
        "cgx_sstep_recover": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _n, _offs, _i, _i, _d, _d,
                              _d_in, _i, _n, _i, _p),
        "cgx_sstep_recover_wave": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _offs, _i, _i, _d, _d,
                                   _d_in, _i, _offs, _i, _i, _p),
    },
}
# Entries that also take bfloat16 bands under float32 vectors, bound with
# this suffix (cgx_torch.ops._util.BF16_BANDS_SUFFIX).
_BF16_BANDS = ("cgx_dia_cg_chunk", "cgx_dia_cg_resident", "cgx_cg_stream", "cgx_pcg_wave", "cgx_sstep_gram",
               "cgx_sstep_recover",
               "cgx_sstep_gram_wave", "cgx_sstep_recover_wave")
# Entries with one variant only: the replay works on the float64 state.
_ONLY = {"cgx_sstep_replay": ("_f64",)}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH): the cgx_torch CUDA kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every source whose library is missing; return
    ``{source: library path}`` and, under ``"ptxas"``, what ``nvcc``
    reported about each kernel's registers and spills for the sources it
    compiled."""
    tag = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {s: BUILD_DIR / f"libcgx_{s}_{tag}.so" for s in _SIGNATURES}
    todo = {s: p for s, p in libs.items() if not p.exists()}
    procs = {}
    if todo:
        nvcc = _nvcc()
        for s, lib in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{s}.cu")]
            procs[s] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ))
    report = []
    failed = []
    for s, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{s}.cu (nvcc exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, libs[s])  # atomic: a concurrent loader sees whole files only
        report += [ln.strip() for ln in err.splitlines()
                   if "registers" in ln or "spill" in ln or "entry function" in ln]
    if failed:
        raise RuntimeError("building the cgx_torch kernels failed:\n" + "\n".join(failed))
    return {**{s: str(p) for s, p in libs.items()}, "ptxas": report}


@functools.lru_cache(maxsize=None)
def load() -> types.SimpleNamespace:
    """Build if needed, load, and bind every C entry point (with
    ``argtypes`` so no pointer is cut to 32 bits). Returns a namespace
    of the bound functions, e.g. ``load().cgx_dia_matvec_f32``."""
    libs = build()
    ns = types.SimpleNamespace()
    for s, entries in _SIGNATURES.items():
        cdll = ctypes.CDLL(libs[s])
        for name, argtypes in entries.items():
            suffixes = ("_f32", "_f64") + (("_f32_bf16b",) if name in _BF16_BANDS else ())
            for suffix in _ONLY.get(name, suffixes):
                fn = getattr(cdll, name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(ns, name + suffix, fn)
    return ns

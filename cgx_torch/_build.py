"""Build and bind the hand-written CUDA kernels of ``cgx_torch/csrc``.

Each ``.cu`` source compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``; the sources with the
most instantiations compile once per entry suffix, a library each
(:data:`_SPLIT`). The libraries go to ``build/cgx_torch/`` at the root
of the checkout, named by a hash of the sources, headers and flags, so
an edited source rebuilds. All libraries compile at once, one ``nvcc``
process each. Nothing here runs at import time: :func:`load` builds on
the first CUDA call.
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
        "cgx_dense_matvec": (_p, _p, _p, _n, _n, _n, _n, _n, _i, _i, _i, _i, _i, _p),
        "cgx_dense_matvec_dot": (_p, _p, _p, _n, _n, _n, _n, _n, _i, _i, _i, _i, _i, _p, _p, _p,
                                 _p, _n, _p),
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
        "cgx_cg_stream_wave": (_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _p, _n, _offs, _i,
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
                           _d, _d_in, _i, _d, _d, _d, _n, _i, _n, _n, _i, _p),
        "cgx_sstep_gram_wave": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _n, _offs, _i, _i, _d,
                                _d, _d_in, _i, _d, _d, _d, _offs, _i, _i, _n, _n, _i, _p),
        "cgx_sstep_replay": (_p, _p, _i, _d, _d, _d, _i, _p),
    },
    "sstep_recover": {
        "cgx_sstep_recover": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _p, _n, _offs, _i, _i, _d, _d,
                              _d_in, _i, _n, _i, _n, _n, _p),
        "cgx_sstep_recover_wave": (_p, _p, _p, _p, _p, _p, _p, _p, _n, _offs, _i, _i, _d, _d,
                                   _d_in, _i, _offs, _i, _i, _n, _n, _p),
    },
}
# Entries that also take bfloat16 bands under float32 vectors, bound with
# the suffix _f32_bf16b (cgx_torch.ops._util.NARROW_BANDS).
BF16_BANDS = ("cgx_dia_cg_chunk", "cgx_dia_cg_resident", "cgx_cg_stream", "cgx_pcg_wave",
              "cgx_cg_stream_wave", "cgx_sstep_gram", "cgx_sstep_recover",
              "cgx_sstep_gram_wave", "cgx_sstep_recover_wave")
# Entries that also take float16 bands under float32 vectors, bound with the
# suffix _f32_f16b (cgx_torch.ops._util.NARROW_BANDS): those whose cgx
# counterpart takes an explicit bands_dtype, B5, B4/B7 and B10 (B6's PCG takes
# "auto" only, so it has none).
F16_BANDS = ("cgx_dia_cg_chunk", "cgx_dia_cg_resident", "cgx_cg_stream", "cgx_cg_stream_wave",
             "cgx_sstep_gram", "cgx_sstep_recover", "cgx_sstep_gram_wave",
             "cgx_sstep_recover_wave")
# Entries also built on bfloat16 vectors and bands, bound with the suffix _bf16
# (cgx_torch.ops._util.KERNEL_DTYPES, vector_dtypes): B1's product (both
# designs), B5 (both designs), B4/B7 and B6 (both designs each), B3 (both entries),
# B10's Gram and recover and B9 (both designs each).
BF16_VECTORS = ("cgx_dia_matvec", "cgx_dia_matvec_stream", "cgx_dia_cg_chunk",
                "cgx_dia_cg_resident", "cgx_cg_stream", "cgx_pcg_wave", "cgx_cg_stream_wave",
                "cgx_dense_matvec", "cgx_dense_matvec_dot", "cgx_sstep_gram", "cgx_sstep_gram_wave",
                "cgx_sstep_recover", "cgx_sstep_recover_wave", "cgx_dia_sstep_basis",
                "cgx_dia_sstep_basis_wave")
# Entries with one variant only: the replay works on the float64 state.
_ONLY = {"cgx_sstep_replay": ("_f64",)}
# Sources compiled once per entry suffix (-DCGX_PART_<SUFFIX>, csrc/common.cuh),
# one library each: their many template instantiations would otherwise take
# one core for most of the build while the other sources are long done.
_SPLIT = {
    "cg_kernel": ("_f32", "_f64", "_f32_bf16b", "_f32_f16b", "_bf16"),
    "sstep_stream": ("_f32", "_f64", "_f32_bf16b", "_f32_f16b", "_bf16"),
    "sstep_recover": ("_f32", "_f64", "_f32_bf16b", "_f32_f16b", "_bf16"),
}


def _units() -> dict:
    """``{library name: (source, extra nvcc flags)}``: a source, or one
    part of a source that :data:`_SPLIT` names."""
    units = {}
    for s in _SIGNATURES:
        for part in _SPLIT.get(s, ("",)):
            units[s + part] = (s, (f"-DCGX_PART{part.upper()}",) if part else ())
    return units


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
    """Compile every library of :func:`_units` that is missing; return
    ``{library name: path}`` and, under ``"ptxas"``, what ``nvcc``
    reported about each kernel's registers and spills for the libraries
    it compiled."""
    tag = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = _units()
    libs = {u: BUILD_DIR / f"libcgx_{u}_{tag}.so" for u in units}
    todo = {u: p for u, p in libs.items() if not p.exists()}
    procs = {}
    if todo:
        nvcc = _nvcc()
        for u, lib in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            s, defines = units[u]
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{s}.cu")]
            procs[u] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ))
    report = []
    failed = []
    for u, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{u} (nvcc exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, libs[u])  # atomic: a concurrent loader sees whole files only
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
    cdlls = {u: ctypes.CDLL(libs[u]) for u in _units()}
    ns = types.SimpleNamespace()
    for s, entries in _SIGNATURES.items():
        for name, argtypes in entries.items():
            suffixes = ("_f32", "_f64") + (("_f32_bf16b",) if name in BF16_BANDS else ()) + (
                ("_f32_f16b",) if name in F16_BANDS else ()) + (
                ("_bf16",) if name in BF16_VECTORS else ())
            for suffix in _ONLY.get(name, suffixes):
                fn = getattr(cdlls[s + suffix if s in _SPLIT else s], name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(ns, name + suffix, fn)
    return ns

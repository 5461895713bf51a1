#!/usr/bin/env python3
"""Measure the bfloat16 builds of B3 (the dense mat-vec) and B4/B7 (the
plain streaming iteration) against the designs before them and against
edited copies of their sources, on one card.

    python3 redesign_probe.py [--parent DIR]

builds ``cgx_torch/csrc/matvec.cu`` and ``cg_stream.cu`` of this checkout,
and edited copies of them under ``build/redesign_probe/`` (ablations: no
source of the checkout changes), each with ``cgx_torch._build``'s flags
in a namespace of its own, and times by CUDA events (ms a call, the
median of bursts as ``chip_smoke.py`` times), by Kineto (device-only ms:
the median duration of the kernel's records) and on the host (µs a
call, below the launch queue's depth):

- B3 bfloat16 at lap2d_fd(100) (N = 10,000) with 1024 x 128 tiles (the
  CLI's "1024 16") and 1024 x 256, and at lap2d_reference(16384) with
  256 x 512 (the defaults) and 256 x 128: dense_plan's spans, the
  whole-warp spans forced (``lanes=32``, the design before), the L2
  prefetch at 0, 1 and 4 units ahead (``kDensePrefetch``), and separate
  products and sums in place of the fused exact ones; where the plan takes
  whole warps, their spans with the L2 prefetch; ``torch.mv`` on the same
  inputs. float32 and float64 at 1024 x 128 and 256 x 512.
- B4 and B7 at lap2d_fd(3200) (N = 10,240,000) on bfloat16, float32 (with
  float32, bfloat16 and float16 bands) and float64: stream_plan's
  wavefront against the grid design; on bfloat16 the grid design with
  each neighbour's r' read where it is formed again (wrong numbers: an
  ablation of the time only), with truncation in place of rounding to
  nearest, and with both.
- B3 bfloat16's blocks: a build that records each block's start and end
  (globaltimer) gives, for one launch, how far the blocks' ends spread
  under the static split of rows (the kernel waits for its last block).

With ``--parent DIR`` (the root of another checkout, e.g. the parent
commit unpacked by ``git archive`` into a directory ``.gitignore`` lists)
it also builds and times that checkout's two sources on the same inputs:
B3 by its C entries (the signature before ``lanes``; ``dense_matvec_dot``
too, beside this checkout's), B4/B7 by its grid kernel. Every y and every
launch's vectors are checked against the plain versions (bitwise, as
``chip_smoke.py`` checks them) where the build is not an ablation that
changes numbers. It prints one JSON record a line and ends with
``RESULT {json}``. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from cgx_torch import _build  # noqa: E402
from cgx_torch.mats.generators import lap2d_fd, lap2d_reference  # noqa: E402
from cgx_torch.ops import cg_stream, matvec  # noqa: E402
from cgx_torch.ops._util import sms_of  # noqa: E402
from cgx_torch.solver.operators import as_operator, densify_on_device  # noqa: E402

OUT = ROOT / "build" / "redesign_probe"
SUFFIXES = ("_f32", "_f64", "_f32_bf16b", "_f32_f16b", "_bf16")
BF16 = torch.bfloat16
# (file, text, replacement) of each ablation
FMA = ("matvec.cu", "p = __fmaf_rn(bf_lo(aw[k]), bf_lo(xw[k]), p);\n"
       "    p = __fmaf_rn(bf_hi(aw[k]), bf_hi(xw[k]), p);",
       "p += bf_lo(aw[k]) * bf_lo(xw[k]);\n    p += bf_hi(aw[k]) * bf_hi(xw[k]);")
PREFETCH = "constexpr int kDensePrefetch = 2;"
READ = ("cg_stream.cu", "const T r_j = j == i ? r_new : r[j] - alpha * (w[j] + beta * s[j]);",
        "const T r_j = j == i ? r_new : r[j];")
TRUNC = ("bf16.cuh", ": bits(__bfloat16_as_ushort(__float2bfloat16_rn(f))) {}",
         ": bits(__bfloat16_as_ushort(__float2bfloat16_rz(f))) {}")
# each block's first and last globaltimer reading, for the spread of their ends
BLOCK_TIMES = [
    ("matvec.cu", "// in order.\ntemplate <typename T, bool ALIGNED, bool DOT, int SUB>\n",
     "// in order.\n__device__ unsigned long long g_block_time[2048];\n"
     "template <typename T, bool ALIGNED, bool DOT, int SUB>\n"),
    ("matvec.cu", "  dense_rows<T, ALIGNED, DOT, SUB>(a, x, y, n_rows, n_cols, block_cols, "
     "chunk_cols,\n                                   rows_per_cta, staged, dd.prods);\n",
     "  unsigned long long t_start, t_end;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_start));\n"
     "  dense_rows<T, ALIGNED, DOT, SUB>(a, x, y, n_rows, n_cols, block_cols, chunk_cols,\n"
     "                                   rows_per_cta, staged, dd.prods);\n"
     "  __syncthreads();\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_end));\n"
     "  if (threadIdx.x == 0) {\n"
     "    g_block_time[2 * blockIdx.x] = t_start;\n"
     "    g_block_time[2 * blockIdx.x + 1] = t_end;\n"
     "  }\n"),
    ("matvec.cu", "}  // extern \"C\"",
     "int cgx_block_times(void* out, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, cgx::g_block_time, 16LL * n));\n"
     "}\n\n}  // extern \"C\""),
]
PF_RULE = "constexpr int PF = std::is_same_v<T, bf16> && SUB < 32 ? kDensePrefetch : 0;"
ABLATIONS = {
    "matvec": {"pfwarp": [("matvec.cu", PF_RULE, PF_RULE.replace(" && SUB < 32", ""))],
               "pf0": [("matvec.cu", PREFETCH, PREFETCH.replace("2", "0"))],
               "pf1": [("matvec.cu", PREFETCH, PREFETCH.replace("2", "1"))],
               "pf4": [("matvec.cu", PREFETCH, PREFETCH.replace("2", "4"))],
               "nofma": [FMA], "blocktimes": BLOCK_TIMES},
    "cg_stream": {"read": [READ], "trunc": [TRUNC], "read_trunc": [READ, TRUNC]},
}
REPS, BURST, WARMUP, CALLS = 25, 10, 3, 40


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


# ---- building and binding ----


def edited_copy(src: Path, name: str, edits) -> Path:
    d = OUT / f"src_{name}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(src, d)
    for f, old, new in edits:
        p = d / f
        text = p.read_text()
        if old not in text:
            raise SystemExit(f"ablation {name}: {f} has no {old!r}")
        p.write_text(text.replace(old, new))
    return d


def build(units: dict) -> dict:
    """{label: (csrc dir, source)} -> {label: library}, one nvcc each, all at
    once, each in the namespace cgx_<label>."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, source) in units.items():
        lib = OUT / f"lib_{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-Dcgx=cgx_{label}", "-I", str(src),
               "-o", str(lib), str(Path(src) / f"{source}.cu")]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"building {label} failed:\n{err[-4000:]}")
        libs[label] = lib
    return libs


def bind(lib: Path, source: str, signatures=None) -> types.SimpleNamespace:
    """A namespace like _build.load()'s of one library's entries."""
    cdll = ctypes.CDLL(str(lib))
    ns = types.SimpleNamespace()
    for name, argtypes in (signatures or _build._SIGNATURES[source]).items():
        for sfx in SUFFIXES:
            try:
                fn = getattr(cdll, name + sfx)
            except AttributeError:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(ns, name + sfx, fn)
    return ns


def use(*namespaces) -> None:
    """Point the wrappers' _build.load at the entries of ``namespaces``."""
    merged = types.SimpleNamespace()
    for ns in namespaces:
        merged.__dict__.update(ns.__dict__)
    _build.load = lambda: merged


# ---- timing ----


def event_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return statistics.median(times)


def device_ms(fn, names) -> float:
    """The median Kineto duration of the kernels named by ``names`` over
    CALLS calls ("" for every kernel: then their medians summed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_hidden_event() and any(
                k in e.name() for k in names):
            by_name.setdefault(e.name(), []).append(e.duration_ns() / 1e6)
    return sum(statistics.median(v) for v in by_name.values()) if by_name else None


def host_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def times(fn, names) -> dict:
    return {"ms": event_ms(fn), "device_ms": device_ms(fn, names), "host_us": host_us(fn)}


# ---- B3 ----

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PARENT_MATVEC = {"cgx_dense_matvec": (_P, _P, _P, _N, _N, _N, _N, _N, _I, _I, _I, _I, _P),
                 "cgx_dense_matvec_dot": (_P, _P, _P, _N, _N, _N, _N, _N, _I, _I, _I, _I, _P, _P,
                                          _P, _P, _N, _P)}
DOT_SUFFIX = {BF16: "_bf16", torch.float32: "_f32", torch.float64: "_f64"}


def parent_dense(ns, a, x, br, bc, plan, dot=False):
    """y (and with ``dot`` the dot) by the parent's entries (no lanes
    argument) on the same plan, with dense_matvec_dot's buffers as its
    wrapper allocates them."""
    n = a.shape[0]
    y = torch.empty(n, dtype=a.dtype, device=a.device)
    args = [a.data_ptr(), x.data_ptr(), y.data_ptr(), n, a.shape[1], bc, plan.chunk_cols,
            plan.rows_per_cta, int(plan.staging != "global"), int(plan.aligned), plan.shared,
            plan.grid]
    if dot:
        acc = matvec.acc_dtype(a.dtype)
        d = torch.empty((), dtype=acc, device=a.device)
        scratch = torch.empty(n + -(-n // br), dtype=acc, device=a.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=a.device)
        args += [scratch.data_ptr(), scratch[n:].data_ptr(), ticket.data_ptr(), d.data_ptr(), br]
    fn = getattr(ns, ("cgx_dense_matvec_dot" if dot else "cgx_dense_matvec") + DOT_SUFFIX[a.dtype])
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent dense_matvec: cudaError {rc}")
    return (y, d) if dot else y


def probe_dense(ns: dict, out: dict) -> None:
    problems = [("lap2d_fd(100)", lambda: lap2d_fd(100), [(1024, 128), (1024, 256)]),
                ("lap2d_reference(16384)", lambda: lap2d_reference(16384),
                 [(256, 512), (256, 128)])]
    for problem, make, tiles in problems:
        for dtype in (BF16, torch.float32, torch.float64):
            a = densify_on_device(as_operator(make(), dtype, device="cuda")).a
            x = torch.randn(a.shape[0], generator=torch.Generator().manual_seed(0)).to(dtype)
            x = x.cuda()
            if dtype == BF16:
                rec = {"kernel": "torch.mv", "problem": problem, "dtype": str(dtype),
                       **times(lambda: torch.mv(a, x), ("",))}
                emit(rec)
                out[f"mv {problem}"] = rec
            for br, bc in tiles if dtype == BF16 else tiles[:1]:
                plan = matvec._plan_of(a, x, bc)
                ref = matvec.dense_matvec_ref(a, x, block_rows=br, block_cols=bc)
                runs = {"this": ("this", plan)}
                if plan.lanes != 32:
                    runs["lanes32"] = ("this", plan._replace(lanes=32))
                if dtype == BF16:  # the prefetch on whole warps where the plan takes whole warps
                    runs.update({k: (k, plan) for k in ABLATIONS["matvec"]
                                 if k != "blocktimes" and (k == "pfwarp") == (plan.lanes == 32)})
                if dtype == BF16:
                    out[f"block times {problem} {br}x{bc}"] = block_times(ns, a, x, br, bc, plan)
                for label, (lib, p) in runs.items():
                    use(ns[f"matvec_{lib}"])

                    def call(p=p):
                        return matvec.dense_matvec(a, x, block_rows=br, block_cols=bc, plan=p)

                    rec = {"kernel": "dense_matvec", "build": label, "problem": problem,
                           "tiles": [br, bc], "dtype": str(dtype), "plan": p._asdict(),
                           "bitwise_plain": torch.equal(call(), ref),
                           **times(call, ("dense_matvec",))}
                    emit(rec)
                    out[f"dense {problem} {br}x{bc} {dtype} {label}"] = rec
                use(ns["matvec_this"])

                def dot():
                    return matvec.dense_matvec_dot(a, x, block_rows=br, block_cols=bc)

                rec = {"kernel": "dense_matvec_dot", "build": "this", "problem": problem,
                       "tiles": [br, bc], "dtype": str(dtype), **times(dot, ("dense_matvec",))}
                emit(rec)
                out[f"dense_dot {problem} {br}x{bc} {dtype} this"] = rec
                if "matvec_parent" in ns:
                    for kernel, is_dot in (("dense_matvec", False), ("dense_matvec_dot", True)):
                        def call(is_dot=is_dot):
                            return parent_dense(ns["matvec_parent"], a, x, br, bc, plan, is_dot)

                        got = call()
                        want = dot() if is_dot else matvec.dense_matvec(
                            a, x, block_rows=br, block_cols=bc, plan=plan)
                        same = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                                if is_dot else torch.equal(got, want))
                        rec = {"kernel": kernel, "build": "parent", "problem": problem,
                               "tiles": [br, bc], "dtype": str(dtype), "bitwise_this": same,
                               **times(call, ("dense_matvec",))}
                        emit(rec)
                        out[f"{kernel} {problem} {br}x{bc} {dtype} parent"] = rec
            del a, x
            torch.cuda.empty_cache()


def block_times(ns, a, x, br, bc, plan) -> dict:
    """Each block's start and end (globaltimer) in one launch of the
    timing build, after warm-up calls: how far the blocks' ends spread,
    against the kernel's span (a static split waits for its last block)."""
    use(ns["matvec_blocktimes"])
    for _ in range(WARMUP + 1):
        matvec.dense_matvec(a, x, block_rows=br, block_cols=bc, plan=plan)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * plan.grid))()
    rc = ns["matvec_blocktimes"].cgx_block_times(buf, plan.grid)
    if rc != 0:
        raise RuntimeError(f"cgx_block_times: cudaError {rc}")
    start, end = list(buf)[0::2], list(buf)[1::2]
    t0 = min(start)
    dur = [(e - s) / 1e3 for s, e in zip(start, end)]
    rec = {"kernel": "dense_matvec", "build": "blocktimes", "problem": str(a.shape),
           "tiles": [br, bc], "blocks": plan.grid, "span_us": (max(end) - t0) / 1e3,
           "mean_end_us": statistics.mean(e - t0 for e in end) / 1e3,
           "first_end_us": (min(end) - t0) / 1e3, "last_start_us": (max(start) - t0) / 1e3,
           "mean_block_us": statistics.mean(dur), "max_block_us": max(dur)}
    emit(rec)
    return rec


# ---- B4/B7 ----


def stream_state(dia, dtype, bands_dtype, stacked):
    import numpy as np

    rng = np.random.default_rng(0)
    bands = torch.as_tensor(dia.bands, dtype=dtype, device="cuda")
    b, x = (torch.as_tensor(rng.standard_normal(dia.shape[0]), dtype=dtype, device="cuda")
            for _ in range(2))
    st = cg_stream.initial_state(bands, b, 0.0, offsets=tuple(dia.offsets), stacked=stacked)
    st.x.copy_(x)
    return (bands if bands_dtype is None else bands.to(bands_dtype)), st


def clone(st):
    if st.rws is not None:
        rws = st.rws.clone()
        pairs = (rws[:, 0], rws[:, 1], rws[:, 2])
    else:
        rws, pairs = None, tuple(t.clone() for t in (st.r, st.w, st.s))
    return cg_stream.StreamState(st.p.clone(), st.x.clone(), None, *pairs, rws, st.scal.clone())


def probe_stream(ns: dict, out: dict) -> None:
    dia = lap2d_fd(3200)
    n, offs = dia.shape[0], tuple(dia.offsets)
    kw = dict(tol=0.0, nearzero=1e-14, maxiter=10**9)
    sms = sms_of(torch.device("cuda"))
    cases = [(BF16, None, False), (BF16, None, True), (torch.float32, BF16, False),
             (torch.float32, None, False), (torch.float32, torch.float16, False),
             (torch.float32, None, True), (torch.float64, None, False)]
    names = ("stream_wave_kernel", "cg_stream_kernel")
    for dtype, bands_dtype, stacked in cases:
        bands, st = stream_state(dia, dtype, bands_dtype, stacked)
        scal0 = st.scal.clone()
        work = cg_stream.workspace("cuda", n)
        site = cg_stream._stream_iteration_stacked if stacked else cg_stream._stream_iteration
        runs = {"wavefront": ("this", cg_stream.stream_plan(n, offs, dtype, sms)),
                "grid": ("this", cg_stream.grid_plan(n))}
        if dtype == BF16 and not stacked:
            runs.update({k: (k, cg_stream.grid_plan(n)) for k in ABLATIONS["cg_stream"]})
        if "cg_stream_parent" in ns:
            runs["parent"] = ("parent", cg_stream.grid_plan(n))
        for label, (lib, plan) in runs.items():
            use(ns[f"cg_stream_{lib}"])
            got, ref = clone(st), clone(st)
            cg_stream.step(bands, got, offsets=offs, plan=plan, **kw)
            cg_stream._iteration_ref(bands, *ref[:6], ref.scal, offsets=offs, **kw)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, w) for a, w in zip(got[:6], ref[:6]) if a is not None)
            go = cg_stream._launcher(site, bands, st.p, st.x, None, st.r, st.w, st.s, st.scal,
                                     offs, kw["tol"], kw["nearzero"], kw["maxiter"], work, plan)
            call = lambda go=go: (st.scal.copy_(scal0), go())  # noqa: E731
            rec = {"kernel": site.__name__.removeprefix("_"), "build": label,
                   "design": plan.design, "dtype": str(dtype), "bands_dtype": str(bands.dtype),
                   "stacked": stacked, "bitwise_plain": bitwise, **times(call, names)}
            emit(rec)
            out[f"stream {dtype} {bands.dtype} {'stacked' if stacked else 'split'} {label}"] = rec
            del got, ref, go, call
        use(ns["cg_stream_this"])
        del bands, st, work
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the root of another checkout to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("redesign_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    units = {}
    for source in ("matvec", "cg_stream"):
        units[f"{source}_this"] = (_build.CSRC, source)
        for name, edits in ABLATIONS[source].items():
            units[f"{source}_{name}"] = (edited_copy(_build.CSRC, name, edits), source)
        if args.parent:
            units[f"{source}_parent"] = (args.parent / "cgx_torch" / "csrc", source)
    t0 = time.perf_counter()
    ns = {label: bind(lib, label.split("_")[0] if label.startswith("matvec") else "cg_stream",
                      PARENT_MATVEC if label == "matvec_parent" else None)
          for label, lib in build(units).items()}
    ns["matvec_blocktimes"].cgx_block_times = ctypes.CDLL(
        str(OUT / "lib_matvec_blocktimes.so")).cgx_block_times
    ns["matvec_blocktimes"].cgx_block_times.argtypes = (ctypes.c_void_p, ctypes.c_int)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "units": sorted(units)})
    use(ns["matvec_this"], ns["cg_stream_this"])
    out = {"device": smi}
    probe_dense(ns, out)
    use(ns["matvec_this"], ns["cg_stream_this"])
    probe_stream(ns, out)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

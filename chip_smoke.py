#!/usr/bin/env python3
"""Drive cgx_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON object per line each:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them (also printed raw on a line of their own);
2. build: nvcc compiles the kernels of cgx_torch/csrc (one process per
   source, all at once);
3. kernels: each CUDA kernel, in float32 and float64, on the bands of
   lap2d_fd(3200) and lap2d_reference(10_240_000) (N = 10,240,000),
   against its plain PyTorch version on the same seeded inputs, with
   its time, the plain version's, a one-call PyTorch yardstick where
   there is one, and the least time the card could take;
4. goldens: the fp64 flagship goldens of tests/test_golden.py through
   the three-kernel loop;
5. main path: cgx_torch.solve on lap2d_fd(3200) in fp32 with
   use_pallas=True, twice (bitwise equal), its kernel launch counts,
   and the plain fp32 loop on the same problem;
6. profile: device time by kernel and the card's idle share over 256
   iterations of the main path, from torch.profiler;
7. dense kernels: dense_matvec and dense_matvec_dot, float32 and
   float64, on lap2d_fd(100) densified (N = 10,000, tiles 1024 x 128,
   the CLI's mapping of the reference's "1024 16") and on
   lap2d_reference(16384) densified (N = 16,384, the default 256 x 512),
   against their plain versions, with torch.mv as the yardstick;
8. CLI, CUDA grammar: the reference's own run, lap2D_5pt_n100.mtx 1024
   16 true, in fp64 through the dense kernel, twice (bitwise equal),
   held to the lap2d_fd(100) goldens and the reference's gates;
9. CLI, MPI grammar: 16384 --pallas, dense fp64 through the kernel,
   against the plain fp64 dense loop;
10. CLI, fp32: the CUDA grammar with --precision fp32 against the plain
    fp32 loop.

The CLI phases call cgx_torch.cli.main.run, the body of the CLI's main,
in this process. Then a "kernels" line for the six kernels, and, last,
the contract line {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero and prints no result. It needs a
CUDA device and imports neither JAX nor cgx.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from cgx_torch import (
    DenseOperator,
    SolveConfig,
    _build,
    as_operator,
    cg_solve,
    densify_on_device,
    dia_cg_solve_pallas,
    solve,
)
from cgx_torch.cli import main as cli
from cgx_torch.mats.generators import lap2d_fd, lap2d_fd_coo_lower, lap2d_reference, source_term
from cgx_torch.ops import axpy, dia_spmv, matvec
from cgx_torch.ops._util import f32_exact

SEED = 0
DEV = "cuda"  # every tensor of the run lives here
GRID = 3200  # bench.py:54, N = 10,240,000
REPS = 25  # timed samples per kernel, after WARMUP calls
BURST = 10  # calls per timed sample
WARMUP = 3
PROFILE_ITERS = 256  # main-path iterations under torch.profiler
# relative tolerances of section 3: vectors against max|ref|, dots against sum|a_i b_i|.
# FMA contraction in the kernels is the only expected difference.
VEC_RTOL = {torch.float32: 1e-6, torch.float64: 1e-14}
DOT_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}

# (name substring, HBM bytes/s, float32 FLOP/s, float64 FLOP/s) from
# NVIDIA's data sheets, dense, without tensor cores; first match wins.
CARDS = [
    ("H200", 4.8e12, 67e12, 34e12),
    ("H100 NVL", 3.9e12, 60e12, 30e12),
    ("H100 PCIe", 2.0e12, 51e12, 26e12),
    ("H100", 3.35e12, 67e12, 34e12),  # SXM
]

# tests/test_golden.py FLAGSHIP: first 8 recursive residuals, fp64, tol 1e-10
GOLDEN_PREFIX = {
    "lap2d_fd(100)": [
        1.07063277869174667e07, 1.75349458723023348e07, 2.74651125490928143e07,
        2.77661385929982923e07, 2.65666156891916655e07, 2.76468291995650306e07,
        2.49027236340865903e07, 2.66006474327106588e07,
    ],
    "lap2d_reference(10000)": [
        9.73651372396838479e06, 3.12457512412081882e07, 3.11245496621514186e07,
        3.48747115235015601e07, 3.93113117033372298e07, 3.42798756200103164e07,
        3.75301595863472968e07, 3.23599153440569490e07,
    ],
}
GOLDEN_K = {"lap2d_fd(100)": (485, 491), "lap2d_reference(10000)": (604, 610)}

KERNELS = {
    "dia_matvec": ("cgx_torch/csrc/dia_spmv.cu", "cgx/ops/dia_spmv.py:91"),
    "dia_matvec_dot": ("cgx_torch/csrc/dia_spmv.cu", "cgx/ops/dia_spmv.py:431"),
    "fused_update_rs": ("cgx_torch/csrc/axpy.cu", "cgx/ops/axpy.py:68"),
    "fused_axpby": ("cgx_torch/csrc/axpy.cu", "cgx/ops/axpy.py:118"),
    "dense_matvec": ("cgx_torch/csrc/matvec.cu", "cgx/ops/matvec.py:88"),
    "dense_matvec_dot": ("cgx_torch/csrc/matvec.cu", "cgx/ops/matvec.py:163"),
}
WRAPPERS = {
    "dia_matvec": dia_spmv.dia_matvec,
    "dia_matvec_dot": dia_spmv.dia_matvec_dot,
    "fused_update_rs": axpy.fused_update_rs,
    "fused_axpby": axpy.fused_axpby,
    "dense_matvec": matvec.dense_matvec,
    "dense_matvec_dot": matvec.dense_matvec_dot,
}
# (problem, host matrix, (block_rows, block_cols)) of the dense kernel phase
DENSE_PROBLEMS = [
    ("lap2d_fd(100)", lambda: lap2d_fd(100), (1024, 128)),  # the CLI's "1024 16"
    ("lap2d_reference(16384)", lambda: lap2d_reference(16384), (256, 512)),  # the defaults
]
MPI_N = 16384  # the reference's largest MPI size (the 16384 key of plots.ipynb's ALPHAS)
STEP = re.compile(r"\[STEP (\d+)\] residual = ([0-9.e+-]+), \|\|x\|\| = ([0-9.e+-]+), "
                  r"\|\|Ax - b\|\|/\|\|b\|\| = ([0-9.e+-]+|nan)")


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` on the card: the median over
    REPS samples, after WARMUP calls, of CUDA-event time over a run of
    BURST back-to-back calls, divided by BURST. The burst lets the host
    enqueue ahead of the card, so the figure is device time and not the
    host's launch latency."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return statistics.median(times)


def card_spec(name: str):
    for key, bw, f32, f64 in CARDS:
        if key in name:
            return {"spec": key, "hbm_bytes_per_s": bw,
                    "flops_per_s": {torch.float32: f32, torch.float64: f64}}
    raise AssertionError(f"no data-sheet entry for {name!r}: add it to CARDS")


def phase_device() -> dict:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return {"name": name, "smi": smi, **card_spec(name)}


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": libs["ptxas"]})


def csr_of(bands: torch.Tensor, offsets) -> torch.Tensor:
    """The banded matrix as a torch sparse CSR tensor (the library yardstick)."""
    ndiag, n = bands.shape
    i = torch.arange(n, device=bands.device)
    cols = (i[None, :] + torch.tensor(offsets, device=bands.device)[:, None]).T.contiguous()
    valid = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=bands.device)
    crow[1:] = torch.cumsum(valid.sum(dim=1), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[valid], bands.T.contiguous()[valid],
                                       size=(n, n), check_invariants=False)


def rel_err(got, ref, scale) -> float:
    return float((got - ref).abs().max() / scale)


def bound_ms(spec, dtype, words: float, flops: float):
    item = torch.finfo(dtype).bits // 8
    t_bytes = words * item / spec["hbm_bytes_per_s"] * 1e3
    t_ops = flops / spec["flops_per_s"][dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(spec, problem: str, dia, dtype) -> dict:
    """Each kernel against its plain version on this problem and dtype;
    returns {kernel: record} and emits one line per kernel."""
    dev = torch.device(DEV)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=dev)
    rng = np.random.default_rng(SEED)
    x, p, r, ap = (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
                   for _ in range(4))
    alpha = torch.tensor(0.37, dtype=dtype, device=dev)
    beta = torch.tensor(-1.25, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)
    csr = csr_of(bands, offsets)

    cases = {
        # name: (kernel call, plain call, library call or None, words, flops)
        "dia_matvec": (lambda: dia_spmv.dia_matvec(bands, x, offsets=offsets),
                       lambda: dia_spmv.dia_matvec_ref(bands, x, offsets=offsets),
                       lambda: torch.mv(csr, x), (ndiag + 2) * n, 2 * ndiag * n),
        "dia_matvec_dot": (lambda: dia_spmv.dia_matvec_dot(bands, x, offsets=offsets),
                           lambda: dia_spmv.dia_matvec_dot_ref(bands, x, offsets=offsets),
                           None, (ndiag + 2) * n + 1, (2 * ndiag + 2) * n),
        "fused_update_rs": (lambda: axpy.fused_update_rs(x, p, r, ap, alpha),
                            lambda: axpy.fused_update_rs_ref(x, p, r, ap, alpha),
                            None, 6 * n + 2, 6 * n),
        # the loop's form p' = beta p + 1 r, which torch.add(r, p, alpha=beta) also computes
        "fused_axpby": (lambda: axpy.fused_axpby(p, r, beta, one),
                        lambda: axpy.fused_axpby_ref(p, r, beta, one),
                        lambda: torch.add(r, p, alpha=float(beta)), 3 * n + 2, 3 * n),
    }
    dot_terms = {  # the (a, b) whose sum of |a_i b_i| scales each dot's error
        "dia_matvec_dot": lambda out: (x, out[0]),
        "fused_update_rs": lambda out: (out[1], out[1]),
    }
    return measure_cases(spec, problem, dtype, n, cases, dot_terms)


def measure_cases(spec, problem: str, dtype, n: int, cases: dict, dot_terms: dict) -> dict:
    """Each case's kernel against its plain version, then the times of
    the kernel, the plain version and the library call; returns
    {kernel: record} and emits one line per kernel. ``cases`` maps a
    kernel to (kernel call, plain call, library call or None, words,
    flops)."""
    records = {}
    for name, (kern, plain, lib, words, flops) in cases.items():
        got, ref = kern(), plain()
        sync()
        vecs = [got] if isinstance(got, torch.Tensor) else [g for g in got if g.dim() == 1]
        refs = [ref] if isinstance(ref, torch.Tensor) else [g for g in ref if g.dim() == 1]
        max_abs = max(float((g - f).abs().max()) for g, f in zip(vecs, refs))
        vec_rel = max(rel_err(g, f, f.abs().max()) for g, f in zip(vecs, refs))
        check(vec_rel <= VEC_RTOL[dtype],
              f"{name} {problem} {dtype}: vector error {vec_rel} > {VEC_RTOL[dtype]}")
        rec = {"phase": "kernel", "kernel": name, "problem": problem, "dtype": str(dtype),
               "n": n, "max_abs_err": max_abs, "vec_rel_err": vec_rel}
        if name in dot_terms:
            a_, b_ = dot_terms[name](ref)
            dot_rel = rel_err(got[-1], ref[-1], (a_ * b_).abs().sum())
            check(dot_rel <= DOT_RTOL[dtype],
                  f"{name} {problem} {dtype}: dot error {dot_rel} > {DOT_RTOL[dtype]}")
            rec["dot_rel_err"] = dot_rel
        if lib is not None:  # a yardstick of speed; its agreement is only reported
            rec["library_vec_rel_err"] = rel_err(lib(), got, got.abs().max())
        del got, ref
        rec["ms"] = time_ms(kern)
        rec["plain_ms"] = time_ms(plain)
        rec["library_ms"] = None if lib is None else time_ms(lib)
        rec["bound_ms"], rec["bound_by"] = bound_ms(spec, dtype, words, flops)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        emit(rec)
        records[name] = rec
    return records


def phase_kernels(spec) -> dict:
    main_records = {}
    problems = [(f"lap2d_fd({GRID})", lambda: lap2d_fd(GRID)),
                (f"lap2d_reference({GRID * GRID})", lambda: lap2d_reference(GRID * GRID))]
    for problem, make in problems:
        dia = make()
        for dtype in (torch.float32, torch.float64):
            recs = kernel_cases(spec, problem, dia, dtype)
            if problem.startswith("lap2d_fd") and dtype == torch.float32:
                main_records = recs  # the main path's shapes and dtype
            sync()
    return main_records


def dense_kernel_cases(spec, problem: str, dia, dtype, tiles) -> dict:
    """The dense kernels against their plain versions on ``dia``
    densified on the card, with the given tiles."""
    a = densify_on_device(as_operator(dia, dtype, device=DEV)).a
    n = a.shape[0]
    br, bc = tiles
    x = torch.as_tensor(np.random.default_rng(SEED).standard_normal(n), dtype=dtype, device=DEV)

    def library():  # cuBLAS gemv at full float32: a yardstick the port never calls
        with f32_exact():
            return torch.mv(a, x)

    cases = {
        "dense_matvec": (lambda: matvec.dense_matvec(a, x, block_rows=br, block_cols=bc),
                         lambda: matvec.dense_matvec_ref(a, x, block_rows=br, block_cols=bc),
                         library, n * n + 2 * n, 2 * n * n),
        "dense_matvec_dot": (lambda: matvec.dense_matvec_dot(a, x, block_rows=br, block_cols=bc),
                             lambda: matvec.dense_matvec_dot_ref(a, x, block_rows=br,
                                                                 block_cols=bc),
                             None, n * n + 2 * n + 1, 2 * n * n + 2 * n),
    }
    dot_terms = {"dense_matvec_dot": lambda out: (x, out[0])}
    records = measure_cases(spec, f"{problem} dense {br}x{bc}", dtype, n, cases, dot_terms)
    del a
    return records


def phase_dense_kernels(spec) -> dict:
    """Returns the records at the reference run's shape and dtype:
    lap2d_fd(100), 1024 x 128 tiles, float64."""
    main_records = {}
    for problem, make, tiles in DENSE_PROBLEMS:
        dia = make()
        for dtype in (torch.float32, torch.float64):
            recs = dense_kernel_cases(spec, problem, dia, dtype, tiles)
            if problem == "lap2d_fd(100)" and dtype == torch.float64:
                main_records = recs
            sync()
    return main_records


def true_rel(dia, x: np.ndarray, b: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b))


def phase_goldens() -> None:
    for problem, dia in (("lap2d_fd(100)", lap2d_fd(100)),
                         ("lap2d_reference(10000)", lap2d_reference(10000))):
        b = source_term(dia.shape[0])
        op = as_operator(dia, torch.float64, device=DEV)
        t0 = time.perf_counter()
        res = dia_cg_solve_pallas(op, b, tol=1e-10, history=8, device=DEV)
        k = int(res.iterations)
        seconds = time.perf_counter() - t0
        hist = res.history.cpu().numpy()
        prefix_rel = float(np.max(np.abs(hist - GOLDEN_PREFIX[problem])
                                  / np.abs(GOLDEN_PREFIX[problem])))
        rel = true_rel(dia, res.x.cpu().numpy(), b)
        lo, hi = GOLDEN_K[problem]
        emit({"phase": "golden", "problem": problem, "dtype": "float64", "k": k,
              "prefix_rel_err": prefix_rel, "true_rel": rel, "seconds": seconds})
        check(bool(res.converged) and lo <= k <= hi, f"{problem}: k={k} not in [{lo}, {hi}]")
        check(prefix_rel <= 1e-10, f"{problem}: residual prefix off by {prefix_rel}")
        check(rel < 1e-11, f"{problem}: true relative residual {rel}")


def phase_main(spec) -> dict:
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    cfg = SolveConfig(precision="fp32", use_pallas=True, tolerance=tol)
    op = as_operator(dia, torch.float32, device=DEV)  # set-up: bands and b on the card
    b_dev = torch.as_tensor(b, dtype=torch.float32, device=DEV)
    item = 4

    runs = []
    for _ in range(2):
        for w in WRAPPERS.values():
            w.launches = 0
        sync()
        t0 = time.perf_counter()
        res = solve(op, b_dev, cfg, device=DEV)
        k = int(res.iterations)  # waits for the solve
        seconds = time.perf_counter() - t0
        runs.append((res, k, seconds, {name: w.launches for name, w in WRAPPERS.items()}))
    (res, k, seconds, launches), (res2, k2, _, _) = runs
    check(bool(res.converged), "main path did not converge")
    bitwise = k == k2 and torch.equal(res.x.view(torch.int32), res2.x.view(torch.int32))
    check(bitwise, "two runs of the main path differ")
    check(launches["dia_matvec_dot"] >= k + 1 and launches["fused_update_rs"] >= k
          and launches["fused_axpby"] >= k and launches["dia_matvec"] >= 1,
          f"main path missed a kernel: {launches} at k={k}")
    body_calls = launches["dia_matvec_dot"]

    sync()
    t0 = time.perf_counter()
    plain = cg_solve(op, b_dev, tol=tol, device=DEV)
    k_plain = int(plain.iterations)
    plain_seconds = time.perf_counter() - t0

    # true residuals in fp64 on the card, through the plain fp64 mat-vec
    bands64 = torch.as_tensor(dia.bands, dtype=torch.float64, device=DEV)
    b64 = torch.as_tensor(b, dtype=torch.float64, device=DEV)

    def rel64(x):
        r = dia_spmv.dia_matvec_ref(bands64, x.double(), offsets=tuple(dia.offsets)) - b64
        return float(torch.linalg.norm(r) / torch.linalg.norm(b64))

    rel_fast, rel_plain = rel64(res.x), rel64(plain.x)
    per_iter_words = (len(dia.offsets) + 2) * n + 6 * n + 3 * n  # 16N for 5 bands
    rec = {"phase": "main", "problem": f"lap2d_fd({GRID})", "n": n, "dtype": "float32",
           "tol": tol, "k": k, "converged": True, "bitwise_repeat": bitwise,
           "seconds": seconds, "us_per_iter": seconds / body_calls * 1e6,
           "body_iterations": body_calls,
           "bound_us_per_iter": per_iter_words * item / spec["hbm_bytes_per_s"] * 1e6,
           "launches": launches, "k_plain": k_plain, "plain_seconds": plain_seconds,
           "plain_us_per_iter": plain_seconds / (k_plain + 1) * 1e6,
           "true_rel": rel_fast, "true_rel_plain": rel_plain,
           "x_finite": bool(torch.isfinite(res.x).all())}
    emit(rec)
    check(rec["x_finite"] and res.x.shape == (n,), "main path result is not finite")
    check(abs(k - k_plain) <= 0.02 * k_plain, f"k={k} vs plain k={k_plain}: more than 2% apart")
    check(max(rel_fast, rel_plain) <= 2 * min(rel_fast, rel_plain),
          f"true residuals {rel_fast} and {rel_plain} differ by more than 2x")
    phase_profile(op, b_dev)
    return launches


def phase_profile(op, b_dev) -> None:
    """Where an iteration of the main path spends its time on the card:
    device time by kernel over PROFILE_ITERS iterations, from
    torch.profiler's CUDA events, and the share of the (profiled) wall
    time in which the card ran nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = SolveConfig(precision="fp32", use_pallas=True, tolerance=0.0, maxiter=PROFILE_ITERS)
    solve(op, b_dev, cfg, device=DEV)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        int(solve(op, b_dev, cfg, device=DEV).iterations)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy_us, count = {}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in ("dia_matvec_dot_kernel", "dia_matvec_kernel",
                                 "update_rs_kernel", "axpby_kernel") if k in e.name), "other")
        us = e.time_range.elapsed_us()
        by_name[name] = by_name.get(name, 0.0) + us / PROFILE_ITERS
        busy_us += us
        count += 1
    emit({"phase": "profile", "iterations": PROFILE_ITERS, "device_events": count,
          "device_events_per_iter": count / PROFILE_ITERS,
          "device_us_per_iter": by_name,
          "device_busy_us_per_iter": busy_us / PROFILE_ITERS,
          "profiled_wall_us_per_iter": wall_us / PROFILE_ITERS,
          "idle_share": 1 - busy_us / wall_us})


def cli_run(argv):
    """One in-process CLI run with every launch count set to 0 just
    before it: returns (Run, its stdout, the launch counts just after)."""
    for w in WRAPPERS.values():
        w.launches = 0
    sync()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = cli.run(argv)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    check(run.rc == 0, f"cli {argv}: exit code {run.rc}")
    m = STEP.search(buf.getvalue())
    check(m is not None, f"cli {argv}: no [STEP k] line in {buf.getvalue()!r}")
    return run, m, launches


def cli_record(spec, phase: str, run, m, launches, n: int, dtype) -> dict:
    """The numbers every CLI record gives. An iteration's bound: A read
    once, plus the 14 vector words of the reference recurrence."""
    item = torch.finfo(dtype).bits // 8
    body = launches["dense_matvec"] - 1  # less the start residual's mat-vec
    return {"phase": phase, "n": n, "dtype": str(dtype), "k": int(m.group(1)),
            "step_line": m.group(0), "csv_row": run.csv_row, "seconds": run.seconds,
            "body_iterations": body, "us_per_iter": run.seconds / body * 1e6,
            "bound_us_per_iter": (n * n + 14 * n) * item / spec["hbm_bytes_per_s"] * 1e6,
            "launches": launches, "converged": bool(run.result.converged),
            "true_rel": float(m.group(4))}


def phase_cli_reference(spec, tmp: Path) -> dict:
    """The reference's run, CUDA grammar, fp64: converged, the golden
    count window and residual prefix of lap2d_fd(100), the DEBUG gate,
    the CSV row, the kernel on every iteration, and bitwise repeatable."""
    mtx = tmp / "lap2D_5pt_n100.mtx"
    lap2d_fd_coo_lower(100).write(mtx, comment=" 2D 5-point Laplacian, 100x100 grid")
    out = tmp / "CUDA_T.txt"
    argv = [str(mtx), "1024", "16", "true", str(out), "--history", "8"]
    run, m, launches = cli_run(argv)
    run2, m2, _ = cli_run(argv)
    n = run.op.shape[0]
    rec = cli_record(spec, "cli_cuda_grammar", run, m, launches, n, torch.float64)
    k = rec["k"]
    hist = run.result.history.cpu().numpy()
    gold = GOLDEN_PREFIX["lap2d_fd(100)"]
    rec["prefix_rel_err"] = float(np.max(np.abs(hist - gold) / np.abs(gold)))
    rec["tiles"] = [run.op.block_rows, run.op.block_cols]
    rec["bitwise_repeat"] = int(m2.group(1)) == k and torch.equal(
        run.result.x.view(torch.int64), run2.result.x.view(torch.int64))
    rec["seconds_repeat"] = run2.seconds
    emit(rec)
    lo, hi = GOLDEN_K["lap2d_fd(100)"]
    row = out.read_text().splitlines()[0].split(",")
    check(rec["converged"] and lo <= k <= hi, f"reference run: k={k} not in [{lo}, {hi}]")
    check(rec["prefix_rel_err"] <= 1e-10, f"reference run: prefix off by {rec['prefix_rel_err']}")
    check(rec["true_rel"] < 1e-11, f"reference run: true relative residual {rec['true_rel']}")
    check(row[:2] == ["1024", "16"] and float(row[2]) > 0, f"reference run: CSV row {row}")
    check(type(run.op).__name__ == "PallasDenseOperator" and rec["tiles"] == [1024, 128],
          f"reference run: operator {run.op!r:.80}")
    check(launches["dense_matvec"] >= k + 1, f"reference run missed the kernel: {launches}")
    check(rec["bitwise_repeat"], "two reference runs differ")
    return launches


def phase_cli_mpi(spec, tmp: Path) -> None:
    """MPI grammar, N = 16,384 dense fp64 through the kernel, against
    the plain fp64 dense loop (torch.matmul) on the same matrix."""
    out = tmp / "strong.txt"
    run, m, launches = cli_run([str(MPI_N), str(out), "--pallas"])
    rec = cli_record(spec, "cli_mpi_grammar", run, m, launches, MPI_N, torch.float64)
    b = torch.as_tensor(source_term(MPI_N), dtype=torch.float64, device=DEV)
    sync()
    t0 = time.perf_counter()
    plain = cg_solve(DenseOperator(run.op.a), b, device=DEV)
    k_plain = int(plain.iterations)
    rec.update(k_plain=k_plain, plain_seconds=time.perf_counter() - t0,
               tiles=[run.op.block_rows, run.op.block_cols])
    emit(rec)
    row = out.read_text().splitlines()[0].split(",")
    k = rec["k"]
    check(rec["converged"] and rec["true_rel"] < 1e-11,
          f"MPI run: converged={rec['converged']}, true relative residual {rec['true_rel']}")
    check(abs(k - k_plain) <= 0.01 * k_plain, f"MPI run: k={k} vs plain k={k_plain}")
    check(row[:2] == [str(MPI_N), "1"] and float(row[2]) > 0, f"MPI run: CSV row {row}")
    check(launches["dense_matvec"] >= k + 1, f"MPI run missed the kernel: {launches}")


def phase_cli_fp32(spec, tmp: Path) -> None:
    """The CUDA grammar in fp32 (fp32 dots) against the plain fp32 loop:
    the main path's fp32 gates, k within 2% and true residuals within 2x."""
    mtx = tmp / "lap2D_5pt_n100.mtx"  # written by phase_cli_reference
    dia = lap2d_fd(100)
    b = source_term(dia.shape[0])
    tol = 1e-5 * float(np.linalg.norm(b))
    argv = [str(mtx), "1024", "16", "true", str(tmp / "fp32.txt"), "--precision", "fp32",
            "--tol", repr(tol)]
    run, m, launches = cli_run(argv)
    rec = cli_record(spec, "cli_fp32", run, m, launches, dia.shape[0], torch.float32)
    sync()
    t0 = time.perf_counter()
    plain = cg_solve(DenseOperator(run.op.a), torch.as_tensor(b, dtype=torch.float32, device=DEV),
                     tol=tol, device=DEV)
    k_plain = int(plain.iterations)
    rel_plain = true_rel(dia, plain.x.cpu().numpy(), b)
    rec.update(tol=tol, k_plain=k_plain, plain_seconds=time.perf_counter() - t0,
               true_rel=true_rel(dia, run.result.x.cpu().numpy(), b), true_rel_plain=rel_plain,
               x_finite=bool(torch.isfinite(run.result.x).all()))
    emit(rec)
    k, rel = rec["k"], rec["true_rel"]
    check(rec["converged"] and rec["x_finite"], "fp32 run did not converge to a finite x")
    check(abs(k - k_plain) <= 0.02 * k_plain, f"fp32 run: k={k} vs plain k={k_plain}")
    check(max(rel, rel_plain) <= 2 * min(rel, rel_plain),
          f"fp32 run: true residuals {rel} and {rel_plain} differ by more than 2x")
    check(launches["dense_matvec"] >= k + 1, f"fp32 run missed the kernel: {launches}")


def main() -> int:
    spec = phase_device()
    phase_build()
    records = phase_kernels(spec)
    phase_goldens()
    launches = phase_main(spec)
    records.update(phase_dense_kernels(spec))
    with tempfile.TemporaryDirectory() as tmp:
        launches.update({name: n for name, n in phase_cli_reference(spec, Path(tmp)).items()
                         if name.startswith("dense_")})
        phase_cli_mpi(spec, Path(tmp))
        phase_cli_fp32(spec, Path(tmp))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = records[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive cgx_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON object per line each:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them (also printed raw on a line of their own);
2. build: nvcc compiles the kernels of cgx_torch/csrc (one process per
   source, all at once);
3. kernels: the mat-vec and update kernels, in float32 and float64, on
   the bands of lap2d_fd(3200) and lap2d_reference(10_240_000)
   (N = 10,240,000), against their plain PyTorch versions on the same
   seeded inputs, with their times, the plain versions', a one-call
   PyTorch yardstick where there is one, and the least time the card
   could take;
4. goldens: the fp64 flagship goldens of tests/test_golden.py through
   the three-kernel loop, with its launch counts;
5. stream kernel: the streaming Chronopoulos-Gear kernels (split in
   float32 with float32 and with bfloat16 bands, and in float64; stacked
   in float32; the Neumann PCG in float32) on lap2d_fd(3200) from one
   seeded state, one iteration and 32 against the plain version,
   split against stacked bitwise, with ms an iteration, the bound, the
   plain version's ms and the peak device memory;
6. main path: cgx_torch.solve on lap2d_fd(3200) in fp32 with
   use_pallas=True, twice (bitwise equal), its kernel launch counts, the
   same solve through the stacked layout (bitwise equal), and the plain
   pipelined loop (fp64 dots) and the plain classic loop on the same
   problem;
7. profile: device time by kernel and the card's idle share over 256
   iterations of the main path, from torch.profiler;
8. stream PCG path: the main path's call with precond="neumann", twice,
   against the plain pipelined Neumann PCG;
9. stream goldens: dia_cg_solve_stream in float64 on lap2d_fd(100) and
   lap2d_reference(10000) at tol 1e-10, twice each, against the plain
   float64 pipelined loop;
10. dense kernels: dense_matvec and dense_matvec_dot, float32 and
    float64, on lap2d_fd(100) densified (N = 10,000, tiles 1024 x 128,
    the CLI's mapping of the reference's "1024 16") and on
    lap2d_reference(16384) densified (N = 16,384, the default 256 x 512),
    against their plain versions, with torch.mv as the yardstick;
11. CLI, CUDA grammar: the reference's own run, lap2D_5pt_n100.mtx 1024
    16 true, in fp64 through the dense kernel, twice (bitwise equal),
    held to the lap2d_fd(100) goldens and the reference's gates;
12. CLI, MPI grammar: 16384 --pallas, dense fp64 through the kernel,
    against the plain fp64 dense loop;
13. CLI, fp32: the CUDA grammar with --precision fp32 against the plain
    fp32 loop;
14. resident kernel: the whole-solve chunk kernel against its plain
    version from one seeded state on the bands of lap2d_fd(1000)
    (N = 1,000,000), float32, float64 and float32 under bfloat16 bands:
    one iteration, and one 64-iteration chunk; then its ms per iteration
    in both layouts against the HBM bound, the plain version's and the
    peak device memory;
15. resident goldens: dia_cg_solve_vmem in float64 on lap2d_fd(100) and
    lap2d_reference(10000) at tol 1e-10, twice each;
16. resident path: the whole-solve kernel at N = 1,000,000 and 1,999,396
    in fp32, without and with the Neumann preconditioner, twice each,
    against the plain fp32 (P)CG loop and beside the three-kernel loop:
    through cgx_torch.solve where the budget routes it there, by a direct
    call where it no longer does; and one direct call with layout="1d";
17. crossover: the whole-solve kernel against the streaming kernel, and
    its Neumann PCG against the streaming PCG, in us per iteration at
    N = 250,000, 1e6, 1,999,396 and 4e6, beside the three-kernel loop,
    which sets cgx_torch.config.RESIDENT_BUDGET_BYTES;
18. mixed: cgx_torch.solve(lap2d_fd(1000)) with precision="mixed" at a
    relative tolerance of 1e-11, beside the plain fp64 loop;
19. mixed above the budget: iterative_refinement(use_pallas=True) on
    lap2d_fd(1000) with the budget set so that the inner solve is the
    streaming PCG, then the whole-solve kernel under bfloat16 bands; and
    one direct call of the latter with layout="1d";
20. sstep kernels: the matrix-powers kernel (float32 and float64), the
    fused s-step Gram and recover kernels (float32 with float32 and with
    bfloat16 bands, and float64) and the replay kernel on lap2d_fd(3200)
    from seeded p and r, s = 4, Chebyshev and Newton, against their plain
    versions: the basis and the recovered x, r and p bitwise, the Gram
    within 1e-12 of sum |v_i v_j|, the replayed coefficients within 1e-13;
    then each one's ms against its bound, the plain version's ms and the
    peak device memory;
21. sstep path: cgx_torch.solve(lap2d_fd(3200), fp32, method="sstep"),
    which resolves to the fused kernels with bfloat16 bands, twice
    (bitwise equal), and the same call with sstep_powers="pallas" (the
    matrix-powers kernel and the replay kernel), twice; against the plain
    fp32 s-step loop with a float64 Gram, beside the main path's
    streaming kernel; the Lanczos bounds timed apart as set-up;
22. sstep profile: device time by kernel and the idle share over 64
    fused blocks;
23. sstep goldens: dia_sstep_stream_solve in float64 on lap2d_fd(100)
    and lap2d_reference(10000) at tol 1e-10, twice each, against the
    plain float64 s-step loop;
24. stream matvec: kernel B8's two entry points (flat bands, band planes)
    on lap2d_fd(3200) in float32 and float64, bitwise against their plain
    versions, and the sharded halo mat-vec's local product through B8 with
    seeded halos bitwise against its plain form; their times, the plain
    versions', torch.sparse's CSR product and the bound;
25. sharded: a real NCCL process group of one rank (FileStore), and
    cgx_torch.solve(lap2d_fd(3200), fp32, mesh=make_mesh(1)), "auto"
    resolving the local product to B8: the reference and the pipelined
    method, twice each (bitwise), against the plain loops of phase 6 (k
    within 2%, true residual within 2x), B8 on every iteration and B1 on
    none, the collectives of every iteration from the recorder; then a
    profile over 256 iterations (B8, NCCL, the rest, the idle share);
26. sharded goldens: the fp64 goldens through the sharded route with B8
    forced, twice each.

The CLI phases call cgx_torch.cli.main.run, the body of the CLI's main,
in this process. Then a "kernels" line for the ported kernels (every
pallas_call site of cgx, with the replay kernel; "not_ported" is empty),
and, last, the contract line {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result. It
needs a CUDA device and imports neither JAX nor cgx.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
import torch.distributed as dist

from cgx_torch import (
    DenseOperator,
    SolveConfig,
    _build,
    as_operator,
    cg_solve,
    config,
    densify_on_device,
    dia_cg_solve_pallas,
    dia_cg_solve_stream,
    dia_cg_solve_stream_pcg,
    dia_cg_solve_vmem,
    iterative_refinement,
    pipelined_cg_solve,
    solve,
)
from cgx_torch.cli import main as cli
from cgx_torch.parallel import make_mesh, make_sharded_solver
from cgx_torch.parallel import sharded_cg as sc
from cgx_torch.mats.generators import lap2d_fd, lap2d_fd_coo_lower, lap2d_reference, source_term
from cgx_torch.ops import axpy, cg_kernel, cg_stream, dia_powers, dia_spmv, matvec
from cgx_torch.ops import sstep_stream as ss
from cgx_torch.ops._util import f32_exact
from cgx_torch.solver.chebyshev import device_matvec, host_matvec, lanczos_bounds, spectral_bounds
from cgx_torch.solver.precond import neumann_banded
from cgx_torch.solver.sstep import newton_shifts, sstep_cg_solve
from cgx_torch.utils import collectives

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
# A 64-iteration chunk of the whole-solve kernel against its plain version, relative
# to max|ref|: the float64 dots run in another order (the kernel's blocks against
# torch.sum), so a float64 alpha or beta may differ in its last bit, and a float32 one
# at a near-tie, and the difference compounds over the iterations. At N = 1,000,000
# the float32 vectors came out bitwise equal and the float64 ones within 1.8e-14; an
# earlier build with float32 dots, whose alpha and beta flipped often, moved them by
# 9.4e-6 and 3.1e-14 (H100, 700 W). The bounds leave 10x and 30x over the latter.
CHUNK_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
RESIDENT_GRID = 1000  # lap2d_fd(1000): N = 1,000,000, BASELINE.json config 2
RESIDENT_GRIDS = (1000, 1414)  # N = 1,000,000 and 1,999,396 (cgx/config.py:33-35)
CHUNK = 64  # iterations per launch of dia_cg_solve_vmem's default
CROSSOVER_GRIDS = (500, 1000, 1414, 2000)  # N = 250,000 .. 4,000,000
CROSSOVER_ITERS = 512
STREAM_ITERS = 32  # launches of the stream kernel phase's second comparison
# name: (kernel site, vector dtype, bfloat16 bands, preconditioner, stacked layout)
STREAM_CASES = {
    "split_f32": ("stream_iteration", torch.float32, False, False, False),
    "split_f32_bf16b": ("stream_iteration", torch.float32, True, False, False),
    "split_f64": ("stream_iteration", torch.float64, False, False, False),
    "stacked_f32": ("stream_iteration_stacked", torch.float32, False, False, True),
    "pcg_f32": ("stream_iteration_pcg", torch.float32, False, True, False),
}
# the case whose shapes and dtypes the main paths give each streaming site
STREAM_MAIN_CASE = {"stream_iteration": "split_f32_bf16b", "stream_iteration_stacked":
                    "stacked_f32", "stream_iteration_pcg": "pcg_f32"}
SSTEP_S = 4  # cgx's default sstep_s
# name: (vector dtype, bfloat16 bands); the matrix-powers kernel takes the
# bands in the vectors' dtype only
SSTEP_CASES = {"f32": (torch.float32, False), "f32_bf16b": (torch.float32, True),
               "f64": (torch.float64, False)}
# the case whose shapes and dtypes the s-step paths give each site: solve's
# "fused" route streams bfloat16 bands, its "pallas" route float32 ones
SSTEP_MAIN_CASE = {"dia_sstep_basis_planes": "f32", "sstep_gram": "f32_bf16b",
                   "sstep_recover": "f32_bf16b", "sstep_replay": "f32"}
GRAM_RTOL = 1e-12  # against sum |v_i v_j|: float64 sums in two orders
COEF_RTOL = 1e-13  # the replay's coefficients, against their max
SSTEP_PROFILE_BLOCKS = 64

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
    "dia_cg_vmem": ("cgx_torch/csrc/cg_kernel.cu", "cgx/ops/cg_kernel.py:245"),
    "dia_cg_vmem2d": ("cgx_torch/csrc/cg_kernel.cu", "cgx/ops/cg_kernel.py:479"),
    "dia_cg_vmem_bf16b": ("cgx_torch/csrc/cg_kernel.cu", "cgx/ops/cg_kernel.py:245"),
    "dia_cg_vmem2d_bf16b": ("cgx_torch/csrc/cg_kernel.cu", "cgx/ops/cg_kernel.py:479"),
    "stream_iteration": ("cgx_torch/csrc/cg_stream.cu", "cgx/ops/cg_stream.py:404"),
    "stream_iteration_stacked": ("cgx_torch/csrc/cg_stream.cu", "cgx/ops/cg_stream.py:930"),
    "stream_iteration_pcg": ("cgx_torch/csrc/cg_stream.cu", "cgx/ops/cg_stream.py:1203"),
    "dia_sstep_basis_planes": ("cgx_torch/csrc/dia_powers.cu", "cgx/ops/dia_powers.py:299"),
    "sstep_gram": ("cgx_torch/csrc/sstep_stream.cu", "cgx/ops/sstep_stream.py:395"),
    "sstep_recover": ("cgx_torch/csrc/sstep_stream.cu", "cgx/ops/sstep_stream.py:466"),
    # no pallas_call: cgx replays in XLA (replay_block, called at cgx/solver/sstep.py:218
    # and cgx/ops/sstep_stream.py:730); one small kernel here, so the host sets no pace
    "sstep_replay": ("cgx_torch/csrc/sstep_stream.cu", "cgx/solver/sstep.py:284"),
    # B8: the flat form has no solver caller in cgx (and none here); the
    # planes form is the sharded route's local product
    "dia_matvec_stream": ("cgx_torch/csrc/dia_stream.cu", "cgx/ops/dia_spmv.py:192"),
    "dia_matvec_stream2d_planes": ("cgx_torch/csrc/dia_stream.cu", "cgx/ops/dia_spmv.py:354"),
}
NOT_PORTED = []  # every pallas_call site of cgx has its kernel
SSTEP_SITES = {
    "dia_sstep_basis_planes": dia_powers.dia_sstep_basis_planes,
    "sstep_gram": ss._sstep_gram,
    "sstep_recover": ss._sstep_recover,
    "sstep_replay": ss.sstep_replay,
}
# the whole-solve kernel's two cgx sites, by the layout its wrapper counts,
# with the bands in the vectors' dtype and in bfloat16
RESIDENT_SITES = {"dia_cg_vmem": "1d", "dia_cg_vmem2d": "2d"}
BF16_SITES = {"dia_cg_vmem_bf16b": "1d", "dia_cg_vmem2d_bf16b": "2d"}
STREAM_SITES = {
    "stream_iteration": cg_stream._stream_iteration,
    "stream_iteration_stacked": cg_stream._stream_iteration_stacked,
    "stream_iteration_pcg": cg_stream._stream_iteration_pcg,
}
THREE_KERNEL = ("dia_matvec", "dia_matvec_dot", "fused_update_rs", "fused_axpby")
WRAPPERS = {
    "dia_matvec": dia_spmv.dia_matvec,
    "dia_matvec_dot": dia_spmv.dia_matvec_dot,
    "fused_update_rs": axpy.fused_update_rs,
    "fused_axpby": axpy.fused_axpby,
    "dense_matvec": matvec.dense_matvec,
    "dense_matvec_dot": matvec.dense_matvec_dot,
    "dia_matvec_stream": dia_spmv.dia_matvec_stream,
    "dia_matvec_stream2d_planes": dia_spmv.dia_matvec_stream2d_planes,
}
B8_SITES = ("dia_matvec_stream", "dia_matvec_stream2d_planes")
# per-iteration collectives of the sharded route (tests/test_collective_counts.py)
SHARDED_SIGNATURE = {
    "reference": [("ppermute", 1, GRID), ("ppermute", 1, GRID), ("psum", 1, 1), ("psum", 1, 1)],
    "pipelined": [("psum", 1, 2), ("ppermute", 1, GRID), ("ppermute", 1, GRID)],
}
# (problem, host matrix, (block_rows, block_cols)) of the dense kernel phase
DENSE_PROBLEMS = [
    ("lap2d_fd(100)", lambda: lap2d_fd(100), (1024, 128)),  # the CLI's "1024 16"
    ("lap2d_reference(16384)", lambda: lap2d_reference(16384), (256, 512)),  # the defaults
]
MPI_N = 16384  # the reference's largest MPI size (the 16384 key of plots.ipynb's ALPHAS)
STEP = re.compile(r"\[STEP (\d+)\] residual = ([0-9.e+-]+), \|\|x\|\| = ([0-9.e+-]+), "
                  r"\|\|Ax - b\|\|/\|\|b\|\| = ([0-9.e+-]+|nan)")


def reset_launches() -> None:
    for w in (*WRAPPERS.values(), *STREAM_SITES.values(), *SSTEP_SITES.values()):
        w.launches = 0
    cg_kernel.dia_cg_chunk.launches = {layout: 0 for layout in cg_kernel.LAYOUTS}
    cg_kernel.dia_cg_chunk.launches_bf16 = {layout: 0 for layout in cg_kernel.LAYOUTS}


def read_launches() -> dict:
    counts = {name: w.launches
              for name, w in (*WRAPPERS.items(), *STREAM_SITES.items(), *SSTEP_SITES.items())}
    chunk = cg_kernel.dia_cg_chunk
    for name, layout in RESIDENT_SITES.items():
        counts[name] = chunk.launches[layout] - chunk.launches_bf16[layout]
    for name, layout in BF16_SITES.items():
        counts[name] = chunk.launches_bf16[layout]
    return counts


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int = REPS, burst: int = BURST) -> float:
    """Milliseconds of one call of ``fn`` on the card: the median over
    ``reps`` samples, after WARMUP calls, of CUDA-event time over a run of
    ``burst`` back-to-back calls, divided by ``burst``. The burst lets the
    host enqueue ahead of the card, so the figure is device time and not
    the host's launch latency."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
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
        rec["bound_ms"], rec["bound_by"] = bound_of(spec, dtype,
                                                    words * torch.finfo(dtype).bits // 8, flops)
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


def phase_goldens() -> dict:
    """The goldens through the three-kernel loop; returns the launch
    counts of its first run (kernels B1 and B2, which left the main path
    when the streaming kernel took it over)."""
    counts = None
    for problem, dia in (("lap2d_fd(100)", lap2d_fd(100)),
                         ("lap2d_reference(10000)", lap2d_reference(10000))):
        b = source_term(dia.shape[0])
        op = as_operator(dia, torch.float64, device=DEV)
        reset_launches()
        t0 = time.perf_counter()
        res = dia_cg_solve_pallas(op, b, tol=1e-10, history=8, device=DEV)
        k = int(res.iterations)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        counts = counts or launches
        hist = res.history.cpu().numpy()
        prefix_rel = float(np.max(np.abs(hist - GOLDEN_PREFIX[problem])
                                  / np.abs(GOLDEN_PREFIX[problem])))
        rel = true_rel(dia, res.x.cpu().numpy(), b)
        lo, hi = GOLDEN_K[problem]
        emit({"phase": "golden", "problem": problem, "dtype": "float64", "k": k,
              "prefix_rel_err": prefix_rel, "true_rel": rel, "seconds": seconds,
              "launches": {name: launches[name] for name in THREE_KERNEL}})
        check(bool(res.converged) and lo <= k <= hi, f"{problem}: k={k} not in [{lo}, {hi}]")
        check(prefix_rel <= 1e-10, f"{problem}: residual prefix off by {prefix_rel}")
        check(rel < 1e-11, f"{problem}: true relative residual {rel}")
        check(launches["dia_matvec"] >= 1 and launches["dia_matvec_dot"] >= k + 1
              and launches["fused_update_rs"] >= k and launches["fused_axpby"] >= k,
              f"{problem}: the three-kernel loop missed a kernel: {launches} at k={k}")
    return counts


def stream_bytes(ndiag: int, n: int, bands_item: int, vec_item: int, precond: bool) -> int:
    """Bytes an iteration of the streaming kernel must move: the bands
    once, p, x, r, w and s in and out (and u with the preconditioner),
    csrc/cg_stream.cu."""
    return n * (ndiag * bands_item + (12 if precond else 10) * vec_item)


def stream_flops(ndiag: int, n: int, precond: bool) -> int:
    """Operations of an iteration, as cgx's cost estimate counts them
    (cg_stream.py:463, :1261)."""
    return (4 * ndiag + 14) * n if precond else (2 * ndiag + 8) * n


def bound_of(spec, dtype, nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    return bound_mixed(spec, nbytes, {dtype: flops})


def solve_twice(fn) -> tuple:
    """Two runs of a solve, each with the launch counts set to 0 just
    before it; returns (result, k, seconds, launches, bitwise equal)."""
    runs = []
    for _ in range(2):
        reset_launches()
        res, k, seconds = timed(fn)
        runs.append((res, k, seconds, read_launches()))
    (res, k, seconds, launches), (res2, k2, _, _) = runs
    bitwise = k == k2 and torch.equal(res.x.view(torch.int32), res2.x.view(torch.int32))
    return res, k, seconds, launches, bitwise


def phase_main(spec) -> dict:
    """The main path: solve(lap2d_fd(3200), fp32, use_pallas) above the
    resident budget runs the streaming kernel with bfloat16 bands (the
    bands -1, 0 and 4 survive the round trip). Returns its launch counts,
    with the stacked site's from the same solve through layout="stacked"."""
    dia = lap2d_fd(GRID)
    n, ndiag = dia.shape[0], len(dia.offsets)
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    cfg = SolveConfig(precision="fp32", use_pallas=True, tolerance=tol)
    op = as_operator(dia, torch.float32, device=DEV)  # set-up: bands and b on the card
    b_dev = torch.as_tensor(b, dtype=torch.float32, device=DEV)
    check(cg_kernel.resident_state_bytes(ndiag, n, 4, 4) > config.RESIDENT_BUDGET_BYTES,
          f"N = {n} is within the resident budget: the main path would not stream")

    res, k, seconds, launches, bitwise = solve_twice(lambda: solve(op, b_dev, cfg, device=DEV))
    bands_dtype = cg_stream._stream_iteration.bands_dtype
    check(bool(res.converged), "main path did not converge")
    check(bitwise, "two runs of the main path differ")
    check(launches["stream_iteration"] >= k and bands_dtype == torch.bfloat16,
          f"main path missed the streaming kernel: {launches} at k={k}, bands {bands_dtype}")
    others = {name: c for name, c in launches.items()
              if name != "stream_iteration" and name in KERNELS and c}
    check(not others, f"main path launched other kernels: {others}")

    # cgx's second site: the same solve with r, w and s stacked (B7)
    reset_launches()
    stacked, k_stacked, stacked_seconds = timed(lambda: dia_cg_solve_stream(
        op, b_dev, tol=tol, layout="stacked", bands_dtype="auto", device=DEV))
    launches["stream_iteration_stacked"] = read_launches()["stream_iteration_stacked"]
    same = k_stacked == k and torch.equal(stacked.x.view(torch.int32), res.x.view(torch.int32))
    check(same and launches["stream_iteration_stacked"] >= k,
          f"stacked layout: k={k_stacked}, bitwise equal to split: {same}, "
          f"{launches['stream_iteration_stacked']} launches")

    plain, k_plain, plain_seconds = timed(lambda: pipelined_cg_solve(
        op, b_dev, tol=tol, dot_precision=torch.float64, device=DEV))
    classic, k_classic, classic_seconds = timed(lambda: cg_solve(
        op, b_dev, tol=tol, dot_precision=torch.float64, device=DEV))
    rel64 = rel64_on_card(dia, b)
    rel_fast, rel_plain, rel_classic = rel64(res.x), rel64(plain.x), rel64(classic.x)
    bound_iter, bound_by = bound_of(spec, torch.float32, stream_bytes(ndiag, n, 2, 4, False),
                                    stream_flops(ndiag, n, False))
    rec = {"phase": "main", "problem": f"lap2d_fd({GRID})", "n": n, "dtype": "float32",
           "bands_dtype": str(bands_dtype), "tol": tol, "k": k, "converged": True,
           "bitwise_repeat": bitwise, "seconds": seconds, "us_per_iter": seconds / k * 1e6,
           "launches_run": launches["stream_iteration"], "grid": cg_stream._stream_iteration.grid,
           "bound_us_per_iter": bound_iter * 1e3, "bound_by": bound_by, "launches": launches,
           "k_stacked": k_stacked, "stacked_seconds": stacked_seconds, "stacked_bitwise": same,
           "k_plain": k_plain, "plain_seconds": plain_seconds,
           "plain_us_per_iter": plain_seconds / k_plain * 1e6,
           "k_classic": k_classic, "classic_seconds": classic_seconds,
           "true_rel": rel_fast, "true_rel_plain": rel_plain, "true_rel_classic": rel_classic,
           "x_finite": bool(torch.isfinite(res.x).all())}
    emit(rec)
    check(rec["x_finite"] and res.x.shape == (n,), "main path result is not finite")
    check(abs(k - k_plain) <= 0.02 * k_plain, f"k={k} vs plain k={k_plain}: more than 2% apart")
    check(max(rel_fast, rel_plain) <= 2 * min(rel_fast, rel_plain),
          f"true residuals {rel_fast} and {rel_plain} differ by more than 2x")
    phase_profile(op, b_dev)
    return launches, rec


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
        name = "cg_stream_kernel" if "cg_stream_kernel" in e.name else "other"
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


def stream_state(dia, dtype, precond: bool, stacked: bool):
    """Bands and cgx's start state from a seeded b, with a seeded x."""
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=DEV)
    rng = np.random.default_rng(SEED)
    b, x = (torch.as_tensor(rng.standard_normal(dia.shape[0]), dtype=dtype, device=DEV)
            for _ in range(2))
    st = cg_stream.initial_state(bands, b, 0.0, offsets=tuple(dia.offsets), precond=precond,
                                 stacked=stacked)
    st.x.copy_(x)
    return bands, st


def clone_state(st):
    if st.rws is not None:
        rws = st.rws.clone()
        pairs = (rws[:, 0], rws[:, 1], rws[:, 2])
    else:
        rws, pairs = None, tuple(t.clone() for t in (st.r, st.w, st.s))
    return cg_stream.StreamState(st.p.clone(), st.x.clone(),
                                 None if st.u is None else st.u.clone(), *pairs, rws,
                                 st.scal.clone())


def phase_stream_kernel(spec) -> dict:
    """Each streaming case against its plain version from one seeded
    state at N = 10,240,000: one launch (vectors within VEC_RTOL, dots
    within DOT_RTOL) and STREAM_ITERS launches (within CHUNK_RTOL: a
    dot's last bit can flip a float alpha, and the difference compounds),
    split against stacked bitwise; then the time of a launch. Returns the
    records of the kernels line for the three streaming sites."""
    dia = lap2d_fd(GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    kw = dict(offsets=offsets, tol=0.0, nearzero=1e-14, maxiter=10**9)
    records, after = {}, {}
    for case, (site, dtype, bf16, precond, stacked) in STREAM_CASES.items():
        bands, st = stream_state(dia, dtype, precond, stacked)
        kb = bands.to(torch.bfloat16) if bf16 else bands
        del bands
        one_err = None
        for launches, vec_rtol, dot_rtol in ((1, VEC_RTOL[dtype], DOT_RTOL[dtype]),
                                             (STREAM_ITERS, CHUNK_RTOL[dtype], CHUNK_RTOL[dtype])):
            got, ref = clone_state(st), clone_state(st)
            for _ in range(launches):
                cg_stream.step(kb, got, **kw)
                cg_stream._iteration_ref(kb, *ref[:6], ref.scal, **kw)
            sync()
            pairs = [(a, w) for a, w in zip(got[:6], ref[:6]) if a is not None]
            max_abs = max(float((a - w).abs().max()) for a, w in pairs)
            vec_rel = max(rel_err(a, w, w.abs().max()) for a, w in pairs)
            dot_rel = float(((got.scal[:3] - ref.scal[:3]).abs() / ref.scal[:3].abs()).max())
            same = torch.equal(got.scal[cg_stream.K:], ref.scal[cg_stream.K:])
            emit({"phase": "stream_kernel_check", "case": case, "problem": f"lap2d_fd({GRID})",
                  "n": n, "dtype": str(dtype), "bands_dtype": str(kb.dtype), "launches": launches,
                  "max_abs_err": max_abs, "vec_rel_err": vec_rel, "dot_rel_err": dot_rel,
                  "vec_rtol": vec_rtol, "dot_rtol": dot_rtol, "grid": STREAM_SITES[site].grid,
                  "scalars": got.scal.tolist(), "plain_scalars": ref.scal.tolist()})
            check(vec_rel <= vec_rtol and dot_rel <= dot_rtol and same,
                  f"stream {case} x{launches}: vectors {vec_rel}, dots {dot_rel}, "
                  f"k/stop/breakdown {got.scal[cg_stream.K:].tolist()} against "
                  f"{ref.scal[cg_stream.K:].tolist()}")
            if launches == 1:
                one_err = max_abs
            elif case in ("split_f32", "stacked_f32"):
                q = int(got.scal[cg_stream.K]) & 1
                after[case] = [got.p, got.x, got.r[q], got.w[q], got.s[q]]
            del got, ref
        sync()
        torch.cuda.reset_peak_memory_stats()
        work = cg_stream.workspace(DEV, n)
        ms = time_ms(lambda: cg_stream.step(kb, st, work=work, **kw))
        peak = torch.cuda.max_memory_allocated()
        held = sum(t.numel() * t.element_size() for t in (kb, *st, *work)
                   if t is not None and t is not st.rws)
        plain_ms = time_ms(lambda: cg_stream._iteration_ref(kb, *st[:6], st.scal, **kw),
                           reps=3, burst=1)
        item = torch.finfo(dtype).bits // 8
        bound, bound_by = bound_of(spec, dtype,
                                   stream_bytes(ndiag, n, 2 if bf16 else item, item, precond),
                                   stream_flops(ndiag, n, precond))
        rec = {"phase": "stream_kernel", "case": case, "site": site, "problem": f"lap2d_fd({GRID})",
               "n": n, "dtype": str(dtype), "bands_dtype": str(kb.dtype),
               "ms_per_iter": ms, "launches_per_iter": 3 if precond else 1,
               "bound_ms_per_iter": bound,
               "bound_by": bound_by, "bound_share": bound / ms, "plain_ms_per_iter": plain_ms,
               "state_bytes": held, "max_memory_allocated": peak,
               "grid": STREAM_SITES[site].grid,
               "max_abs_err": one_err}
        emit(rec)
        if STREAM_MAIN_CASE[site] == case:
            records[site] = {"max_abs_err": one_err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": bound_by,
                             "library_ms": None}  # no one PyTorch call runs a CG iteration
        del kb, st, work
        sync()
    same = all(torch.equal(a, b) for a, b in zip(after["split_f32"], after["stacked_f32"]))
    emit({"phase": "stream_layouts", "launches": STREAM_ITERS, "split_equals_stacked": same})
    check(same, "split and stacked layouts differ")
    return records


def phase_stream_pcg(spec) -> dict:
    """solve(lap2d_fd(3200), fp32, use_pallas, precond="neumann") above
    the budget runs the streaming PCG kernel; against the plain pipelined
    Neumann PCG with fp64 dots. Returns its launch counts."""
    dia = lap2d_fd(GRID)
    n, ndiag = dia.shape[0], len(dia.offsets)
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    cfg = SolveConfig(precision="fp32", use_pallas=True, tolerance=tol, precond="neumann")
    op = as_operator(dia, torch.float32, device=DEV)
    b_dev = torch.as_tensor(b, dtype=torch.float32, device=DEV)
    res, k, seconds, launches, bitwise = solve_twice(lambda: solve(op, b_dev, cfg, device=DEV))
    check(bool(res.converged) and bitwise, f"stream PCG: converged {bool(res.converged)}, "
          f"bitwise repeat {bitwise}")
    others = {name: c for name, c in launches.items()
              if name != "stream_iteration_pcg" and name in KERNELS and c}
    check(launches["stream_iteration_pcg"] >= 3 * k and not others,  # three launches an iteration
          f"stream PCG path: {launches} at k={k}")
    pc = neumann_banded(op.bands, op.offsets, sweeps=2)
    plain, k_plain, plain_seconds = timed(lambda: pipelined_cg_solve(
        op, b_dev, tol=tol, precond=pc, dot_precision=torch.float64, device=DEV))
    rel64 = rel64_on_card(dia, b)
    rel, rel_plain = rel64(res.x), rel64(plain.x)
    bound_iter, bound_by = bound_of(spec, torch.float32, stream_bytes(ndiag, n, 4, 4, True),
                                    stream_flops(ndiag, n, True))
    emit({"phase": "stream_pcg_path", "problem": f"lap2d_fd({GRID})", "n": n, "dtype": "float32",
          "tol": tol, "k": k, "converged": True, "bitwise_repeat": bitwise, "seconds": seconds,
          "us_per_iter": seconds / k * 1e6, "bound_us_per_iter": bound_iter * 1e3,
          "bound_by": bound_by, "launches": launches, "grid": cg_stream._stream_iteration_pcg.grid,
          "k_plain": k_plain, "plain_seconds": plain_seconds, "true_rel": rel,
          "true_rel_plain": rel_plain, "x_finite": bool(torch.isfinite(res.x).all())})
    check(bool(torch.isfinite(res.x).all()), "stream PCG result is not finite")
    check(abs(k - k_plain) <= 0.02 * k_plain, f"stream PCG: k={k} vs plain k={k_plain}")
    check(max(rel, rel_plain) <= 2 * min(rel, rel_plain),
          f"stream PCG: true residuals {rel} and {rel_plain} differ by more than 2x")
    return launches


def phase_stream_goldens() -> None:
    """The fp64 goldens through the streaming kernel, twice each: k within
    2 of the plain fp64 pipelined loop's, the reference's quality gate."""
    for problem, dia in (("lap2d_fd(100)", lap2d_fd(100)),
                         ("lap2d_reference(10000)", lap2d_reference(10000))):
        b = source_term(dia.shape[0])
        op = as_operator(dia, torch.float64, device=DEV)
        b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
        runs = [timed(lambda: dia_cg_solve_stream(op, b_dev, tol=1e-10, device=DEV))
                for _ in range(2)]
        (res, k, seconds), (res2, k2, _) = runs
        plain, k_plain, _ = timed(lambda: pipelined_cg_solve(op, b_dev, tol=1e-10, device=DEV))
        rel = true_rel(dia, res.x.cpu().numpy(), b)
        bitwise = k == k2 and torch.equal(res.x.view(torch.int64), res2.x.view(torch.int64))
        emit({"phase": "stream_golden", "problem": problem, "dtype": "float64", "k": k,
              "k_plain": k_plain, "true_rel": rel, "bitwise_repeat": bitwise, "seconds": seconds,
              "grid": cg_stream._stream_iteration.grid})
        check(bool(res.converged) and abs(k - k_plain) <= 2,
              f"stream {problem}: k={k} vs plain k={k_plain}")
        check(rel < 1e-11, f"stream {problem}: true relative residual {rel}")
        check(bitwise, f"stream {problem}: two runs differ")


def cli_run(argv):
    """One in-process CLI run with every launch count set to 0 just
    before it: returns (Run, its stdout, the launch counts just after)."""
    reset_launches()
    sync()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = cli.run(argv)
    launches = read_launches()
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


def resident_words(ndiag: int, n: int, precond: bool) -> int:
    """Words an iteration of the whole-solve kernel must move: the bands
    once, p, x and r in and out; the preconditioner adds a band pass and
    c out and back (csrc/cg_kernel.cu)."""
    return (2 * ndiag + 8) * n if precond else (ndiag + 6) * n


def seeded_state(dia, dtype):
    """Bands and a seeded (p, x, r, scal) on the card, rsold = <r, r>."""
    n = dia.shape[0]
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=DEV)
    rng = np.random.default_rng(SEED)
    p, x, r = (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=DEV) for _ in range(3))
    zero = torch.zeros((), dtype=torch.float64, device=DEV)
    return bands, [p, x, r, torch.stack([torch.sum(r.double() ** 2), zero, zero, zero])]


def chunk_call(fn, bands, state, offsets, chunk, precond, **kw):
    """One call of the chunk kernel or its plain version on ``state``
    (advanced in place; its scalars replaced), tol 0 so no iteration
    freezes."""
    state[3] = fn(bands, *state, offsets=offsets, tol=0.0, nearzero=1e-14, maxiter=10**9,
                  chunk=chunk, precond=precond, **kw)


def phase_resident_kernel(spec) -> dict:
    """The whole-solve chunk kernel against its plain version from one
    seeded state, then its time against the bound, in float32 (and under
    bfloat16 bands with the preconditioner, as the refinement's inner runs
    it). Returns the records of the kernels line for its four sites."""
    dia = lap2d_fd(RESIDENT_GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    errs = {}
    for dtype, bf16 in ((torch.float32, False), (torch.float64, False), (torch.float32, True)):
        bands, state = seeded_state(dia, dtype)
        if bf16:
            bands = bands.to(torch.bfloat16)
        for precond in (False, True):
            for chunk, rtol in ((1, VEC_RTOL[dtype]), (CHUNK, CHUNK_RTOL[dtype])):
                got, ref = [t.clone() for t in state], [t.clone() for t in state]
                chunk_call(cg_kernel.dia_cg_chunk, bands, got, offsets, chunk, precond)
                chunk_call(cg_kernel.dia_cg_chunk_ref, bands, ref, offsets, chunk, precond)
                sync()
                max_abs = max(float((g - f).abs().max()) for g, f in zip(got[:3], ref[:3]))
                vec_rel = max(rel_err(g, f, f.abs().max()) for g, f in zip(got[:3], ref[:3]))
                rsold_rel = rel_err(got[3][0], ref[3][0], ref[3][0].abs())
                dot_tol = DOT_RTOL[dtype] if chunk == 1 else rtol
                emit({"phase": "resident_kernel_check", "problem": f"lap2d_fd({RESIDENT_GRID})",
                      "dtype": str(dtype), "bands_dtype": str(bands.dtype), "precond": precond,
                      "iterations": chunk, "max_abs_err": max_abs, "vec_rel_err": vec_rel,
                      "rsold_rel_err": rsold_rel, "vec_rtol": rtol, "rsold_rtol": dot_tol,
                      "grid": cg_kernel.dia_cg_chunk.grid, "scalars": got[3].tolist(),
                      "plain_scalars": ref[3].tolist()})
                check(vec_rel <= rtol and rsold_rel <= dot_tol,
                      f"chunk kernel {dtype} bf16={bf16} precond={precond} x{chunk}: vectors "
                      f"{vec_rel}, rsold {rsold_rel}")
                check(torch.equal(got[3][1:], ref[3][1:]),
                      f"chunk kernel {dtype} bf16={bf16} precond={precond} x{chunk}: converged, k, "
                      f"breakdown {got[3][1:].tolist()} against {ref[3][1:].tolist()}")
                if dtype == torch.float32 and chunk == 1 and precond == bf16:
                    errs[bf16] = max_abs
        del bands, state
        sync()

    records = {}
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    for precond, bf16 in ((False, False), (True, False), (True, True)):
        base = torch.cuda.memory_allocated()
        bands, state = seeded_state(dia, torch.float32)
        if bf16:
            bands = bands.to(torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        ms = {layout: time_ms(lambda: chunk_call(cg_kernel.dia_cg_chunk, bands, state, offsets,
                                                 CHUNK, precond, layout=layout), reps=10, burst=2)
              for layout in cg_kernel.LAYOUTS}
        peak = torch.cuda.max_memory_allocated() - base
        plain_ms = time_ms(lambda: chunk_call(cg_kernel.dia_cg_chunk_ref, bands, state, offsets,
                                              CHUNK, precond), reps=3, burst=1)
        band_bytes = 2 if bf16 else 4
        nbytes = resident_words(ndiag, n, precond) * 4 - (4 - band_bytes) * ndiag * n * (
            2 if precond else 1)
        bound_iter, bound_by = bound_of(spec, torch.float32, nbytes, (2 * ndiag + 10) * n)
        state_bytes = cg_kernel.resident_state_bytes(ndiag, n, band_bytes, 4, precond=precond)
        rec = {"phase": "resident_kernel", "problem": f"lap2d_fd({RESIDENT_GRID})", "n": n,
               "dtype": "float32", "bands_dtype": str(bands.dtype), "precond": precond,
               "chunk": CHUNK, "grid": cg_kernel.dia_cg_chunk.grid,
               "ms_per_iter": {layout: t / CHUNK for layout, t in ms.items()},
               "bound_ms_per_iter": bound_iter, "bound_by": bound_by,
               "bound_share": {layout: bound_iter * CHUNK / t for layout, t in ms.items()},
               "plain_ms_per_iter": plain_ms / CHUNK, "max_memory_allocated": peak,
               "resident_state_bytes": state_bytes, "l2_bytes": l2}
        if max(rec["bound_share"].values()) > 1:
            rec["why_above_bound"] = (
                f"the {state_bytes / 1e6:.1f} MB state fits the card's {l2 / 1e6:.1f} MB L2, "
                "so bands and vectors come back from L2, not from HBM as the bound assumes")
        emit(rec)
        if precond == bf16:  # fp32 bands without, bf16 bands with the preconditioner
            for name, layout in (BF16_SITES if bf16 else RESIDENT_SITES).items():
                records[name] = {"max_abs_err": errs[bf16], "ms": ms[layout],
                                 "plain_ms": plain_ms, "bound_ms": bound_iter * CHUNK,
                                 "bound_by": bound_by,
                                 "library_ms": None}  # no one PyTorch call runs a CG chunk
        del bands, state
        sync()
    return records


def phase_resident_goldens() -> None:
    """The fp64 goldens through the whole-solve kernel, twice each."""
    for problem, dia in (("lap2d_fd(100)", lap2d_fd(100)),
                         ("lap2d_reference(10000)", lap2d_reference(10000))):
        b = source_term(dia.shape[0])
        op = as_operator(dia, torch.float64, device=DEV)
        b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
        runs = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            res = dia_cg_solve_vmem(op, b_dev, tol=1e-10, layout="2d", device=DEV)
            runs.append((res, int(res.iterations), time.perf_counter() - t0))
        (res, k, seconds), (res2, k2, _) = runs
        rel = true_rel(dia, res.x.cpu().numpy(), b)
        bitwise = k == k2 and torch.equal(res.x.view(torch.int64), res2.x.view(torch.int64))
        lo, hi = GOLDEN_K[problem]
        emit({"phase": "resident_golden", "problem": problem, "dtype": "float64", "k": k,
              "true_rel": rel, "bitwise_repeat": bitwise, "seconds": seconds,
              "grid": cg_kernel.dia_cg_chunk.grid})
        check(bool(res.converged) and lo <= k <= hi, f"resident {problem}: k={k} not in [{lo}, {hi}]")
        check(rel < 1e-11, f"resident {problem}: true relative residual {rel}")
        check(bitwise, f"resident {problem}: two runs differ")


def rel64_on_card(dia, b: np.ndarray):
    """x -> ||A x - b|| / ||b|| in fp64 on the card, through the plain mat-vec."""
    bands64 = torch.as_tensor(dia.bands, dtype=torch.float64, device=DEV)
    b64 = torch.as_tensor(b, dtype=torch.float64, device=DEV)

    def rel(x):
        r = dia_spmv.dia_matvec_ref(bands64, x.double(), offsets=tuple(dia.offsets)) - b64
        return float(torch.linalg.norm(r) / torch.linalg.norm(b64))
    return rel


def timed(fn):
    """(result, its iteration count, seconds to the result on the host)."""
    sync()
    t0 = time.perf_counter()
    res = fn()
    k = int(res.iterations)  # waits for the solve
    return res, k, time.perf_counter() - t0


def phase_resident_path(spec) -> dict:
    """The whole-solve kernel at N = 1e6 and 2e6, fp32, without and with
    the Neumann preconditioner: through cgx_torch.solve where the budget
    routes the size there, else (the budget came from phase_crossover) by
    a direct dia_cg_solve_vmem call, so that the kernel is still driven.
    Returns the launch counts of the first (N = 1e6, no preconditioner)
    with the direct layout="1d" call's count of site 9."""
    counts = None
    for g in RESIDENT_GRIDS:
        dia = lap2d_fd(g)
        n, ndiag = dia.shape[0], len(dia.offsets)
        b = source_term(n)
        tol = 1e-5 * float(np.linalg.norm(b))
        op = as_operator(dia, torch.float32, device=DEV)
        b_dev = torch.as_tensor(b, dtype=torch.float32, device=DEV)
        rel64 = rel64_on_card(dia, b)
        for precond in (None, "neumann"):
            state = cg_kernel.resident_state_bytes(ndiag, n, 4, 4, precond=precond is not None)
            routed = state <= config.RESIDENT_BUDGET_BYTES
            cfg = SolveConfig(precision="fp32", use_pallas=True, tolerance=tol, precond=precond)
            if routed:
                res, k, seconds, launches, bitwise = solve_twice(
                    lambda: solve(op, b_dev, cfg, device=DEV))
            else:  # solve streams this size now; drive the kernel directly
                res, k, seconds, launches, bitwise = solve_twice(lambda: dia_cg_solve_vmem(
                    op, b_dev, tol=tol, precond=precond is not None, layout="2d", device=DEV))
            # the plain fp32 (P)CG loop as solve runs it without use_pallas: fp32 vectors,
            # fp64 dots, the kernel's arithmetic (csrc/cg_kernel.cu)
            pc = None if precond is None else neumann_banded(op.bands, op.offsets, sweeps=2)
            plain, k_plain, plain_seconds = timed(lambda: cg_solve(
                op, b_dev, tol=tol, precond=pc, dot_precision=torch.float64, device=DEV))
            rel, rel_plain = rel64(res.x), rel64(plain.x)
            words = resident_words(ndiag, n, precond is not None)
            rec = {"phase": "resident_path", "problem": f"lap2d_fd({g})", "n": n,
                   "dtype": "float32", "precond": precond, "tol": tol, "k": k,
                   "through_solve": routed, "state_bytes": state,
                   "converged": bool(res.converged), "bitwise_repeat": bitwise,
                   "seconds": seconds, "us_per_iter": seconds / (k + 1) * 1e6,
                   "bound_us_per_iter": words * 4 / spec["hbm_bytes_per_s"] * 1e6,
                   "launches": launches, "grid": cg_kernel.dia_cg_chunk.grid,
                   "k_plain": k_plain, "plain_seconds": plain_seconds,
                   "plain_us_per_iter": plain_seconds / (k_plain + 1) * 1e6,
                   "true_rel": rel, "true_rel_plain": rel_plain,
                   "x_finite": bool(torch.isfinite(res.x).all())}
            if precond is None:  # the three-kernel loop on the same problem
                reset_launches()
                loop, k_loop, loop_seconds = timed(lambda: dia_cg_solve_pallas(
                    op, b_dev, tol=tol, maxiter=n, device=DEV))
                body = read_launches()["dia_matvec_dot"]
                rec.update(k_loop=k_loop, loop_seconds=loop_seconds,
                           loop_us_per_iter=loop_seconds / body * 1e6)
            emit(rec)
            chunks = -(-(k + 1) // CHUNK)
            check(rec["converged"] and rec["x_finite"] and res.x.shape == (n,),
                  f"resident path {g} {precond}: did not converge to a finite x")
            others = {name: c for name, c in launches.items()  # B1 forms the PCG's z0
                      if name not in ("dia_cg_vmem2d", "dia_matvec") and name in KERNELS and c}
            check(launches["dia_cg_vmem2d"] >= chunks and not others,
                  f"resident path {g} {precond} left the whole-solve kernel: {launches} at k={k}")
            check(bitwise, f"resident path {g} {precond}: two runs differ")
            check(abs(k - k_plain) <= 0.02 * k_plain,
                  f"resident path {g} {precond}: k={k} vs plain k={k_plain}")
            check(max(rel, rel_plain) <= 2 * min(rel, rel_plain),
                  f"resident path {g} {precond}: true residuals {rel} and {rel_plain}")
            if counts is None:
                counts = launches
                x_2d = res.x
        if g == RESIDENT_GRIDS[0]:  # site 9: the same kernel through layout="1d"
            reset_launches()
            res1, k1, seconds1 = timed(lambda: dia_cg_solve_vmem(op, b_dev, tol=tol, layout="1d",
                                                                 device=DEV))
            one_d = read_launches()["dia_cg_vmem"]
            same = torch.equal(res1.x.view(torch.int32), x_2d.view(torch.int32))
            emit({"phase": "resident_1d", "problem": f"lap2d_fd({g})", "k": k1,
                  "seconds": seconds1, "launches": one_d, "bitwise_equal_to_2d": same})
            check(one_d >= -(-(k1 + 1) // CHUNK) and same,
                  f"layout='1d': {one_d} launches, bitwise equal to 2d: {same}")
            counts["dia_cg_vmem"] = one_d
        del op, b_dev
        sync()
    return counts


def phase_crossover(spec) -> None:
    """The whole-solve kernel against the streaming kernel (bf16 bands by
    "auto", as solve runs it), and with the Neumann preconditioner
    against the streaming PCG, fp32, a fixed CROSSOVER_ITERS iterations at
    tol 0, in turns (resident, stream, stream, resident, twice) after a
    warm-up of each, the least time of each route; the three-kernel loop
    beside them for reference. The budget
    is the preconditioned state of the largest size at which both
    whole-solve routes still win (so the unpreconditioned state of that
    size is within it too)."""
    pairs = {"plain": ("resident", "stream"), "pcg": ("resident_pcg", "stream_pcg")}
    suggested, lost = 0, False
    for g in CROSSOVER_GRIDS:
        dia = lap2d_fd(g)
        n, ndiag = dia.shape[0], len(dia.offsets)
        op = as_operator(dia, torch.float32, device=DEV)
        b_dev = torch.as_tensor(source_term(n), dtype=torch.float32, device=DEV)
        it = dict(tol=0.0, maxiter=CROSSOVER_ITERS, device=DEV)
        runs = {"resident": lambda: dia_cg_solve_vmem(op, b_dev, layout="2d", **it),
                "stream": lambda: dia_cg_solve_stream(op, b_dev, bands_dtype="auto", **it),
                "resident_pcg": lambda: dia_cg_solve_vmem(op, b_dev, layout="2d", precond=True,
                                                          **it),
                "stream_pcg": lambda: dia_cg_solve_stream_pcg(op, b_dev, **it),
                "three_kernel": lambda: dia_cg_solve_pallas(op, b_dev, **it)}
        seconds = {name: [] for name in runs}
        order = [name for a, c in pairs.values() for name in (a, c) + (a, c, c, a) * 2]
        order += ["three_kernel"] * 3
        for name in order:
            res, k, t = timed(runs[name])
            check(k == CROSSOVER_ITERS, f"crossover {name} at N = {n}: k = {k}")
            seconds[name].append(t)
        us = {name: min(t[1:]) / CROSSOVER_ITERS * 1e6 for name, t in seconds.items()}
        state = {"plain": cg_kernel.resident_state_bytes(ndiag, n, 4, 4),
                 "pcg": cg_kernel.resident_state_bytes(ndiag, n, 4, 4, precond=True)}
        wins = {case: us[a] < us[c] for case, (a, c) in pairs.items()}
        hbm_us = 1e6 / spec["hbm_bytes_per_s"]
        emit({"phase": "crossover", "problem": f"lap2d_fd({g})", "n": n, "state_bytes": state,
              "us_per_iter": us, "seconds": seconds, "resident_wins": wins,
              "bound_us_per_iter": {"resident": resident_words(ndiag, n, False) * 4 * hbm_us,
                                    "stream": stream_bytes(ndiag, n, 2, 4, False) * hbm_us,
                                    "stream_pcg": stream_bytes(ndiag, n, 4, 4, True) * hbm_us}})
        lost = lost or not all(wins.values())
        if not lost:
            suggested = state["pcg"]
        del op, b_dev
        sync()
    emit({"phase": "crossover_budget", "budget_from_sweep": suggested,
          "configured_budget_bytes": config.RESIDENT_BUDGET_BYTES})


def mixed_inner(n: int, ndiag: int) -> str:
    """The kernel site the fp32 inner solves of the refinement run at this
    size under the configured budget (cgx_torch.solver.refine)."""
    budget = config.RESIDENT_BUDGET_BYTES
    if cg_kernel.resident_state_bytes(ndiag, n, 4, 4, precond=True) <= budget:
        return "dia_cg_vmem2d"
    if cg_kernel.resident_state_bytes(ndiag, n, 2, 4, precond=True) <= budget:
        return "dia_cg_vmem2d_bf16b"
    return "stream_iteration_pcg"


def phase_mixed(spec) -> None:
    """precision="mixed" on lap2d_fd(1000) at rtol 1e-11, beside the
    plain fp64 loop to the same relative tolerance."""
    dia = lap2d_fd(RESIDENT_GRID)
    n = dia.shape[0]
    b = source_term(n)
    op64 = as_operator(dia, torch.float64, device=DEV)
    b64 = torch.as_tensor(b, dtype=torch.float64, device=DEV)
    rel64 = rel64_on_card(dia, b)
    inner = mixed_inner(n, len(dia.offsets))
    reset_launches()
    res, sweeps, seconds = timed(lambda: solve(op64, b64, SolveConfig(precision="mixed",
                                                                      tolerance=1e-11),
                                               device=DEV))
    launches = read_launches()
    plain, k_plain, plain_seconds = timed(lambda: cg_solve(
        op64, b64, tol=1e-11 * float(np.linalg.norm(b)), device=DEV))
    rel, rel_plain = rel64(res.x), rel64(plain.x)
    emit({"phase": "mixed", "problem": f"lap2d_fd({RESIDENT_GRID})", "n": n, "rtol": 1e-11,
          "sweeps": sweeps, "converged": bool(res.converged), "true_rel": rel, "inner": inner,
          "seconds": seconds, "launches": launches, "k_plain_fp64": k_plain,
          "plain_seconds": plain_seconds, "true_rel_plain": rel_plain})
    check(bool(res.converged) and rel < 1e-11 and sweeps <= 4,
          f"mixed: converged={bool(res.converged)}, true relative residual {rel}, {sweeps} sweeps")
    check(launches[inner] >= sweeps, f"mixed: inner solves missed {inner}: {launches}")


def phase_mixed_above(spec) -> dict:
    """iterative_refinement(use_pallas=True) on lap2d_fd(1000) with the
    budget set so that the inner solves run the streaming PCG, then the
    whole-solve kernel under bfloat16 bands: each below 1e-11 within
    max_outer = 8. Returns the bf16 sites' launch counts: the 2d one from
    the second run, the 1d one from a direct call."""
    dia = lap2d_fd(RESIDENT_GRID)
    n, ndiag = dia.shape[0], len(dia.offsets)
    b = source_term(n)
    op64 = as_operator(dia, torch.float64, device=DEV)
    b64 = torch.as_tensor(b, dtype=torch.float64, device=DEV)
    rel64 = rel64_on_card(dia, b)
    bf16_state = cg_kernel.resident_state_bytes(ndiag, n, 2, 4, precond=True)
    counts = {}
    configured = config.RESIDENT_BUDGET_BYTES
    try:
        for inner, budget in (("stream_iteration_pcg", bf16_state - 1),
                              ("dia_cg_vmem2d_bf16b", bf16_state)):
            config.RESIDENT_BUDGET_BYTES = budget
            check(mixed_inner(n, ndiag) == inner, f"budget {budget} does not route to {inner}")
            reset_launches()
            sync()
            t0 = time.perf_counter()
            res = iterative_refinement(op64, b64, tol=0.0, rtol=1e-11, max_outer=8,
                                       use_pallas=True, device=DEV)
            seconds = time.perf_counter() - t0  # the host read of each sweep's norm waited
            launches = read_launches()
            rel = rel64(res.x)
            inner_k = res.inner_iterations.tolist()
            emit({"phase": "mixed_above_budget", "problem": f"lap2d_fd({RESIDENT_GRID})",
                  "n": n, "budget_bytes": budget, "inner": inner, "sweeps": res.outer_iterations,
                  "inner_iterations": inner_k, "converged": bool(res.converged), "true_rel": rel,
                  "seconds": seconds, "launches": launches})
            check(bool(res.converged) and rel < 1e-11 and res.outer_iterations <= 8,
                  f"mixed above the budget ({inner}): converged={bool(res.converged)}, "
                  f"true relative residual {rel}, {res.outer_iterations} sweeps")
            # a launch an iteration for the streaming PCG, a chunk of 512 for the resident one
            need = sum(inner_k) if inner == "stream_iteration_pcg" else res.outer_iterations
            check(launches[inner] >= max(need, 1),
                  f"mixed above the budget: inner solves missed {inner}: {launches}")
            counts[inner] = launches[inner]
    finally:
        config.RESIDENT_BUDGET_BYTES = configured
    # site 9 under bfloat16 bands: the same inner through layout="1d"
    op32 = as_operator(dia, torch.float32, device=DEV)
    r32 = (b64 / torch.linalg.norm(b64)).to(torch.float32)
    reset_launches()
    res1, k1, seconds1 = timed(lambda: dia_cg_solve_vmem(
        op32, r32, tol=1e-6, precond=True, bands_dtype=torch.bfloat16, layout="1d", device=DEV))
    counts["dia_cg_vmem_bf16b"] = read_launches()["dia_cg_vmem_bf16b"]
    emit({"phase": "bf16_bands_1d", "problem": f"lap2d_fd({RESIDENT_GRID})", "k": k1,
          "converged": bool(res1.converged), "seconds": seconds1,
          "launches": counts["dia_cg_vmem_bf16b"]})
    check(bool(res1.converged) and counts["dia_cg_vmem_bf16b"] >= -(-(k1 + 1) // CHUNK),
          f"bf16 bands, layout='1d': converged {bool(res1.converged)}, "
          f"{counts['dia_cg_vmem_bf16b']} launches")
    return counts


def bound_mixed(spec, nbytes: float, ops: dict):
    """bound_of for work in several dtypes: ``ops`` maps a dtype to its
    operations, each at its own peak rate."""
    t_bytes = nbytes / spec["hbm_bytes_per_s"] * 1e3
    t_ops = sum(c / spec["flops_per_s"][dt] for dt, c in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sstep_bound(spec, site: str, ndiag: int, n: int, dtype, bands_item: int):
    """The least time of one launch of an s-step site at SSTEP_S. Bytes:
    the bands, p and r read once; the basis written (matrix powers), or x
    read and x, r and p written (recover); the Gram and the state are a
    few hundred words. Operations: the 2s-1 band applications of the
    basis and their Chebyshev terms in the vectors' dtype, the Gram's
    m(m+1)/2 products and sums in float64, the recovery's 3m of each."""
    s, m = SSTEP_S, 2 * SSTEP_S + 1
    item = torch.finfo(dtype).bits // 8
    if site == "sstep_replay":  # G and B in, the state out; 3 m x m forms an iteration
        return bound_mixed(spec, (2 * m * m + 3 * m + 8) * 8,
                           {torch.float64: s * 6 * m * m})
    basis = (2 * ndiag + 4) * (2 * s - 1) * n
    words = {"dia_sstep_basis_planes": m, "sstep_gram": 0, "sstep_recover": 4}[site]
    ops = {dtype: basis}
    if site == "sstep_gram":
        ops[torch.float64] = ops.get(torch.float64, 0) + m * (m + 1) * n
    if site == "sstep_recover":
        ops[dtype] += 6 * m * n
    return bound_mixed(spec, n * (ndiag * bands_item + (2 + words) * item), ops)


def sstep_kw(dia, bounds, shifts=()) -> dict:
    lmin, lmax = bounds
    return dict(offsets=tuple(dia.offsets), s=SSTEP_S, theta=(lmax + lmin) / 2.0,
                delta=(lmax - lmin) / 2.0, shifts=tuple(shifts))


def seeded_block(bands, p, r, kw) -> ss.BlockState:
    """A live block on the card with p and r in half 0 of their pairs."""
    st = ss.initial_state(bands, r, torch.zeros_like(r), 0.0, **kw)
    st.p[0].copy_(p)
    return st


def pair_sums(v: torch.Tensor):
    """(sum v_i v_j, sum |v_i v_j|) for i <= j, in float64, products
    formed one pair at a time (exact for float32 v) and summed by
    torch.sum: the yardstick of the Gram's error and its scale."""
    m = v.shape[0]
    exact, scale = torch.zeros(m, m, dtype=torch.float64, device=v.device), torch.zeros(
        m, m, dtype=torch.float64, device=v.device)
    for i in range(m):
        for j in range(i, m):
            prod = v[i] * v[j]
            exact[i, j] = exact[j, i] = prod.sum()
            scale[i, j] = scale[j, i] = prod.abs().sum()
    return exact, scale


SSTEP_CONTROL = dict(tol=0.0, nearzero=1e-14, maxiter=10**9)  # no iteration freezes


def sstep_inputs(case: str, dia):
    """The case's bands on the card, the bands its kernels stream, and
    seeded p and r."""
    dtype, bf16 = SSTEP_CASES[case]
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=DEV)
    rng = np.random.default_rng(SEED)
    p, r = (torch.as_tensor(rng.standard_normal(dia.shape[0]), dtype=dtype, device=DEV)
            for _ in range(2))
    return bands, bands.to(torch.bfloat16) if bf16 else bands, p, r


def sstep_checks(case: str, basis: str, dia, kw) -> dict:
    """One case of the s-step kernels against their plain versions from
    seeded p and r; returns each site's max abs error."""
    dtype, bf16 = SSTEP_CASES[case]
    n = dia.shape[0]
    bands, kb, p, r = sstep_inputs(case, dia)
    errs = {}
    where = f"sstep {case} {basis}"
    if not bf16:  # the matrix-powers kernel: bands in the vectors' dtype
        got = dia_powers.dia_sstep_basis_planes(bands, p, r, **kw)
        want = ss.dia_sstep_basis_ref(bands, p, r, **kw)
        sync()
        errs["dia_sstep_basis_planes"] = float((got - want).abs().max())
        check(torch.equal(got, want), f"{where}: the matrix-powers basis is not the plain one, "
                                      f"max abs {errs['dia_sstep_basis_planes']}")
        del got, want
    m = 2 * SSTEP_S + 1
    gram = slice(ss.GRAM, ss.GRAM + m * m)
    coef = slice(ss.COEF, ss.COEF + 3 * m)
    flags = [ss.K, ss.CONV, ss.BRK, ss.LIVE]
    start = seeded_block(bands, p, r, kw)
    got, want = (ss.BlockState(*(t.clone() for t in start)) for _ in range(2))
    ss._sstep_gram(kb, got.p, got.r, got.state, got.bmat, **kw, **SSTEP_CONTROL)
    ss._gram_ref(kb, want.p, want.r, want.state, want.bmat, **kw, **SSTEP_CONTROL)
    sync()
    g_kern, g_plain = got.state[gram].view(m, m), want.state[gram].view(m, m)
    exact, scale = pair_sums(ss.dia_sstep_basis_ref(kb, p, r, **kw).double())
    gram_rel = float(((g_kern - g_plain).abs() / scale).max())
    kern_exact = float(((g_kern - exact).abs() / scale).max())
    plain_exact = float(((g_plain - exact).abs() / scale).max())
    errs["sstep_gram"] = float((g_kern - g_plain).abs().max())
    check(gram_rel <= GRAM_RTOL, f"{where}: Gram off the plain one by {gram_rel} of sum|v_i v_j|")
    check(kern_exact <= GRAM_RTOL, f"{where}: Gram off the exact sums by {kern_exact}")
    # the replay: the replay kernel and its plain version on the kernel's G, from
    # the start's scalars; the Gram launch's own replay runs the same device code
    rk, rp = start.state.clone(), start.state.clone()
    rk[gram] = got.state[gram]
    rp[gram] = got.state[gram]
    ss.sstep_replay(rk, start.bmat, s=SSTEP_S, **SSTEP_CONTROL)
    ss._replay_ref(rp, start.bmat, s=SSTEP_S, **SSTEP_CONTROL)
    sync()
    c_max = float(rp[coef].abs().max())
    coef_rel = float((rk[coef] - rp[coef]).abs().max()) / c_max
    errs["sstep_replay"] = float((rk[coef] - rp[coef]).abs().max())
    same_in_gram = torch.equal(rk[coef], got.state[coef])
    check(coef_rel <= COEF_RTOL and torch.equal(rk[flags[:3]], rp[flags[:3]]),
          f"{where}: replay coefficients off by {coef_rel}, k/conv/brk "
          f"{rk[flags[:3]].tolist()} against {rp[flags[:3]].tolist()}")
    check(same_in_gram, f"{where}: the Gram launch's replay is not the replay kernel's")
    check(torch.equal(got.state[flags], want.state[flags]),
          f"{where}: k/conv/brk/live {got.state[flags].tolist()} against "
          f"{want.state[flags].tolist()}")
    # the recover launch from the same coefficients on both sides
    want.state.copy_(got.state)
    ss._sstep_recover(kb, got.p, got.r, got.x, got.state, **kw)
    ss._recover_ref(kb, want.p, want.r, want.x, want.state, **kw)
    sync()
    errs["sstep_recover"] = max(float((a - w).abs().max()) for a, w in zip(got[:3], want[:3]))
    same = all(torch.equal(a, w) for a, w in zip(got[:4], want[:4]))
    check(same, f"{where}: recovered x, r, p or state differ from the plain version, "
                f"max abs {errs['sstep_recover']}")
    emit({"phase": "sstep_kernel_check", "case": case, "basis": basis,
          "problem": f"lap2d_fd({GRID})", "n": n, "dtype": str(dtype),
          "bands_dtype": str(kb.dtype), "max_abs_err": errs, "gram_rel_err": gram_rel,
          "gram_rel_err_to_exact": kern_exact, "plain_gram_rel_err_to_exact": plain_exact,
          "coef_rel_err": coef_rel, "powers_checked": not bf16, "recover_bitwise": same,
          "state_after_gram": got.state[:ss.COEF].tolist(),
          "grid": {"gram": ss._sstep_gram.grid, "recover": ss._sstep_recover.grid}})
    return errs


def sstep_times(spec, case: str, dia, kw) -> dict:
    """ms of a launch of each s-step site in this case (Chebyshev), beside
    its bound, the plain version's ms and the peak device memory."""
    dtype, bf16 = SSTEP_CASES[case]
    n, ndiag = dia.shape[0], len(dia.offsets)
    bands, kb, p, r = sstep_inputs(case, dia)
    st = seeded_block(bands, p, r, kw)
    work = ss.workspace(DEV, n, kw["offsets"], SSTEP_S, dtype)
    # each recover launch from half 0 with the mark of a live Gram launch: a 1-element copy
    live = torch.tensor([0.0, 1.0], dtype=torch.float64, device=DEV)

    def recover(fn, **extra):
        st.state[ss.BLK:ss.LIVE + 1].copy_(live)
        fn(kb, st.p, st.r, st.x, st.state, **kw, **extra)

    runs = {
        "sstep_gram": (lambda: ss._sstep_gram(kb, st.p, st.r, st.state, st.bmat, work=work, **kw,
                                              **SSTEP_CONTROL),
                       lambda: ss._gram_ref(kb, st.p, st.r, st.state, st.bmat, **kw,
                                            **SSTEP_CONTROL)),
        "sstep_recover": (lambda: recover(ss._sstep_recover, work=work),
                          lambda: recover(ss._recover_ref)),
        "sstep_replay": (lambda: ss.sstep_replay(st.state, st.bmat, s=SSTEP_S, **SSTEP_CONTROL),
                         lambda: ss._replay_ref(st.state, st.bmat, s=SSTEP_S, **SSTEP_CONTROL)),
    }
    if not bf16:
        runs["dia_sstep_basis_planes"] = (lambda: dia_powers.dia_sstep_basis_planes(bands, p, r,
                                                                                    **kw),
                                          lambda: ss.dia_sstep_basis_ref(bands, p, r, **kw))
    records = {}
    for site, (kern, plain) in runs.items():
        sync()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(kern)
        peak = torch.cuda.max_memory_allocated()
        plain_ms = time_ms(plain, reps=3, burst=1)
        bound, bound_by = sstep_bound(spec, site, ndiag, n, dtype,
                                      2 if bf16 else torch.finfo(dtype).bits // 8)
        rec = {"phase": "sstep_kernel", "site": site, "case": case,
               "problem": f"lap2d_fd({GRID})", "n": n, "s": SSTEP_S, "dtype": str(dtype),
               "bands_dtype": str(kb.dtype), "ms": ms, "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / ms, "plain_ms": plain_ms, "max_memory_allocated": peak,
               "grid": SSTEP_SITES[site].grid}
        if site == "sstep_recover":
            rec["note"] = "each timed call also copies 2 words of the state (the live mark)"
        emit(rec)
        records[site] = rec
    del bands, kb, st, work
    sync()
    return records


def phase_sstep_bounds():
    """The Lanczos bounds of lap2d_fd(GRID) on the card, once: set-up of
    the s-step phases, timed apart from the solves; beside them cgx's host
    NumPy steps on the same operator, timed, and the two paths' relative
    difference (the CPU tests hold it to 1e-12)."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    op = as_operator(dia, torch.float32, device=DEV)
    sync()
    t0 = time.perf_counter()
    bounds = spectral_bounds(op, n)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = lanczos_bounds(host_matvec(op), n)
    host_seconds = time.perf_counter() - t0
    card = lanczos_bounds(device_matvec(op), n, device=op.bands.device)
    rel = max(abs(a - c) / abs(c) for a, c in zip(card, host))
    emit({"phase": "sstep_bounds", "problem": f"lap2d_fd({GRID})", "n": n,
          "lmin": bounds[0], "lmax": bounds[1], "seconds": seconds,
          "host_lanczos_seconds": host_seconds, "card_vs_host_rel": rel})
    check(0 < bounds[0] < bounds[1], f"Lanczos bounds {bounds}")
    return bounds, seconds


def phase_sstep_kernels(spec, bounds) -> dict:
    """The s-step kernels against their plain versions on lap2d_fd(GRID),
    Chebyshev and Newton, in every case; then their times (Chebyshev).
    Returns the records of the kernels line for the four sites."""
    dia = lap2d_fd(GRID)
    op = as_operator(dia, torch.float32, device=DEV)
    shifts = newton_shifts(op, dia.shape[0], SSTEP_S, bounds)
    del op
    errs = {}
    for case in SSTEP_CASES:
        for basis, sh in (("chebyshev", ()), ("newton", shifts)):
            e = sstep_checks(case, basis, dia, sstep_kw(dia, bounds, sh))
            if basis == "chebyshev":
                errs[case] = e
            sync()
    records = {}
    for case in SSTEP_CASES:
        for site, rec in sstep_times(spec, case, dia, sstep_kw(dia, bounds)).items():
            if SSTEP_MAIN_CASE[site] == case:
                records[site] = {"max_abs_err": errs[case][site], "ms": rec["ms"],
                                 "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                                 "bound_by": rec["bound_by"],
                                 "library_ms": None}  # no one PyTorch call builds a Krylov basis
    return records


SSTEP_ROUTES = {"fused": ("sstep_gram", "sstep_recover"),
                "pallas": ("dia_sstep_basis_planes", "sstep_replay")}


def phase_sstep_path(spec, bounds, bounds_seconds: float, b4: dict) -> dict:
    """solve(lap2d_fd(GRID), fp32, method="sstep"): "auto" resolves to the
    fused kernels (bfloat16 bands by "auto"); then sstep_powers="pallas",
    the matrix-powers and replay kernels. Each twice, bitwise equal,
    against the plain fp32 s-step loop with a float64 Gram (the kernels'
    arithmetic), beside the main path's streaming kernel. solve estimates
    the Lanczos bounds itself; the plain loop is given them. Returns the
    launch counts of each route's sites."""
    dia = lap2d_fd(GRID)
    n, ndiag = dia.shape[0], len(dia.offsets)
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    op = as_operator(dia, torch.float32, device=DEV)
    b_dev = torch.as_tensor(b, dtype=torch.float32, device=DEV)
    rel64 = rel64_on_card(dia, b)
    plain, k_plain, plain_seconds = timed(lambda: sstep_cg_solve(
        op, b_dev, s=SSTEP_S, bounds=bounds, tol=tol, powers="off",
        gram_precision=torch.float64, device=DEV))
    rel_plain = rel64(plain.x)
    check(bool(plain.converged), "the plain s-step loop did not converge")
    counts = {}
    for route, sites in SSTEP_ROUTES.items():
        cfg = SolveConfig(precision="fp32", method="sstep", tolerance=tol,
                          **({"sstep_powers": "pallas"} if route == "pallas" else {}))
        res, k, seconds, launches, bitwise = solve_twice(lambda: solve(op, b_dev, cfg, device=DEV))
        fallback = launches["stream_iteration"]  # B4 finishes a solve whose replay broke down
        rel = rel64(res.x)
        blocks = launches[sites[0]]
        bound_sites = sites if route == "fused" else sites[:1]  # the replay is a few words
        bound_block = sum(sstep_bound(spec, site, ndiag, n, torch.float32,
                                      2 if route == "fused" else 4)[0] for site in bound_sites)
        rec = {"phase": "sstep_path", "route": route, "problem": f"lap2d_fd({GRID})", "n": n,
               "dtype": "float32", "s": SSTEP_S, "tol": tol, "k": k,
               "converged": bool(res.converged), "fell_back_to_b4": fallback > 0,
               "b4_launches": fallback, "bitwise_repeat": bitwise, "seconds": seconds,
               "bounds_seconds": bounds_seconds,
               "us_per_iter": (seconds - bounds_seconds) / k * 1e6,
               "blocks_launched": blocks, "launches": {s_: launches[s_] for s_ in SSTEP_SITES},
               "bands_dtype": str(ss._sstep_gram.bands_dtype) if route == "fused" else "float32",
               "bound_us_per_iter": bound_block / SSTEP_S * 1e3,
               "bound_counts": bound_sites,
               "k_plain": k_plain, "plain_seconds": plain_seconds,
               "plain_us_per_iter": plain_seconds / k_plain * 1e6, "true_rel": rel,
               "true_rel_plain": rel_plain, "b4_k": b4["k"], "b4_seconds": b4["seconds"],
               "b4_us_per_iter": b4["us_per_iter"], "b4_true_rel": b4["true_rel"],
               "x_finite": bool(torch.isfinite(res.x).all())}
        emit(rec)
        where = f"sstep path ({route})"
        check(rec["converged"] and rec["x_finite"] and res.x.shape == (n,),
              f"{where}: did not converge to a finite x")
        check(bitwise, f"{where}: two runs differ")
        check(blocks >= 1 and launches[sites[1]] == blocks,
              f"{where}: launches {launches} at k={k}")
        check(fallback > 0 or blocks * SSTEP_S >= k, f"{where}: {blocks} blocks for k={k}")
        others = {name: c for name, c in launches.items()
                  if name not in (*sites, "stream_iteration") and name in KERNELS and c}
        check(not others, f"{where} launched other kernels: {others}")
        check(abs(k - k_plain) <= 0.02 * k_plain, f"{where}: k={k} vs plain k={k_plain}")
        check(max(rel, rel_plain) <= 2 * min(rel, rel_plain),
              f"{where}: true residuals {rel} and {rel_plain} differ by more than 2x")
        counts.update({site: launches[site] for site in sites})
    phase_sstep_profile(op, b_dev, bounds)
    return counts


def phase_sstep_profile(op, b_dev, bounds) -> None:
    """Device time by kernel and the card's idle share over
    SSTEP_PROFILE_BLOCKS fused blocks (tol 0, so none stops early)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cgx_torch import dia_sstep_stream_solve

    iters = SSTEP_PROFILE_BLOCKS * SSTEP_S
    kw = dict(s=SSTEP_S, bounds=bounds, tol=0.0, maxiter=iters, device=DEV)
    dia_sstep_stream_solve(op, b_dev, **kw)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        k = int(dia_sstep_stream_solve(op, b_dev, **kw).iterations)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy_us, count = {}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((kn for kn in ("gram_kernel", "recover_kernel") if kn in e.name), "other")
        us = e.time_range.elapsed_us()
        by_name[name] = by_name.get(name, 0.0) + us / SSTEP_PROFILE_BLOCKS
        busy_us += us
        count += 1
    emit({"phase": "sstep_profile", "blocks": SSTEP_PROFILE_BLOCKS, "k": k,
          "device_events": count, "device_us_per_block": by_name,
          "device_busy_us_per_block": busy_us / SSTEP_PROFILE_BLOCKS,
          "profiled_wall_us_per_block": wall_us / SSTEP_PROFILE_BLOCKS,
          "idle_share": 1 - busy_us / wall_us})
    check(k == iters and by_name.get("gram_kernel", 0) > 0 and by_name.get("recover_kernel", 0) > 0,
          f"sstep profile: k={k}, device time {by_name}")


def phase_sstep_goldens() -> None:
    """dia_sstep_stream_solve in float64 at tol 1e-10, twice each: k within
    s of the plain float64 s-step loop; the true residual below the
    reference's 1e-11, or within 2x of that loop's where the s-step
    recurrence's own floor is there: on lap2d_reference(10000) the plain
    loop lands between 8.6e-12 and 1.2e-11 by the Gram's summation order
    alone (an exact Gram: 1.07e-11), while ||b|| = 7.0e6 puts the
    recursive residual at 1.4e-17."""
    from cgx_torch import dia_sstep_stream_solve

    for problem, dia in (("lap2d_fd(100)", lap2d_fd(100)),
                         ("lap2d_reference(10000)", lap2d_reference(10000))):
        b = source_term(dia.shape[0])
        op = as_operator(dia, torch.float64, device=DEV)
        b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
        bounds = spectral_bounds(op, dia.shape[0])
        kw = dict(s=SSTEP_S, bounds=bounds, tol=1e-10, device=DEV)
        runs = [timed(lambda: dia_sstep_stream_solve(op, b_dev, **kw)) for _ in range(2)]
        (res, k, seconds), (res2, k2, _) = runs
        plain, k_plain, _ = timed(lambda: sstep_cg_solve(op, b_dev, powers="off",
                                                         gram_precision=torch.float64, **kw))
        rel, rel_plain = true_rel(dia, res.x.cpu().numpy(), b), true_rel(dia, plain.x.cpu().numpy(), b)
        bitwise = k == k2 and torch.equal(res.x.view(torch.int64), res2.x.view(torch.int64))
        emit({"phase": "sstep_golden", "problem": problem, "dtype": "float64", "s": SSTEP_S,
              "k": k, "k_plain": k_plain, "true_rel": rel, "true_rel_plain": rel_plain,
              "breakdown": bool(res.breakdown), "bitwise_repeat": bitwise, "seconds": seconds})
        check(bool(res.converged) and abs(k - k_plain) <= SSTEP_S,
              f"sstep {problem}: k={k} vs plain k={k_plain}")
        check(rel < max(1e-11, 2 * rel_plain),
              f"sstep {problem}: true relative residual {rel} (plain loop {rel_plain})")
        check(bitwise, f"sstep {problem}: two runs differ")


def phase_stream_matvec(spec) -> dict:
    """Kernel B8 on lap2d_fd(GRID), float32 and float64: both entry
    points against their plain versions, bitwise; the sharded halo
    mat-vec's local product with B8 and seeded, non-zero halos against
    its plain "xla" form, bitwise; then the times of each entry point,
    its plain version and torch.sparse's CSR product. Returns the float32
    records (the sharded route's dtype)."""
    dia = lap2d_fd(GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    records = {}
    for dtype in (torch.float32, torch.float64):
        bands = torch.as_tensor(dia.bands, dtype=dtype, device=DEV)
        planes = dia_spmv.stream2d_band_planes(bands, rows=sc.PLANE_ROWS,
                                               cols=sc.PLANE_COLS).contiguous()
        rng = np.random.default_rng(SEED)
        x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=DEV)
        want = dia_spmv.dia_matvec_ref(bands, x, offsets=offsets)
        flat = dia_spmv.dia_matvec_stream(bands, x, offsets=offsets)
        plane = dia_spmv.dia_matvec_stream2d_planes(planes, x, offsets=offsets)
        sync()
        same = {"dia_matvec_stream": torch.equal(flat, want),
                "dia_matvec_stream2d_planes": torch.equal(plane, want)}
        # the halo mat-vec of rank 1 of 4: its rows of the bands, its block of x,
        # and the neighbours' edge rows of x as its (non-zero) halos
        mesh = make_mesh(device=DEV)
        halo, n_loc = max(abs(o) for o in offsets), n // 4
        lo, hi = n_loc, 2 * n_loc
        left, right = x[lo - halo: lo], x[hi: hi + halo]
        shard = bands[:, lo:hi].contiguous()
        shard_planes = dia_spmv.stream2d_band_planes(shard, rows=sc.PLANE_ROWS,
                                                     cols=sc.PLANE_COLS).contiguous()
        xla = sc._DiaHalo(mesh, shard, offsets, n_loc, local_kernel="xla").local(
            x[lo:hi], left, right)
        st = sc._DiaHalo(mesh, shard_planes, offsets, n_loc, local_kernel="stream2d").local(
            x[lo:hi], left, right)
        sync()
        same["halo_stream2d_vs_xla"] = torch.equal(st, xla)
        same["halo_xla_vs_global_rows"] = torch.equal(xla, want[lo:hi])
        emit({"phase": "stream_matvec_check", "problem": f"lap2d_fd({GRID})", "n": n,
              "dtype": str(dtype), "bitwise": same, "halo": halo, "shard_rows": [lo, hi],
              "halo_max_abs": float(torch.maximum(left.abs().max(), right.abs().max()))})
        del shard, shard_planes
        check(all(same.values()), f"B8 {dtype}: not bitwise equal to the plain versions: {same}")
        del flat, plane, want, xla, st
        csr = csr_of(bands, offsets)
        cases = {
            "dia_matvec_stream": (
                lambda: dia_spmv.dia_matvec_stream(bands, x, offsets=offsets),
                lambda: dia_spmv.dia_matvec_stream_ref(bands, x, offsets=offsets),
                lambda: torch.mv(csr, x), (ndiag + 2) * n, 2 * ndiag * n),
            "dia_matvec_stream2d_planes": (
                lambda: dia_spmv.dia_matvec_stream2d_planes(planes, x, offsets=offsets),
                lambda: dia_spmv.dia_matvec_stream2d_planes_ref(planes, x, offsets=offsets),
                lambda: torch.mv(csr, x), (ndiag + 2) * n, 2 * ndiag * n),
        }
        recs = measure_cases(spec, f"lap2d_fd({GRID}) B8", dtype, n, cases, {})
        if dtype == torch.float32:
            records = recs
        del bands, planes, csr, x
        sync()
    return records


@contextlib.contextmanager
def nccl_mesh():
    """A real NCCL process group of one rank (a FileStore in a temporary
    directory) and the mesh over it; destroyed on the way out."""
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device(DEV, torch.cuda.current_device()))
        try:
            mesh = make_mesh(1, device=DEV)
            check(mesh.group is not None and dist.get_backend(mesh.group) == "nccl",
                  f"the mesh is not an NCCL group: {mesh}")
            emit({"phase": "nccl_group", "world": dist.get_world_size(), "rank": mesh.rank,
                  "backend": dist.get_backend(mesh.group), "device": str(mesh.device),
                  "nccl": str(torch.cuda.nccl.version())})
            yield mesh
        finally:
            dist.destroy_process_group()


def phase_sharded(spec, mesh, b4: dict) -> dict:
    """The sharded route through solve(..., mesh=mesh) on one NCCL rank:
    lap2d_fd(GRID) in fp32 (float64 dots) at tol 1e-5 ||b||, "auto"
    resolving the local product to B8. The reference method twice
    (bitwise), against the plain classic loop of the main phase (the same
    recurrence; k within 2%, true residual within 2x); the pipelined
    method likewise against the plain pipelined loop. The collectives of
    each iteration from the recorder; B1 must not run. Returns B8's
    launch counts from the reference run."""
    dia = lap2d_fd(GRID)
    n, ndiag = dia.shape[0], len(dia.offsets)
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    rel64 = rel64_on_card(dia, b)
    resolved = sc._resolve_local_kernel("auto", n, torch.float32, mesh.device)
    check(resolved == "stream2d", f"auto resolved the local product to {resolved!r}")
    t0 = time.perf_counter()
    make_sharded_solver(dia, n, dtype=np.float32, mesh=mesh, tol=tol,
                        dot_precision=torch.float64)
    sync()
    setup_seconds = time.perf_counter() - t0  # the shard's planes built and uploaded
    counts = {}
    for method, plain_k, plain_rel in (("reference", b4["k_classic"], b4["true_rel_classic"]),
                                       ("pipelined", b4["k_plain"], b4["true_rel_plain"])):
        cfg = SolveConfig(precision="fp32", tolerance=tol, method=method)
        with collectives.capture() as cap:
            res, k, seconds, launches, bitwise = solve_twice(
                lambda: solve(dia, b, cfg, mesh=mesh, device=DEV))
        sigs = [cap.signature(i) for i in range(len(cap.programs))]
        rel = rel64(res.x)
        b8 = launches["dia_matvec_stream2d_planes"]
        others = {name: c for name, c in launches.items()
                  if name != "dia_matvec_stream2d_planes" and name in KERNELS and c}
        bound_iter, bound_by = bound_of(spec, torch.float32, (ndiag + 2) * n * 4, 2 * ndiag * n)
        rec = {"phase": "sharded", "method": method, "problem": f"lap2d_fd({GRID})", "n": n,
               "dtype": "float32", "world": mesh.size, "backend": dist.get_backend(mesh.group),
               "local_kernel": resolved, "tol": tol, "k": k, "converged": bool(res.converged),
               "bitwise_repeat": bitwise, "seconds": seconds, "setup_seconds": setup_seconds,
               "us_per_iter": (seconds - setup_seconds) / k * 1e6,
               "b8_bound_us_per_iter": bound_iter * 1e3, "bound_by": bound_by,
               "launches": launches, "b8_launches": b8,
               "signature_iter": sigs[0]["iter"], "signature_setup": sigs[0]["setup"],
               "signature_uniform": all(sg["uniform"] for sg in sigs),
               "loop_iterations": sigs[0]["iterations"],
               "k_plain": plain_k, "true_rel": rel, "true_rel_plain": plain_rel,
               "x_finite": bool(torch.isfinite(res.x).all())}
        emit(rec)
        where = f"sharded {method}"
        check(rec["converged"] and rec["x_finite"] and res.x.shape == (n,),
              f"{where}: did not converge to a finite x")
        check(bitwise, f"{where}: two runs differ")
        check(b8 >= k + 1 and launches["dia_matvec"] == 0 and not others,
              f"{where}: launches {launches} at k={k}")
        check(all(sg["iter"] == SHARDED_SIGNATURE[method] and sg["uniform"] for sg in sigs),
              f"{where}: collectives an iteration {sigs[0]['iter']}")
        check(abs(k - plain_k) <= 0.02 * plain_k, f"{where}: k={k} vs plain k={plain_k}")
        check(max(rel, plain_rel) <= 2 * min(rel, plain_rel),
              f"{where}: true residuals {rel} and {plain_rel} differ by more than 2x")
        if method == "reference":
            counts = {name: launches[name] for name in B8_SITES}
        del res
        sync()
    phase_sharded_profile(mesh, dia, b)
    return counts


def phase_sharded_profile(mesh, dia, b) -> None:
    """Device time by kernel (B8, NCCL, the rest) and the card's idle
    share over PROFILE_ITERS iterations of the sharded reference route,
    from torch.profiler; the shard is built before the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver = make_sharded_solver(dia, dia.shape[0], dtype=np.float32, mesh=mesh, tol=0.0,
                                 maxiter=PROFILE_ITERS, dot_precision=torch.float64)
    solver.solve(b)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        k = int(solver.solve(b).iterations)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy_us, count = {}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        name = ("b8_dia_stream_kernel" if "dia_stream_kernel" in low else
                "nccl" if "nccl" in low else "other")
        us = e.time_range.elapsed_us()
        by_name[name] = by_name.get(name, 0.0) + us / PROFILE_ITERS
        busy_us += us
        count += 1
    emit({"phase": "sharded_profile", "iterations": PROFILE_ITERS, "k": k,
          "device_events": count, "device_events_per_iter": count / PROFILE_ITERS,
          "device_us_per_iter": by_name, "device_busy_us_per_iter": busy_us / PROFILE_ITERS,
          "profiled_wall_us_per_iter": wall_us / PROFILE_ITERS,
          "idle_share": 1 - busy_us / wall_us})
    check(k == PROFILE_ITERS and by_name.get("b8_dia_stream_kernel", 0) > 0,
          f"sharded profile: k={k}, device time {by_name}")


def phase_sharded_goldens(mesh) -> None:
    """The fp64 goldens through the sharded route with B8 forced
    (local_kernel="stream2d"; "auto" takes the plain product for fp64, as
    cgx does), at tol 1e-10, twice each: k in the golden window or within
    2 of the plain fp64 loop, true residual below 1e-11, bitwise repeat."""
    for problem, dia in (("lap2d_fd(100)", lap2d_fd(100)),
                         ("lap2d_reference(10000)", lap2d_reference(10000))):
        b = source_term(dia.shape[0])
        cfg = SolveConfig(tolerance=1e-10, local_kernel="stream2d")
        reset_launches()
        runs = [timed(lambda: solve(dia, b, cfg, mesh=mesh, device=DEV)) for _ in range(2)]
        b8 = dia_spmv.dia_matvec_stream2d_planes.launches
        (res, k, seconds), (res2, k2, _) = runs
        op = as_operator(dia, torch.float64, device=DEV)
        plain, k_plain, _ = timed(lambda: cg_solve(op, b, tol=1e-10, device=DEV))
        rel = true_rel(dia, res.x.cpu().numpy(), b)
        bitwise = k == k2 and torch.equal(res.x.view(torch.int64), res2.x.view(torch.int64))
        lo, hi = GOLDEN_K[problem]
        emit({"phase": "sharded_golden", "problem": problem, "dtype": "float64", "k": k,
              "k_plain": k_plain, "true_rel": rel, "bitwise_repeat": bitwise,
              "seconds": seconds, "b8_launches_two_runs": b8})
        check(bool(res.converged) and (lo <= k <= hi or abs(k - k_plain) <= 2),
              f"sharded {problem}: k={k}, window [{lo}, {hi}], plain k={k_plain}")
        check(rel < 1e-11, f"sharded {problem}: true relative residual {rel}")
        check(bitwise, f"sharded {problem}: two runs differ")
        check(b8 >= 2 * (k + 1), f"sharded {problem}: {b8} B8 launches for k={k}")


def main() -> int:
    spec = phase_device()
    phase_build()
    records = phase_kernels(spec)
    # each kernel's launches come from a path that runs it, counted from 0 just before it
    launches = {name: n for name, n in phase_goldens().items() if name in THREE_KERNEL}
    records.update(phase_stream_kernel(spec))
    main_launches, b4_main = phase_main(spec)
    launches.update({name: n for name, n in main_launches.items()
                     if name in ("stream_iteration", "stream_iteration_stacked")})
    launches["stream_iteration_pcg"] = phase_stream_pcg(spec)["stream_iteration_pcg"]
    phase_stream_goldens()
    records.update(phase_dense_kernels(spec))
    with tempfile.TemporaryDirectory() as tmp:
        launches.update({name: n for name, n in phase_cli_reference(spec, Path(tmp)).items()
                         if name.startswith("dense_")})
        phase_cli_mpi(spec, Path(tmp))
        phase_cli_fp32(spec, Path(tmp))
    records.update(phase_resident_kernel(spec))
    phase_resident_goldens()
    launches.update({name: n for name, n in phase_resident_path(spec).items()
                     if name in RESIDENT_SITES})
    phase_crossover(spec)
    phase_mixed(spec)
    launches.update({name: n for name, n in phase_mixed_above(spec).items() if name in BF16_SITES})
    bounds, bounds_seconds = phase_sstep_bounds()
    records.update(phase_sstep_kernels(spec, bounds))
    launches.update(phase_sstep_path(spec, bounds, bounds_seconds, b4_main))
    phase_sstep_goldens()
    records.update(phase_stream_matvec(spec))
    with nccl_mesh() as mesh:
        launches.update(phase_sharded(spec, mesh, b4_main))
        phase_sharded_goldens(mesh)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = records[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels, "not_ported": NOT_PORTED}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

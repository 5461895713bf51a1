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
   could take; B1's two designs (B8's staged-x kernel, which matvec_plan
   picks, and the grid-stride one, forced) bitwise equal to each other
   and to B8's flat entry, with the grid-stride design's times; then
   both designs at N = 10,000, 90,000, 160,000 and 1,000,000 (lap2d_fd(100),
   (300), (400), (1000)) in float64 and float32, bitwise, timed by CUDA
   events and as device time;
4. goldens: the fp64 flagship goldens of tests/test_golden.py through
   the three-kernel loop (B1 on the grid-stride design, which matvec_plan
   picks at N = 10,000), with its launch counts;
5. stream kernel: the streaming Chronopoulos-Gear kernels (split in
   float32 with float32 and with bfloat16 bands, and in float64; stacked
   in float32; the Neumann PCG in float32, in both designs: the wavefront
   pcg_plan picks, one launch an iteration, and the three launches) on
   lap2d_fd(3200) from one seeded state, one iteration (the PCG's p, x,
   u, r', s' and w' bitwise) and 32 against the plain version, split
   against stacked bitwise, with ms an iteration, the bound, the plain
   version's ms and the peak device memory;
6. main path: cgx_torch.solve on lap2d_fd(3200) in fp32 with
   use_pallas=True, twice (bitwise equal), its kernel launch counts, the
   same solve through the stacked layout (bitwise equal), and the plain
   pipelined loop (fp64 dots) and the plain classic loop on the same
   problem;
7. profile: device time by kernel and the card's idle share over 256
   iterations of the main path, from torch.profiler;
8. stream PCG path: the main path's call with precond="neumann", twice,
   against the plain pipelined Neumann PCG, one launch of the wavefront
   an iteration; then its profile over 256 iterations;
9. stream goldens: dia_cg_solve_stream in float64 on lap2d_fd(100) and
   lap2d_reference(10000) at tol 1e-10, twice each, against the plain
   float64 pipelined loop;
10. dense kernels: dense_matvec and dense_matvec_dot, float32 and
    float64, on lap2d_fd(100) densified (N = 10,000, tiles 1024 x 128,
    the CLI's mapping of the reference's "1024 16"), on
    lap2d_reference(16384) densified (N = 16,384, the default 256 x 512)
    and on lap2d_reference(1001) densified (N = 1,001, tiles 100 x 37:
    rows off the 16-byte grid), against their plain versions, with
    torch.mv as the yardstick; dense_matvec's plan (aligned or peeled,
    the staging of x, the grid), a bitwise repeat, and dense_matvec_dot's
    y bitwise dense_matvec's (one kernel body on one plan);
11. CLI, CUDA grammar: the reference's own run, lap2D_5pt_n100.mtx 1024
    16 true, in fp64 through the dense kernel, twice (bitwise equal),
    held to the lap2d_fd(100) goldens and the reference's gates;
12. CLI, MPI grammar: 16384 --pallas, dense fp64 through the kernel,
    against the plain fp64 dense loop;
13. CLI, fp32: the CUDA grammar with --precision fp32 against the plain
    fp32 loop;
14. resident kernel: the whole-solve chunk kernel in both designs (the
    resident one resident_plan picks, and the global one, forced) against
    its plain version from one seeded state on the bands of lap2d_fd(1000)
    (N = 1,000,000), float32, float64 (the resident design on
    lap2d_fd(500), where float64 vectors fit) and float32 under bfloat16
    bands, with and without the preconditioner: one iteration, and one
    64-iteration chunk; then its ms per iteration in both layouts and both
    designs, and the resident design's sync floor (its grid syncs and
    ordered sums alone), against the bound of one launch (the bands, p, x
    and r read once, p, x and r written once, and the operations), the
    global design's HBM traffic an iteration beside it, the plain
    version's ms and the peak device memory;
15. resident goldens: dia_cg_solve_vmem in float64 on lap2d_fd(100) and
    lap2d_reference(10000) at tol 1e-10, twice each in the resident
    design, once in the global one (the same chunk loop, forced);
16. resident path: the whole-solve kernel at N = 1,000,000 and 1,999,396
    in fp32, without and with the Neumann preconditioner, twice each,
    against the plain fp32 (P)CG loop and beside the three-kernel loop:
    through cgx_torch.solve where the budget routes it there, by a direct
    call where it no longer does; and one direct call with layout="1d";
    the fp32 three-kernel loop (B1 on B8's design) beside them, its k
    within 2% of the plain loop's;
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
    from seeded p, r and x, s = 4, Chebyshev and Newton, against their
    plain versions: the basis and the recovered x, r and p bitwise, the
    Gram within 1e-12 of sum |v_i v_j| of the plain one's and of the exact
    sums, each of the three in the design basis_plan picks (the wavefront
    for float32 vectors, the slab for float64) and, where that is the
    wavefront, in the slab design too, the replayed coefficients within
    1e-13; the design and its plan recorded; the same checks on
    lap3d_fd(48) (7 diagonals: the kernels built for any number of them,
    Chebyshev); then each one's ms against
    its bound, the plain version's ms and the peak device memory, and
    the slab design's ms on the same inputs;
21. sstep path: cgx_torch.solve(lap2d_fd(3200), fp32, method="sstep"),
    which resolves to the fused kernels with bfloat16 bands, twice
    (bitwise equal), and the same call with sstep_powers="pallas" (the
    matrix-powers kernel and the replay kernel), twice; against the plain
    fp32 s-step loop with a float64 Gram, beside the main path's
    streaming kernel; the Lanczos bounds timed apart as set-up; every
    basis kernel of the route in the wavefront design;
22. sstep profile: device time by kernel (the Gram's and the recover's us
    a block) and the idle share over 64 fused blocks, and the peak device
    memory the fused loop takes above its operator and right-hand side;
23. sstep goldens: dia_sstep_stream_solve in float64 on lap2d_fd(100)
    and lap2d_reference(10000) at tol 1e-10, twice each, against the
    plain float64 s-step loop, both launches in the wavefront design;
24. stream matvec: kernel B8's two entry points (flat bands, band planes)
    on lap2d_fd(3200) in float32 and float64, bitwise against their plain
    versions, with its plan, and the sharded halo mat-vec's local product
    through B8 with seeded halos bitwise against its plain form; their
    times, the plain versions', torch.sparse's CSR product and the bound;
25. sharded: a real NCCL process group of one rank (FileStore), and
    cgx_torch.solve(lap2d_fd(3200), fp32, mesh=make_mesh(1)), "auto"
    resolving the local product to B8: the reference and the pipelined
    method (bitwise on two runs capped at 256 iterations), against the
    plain loops of phase 6 (k within 2%, true residual within 2x), B8 on
    every iteration and B1 on
    none, the collectives of every iteration from the recorder; then a
    profile over 256 iterations (B8, NCCL, the rest, the idle share);
26. sharded goldens: the fp64 goldens through the sharded route with B8
    forced, twice each;
27. mg main: MG-PCG on cgx's flagship problem, lap2d_operator(3200) and
    source_term_device built on the card (N = 10,240,000, fp64, tol
    1e-10 ||b||), through solve(precond="mg") with an fp32 and an fp64
    cycle, twice each (bitwise), the hierarchy built on the card by band
    probing; the build timed apart with its peak device memory, the
    V-cycles applied (at most 2k + 2), a profile (launches a loop
    iteration, idle share) and one cycle's device time by level; B4's main
    path beside it. No hand-written kernel runs on this path: cgx's cycle
    is XLA code, and the port's is plain torch;
28. mg goldens: MG-PCG on lap2d_fd(100), (130) (the Chebyshev coarsest)
    and lap3d_fd(64), fp64, Richardson and GS, V and W (but GS W in 3-D),
    k on the card against the same solve on this machine's CPU; then
    lap2d_fd(256)'s device Galerkin build against the host build;
29. precond paths: solve(precond="block_jacobi") and "chebyshev" on
    lap2d_fd(1000), fp64, and the CLI with --precond mg --mg-cycle fp32;
30. sharded preconditioners (inside phase 25's NCCL group of one rank):
    solve(mesh=) with precond="block_jacobi" and "chebyshev" on
    lap2d_fd(1000), fp64, tol 1e-10 ||b||, k within 1 of the same solve
    on one device, the true residual (error-free) below the larger of
    1e-10 and twice the plain fp64 loop's, block-Jacobi's collectives
    point Jacobi's;
31. tw main: bench.py's secondary flagship, uncut: solve(lap2d_operator(
    3200), source_term_device(N), precision="tw", precond="mg",
    tolerance=3e-11), N = 10,240,000, then refine_pcg_sweeps_tw with
    bench.py's arguments around an fp32 V-cycle built once, twice
    (the words bitwise), the build timed apart with its peak memory, the
    solve's peak memory, V-cycles, a profile of its first sweep
    (launches, device ms, idle share); the tw-evaluated true relative
    residual and a host np.longdouble referee of w0 + w1 + w2, both
    below 1e-10;
32. dd main: the same problem, inner and arguments through
    refine_pcg_sweeps_dd (the H100's fp64 is IEEE, so double-double is
    valid there), the same gate on its dd-evaluated residual and its
    longdouble referee;
33. ozaki dense: lap2D_5pt_n100.mtx densified (N = 10,000, fp64): the
    int8 product (torch._int_mm) bitwise its float64 plain version, the
    Ozaki mat-vec within 1e-14 of torch.mv relative to each dot's mass,
    solve(dense_fp64="ozaki") at tol 1e-10 (k in the golden's window,
    true residual below 1e-11), "auto" resolving to the plain operator;
    ms of an Ozaki mat-vec beside B3 and torch.mv;
34. sharded methods (inside phase 25's NCCL group of one rank): gvpipe
    through solve(mesh=) and the Chebyshev method on the analytic bounds,
    lap2d_fd(1000), fp64, k equal to one device's, one all-reduce an
    iteration for gvpipe and one every check_every for Chebyshev;
35. gv main: Ghysels-Vanroose CG at N = 10,240,000: fp32 twice (bitwise;
    an honest breakdown or the classic loop's gates), fp64 against the
    three-kernel loop (cgx's k bound), and MG-PCG in fp64 with both
    cycles at 1e-10 ||b|| and with the fp64 cycle at 1e-8 ||b||;
36. cheby main: the analytic extremes of the stencil against eigvalsh,
    the Lanczos estimate, the Chebyshev iteration at N = 10,240,000 in
    fp32 (bitwise on two runs capped at 256 iterations), and
    solve(method="chebyshev") on lap2D_5pt_n100.mtx in fp64 on the card
    and the host (k equal);
37. CLI methods: --method gvpipe and --method chebyshev on the
    reference's run against a CPU replay of the same argv, run in a
    process of its own beside phases 35-36;
38. block main: block MG-PCG with 8 right-hand sides at N = 10,240,000,
    fp64, fp32 cycle, twice (bitwise), its build apart, V-cycles, host
    syncs, a profile and the peak memory;
39. multi-RHS paths on lap2d_fd(1000): multi_rhs="batched" against
    single solves, solve_sequence against plain CG, and the
    differentiable solves (single and block) against one more solve and a
    central difference;
40. sstep halo (after the s-step goldens): B10's halo mode on
    lap2d_fd(3200) cut in one process into 4 shards of 2,560,000 rows
    (5000 x 512 of cgx's float32 planes), each extended by its
    neighbours' rows: the Gram-only launches' G summed in rank order
    within 1e-12 of the single-device Gram, the replay of the sum within
    1e-13 of its coefficients, the recovered rows bitwise; each launch
    against its plain version on the same shards, float32 and bfloat16
    bands, both designs; the times of a shard's launches with bfloat16
    bands beside their bound on its extended rows;
41. sharded s-step (inside phase 25's NCCL group): make_sharded_solver
    (method="sstep") at N = 10,240,000, fp32, analytic bounds, "fused",
    "off" and "deephalo", set-up apart: "fused" k equal to the
    single-device fused route's on the same bounds, the others within s,
    true residuals within 2x of it, one Gram all-reduce a block, B10 on
    every fused block; the bitwise repeat and a profile on 64 blocks
    each;
42. sharded mixed, MG-PCG and tw (a second NCCL group of one rank, after
    phase 33): solve(precision="mixed", mesh=) at rtol 2e-10 (sweeps
    within one of one device's; the repeat on one capped sweep),
    solve(precond="mg", mesh=) in fp64 with the fp32 cycle (k within 2
    of phase 27's, its gate), solve(precision="tw", precond="mg", mesh=)
    (sweeps within one of phase 31's, below 1e-10 by its own words), at
    N = 10,240,000; MG and tw then from sharded_mg_cg_setup's and
    sharded_tw_setup's build, timed apart, twice (bitwise the solve()
    call's x); each profiled;
43. sharded multi-RHS (the same NCCL group, after phase 42), at N =
    10,240,000: block MG-PCG through solve(B, mesh=) with 8 columns, fp64,
    fp32 cycle (k at most one above phase 42's MG, every column below
    MG's gate, one cycle of width 8 an iteration, the build apart);
    sharded_cg_solve_batched on make_mesh2d(1, 1), fp32, 4 seeded columns,
    pipelined (each column's k within 2% of the single-device batched
    reference loop with the same dots); solve_sequence(mesh=), fp32, k =
    8, on b0 and one column (the harvest's k within 2% of that plain
    loop's, the deflated solve within a tenth, B8 on every iteration);
    each bitwise on capped runs;
44. bf16 CLI (after the fp32 CLI phase): the CUDA grammar on
    lap2D_5pt_n100.mtx with `true` and --precision bf16 at 5e-2 ||b||, B3's
    bfloat16 build on every iteration, float32 dots, k within 2% of the
    plain bfloat16 dense loop's, the [STEP k] line and the CSV row;
45. bf16 kernels (after the resident path): each bfloat16-vector build
    bitwise against its plain version on seeded inputs (B1's dia_matvec in
    both designs at N = 1e6 and 10,240,000; B5 in both designs at N = 1e6,
    with and without Neumann, 1 and 64 iterations; B4, B7 and B6 in both
    designs at N = 10,240,000, 1 and 32 launches; B3's two entries at the
    dense phase's three shapes), with ms, the bound at 2-byte words, the
    plain version's ms and torch.mv in bfloat16 where it runs;
46. bf16 resident: solve(lap2d_fd(1000), bf16, use_pallas) through B5,
    without and with Neumann (its set-up through B1), twice each, k within
    2% of the plain reference loop with float64 dots, and layout="1d";
47. bf16 main: solve(lap2d_fd(3200), bf16, use_pallas, 5e-2 ||b||, maxiter
    20000) through B4, and with precond="neumann" through B6, k within 2%
    of the plain bfloat16 pipelined loop with float64 dots, the bitwise
    repeat on 256 capped iterations, us an iteration against the bound,
    the idle share; the stacked layout (B7) bitwise the split solve;
48. bf16 mesh (inside phase 25's NCCL group): solve and solve_sequence
    with precision="bf16" and mesh= on lap2d_fd(256): a float32 x, bitwise
    the fp32 request's;
49. bf16 sstep kernels (after the s-step goldens): the bfloat16-vector
    builds of B9 and of B10's Gram and recover on lap2d_fd(3200), each in
    both designs, Chebyshev and Newton, against their plain versions (the
    basis and x, r, p bitwise, G within 1e-12 of sum |v_i v_j|), timed
    against the bound at 2-byte words; B9 once through dia_sstep_basis;
50. bf16 sstep: solve(lap2d_fd(3200), bf16, method="sstep", 5e-2 ||b||),
    "auto" resolving to B10's bfloat16 builds: two runs capped at 256
    iterations bitwise, and k, the flags and x bitwise the chained plain
    versions'; the run to its stop (maxiter 4096, or 64 iterations past
    the first non-finite read where bfloat16 leaves the finite range), us
    an iteration against the bound; then lap2d_fd(1000) to convergence,
    bitwise the chained plain versions';
51. f16 bands: the float16-band builds under float32 vectors (B4 on
    lap2d_fd(3200), B5 on lap2d_fd(1000) in both designs, B10's Gram and
    recover in both designs) against their plain versions and, bitwise,
    their bfloat16-band builds on the same inputs, timed; then one solve
    each (dia_cg_solve_stream, dia_sstep_stream_solve, dia_cg_solve_vmem
    with bands_dtype=float16), x bitwise the bfloat16-band run's;
52. slope (after multi_rhs_paths): measure_dia_cg on lap2d_fd(3200),
    fp64, and measure_dense_cg on lap2d_fd(100) densified, fp32, through
    B3 and torch.matmul: s/iter, the Theil-Sen spread, the share of the
    data sheet's 3.35 TB/s and row_trusted; B3's s/iter no less than 0.9x
    its ms of phase 10;
53. autotune: autotune_dense_tiles(10000, float32) with the cache in the
    run's temporary directory, tuned_tiles, and the CLI with --pallas and
    no tiles on N = 10,000 building its operator with the tuned pair (k
    within 2% of the plain dense loop's);
54. native: the C++ MatrixMarket parser built, lap2d_fd(1000)'s lower
    COO written by it and read back through COOMatrix.read (bitwise the
    NumPy parser's), then solved through B5, bitwise the generator's;
55. grid_dia: GridDiaOperator on lap2d_fd(3200), fp64: its mat-vec
    bitwise the flat one, cg_solve capped at 512 iterations within 1e-13
    of the flat run, lap2d_reference(10000) refused;
56. checkpoint (in a third NCCL group of one rank): cg_solve_resumable on
    lap2d_fd(3200), fp64, segments of 512, uninterrupted to 1024 and
    interrupted at 512 (bitwise), and sharded_cg_solve_resumable resumed
    from the single-device file (within 1e-13), with each segment's and
    each checkpoint write's seconds;
57. sweeps (the same group): kernel_sweep(10000) over threads (128, 256,
    1024) x widths (128, 512, 4096), strong_scaling((1024, 2048)) and
    weak_scaling((1024,)), every row in cgx's schema;
58. records_timer: a PhaseTimer around one B3 call on lap2d_fd(100)
    densified, float32 (it waits for the card), trace() around 20 (in a
    process of its own, started before phase 54: its Chrome trace names
    B3's kernel), and a SolveRecord of a 64-iteration dense solve through
    B3 with its JSON, CSV rows and [STEP k] line.

The CLI phases call cgx_torch.cli.main.run, the body of the CLI's main,
in this process. Then a "kernels" line for the ported kernels (every
pallas_call site of cgx, with the replay kernel; "not_ported" is empty;
each site with two designs names the one that ran and the other's ms),
and, last, the contract line {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result. It
needs a CUDA device and imports neither JAX nor cgx.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import signal
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
    CGCheckpoint,
    DenseOperator,
    GridDiaOperator,
    PallasDenseOperator,
    PhaseTimer,
    SolveRecord,
    cg_solve_resumable,
    sharded_cg_solve_resumable,
    trace,
    gv_cg_solve,
    DiaOperator,
    SolveConfig,
    _build,
    as_operator,
    block_cg_solve,
    block_cg_solve_differentiable,
    cg_solve,
    cg_solve_batched,
    cg_solve_differentiable,
    chebyshev_solve,
    config,
    densify_on_device,
    dia_cg_solve_pallas,
    dia_cg_solve_stream,
    dia_cg_solve_stream_pcg,
    dia_cg_solve_vmem,
    iterative_refinement,
    pipelined_cg_solve,
    solve,
    solve_sequence,
)
from cgx_torch.bench import autotune, slope, sweeps
from cgx_torch.cli import main as cli
from cgx_torch.io import mmio, native
from cgx_torch.mats.device import lap2d_operator, source_term_device
from cgx_torch.parallel import make_mesh, make_mesh2d, make_sharded_solver
from cgx_torch.parallel import sharded_cg as sc
from cgx_torch.parallel import sharded_cg_solve_batched, sharded_cg_solve_harvest
from cgx_torch.parallel.mg_sharded import (
    _ShardedVCycle,
    sharded_mg_block_cg_setup,
    sharded_mg_cg_setup,
)
from cgx_torch.parallel.sstep_fused import fused_plane_geometry
from cgx_torch.parallel.tw_sharded import sharded_tw_setup
from cgx_torch.mats.containers import COOMatrix, DIAMatrix
from cgx_torch.mats.generators import (
    lap2d_fd,
    lap2d_fd_coo_lower,
    lap2d_reference,
    lap3d_fd,
    source_term,
)
from cgx_torch.ops import axpy, cg_kernel, cg_stream, dia_powers, dia_spmv, matvec, ozaki
from cgx_torch.ops import sstep_stream as ss
from cgx_torch.ops._util import BF16_BANDS_SUFFIX, BUILD_LAUNCHES, f32_exact, pow2_rhs_scale
from cgx_torch.ops.dd import two_prod, two_sum
from cgx_torch.solver import api, blockcg
from cgx_torch.solver.chebyshev import (
    device_matvec,
    host_matvec,
    host_spectral_bounds,
    lanczos_bounds,
    spectral_bounds,
)
from cgx_torch.solver.multigrid import infer_grid_ndim, mg_preconditioner
from cgx_torch.solver.precond import neumann_banded
from cgx_torch.solver.refine import refine_pcg_sweeps_dd, refine_pcg_sweeps_tw
from cgx_torch.solver.sstep import newton_shifts, sstep_cg_solve
from cgx_torch.utils import collectives

STARTED = time.perf_counter()  # the records' script_seconds count from here
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
RESIDENT_F64_GRID = 500  # lap2d_fd(500), N = 250,000: float64 vectors fit B5's resident design
CHUNK = 64  # iterations per launch of dia_cg_solve_vmem's default
CROSSOVER_GRIDS = (500, 1000, 1414, 2000)  # N = 250,000 .. 4,000,000
CROSSOVER_ITERS = 512
STREAM_ITERS = 32  # launches of the stream kernel phase's second comparison
DEVICE_CALLS = 20  # calls under torch.profiler for a kernel's device-only time
# a redesign is taken only where it is no slower than the design before it in
# the same run, within this share (the float builds of B4/B7 on the wavefront)
REDESIGN_SLACK = 1.03
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
# name: (vector dtype, the bands' narrower storage or None); the matrix-powers
# kernel takes the bands in the vectors' dtype only
SSTEP_CASES = {"f32": (torch.float32, None), "f32_bf16b": (torch.float32, torch.bfloat16),
               "f64": (torch.float64, None)}
# the cases of ROADMAP A6's rest, checked in phases of their own: bfloat16
# vectors (bf16_sstep_kernels) and float16 bands (f16_bands)
SSTEP_CASE_DTYPES = {**SSTEP_CASES, "bf16": (torch.bfloat16, None),
                     "f32_f16b": (torch.float32, torch.float16)}
# the case whose shapes and dtypes the s-step paths give each site: solve's
# "fused" route streams bfloat16 bands, its "pallas" route float32 ones
SSTEP_MAIN_CASE = {"dia_sstep_basis_planes": "f32", "sstep_gram": "f32_bf16b",
                   "sstep_recover": "f32_bf16b", "sstep_replay": "f32"}
GRAM_RTOL = 1e-12  # against sum |v_i v_j|: float64 sums in two orders
COEF_RTOL = 1e-13  # the replay's coefficients, against their max
SSTEP_PROFILE_BLOCKS = 64
# the sharded mixed solve's rtol at N = 10,240,000: fp64 leaves a floor near
# 1e-10 there (phase_mg_main), and the refinement on one card and on the mesh
# both stall at 8.45e-11, so the 1e-11 of the N = 1e6 phases is out of reach
MIXED_RTOL = 2e-10
HALO_SHARDS = 4  # the halo phase's cut of lap2d_fd(GRID): 2,560,000 rows a shard
# The longer sharded solves (s-step, mixed refinement, the 2-D batched solve and
# the sequence) run on lap2d_fd(SHARDED_GRID): N = 2,560,000, a shard of
# lap2d_fd(GRID) on HALO_SHARDS ranks, still at least the STREAM_LOCAL_MIN_ELEMS
# for which "auto" takes B8. Cut from GRID for the script's time: one NCCL rank
# takes about 2 ms an iteration on the host either way, and k halves with the grid.
SHARDED_GRID = 1600
SHARDED_POWERS = ("fused", "off", "deephalo")  # the sharded s-step routes
GENERIC_GRID = 48  # lap3d_fd(48): N = 110,592, 7 diagonals, reach 2304

# (name substring, HBM bytes/s, float32 FLOP/s, float64 FLOP/s, bfloat16 FLOP/s)
# from NVIDIA's data sheets, dense, without tensor cores; first match wins. The
# bfloat16 rate outside the tensor cores is twice the float32 one (two values a
# lane: 133.8 TFLOP/s on the H100 SXM in NVIDIA's H100 architecture paper).
CARDS = [
    ("H200", 4.8e12, 67e12, 34e12, 134e12),
    ("H100 NVL", 3.9e12, 60e12, 30e12, 120e12),
    ("H100 PCIe", 2.0e12, 51e12, 26e12, 102e12),
    ("H100", 3.35e12, 67e12, 34e12, 134e12),  # SXM
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
    "sstep_recover": ("cgx_torch/csrc/sstep_recover.cu", "cgx/ops/sstep_stream.py:466"),
    # no pallas_call: cgx replays in XLA (replay_block, called at cgx/solver/sstep.py:218
    # and cgx/ops/sstep_stream.py:730); one small kernel here, so the host sets no pace
    "sstep_replay": ("cgx_torch/csrc/sstep_stream.cu", "cgx/solver/sstep.py:284"),
    # B8: the flat form has no solver caller in cgx (and none here); the
    # planes form is the sharded route's local product
    "dia_matvec_stream": ("cgx_torch/csrc/dia_stream.cu", "cgx/ops/dia_spmv.py:192"),
    "dia_matvec_stream2d_planes": ("cgx_torch/csrc/dia_stream.cu", "cgx/ops/dia_spmv.py:354"),
}
# the bfloat16-vector builds (ROADMAP A6, first part), a row each in the kernels line
BF16_KERNELS = {
    "dia_matvec_bf16": ("cgx_torch/csrc/dia_stream.cu", "cgx/ops/dia_spmv.py:91"),
    "dia_cg_vmem_bf16": ("cgx_torch/csrc/cg_kernel.cu", "cgx/ops/cg_kernel.py:245"),
    "dia_cg_vmem2d_bf16": ("cgx_torch/csrc/cg_kernel.cu", "cgx/ops/cg_kernel.py:479"),
    "stream_iteration_bf16": ("cgx_torch/csrc/cg_stream.cu", "cgx/ops/cg_stream.py:404"),
    "stream_iteration_stacked_bf16": ("cgx_torch/csrc/cg_stream.cu", "cgx/ops/cg_stream.py:930"),
    "stream_iteration_pcg_bf16": ("cgx_torch/csrc/cg_stream.cu", "cgx/ops/cg_stream.py:1203"),
    "dense_matvec_bf16": ("cgx_torch/csrc/matvec.cu", "cgx/ops/matvec.py:88"),
    "dense_matvec_dot_bf16": ("cgx_torch/csrc/matvec.cu", "cgx/ops/matvec.py:163"),
}
KERNELS.update(BF16_KERNELS)
# ROADMAP A6's rest: the s-step builds on bfloat16 vectors and the float16-band
# builds under float32 vectors, a row each: (source, the cgx site, the
# BUILD_LAUNCHES key its launches are counted by)
A6_KERNELS = {
    "dia_sstep_basis_planes_bf16": ("cgx_torch/csrc/dia_powers.cu", "cgx/ops/dia_powers.py:299",
                                    "dia_sstep_basis_planes_bf16"),
    "sstep_gram_bf16": ("cgx_torch/csrc/sstep_stream.cu", "cgx/ops/sstep_stream.py:395",
                        "sstep_gram_bf16"),
    "sstep_recover_bf16": ("cgx_torch/csrc/sstep_recover.cu", "cgx/ops/sstep_stream.py:466",
                           "sstep_recover_bf16"),
    "dia_cg_vmem_f16b": ("cgx_torch/csrc/cg_kernel.cu", "cgx/ops/cg_kernel.py:245",
                         "dia_cg_vmem_f32_f16b"),
    "stream_iteration_f16b": ("cgx_torch/csrc/cg_stream.cu", "cgx/ops/cg_stream.py:404",
                              "stream_iteration_f32_f16b"),
    "sstep_gram_f16b": ("cgx_torch/csrc/sstep_stream.cu", "cgx/ops/sstep_stream.py:395",
                        "sstep_gram_f32_f16b"),
    "sstep_recover_f16b": ("cgx_torch/csrc/sstep_recover.cu", "cgx/ops/sstep_stream.py:466",
                           "sstep_recover_f32_f16b"),
}
KERNELS.update({name: row[:2] for name, row in A6_KERNELS.items()})
# the rows of a bfloat16-vector build
BF16_BUILT = {*BF16_KERNELS, "dia_sstep_basis_planes_bf16", "sstep_gram_bf16",
              "sstep_recover_bf16"}
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
# rows read from the wrappers' counts by build (BUILD_LAUNCHES): the row, and the
# keys of the builds it sums; the bf16 rows' key is their name
FLOAT_BUILDS = ("_f32", "_f64", BF16_BANDS_SUFFIX)
BUILD_ROWS = {
    **{name: [name + s for s in FLOAT_BUILDS[:2]] for name in RESIDENT_SITES},
    **{name: [name.removesuffix("_bf16b") + BF16_BANDS_SUFFIX] for name in BF16_SITES},
    **{name: [name + s for s in FLOAT_BUILDS] for name in (
        "dia_matvec", *STREAM_SITES, "dense_matvec", "dense_matvec_dot")},
    **{name: [name] for name in BF16_KERNELS},
    **{name: [row[2]] for name, row in A6_KERNELS.items()},
}
BF16 = torch.bfloat16
BF16_TOL = 5e-2  # relative to ||b||: cgx's own bf16 test (tests/test_api.py:72-77)
BF16_MAXITER = 20000
BF16_MESH_GRID = 256  # lap2d_fd(256): the mesh's bf16 request, a small grid
# maxiter of bf16_sstep's full-size run (cut from BF16_MAXITER for the script's
# time: on an H100 80GB HBM3 the bf16 s-step there had not converged at 20,000
# iterations, 10.5 s, its x non-finite)
BF16_SSTEP_MAXITER = 4096
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
    # odd N and tiles: rows and tiles off the 16-byte grid, the kernel's peeled path
    ("lap2d_reference(1001)", lambda: lap2d_reference(1001), (100, 37)),
]
MPI_N = 16384  # the reference's largest MPI size (the 16384 key of plots.ipynb's ALPHAS)
MG_CYCLES = ("fp32", "fp64")  # bench.py's fp64_mg_mixed, then the full-fp64 cycle
MG_GOLDENS = [("lap2d_fd(100)", lambda: lap2d_fd(100)),  # bench.py's primary problem
              ("lap2d_fd(130)", lambda: lap2d_fd(130)),  # 130 -> 65: the Chebyshev coarsest
              ("lap3d_fd(64)", lambda: lap3d_fd(64))]  # 3-D: 81- and 125-band coarse levels
MG_CONFIGS = (("richardson", "v"), ("richardson", "w"), ("gs", "v"), ("gs", "w"))
# the 3-D GS W-cycle visits its 27-colour 125-band levels 4 and more times: about
# 370,000 launches a cycle at lap3d_fd(128), minutes on the host for the card and its twin
MG_SKIP = {("lap3d_fd(64)", "gs", "w")}
MG_PROBE_GRID = 256  # device against host Galerkin build
PRECOND_GRID = 1000  # lap2d_fd(1000): N = 1,000,000
AUTODIFF_GRID = 500  # multi_rhs_paths' differentiable solves (cut from 1000 for the time)
GV_SLACK = (1.15, 2)  # tests/test_gvpipe.py:61: gvpipe's k <= 1.15 k_classic + 2
BLOCK_S = 8  # block_main's right-hand sides
MULTI_S = 4  # multi_rhs_paths' batched and block right-hand sides
SEQ_K = 16  # solve_sequence's harvested Ritz vectors
SHARDED_SEQ_K = 8  # the sharded sequence's (its window max(8k, 64) = 64 rows)
# the sharded batched phase's columns and the sharded sequence's right-hand sides
# (cut from 8 and 3 for the script's time)
SHARDED_BATCHED_S = 4
SEQUENCE_LEN = 2
REPEAT_ITERS = 256  # the capped bitwise repeats of the longer solves at full size
BATCHED_RTOL = 1e-3  # the 2-D batched phase's float32 tolerance, relative to ||b0||
# the sharded sequence's too (cut from 1e-5 for the script's time: the seeded
# column's float32 floor, as BATCHED_RTOL's note in phase_sharded_batched says)
SEQUENCE_RTOL = BATCHED_RTOL
# Lanczos steps of the host-against-card comparison (cut from 16 for the script's
# time: the host's NumPy steps at N = 10,240,000 took 14.2 s at 16)
HOST_LANCZOS_M = 8
FD_STEP = 1e-4  # the bands scaled by 1 +- FD_STEP for the central difference
TW_GATE = 1e-10  # bench.py's SECONDARY_REL_GATE: the true relative residual
# bench.py's refine_pcg_sweeps_tw arguments (bench.py:140-144); solve(precision="tw") the same
TW_KW = dict(sweeps=16, rtol=3e-11, inner_tol=1e-6, inner_maxiter=80)
OZAKI_GRID = 100  # lap2D_5pt_n100.mtx, the reference's dense regime
OZAKI_MASS_RTOL = 1e-14  # tests/test_ozaki.py's bound, relative to |A| |x|
STEP = re.compile(r"\[STEP (\d+)\] residual = ([0-9.e+-]+), \|\|x\|\| = ([0-9.e+-]+), "
                  r"\|\|Ax - b\|\|/\|\|b\|\| = ([0-9.e+-]+|nan)")


def reset_launches() -> None:
    for w in (*WRAPPERS.values(), *STREAM_SITES.values(), *SSTEP_SITES.values()):
        w.launches = 0
    cg_kernel.dia_cg_chunk.launches = {layout: 0 for layout in cg_kernel.LAYOUTS}
    BUILD_LAUNCHES.clear()


def read_launches() -> dict:
    counts = {name: w.launches
              for name, w in (*WRAPPERS.items(), *STREAM_SITES.items(), *SSTEP_SITES.items())}
    for name, keys in BUILD_ROWS.items():
        counts[name] = sum(BUILD_LAUNCHES[key] for key in keys)
    return counts


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def emit(obj: dict) -> None:
    """One record a line, with the seconds since the script started."""
    print(json.dumps({**obj, "script_seconds": time.perf_counter() - STARTED}), flush=True)


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


def device_ms(fn, names, calls: int = DEVICE_CALLS):
    """Device-only milliseconds of one call of ``fn``: for each kernel whose
    name holds one of ``names`` ("" for every kernel), the median of its
    Kineto durations over ``calls`` calls under torch.profiler (after one
    call outside it), times its launches a call; summed over the kernels.
    Unlike time_ms's events, no gap between launches and no host time
    enters it. The profiler may drop some of a window's device records, so
    a median and not a sum over the window; None where it kept none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for name, t in cuda_events(prof):
        if any(k in name for k in names):
            by_name.setdefault(name, []).append(t)
    if not by_name:
        return None
    return sum(statistics.median(us) * max(1, round(len(us) / calls))
               for us in by_name.values()) / 1e3


def card_spec(name: str):
    for key, bw, f32, f64, bf16 in CARDS:
        if key in name:
            return {"spec": key, "hbm_bytes_per_s": bw,
                    "flops_per_s": {torch.float32: f32, torch.float64: f64,
                                    torch.bfloat16: bf16}}
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
    records = measure_cases(spec, problem, dtype, n, cases, dot_terms)
    records.update(b1_designs(spec, problem, bands, x, offsets, records))
    return records


def b1_designs(spec, problem: str, bands, x, offsets, records: dict) -> dict:
    """B1's two designs on the same inputs: the one matvec_plan picks (B8's
    staged-x kernel, with a dot epilogue for dia_matvec_dot) and the
    grid-stride one, forced; y bitwise equal between them and to B8's flat
    entry. Adds the grid design's ms to each record."""
    plan = dia_spmv.matvec_plan(x.shape[0], offsets, x.dtype, torch.cuda.get_device_properties(
        0).multi_processor_count)
    grid = dia_spmv.GRID_PLAN
    y_new = dia_spmv.dia_matvec(bands, x, offsets=offsets)
    ran = [dia_spmv.dia_matvec.plan]
    y_old = dia_spmv.dia_matvec(bands, x, offsets=offsets, plan=grid)
    yd_new, d_new = dia_spmv.dia_matvec_dot(bands, x, offsets=offsets)
    ran.append(dia_spmv.dia_matvec_dot.plan)
    yd_old, d_old = dia_spmv.dia_matvec_dot(bands, x, offsets=offsets, plan=grid)
    y_b8 = dia_spmv.dia_matvec_stream(bands, x, offsets=offsets)
    sync()
    same = {"matvec_new_vs_old": torch.equal(y_new, y_old),
            "matvec_new_vs_b8": torch.equal(y_new, y_b8),
            "dot_y_new_vs_old": torch.equal(yd_new, yd_old),
            "dot_y_new_vs_matvec": torch.equal(yd_new, y_new)}
    dot_scale = float((x * y_old).abs().sum())
    rec = {"phase": "b1_designs", "problem": problem, "dtype": str(x.dtype), "design": plan.design,
           "plan": plan.stream._asdict() if plan.stream else None, "bitwise": same,
           "dot_new_vs_old_rel": abs(float(d_new) - float(d_old)) / dot_scale}
    check(plan.design == "stream" and ran == [plan, plan], f"B1 {problem} {x.dtype}: ran {ran}")
    check(all(same.values()), f"B1 {problem} {x.dtype}: designs differ: {same}")
    check(rec["dot_new_vs_old_rel"] <= DOT_RTOL[x.dtype],
          f"B1 {problem} {x.dtype}: dots {float(d_new)} and {float(d_old)}")
    del y_new, y_old, yd_new, yd_old, y_b8
    out = {}
    for name, fn in (("dia_matvec", dia_spmv.dia_matvec), ("dia_matvec_dot",
                                                          dia_spmv.dia_matvec_dot)):
        rec[f"{name}_grid_ms"] = time_ms(lambda: fn(bands, x, offsets=offsets, plan=grid))
        out[name] = {**records[name], "design": plan.design, "grid_ms": rec[f"{name}_grid_ms"]}
    emit(rec)
    return out


def device_us(fn, kernel: str, calls: int = 200) -> float:
    """Microseconds of device time a call of ``fn`` spends in kernels whose
    name holds ``kernel``, from torch.profiler's CUDA events over ``calls``
    back-to-back calls after a warm-up: at a few microseconds a call the
    host's launch time, not the kernel's, sets CUDA-event time. A lead
    kernel, waited for, opens the window (as in device_profile): the
    profiler can miss the first kernel of a window."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the lead
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        sync()
    us = [t for name, t in cuda_events(prof) if kernel in name]
    check(len(us) == calls, f"profiled {len(us)} {kernel} kernels of {calls} calls")
    return sum(us) / calls


def phase_b1_sizes(spec) -> None:
    """B1's two designs at the sizes its solver callers run it: N = 10,000
    in float64 (the fp64 golden through the three-kernel loop) and N = 1e6
    in float32 (the three-kernel loop beside the resident path), and on
    either side of matvec_plan's line (a 1024-row tile an SM: N = 90,000
    and 160,000), both dtypes at each: y bitwise between the designs, and
    each entry's time by CUDA events and as device time."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for g in (100, 300, 400, RESIDENT_GRID):  # 10, 88, 157 and 977 tiles of 1024 rows
        dia = lap2d_fd(g)
        n, offsets = dia.shape[0], tuple(dia.offsets)
        for dtype in (torch.float64, torch.float32):
            bands = torch.as_tensor(dia.bands, dtype=dtype, device=DEV)
            x = torch.as_tensor(np.random.default_rng(SEED).standard_normal(n), dtype=dtype,
                                device=DEV)
            stream = dia_spmv.MatvecPlan("stream", dia_spmv.stream_plan(n, offsets, dtype, sms))
            designs = {"stream": stream, "grid": dia_spmv.GRID_PLAN}
            ys = {d: dia_spmv.dia_matvec(bands, x, offsets=offsets, plan=p)
                  for d, p in designs.items()}
            yd = {d: dia_spmv.dia_matvec_dot(bands, x, offsets=offsets, plan=p)[0]
                  for d, p in designs.items()}
            sync()
            bitwise = torch.equal(ys["stream"], ys["grid"]) and torch.equal(yd["stream"],
                                                                            ys["stream"])
            rec = {"phase": "b1_sizes", "problem": f"lap2d_fd({g})", "n": n,
                   "dtype": str(dtype), "picked": dia_spmv.matvec_plan(n, offsets, dtype,
                                                                       sms).design,
                   "stream_grid": stream.stream.grid, "bitwise": bitwise,
                   "bound_ms": bound_of(spec, dtype, (len(offsets) + 2) * n * (
                       torch.finfo(dtype).bits // 8), 2 * len(offsets) * n)[0]}
            for name, fn in (("dia_matvec", dia_spmv.dia_matvec),
                             ("dia_matvec_dot", dia_spmv.dia_matvec_dot)):
                for d, p in designs.items():
                    def call(fn=fn, p=p):
                        return fn(bands, x, offsets=offsets, plan=p)
                    rec[f"{name}_{d}_ms"] = time_ms(call)
                    rec[f"{name}_{d}_device_us"] = device_us(call, "dia_")
            emit(rec)
            check(bitwise, f"B1 lap2d_fd({g}) {dtype}: designs differ")
            del bands, x, ys, yd
            sync()


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
    y1 = matvec.dense_matvec(a, x, block_rows=br, block_cols=bc)
    y2 = matvec.dense_matvec(a, x, block_rows=br, block_cols=bc)
    y3, _ = matvec.dense_matvec_dot(a, x, block_rows=br, block_cols=bc)
    sync()
    plan = matvec.dense_matvec.plan
    rec = {"phase": "dense_plan", "problem": problem, "dtype": str(dtype), "n": n,
           "tiles": [br, bc], **plan._asdict(), "bitwise_repeat": torch.equal(y1, y2),
           "dot_kernel_y_bitwise": torch.equal(y1, y3)}
    emit(rec)
    check(rec["bitwise_repeat"], f"dense_matvec {problem} {dtype}: two calls differ")
    check(rec["dot_kernel_y_bitwise"] and matvec.dense_matvec_dot.plan == plan,
          f"dense_matvec_dot {problem} {dtype}: y differs from dense_matvec's")
    check(plan.aligned == (n * torch.finfo(dtype).bits // 8 % 16 == 0
                           and bc * torch.finfo(dtype).bits // 8 % 16 == 0),
          f"dense_matvec {problem} {dtype}: plan {plan}")
    del a, y1, y2, y3
    return records


def phase_dense_kernels(spec) -> tuple:
    """Returns the records at the reference run's shape and dtype:
    lap2d_fd(100), 1024 x 128 tiles, float64; and B3's ms there in
    float32 (the slope phase's yardstick)."""
    main_records, b3_fp32_ms = {}, None
    for problem, make, tiles in DENSE_PROBLEMS:
        dia = make()
        for dtype in (torch.float32, torch.float64):
            recs = dense_kernel_cases(spec, problem, dia, dtype, tiles)
            if problem == "lap2d_fd(100)" and dtype == torch.float64:
                main_records = recs
            if problem == "lap2d_fd(100)" and dtype == torch.float32:
                b3_fp32_ms = recs["dense_matvec"]["ms"]
            sync()
    return main_records, b3_fp32_ms


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
        check(dia_spmv.dia_matvec_dot.plan == dia_spmv.GRID_PLAN,  # below a tile an SM
              f"{problem}: B1 ran {dia_spmv.dia_matvec_dot.plan}, not the grid-stride design")
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


def solve_capped_repeat(fn, capped) -> tuple:
    """One run of a solve, the launch counts set to 0 just before it, and
    the bitwise repeat on two runs of ``capped``, the same solve cut at
    REPEAT_ITERS iterations; returns (result, k, seconds, launches,
    bitwise equal)."""
    reset_launches()
    res, k, seconds = timed(fn)
    launches = read_launches()
    return res, k, seconds, launches, same_x(capped(), capped())


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
           "design": cg_stream._stream_iteration.design,
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
    pick = cg_stream.stream_plan(n, tuple(dia.offsets), torch.float32, dia_powers.sms_of(DEV))
    check(rec["design"] == pick.design,
          f"main path ran the {rec['design']} design, stream_plan picks {pick.design}")
    check(max(rel_fast, rel_plain) <= 2 * min(rel_fast, rel_plain),
          f"true residuals {rel_fast} and {rel_plain} differ by more than 2x")
    phase_profile(op, b_dev)
    return launches, rec, res.x


def cuda_events(prof) -> list:
    """(name, µs) of each event the card ran in a finished torch.profiler
    window, from its raw Kineto records. ``prof.events()`` gives the same
    device events but first builds a Python object for every host event
    too: about 70 µs an event, seconds for a profile of a few hundred
    iterations of the eager loops."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_hidden_event()]


def phase_profile(op, b_dev, precond=None) -> None:
    """Where an iteration of the main path (or its precond="neumann"
    twin) spends its time on the card: device time by kernel over
    PROFILE_ITERS iterations, from torch.profiler's CUDA events, and the
    share of the (profiled) wall time in which the card ran nothing."""
    from torch.profiler import ProfilerActivity, profile

    cfg = SolveConfig(precision="fp32", use_pallas=True, tolerance=0.0, maxiter=PROFILE_ITERS,
                      precond=precond)
    solve(op, b_dev, cfg, device=DEV)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        int(solve(op, b_dev, cfg, device=DEV).iterations)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy_us, count = {}, 0.0, 0
    for ename, us in cuda_events(prof):
        name = next((k for k in STREAM_KERNELS if k in ename), "other")
        by_name[name] = by_name.get(name, 0.0) + us / PROFILE_ITERS
        busy_us += us
        count += 1
    emit({"phase": "profile", "precond": precond, "iterations": PROFILE_ITERS,
          "device_events": count,
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


def stream_designs(n: int, offsets, dtype, precond: bool):
    """The designs a streaming case runs: the plan function's pick first
    (the wavefront at N = 10,240,000), then the design before it: the
    three-launch design for the PCG (pcg_plan), the grid design for the
    plain iteration (stream_plan)."""
    sms = dia_powers.sms_of(DEV)
    if precond:
        return [cg_stream.pcg_plan(n, offsets, dtype, sms), cg_stream.three_plan(n)]
    pick = cg_stream.stream_plan(n, offsets, dtype, sms)
    return [pick] if pick.design == "grid" else [pick, cg_stream.grid_plan(n)]


STREAM_KERNELS = ("stream_wave_kernel", "cg_stream_kernel", "pcg_wave_kernel")


def stream_call(bands, st, plan, kw, work, scal0=None):
    """One launch of ``st``'s streaming site in ``plan``'s design with its C
    arguments built once (cg_stream._launcher), as the solvers' host loop
    launches it, so that its time is the card's and not the wrapper's
    checks; from the scalars ``scal0`` each time where given (an active
    launch: the 64-byte copy is in the event times, not in device_ms)."""
    site = (cg_stream._stream_iteration_pcg if st.u is not None
            else cg_stream._stream_iteration_stacked if st.rws is not None
            else cg_stream._stream_iteration)
    go = cg_stream._launcher(site, bands, st.p, st.x, st.u, st.r, st.w, st.s, st.scal,
                             tuple(kw["offsets"]), kw["tol"], kw["nearzero"], kw["maxiter"],
                             work, plan)
    if scal0 is None:
        return go
    return lambda: (st.scal.copy_(scal0), go())


def phase_stream_kernel(spec) -> dict:
    """Each streaming case against its plain version from one seeded
    state at N = 10,240,000, in each design (stream_designs): one launch
    (vectors within VEC_RTOL, for the PCG p, x, u, r', s' and w' bitwise;
    dots within DOT_RTOL) and STREAM_ITERS launches (within CHUNK_RTOL: a
    dot's last bit can flip a float alpha, and the difference compounds),
    split against stacked bitwise in each design; then the time of an
    iteration in each design, by events and on the device alone, the plan
    function's pick no slower than the design before it (REDESIGN_SLACK).
    Returns the records of the kernels line for the three streaming
    sites."""
    dia = lap2d_fd(GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    kw = dict(offsets=offsets, tol=0.0, nearzero=1e-14, maxiter=10**9)
    records, after = {}, {}
    for case, (site, dtype, bf16, precond, stacked) in STREAM_CASES.items():
        bands, st = stream_state(dia, dtype, precond, stacked)
        kb = bands.to(torch.bfloat16) if bf16 else bands
        del bands
        times, dev = {}, {}
        for plan in stream_designs(n, offsets, dtype, precond):
            design = plan.design
            one_err = None
            for launches, vec_rtol, dot_rtol in ((1, VEC_RTOL[dtype], DOT_RTOL[dtype]),
                                                 (STREAM_ITERS, CHUNK_RTOL[dtype],
                                                  CHUNK_RTOL[dtype])):
                got, ref = clone_state(st), clone_state(st)
                for _ in range(launches):
                    cg_stream.step(kb, got, plan=plan, **kw)
                    cg_stream._iteration_ref(kb, *ref[:6], ref.scal, **kw)
                sync()
                pairs = [(a, w) for a, w in zip(got[:6], ref[:6]) if a is not None]
                max_abs = max(float((a - w).abs().max()) for a, w in pairs)
                vec_rel = max(rel_err(a, w, w.abs().max()) for a, w in pairs)
                dot_rel = float(((got.scal[:3] - ref.scal[:3]).abs() / ref.scal[:3].abs()).max())
                same = torch.equal(got.scal[cg_stream.K:], ref.scal[cg_stream.K:])
                bitwise = all(torch.equal(a, w) for a, w in pairs)
                emit({"phase": "stream_kernel_check", "case": case, "design": design,
                      "problem": f"lap2d_fd({GRID})", "n": n, "dtype": str(dtype),
                      "bands_dtype": str(kb.dtype), "launches": launches,
                      "max_abs_err": max_abs, "vec_rel_err": vec_rel, "bitwise": bitwise,
                      "dot_rel_err": dot_rel, "vec_rtol": vec_rtol, "dot_rtol": dot_rtol,
                      "grid": STREAM_SITES[site].grid, "scalars": got.scal.tolist(),
                      "plain_scalars": ref.scal.tolist()})
                check(vec_rel <= vec_rtol and dot_rel <= dot_rtol and same,
                      f"stream {case} {design} x{launches}: vectors {vec_rel}, dots {dot_rel}, "
                      f"k/stop/breakdown {got.scal[cg_stream.K:].tolist()} against "
                      f"{ref.scal[cg_stream.K:].tolist()}")
                if launches == 1:
                    one_err = max_abs
                    check(bitwise or not precond,
                          f"stream {case} {design}: one launch is not bitwise the plain one")
                elif case in ("split_f32", "stacked_f32"):
                    q = int(got.scal[cg_stream.K]) & 1
                    after[case, design] = [got.p, got.x, got.r[q], got.w[q], got.s[q]]
                del got, ref
            sync()
            torch.cuda.reset_peak_memory_stats()
            work = cg_stream.workspace(DEV, n)
            call = stream_call(kb, st, plan, kw, work)
            ms = time_ms(call)
            dev[design] = device_ms(call, STREAM_KERNELS)
            peak = torch.cuda.max_memory_allocated()
            held = sum(t.numel() * t.element_size() for t in (kb, *st, *work)
                       if t is not None and t is not st.rws)
            plain_ms = time_ms(lambda: cg_stream._iteration_ref(kb, *st[:6], st.scal, **kw),
                               reps=3, burst=1)
            item = torch.finfo(dtype).bits // 8
            bound, bound_by = bound_of(spec, dtype,
                                       stream_bytes(ndiag, n, 2 if bf16 else item, item, precond),
                                       stream_flops(ndiag, n, precond))
            rec = {"phase": "stream_kernel", "case": case, "site": site, "design": design,
                   "problem": f"lap2d_fd({GRID})", "n": n, "dtype": str(dtype),
                   "bands_dtype": str(kb.dtype), "ms_per_iter": ms,
                   "device_ms_per_iter": dev[design], "launches_per_iter": plan.launches,
                   "bound_ms_per_iter": bound, "bound_by": bound_by, "bound_share": bound / ms,
                   "plain_ms_per_iter": plain_ms, "state_bytes": held,
                   "max_memory_allocated": peak, "grid": STREAM_SITES[site].grid,
                   "max_abs_err": one_err}
            emit(rec)
            times[design] = ms
            if STREAM_MAIN_CASE[site] == case and site not in records:
                records[site] = {"max_abs_err": one_err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": bound_by,
                                 "library_ms": None,  # no one PyTorch call runs a CG iteration
                                 "design": design, "device_ms": dev[design]}
            del work, call
        if STREAM_MAIN_CASE[site] == case:
            other = "three" if precond else "grid"
            records[site][f"{other}_ms"] = times.get(other)
            records[site][f"{other}_device_ms"] = dev.get(other)
        if "wavefront" in times and not precond:
            check(times["wavefront"] <= REDESIGN_SLACK * times["grid"],
                  f"stream {case}: the wavefront ({times['wavefront']} ms) is slower than the "
                  f"grid design ({times['grid']} ms) that stream_plan would replace")
        del kb, st
        sync()
    for design in ("wavefront", "grid"):
        same = all(torch.equal(a, b) for a, b in zip(after["split_f32", design],
                                                     after["stacked_f32", design]))
        emit({"phase": "stream_layouts", "design": design, "launches": STREAM_ITERS,
              "split_equals_stacked": same})
        check(same, f"split and stacked layouts differ on the {design} design")
    return records


def phase_stream_pcg(spec) -> dict:
    """solve(lap2d_fd(3200), fp32, use_pallas, precond="neumann") above
    the budget runs the streaming PCG kernel in pcg_plan's design, its
    launches a call 32 ceil(k / 32) times (the host reads the scalars once
    per 32 calls); against the plain pipelined Neumann PCG with fp64 dots;
    then its device-time profile. Returns its launch counts."""
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
    plan = cg_stream.pcg_plan(n, tuple(dia.offsets), torch.float32, dia_powers.sms_of(DEV))
    calls = 32 * -(-k // 32)
    check(launches["stream_iteration_pcg"] == plan.launches * calls and not others
          and cg_stream._stream_iteration_pcg.design == plan.design,
          f"stream PCG path: {launches} at k={k}, design {plan.design}")
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
          "design": plan.design, "launches_per_iter": plan.launches,
          "k_plain": k_plain, "plain_seconds": plain_seconds, "true_rel": rel,
          "true_rel_plain": rel_plain, "x_finite": bool(torch.isfinite(res.x).all())})
    check(bool(torch.isfinite(res.x).all()), "stream PCG result is not finite")
    check(abs(k - k_plain) <= 0.02 * k_plain, f"stream PCG: k={k} vs plain k={k_plain}")
    check(max(rel, rel_plain) <= 2 * min(rel, rel_plain),
          f"stream PCG: true residuals {rel} and {rel_plain} differ by more than 2x")
    phase_profile(op, b_dev, precond="neumann")
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
    """Words an iteration of the whole-solve kernel's global design moves
    through device memory: the bands once, p, x and r in and out; the
    preconditioner adds a band pass and c out and back (csrc/cg_kernel.cu).
    Kept beside :func:`resident_bound` for comparison: no design need
    move it."""
    return (2 * ndiag + 8) * n if precond else (ndiag + 6) * n


def resident_bound(spec, ndiag: int, n: int, band_bytes: int, precond: bool, iters: int,
                   launches: int = 1, vec_bytes: int = 4):
    """The least time of ``iters`` iterations of the whole-solve function
    in ``launches`` launches. Bytes: each launch reads the bands, p, x and
    r once and writes p, x and r once; nothing else need leave the chip.
    Operations an iteration a row, float32 vectors: float32, Ap (2 ndiag),
    the x, r and p updates (6), with the preconditioner c, Ac and z (2
    ndiag + 4); float64, the dots <p, Ap> and <r, r> (4), with <r, z> (6).
    bfloat16 vectors (``vec_bytes`` 2) round each vector operation to
    bfloat16, so at the bfloat16 rate; the dots' products are exact in
    float (2, with <r, z> 3) and only their sums need float64."""
    nbytes = launches * n * (ndiag * band_bytes + 6 * vec_bytes)
    vec = (4 * ndiag + 10 if precond else 2 * ndiag + 6) * n * iters
    dots = (3 if precond else 2) * n * iters
    if vec_bytes == 2:
        return bound_mixed(spec, nbytes, {BF16: vec, torch.float32: dots, torch.float64: dots})
    return bound_mixed(spec, nbytes, {torch.float32: vec, torch.float64: 2 * dots})


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


def chunk_plan(design: str, n: int, offsets, dtype, bands_dtype, precond: bool):
    """The whole-solve kernel's plan in ``design``: resident_plan's, which
    must pick it, or the global design forced."""
    if design == "global":
        return cg_kernel.GLOBAL_PLAN
    plan = cg_kernel.resident_plan(n, tuple(offsets), dtype, bands_dtype, precond,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
    check(plan.design == "resident", f"resident_plan picks {plan} at N = {n}, {dtype}")
    return plan


def phase_resident_kernel(spec) -> dict:
    """The whole-solve chunk kernel in both designs against its plain
    version from one seeded state (float32 and bfloat16 bands on
    lap2d_fd(1000); float64 there in the global design and on
    lap2d_fd(500) in the resident one, where its vectors fit), then its
    time in both designs and the resident design's sync floor against the
    bound, in float32 (and under bfloat16 bands with the preconditioner, as
    the refinement's inner runs it). Returns the records of the kernels
    line for its four sites."""
    errs = {}
    for dtype, bf16 in ((torch.float32, False), (torch.float64, False), (torch.float32, True)):
        for design in ("resident", "global"):
            g = RESIDENT_F64_GRID if (dtype == torch.float64 and design == "resident") \
                else RESIDENT_GRID
            dia = lap2d_fd(g)
            n, offsets = dia.shape[0], tuple(dia.offsets)
            bands, state = seeded_state(dia, dtype)
            if bf16:
                bands = bands.to(torch.bfloat16)
            for precond in (False, True):
                plan = chunk_plan(design, n, offsets, dtype, bands.dtype, precond)
                for chunk, rtol in ((1, VEC_RTOL[dtype]), (CHUNK, CHUNK_RTOL[dtype])):
                    got, ref = [t.clone() for t in state], [t.clone() for t in state]
                    chunk_call(cg_kernel.dia_cg_chunk, bands, got, offsets, chunk, precond,
                               plan=plan)
                    chunk_call(cg_kernel.dia_cg_chunk_ref, bands, ref, offsets, chunk, precond)
                    sync()
                    max_abs = max(float((g_ - f).abs().max()) for g_, f in zip(got[:3], ref[:3]))
                    vec_rel = max(rel_err(g_, f, f.abs().max()) for g_, f in zip(got[:3], ref[:3]))
                    rsold_rel = rel_err(got[3][0], ref[3][0], ref[3][0].abs())
                    dot_tol = DOT_RTOL[dtype] if chunk == 1 else rtol
                    emit({"phase": "resident_kernel_check", "problem": f"lap2d_fd({g})",
                          "design": design, "dtype": str(dtype), "bands_dtype": str(bands.dtype),
                          "precond": precond, "iterations": chunk, "max_abs_err": max_abs,
                          "vec_rel_err": vec_rel, "rsold_rel_err": rsold_rel, "vec_rtol": rtol,
                          "rsold_rtol": dot_tol, "grid": cg_kernel.dia_cg_chunk.grid,
                          "scalars": got[3].tolist(), "plain_scalars": ref[3].tolist()})
                    check(cg_kernel.dia_cg_chunk.plan.design == design,
                          f"chunk kernel ran {cg_kernel.dia_cg_chunk.plan}, not {design}")
                    check(vec_rel <= rtol and rsold_rel <= dot_tol,
                          f"chunk kernel {design} {dtype} bf16={bf16} precond={precond} x{chunk}: "
                          f"vectors {vec_rel}, rsold {rsold_rel}")
                    check(torch.equal(got[3][1:], ref[3][1:]),
                          f"chunk kernel {design} {dtype} bf16={bf16} precond={precond} x{chunk}: "
                          f"converged, k, breakdown {got[3][1:].tolist()} against "
                          f"{ref[3][1:].tolist()}")
                    if dtype == torch.float32 and chunk == 1 and precond == bf16 and \
                            design == "resident":
                        errs[bf16] = max_abs
            del bands, state
            sync()

    records = {}
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    dia = lap2d_fd(RESIDENT_GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    for precond, bf16 in ((False, False), (True, False), (True, True)):
        base = torch.cuda.memory_allocated()
        bands, state = seeded_state(dia, torch.float32)
        if bf16:
            bands = bands.to(torch.bfloat16)
        plan = chunk_plan("resident", n, offsets, torch.float32, bands.dtype, precond)
        torch.cuda.reset_peak_memory_stats()
        ms = {layout: time_ms(lambda: chunk_call(cg_kernel.dia_cg_chunk, bands, state, offsets,
                                                 CHUNK, precond, layout=layout), reps=10, burst=2)
              for layout in cg_kernel.LAYOUTS}
        peak = torch.cuda.max_memory_allocated() - base
        global_ms = time_ms(lambda: chunk_call(cg_kernel.dia_cg_chunk, bands, state, offsets,
                                               CHUNK, precond, plan=cg_kernel.GLOBAL_PLAN),
                            reps=10, burst=2)
        floor_ms = time_ms(lambda: cg_kernel.resident_sync_floor(
            bands, *state[:3], state[3], offsets=offsets, chunk=CHUNK, precond=precond),
            reps=10, burst=2)
        plain_ms = time_ms(lambda: chunk_call(cg_kernel.dia_cg_chunk_ref, bands, state, offsets,
                                              CHUNK, precond), reps=3, burst=1)
        band_bytes = 2 if bf16 else 4
        bound, bound_by = resident_bound(spec, ndiag, n, band_bytes, precond, CHUNK)
        hbm_iter = (resident_words(ndiag, n, precond) * 4 - (4 - band_bytes) * ndiag * n * (
            2 if precond else 1)) / spec["hbm_bytes_per_s"] * 1e3
        state_bytes = cg_kernel.resident_state_bytes(ndiag, n, band_bytes, 4, precond=precond)
        rec = {"phase": "resident_kernel", "problem": f"lap2d_fd({RESIDENT_GRID})", "n": n,
               "dtype": "float32", "bands_dtype": str(bands.dtype), "precond": precond,
               "chunk": CHUNK, "design": plan.design, "plan": plan._asdict(),
               "ms_per_iter": {layout: t / CHUNK for layout, t in ms.items()},
               "global_ms_per_iter": global_ms / CHUNK,
               "sync_floor_ms_per_iter": floor_ms / CHUNK,
               "syncs_per_iter": 3 if precond else 2,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_share": {layout: bound / t for layout, t in ms.items()},
               "global_bound_share": bound / global_ms,
               "sync_floor_share": floor_ms / ms["2d"],
               # the global design's traffic an iteration at the HBM rate, for comparison:
               # above 100% where the state comes back from L2 or stays on chip
               "hbm_per_iter_bound_ms": hbm_iter,
               "hbm_per_iter_share": {layout: hbm_iter * CHUNK / t for layout, t in ms.items()},
               "global_hbm_per_iter_share": hbm_iter * CHUNK / global_ms,
               "plain_ms_per_iter": plain_ms / CHUNK, "max_memory_allocated": peak,
               "resident_state_bytes": state_bytes, "l2_bytes": l2}
        emit(rec)
        if precond == bf16:  # fp32 bands without, bf16 bands with the preconditioner
            for name, layout in (BF16_SITES if bf16 else RESIDENT_SITES).items():
                records[name] = {"max_abs_err": errs[bf16], "ms": ms[layout],
                                 "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                                 "hbm_per_iter_bound_ms": hbm_iter * CHUNK,
                                 "design": plan.design, "global_ms": global_ms,
                                 "sync_floor_ms": floor_ms,
                                 "library_ms": None}  # no one PyTorch call runs a CG chunk
        del bands, state
        sync()
    return records


def phase_resident_goldens() -> None:
    """The fp64 goldens through the whole-solve kernel: twice in the design
    resident_plan picks (the resident one), once in the global design."""
    for problem, dia in (("lap2d_fd(100)", lap2d_fd(100)),
                         ("lap2d_reference(10000)", lap2d_reference(10000))):
        b = source_term(dia.shape[0])
        op = as_operator(dia, torch.float64, device=DEV)
        b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
        lo, hi = GOLDEN_K[problem]
        runs = []
        for plan in (None, None, cg_kernel.GLOBAL_PLAN):
            sync()
            t0 = time.perf_counter()
            if plan is None:
                res = dia_cg_solve_vmem(op, b_dev, tol=1e-10, layout="2d", device=DEV)
            else:  # the same chunk loop with every chunk forced to the global design
                res = cg_kernel._solve(op.bands, b_dev, offsets=tuple(op.offsets), tol=1e-10,
                                       nearzero=config.NEARZERO, maxiter=dia.shape[0],
                                       chunk=64, precond=False, layout="2d", plan=plan)
            runs.append((res, int(res.iterations), time.perf_counter() - t0,
                         cg_kernel.dia_cg_chunk.plan))
        (res, k, seconds, plan), (res2, k2, _, _), (res_g, k_g, seconds_g, _) = runs
        rel = true_rel(dia, res.x.cpu().numpy(), b)
        rel_g = true_rel(dia, res_g.x.cpu().numpy(), b)
        bitwise = k == k2 and torch.equal(res.x.view(torch.int64), res2.x.view(torch.int64))
        emit({"phase": "resident_golden", "problem": problem, "dtype": "float64", "k": k,
              "true_rel": rel, "bitwise_repeat": bitwise, "seconds": seconds,
              "design": plan.design, "grid": plan.grid, "rows": plan.rows,
              "global_k": k_g, "global_true_rel": rel_g, "global_seconds": seconds_g})
        check(plan.design == "resident", f"resident {problem}: ran {plan}")
        for design, r_, k_, rel_ in (("resident", res, k, rel), ("global", res_g, k_g, rel_g)):
            check(bool(r_.converged) and lo <= k_ <= hi,
                  f"{design} {problem}: k={k_} not in [{lo}, {hi}]")
            check(rel_ < 1e-11, f"{design} {problem}: true relative residual {rel_}")
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
            n_launch = launches.get("dia_cg_vmem2d", 0) + launches.get("dia_cg_vmem", 0)
            bound, _ = resident_bound(spec, ndiag, n, 4, precond is not None, k + 1,
                                      max(1, n_launch))
            rec = {"phase": "resident_path", "problem": f"lap2d_fd({g})", "n": n,
                   "dtype": "float32", "precond": precond, "tol": tol, "k": k,
                   "through_solve": routed, "state_bytes": state,
                   "converged": bool(res.converged), "bitwise_repeat": bitwise,
                   "seconds": seconds, "us_per_iter": seconds / (k + 1) * 1e6,
                   "bound_us_per_iter": bound / (k + 1) * 1e3,
                   "hbm_per_iter_bound_us": words * 4 / spec["hbm_bytes_per_s"] * 1e6,
                   "launches": launches, "grid": cg_kernel.dia_cg_chunk.grid,
                   "k_plain": k_plain, "plain_seconds": plain_seconds,
                   "plain_us_per_iter": plain_seconds / (k_plain + 1) * 1e6,
                   "true_rel": rel, "true_rel_plain": rel_plain,
                   "x_finite": bool(torch.isfinite(res.x).all())}
            rec["design"] = cg_kernel.dia_cg_chunk.plan.design
            if precond is None:  # the three-kernel loop on the same problem
                reset_launches()
                loop, k_loop, loop_seconds = timed(lambda: dia_cg_solve_pallas(
                    op, b_dev, tol=tol, maxiter=n, device=DEV))
                body = read_launches()["dia_matvec_dot"]
                rec.update(k_loop=k_loop, loop_seconds=loop_seconds,
                           loop_us_per_iter=loop_seconds / body * 1e6,
                           loop_design=dia_spmv.dia_matvec_dot.plan.design,
                           loop_true_rel=rel64(loop.x))
                check(abs(k_loop - k_plain) <= 0.02 * k_plain,
                      f"three-kernel loop {g}: k={k_loop} vs the plain loop's {k_plain}")
            emit(rec)
            chunks = -(-(k + 1) // CHUNK)
            check(rec["converged"] and rec["x_finite"] and res.x.shape == (n,),
                  f"resident path {g} {precond}: did not converge to a finite x")
            others = {name: c for name, c in launches.items()  # B1 forms the PCG's z0
                      if name not in ("dia_cg_vmem2d", "dia_matvec") and name in KERNELS and c}
            check(launches["dia_cg_vmem2d"] >= chunks and not others,
                  f"resident path {g} {precond} left the whole-solve kernel: {launches} at k={k}")
            check(rec["design"] == ("resident" if g == RESIDENT_GRID else "global"),
                  f"resident path {g} {precond}: the {rec['design']} design ran")
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
              "hbm_per_iter_bound_us": {"resident": resident_words(ndiag, n, False) * 4 * hbm_us,
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


def slab_plan_of(n: int, dtype):
    """The slab design's plan on this card: what basis_plan picks where the
    rings do not fit, forced here to run beside the wavefront."""
    return dia_powers.slab_plan(n, SSTEP_S, dtype, dia_powers.sms_of(DEV))


def sstep_inputs(case: str, dia):
    """The case's bands on the card, the bands its kernels stream, and
    seeded p and r."""
    dtype, narrow = SSTEP_CASE_DTYPES[case]
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=DEV)
    rng = np.random.default_rng(SEED)
    p, r = (torch.as_tensor(rng.standard_normal(dia.shape[0]), dtype=dtype, device=DEV)
            for _ in range(2))
    return bands, bands.to(narrow) if narrow is not None else bands, p, r


def sstep_checks(case: str, basis: str, dia, kw, problem: str = f"lap2d_fd({GRID})") -> dict:
    """One case of the s-step kernels against their plain versions from
    seeded p and r; returns each site's max abs error."""
    dtype, narrow = SSTEP_CASE_DTYPES[case]
    n = dia.shape[0]
    bands, kb, p, r = sstep_inputs(case, dia)
    errs = {}
    where = f"sstep {problem} {case} {basis}"
    powers_designs = {}
    if narrow is None:  # the matrix-powers kernel: bands in the vectors' dtype
        want = ss.dia_sstep_basis_ref(bands, p, r, **kw)
        got = dia_powers.dia_sstep_basis_planes(bands, p, r, **kw)
        design = dia_powers.dia_sstep_basis_planes.design  # basis_plan's for this shape
        sync()
        errs["dia_sstep_basis_planes"] = float((got - want).abs().max())
        powers_designs[design] = torch.equal(got, want)
        del got
        if design != "slab":  # the other design on the same inputs, forced
            got = dia_powers.dia_sstep_basis_planes(bands, p, r, plan=slab_plan_of(n, dtype), **kw)
            sync()
            powers_designs["slab"] = torch.equal(got, want)
            del got
        check(all(powers_designs.values()), f"{where}: the matrix-powers basis is not the plain "
              f"one: {powers_designs}, max abs {errs['dia_sstep_basis_planes']}")
        del want
    m = 2 * SSTEP_S + 1
    gram = slice(ss.GRAM, ss.GRAM + m * m)
    coef = slice(ss.COEF, ss.COEF + 3 * m)
    flags = [ss.K, ss.CONV, ss.BRK, ss.LIVE]
    start = seeded_block(bands, p, r, kw)
    got, want = (ss.BlockState(*(t.clone() for t in start)) for _ in range(2))
    ss._sstep_gram(kb, got.p, got.r, got.state, got.bmat, **kw, **SSTEP_CONTROL)
    plan = ss._sstep_gram.plan  # basis_plan's design for this shape
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
    designs = {plan.design: {"rel_to_plain": gram_rel, "rel_to_exact": kern_exact}}
    slab = None
    if plan.design != "slab":  # the other design on the same inputs, forced
        other = ss.BlockState(*(t.clone() for t in start))
        slab = ss.workspace(DEV, n, kw["offsets"], SSTEP_S, dtype, plan=slab_plan_of(n, dtype))
        ss._sstep_gram(kb, other.p, other.r, other.state, other.bmat, work=slab, **kw,
                       **SSTEP_CONTROL)
        sync()
        g_slab = other.state[gram].view(m, m)
        designs["slab"] = {"rel_to_plain": float(((g_slab - g_plain).abs() / scale).max()),
                           "rel_to_exact": float(((g_slab - exact).abs() / scale).max())}
        check(max(designs["slab"].values()) <= GRAM_RTOL,
              f"{where}: the slab design's Gram is off by {designs['slab']}")
        del other
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
    # the recover launch from the same coefficients and a seeded x on both sides, in
    # basis_plan's design and, where that is the wavefront, in the slab design
    want.state.copy_(got.state)
    want.x.copy_(p)
    after_gram = ss.BlockState(*(t.clone() for t in want))
    ss._recover_ref(kb, want.p, want.r, want.x, want.state, **kw)
    recover_designs = {}
    for work in (None, slab) if slab is not None else (None,):
        mine = ss.BlockState(*(t.clone() for t in after_gram))
        ss._sstep_recover(kb, mine.p, mine.r, mine.x, mine.state, work=work, **kw)
        sync()
        recover_designs[ss._sstep_recover.design] = all(
            torch.equal(a, w) for a, w in zip(mine[:4], want[:4]))
        if work is None:
            errs["sstep_recover"] = max(float((a - w).abs().max())
                                        for a, w in zip(mine[:3], want[:3]))
    del mine, after_gram, slab
    same = all(recover_designs.values())
    check(same, f"{where}: recovered x, r, p or state differ from the plain version: "
                f"{recover_designs}, max abs {errs['sstep_recover']}")
    emit({"phase": "sstep_kernel_check", "case": case, "basis": basis,
          "problem": problem, "n": n, "dtype": str(dtype),
          "bands_dtype": str(kb.dtype), "max_abs_err": errs, "gram_rel_err": gram_rel,
          "gram_rel_err_to_exact": kern_exact, "plain_gram_rel_err_to_exact": plain_exact,
          "coef_rel_err": coef_rel, "powers_checked": narrow is None, "recover_bitwise": same,
          "state_after_gram": got.state[:ss.COEF].tolist(),
          "grid": {"gram": plan.grid, "recover": plan.grid},
          "gram_design": plan.design, "gram_plan": {"width": plan.width, "shared": plan.shared,
                                                    "grid": plan.grid, "slab": plan.slab},
          "gram_designs": designs, "recover_bitwise_by_design": recover_designs,
          "powers_bitwise_by_design": powers_designs})
    return errs


def sstep_times(spec, case: str, dia, kw) -> dict:
    """ms of a launch of each s-step site in this case (Chebyshev), beside
    its bound, the plain version's ms and the peak device memory."""
    dtype, narrow = SSTEP_CASE_DTYPES[case]
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
    slab = None
    slab_runs = {}
    if work.plan.design != "slab":
        slab_plan = slab_plan_of(n, dtype)
        slab = ss.workspace(DEV, n, kw["offsets"], SSTEP_S, dtype, plan=slab_plan)
        slab_runs = {
            "sstep_gram": lambda: ss._sstep_gram(kb, st.p, st.r, st.state, st.bmat, work=slab,
                                                 **kw, **SSTEP_CONTROL),
            "sstep_recover": lambda: recover(ss._sstep_recover, work=slab),
            "dia_sstep_basis_planes": lambda: dia_powers.dia_sstep_basis_planes(
                bands, p, r, plan=slab_plan, **kw)}
    if narrow is None:
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
                                      torch.finfo(kb.dtype).bits // 8)
        rec = {"phase": "sstep_kernel", "site": site, "case": case,
               "problem": f"lap2d_fd({GRID})", "n": n, "s": SSTEP_S, "dtype": str(dtype),
               "bands_dtype": str(kb.dtype), "ms": ms, "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / ms, "plain_ms": plain_ms, "max_memory_allocated": peak,
               "grid": SSTEP_SITES[site].grid}
        if site != "sstep_replay":  # basis_plan's design, and the slab design forced
            rec["design"] = work.plan.design
        if site in slab_runs:
            rec["slab_ms"] = time_ms(slab_runs[site])
            rec["slab_bound_share"] = bound / rec["slab_ms"]
        if site == "sstep_recover":
            rec["note"] = "each timed call also copies 2 words of the state (the live mark)"
        emit(rec)
        records[site] = rec
    del bands, kb, st, work, slab, slab_runs
    sync()
    return records


def phase_sstep_bounds():
    """The Lanczos bounds of lap2d_fd(GRID) on the card, once: set-up of
    the s-step phases, timed apart from the solves; beside them cgx's host
    NumPy steps on the same operator, timed, and the two paths' relative
    difference at HOST_LANCZOS_M steps each (the CPU tests hold it to
    1e-12)."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    op = as_operator(dia, torch.float32, device=DEV)
    sync()
    t0 = time.perf_counter()
    bounds = spectral_bounds(op, n)
    seconds = time.perf_counter() - t0
    # the host's steps reorthogonalise in NumPy (52 s at m = 64 on N =
    # 10,240,000): the comparison runs both paths at HOST_LANCZOS_M steps
    t0 = time.perf_counter()
    host = lanczos_bounds(host_matvec(op), n, m=HOST_LANCZOS_M)
    host_seconds = time.perf_counter() - t0
    card = lanczos_bounds(device_matvec(op), n, m=HOST_LANCZOS_M, device=op.bands.device)
    rel = max(abs(a - c) / abs(c) for a, c in zip(card, host))
    emit({"phase": "sstep_bounds", "problem": f"lap2d_fd({GRID})", "n": n,
          "lmin": bounds[0], "lmax": bounds[1], "seconds": seconds,
          "host_lanczos_seconds": host_seconds, "host_lanczos_m": HOST_LANCZOS_M,
          "card_vs_host_rel": rel})
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
    # a 7-point stencil: the wavefront kernels built for any number of diagonals
    # (the main path's 5-point kernels are built for sorted, centred offsets)
    dia3 = lap3d_fd(GENERIC_GRID)
    bounds3 = spectral_bounds(as_operator(dia3, torch.float32, device=DEV), dia3.shape[0])
    for case in SSTEP_CASES:
        sstep_checks(case, "chebyshev", dia3, sstep_kw(dia3, bounds3),
                     problem=f"lap3d_fd({GENERIC_GRID})")
        sync()
    records = {}
    for case in SSTEP_CASES:
        for site, rec in sstep_times(spec, case, dia, sstep_kw(dia, bounds)).items():
            if SSTEP_MAIN_CASE[site] == case:
                records[site] = {"max_abs_err": errs[case][site], "ms": rec["ms"],
                                 "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                                 "bound_by": rec["bound_by"],
                                 "library_ms": None,  # no one PyTorch call builds a Krylov basis
                                 "design": rec.get("design"), "slab_ms": rec.get("slab_ms")}
    return records


SSTEP_ROUTES = {"fused": ("sstep_gram", "sstep_recover"),
                "pallas": ("dia_sstep_basis_planes", "sstep_replay")}


def phase_sstep_path(spec, bounds, bounds_seconds: float, b4: dict) -> dict:
    """solve(lap2d_fd(GRID), fp32, method="sstep"): "auto" resolves to the
    fused kernels (bfloat16 bands by "auto"); then sstep_powers="pallas",
    the matrix-powers and replay kernels. Each once (bitwise on two runs
    capped at REPEAT_ITERS iterations), against the plain fp32 s-step loop with a float64 Gram (the kernels'
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
    counts, xs = {}, {}
    for route, sites in SSTEP_ROUTES.items():
        cfg = SolveConfig(precision="fp32", method="sstep", tolerance=tol,
                          **({"sstep_powers": "pallas"} if route == "pallas" else {}))
        capped = dataclasses.replace(cfg, maxiter=REPEAT_ITERS)
        res, k, seconds, launches, bitwise = solve_capped_repeat(
            lambda: solve(op, b_dev, cfg, device=DEV), lambda: solve(op, b_dev, capped, device=DEV))
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
               "gram_design": ss._sstep_gram.design if route == "fused" else None,
               "recover_design": ss._sstep_recover.design if route == "fused" else None,
               "powers_design": (dia_powers.dia_sstep_basis_planes.design
                                 if route == "pallas" else None),
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
        designs = ((rec["gram_design"], rec["recover_design"]) if route == "fused"
                   else (rec["powers_design"],))
        check(all(d == "wavefront" for d in designs), f"{where}: the designs ran were {designs}")
        check(abs(k - k_plain) <= 0.02 * k_plain, f"{where}: k={k} vs plain k={k_plain}")
        check(max(rel, rel_plain) <= 2 * min(rel, rel_plain),
              f"{where}: true residuals {rel} and {rel_plain} differ by more than 2x")
        counts.update({site: launches[site] for site in sites})
        xs[route] = res.x if fallback == 0 else None  # the kernels' x alone, for f16_bands
    phase_sstep_profile(op, b_dev, bounds)
    return counts, xs["fused"]


def phase_sstep_profile(op, b_dev, bounds) -> None:
    """Device time by kernel and the card's idle share over
    SSTEP_PROFILE_BLOCKS fused blocks (tol 0, so none stops early)."""
    from torch.profiler import ProfilerActivity, profile

    from cgx_torch import dia_sstep_stream_solve

    iters = SSTEP_PROFILE_BLOCKS * SSTEP_S
    kw = dict(s=SSTEP_S, bounds=bounds, tol=0.0, maxiter=iters, device=DEV)
    sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dia_sstep_stream_solve(op, b_dev, **kw)
    peak = torch.cuda.max_memory_allocated() - held  # the loop's state and workspace
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        k = int(dia_sstep_stream_solve(op, b_dev, **kw).iterations)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy_us, count = {}, 0.0, 0
    for ename, us in cuda_events(prof):
        name = next((key for key, kn in (("gram_kernel", "gram_wave_kernel"),
                                         ("gram_kernel", "gram_slab_kernel"),
                                         ("recover_kernel", "recover_wave_kernel"),
                                         ("recover_kernel", "recover_kernel")) if kn in ename),
                    "other")
        by_name[name] = by_name.get(name, 0.0) + us / SSTEP_PROFILE_BLOCKS
        busy_us += us
        count += 1
    emit({"phase": "sstep_profile", "blocks": SSTEP_PROFILE_BLOCKS, "k": k,
          "gram_design": ss._sstep_gram.design, "recover_design": ss._sstep_recover.design,
          "gram_us_per_block": by_name.get("gram_kernel", 0.0),
          "recover_us_per_block": by_name.get("recover_kernel", 0.0),
          "profiled_us_per_iter": wall_us / iters, "device_events": count,
          "device_us_per_block": by_name,
          "device_busy_us_per_block": busy_us / SSTEP_PROFILE_BLOCKS,
          "profiled_wall_us_per_block": wall_us / SSTEP_PROFILE_BLOCKS,
          "idle_share": 1 - busy_us / wall_us, "peak_bytes_above_inputs": peak})
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
              "designs": {"gram": ss._sstep_gram.design, "recover": ss._sstep_recover.design},
              "k": k, "k_plain": k_plain, "true_rel": rel, "true_rel_plain": rel_plain,
              "breakdown": bool(res.breakdown), "bitwise_repeat": bitwise, "seconds": seconds})
        check(bool(res.converged) and abs(k - k_plain) <= SSTEP_S,
              f"sstep {problem}: k={k} vs plain k={k_plain}")
        check(rel < max(1e-11, 2 * rel_plain),
              f"sstep {problem}: true relative residual {rel} (plain loop {rel_plain})")
        check(bitwise, f"sstep {problem}: two runs differ")
        check(ss._sstep_gram.design == ss._sstep_recover.design == "wavefront",
              f"sstep {problem}: the launches ran {ss._sstep_gram.design}, "
              f"{ss._sstep_recover.design}")


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
              "plan": dia_spmv.dia_matvec_stream2d_planes.plan._asdict(),
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
    resolving the local product to B8. The reference method (the bitwise
    repeat on REPEAT_ITERS iterations), against the plain classic
    loop of the main phase (the same
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
        capped = dataclasses.replace(cfg, maxiter=REPEAT_ITERS)
        with collectives.capture() as cap:  # the whole solve takes 12 s: a capped repeat
            res, k, seconds, launches, bitwise = solve_capped_repeat(
                lambda: solve(dia, b, cfg, mesh=mesh, device=DEV),
                lambda: solve(dia, b, capped, mesh=mesh, device=DEV))
        sigs = [cap.signature(i) for i in range(len(cap.programs))]
        rel = rel64(res.x)
        b8 = launches["dia_matvec_stream2d_planes"]
        others = {name: c for name, c in launches.items()
                  if name != "dia_matvec_stream2d_planes" and name in KERNELS and c}
        bound_iter, bound_by = bound_of(spec, torch.float32, (ndiag + 2) * n * 4, 2 * ndiag * n)
        rec = {"phase": "sharded", "method": method, "problem": f"lap2d_fd({GRID})", "n": n,
               "dtype": "float32", "world": mesh.size, "backend": dist.get_backend(mesh.group),
               "local_kernel": resolved, "tol": tol, "k": k, "converged": bool(res.converged),
               "bitwise_repeat": bitwise, "bitwise_repeat_iterations": REPEAT_ITERS,
               "seconds": seconds, "setup_seconds": setup_seconds,
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
        check(bitwise, f"{where}: two capped runs differ")
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
    for ename, us in cuda_events(prof):
        low = ename.lower()
        name = ("b8_dia_stream_kernel" if "dia_stream_kernel" in low else
                "nccl" if "nccl" in low else "other")
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


def no_kernel_launched(launches: dict, where: str) -> None:
    """The multigrid and preconditioner paths run plain torch (cgx's are
    XLA code): none of the hand-written kernels may launch there."""
    ran = {name: c for name, c in launches.items() if c}
    check(not ran, f"{where}: a hand-written kernel ran: {ran}")


def device_profile(fn) -> tuple:
    """(device events, device busy us, wall us) of one call of ``fn`` under
    torch.profiler, its result read before the clock stops. A lead kernel
    opens the trace, which may miss its first kernel; it is not counted."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the lead
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = [us for name, us in cuda_events(prof) if "spin" not in name and "sleep" not in name]
    return len(cuda), sum(cuda), wall_us


def level_split(mg, r0) -> list:
    """One cycle's device time by level: level L's subtree
    (``_vcycle(L, r_L)``, r_L the restriction of r0) profiled on its own,
    level L's time its subtree's less level L+1's. Returns [(us, events)]."""
    r_levels = [r0]
    for g in mg.grids[:-1]:
        r_levels.append(mg._restrict_bilinear(r_levels[-1], g, mg.ndim))
    subtree = []
    for level, r_l in enumerate(r_levels):
        mg._vcycle(level, r_l)  # warm
        events, busy_us, _ = device_profile(lambda: mg._vcycle(level, r_l))
        subtree.append((busy_us, events))
    return [(subtree[i][0] - subtree[i + 1][0], subtree[i][1] - subtree[i + 1][1])
            for i in range(len(subtree) - 1)] + [subtree[-1]]


def true_rel_compensated(bands, offsets, x, b) -> float:
    """||A x - b|| / ||b|| with each row's residual summed error-free
    (TwoProd and TwoSum in float64), so that the figure is the residual
    of the computed x and not the rounding of its evaluation: at N =
    10,240,000 an fp64 evaluation errs by about eps ||A|| ||x|| / ||b||,
    near 1e-10 (cgx gates its flagship on a triple-word evaluation for
    that reason, bench.py:65-71)."""
    n = x.shape[0]
    pad = max(abs(int(o)) for o in offsets)
    xp = torch.nn.functional.pad(x, (pad, pad))
    s, err = -b, torch.zeros_like(b)
    for d, off in enumerate(offsets):
        p, pe = two_prod(bands[d], xp[pad + off:pad + off + n])
        s, se = two_sum(s, p)
        err = err + (se + pe)
    return float(torch.linalg.norm(s + err) / torch.linalg.norm(b))


def counted(pc):
    """``pc`` with a count of its applications."""
    calls = [0]

    def apply(r):
        calls[0] += 1
        return pc(r)
    return apply, calls


def phase_mg_main(spec, b4: dict) -> dict:
    """MG-PCG on cgx's flagship problem, uncut: lap2d_operator(3200) and
    source_term_device built on the card, N = 10,240,000, fp64, tol
    1e-10 ||b||, through solve(precond="mg") with an fp32 cycle (bench.py's
    fp64_mg_mixed) and an fp64 one, twice each (bitwise); the hierarchy
    built by band probing on the card (galerkin_setup "auto"). Then the
    same build timed apart, with its peak device memory, the solve from it
    (bitwise solve()'s) with its V-cycles counted (at most 2k + 2), a
    profile of that solve (launches a loop iteration, idle share), and one
    cycle's device time split by level. B4's main path (fp32 answer)
    beside.

    The true residual is evaluated error-free. At this size fp64 leaves a
    floor near 1e-10 (||x|| / ||b|| is about 3e5, so eps ||A|| ||x|| /
    ||b|| is 2.7e-10, bench.py:65-71), so it is held to the larger of
    1e-10 and twice the floor the reference recurrence itself reaches
    there: plain fp64 CG (the three-kernel loop) at the same tolerance."""
    n = GRID * GRID
    op = lap2d_operator(GRID, torch.float64, device=DEV)
    b = source_term_device(n, device=DEV)
    bnorm = float(torch.linalg.norm(b))
    tol = 1e-10 * bnorm

    def true_rel(x):
        return float(torch.linalg.norm(
            dia_spmv.dia_matvec_ref(op.bands, x, offsets=op.offsets) - b) / bnorm)

    plain, k_plain, plain_seconds = timed(lambda: dia_cg_solve_pallas(op, b, tol=tol,
                                                                      device=DEV))
    check(bool(plain.converged), "mg_main: the plain fp64 loop did not converge")
    floor = true_rel_compensated(op.bands, op.offsets, plain.x, b)
    del plain
    summary = {"k": {}, "floor": floor, "k_plain": k_plain}
    for cycle in MG_CYCLES:
        cfg = SolveConfig(precision="fp64", precond="mg", mg_cycle_precision=cycle,
                          tolerance=tol)
        runs = []
        for _ in range(2):
            reset_launches()
            res, k, seconds = timed(lambda: solve(op, b, cfg, device=DEV))
            runs.append((res, k, seconds, read_launches()))
        (res, k, seconds, launches), (res2, k2, seconds2, _) = runs
        bitwise = k == k2 and torch.equal(res.x.view(torch.int64), res2.x.view(torch.int64))
        del res2, runs
        rel = true_rel_compensated(op.bands, op.offsets, res.x, b)
        rel_fp64 = true_rel(res.x)
        no_kernel_launched(launches, f"mg {cycle} cycle")

        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pc = api._build_precond(cfg, op)  # the build solve() makes
        sync()
        setup_seconds = time.perf_counter() - t0
        peak_build = torch.cuda.max_memory_allocated() - base
        mg = pc.__self__
        apply, calls = counted(pc)
        again, k_again, solve_seconds = timed(
            lambda: cg_solve(op, b, tol=tol, precond=apply, device=DEV))
        vcycles = calls[0]
        same = k_again == k and torch.equal(again.x.view(torch.int64), res.x.view(torch.int64))
        del again
        calls[0] = 0
        events, busy_us, wall_us = device_profile(
            lambda: int(cg_solve(op, b, tol=tol, precond=apply, device=DEV).iterations))
        loop_iters = calls[0] - 1  # the start applies it once, every loop iteration once
        split = level_split(mg, b.to(mg.dtype))
        levels = [{"grid": g, "bands": len(o.offsets) if o is not None else None,
                   "solve": "smooth" if o is not None else (
                       "dense inverse" if mg.coarsest_inv is not None else "Chebyshev 40"),
                   "device_us": us, "device_events": ev}
                  for g, o, (us, ev) in zip(mg.grids, [mg.fine] + mg.coarse_ops + [None], split)]
        rec = {"phase": "mg_main", "problem": f"lap2d_operator({GRID})", "n": n,
               "precision": "fp64", "cycle_precision": cycle, "tol": tol, "k": k,
               "converged": bool(res.converged), "true_rel": rel,
               "true_rel_fp64_evaluation": rel_fp64, "x_norm": float(torch.linalg.norm(res.x)),
               "b_norm": bnorm, "k_plain": k_plain, "plain_seconds": plain_seconds,
               "true_rel_plain": floor,
               "bitwise_repeat": bitwise, "seconds": seconds, "seconds_repeat": seconds2,
               "setup_seconds": setup_seconds,
               "solve_seconds": solve_seconds, "solve_bitwise_solve": same,
               "galerkin_setup": mg.galerkin_setup, "peak_build_bytes": peak_build,
               "vcycles": vcycles, "vcycles_cap": 2 * k + 2, "levels": levels,
               "vcycle_device_us": sum(us for us, _ in split),
               "profile_loop_iterations": loop_iters,
               "device_events": events, "device_events_per_iter": events / loop_iters,
               "device_busy_us_per_iter": busy_us / loop_iters,
               "profiled_wall_us_per_iter": wall_us / loop_iters,
               "idle_share_profiled": 1 - busy_us / wall_us,
               "idle_share": 1 - busy_us / (solve_seconds * 1e6),  # the same solve unprofiled
               "b4_seconds": b4["seconds"], "b4_k": b4["k"], "b4_true_rel": b4["true_rel"],
               "x_finite": bool(torch.isfinite(res.x).all())}
        emit(rec)
        where = f"mg_main ({cycle} cycle)"
        check(rec["converged"] and rec["x_finite"] and res.x.shape == (n,),
              f"{where}: did not converge to a finite x")
        check(rel < max(1e-10, 2 * floor),
              f"{where}: true relative residual {rel}, the plain fp64 loop's {floor}")
        check(bitwise and same, f"{where}: two solve() runs bitwise {bitwise}, the solve from "
              f"the separate build bitwise {same}")
        check(mg.galerkin_setup == "device", f"{where}: the {mg.galerkin_setup} Galerkin build ran")
        check(vcycles <= 2 * k + 2, f"{where}: {vcycles} V-cycles for k={k}")
        summary["k"][cycle] = k
        summary[f"seconds_{cycle}"] = seconds
        summary[f"setup_seconds_{cycle}"] = setup_seconds
        del res, pc, mg, apply
        sync()
    return summary


def mg_cpu_twin(dia, ndim: int, setup: str):
    """The CPU counterpart of the card's hierarchy: one build (the card's
    Galerkin setup, GS colours included) whose smoother and cycle are set
    per configuration. Both are read only by the apply, so a variant is
    the preconditioner a fresh build with them makes, at one build's cost
    (the 3-D probe build takes tens of seconds on the host's cores)."""
    import copy

    op = as_operator(dia, torch.float64, device="cpu")
    base = mg_preconditioner(op, ndim=ndim, smoother="gs", galerkin_setup=setup)

    def variant(smoother, cycle):
        mg = copy.copy(base)
        mg.smoother, mg.cycle = smoother, cycle
        return mg
    return op, variant


def phase_mg_goldens() -> None:
    """MG-PCG goldens, fp64, tol 1e-10 ||b||: lap2d_fd(100), (130) (the
    Chebyshev coarsest) and lap3d_fd(64) (3-D, 81- and 125-band levels;
    lap3d_fd(128) would take 75 s more of the script's time limit),
    Richardson and GS, V and W (less MG_SKIP): k on the card equal to the
    same solve's on this machine's CPU or within 1, the true residual
    below 1e-10, no hand-written kernel. Then the device Galerkin build of
    lap2d_fd(256) against the host build, band by band, within 1e-12."""
    for problem, make in MG_GOLDENS:
        dia = make()
        n = dia.shape[0]
        ndim = infer_grid_ndim(n, dia.offsets)
        b = source_term(n)
        tol = 1e-10 * float(np.linalg.norm(b))
        op = as_operator(dia, torch.float64, device=DEV)
        b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
        twin = None
        for smoother, cycle in MG_CONFIGS:
            if (problem, smoother, cycle) in MG_SKIP:
                continue
            sync()
            reset_launches()
            t0 = time.perf_counter()
            mg = mg_preconditioner(op, ndim=ndim, smoother=smoother, cycle=cycle)
            setup_seconds = time.perf_counter() - t0
            res, k, seconds = timed(lambda: cg_solve(op, b_dev, tol=tol, precond=mg.apply,
                                                      device=DEV))
            launches = read_launches()
            if twin is None:
                t0 = time.perf_counter()
                op_cpu, twin = mg_cpu_twin(dia, ndim, mg.galerkin_setup)
                twin_setup = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = cg_solve(op_cpu, b, tol=tol, precond=twin(smoother, cycle).apply, device="cpu")
            k_cpu = int(cpu.iterations)
            rel = true_rel_compensated(op.bands, op.offsets, res.x, b_dev)
            emit({"phase": "mg_golden", "problem": problem, "ndim": ndim, "smoother": smoother,
                  "cycle": cycle, "k": k, "k_cpu": k_cpu, "converged": bool(res.converged),
                  "true_rel": rel, "true_rel_cpu": true_rel(dia, cpu.x.numpy(), b),
                  "grids": mg.grids, "bands": [len(o.offsets) for o in mg.coarse_ops],
                  "coarsest": "dense inverse" if mg.coarsest_inv is not None else "Chebyshev 40",
                  "galerkin_setup": mg.galerkin_setup, "setup_seconds": setup_seconds,
                  "seconds": seconds, "cpu_setup_seconds": twin_setup,
                  "cpu_seconds": time.perf_counter() - t0})
            where = f"mg golden {problem} {smoother} {cycle}"
            check(bool(res.converged) and bool(cpu.converged), f"{where}: did not converge")
            check(abs(k - k_cpu) <= 1, f"{where}: k={k} on the card, {k_cpu} on the CPU")
            check(rel < 1e-10, f"{where}: true relative residual {rel}")
            no_kernel_launched(launches, where)
            del res, mg, cpu
            sync()

    dia = lap2d_fd(MG_PROBE_GRID)
    op = as_operator(dia, torch.float64, device=DEV)
    dev = mg_preconditioner(op, galerkin_setup="device")
    host = mg_preconditioner(op, galerkin_setup="host")
    worst = 0.0
    check(dev.grids == host.grids, f"probe grids {dev.grids} against host {host.grids}")
    for od, oh in zip(dev.coarse_ops, host.coarse_ops):
        check(od.offsets == oh.offsets, f"probe offsets {od.offsets} against host {oh.offsets}")
        for bd, bh in zip(od.bands, oh.bands):
            worst = max(worst, float((bd - bh).abs().max() / bh.abs().max()))
    inv_err = float((dev.coarsest_inv - host.coarsest_inv).abs().max()
                    / host.coarsest_inv.abs().max())
    emit({"phase": "mg_probe_vs_host", "problem": f"lap2d_fd({MG_PROBE_GRID})",
          "grids": dev.grids, "bands": [len(o.offsets) for o in dev.coarse_ops],
          "max_band_rel_err": worst, "coarsest_inverse_rel_err": inv_err})
    check(worst <= 1e-12, f"device Galerkin bands off the host's by {worst} (relative)")
    check(inv_err <= 1e-12, f"coarsest inverse off the host's by {inv_err} (relative)")


def phase_precond_paths(tmp: Path) -> None:
    """solve(precond="block_jacobi") and solve(precond="chebyshev") on
    lap2d_fd(1000), fp64, tol 1e-10 ||b||: k, seconds and the true
    residual (error-free), held to the larger of 1e-10 and twice the
    plain fp64 loop's at the same tolerance (the three-kernel loop, timed
    beside them: a few thousand iterations leave a floor above 1e-10
    there); then the CLI in this process with --precond mg --mg-cycle
    fp32 on lap2D_5pt_n100.mtx (DIA), at the CLI's absolute tolerance.
    The two preconditioned solves and the CLI launch no hand-written
    kernel."""
    dia = lap2d_fd(PRECOND_GRID)
    n = dia.shape[0]
    b = source_term(n)
    tol = 1e-10 * float(np.linalg.norm(b))
    op = as_operator(dia, torch.float64, device=DEV)
    b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
    plain, k_plain, plain_seconds = timed(lambda: dia_cg_solve_pallas(op, b_dev, tol=tol,
                                                                      device=DEV))
    floor = true_rel_compensated(op.bands, op.offsets, plain.x, b_dev)
    emit({"phase": "precond_path", "precond": None, "problem": f"lap2d_fd({PRECOND_GRID})",
          "n": n, "precision": "fp64", "tol": tol, "k": k_plain,
          "converged": bool(plain.converged), "seconds": plain_seconds,
          "us_per_iter": plain_seconds / k_plain * 1e6, "true_rel": floor})
    check(bool(plain.converged), "precond paths: the plain fp64 loop did not converge")
    del plain
    for name in ("block_jacobi", "chebyshev"):
        cfg = SolveConfig(precision="fp64", precond=name, tolerance=tol)
        reset_launches()
        res, k, seconds = timed(lambda: solve(op, b_dev, cfg, device=DEV))
        launches = read_launches()
        rel = true_rel_compensated(op.bands, op.offsets, res.x, b_dev)
        emit({"phase": "precond_path", "precond": name, "problem": f"lap2d_fd({PRECOND_GRID})",
              "n": n, "precision": "fp64", "tol": tol, "k": k, "converged": bool(res.converged),
              "seconds": seconds, "us_per_iter": seconds / max(k, 1) * 1e6, "true_rel": rel})
        check(bool(res.converged) and rel < max(1e-10, 2 * floor),
              f"precond={name}: converged {bool(res.converged)}, true relative residual {rel}, "
              f"the plain fp64 loop's {floor}")
        no_kernel_launched(launches, f"precond={name}")
        del res
        sync()

    mtx = tmp / "lap2D_5pt_n100.mtx"
    lap2d_fd_coo_lower(100).write(mtx, comment=" 2D 5-point Laplacian, 100x100 grid")
    out = tmp / "mg.txt"
    argv = [str(mtx), "1024", "16", "false", str(out), "--format", "dia", "--precond", "mg",
            "--mg-cycle", "fp32"]
    run, m, launches = cli_run(argv)
    k, rel = int(m.group(1)), float(m.group(4))
    row = out.read_text().splitlines()[0].split(",")
    emit({"phase": "precond_cli", "argv": argv[5:], "k": k, "step_line": m.group(0),
          "csv_row": run.csv_row, "seconds": run.seconds,
          "converged": bool(run.result.converged), "true_rel": rel})
    check(bool(run.result.converged) and rel < 1e-10,
          f"CLI --precond mg: converged {bool(run.result.converged)}, true residual {rel}")
    check(row[:2] == ["1024", "16"] and float(row[2]) > 0, f"CLI --precond mg: CSV row {row}")
    no_kernel_launched(launches, "CLI --precond mg")


def phase_sharded_precond(mesh) -> None:
    """The sharded route's block-Jacobi and Chebyshev preconditioners on
    the NCCL group of one rank: solve(lap2d_fd(1000), fp64, tol 1e-10
    ||b||, mesh=mesh) against the same solve on one device (k within 1),
    the true residual (error-free) held to the larger of 1e-10 and twice
    the plain fp64 loop's (the few thousand iterations leave a floor
    above 1e-10 there, phase 29), block-Jacobi's collectives an iteration
    point Jacobi's (its apply is local), no hand-written kernel (fp64
    shards take the plain local product)."""
    dia = lap2d_fd(PRECOND_GRID)
    n, g = dia.shape[0], PRECOND_GRID
    b = source_term(n)
    tol = 1e-10 * float(np.linalg.norm(b))
    op = as_operator(dia, torch.float64, device=DEV)
    b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
    plain, k_plain, _ = timed(lambda: dia_cg_solve_pallas(op, b_dev, tol=tol, device=DEV))
    floor = true_rel_compensated(op.bands, op.offsets, plain.x, b_dev)
    del plain
    jacobi_sig = [("ppermute", 1, g), ("ppermute", 1, g), ("psum", 1, 1), ("psum", 2, 2)]
    t0 = time.perf_counter()
    host_spectral_bounds(dia)  # what the sharded Chebyshev's set-up runs on the host
    bounds_seconds = time.perf_counter() - t0
    for name in ("block_jacobi", "chebyshev"):
        cfg = SolveConfig(precision="fp64", precond=name, tolerance=tol)
        single, k_single, single_seconds = timed(lambda: solve(op, b_dev, cfg, device=DEV))
        del single
        reset_launches()
        with collectives.capture() as cap:
            res, k, seconds = timed(lambda: solve(dia, b, cfg, mesh=mesh, device=DEV))
        launches = read_launches()
        sig = cap.signature(0)
        rel = true_rel_compensated(op.bands, op.offsets, res.x, b_dev)
        emit({"phase": "sharded_precond", "precond": name, "problem": f"lap2d_fd({g})", "n": n,
              "precision": "fp64", "world": mesh.size, "backend": dist.get_backend(mesh.group),
              "tol": tol, "k": k, "k_single": k_single, "converged": bool(res.converged),
              "seconds": seconds, "single_seconds": single_seconds,
              "host_bounds_seconds": bounds_seconds if name == "chebyshev" else 0.0,
              "us_per_iter": seconds / max(k, 1) * 1e6, "true_rel": rel,
              "true_rel_plain": floor, "k_plain": k_plain, "signature_iter": sig["iter"],
              "signature_uniform": sig["uniform"]})
        where = f"sharded precond={name}"
        check(bool(res.converged) and rel < max(TW_GATE, 2 * floor),
              f"{where}: converged {bool(res.converged)}, true relative residual {rel}, the "
              f"plain fp64 loop's {floor}")
        check(abs(k - k_single) <= 1, f"{where}: k={k}, one device k={k_single}")
        if name == "block_jacobi":
            check(sig["iter"] == jacobi_sig and sig["uniform"],
                  f"{where}: collectives an iteration {sig['iter']}")
        no_kernel_launched(launches, where)
        del res
        sync()


def ld_true_rel(bands: torch.Tensor, offsets, words, b: torch.Tensor) -> float:
    """||b - A x|| / ||b|| on the host in np.longdouble (x86 80-bit, eps
    about 5.4e-20), x the sum of its words (a triple or a pair) in
    longdouble: the referee of the extended-precision routes
    (tests/test_tw32.py:126-150)."""
    x = sum(w.cpu().numpy().astype(np.longdouble) for w in words)
    bl = b.cpu().numpy().astype(np.longdouble)
    r = bl.copy()
    n = bl.shape[0]
    for d, off in enumerate(offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        r[i0:i1] -= bands[d, i0:i1].cpu().numpy().astype(np.longdouble) * x[i0 + off:i1 + off]
    return float(np.sqrt(np.sum(r * r)) / np.sqrt(np.sum(bl * bl)))


def refine_run(fn) -> tuple:
    """(result, seconds to its residual on the host, peak device bytes
    above the start) of one refinement call."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = fn()
    float(res.residual_norm)  # waits for the last sweep
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def bitwise_words(u, v) -> bool:
    return all(torch.equal(a.view(torch.int32 if a.dtype == torch.float32 else torch.int64),
                           b.view(torch.int32 if b.dtype == torch.float32 else torch.int64))
               for a, b in zip(u, v))


def refine_record(kind: str, op, b, apply, calls, words, sweep_fn) -> dict:
    """Two runs of ``sweep_fn(sweeps)`` from one built hierarchy
    (``apply``, counted by ``calls``), their words bitwise, the first
    one's residuals (its own extended-precision one, the longdouble
    referee, and an fp64 evaluation of its fp64 view, error-free), its
    V-cycles and peak memory, then a profile of its first sweep alone
    (launches, device time, idle share; a whole run holds about 60,000
    kernels, one sweep keeps the trace short)."""
    bnorm = float(torch.linalg.norm(b))
    calls[0] = 0
    full = TW_KW["sweeps"]
    (r1, seconds, peak) = refine_run(lambda: sweep_fn(full))
    (r2, seconds2, _) = refine_run(lambda: sweep_fn(full))
    vcycles = calls[0] // 2
    sweeps, inner = r1.outer_iterations, int(r1.inner_iterations[0])
    first, first_seconds, _ = refine_run(lambda: sweep_fn(1))
    events, busy_us, wall_us = device_profile(lambda: float(sweep_fn(1).residual_norm))
    rec = {"problem": f"lap2d_operator({GRID})", "n": b.shape[0], "kw": TW_KW,
           "converged": bool(r1.converged), "sweeps": sweeps, "inner_iterations": inner,
           "vcycles": vcycles, "own_true_rel": float(r1.residual_norm) / bnorm,
           "referee_true_rel": ld_true_rel(op.bands, op.offsets, words(r1), b),
           "fp64_view_true_rel": true_rel_compensated(op.bands, op.offsets, r1.x, b),
           "residual_history": [float(h) / bnorm for h in r1.residual_history[:sweeps]],
           "bitwise_repeat": sweeps == r2.outer_iterations and bitwise_words(words(r1),
                                                                              words(r2)),
           "seconds": seconds, "seconds_repeat": seconds2, "peak_solve_bytes": peak,
           "first_sweep_inner_iterations": int(first.inner_iterations[0]),
           "first_sweep_seconds": first_seconds, "first_sweep_device_events": events,
           "first_sweep_device_ms": busy_us / 1e3,
           "first_sweep_profiled_wall_ms": wall_us / 1e3,
           "idle_share_profiled": 1 - busy_us / wall_us,
           "idle_share": 1 - busy_us / (first_seconds * 1e6),  # the same sweep unprofiled
           "x_finite": all(bool(torch.isfinite(w).all()) for w in words(r1))}
    where = f"{kind}_main"
    check(rec["converged"] and rec["x_finite"], f"{where}: did not converge to a finite x")
    check(rec["own_true_rel"] < TW_GATE and rec["referee_true_rel"] < TW_GATE,
          f"{where}: true relative residual {rec['own_true_rel']} ({kind}), "
          f"{rec['referee_true_rel']} (longdouble referee)")
    check(rec["bitwise_repeat"], f"{where}: two runs differ")
    return rec


def phase_tw_main() -> tuple:
    """bench.py's secondary flagship on the card, uncut: lap2d_operator(3200)
    and source_term_device (N = 10,240,000), triple-word float32 sweeps
    around an fp32 MG-PCG inner, gated on the true relative residual below
    1e-10 (below fp64's evaluation floor there). First through solve(
    precision="tw", precond="mg", tolerance=3e-11), which builds its own
    hierarchy; then refine_pcg_sweeps_tw with bench.py's arguments around
    a hierarchy built once (timed apart, with its peak memory), twice
    (the words bitwise), and profiled. No hand-written kernel runs: cgx's
    sweeps and V-cycle are XLA code. Returns the operator, b, the built
    hierarchy and the record, for the dd phase."""
    n = GRID * GRID
    op = lap2d_operator(GRID, torch.float64, device=DEV)
    b = source_term_device(n, device=DEV)
    bnorm = float(torch.linalg.norm(b))
    reset_launches()
    res, k_solve, solve_call_seconds = timed(lambda: solve(
        op, b, SolveConfig(precision="tw", precond="mg", tolerance=TW_KW["rtol"]), device=DEV))
    launches = read_launches()
    solve_rec = {"k": k_solve, "converged": bool(res.converged),
                 "own_true_rel": float(res.residual_norm) / bnorm,
                 "seconds": solve_call_seconds}
    check(solve_rec["converged"] and solve_rec["own_true_rel"] < TW_GATE,
          f"tw solve(): {solve_rec}")
    no_kernel_launched(launches, "tw solve()")
    del res
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mg = mg_preconditioner(op, dtype=torch.float32)
    sync()
    setup_seconds = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated() - base
    apply, calls = counted(mg.apply)
    reset_launches()
    kw = {k: v for k, v in TW_KW.items() if k != "sweeps"}
    rec = refine_record("tw", op, b, apply, calls, lambda r: r.x_words,
                        lambda sweeps: refine_pcg_sweeps_tw(op, b, precond=apply, sweeps=sweeps,
                                                            device=DEV, **kw))
    no_kernel_launched(read_launches(), "refine_pcg_sweeps_tw")
    rec = {"phase": "tw_main", **rec, "setup_seconds": setup_seconds,
           "peak_build_bytes": peak_build, "galerkin_setup": mg.galerkin_setup,
           "time_to_solution_seconds": setup_seconds + rec["seconds"], "solve": solve_rec}
    emit(rec)
    check(solve_rec["k"] == rec["sweeps"],
          f"tw: solve() took {solve_rec['k']} sweeps, the built hierarchy {rec['sweeps']}")
    return op, b, apply, calls, rec


def phase_dd_main(op, b, apply, calls, tw: dict) -> None:
    """The same problem, inner and arguments through refine_pcg_sweeps_dd:
    double-double fp64 sweeps, valid on the H100's IEEE fp64 (cgx measured
    them degraded on its TPU), under the same gate on the dd-evaluated
    residual and its longdouble referee; beside tw_main's numbers."""
    reset_launches()
    kw = {k: v for k, v in TW_KW.items() if k != "sweeps"}
    rec = refine_record("dd", op, b, apply, calls, lambda r: (r.x_hi, r.x_lo),
                        lambda sweeps: refine_pcg_sweeps_dd(op, b, precond=apply, sweeps=sweeps,
                                                            device=DEV, **kw))
    no_kernel_launched(read_launches(), "refine_pcg_sweeps_dd")
    emit({"phase": "dd_main", **rec, "tw_sweeps": tw["sweeps"],
          "tw_referee_true_rel": tw["referee_true_rel"], "tw_seconds": tw["seconds"],
          "reaches_tw": rec["referee_true_rel"] < TW_GATE and rec["sweeps"] <= tw["sweeps"]})


def phase_ozaki_dense() -> None:
    """The Ozaki dense operator on the reference's dense regime:
    lap2D_5pt_n100.mtx densified on the card (N = 10,000, fp64). The one
    int8 product (torch._int_mm) of A's slices and b's bitwise its float64
    plain version; OzakiDenseOperator.matvec within 1e-14 of torch.mv
    relative to each dot's mass; solve(dense_fp64="ozaki") at the
    golden's tolerance (k in its window, true residual below 1e-11, no
    hand-written kernel); "auto" the plain fp64 operator on CUDA; the ms
    of an Ozaki mat-vec beside B3's fp64 dense_matvec and torch.mv."""
    dia = lap2d_fd(OZAKI_GRID)
    n = dia.shape[0]
    dense = densify_on_device(as_operator(dia, torch.float64, device=DEV))
    a = dense.a
    b = torch.as_tensor(source_term(n), dtype=torch.float64, device=DEV)
    c, sigma = ozaki._build_slices(a, 8)
    d, _ = ozaki._slice_vector(b[:, None], 8)
    c_cat, d_cat = ozaki._int8_operands(c, d)
    p = ozaki.int8_matmul(c_cat, d_cat)
    p_ref = ozaki.int8_matmul_ref(c_cat, d_cat)
    int_mm_bitwise = torch.equal(p, p_ref)
    int_mm_ms = time_ms(lambda: ozaki.int8_matmul(c_cat, d_cat))
    del c, sigma, d, p, p_ref
    sync()
    t0 = time.perf_counter()
    op = ozaki.OzakiDenseOperator.from_dense(a)
    sync()
    slice_seconds = time.perf_counter() - t0
    x = torch.as_tensor(np.random.default_rng(SEED).standard_normal(n) * 1e6,
                        dtype=torch.float64, device=DEV)
    y, y_ref = op.matvec(x), torch.mv(a, x)
    mv_err = float(torch.max((y - y_ref).abs() / torch.mv(a.abs(), x.abs())))
    times = {"ozaki_matvec_ms": time_ms(lambda: op.matvec(x)),
             "b3_dense_matvec_ms": time_ms(lambda: matvec.dense_matvec(a, x)),
             "torch_mv_ms": time_ms(lambda: torch.mv(a, x))}
    del op, y, y_ref
    sync()
    tol = 1e-10  # the golden's absolute tolerance (tests/test_golden.py:73-131)
    results = {}
    for mode in ("ozaki", "auto"):
        reset_launches()
        res, k, seconds = timed(lambda: solve(dense, b, SolveConfig(
            precision="fp64", dense_fp64=mode, tolerance=tol), device=DEV))
        results[mode] = {"k": k, "converged": bool(res.converged), "seconds": seconds,
                         "true_rel": float(torch.linalg.norm(torch.mv(a, res.x) - b)
                                           / torch.linalg.norm(b)),
                         "launches": {k_: c_ for k_, c_ in read_launches().items() if c_}}
        del res
    auto_plain = api._maybe_ozaki(dense, SolveConfig()) is dense
    lo, hi = GOLDEN_K["lap2d_fd(100)"]
    rec = {"phase": "ozaki_dense", "problem": f"lap2d_fd({OZAKI_GRID}) dense", "n": n,
           "int_mm_shape": [list(c_cat.shape), list(d_cat.shape)],
           "int_mm_bitwise_plain": int_mm_bitwise, "int_mm_ms": int_mm_ms,
           "slice_seconds": slice_seconds, "matvec_max_err_over_mass": mv_err, **times,
           "solve": results, "golden_k": [lo, hi], "auto_is_plain": auto_plain}
    emit(rec)
    check(int_mm_bitwise, "ozaki: torch._int_mm differs from its float64 plain version")
    check(mv_err < OZAKI_MASS_RTOL, f"ozaki: mat-vec off torch.mv by {mv_err} of the mass")
    oz = results["ozaki"]
    check(oz["converged"] and lo <= oz["k"] <= hi and oz["true_rel"] < 1e-11,
          f"ozaki: solve(dense_fp64='ozaki') {oz}")
    check(auto_plain and results["auto"]["converged"], "ozaki: 'auto' is not the plain operator")
    no_kernel_launched(oz["launches"], "solve(dense_fp64='ozaki')")
    del dense, a, c_cat, d_cat
    sync()


def analytic_bounds(g: int) -> tuple:
    """The extreme eigenvalues of lap2d_fd(g), the 5-point Dirichlet
    stencil (4 on the diagonal, -1 at the four neighbours):
    4 (1 -+ cos(pi / (g + 1)))."""
    c = float(np.cos(np.pi / (g + 1)))
    return 4.0 * (1.0 - c), 4.0 * (1.0 + c)


def peak_since(base: int) -> int:
    return torch.cuda.max_memory_allocated() - base


def reset_peak() -> int:
    sync()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def profile_record(fn, iters: int) -> dict:
    """Launches, device ms and the idle share an iteration of ``fn``, a
    run of ``iters`` loop iterations, from torch.profiler."""
    events, busy_us, wall_us = device_profile(fn)
    return {"profile_iterations": iters, "device_events_per_iter": events / iters,
            "device_ms_per_iter": busy_us / iters / 1e3,
            "profiled_wall_us_per_iter": wall_us / iters,
            "idle_share_profiled": 1 - busy_us / wall_us}


def phase_gv_main(spec, b4: dict, mg: dict) -> None:
    """Ghysels-Vanroose CG on cgx's flagship problem, uncut:
    lap2d_operator(3200) and source_term_device (N = 10,240,000). First in
    fp32 (float64 dots) at the main path's 1e-5 ||b||, solve(method=
    "gvpipe") twice (bitwise), with a profile of 256 iterations and the
    peak memory. In fp32 cgx's recurrence breaks down before that
    tolerance once kappa passes about 1e4 (cgx's own gv_cg_solve does, on
    lap2d_fd(128) and up on the CPU: its deeper recursions drift by about
    eps kappa), and exits on it with converged False (gvpipe.py:148-160):
    so a converged run is held to the classic loop's true residual within
    2x (cgx bounds no fp32 count: tests/test_gvpipe.py:117-128), and a
    broken-down one to an honest exit (breakdown set, k below N, the
    reported residual within 2x of the true one). Then in fp64 at the same
    tolerance against the plain fp64 classic loop: cgx's bound k <= 1.15
    k_classic + 2 (tests/test_gvpipe.py:61) and the true residual within
    2x; then in fp64 with precond="mg" at 1e-10 ||b||, an fp64 and an fp32
    cycle: with the fp64 cycle k within 1 of mg_main's and MG's gate (the
    error-free true residual below the larger of 1e-10 and twice the
    plain fp64 loop's) where it converges, and an honest exit where the
    recursions stall first: an fp32 cycle is not the exactly symmetric
    operator they assume (cgx breaks down on it at lap2d_fd(64) and (128)
    on the CPU), and at this size even the fp64 cycle's recursive residual
    stalls near 1.3e-10 ||b||. So gvpipe MG-PCG with the fp64 cycle runs
    again at 1e-8 ||b||, held to MG-PCG on the same build (k one more,
    the true residual within 2x). Plain torch: no hand-written kernel runs
    (the fp64 yardstick is the three-kernel loop, B1 and B2)."""
    n = GRID * GRID
    b_host = source_term(n)
    rel64 = rel64_on_card(lap2d_fd(GRID), b_host)
    op = lap2d_operator(GRID, torch.float32, device=DEV)
    b = source_term_device(n, torch.float32, device=DEV)
    tol = 1e-5 * float(np.linalg.norm(b_host))
    cfg = SolveConfig(precision="fp32", method="gvpipe", tolerance=tol)
    base = reset_peak()
    res, k, seconds, launches, bitwise = solve_twice(lambda: solve(op, b, cfg, device=DEV))
    peak = peak_since(base)
    rel = rel64(res.x)
    prof = profile_record(lambda: solve(op, b, SolveConfig(
        precision="fp32", method="gvpipe", tolerance=0.0, maxiter=PROFILE_ITERS),
        device=DEV).iterations.item(), PROFILE_ITERS)
    bound = GV_SLACK[0] * b4["k_classic"] + GV_SLACK[1]
    reported = float(res.residual_norm) / float(np.linalg.norm(b_host))
    rec = {"phase": "gv_main", "problem": f"lap2d_operator({GRID})", "n": n,
           "precision": "fp32", "dots": "float64", "tol": tol, "k": k,
           "converged": bool(res.converged), "breakdown": bool(res.breakdown),
           "bitwise_repeat": bitwise, "seconds": seconds, "us_per_iter": seconds / max(k, 1) * 1e6,
           "k_classic": b4["k_classic"], "k_bound": bound,
           "classic_seconds": b4["classic_seconds"], "true_rel": rel,
           "reported_rel": reported, "true_rel_classic": b4["true_rel_classic"],
           "peak_bytes": peak, **prof,
           "x_finite": bool(torch.isfinite(res.x).all())}
    emit(rec)
    check(rec["x_finite"] and res.x.shape == (n,), "gv_main: x is not finite")
    check(bitwise, "gv_main: two runs differ")
    rc = b4["true_rel_classic"]
    if rec["converged"]:
        check(max(rel, rc) <= 2 * min(rel, rc),
              f"gv_main: true residual {rel}, the classic loop's {rc}: more than 2x apart")
    else:
        check(rec["breakdown"] and k < n and max(rel, reported) <= 2 * min(rel, reported),
              f"gv_main: neither converged nor an honest breakdown: k={k}, breakdown "
              f"{rec['breakdown']}, reported residual {reported}, true {rel}")
    no_kernel_launched(launches, "gv_main")
    del res, op, b
    sync()

    op64 = lap2d_operator(GRID, torch.float64, device=DEV)
    b64 = source_term_device(n, device=DEV)
    classic, k_classic, classic_seconds = timed(lambda: dia_cg_solve_pallas(op64, b64, tol=tol,
                                                                            device=DEV))
    rc = rel64(classic.x)
    del classic
    reset_launches()
    res, k, seconds = timed(lambda: solve(op64, b64, SolveConfig(method="gvpipe", tolerance=tol),
                                          device=DEV))
    launches = read_launches()
    rel = rel64(res.x)
    bound = GV_SLACK[0] * k_classic + GV_SLACK[1]
    emit({"phase": "gv_main_fp64", "problem": f"lap2d_operator({GRID})", "n": n,
          "precision": "fp64", "tol": tol, "k": k, "converged": bool(res.converged),
          "seconds": seconds, "us_per_iter": seconds / k * 1e6, "k_classic": k_classic,
          "classic_seconds": classic_seconds, "k_bound": bound, "true_rel": rel,
          "true_rel_classic": rc})
    check(bool(res.converged) and k <= bound,
          f"gv_main fp64: converged {bool(res.converged)}, k={k}, bound {bound}")
    check(max(rel, rc) <= 2 * min(rel, rc),
          f"gv_main fp64: true residual {rel}, the classic loop's {rc}: more than 2x apart")
    no_kernel_launched(launches, "gv_main fp64")
    del res
    sync()

    tol64 = 1e-10 * float(torch.linalg.norm(b64))
    for cycle in MG_CYCLES:
        cfg = SolveConfig(precision="fp64", method="gvpipe", precond="mg",
                          mg_cycle_precision=cycle, tolerance=tol64)
        base = reset_peak()
        reset_launches()
        res, k, seconds = timed(lambda: solve(op64, b64, cfg, device=DEV))
        launches = read_launches()
        peak = peak_since(base)
        rel = true_rel_compensated(op64.bands, op64.offsets, res.x, b64)
        reported = float(res.residual_norm) / float(torch.linalg.norm(b64))
        k_mg = mg["k"][cycle]
        rec = {"phase": "gv_main_mg", "problem": f"lap2d_operator({GRID})", "n": n,
               "precision": "fp64", "cycle_precision": cycle, "tol": tol64, "k": k,
               "converged": res.converged.tolist() if res.converged.dim() else bool(res.converged),
            "breakdown": bool(res.breakdown),
               "seconds_with_build": seconds, "mg_main_k": k_mg,
               "mg_main_seconds_with_build": mg[f"seconds_{cycle}"],
               "mg_setup_seconds": mg[f"setup_seconds_{cycle}"], "true_rel": rel,
               "reported_rel": reported, "true_rel_plain": mg["floor"], "peak_bytes": peak,
               "x_finite": bool(torch.isfinite(res.x).all())}
        emit(rec)
        where = f"gv_main mg ({cycle} cycle)"
        check(rec["x_finite"], f"{where}: x is not finite")
        if rec["converged"]:
            check(abs(k - k_mg) <= 1, f"{where}: k={k}, mg_main's {k_mg}")
            check(rel < max(1e-10, 2 * mg["floor"]),
                  f"{where}: true relative residual {rel}, the plain fp64 loop's {mg['floor']}")
        else:
            # the recursions' drift: an honest exit on denom <= 0 (gvpipe.py:148-160)
            check(rec["breakdown"] and k < n, f"{where}: neither converged nor an honest "
                  f"breakdown: k={k}, breakdown {rec['breakdown']}")
        no_kernel_launched(launches, where)
        del res
        sync()

    # above the recursions' attainable accuracy at this size (the recursive
    # residual stalls near 1.3e-10 ||b|| from k = 11 on an H100): against
    # MG-PCG on the same build at the same tolerance
    tol8 = 1e-8 * float(torch.linalg.norm(b64))
    cfg = SolveConfig(precision="fp64", precond="mg", tolerance=tol8)
    pc = api._build_precond(cfg, op64)
    ref, k_ref, ref_seconds = timed(lambda: cg_solve(op64, b64, tol=tol8, precond=pc,
                                                     device=DEV))
    rel_ref = true_rel_compensated(op64.bands, op64.offsets, ref.x, b64)
    del ref
    reset_launches()
    res, k, seconds = timed(lambda: gv_cg_solve(op64, b64, tol=tol8, precond=pc, device=DEV))
    launches = read_launches()
    rel = true_rel_compensated(op64.bands, op64.offsets, res.x, b64)
    rec = {"phase": "gv_main_mg_1e-8", "problem": f"lap2d_operator({GRID})", "n": n,
           "precision": "fp64", "cycle_precision": "fp64", "tol": tol8, "k": k,
           "converged": bool(res.converged), "seconds": seconds, "k_pcg": k_ref,
           "pcg_seconds": ref_seconds, "true_rel": rel, "true_rel_pcg": rel_ref}
    emit(rec)
    where = "gv_main mg at 1e-8"
    # gvpipe tests convergence as an iteration starts: one more than classic's k
    check(rec["converged"] and 0 <= k - k_ref <= 1, f"{where}: k={k}, MG-PCG's {k_ref}")
    check(max(rel, rel_ref) <= 2 * min(rel, rel_ref),
          f"{where}: true residual {rel}, MG-PCG's {rel_ref}: more than 2x apart")
    no_kernel_launched(launches, where)
    del res, pc, op64, b64
    sync()


def phase_cheby_main(spec, b4: dict, tmp: Path) -> None:
    """The Chebyshev iteration at N = 10,240,000, fp32, tol 1e-5 ||b||.
    The analytic extremes of the 5-point Dirichlet stencil, checked
    against a dense eigvalsh of lap2d_fd(8) and (12) on the host, beside
    the port's spectral_bounds (64-step Lanczos, Gershgorin-tightened) of
    the card's operator. At kappa near 4e6 the 64 steps cannot resolve
    lmin; where the estimate is more than 2x above the analytic lmin the
    full-size solve runs on the analytic bounds (chebyshev_solve(bounds=)),
    else through solve(method="chebyshev"); once, bitwise on two runs
    capped at REPEAT_ITERS iterations, k a multiple
    of check_every, a profile of 256 iterations, the true residual below
    the larger of 1e-4 and twice the classic loop's. Then
    solve(method="chebyshev") on the reference's lap2D_5pt_n100.mtx in
    fp64, on the card and on the host CPU: k equal."""
    for g in (8, 12):
        ev = np.linalg.eigvalsh(lap2d_fd(g).to_dense())
        lo, hi = analytic_bounds(g)
        check(abs(ev[0] - lo) <= 1e-12 * hi and abs(ev[-1] - hi) <= 1e-12 * hi,
              f"cheby_main: lap2d_fd({g}) extremes {ev[0]}, {ev[-1]}; analytic {lo}, {hi}")
    n = GRID * GRID
    b_host = source_term(n)
    rel64 = rel64_on_card(lap2d_fd(GRID), b_host)
    op = lap2d_operator(GRID, torch.float32, device=DEV)
    b = source_term_device(n, torch.float32, device=DEV)
    tol = 1e-5 * float(np.linalg.norm(b_host))
    sync()
    t0 = time.perf_counter()
    est = spectral_bounds(op, n)
    bounds_seconds = time.perf_counter() - t0
    analytic = analytic_bounds(GRID)
    on_analytic = est[0] > 2 * analytic[0]
    if on_analytic:
        def run(maxiter=None, tol=tol):
            return chebyshev_solve(op, b, bounds=analytic, tol=tol, maxiter=maxiter, device=DEV)
    else:
        def run(maxiter=None, tol=tol):
            return solve(op, b, SolveConfig(precision="fp32", method="chebyshev", tolerance=tol,
                                            maxiter=maxiter), device=DEV)
    base = reset_peak()
    res, k, seconds, launches, bitwise = solve_capped_repeat(run,
                                                             lambda: run(maxiter=REPEAT_ITERS))
    peak = peak_since(base)
    rel = rel64(res.x)
    prof = profile_record(lambda: run(PROFILE_ITERS, 0.0).iterations.item(), PROFILE_ITERS)
    rc = b4["true_rel_classic"]
    rec = {"phase": "cheby_main", "problem": f"lap2d_operator({GRID})", "n": n,
           "precision": "fp32", "tol": tol, "bounds_estimate": list(est),
           "bounds_analytic": list(analytic), "bounds_seconds": bounds_seconds,
           "lmin_estimate_over_analytic": est[0] / analytic[0],
           "ran_on": "analytic bounds" if on_analytic else "estimated bounds",
           "k": k, "converged": bool(res.converged), "bitwise_repeat": bitwise,
           "seconds": seconds, "us_per_iter": seconds / k * 1e6, "k_classic": b4["k_classic"],
           "true_rel": rel, "true_rel_classic": rc, "peak_bytes": peak, **prof,
           "idle_share": 1 - prof["device_ms_per_iter"] * 1e3 / (seconds / k * 1e6),
           "x_finite": bool(torch.isfinite(res.x).all())}
    emit(rec)
    check(rec["converged"] and rec["x_finite"], "cheby_main: did not converge to a finite x")
    check(bitwise and k % SolveConfig().check_every == 0,
          f"cheby_main: bitwise {bitwise}, k={k} not a multiple of check_every")
    check(rel < max(1e-4, 2 * rc), f"cheby_main: true relative residual {rel}")
    no_kernel_launched(launches, "cheby_main")
    del res, op, b
    sync()

    mtx = tmp / "lap2D_5pt_n100.mtx"
    if not mtx.exists():
        lap2d_fd_coo_lower(100).write(mtx, comment=" 2D 5-point Laplacian, 100x100 grid")
    coo = COOMatrix.read(str(mtx))
    b100 = source_term(coo.shape[0])
    cfg = SolveConfig(method="chebyshev")
    card, k_card, card_seconds = timed(lambda: solve(coo, b100, cfg, device=DEV))
    t0 = time.perf_counter()
    cpu = solve(coo, b100, cfg, device="cpu")
    cpu_seconds = time.perf_counter() - t0
    dense = lap2d_fd(100).to_dense()
    rel_card = float(np.linalg.norm(dense @ card.x.cpu().numpy() - b100) / np.linalg.norm(b100))
    emit({"phase": "cheby_mtx", "problem": "lap2D_5pt_n100.mtx", "precision": "fp64",
          "k": k_card, "k_cpu": int(cpu.iterations), "converged": bool(card.converged),
          "seconds": card_seconds, "cpu_seconds": cpu_seconds, "true_rel": rel_card})
    check(bool(card.converged) and k_card == int(cpu.iterations),
          f"cheby_mtx: k={k_card} on the card, {int(cpu.iterations)} on the CPU")
    check(rel_card < 1e-11, f"cheby_mtx: true relative residual {rel_card}")


def phase_block_main(spec, mg: dict) -> None:
    """Block MG-PCG at N = 10,240,000: solve(lap2d_operator(3200), B,
    precond="mg", fp32 cycle) in fp64 with B (n, 8): source_term and seven
    seeded normal columns scaled to its norm, tol 1e-10 ||b0||, twice
    (bitwise). Every column's error-free true residual below MG's gate,
    k at most one above mg_main's single-RHS k. Then the build timed apart (peak
    memory), the solve from it (bitwise) with its V-cycles (one
    batched cycle an iteration), host syncs and peak memory counted, and a
    profile of it (launches, device ms and idle share an iteration)."""
    n = GRID * GRID
    op = lap2d_operator(GRID, torch.float64, device=DEV)
    b0 = source_term_device(n, device=DEV)
    bnorm = float(torch.linalg.norm(b0))
    cols = torch.as_tensor(np.random.default_rng(SEED).standard_normal((n, BLOCK_S - 1)),
                           device=DEV)
    big_b = torch.cat([b0[:, None], cols * (bnorm / torch.linalg.norm(cols, dim=0))], dim=1)
    del cols
    tol = 1e-10 * bnorm
    cfg = SolveConfig(precision="fp64", precond="mg", mg_cycle_precision="fp32", tolerance=tol)
    runs = []
    for _ in range(2):
        reset_launches()
        res, k, seconds = timed(lambda: solve(op, big_b, cfg, device=DEV))
        runs.append((res, k, seconds, read_launches()))
    (res, k, seconds, launches), (res2, k2, seconds2, _) = runs
    bitwise = k == k2 and torch.equal(res.x.view(torch.int64), res2.x.view(torch.int64))
    del res2, runs
    rels = [true_rel_compensated(op.bands, op.offsets, res.x[:, j].contiguous(),
                                 big_b[:, j].contiguous()) for j in range(BLOCK_S)]
    no_kernel_launched(launches, "block_main")

    base = reset_peak()
    t0 = time.perf_counter()
    pc = api._build_precond(cfg, op)
    sync()
    setup_seconds = time.perf_counter() - t0
    peak_build = peak_since(base)
    cycle = pc.__self__
    widths, syncs = [], [0]
    vcycle, host = cycle._vcycle, blockcg._host

    def counting_cycle(level, r):
        if level == 0:
            widths.append(r.shape[0] if r.dim() > 1 else 1)
        return vcycle(level, r)

    def counting_host(t):
        syncs[0] += 1
        return host(t)

    cycle._vcycle, blockcg._host = counting_cycle, counting_host
    try:
        base = reset_peak()
        again, k_again, solve_seconds = timed(lambda: block_cg_solve(
            op, big_b, tol=tol, maxiter=n, precond=pc, device=DEV))
        peak_solve = peak_since(base)
        same = k_again == k and torch.equal(again.x.view(torch.int64), res.x.view(torch.int64))
        del again
        cycles, host_reads = list(widths), syncs[0]
        prof = profile_record(lambda: int(block_cg_solve(op, big_b, tol=tol, maxiter=n,
                                                         precond=pc, device=DEV).iterations), k)
    finally:
        cycle._vcycle, blockcg._host = vcycle, host
    rec = {"phase": "block_main", "problem": f"lap2d_operator({GRID})", "n": n, "s": BLOCK_S,
           "precision": "fp64", "cycle_precision": "fp32", "tol": tol, "k": k,
           "converged": res.converged.tolist(), "breakdown": bool(res.breakdown),
           "bitwise_repeat": bitwise, "seconds_with_build": seconds,
           "seconds_with_build_repeat": seconds2, "setup_seconds": setup_seconds,
           "peak_build_bytes": peak_build, "solve_seconds": solve_seconds,
           "us_per_iter": solve_seconds / k * 1e6, "solve_bitwise_solve": same,
           "peak_solve_bytes": peak_solve, "vcycles": len(cycles),
           "vcycle_widths": sorted(set(cycles)),
           "host_syncs": host_reads, "host_syncs_per_iter": (host_reads - 3) / k,
           "mg_main_k": mg["k"]["fp32"], "mg_main_solve_seconds_with_build": mg["seconds_fp32"],
           "true_rel": rels, "true_rel_plain": mg["floor"], **prof,
           "idle_share": 1 - prof["device_ms_per_iter"] * 1e3 / (solve_seconds / k * 1e6),
           "x_finite": bool(torch.isfinite(res.x).all())}
    emit(rec)
    gate = max(1e-10, 2 * mg["floor"])
    check(bool(res.converged.all()) and rec["x_finite"] and res.x.shape == (n, BLOCK_S),
          f"block_main: converged {rec['converged']}")
    check(all(r < gate for r in rels), f"block_main: true residuals {rels}, the gate {gate}")
    # cgx's breakdown-free recurrence takes one iteration more than its
    # single-RHS MG-PCG on this block (8 against 7 at lap2d_fd(64) and (128)
    # on the CPU, cgx and the port alike; blockcg.py:29-31)
    check(k <= mg["k"]["fp32"] + 1,
          f"block_main: k={k}, the single-RHS MG-PCG k={mg['k']['fp32']}")
    check(bitwise and same, f"block_main: bitwise {bitwise}, from the separate build {same}")
    check(len(cycles) == k + 1 and set(cycles) == {BLOCK_S},
          f"block_main: {len(cycles)} V-cycles of widths {set(cycles)} for k={k}")
    del res, big_b, pc, cycle, op, b0
    sync()


def phase_multi_rhs_paths() -> None:
    """The other multi-RHS paths on lap2d_fd(1000) (N = 1,000,000), fp64:
    solve(multi_rhs="batched") with s = 4 (source_term and three seeded
    columns scaled to its norm, tol 1e-8 ||b0||) against each column's
    single-RHS cg_solve (k within 2); solve_sequence of three of them with
    k = 16 against plain CG (the first k within 1, the later ones within
    10% of plain's: on this Laplacian deflation does not pay, as cgx's
    docstring warns), seconds beside plain's; on lap2d_fd(AUTODIFF_GRID)
    (N = 250,000; its b0 and columns built alike) the differentiable solve at
    1e-10 ||b0||: db against one more solve (1e-10) and the band gradient
    against a central difference of the loss along the bands themselves
    (1e-6); the block version at s = 4 likewise. Plain torch: no hand-written kernel."""
    g = PRECOND_GRID
    dia = lap2d_fd(g)
    n = dia.shape[0]
    op = as_operator(dia, torch.float64, device=DEV)
    b0 = source_term(n)
    rng = np.random.default_rng(SEED + 1)
    cols = rng.standard_normal((n, MULTI_S - 1))
    big_b = torch.as_tensor(np.concatenate(
        [b0[:, None], cols * (np.linalg.norm(b0) / np.linalg.norm(cols, axis=0))], axis=1),
        device=DEV)
    tol = 1e-8 * float(np.linalg.norm(b0))
    reset_launches()
    sync()
    t0 = time.perf_counter()
    batched = solve(op, big_b, SolveConfig(multi_rhs="batched", tolerance=tol), device=DEV)
    ks = batched.iterations.tolist()
    batched_seconds = time.perf_counter() - t0
    singles = [timed(lambda: cg_solve(op, big_b[:, j].contiguous(), tol=tol, device=DEV))
               for j in range(MULTI_S)]
    k_single = [k for _, k, _ in singles]
    conv = bool(batched.converged.all())
    emit({"phase": "multi_rhs_batched", "problem": f"lap2d_fd({g})", "n": n, "s": MULTI_S,
          "tol": tol, "k": ks, "k_single": k_single, "converged": conv,
          "seconds": batched_seconds, "single_seconds": [s for _, _, s in singles]})
    check(conv and all(abs(a - c) <= 2 for a, c in zip(ks, k_single)),
          f"batched: k={ks}, single-RHS k={k_single}, converged {conv}")
    del batched

    sync()
    t0 = time.perf_counter()
    seq = solve_sequence(op, [big_b[:, j] for j in range(3)], SolveConfig(tolerance=tol),
                         k=SEQ_K, device=DEV)
    k_seq = [int(r.iterations) for r in seq]
    seq_seconds = time.perf_counter() - t0
    emit({"phase": "multi_rhs_sequence", "problem": f"lap2d_fd({g})", "n": n, "k": SEQ_K,
          "k_seq": k_seq, "k_plain": k_single[:3], "seconds": seq_seconds,
          "plain_seconds": sum(s for _, _, s in singles[:3]),
          "converged": [bool(r.converged) for r in seq]})
    check(all(bool(r.converged) for r in seq), "solve_sequence: a solve did not converge")
    # a 128-row harvest of a 2911-iteration solve deflates no low mode here:
    # cgx's own solve_sequence takes 3023 and 3122 on the CPU, the port's
    # counts, against plain 2855 and 2944
    check(abs(k_seq[0] - k_single[0]) <= 1 and all(a <= 1.1 * c for a, c in zip(
        k_seq[1:], k_single[1:3])), f"solve_sequence: k={k_seq}, plain CG k={k_single[:3]}")
    del seq, op, big_b

    g = AUTODIFF_GRID
    dia = lap2d_fd(g)
    n = dia.shape[0]
    op = as_operator(dia, torch.float64, device=DEV)
    b0 = source_term(n)
    cols = rng.standard_normal((n, MULTI_S - 1))
    big_b = torch.as_tensor(np.concatenate(
        [b0[:, None], cols * (np.linalg.norm(b0) / np.linalg.norm(cols, axis=0))], axis=1),
        device=DEV)
    dtol = 1e-10 * float(np.linalg.norm(b0))
    # the backward solve takes the forward's absolute tolerance (cgx's), so
    # the cotangents are scaled to ||b0||: the same relative accuracy both ways
    w = torch.as_tensor(rng.standard_normal(n), device=DEV)
    w = w * (float(np.linalg.norm(b0)) / torch.linalg.norm(w))
    bands = op.bands.clone().requires_grad_(True)
    b = torch.as_tensor(b0, device=DEV).requires_grad_(True)
    sync()
    t0 = time.perf_counter()
    loss = w @ cg_solve_differentiable(DiaOperator(bands, op.offsets), b, dtol, device=DEV)
    loss.backward()
    diff_seconds = time.perf_counter() - t0
    y = cg_solve(op, w, tol=dtol, device=DEV).x
    db_err = float(torch.max(torch.abs(b.grad - y)) / torch.max(torch.abs(y)))

    def loss_at(scale):
        return float(w @ cg_solve(DiaOperator(op.bands * scale, op.offsets), b.detach(),
                                  tol=dtol, device=DEV).x)

    fd = (loss_at(1 + FD_STEP) - loss_at(1 - FD_STEP)) / (2 * FD_STEP)
    ad = float(torch.sum(bands.grad * op.bands))
    emit({"phase": "multi_rhs_autodiff", "problem": f"lap2d_fd({g})", "n": n, "tol": dtol,
          "seconds_forward_backward": diff_seconds, "db_rel_err": db_err,
          "band_grad_along_bands": ad, "central_difference": fd,
          "fd_rel_err": abs(ad - fd) / abs(fd), "loss": float(loss.detach())})
    check(db_err <= 1e-10, f"autodiff: db off by {db_err}")
    check(abs(ad - fd) <= 1e-6 * abs(fd), f"autodiff: band gradient {ad}, difference {fd}")

    wb = torch.as_tensor(rng.standard_normal((n, MULTI_S)), device=DEV)
    wb = wb * (float(np.linalg.norm(b0)) / torch.linalg.norm(wb, dim=0))
    btol = dtol
    bands = op.bands.clone().requires_grad_(True)
    bb = big_b.clone().requires_grad_(True)
    sync()
    t0 = time.perf_counter()
    xb = block_cg_solve_differentiable(DiaOperator(bands, op.offsets), bb, btol, device=DEV)
    (wb * xb).sum().backward()
    block_seconds = time.perf_counter() - t0
    yb = block_cg_solve(op, wb, tol=btol, device=DEV).x
    db_block = float(torch.max(torch.abs(bb.grad - yb)) / torch.max(torch.abs(yb)))

    def block_loss_at(scale):
        return float(torch.sum(wb * block_cg_solve(DiaOperator(op.bands * scale, op.offsets),
                                                   big_b, tol=btol, device=DEV).x))

    fd = (block_loss_at(1 + FD_STEP) - block_loss_at(1 - FD_STEP)) / (2 * FD_STEP)
    ad = float(torch.sum(bands.grad * op.bands))
    launches = read_launches()
    emit({"phase": "multi_rhs_block_autodiff", "problem": f"lap2d_fd({g})", "n": n,
          "s": MULTI_S, "tol": btol, "seconds_forward_backward": block_seconds,
          "db_rel_err": db_block, "band_grad_along_bands": ad, "central_difference": fd,
          "fd_rel_err": abs(ad - fd) / abs(fd)})
    check(db_block <= 1e-10, f"block autodiff: dB off by {db_block}")
    check(abs(ad - fd) <= 1e-6 * abs(fd), f"block autodiff: band gradient {ad}, difference {fd}")
    no_kernel_launched(launches, "multi_rhs_paths")
    sync()


def phase_sharded_methods(mesh) -> None:
    """The sharded gvpipe and Chebyshev methods on the NCCL group of one
    rank: lap2d_fd(1000), fp64, tol 1e-8 ||b||; gvpipe through
    solve(mesh=), Chebyshev through sharded_cg_solve on the analytic
    bounds. k equal to the same solve on one device; the recorder shows
    one fused all-reduce an iteration for gvpipe (four more mat-vecs' halos
    on the replacement cadence) and one every check_every iterations for
    Chebyshev."""
    dia = lap2d_fd(PRECOND_GRID)
    n, g = dia.shape[0], PRECOND_GRID
    b = source_term(n)
    tol = 1e-8 * float(np.linalg.norm(b))
    op = as_operator(dia, torch.float64, device=DEV)
    b_dev = torch.as_tensor(b, dtype=torch.float64, device=DEV)
    bounds = analytic_bounds(g)
    every = SolveConfig().check_every
    for method in ("gvpipe", "chebyshev"):
        if method == "gvpipe":
            cfg = SolveConfig(method="gvpipe", tolerance=tol)
            single, k_single, single_seconds = timed(lambda: solve(op, b_dev, cfg, device=DEV))
            sharded = lambda: solve(dia, b, cfg, mesh=mesh, device=DEV)  # noqa: E731
        else:
            single, k_single, single_seconds = timed(lambda: chebyshev_solve(
                op, b_dev, bounds=bounds, tol=tol, device=DEV))
            sharded = lambda: sc.sharded_cg_solve(  # noqa: E731
                dia, b, mesh=mesh, method="chebyshev", bounds=bounds, tol=tol, device=DEV)
        del single
        reset_launches()
        with collectives.capture() as cap:
            res, k, seconds = timed(sharded)
        launches = read_launches()
        iters = cap.programs[0].iters
        psums = [[e for e in it if e[0] == "psum"] for it in iters]
        if method == "gvpipe":
            ok = all(p == [("psum", 1, 2)] for p in psums)
        else:
            ok = all(p == ([("psum", 1, 1)] if (i + 1) % every == 0 else [])
                     for i, p in enumerate(psums))
        emit({"phase": "sharded_method", "method": method, "problem": f"lap2d_fd({g})", "n": n,
              "precision": "fp64", "world": mesh.size, "backend": dist.get_backend(mesh.group),
              "tol": tol, "k": k, "k_single": k_single, "converged": bool(res.converged),
              "seconds": seconds, "single_seconds": single_seconds,
              "us_per_iter": seconds / max(k, 1) * 1e6, "loop_iterations": len(iters),
              "psums_in_loop": sum(len(p) for p in psums), "signature_iter": iters[0]})
        where = f"sharded {method}"
        check(bool(res.converged) and k == k_single, f"{where}: k={k}, one device k={k_single}")
        check(ok, f"{where}: all-reduces an iteration {psums[:every]}")
        no_kernel_launched(launches, where)
        del res
        sync()


def halo_shard(v: torch.Tensor, k: int, n_loc: int, d: int) -> torch.Tensor:
    """Shard k of ``v`` (rows on the last axis) with the d rows of each
    neighbour around it, zeros past the ends: what the sharded fused route's
    band exchange and per-block exchange put in a shard's extended rows."""
    n = v.shape[-1]
    lo, hi = k * n_loc, (k + 1) * n_loc
    out = torch.zeros(v.shape[:-1] + (n_loc + 2 * d,), dtype=v.dtype, device=v.device)
    a, b = max(lo - d, 0), min(hi + d, n)
    out[..., a - (lo - d): b - (lo - d)] = v[..., a:b]
    return out


def halo_block(kb, p, r, x, start, k: int, n_loc: int, d: int) -> ss.BlockState:
    """Shard k's block on the card: extended bands, p and r in half 0 of
    their pairs, x, and a copy of the start's state and B."""
    ext = halo_shard(torch.stack([p, r, x]), k, n_loc, d)
    pe, re = (torch.zeros((2, n_loc + 2 * d), dtype=p.dtype, device=p.device) for _ in range(2))
    pe[0], re[0] = ext[0], ext[1]
    return (halo_shard(kb, k, n_loc, d).contiguous(),
            ss.BlockState(ext[2].contiguous(), pe, re, start.state.clone(), start.bmat))


def phase_sstep_halo(spec) -> dict:
    """B10 in the halo mode of the sharded fused route: lap2d_fd(GRID),
    float32 vectors and bands, s = SSTEP_S, cut in one process into
    HALO_SHARDS shards of 2,560,000 rows (5000 x 512 of cgx's float32
    planes, fused_plane_geometry's tiling), each extended by its
    neighbours' d = pm cols rows by copies. Per shard the Gram-only launch
    over the shard's rows, then the recover from the single-device
    replay's coefficients. The shards' G summed in rank order holds to the
    single-device Gram kernel on the whole vector within GRAM_RTOL of its
    largest entry, the replay of the sum to the single-device coefficients
    within COEF_RTOL, and each shard's x, r and p rows bitwise to the
    single-device recover. Then each launch against its plain version on
    the same shards, with float32 and with bfloat16 bands, in both designs
    (halo_plain_checks), and the times of a shard's launches with the
    bfloat16 bands of the sharded fused route beside their bound on
    n_loc + 2d rows. Returns the kernels line's halo figures of the three
    sites."""
    dia = lap2d_fd(GRID)
    n, offsets = dia.shape[0], tuple(dia.offsets)
    n_loc = n // HALO_SHARDS
    rows, cols, pm = fused_plane_geometry(offsets, SSTEP_S, n_loc, torch.float32)
    d = pm * cols
    check(n_loc % (rows * cols) == 0 and d >= SSTEP_S * GRID
          and (GRID != 3200 or (cols, n_loc // cols) == (512, 5000)),
          f"halo geometry {(rows, cols, pm)} of a {n_loc}-row shard")
    kw = sstep_kw(dia, analytic_bounds(GRID))
    m = 2 * SSTEP_S + 1
    gram, coef = slice(ss.GRAM, ss.GRAM + m * m), slice(ss.COEF, ss.COEF + 3 * m)
    bands, kb, p, r = sstep_inputs("f32", dia)
    start = seeded_block(bands, p, r, kw)
    start.x.copy_(p)
    whole = ss.BlockState(*(t.clone() for t in start))
    ss._sstep_gram(kb, whole.p, whole.r, whole.state, whole.bmat, **kw, **SSTEP_CONTROL)
    ss._sstep_recover(kb, whole.p, whole.r, whole.x, whole.state, **kw)
    sync()
    g_whole = whole.state[gram]
    total = torch.zeros_like(g_whole)
    window = (d, d + n_loc)
    bitwise, design = [], None
    for k in range(HALO_SHARDS):
        kbk, st = halo_block(kb, p, r, start.x, start, k, n_loc, d)
        work = ss.workspace(DEV, n_loc, offsets, SSTEP_S, torch.float32)
        ss._sstep_gram(kbk, st.p, st.r, st.state, st.bmat, work=work, window=window, part=True,
                       **kw, **SSTEP_CONTROL)
        total += st.state[gram]  # the all-reduce's sum, in rank order
        design = ss._sstep_gram.design
        check(float(st.state[ss.LIVE]) == 1.0 and float(st.state[ss.K]) == 0.0,
              f"halo shard {k}: the Gram-only launch replayed or left the block dead")
        st.state[coef] = whole.state[coef]  # every shard recovers with the replay's coefficients
        ss._sstep_recover(kbk, st.p, st.r, st.x, st.state, work=work, window=window, **kw)
        lo, hi = k * n_loc, (k + 1) * n_loc
        bitwise.append(torch.equal(st.x[d:d + n_loc], whole.x[lo:hi])
                       and torch.equal(st.p[1, d:d + n_loc], whole.p[1, lo:hi])
                       and torch.equal(st.r[1, d:d + n_loc], whole.r[1, lo:hi]))
        del kbk, st, work
        sync()
    gram_rel = float((total - g_whole).abs().max() / g_whole.abs().max())
    summed = start.state.clone()
    summed[gram] = total
    summed[ss.LIVE] = 1.0
    ss.sstep_replay(summed, start.bmat, s=SSTEP_S, live_only=True, **SSTEP_CONTROL)
    c_whole = whole.state[coef]
    coef_rel = float((summed[coef] - c_whole).abs().max() / c_whole.abs().max())
    del whole, total, summed, bands, kb, p, r, start
    sync()
    checks = halo_plain_checks(dia, kw, n_loc)
    times = halo_times(spec, dia, kw, n_loc)
    rec = {"phase": "sstep_halo", "problem": f"lap2d_fd({GRID})", "n": n,
           "shards": HALO_SHARDS, "n_loc": n_loc, "geometry": {"rows": rows, "cols": cols,
                                                              "pm": pm}, "halo_rows": d,
           "design": design, "gram_rel_to_single_device": gram_rel,
           "coef_rel_to_single_device": coef_rel, "recover_bitwise_by_shard": bitwise,
           "plain_checks": checks, "times": times}
    emit(rec)
    check(gram_rel <= GRAM_RTOL, f"sstep halo: the shards' Gram sum is off by {gram_rel}")
    check(coef_rel <= COEF_RTOL, f"sstep halo: the replay of the sum is off by {coef_rel}")
    check(all(bitwise), f"sstep halo: the recovered rows differ by shard: {bitwise}")
    return times


def halo_plain_checks(dia, kw, n_loc: int) -> dict:
    """The halo-mode launches against their plain versions (on the card)
    on the same inputs, at the shapes of phase_sstep_halo's shards: every
    shard of the cut, float32 bands and the bfloat16 bands the sharded
    fused route streams ("auto"), each with that bands dtype's halo depth
    (fused_plane_geometry), in basis_plan's design and, where that is the
    wavefront, in the slab design forced. The Gram-only G within
    GRAM_RTOL of sum |v_i v_j| and the state's flags equal; the recover
    from seeded coefficients: x, r, p and the state bitwise."""
    offsets = tuple(dia.offsets)
    m = 2 * SSTEP_S + 1
    gram, coef = slice(ss.GRAM, ss.GRAM + m * m), slice(ss.COEF, ss.COEF + 3 * m)
    flags = [ss.K, ss.CONV, ss.BRK, ss.LIVE]
    rng = np.random.default_rng(SEED + 1)
    c = torch.as_tensor(rng.standard_normal(3 * m), dtype=torch.float64, device=DEV)
    out = {}
    for case in ("f32", "f32_bf16b"):
        dtype, narrow = SSTEP_CASE_DTYPES[case]
        d = fused_plane_geometry(offsets, SSTEP_S, n_loc, dtype, narrow)
        d = d[2] * d[1]
        bands, kb, p, r = sstep_inputs(case, dia)
        start = seeded_block(bands, p, r, kw)
        start.x.copy_(p)
        works = {}
        plan_work = ss.workspace(DEV, n_loc, offsets, SSTEP_S, dtype)
        works[plan_work.plan.design] = plan_work
        if plan_work.plan.design != "slab":
            works["slab"] = ss.workspace(DEV, n_loc, offsets, SSTEP_S, dtype,
                                         plan=slab_plan_of(n_loc, dtype))
        rec = {"bands": str(kb.dtype), "halo_rows": d, "gram_rel": {k: [] for k in works},
               "recover_bitwise": {k: [] for k in works}}
        window = (d, d + n_loc)
        for k in range(HALO_SHARDS):
            kbk, st = halo_block(kb, p, r, start.x, start, k, n_loc, d)
            want = ss.BlockState(*(t.clone() for t in st))
            ss._gram_ref(kbk, want.p, want.r, want.state, want.bmat, window=window, part=True,
                         **kw, **SSTEP_CONTROL)
            v = ss.dia_sstep_basis_ref(kbk, st.p[0], st.r[0], **kw)[:, d:d + n_loc].double()
            _, scale = pair_sums(v)
            del v
            want.state[coef] = c
            after_gram = ss.BlockState(*(t.clone() for t in want))
            ss._recover_ref(kbk, want.p, want.r, want.x, want.state, window=window, **kw)
            for design, work in works.items():
                got = ss.BlockState(*(t.clone() for t in st))
                ss._sstep_gram(kbk, got.p, got.r, got.state, got.bmat, work=work, window=window,
                               part=True, **kw, **SSTEP_CONTROL)
                sync()
                rel = float(((got.state[gram] - after_gram.state[gram]).abs()
                             / scale.reshape(-1)).max())
                same_flags = torch.equal(got.state[flags], after_gram.state[flags])
                rec["gram_rel"][design].append(rel if same_flags else float("inf"))
                got = ss.BlockState(*(t.clone() for t in after_gram))
                ss._sstep_recover(kbk, got.p, got.r, got.x, got.state, work=work, window=window,
                                  **kw)
                sync()
                rec["recover_bitwise"][design].append(all(
                    torch.equal(a, w) for a, w in zip(got[:4], want[:4])))
                del got
            del kbk, st, want, after_gram
            sync()
        out[case] = rec
        emit({"phase": "sstep_halo_plain_check", "case": case, "n_loc": n_loc, **rec})
        check(max(max(v) for v in rec["gram_rel"].values()) <= GRAM_RTOL
              and all(all(v) for v in rec["recover_bitwise"].values()),
              f"sstep halo against the plain versions ({case}): {rec}")
        del bands, kb, p, r, start, works, plan_work
        sync()
    return out


def halo_times(spec, dia, kw, n_loc: int) -> dict:
    """ms of shard 0's halo-mode launches (the Gram-only, the recover, the
    live-only replay) with the bfloat16 bands the sharded fused route
    streams, beside their bound on n_loc + 2d rows, the plain versions'
    ms and the launches' design."""
    ndiag = len(dia.offsets)
    offsets = tuple(dia.offsets)
    bands, kb, p, r = sstep_inputs(SSTEP_MAIN_CASE["sstep_gram"], dia)
    rows, cols, pm = fused_plane_geometry(offsets, SSTEP_S, n_loc, torch.float32, kb.dtype)
    d = pm * cols
    start = seeded_block(bands, p, r, kw)
    start.x.copy_(p)
    kbk, st = halo_block(kb, p, r, start.x, start, 0, n_loc, d)
    del bands, start
    work = ss.workspace(DEV, n_loc, offsets, SSTEP_S, torch.float32)
    live = torch.tensor([0.0, 1.0], dtype=torch.float64, device=DEV)
    window = (d, d + n_loc)

    def recover(fn, **extra):
        st.state[ss.BLK:ss.LIVE + 1].copy_(live)
        fn(kbk, st.p, st.r, st.x, st.state, window=window, **kw, **extra)

    runs = {
        "sstep_gram": (lambda: ss._sstep_gram(kbk, st.p, st.r, st.state, st.bmat, work=work,
                                              window=window, part=True, **kw, **SSTEP_CONTROL),
                       lambda: ss._gram_ref(kbk, st.p, st.r, st.state, st.bmat, window=window,
                                            part=True, **kw, **SSTEP_CONTROL)),
        "sstep_recover": (lambda: recover(ss._sstep_recover, work=work),
                          lambda: recover(ss._recover_ref)),
        "sstep_replay": (lambda: ss.sstep_replay(st.state, st.bmat, s=SSTEP_S, live_only=True,
                                                 **SSTEP_CONTROL),
                         lambda: ss._replay_ref(st.state, st.bmat, s=SSTEP_S, **SSTEP_CONTROL)),
    }
    out = {}
    for site, (kern, plain) in runs.items():
        sync()
        st.state[ss.LIVE] = 1.0
        ms = time_ms(kern)
        plain_ms = time_ms(plain, reps=3, burst=1)
        bound, bound_by = sstep_bound(spec, site, ndiag, n_loc + 2 * d, torch.float32,
                                      kb.element_size())
        out[site] = {"halo_ms": ms, "halo_plain_ms": plain_ms, "halo_bound_ms": bound,
                     "halo_bound_by": bound_by, "halo_rows": n_loc + 2 * d,
                     "halo_bands": str(kb.dtype),
                     "halo_design": work.plan.design if site != "sstep_replay" else None}
        emit({"phase": "sstep_halo_kernel", "site": site, "n_loc": n_loc, "halo": d, **out[site],
              "bound_share": bound / ms})
    del kbk, st, work, p, r
    sync()
    return out


def sharded_rec(phase: str, mesh, res, k: int, seconds: float, setup_seconds: float,
                launches: dict, bitwise: bool, **extra) -> dict:
    return {"phase": phase, "world": mesh.size, "backend": dist.get_backend(mesh.group), "k": k,
            "converged": res.converged.tolist() if res.converged.dim() else bool(res.converged),
            "breakdown": bool(res.breakdown),
            "bitwise_repeat": bitwise, "seconds": seconds, "setup_seconds": setup_seconds,
            "time_to_solution_seconds": seconds + setup_seconds,
            "us_per_iter": seconds / max(k, 1) * 1e6,
            "launches": {name: c for name, c in launches.items() if c},
            "x_finite": bool(torch.isfinite(res.x).all()), **extra}


def same_x(a, b) -> bool:
    """Two results' x bit for bit."""
    return same_bits(a.x, b.x)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two tensors bit for bit."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase_sharded_sstep(spec, mesh) -> dict:
    """The sharded s-step on the NCCL group of one rank: lap2d_fd(GRID),
    fp32 (the Gram and the replay in float64), s = SSTEP_S, tol 1e-5 ||b||,
    the stencil's analytic bounds, through make_sharded_solver and its
    solve, set-up apart, for "fused" (B10 per shard in the halo mode;
    bfloat16 bands by "auto"), "off" and "deephalo". Beside them the
    single-device fused route on the same bounds: "fused" takes its k,
    "off" and "deephalo" k within s of it, all three a true residual
    within 2x of its. The collectives a block from the recorder. The
    bitwise repeat and the profile run SSTEP_PROFILE_BLOCKS blocks of each
    (maxiter capped: "off" and "deephalo" take 20 s a whole solve).
    Returns the fused run's launches of the three B10 sites."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    bounds = analytic_bounds(GRID)
    rel64 = rel64_on_card(dia, b)
    op = as_operator(dia, torch.float32, device=DEV)
    b_dev = torch.as_tensor(b, dtype=torch.float32, device=DEV)
    single, k_single, single_seconds = timed(lambda: sstep_cg_solve(
        op, b_dev, s=SSTEP_S, bounds=bounds, tol=tol, powers="fused", device=DEV))
    rel_single = rel64(single.x)
    check(bool(single.converged), "sharded sstep: the single-device fused route did not converge")
    del single, op, b_dev
    sync()
    m = 2 * SSTEP_S + 1
    capped = SSTEP_PROFILE_BLOCKS * SSTEP_S
    counts = {}
    for powers in SHARDED_POWERS:
        kw = dict(dtype=np.float32, mesh=mesh, method="sstep", sstep_s=SSTEP_S,
                  sstep_powers=powers, bounds=bounds, tol=tol, dot_precision=torch.float64)
        t0 = time.perf_counter()
        solver = make_sharded_solver(dia, n, **kw)
        sync()
        setup_seconds = time.perf_counter() - t0
        reset_launches()
        with collectives.capture() as cap:
            res, k, seconds = timed(lambda: solver.solve(b))
        launches = read_launches()
        sig = cap.signature(0)
        rel = rel64(res.x)
        sites = ("sstep_gram", "sstep_recover", "sstep_replay")
        blocks = launches["sstep_gram"]
        prof_solver = make_sharded_solver(dia, n, maxiter=capped, **kw)
        bitwise = same_x(prof_solver.solve(b), prof_solver.solve(b))
        prof = profile_record(lambda: prof_solver.solve(b), capped)
        rec = sharded_rec("sharded_sstep", mesh, res, k, seconds, setup_seconds, launches,
                          bitwise, powers=powers, problem=f"lap2d_fd({GRID})", n=n,
                          dtype="float32", s=SSTEP_S, tol=tol, bounds=bounds,
                          bitwise_repeat_iterations=capped,
                          k_single_fused=k_single, single_fused_seconds=single_seconds,
                          true_rel=rel, true_rel_single_fused=rel_single,
                          signature_block=sig["iter"], signature_setup=sig["setup"],
                          signature_uniform=sig["uniform"], blocks_run=sig["iterations"],
                          bands_dtype=str(ss._sstep_gram.bands_dtype) if powers == "fused"
                          else "float32",
                          gram_design=ss._sstep_gram.design if powers == "fused" else None,
                          recover_design=ss._sstep_recover.design if powers == "fused" else None,
                          **prof)
        emit(rec)
        where = f"sharded sstep ({powers})"
        check(rec["converged"] and rec["x_finite"] and not rec["breakdown"]
              and res.x.shape == (n,), f"{where}: did not converge to a finite x")
        check(bitwise, f"{where}: two runs of {capped} iterations differ")
        check(k == k_single if powers == "fused" else abs(k - k_single) <= SSTEP_S,
              f"{where}: k={k}, the single-device fused route's {k_single}")
        check(rel <= 2 * rel_single, f"{where}: true residual {rel}, one device's {rel_single}")
        psums = [e for e in sig["iter"] if e[0] == "psum"]
        check(sig["uniform"] and psums == [("psum", 1, m * m)],
              f"{where}: collectives a block {sig['iter']}")
        if powers == "fused":
            check(blocks >= k // SSTEP_S and all(launches[s_] == blocks for s_ in sites),
                  f"{where}: launches {launches} at k={k}")
            others = {name: c for name, c in launches.items() if c and name not in sites}
            check(not others, f"{where} launched other kernels: {others}")
            counts = {s_: launches[s_] for s_ in sites}
        else:
            no_kernel_launched(launches, where)
        del res, solver, prof_solver
        sync()
    return counts


def phase_sharded_mixed(spec, mesh) -> None:
    """Mixed refinement on the NCCL group of one rank at N = 2,560,000
    (SHARDED_GRID):
    solve(precision="mixed", mesh=) at rtol MIXED_RTOL, its sweeps within
    one of the single-device mixed solve's (whose inner is the streaming
    PCG, the sharded one plain CG on B8), the true residual below
    MIXED_RTOL, B8 launched by every inner iteration. The bitwise repeat
    and the profile run one sweep of 256 inner iterations (the whole
    solve takes 26 s)."""
    dia = lap2d_fd(SHARDED_GRID)
    n = dia.shape[0]
    b = source_term(n)
    rel64 = rel64_on_card(dia, b)
    op64 = as_operator(dia, torch.float64, device=DEV)
    b64 = torch.as_tensor(b, dtype=torch.float64, device=DEV)
    cfg = SolveConfig(precision="mixed", tolerance=MIXED_RTOL)
    single, k_single, single_seconds = timed(lambda: solve(op64, b64, cfg, device=DEV))
    rel_single = rel64(single.x)
    del single, op64, b64
    reset_launches()
    res, k, seconds = timed(lambda: solve(dia, b, cfg, mesh=mesh, device=DEV))
    launches = read_launches()
    sweep = lambda: sc.sharded_refine_fixed_sweeps(  # noqa: E731
        dia, b, mesh=mesh, sweeps=1, inner_maxiter=256)
    bitwise = same_x(sweep(), sweep())
    prof = profile_record(sweep, 256)
    rel = rel64(res.x)
    inner = float(res.history.sum())
    rec = sharded_rec("sharded_mixed", mesh, res, k, seconds, 0.0, launches, bitwise,
                      problem=f"lap2d_fd({SHARDED_GRID})", n=n, rtol=MIXED_RTOL, sweeps=k,
                      inner_iterations=res.history.tolist(), sweeps_single=k_single,
                      single_seconds=single_seconds, true_rel=rel, true_rel_single=rel_single,
                      local_kernel=sc._resolve_local_kernel("auto", n, torch.float32, DEV),
                      bitwise_repeat_iterations=256, profile_inner_iterations=256, **prof)
    rec["us_per_iter"] = seconds / max(inner, 1.0) * 1e6  # an inner iteration
    rec["note"] = "no set-up apart: the sweeps convert the host operator in the call"
    emit(rec)
    check(rec["converged"] and bitwise and abs(k - k_single) <= 1 and rel < MIXED_RTOL,
          f"sharded mixed: {rec}")
    check(launches["dia_matvec_stream2d_planes"] >= inner,
          f"sharded mixed: the fp32 inner missed B8: {launches}")
    del res
    sync()


def sharded_built(public, setup) -> tuple:
    """A sharded solve whose set-up builds a hierarchy: ``setup()`` timed
    apart (the first build in the process: the host levels' Galerkin
    cache is cold), the call it returns run twice, timed, with the launch
    counts from the first, then ``public`` (the user's entry point, the
    build inside); all three x bit for bit. Returns (the public call's
    result, its k, the built solve's seconds, setup_seconds, launches,
    bitwise, the call, the public call's seconds)."""
    sync()
    t0 = time.perf_counter()
    run = setup()
    sync()
    setup_seconds = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    first = run()
    sync()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    second = run()
    res, k, public_seconds = timed(public)
    bitwise = same_x(first, res) and same_x(second, res)
    del first, second
    return res, k, seconds, setup_seconds, launches, bitwise, run, public_seconds


def phase_sharded_mg(spec, mesh, mg: dict) -> int:
    """MG-PCG on the NCCL group of one rank at N = 10,240,000:
    solve(precond="mg", mesh=) in fp64 with the fp32 cycle at 1e-10 ||b||,
    then sharded_mg_cg_setup's build (on the card) timed apart and its
    solve twice (all three bitwise); k within 2 of mg_main's and the true
    residual (error-free) below mg_main's gate, max(1e-10, 2x the plain
    fp64 floor); no kernel launches; a profile of the built solve.
    Returns its k."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    b = source_term(n)
    tol = 1e-10 * float(np.linalg.norm(b))
    gate = max(1e-10, 2 * mg["floor"])
    bands64 = torch.as_tensor(dia.bands, dtype=torch.float64, device=DEV)
    b64 = torch.as_tensor(b, dtype=torch.float64, device=DEV)
    cfg = SolveConfig(precision="fp64", precond="mg", mg_cycle_precision="fp32", tolerance=tol)
    res, k, seconds, setup_seconds, launches, bitwise, run, public_seconds = sharded_built(
        lambda: solve(dia, b, cfg, mesh=mesh, device=DEV),
        lambda: sharded_mg_cg_setup(dia, b, mesh=mesh, tol=tol, cycle_precision="fp32",
                                    device=DEV))
    prof = profile_record(run, k)
    rel = true_rel_compensated(bands64, tuple(dia.offsets), res.x, b64)
    rec = sharded_rec("sharded_mg", mesh, res, k, seconds, setup_seconds, launches, bitwise,
                      problem=f"lap2d_fd({GRID})", n=n, precision="fp64", cycle="fp32",
                      tol=tol, k_single=mg["k"]["fp32"], true_rel_compensated=rel, gate=gate,
                      public_call_seconds=public_seconds, **prof)
    emit(rec)
    check(rec["converged"] and bitwise and abs(k - mg["k"]["fp32"]) <= 2 and rel < gate,
          f"sharded MG: {rec}")
    no_kernel_launched(launches, "sharded MG")
    del res, bands64, b64, run
    sync()
    return k


def block_columns(b0: np.ndarray, s: int) -> np.ndarray:
    """(n, s): b0 and s - 1 seeded normal columns scaled to its norm, as
    block_main builds its block."""
    cols = np.random.default_rng(SEED).standard_normal((b0.shape[0], s - 1))
    cols *= np.linalg.norm(b0) / np.linalg.norm(cols, axis=0)
    return np.concatenate([b0[:, None], cols], axis=1)


def phase_sharded_block_mg(spec, mesh, mg: dict, k_sharded_mg: int) -> None:
    """Block MG-PCG on the NCCL group of one rank at N = 10,240,000:
    solve(B, precond="mg", mesh=) in fp64 with the fp32 cycle, B (n, 8)
    as block_main's, tol 1e-10 ||b0||, twice (bitwise); then
    sharded_mg_block_cg_setup's build timed apart and its solve (bitwise),
    with the cycles applied (one of width 8 an iteration) and a profile.
    Every column's error-free true residual below MG's gate, k at most one
    above the sharded single-RHS MG-PCG's; no kernel launches."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    b0 = source_term(n)
    big_b = block_columns(b0, BLOCK_S)
    tol = 1e-10 * float(np.linalg.norm(b0))
    gate = max(1e-10, 2 * mg["floor"])
    cfg = SolveConfig(precision="fp64", precond="mg", mg_cycle_precision="fp32", tolerance=tol)
    runs = []
    for _ in range(2):
        reset_launches()
        res, k, seconds = timed(lambda: solve(dia, big_b, cfg, mesh=mesh, device=DEV))
        runs.append((res, k, seconds, read_launches()))
    (res, k, seconds, launches), (res2, k2, seconds2, _) = runs
    bitwise = k == k2 and same_x(res, res2)
    del res2, runs
    no_kernel_launched(launches, "sharded block MG")
    bands64 = torch.as_tensor(dia.bands, dtype=torch.float64, device=DEV)
    b_dev = torch.as_tensor(big_b, device=DEV)
    rels = [true_rel_compensated(bands64, tuple(dia.offsets), res.x[:, j].contiguous(),
                                 b_dev[:, j].contiguous()) for j in range(BLOCK_S)]
    base = reset_peak()
    t0 = time.perf_counter()
    run = sharded_mg_block_cg_setup(dia, big_b, mesh=mesh, tol=tol, cycle_precision="fp32",
                                    device=DEV)
    sync()
    setup_seconds = time.perf_counter() - t0
    peak_build = peak_since(base)
    widths, call = [], _ShardedVCycle.__call__

    def counting(self, r):
        widths.append(r.shape[1] if r.dim() > 1 else 1)
        return call(self, r)

    _ShardedVCycle.__call__ = counting
    try:
        base = reset_peak()
        again, k_again, solve_seconds = timed(run)
        peak_solve = peak_since(base)
        cycles = list(widths)
        same = k_again == k and same_x(again, res)
        del again
        prof = profile_record(run, k)
    finally:
        _ShardedVCycle.__call__ = call
    rec = sharded_rec("sharded_block_mg", mesh, res, k, seconds, setup_seconds, launches,
                      bitwise, problem=f"lap2d_fd({GRID})", n=n, s=BLOCK_S, precision="fp64",
                      cycle="fp32", tol=tol, seconds_repeat=seconds2,
                      solve_seconds=solve_seconds, solve_us_per_iter=solve_seconds / k * 1e6,
                      solve_bitwise_public=same, peak_build_bytes=peak_build,
                      peak_solve_bytes=peak_solve, vcycles=len(cycles),
                      vcycle_widths=sorted(set(cycles)), k_sharded_mg=k_sharded_mg,
                      k_block_main_bound=mg["k"]["fp32"] + 1, true_rel=rels, gate=gate,
                      idle_share=1 - prof["device_ms_per_iter"] * 1e3 / (solve_seconds / k * 1e6),
                      **prof)
    emit(rec)
    where = "sharded block MG"
    check(bool(res.converged.all()) and not bool(res.breakdown) and rec["x_finite"]
          and res.x.shape == (n, BLOCK_S), f"{where}: converged {rec['converged']}")
    check(all(r < gate for r in rels), f"{where}: true residuals {rels}, the gate {gate}")
    check(k <= k_sharded_mg + 1, f"{where}: k={k}, the sharded single-RHS k={k_sharded_mg}")
    check(bitwise and same, f"{where}: bitwise {bitwise}, from the separate build {same}")
    check(len(cycles) == k + 1 and set(cycles) == {BLOCK_S},
          f"{where}: {len(cycles)} cycles of widths {set(cycles)} for k={k}")
    del res, run, bands64, b_dev
    sync()


def rel64_columns(dia, big_b: np.ndarray, xs) -> list:
    """Each column's ||A x_j - b_j|| / ||b_j|| in fp64 on the card (x_j
    the j-th row of ``xs``), the bands uploaded once."""
    bands64 = torch.as_tensor(dia.bands, dtype=torch.float64, device=DEV)
    out = []
    for j in range(big_b.shape[1]):
        b64 = torch.as_tensor(big_b[:, j], dtype=torch.float64, device=DEV)
        r = dia_spmv.dia_matvec_ref(bands64, xs[j].double(), offsets=tuple(dia.offsets)) - b64
        out.append(float(torch.linalg.norm(r) / torch.linalg.norm(b64)))
    return out


def batched_yardstick(dia, big_b: np.ndarray, tol: float) -> dict:
    """The plain loop with the sharded multi-RHS phases' dots: the
    single-device batched reference recurrence (cgx's cg_solve_batched)
    on the columns of ``big_b`` in float32, float32 dots, one call; each
    column's k and true residual."""
    n = dia.shape[0]
    op = as_operator(dia, torch.float32, device=DEV)
    b_rows = torch.as_tensor(np.ascontiguousarray(big_b.T), dtype=torch.float32, device=DEV)
    sync()
    t0 = time.perf_counter()
    res = cg_solve_batched(op, b_rows, tol=tol, maxiter=n, device=DEV)
    ks = res.iterations.tolist()  # waits for the solve
    seconds = time.perf_counter() - t0
    rels = rel64_columns(dia, big_b, res.x)
    out = {"k": ks, "true_rel": rels, "seconds": seconds, "converged": res.converged.tolist()}
    del res, op, b_rows
    sync()
    return out


def phase_sharded_batched(spec, mesh) -> dict:
    """The 2-D batched solve on make_mesh2d(1, 1) of the NCCL rank (its rows
    and rhs groups the NCCL world): sharded_cg_solve_batched at N =
    2,560,000 (SHARDED_GRID) in float32 (cgx's float32 dots), SHARDED_BATCHED_S seeded
    normal columns scaled to ||b0|| (block_columns' beside source_term's b0), tol
    BATCHED_RTOL ||b0|| (float32's floor at this conditioning: at 1e-5 the
    columns' true residuals end near 1e-3 all the same), method="pipelined".
    Each column's k within 2% of the plain loop with the same dots (the
    single-device batched reference recurrence, one call for them all: cgx
    holds pipelined to reference within one,
    tests/test_batched2d.py:166; source_term's column is not solved here:
    in float32 its pipelined recurrence stalls at the floor, a quarter
    past the reference's count) and its true residual within 2x; the
    collectives an iteration (the vote, one all-reduce of 16 dots, the
    halo pair); the bitwise repeat and a profile on REPEAT_ITERS
    iterations; no kernel launches. Returns b0 and the columns for the
    sequence phase."""
    dia = lap2d_fd(SHARDED_GRID)
    n = dia.shape[0]
    b0 = source_term(n)
    tol = BATCHED_RTOL * float(np.linalg.norm(b0))
    # b0 and the columns: the batched phase solves the columns, the sequence b0 and one
    every = block_columns(b0, SHARDED_BATCHED_S + 1).astype(np.float32)
    big_b = every[:, 1:]
    yard = batched_yardstick(dia, big_b, tol)
    mesh2d = make_mesh2d(1, 1, device=DEV)
    check(mesh2d.rows.group is mesh.group and mesh2d.rhs.group is mesh.group,
          "make_mesh2d(1, 1) is not over the NCCL world")
    bt = np.ascontiguousarray(big_b.T)
    reset_launches()
    with collectives.capture() as cap:
        sync()
        t0 = time.perf_counter()
        x, k_t, _res, conv, brk = sharded_cg_solve_batched(dia, bt, mesh=mesh2d, tol=tol,
                                                           method="pipelined", device=DEV)
        ks = k_t.tolist()  # waits for the solve
        seconds = time.perf_counter() - t0
    launches = read_launches()
    prog = cap.programs[-1]
    sig_iters = prog.iters
    rels = rel64_columns(dia, big_b, x)
    capped = lambda: sharded_cg_solve_batched(  # noqa: E731
        dia, bt, mesh=mesh2d, tol=tol, method="pipelined", maxiter=REPEAT_ITERS,
        device=DEV)
    first, second = capped(), capped()
    bitwise = torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))
    del first, second
    prof = profile_record(lambda: capped()[1].tolist(), REPEAT_ITERS)
    loop_iters = len(sig_iters)
    want_sig = [("psum", 1, 1), ("psum", 1, 2 * SHARDED_BATCHED_S),
                ("ppermute", 1, SHARDED_GRID * SHARDED_BATCHED_S),
                ("ppermute", 1, SHARDED_GRID * SHARDED_BATCHED_S)]
    rec = {"phase": "sharded_batched", "world": mesh.size, "mesh2d": list(mesh2d.shape),
           "backend": dist.get_backend(mesh.group), "problem": f"lap2d_fd({SHARDED_GRID})", "n": n,
           "s": SHARDED_BATCHED_S, "dtype": "float32", "method": "pipelined", "tol": tol,
           "k": ks,
           "converged": conv.tolist(), "breakdown": brk.tolist(), "seconds": seconds,
           "loop_iterations": loop_iters, "us_per_iter": seconds / loop_iters * 1e6,
           "bitwise_repeat": bitwise, "bitwise_repeat_iterations": REPEAT_ITERS,
           "k_plain": yard["k"], "plain_seconds": yard["seconds"], "true_rel": rels,
           "true_rel_plain": yard["true_rel"], "signature_iter": sig_iters[0],
           "signature_uniform": all(it == sig_iters[0] for it in sig_iters),
           "signature_setup": prog.setup,
           "launches": {name: c for name, c in launches.items() if c},
           "idle_share": 1 - prof["device_ms_per_iter"] * 1e3 / (seconds / loop_iters * 1e6),
           "x_finite": bool(torch.isfinite(x).all()), **prof}
    emit(rec)
    where = "sharded batched"
    check(bool(conv.all()) and not bool(brk.any()) and rec["x_finite"]
          and tuple(x.shape) == (SHARDED_BATCHED_S, n), f"{where}: converged {conv.tolist()}")
    check(all(yard["converged"]), f"{where}: the yardstick did not converge")
    check(all(abs(a - c) <= 0.02 * c for a, c in zip(ks, yard["k"])),
          f"{where}: k={ks}, the plain loop's {yard['k']}")
    check(all(max(a, c) <= 2 * min(a, c) for a, c in zip(rels, yard["true_rel"])),
          f"{where}: true residuals {rels}, the plain loop's {yard['true_rel']}")
    check(rec["signature_uniform"] and sig_iters[0] == want_sig,
          f"{where}: collectives an iteration {sig_iters[0]}")
    check(bitwise, f"{where}: two capped runs differ")
    no_kernel_launched(launches, where)
    del x
    sync()
    return every


def phase_sharded_sequence(spec, mesh, every: np.ndarray) -> int:
    """solve_sequence on the NCCL group of one rank at N = 2,560,000
    (SHARDED_GRID),
    fp32, tol SEQUENCE_RTOL ||b0||, k = 8: the sharded harvest on source_term, then
    deflated CG on SEQUENCE_LEN - 1 seeded columns (the batched phase's),
    "auto" resolving the local product to B8 on both. The harvest's k
    within 2% of the plain loop with the same dots (batched_yardstick on
    the same columns), each deflated solve within a tenth of that loop's count on
    its column (the harvest deflates little at this size) and a true
    residual within 2x of its; B8 launched by every iteration; the
    basis's width, the window's gather time and the peak memory. The bitwise
    repeat on REPEAT_ITERS iterations a solve. Returns B8's
    launches on the sequence."""
    dia = lap2d_fd(SHARDED_GRID)
    n = dia.shape[0]
    tol = SEQUENCE_RTOL * float(np.linalg.norm(every[:, 0]))
    bs = [np.ascontiguousarray(every[:, j]) for j in range(SEQUENCE_LEN)]
    yard = batched_yardstick(dia, every[:, :SEQUENCE_LEN], tol)
    cfg = SolveConfig(precision="fp32", tolerance=tol)
    resolved = sc._resolve_local_kernel("auto", n, torch.float32, mesh.device)
    check(resolved == "stream2d", f"auto resolved the local product to {resolved!r}")
    base = reset_peak()
    reset_launches()
    with collectives.capture() as cap:
        sync()
        t0 = time.perf_counter()
        seq = solve_sequence(dia, bs, cfg, k=SHARDED_SEQ_K, mesh=mesh, device=DEV)
        ks = [int(r.iterations) for r in seq]
        seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = peak_since(base)
    gather_seconds = sharded_cg_solve_harvest.gather_seconds
    rels = rel64_columns(dia, every[:, :SEQUENCE_LEN], [r.x for r in seq])
    sigs = [cap.signature(i) for i in range(len(cap.programs))]
    b8 = launches["dia_matvec_stream2d_planes"]
    capped = SolveConfig(precision="fp32", tolerance=tol, maxiter=REPEAT_ITERS)
    first = solve_sequence(dia, bs, capped, k=SHARDED_SEQ_K, mesh=mesh, device=DEV)
    second = solve_sequence(dia, bs, capped, k=SHARDED_SEQ_K, mesh=mesh, device=DEV)
    bitwise = all(same_x(a, c) for a, c in zip(first, second))
    del first, second
    rec = {"phase": "sharded_sequence", "world": mesh.size,
           "backend": dist.get_backend(mesh.group), "problem": f"lap2d_fd({SHARDED_GRID})", "n": n,
           "dtype": "float32", "tol": tol, "k_ritz": SHARDED_SEQ_K, "k": ks,
           "converged": [bool(r.converged) for r in seq], "seconds": seconds,
           "us_per_iter": seconds / sum(ks) * 1e6, "local_kernel": resolved,
           "k_plain": yard["k"], "plain_seconds": yard["seconds"], "true_rel": rels,
           "true_rel_plain": yard["true_rel"],
           "window_gather_seconds": gather_seconds, "peak_bytes": peak,
           "ritz_vectors": [e[2] // 2 for e in sigs[1]["iter"] if e[0] == "psum"][1]
           if len(sigs) > 1 else None,
           "b8_launches": b8, "launches": {name: c for name, c in launches.items() if c},
           "signature_iter": [sg["iter"] for sg in sigs],
           "signature_output": [sg["output"] for sg in sigs],
           "bitwise_repeat": bitwise, "bitwise_repeat_iterations": REPEAT_ITERS,
           "x_finite": all(bool(torch.isfinite(r.x).all()) for r in seq)}
    emit(rec)
    where = "sharded sequence"
    check(all(rec["converged"]) and rec["x_finite"], f"{where}: converged {rec['converged']}")
    check(abs(ks[0] - yard["k"][0]) <= 0.02 * yard["k"][0],
          f"{where}: the harvest's k={ks[0]}, the plain loop's {yard['k'][0]}")
    # a 64-row window of a solve of thousands of iterations harvests one Ritz pair
    # here and deflates little on this Laplacian (multi_rhs_paths finds the same on
    # one device, cgx's own counts with it): the deflated solves are held within a
    # tenth of the plain loop's, as there
    check(all(a <= 1.1 * c for a, c in zip(ks[1:], yard["k"][1:])),
          f"{where}: deflated k={ks[1:]}, the plain loop's {yard['k'][1:]}")
    check(all(r <= 2 * c for r, c in zip(rels, yard["true_rel"])),
          f"{where}: true residuals {rels}, the plain loop's {yard['true_rel']}")
    check(b8 >= sum(ks), f"{where}: B8 launched {b8} times for k={ks}")
    others = {name: c for name, c in launches.items()
              if c and name != "dia_matvec_stream2d_planes"}
    check(not others, f"{where} launched other kernels: {others}")
    check(bitwise, f"{where}: two capped sequences differ")
    del seq
    sync()
    return b8


def phase_sharded_tw(spec, mesh, tw: dict) -> None:
    """Triple-word sweeps on the NCCL group of one rank at N = 10,240,000:
    solve(precision="tw", precond="mg", mesh=) at tw_main's rtol, then
    sharded_tw_setup's fp32 hierarchy timed apart and its sweeps twice
    (all three bitwise); sweeps within one of tw_main's and its own
    tw-evaluated residual below TW_GATE, the host long-double residual of
    x's fp64 view beside it; a profile of the built sweeps."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    b = source_term(n)
    bnorm = float(np.linalg.norm(b))
    cfg = SolveConfig(precision="tw", precond="mg", tolerance=TW_KW["rtol"])
    res, k, seconds, setup_seconds, launches, bitwise, run, public_seconds = sharded_built(
        lambda: solve(dia, b, cfg, mesh=mesh, device=DEV),
        lambda: sharded_tw_setup(dia, b, mesh=mesh, rtol=TW_KW["rtol"], precond="mg",
                                 smoother=cfg.mg_smoother, device=DEV))
    prof = profile_record(run, k)
    own = float(res.residual_norm) / bnorm
    ld = ld_true_rel(torch.as_tensor(dia.bands, dtype=torch.float64, device=DEV),
                     tuple(dia.offsets), (res.x,),
                     torch.as_tensor(b, dtype=torch.float64, device=DEV))
    rec = sharded_rec("sharded_tw", mesh, res, k, seconds, setup_seconds, launches, bitwise,
                      problem=f"lap2d_fd({GRID})", n=n, rtol=TW_KW["rtol"], sweeps=k,
                      sweeps_single=tw["sweeps"], own_true_rel=own,
                      longdouble_true_rel_fp64_view=ld, gate=TW_GATE,
                      public_call_seconds=public_seconds, **prof)
    emit(rec)
    check(rec["converged"] and bitwise and abs(k - tw["sweeps"]) <= 1 and own < TW_GATE,
          f"sharded tw: {rec}")
    no_kernel_launched(launches, "sharded tw")
    del res, run
    sync()

CLI_METHODS = ("gvpipe", "chebyshev")
REPLAY_THREADS = 4  # of the host's cores, for the CPU replay beside the card's phases


def cli_method_argv(tmp: Path, method: str, device: str = "cuda") -> list:
    out = tmp / (f"{method}.txt" if device == "cuda" else f"{method}_cpu.txt")
    argv = [str(tmp / "lap2D_5pt_n100.mtx"), "1024", "16", "true", str(out), "--method", method]
    return argv if device == "cuda" else argv + ["--device", "cpu"]


@contextlib.contextmanager
def cli_replay(tmp: Path):
    """The CPU replay of phase_cli_methods' two CLI runs, started in a
    session of its own with REPLAY_THREADS threads just after the build, so
    that it runs while the card's phases do (the dense kernel's plain
    version takes about two minutes on the host); killed, with its
    children, on the way out."""
    replay = start_cli_replay(tmp)
    try:
        yield replay
    finally:
        if replay.poll() is None:
            os.killpg(replay.pid, signal.SIGKILL)
            replay.wait()


def start_cli_replay(tmp: Path) -> subprocess.Popen:
    """Start the CPU replay of phase_cli_methods' two CLI runs."""
    lap2d_fd_coo_lower(100).write(tmp / "lap2D_5pt_n100.mtx",
                                  comment=" 2D 5-point Laplacian, 100x100 grid")
    runs = "; ".join(
        f"{sys.executable} -m cgx_torch.cli.main {' '.join(cli_method_argv(tmp, m, 'cpu'))} "
        f"> {tmp / (m + '_cpu.out')}" for m in CLI_METHODS)
    env = dict(os.environ, OMP_NUM_THREADS=str(REPLAY_THREADS),
               PYTHONPATH=os.pathsep.join(filter(None, [str(Path(__file__).resolve().parent),
                                                        os.environ.get("PYTHONPATH")])))
    return subprocess.Popen(["bash", "-c", f"set -e; {runs}"], env=env, start_new_session=True)


def phase_cli_methods(spec, tmp: Path, replay: subprocess.Popen) -> None:
    """The CLI's --method gvpipe and --method chebyshev on the reference's
    run, lap2D_5pt_n100.mtx 1024 16 true (fp64 through the dense kernel),
    in this process, against the CPU replay of the same argv
    (start_cli_replay): the [STEP k] line (Chebyshev's k equal, gvpipe's
    within 3, the golden window's width, since the kernel sums in its own
    order), the true residual below 1e-11 on both, ||x|| within 1e-9, and
    the CSV rows' fields."""
    card = {m: cli_run(cli_method_argv(tmp, m)) for m in CLI_METHODS}
    t0 = time.perf_counter()
    rc = replay.wait(timeout=900)
    wait_seconds = time.perf_counter() - t0
    check(rc == 0, f"the CLI's CPU replay exited with {rc}")
    for method in CLI_METHODS:
        run, m, launches = card[method]
        m_cpu = STEP.search((tmp / f"{method}_cpu.out").read_text())
        row_cpu = (tmp / f"{method}_cpu.txt").read_text().splitlines()[0].split(",")
        check(m_cpu is not None, f"cli {method}: no [STEP k] line in the CPU replay")
        k, k_cpu = int(m.group(1)), int(m_cpu.group(1))
        row = run.csv_row.split(",")
        x_norm, x_cpu = float(m.group(3)), float(m_cpu.group(3))
        rec = {"phase": "cli_method", "method": method, "argv": cli_method_argv(tmp, method)[5:],
               "k": k, "k_cpu": k_cpu, "step_line": m.group(0), "step_line_cpu": m_cpu.group(0),
               "csv_row": run.csv_row, "csv_row_cpu": ",".join(row_cpu),
               "seconds": run.seconds, "replay_wait_seconds": wait_seconds,
               "converged": bool(run.result.converged), "true_rel": float(m.group(4)),
               "true_rel_cpu": float(m_cpu.group(4)), "dense_launches": launches["dense_matvec"]}
        emit(rec)
        where = f"cli --method {method}"
        check(rec["converged"], f"{where}: did not converge")
        check(k == k_cpu if method == "chebyshev" else abs(k - k_cpu) <= 3,
              f"{where}: k={k}, the CPU replay's {k_cpu}")
        check(rec["true_rel"] < 1e-11 and rec["true_rel_cpu"] < 1e-11,
              f"{where}: true residuals {rec['true_rel']}, {rec['true_rel_cpu']}")
        check(abs(x_norm - x_cpu) <= 1e-9 * x_cpu, f"{where}: ||x|| {x_norm}, the CPU's {x_cpu}")
        check(row[:2] == row_cpu[:2] == ["1024", "16"] and float(row[2]) > 0
              and float(row_cpu[2]) > 0, f"{where}: CSV rows {row}, {row_cpu}")
        check(launches["dense_matvec"] >= k, f"{where} missed the kernel: {launches}")


# ---- bfloat16 vectors (ROADMAP A6, first part) ----


def bf16_seeded(n: int, count: int):
    rng = np.random.default_rng(SEED)
    return [torch.as_tensor(rng.standard_normal(n), dtype=BF16, device=DEV) for _ in range(count)]


def bf16_bound(spec, nbytes: float, flops: float, f32: float = 0, f64: float = 0):
    """The least time of bfloat16-vector work: its bytes, and its
    operations: ``flops`` each rounded to bfloat16 (a product or sum of two
    bfloat16 values rounded once is the float-then-round result, so at the
    card's bfloat16 rate), ``f32`` kept in float (products of two bfloat16
    values, exact in float; B3's row sums), ``f64`` the dots' sums."""
    return bound_mixed(spec, nbytes, {BF16: flops, torch.float32: f32, torch.float64: f64})


def stream_bf16_bound(spec, ndiag: int, n: int, precond: bool):
    """bf16_bound of a streaming iteration on bfloat16 vectors and bands:
    stream_flops, of which the dots (2, with the preconditioner 3) take
    products exact in float and sums in float64."""
    dots = (3 if precond else 2) * n
    return bf16_bound(spec, stream_bytes(ndiag, n, 2, 2, precond),
                      stream_flops(ndiag, n, precond) - 2 * dots, f32=dots, f64=dots)


def bf16_row(rec: dict, **extra) -> dict:
    return {"max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "dtype": str(BF16), **extra}


def bf16_library(fn):
    """(ms, None) of a PyTorch call on bfloat16 inputs, or (None, its error)
    where PyTorch has no bfloat16 form of it."""
    try:
        fn()
        sync()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e)[:120]}"
    return time_ms(fn), None


def phase_bf16_kernels(spec) -> dict:
    """Each bfloat16-vector build against its plain version on the same
    seeded inputs, bit for bit (vectors, and the scalars but the float64
    dots' sums, whose order differs): B1's dia_matvec in both designs at
    N = 1e6 and 10,240,000; B5 in both designs at N = 1e6, with and without
    the Neumann preconditioner, one iteration and one 64-iteration chunk;
    B4, B7 and B6 in both designs at N = 10,240,000, one launch and
    STREAM_ITERS; B3's two entries at the three dense shapes of the dense
    phase. Then each one's median ms against its bound at 2-byte words, its
    plain version's ms and a PyTorch call's where one computes the same
    function on bfloat16. Returns the records of the kernels line's bf16
    rows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    # B1
    for g in (RESIDENT_GRID, GRID):
        dia = lap2d_fd(g)
        n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
        bands = torch.as_tensor(dia.bands, dtype=BF16, device=DEV)
        x, = bf16_seeded(n, 1)
        ref = dia_spmv.dia_matvec_ref(bands, x, offsets=offsets)
        designs = {"stream": dia_spmv.MatvecPlan("stream",
                                                 dia_spmv.stream_plan(n, offsets, BF16, sms)),
                   "grid": dia_spmv.GRID_PLAN}
        rec = {"phase": "bf16_kernel", "kernel": "dia_matvec", "problem": f"lap2d_fd({g})",
               "n": n, "dtype": "bfloat16",
               "picked": dia_spmv.matvec_plan(n, offsets, BF16, sms).design}
        for d, plan in designs.items():
            y = dia_spmv.dia_matvec(bands, x, offsets=offsets, plan=plan)
            sync()
            rec[f"{d}_bitwise"] = torch.equal(y, ref)
            rec[f"{d}_max_abs_err"] = float((y.float() - ref.float()).abs().max())
            rec[f"{d}_ms"] = time_ms(lambda: dia_spmv.dia_matvec(bands, x, offsets=offsets,
                                                                 plan=plan))
        rec["plain_ms"] = time_ms(lambda: dia_spmv.dia_matvec_ref(bands, x, offsets=offsets))
        rec["library_ms"], rec["library_error"] = bf16_library(
            lambda: torch.mv(csr_of(bands, offsets), x))
        rec["bound_ms"], rec["bound_by"] = bf16_bound(spec, (ndiag + 2) * n * 2, 2 * ndiag * n)
        rec["max_abs_err"] = rec[f"{rec['picked']}_max_abs_err"]
        rec["ms"] = rec[f"{rec['picked']}_ms"]
        emit(rec)
        check(rec["stream_bitwise"] and rec["grid_bitwise"],
              f"B1 bf16 lap2d_fd({g}): not bitwise its plain version: {rec}")
        if g == RESIDENT_GRID:  # the shape of B5's Neumann set-up, the path that runs it
            records["dia_matvec_bf16"] = bf16_row(rec, design=rec["picked"],
                                                  grid_ms=rec["grid_ms"], n=n)
        del bands, x, ref
        sync()
    # B5
    dia = lap2d_fd(RESIDENT_GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    bands = torch.as_tensor(dia.bands, dtype=BF16, device=DEV)
    p, x, r = bf16_seeded(n, 3)
    zero = torch.zeros((), dtype=torch.float64, device=DEV)
    state = [p, x, r, torch.stack([torch.sum(r.double() ** 2), zero, zero, zero])]
    b5 = {}
    for precond in (False, True):
        rec = {"phase": "bf16_kernel", "kernel": "dia_cg_chunk", "problem":
               f"lap2d_fd({RESIDENT_GRID})", "n": n, "dtype": "bfloat16", "precond": precond}
        for design in ("resident", "global"):
            plan = chunk_plan(design, n, offsets, BF16, BF16, precond)
            for chunk in (1, CHUNK):
                got, ref = [t.clone() for t in state], [t.clone() for t in state]
                chunk_call(cg_kernel.dia_cg_chunk, bands, got, offsets, chunk, precond,
                           plan=plan)
                chunk_call(cg_kernel.dia_cg_chunk_ref, bands, ref, offsets, chunk, precond)
                sync()
                key = f"{design}_x{chunk}"
                rec[f"{key}_bitwise"] = all(torch.equal(a, w) for a, w in zip(got[:3], ref[:3]))
                rec[f"{key}_max_abs_err"] = max(float((a.float() - w.float()).abs().max())
                                                for a, w in zip(got[:3], ref[:3]))
                rec[f"{key}_rsold_rel_err"] = rel_err(got[3][0], ref[3][0], ref[3][0].abs())
                check(cg_kernel.dia_cg_chunk.plan.design == design and rec[f"{key}_bitwise"]
                      and torch.equal(got[3][1:], ref[3][1:])
                      and rec[f"{key}_rsold_rel_err"] <= DOT_RTOL[torch.float64],
                      f"B5 bf16 {design} precond={precond} x{chunk}: {rec}")
            rec[f"{design}_ms"] = time_ms(lambda: chunk_call(
                cg_kernel.dia_cg_chunk, bands, state, offsets, CHUNK, precond, plan=plan),
                reps=10, burst=2)
        rec["plain_ms"] = time_ms(lambda: chunk_call(cg_kernel.dia_cg_chunk_ref, bands, state,
                                                     offsets, CHUNK, precond), reps=3, burst=1)
        rec["bound_ms"], rec["bound_by"] = resident_bound(spec, ndiag, n, 2, precond, CHUNK,
                                                          vec_bytes=2)
        rec.update(ms=rec["resident_ms"], max_abs_err=rec["resident_x1_max_abs_err"],
                   library_ms=None)  # no one PyTorch call runs a CG chunk
        emit(rec)
        b5[precond] = rec
    for name in ("dia_cg_vmem_bf16", "dia_cg_vmem2d_bf16"):  # one kernel and its numbers
        records[name] = bf16_row(b5[False], design="resident", global_ms=b5[False]["global_ms"],
                                 pcg_ms=b5[True]["ms"], pcg_global_ms=b5[True]["global_ms"],
                                 pcg_bound_ms=b5[True]["bound_ms"], n=n)
    del bands, p, x, r, state
    sync()
    # B4, B7, B6
    dia = lap2d_fd(GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    kw = dict(offsets=offsets, tol=0.0, nearzero=1e-14, maxiter=10**9)
    for site, precond, stacked in (("stream_iteration", False, False),
                                   ("stream_iteration_stacked", False, True),
                                   ("stream_iteration_pcg", True, False)):
        bands, st = stream_state(dia, BF16, precond, stacked)
        # each timed launch starts from the seeded scalars, so it is an active one: the
        # bfloat16 recurrence leaves the finite range within a few hundred launches, and a
        # frozen launch returns at once (the 64-byte copy is in the times)
        scal0 = st.scal.clone()
        plans = stream_designs(n, offsets, BF16, precond)
        rec = {"phase": "bf16_kernel", "kernel": site, "problem": f"lap2d_fd({GRID})", "n": n,
               "dtype": "bfloat16"}
        for plan in plans:
            design = plan.design
            for launches in (1, STREAM_ITERS):
                got, ref = clone_state(st), clone_state(st)
                for _ in range(launches):
                    cg_stream.step(bands, got, plan=plan, **kw)
                    cg_stream._iteration_ref(bands, *ref[:6], ref.scal, **kw)
                sync()
                pairs = [(a, w) for a, w in zip(got[:6], ref[:6]) if a is not None]
                key = f"{design}_x{launches}"
                rec[f"{key}_bitwise"] = all(torch.equal(a, w) for a, w in pairs)
                rec[f"{key}_max_abs_err"] = max(float((a.float() - w.float()).abs().max())
                                                for a, w in pairs)
                rec[f"{key}_dot_rel_err"] = float(((got.scal[:3] - ref.scal[:3]).abs()
                                                  / ref.scal[:3].abs()).max())
                check(rec[f"{key}_bitwise"] and torch.equal(got.scal[cg_stream.K:],
                                                            ref.scal[cg_stream.K:])
                      and rec[f"{key}_dot_rel_err"] <= DOT_RTOL[torch.float64],
                      f"{site} bf16 {design} x{launches}: {rec}")
                del got, ref
            work = cg_stream.workspace(DEV, n)
            call = stream_call(bands, st, plan, kw, work, scal0)
            rec[f"{design}_ms"] = time_ms(call)
            rec[f"{design}_device_ms"] = device_ms(call, STREAM_KERNELS)
            del work, call
        rec["plain_ms"] = time_ms(lambda: (st.scal.copy_(scal0), cg_stream._iteration_ref(
            bands, *st[:6], st.scal, **kw)), reps=3, burst=1)
        rec["bound_ms"], rec["bound_by"] = stream_bf16_bound(spec, ndiag, n, precond)
        first, other = plans[0].design, "three" if precond else "grid"
        rec.update(ms=rec[f"{first}_ms"], max_abs_err=rec[f"{first}_x1_max_abs_err"],
                   device_ms=rec[f"{first}_device_ms"],
                   library_ms=None)  # no one PyTorch call runs a CG iteration
        emit(rec)
        if not precond and first == "wavefront":
            check(rec["wavefront_ms"] <= REDESIGN_SLACK * rec["grid_ms"],
                  f"{site} bf16: the wavefront is slower than the grid design: {rec}")
        records[f"{site}_bf16"] = bf16_row(rec, design=first, n=n, device_ms=rec["device_ms"],
                                           **{f"{other}_ms": rec.get(f"{other}_ms"),
                                              f"{other}_device_ms": rec.get(f"{other}_device_ms")})
        del bands, st
        sync()
    # B3, on dense_plan's plan and with its spans forced onto whole warps (the design before)
    for problem, make, (br, bc) in DENSE_PROBLEMS:
        a = densify_on_device(as_operator(make(), BF16, device=DEV)).a
        n = a.shape[0]
        x, = bf16_seeded(n, 1)
        plan = matvec._plan_of(a, x, bc)
        warp = plan._replace(lanes=32)
        recs = {}
        for name, fn, plain in (
                ("dense_matvec", matvec.dense_matvec,
                 lambda: matvec.dense_matvec_ref(a, x, block_rows=br, block_cols=bc)),
                ("dense_matvec_dot", matvec.dense_matvec_dot,
                 lambda: matvec.dense_matvec_dot_ref(a, x, block_rows=br, block_cols=bc))):
            def kern(p=None):
                return fn(a, x, block_rows=br, block_cols=bc, plan=p)

            got = kern()
            ran = fn.plan
            ref, old = plain(), kern(warp)
            sync()
            y, y_ref, y_old = ((got, ref, old) if name == "dense_matvec"
                               else (got[0], ref[0], old[0]))
            rec = {"phase": "bf16_kernel", "kernel": name, "problem": f"{problem} dense {br}x{bc}",
                   "n": n, "dtype": "bfloat16", "bitwise": torch.equal(y, y_ref),
                   "warp_bitwise": torch.equal(y_old, y_ref),
                   "max_abs_err": float((y.float() - y_ref.float()).abs().max()),
                   "plan": plan._asdict()}
            check(ran == plan, f"{name} bf16 {problem}: ran {ran}, not {plan}")
            if name == "dense_matvec_dot":  # float32 sums in two orders
                scale = float((x.float() * y_ref.float()).abs().sum())
                rec["dot_rel_err"] = abs(float(got[1]) - float(ref[1])) / scale
                rec["y_bitwise_dense_matvec"] = torch.equal(y, recs["dense_matvec"]["y"])
                check(rec["dot_rel_err"] <= DOT_RTOL[torch.float32]
                      and rec["y_bitwise_dense_matvec"], f"{name} bf16 {problem}: {rec}")
            check(rec["bitwise"] and rec["warp_bitwise"],
                  f"{name} bf16 {problem}: y is not bitwise its plain version: {rec}")
            rec["ms"] = time_ms(kern)
            rec["device_ms"] = device_ms(kern, ("dense_matvec",))
            if plan.lanes != 32:
                rec["warp_ms"] = time_ms(lambda: kern(warp))
                rec["warp_device_ms"] = device_ms(lambda: kern(warp), ("dense_matvec",))
            rec["plain_ms"] = time_ms(plain)
            rec["library_ms"], rec["library_error"] = (
                bf16_library(lambda: torch.mv(a, x)) if name == "dense_matvec" else (None, None))
            if rec["library_ms"] is not None:
                rec["library_device_ms"] = device_ms(lambda: torch.mv(a, x), ("",))
            dot = name == "dense_matvec_dot"  # its products rounded to bfloat16, float sums
            rec["bound_ms"], rec["bound_by"] = bf16_bound(spec, (n * n + 2 * n) * 2, n * dot,
                                                          f32=2 * n * n + n * dot)
            emit(rec)
            recs[name] = {**rec, "y": y}
            if problem == "lap2d_fd(100)":  # the CLI's shape and tiles
                records[f"{name}_bf16"] = bf16_row(
                    rec, n=n, tiles=[br, bc], design=f"{plan.lanes} lanes a span",
                    device_ms=rec["device_ms"], warp_ms=rec.get("warp_ms"),
                    warp_device_ms=rec.get("warp_device_ms"),
                    library_device_ms=rec.get("library_device_ms"))
        del a, x, recs
        sync()
    return records


def phase_bf16_main(spec) -> dict:
    """solve(lap2d_fd(3200), source_term(N), bf16, use_pallas, 5e-2 ||b||,
    maxiter BF16_MAXITER) above the budget: B4 on bfloat16 vectors and
    bands, one launch an iteration; and with precond="neumann", B6 in
    pcg_plan's design. The yardstick is the plain bfloat16 pipelined loop
    (with the Neumann preconditioner) with float64 dots: the same verdict,
    and k within 2% of its k or, where its recursive residual leaves the
    finite range (bfloat16 Chronopoulos-Gear does at this size, in cgx
    too), of the iteration where it does; the kernel's stop flag ends the
    solve there, and the plain loop, which runs on to its maxiter, is run
    only to 64 iterations past it. Then the bitwise repeat on REPEAT_ITERS
    capped iterations, us an iteration against the bound at 2-byte words,
    the idle share, and the stacked layout (B7) through
    dia_cg_solve_stream, bitwise the split solve. Returns the launch counts
    of the three sites."""
    dia = lap2d_fd(GRID)
    n, ndiag = dia.shape[0], len(dia.offsets)
    b = source_term(n)
    tol = BF16_TOL * float(np.linalg.norm(b))
    op = as_operator(dia, BF16, device=DEV)
    b_dev = torch.as_tensor(b, dtype=BF16, device=DEV)
    check(cg_kernel.resident_state_bytes(ndiag, n, 2, 2) > config.RESIDENT_BUDGET_BYTES,
          f"N = {n} in bf16 is within the resident budget: the path would not stream")
    counts = {}
    for precond, site in ((None, "stream_iteration_bf16"),
                          ("neumann", "stream_iteration_pcg_bf16")):
        cfg = SolveConfig(precision="bf16", use_pallas=True, tolerance=tol, maxiter=BF16_MAXITER,
                          precond=precond)
        capped = dataclasses.replace(cfg, tolerance=0.0, maxiter=REPEAT_ITERS)
        res, k, seconds, launches, bitwise = solve_capped_repeat(
            lambda: solve(op, b_dev, cfg, device=DEV), lambda: solve(op, b_dev, capped, device=DEV))
        finite = bool(torch.isfinite(res.x).all())
        limit = BF16_MAXITER if finite or bool(res.converged) else min(BF16_MAXITER, k + 64)
        pc = None if precond is None else neumann_banded(op.bands, op.offsets, sweeps=2)
        plain, k_run, plain_seconds = timed(lambda: pipelined_cg_solve(
            op, b_dev, tol=tol, maxiter=limit, history=limit, precond=pc,
            dot_precision=torch.float64, device=DEV))
        bad = torch.nonzero(~torch.isfinite(plain.history[:k_run])).flatten()
        k_break = None if bad.numel() == 0 else int(bad[0]) + 1
        k_plain = k_run if k_break is None else k_break
        # the capped run stops early where the recursion leaves the finite range
        k_capped = int(solve(op, b_dev, capped, device=DEV).iterations)
        prof = profile_record(lambda: solve(op, b_dev, capped, device=DEV), k_capped)
        bound, bound_by = stream_bf16_bound(spec, ndiag, n, precond is not None)
        plan = (None if precond is None else
                cg_stream.pcg_plan(n, tuple(dia.offsets), BF16, dia_powers.sms_of(DEV)))
        per_iter = 1 if plan is None else plan.launches
        rec = {"phase": "bf16_main", "problem": f"lap2d_fd({GRID})", "n": n, "dtype": "bfloat16",
               "precond": precond, "tol": tol, "tol_rel": BF16_TOL, "maxiter": BF16_MAXITER,
               "k": k, "converged": bool(res.converged), "capped": k >= BF16_MAXITER,
               "x_finite": finite, "bitwise_repeat_capped": bitwise,
               "repeat_iterations": REPEAT_ITERS, "capped_iterations": k_capped,
               "seconds": seconds,
               "us_per_iter": seconds / k * 1e6, "bound_us_per_iter": bound * 1e3,
               "bound_by": bound_by,
               "bands_dtype": str(STREAM_SITES[site.removesuffix("_bf16")].bands_dtype),
               "launches": launches, "design": None if plan is None else plan.design,
               "k_plain": k_plain, "plain_iterations_run": k_run,
               "plain_residual_nonfinite_at": k_break, "converged_plain": bool(plain.converged),
               "plain_seconds": plain_seconds, "plain_us_per_iter": plain_seconds / k_run * 1e6,
               "x_dtype": str(res.x.dtype), **prof}
        emit(rec)
        others = {name: c for name, c in launches.items()  # the site's all-dtype count too
                  if name not in (site, site.removesuffix("_bf16")) and name in KERNELS and c}
        check(launches[site] == per_iter * 32 * -(-k // 32) and not others,
              f"bf16 main {precond}: {launches} at k={k}")
        check(res.x.dtype == BF16 and res.x.shape == (n,) and finite == (k_break is None),
              f"bf16 main {precond}: x {res.x.dtype}, finite {finite}, the plain loop's residual "
              f"non-finite at {k_break}")
        check(bool(res.converged) == bool(plain.converged) and abs(k - k_plain) <= 0.02 * k_plain,
              f"bf16 main {precond}: k={k} ({bool(res.converged)}) vs the plain loop's "
              f"{k_plain} ({bool(plain.converged)})")
        check(bitwise, f"bf16 main {precond}: two capped runs differ")
        counts[site] = launches[site]
        if precond is None:
            reset_launches()
            stacked, k_st, _ = timed(lambda: dia_cg_solve_stream(
                op, b_dev, tol=tol, maxiter=BF16_MAXITER, layout="stacked", device=DEV))
            counts["stream_iteration_stacked_bf16"] = read_launches()[
                "stream_iteration_stacked_bf16"]
            same = k_st == k and same_x(stacked, res)
            emit({"phase": "bf16_main_stacked", "k": k_st, "bitwise_equal_to_split": same,
                  "launches": counts["stream_iteration_stacked_bf16"]})
            check(same and counts["stream_iteration_stacked_bf16"] >= k,
                  f"bf16 stacked layout: k={k_st}, bitwise equal to split: {same}")
        del res, plain
        sync()
    return counts


def phase_bf16_resident(spec) -> dict:
    """solve(lap2d_fd(1000), bf16, use_pallas, 5e-2 ||b||) within the budget:
    B5 on bfloat16 vectors in resident_plan's design, without and with the
    Neumann preconditioner (whose set-up runs B1's dia_matvec on bfloat16),
    twice each (bitwise), against the plain reference (P)CG loop with
    float64 dots (k within 2%, the same verdict); and one direct call with
    layout="1d" (bitwise the "2d" solve). Returns the launch counts."""
    dia = lap2d_fd(RESIDENT_GRID)
    n, ndiag = dia.shape[0], len(dia.offsets)
    b = source_term(n)
    tol = BF16_TOL * float(np.linalg.norm(b))
    op = as_operator(dia, BF16, device=DEV)
    b_dev = torch.as_tensor(b, dtype=BF16, device=DEV)
    counts = {}
    for precond in (None, "neumann"):
        state = cg_kernel.resident_state_bytes(ndiag, n, 2, 2, precond=precond is not None)
        check(state <= config.RESIDENT_BUDGET_BYTES,
              f"bf16 resident: {state} state bytes above the budget")
        cfg = SolveConfig(precision="bf16", use_pallas=True, tolerance=tol, precond=precond)
        res, k, seconds, launches, bitwise = solve_twice(lambda: solve(op, b_dev, cfg, device=DEV))
        pc = None if precond is None else neumann_banded(op.bands, op.offsets, sweeps=2)
        plain, k_plain, plain_seconds = timed(lambda: cg_solve(
            op, b_dev, tol=tol, precond=pc, dot_precision=torch.float64, device=DEV))
        chunks = -(-(k + 1) // CHUNK)
        bound, bound_by = resident_bound(spec, ndiag, n, 2, precond is not None, k + 1,
                                         max(1, launches["dia_cg_vmem2d_bf16"]), vec_bytes=2)
        rec = {"phase": "bf16_resident", "problem": f"lap2d_fd({RESIDENT_GRID})", "n": n,
               "dtype": "bfloat16", "precond": precond, "tol": tol, "k": k,
               "converged": bool(res.converged), "bitwise_repeat": bitwise, "seconds": seconds,
               "us_per_iter": seconds / (k + 1) * 1e6, "bound_us_per_iter": bound / (k + 1) * 1e3,
               "bound_by": bound_by, "design": cg_kernel.dia_cg_chunk.plan.design,
               "launches": launches, "k_plain": k_plain, "converged_plain": bool(plain.converged),
               "plain_seconds": plain_seconds, "x_dtype": str(res.x.dtype),
               "x_finite": bool(torch.isfinite(res.x).all()), "state_bytes": state}
        emit(rec)
        others = {name: c for name, c in launches.items()  # B1 forms the PCG's z0
                  if name not in ("dia_cg_vmem2d_bf16", "dia_matvec_bf16", "dia_matvec")
                  and name in KERNELS and c}
        check(launches["dia_cg_vmem2d_bf16"] >= chunks and not others
              and launches["dia_matvec_bf16"] == (precond is not None),
              f"bf16 resident {precond}: {launches} at k={k}")
        check(rec["design"] == "resident" and bitwise and rec["x_finite"]
              and res.x.dtype == BF16, f"bf16 resident {precond}: {rec}")
        check(bool(res.converged) == bool(plain.converged) and abs(k - k_plain) <= 0.02 * k_plain,
              f"bf16 resident {precond}: k={k} vs the plain loop's {k_plain}")
        if precond is None:
            counts["dia_cg_vmem2d_bf16"] = launches["dia_cg_vmem2d_bf16"]
            reset_launches()
            res1, k1, _ = timed(lambda: dia_cg_solve_vmem(op, b_dev, tol=tol, layout="1d",
                                                          device=DEV))
            counts["dia_cg_vmem_bf16"] = read_launches()["dia_cg_vmem_bf16"]
            same = k1 == k and same_x(res1, res)
            emit({"phase": "bf16_resident_1d", "k": k1, "bitwise_equal_to_2d": same,
                  "launches": counts["dia_cg_vmem_bf16"]})
            check(same and counts["dia_cg_vmem_bf16"] >= chunks,
                  f"bf16 layout='1d': k={k1}, bitwise equal to 2d: {same}")
        else:
            counts["dia_matvec_bf16"] = launches["dia_matvec_bf16"]
    return counts


def phase_bf16_cli(spec, tmp: Path) -> dict:
    """The CUDA grammar on lap2D_5pt_n100.mtx with `true` and --precision
    bf16 at 5e-2 ||b||: B3's bfloat16 build on every iteration, float32
    dots (cgx's CLI from a shell); against the plain bfloat16 dense loop
    with float32 dots (k within 2%, the same verdict); the [STEP k] line
    and the CSV row. Returns its launch counts."""
    mtx = tmp / "lap2D_5pt_n100.mtx"  # written by phase_cli_reference
    dia = lap2d_fd(100)
    b = source_term(dia.shape[0])
    tol = BF16_TOL * float(np.linalg.norm(b))
    out = tmp / "bf16.txt"
    run, m, launches = cli_run([str(mtx), "1024", "16", "true", str(out), "--precision", "bf16",
                                "--tol", repr(tol)])
    rec = cli_record(spec, "bf16_cli", run, m, launches, dia.shape[0], BF16)
    rec["body_iterations"] = launches["dense_matvec_bf16"] - 1
    rec["us_per_iter"] = run.seconds / rec["body_iterations"] * 1e6
    sync()
    t0 = time.perf_counter()
    plain = cg_solve(DenseOperator(run.op.a), torch.as_tensor(b, dtype=BF16, device=DEV),
                     tol=tol, dot_precision=torch.float32, device=DEV)
    k_plain = int(plain.iterations)
    row = out.read_text().splitlines()[0].split(",")
    rec.update(tol=tol, k_plain=k_plain, converged_plain=bool(plain.converged),
               plain_seconds=time.perf_counter() - t0, x_dtype=str(run.result.x.dtype),
               csv=row)
    emit(rec)
    k = rec["k"]
    check(rec["converged"] == bool(plain.converged) and abs(k - k_plain) <= 0.02 * k_plain,
          f"bf16 CLI: k={k} vs the plain loop's {k_plain}")
    check(run.result.x.dtype == BF16 and bool(torch.isfinite(run.result.x).all()),
          f"bf16 CLI: x is {run.result.x.dtype}")
    check(row[:2] == ["1024", "16"] and float(row[2]) > 0, f"bf16 CLI: CSV row {row}")
    check(launches["dense_matvec_bf16"] >= k + 1 and launches["dense_matvec"] == 0,
          f"bf16 CLI missed the bf16 kernel: {launches}")
    return {"dense_matvec_bf16": launches["dense_matvec_bf16"],
            "dense_matvec_dot_bf16": launches["dense_matvec_dot_bf16"]}


def phase_bf16_mesh(mesh) -> None:
    """solve(lap2d_fd(256), precision="bf16", mesh=) on the NCCL group: a
    float32 x, bitwise the fp32 request's (cgx solves a bf16 request's b
    in float32 on the mesh, api.py:233-234); solve_sequence likewise."""
    dia = lap2d_fd(BF16_MESH_GRID)
    b = source_term(dia.shape[0])
    tol = BF16_TOL * float(np.linalg.norm(b))
    runs = {}
    for precision in ("bf16", "fp32"):
        cfg = SolveConfig(precision=precision, tolerance=tol)
        res, k, seconds = timed(lambda: solve(dia, b, cfg, mesh=mesh, device=DEV))
        seq = solve_sequence(dia, [b, np.roll(b, BF16_MESH_GRID)], cfg, k=4, mesh=mesh,
                             device=DEV)
        runs[precision] = (res, k, seconds, seq)
    (res, k, seconds, seq), (res32, k32, _, seq32) = runs["bf16"], runs["fp32"]
    same = same_x(res, res32) and all(same_x(a, c) for a, c in zip(seq, seq32))
    emit({"phase": "bf16_mesh", "problem": f"lap2d_fd({BF16_MESH_GRID})", "k": k, "k_fp32": k32,
          "x_dtype": str(res.x.dtype), "seconds": seconds,
          "sequence_k": [int(r.iterations) for r in seq], "bitwise_fp32": same})
    check(res.x.dtype == torch.float32 and bool(res.converged) and k == k32 and same,
          f"bf16 mesh: x {res.x.dtype}, k {k} vs fp32 {k32}, bitwise {same}")


# ---- ROADMAP A6's rest: bfloat16 vectors through the fused s-step, float16 bands ----


def sstep_row(rec: dict, err: float, **extra) -> dict:
    """A kernels-line row from an sstep_times record and its check's error."""
    return {"max_abs_err": err, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,  # no one PyTorch call builds a Krylov basis
            "design": rec.get("design"), "slab_ms": rec.get("slab_ms"), "n": rec["n"], **extra}


def phase_bf16_sstep_kernels(spec, bounds) -> tuple:
    """The s-step kernels' bfloat16-vector builds against their plain
    versions on lap2d_fd(GRID) from seeded p, r and x (sstep_checks,
    Chebyshev and Newton): B9's basis, and B10's recovered x, r and p,
    bitwise, G within GRAM_RTOL of sum |v_i v_j|, each in basis_plan's
    design (the wavefront) and the slab design forced; then each one's ms
    against its bound at 2-byte words, the plain version's ms and the slab
    design's ms. No route of solve runs B9 on bfloat16 (the "pallas" loop
    refuses it, as cgx's does), so its row's launches are one call of
    cgx's entry, dia_sstep_basis. Returns the rows and that count."""
    dia = lap2d_fd(GRID)
    op = as_operator(dia, torch.float32, device=DEV)
    shifts = newton_shifts(op, dia.shape[0], SSTEP_S, bounds)
    del op
    errs = {}
    for basis, sh in (("chebyshev", ()), ("newton", shifts)):
        e = sstep_checks("bf16", basis, dia, sstep_kw(dia, bounds, sh))
        errs = errs or e
        sync()
    recs = sstep_times(spec, "bf16", dia, sstep_kw(dia, bounds))
    rows = {f"{site}_bf16": sstep_row(recs[site], errs[site], dtype=str(BF16))
            for site in ("dia_sstep_basis_planes", "sstep_gram", "sstep_recover")}
    bands, _, p, r = sstep_inputs("bf16", dia)
    reset_launches()
    dia_powers.dia_sstep_basis(bands, p, r, **sstep_kw(dia, bounds))
    sync()
    count = read_launches()["dia_sstep_basis_planes_bf16"]
    check(count == 1 and dia_powers.dia_sstep_basis_planes.design == "wavefront",
          f"B9 bf16 through dia_sstep_basis: {count} launches, "
          f"{dia_powers.dia_sstep_basis_planes.design}")
    return rows, {"dia_sstep_basis_planes_bf16": count}


def plain_fused_solve(bands, offsets, b, bounds, tol: float, maxiter: int):
    """dia_sstep_stream_solve from x0 = 0 (Chebyshev, s = SSTEP_S) with
    each launch replaced by its plain version on the card, chained as
    _sstep_stream_loop chains the launches (a block after the stop
    changes nothing, so one a host read): the yardstick of the fused
    route's k, flags and x. Returns (k, converged, breakdown, x)."""
    lmin, lmax = bounds
    kw = dict(offsets=tuple(offsets), s=SSTEP_S, theta=(lmax + lmin) / 2.0,
              delta=(lmax - lmin) / 2.0, shifts=())
    x0 = torch.zeros_like(b)
    down, up = (float(v) for v in pow2_rhs_scale(b, x0))
    st = ss.initial_state(bands.to(b.dtype), b * down, x0, tol * down, **kw)
    nearzero = SolveConfig().nearzero
    while not ss._stopped(st.state[:ss.COEF].tolist(), maxiter):
        ss._gram_ref(bands, st.p, st.r, st.state, st.bmat, tol=tol * down, nearzero=nearzero,
                     maxiter=maxiter, **kw)
        ss._recover_ref(bands, st.p, st.r, st.x, st.state, **kw)
    h = st.state[:ss.COEF].tolist()
    return int(h[ss.K]), h[ss.CONV] != 0.0, h[ss.BRK] != 0.0, st.x * up


def fused_nonfinite_at(op, b, bounds, tol: float, maxiter: int):
    """The kernel chain of dia_sstep_stream_solve from x0 = 0 (Chebyshev,
    s = SSTEP_S), its state read every 8 blocks as the solve reads it:
    the k of the first read at which the recursive residual (the state's
    rsnew) or the x the solve would return is not finite, or None where
    the solve stops first. The replay has no stop on either (cgx's
    neither), so a bfloat16 solve that leaves the finite range runs on to
    maxiter."""
    lmin, lmax = bounds
    kw = dict(offsets=tuple(op.offsets), s=SSTEP_S, theta=(lmax + lmin) / 2.0,
              delta=(lmax - lmin) / 2.0, shifts=())
    x0 = torch.zeros_like(b)
    down, up = (float(v) for v in pow2_rhs_scale(b, x0))
    st = ss.initial_state(op.bands, b * down, x0, tol * down, **kw)
    work = ss.workspace(DEV, b.shape[0], kw["offsets"], SSTEP_S, b.dtype)
    nearzero = SolveConfig().nearzero
    while True:
        h = st.state[:ss.COEF].tolist()
        if not (math.isfinite(h[ss.RSNEW]) and bool(torch.isfinite(st.x * up).all())):
            return int(h[ss.K])
        if ss._stopped(h, maxiter):
            return None
        for _ in range(8):
            ss.block(op.bands, st, tol=tol * down, nearzero=nearzero, maxiter=maxiter, work=work,
                     **kw)


def fused_matches_plain(res, plain) -> bool:
    """A fused solve's k, flags and x against plain_fused_solve's, bit for bit."""
    k, conv, brk, x = plain
    return (int(res.iterations) == k and bool(res.converged) == conv
            and bool(res.breakdown) == brk and same_bits(res.x, x))


def phase_bf16_sstep(spec) -> dict:
    """solve(lap2d_fd(GRID), source_term(N), bf16, method="sstep", 5e-2
    ||b||, maxiter BF16_MAXITER): "auto" resolves to the fused kernels'
    bfloat16 builds (B10's Gram and recover, in basis_plan's wavefront).
    On REPEAT_ITERS capped iterations: two runs bitwise, and k, the flags
    and x bitwise the chained plain versions' on the card
    (plain_fused_solve, on the bounds solve estimates: spectral_bounds of
    the same operator). Then the run to its stop, reported as it ends: k,
    us an iteration against the bound at 2-byte words, and the stop
    (converged; or a replay breakdown, then the fallback on B4's bfloat16
    build; or maxiter, BF16_SSTEP_MAXITER at this size). Where the
    recursion or x leaves the finite range (fused_nonfinite_at) the
    replay runs on to maxiter on non-finite values, so the run is cut 64
    iterations past the first non-finite read, as bf16_main cuts its plain
    loop. Then
    lap2d_fd(RESIDENT_GRID) (N = 1e6) to convergence, twice (bitwise), k,
    the flags and x bitwise the chained plain versions'. Returns the fused
    route's launches by build on the full-size run."""
    counts = {}
    for g, full in ((GRID, True), (RESIDENT_GRID, False)):
        dia = lap2d_fd(g)
        n, ndiag = dia.shape[0], len(dia.offsets)
        b = source_term(n)
        tol = BF16_TOL * float(np.linalg.norm(b))
        op = as_operator(dia, BF16, device=DEV)
        b_dev = torch.as_tensor(b, dtype=BF16, device=DEV)
        sync()
        t0 = time.perf_counter()
        bounds = spectral_bounds(op, n)  # what solve estimates, timed apart as set-up
        bounds_seconds = time.perf_counter() - t0
        limit = BF16_SSTEP_MAXITER if full else BF16_MAXITER
        nonfinite = fused_nonfinite_at(op, b_dev, bounds, tol, limit) if full else None
        maxiter = limit if nonfinite is None else min(limit, nonfinite + 64)
        cfg = SolveConfig(precision="bf16", method="sstep", tolerance=tol, maxiter=maxiter)
        capped = dataclasses.replace(cfg, maxiter=REPEAT_ITERS)
        reset_launches()
        res, k, seconds = timed(lambda: solve(op, b_dev, cfg, device=DEV))
        launches = read_launches()
        builds = {key: c for key, c in BUILD_LAUNCHES.items() if c}
        where = f"bf16 sstep lap2d_fd({g})"
        if full:  # the capped runs against each other and the chained plain versions
            capped_runs = [solve(op, b_dev, capped, device=DEV) for _ in range(2)]
            bitwise = same_x(*capped_runs)
            kern = ss.dia_sstep_stream_solve(op, b_dev, s=SSTEP_S, bounds=bounds, tol=tol,
                                             maxiter=REPEAT_ITERS, device=DEV)
            plain = plain_fused_solve(op.bands, dia.offsets, b_dev, bounds, tol, REPEAT_ITERS)
            same_plain = fused_matches_plain(kern, plain)
            same_solve = bool(kern.breakdown) or (
                int(capped_runs[0].iterations) == int(kern.iterations)
                and same_x(capped_runs[0], kern))
        else:  # the whole solve against them
            bitwise = same_x(res, solve(op, b_dev, cfg, device=DEV))
            plain = plain_fused_solve(op.bands, dia.offsets, b_dev, bounds, tol, BF16_MAXITER)
            same_plain = fused_matches_plain(res, plain)
            same_solve = True
        blocks = launches["sstep_gram_bf16"]
        fallback = launches["stream_iteration_bf16"]
        finite = bool(torch.isfinite(res.x).all())
        stop = ("converged" if bool(res.converged) else
                "breakdown, B4 fallback" if bool(res.breakdown) else
                "maxiter" if nonfinite is None else
                f"non-finite by k = {nonfinite}, cut at maxiter {maxiter}")
        bound = sum(sstep_bound(spec, site, ndiag, n, BF16, 2)[0]
                    for site in ("sstep_gram", "sstep_recover"))
        rec = {"phase": "bf16_sstep", "problem": f"lap2d_fd({g})", "n": n, "dtype": "bfloat16",
               "s": SSTEP_S, "tol": tol, "tol_rel": BF16_TOL, "maxiter": maxiter, "k": k,
               "nonfinite_at": nonfinite,
               "converged": bool(res.converged), "breakdown": bool(res.breakdown),
               "stop": stop, "x_finite": finite, "fell_back_to_b4": fallback > 0,
               "b4_launches": fallback, "seconds": seconds, "bounds_seconds": bounds_seconds,
               "us_per_iter": (seconds - bounds_seconds) / k * 1e6,
               "bound_us_per_iter": bound / SSTEP_S * 1e3, "blocks_launched": blocks,
               "launches_by_build": builds, "gram_design": ss._sstep_gram.design,
               "recover_design": ss._sstep_recover.design,
               "bounds": list(bounds), "bitwise_repeat_capped": bitwise,
               "repeat_iterations": REPEAT_ITERS if full else None, "k_plain": plain[0],
               "plain_converged": plain[1], "plain_breakdown": plain[2],
               "bitwise_chained_plain": same_plain, "capped_solve_is_kernel_chain": same_solve,
               "x_dtype": str(res.x.dtype)}
        emit(rec)
        allowed = {"sstep_gram_bf16", "sstep_recover_bf16", "stream_iteration_bf16"}
        check(blocks >= 1 and launches["sstep_recover_bf16"] == blocks
              and set(builds) <= allowed, f"{where}: launches by build {builds}")
        check(rec["gram_design"] == rec["recover_design"] == "wavefront",
              f"{where}: the designs ran were {rec['gram_design']}, {rec['recover_design']}")
        check(res.x.dtype == BF16 and res.x.shape == (n,), f"{where}: x {res.x.dtype}")
        check(bitwise, f"{where}: two runs differ")
        check(same_plain and same_solve,
              f"{where}: k, flags or x differ from the chained plain versions' ({plain[:3]})")
        if not full:
            check(bool(res.converged) and finite and not rec["fell_back_to_b4"],
                  f"{where}: did not converge on the fused route: {rec['stop']}")
        else:
            counts = {key: builds.get(key, 0) for key in ("sstep_gram_bf16", "sstep_recover_bf16")}
        del op, b_dev, res
        sync()
    return counts


def phase_f16_bands(spec, main_x, fused_x, bounds) -> tuple:
    """The float16-band builds (float32 vectors; cgx's explicit
    bands_dtype=float16), each against its plain version on seeded inputs
    and against its bfloat16-band build on the same inputs (the stencil is
    exact in both, so the two builds agree bit for bit): B4 on
    lap2d_fd(GRID), one launch (bitwise the plain one) and STREAM_ITERS
    (within CHUNK_RTOL of it, as float32 bands); B5 on
    lap2d_fd(RESIDENT_GRID) in both designs, one iteration and a CHUNK;
    B10's Gram and recover in both designs (sstep_checks, Chebyshev: x, r
    and p bitwise the plain ones); each timed against its bound at 2-byte
    bands. Then one solve each, x bitwise the bfloat16-band run's:
    dia_cg_solve_stream and dia_sstep_stream_solve on lap2d_fd(GRID)
    against the main path's and the fused s-step path's x (both on
    bfloat16 bands by "auto"), dia_cg_solve_vmem on lap2d_fd(RESIDENT_GRID)
    against the same call with bfloat16 bands. Returns the rows of the
    kernels line and each build's launches on its solve."""
    F16 = torch.float16
    rows, counts = {}, {}
    # B4
    dia = lap2d_fd(GRID)
    n, ndiag, offsets = dia.shape[0], len(dia.offsets), tuple(dia.offsets)
    kw = dict(offsets=offsets, tol=0.0, nearzero=1e-14, maxiter=10**9)
    bands, st = stream_state(dia, torch.float32, False, False)
    kb = {F16: bands.to(F16), torch.bfloat16: bands.to(torch.bfloat16)}
    del bands
    rec = {"phase": "f16_kernel", "kernel": "stream_iteration", "problem": f"lap2d_fd({GRID})",
           "n": n, "dtype": "float32", "bands_dtype": "torch.float16"}
    for launches in (1, STREAM_ITERS):
        got, ref, twin = clone_state(st), clone_state(st), clone_state(st)
        for _ in range(launches):
            cg_stream.step(kb[F16], got, **kw)
            cg_stream.step(kb[torch.bfloat16], twin, **kw)
            cg_stream._iteration_ref(kb[F16], *ref[:6], ref.scal, **kw)
        sync()
        pairs = [(a, w) for a, w in zip(got[:6], ref[:6]) if a is not None]
        key = f"x{launches}"
        rec[f"{key}_bitwise"] = all(torch.equal(a, w) for a, w in pairs)
        rec[f"{key}_max_abs_err"] = max(float((a - w).abs().max()) for a, w in pairs)
        rec[f"{key}_vec_rel_err"] = max(rel_err(a, w, w.abs().max()) for a, w in pairs)
        rec[f"{key}_bitwise_bf16_bands"] = all(
            torch.equal(a, w) for a, w in zip(got, twin) if a is not None)
        check(rec[f"{key}_bitwise_bf16_bands"]
              and (rec[f"{key}_bitwise"] if launches == 1
                   else rec[f"{key}_vec_rel_err"] <= CHUNK_RTOL[torch.float32]),
              f"B4 f16 bands x{launches}: {rec}")
        del got, ref, twin
    # the grid design (the design before stream_plan's wavefront) on one launch
    got, ref = clone_state(st), clone_state(st)
    grid = cg_stream.grid_plan(n)
    cg_stream.step(kb[F16], got, plan=grid, **kw)
    cg_stream._iteration_ref(kb[F16], *ref[:6], ref.scal, **kw)
    sync()
    rec["grid_x1_bitwise"] = all(torch.equal(a, w) for a, w in zip(got[:6], ref[:6])
                                 if a is not None)
    check(rec["grid_x1_bitwise"], f"B4 f16 bands, grid design: {rec}")
    del got, ref
    work = cg_stream.workspace(DEV, n)
    sms = dia_powers.sms_of(DEV)
    rec["design"] = cg_stream.stream_plan(n, offsets, torch.float32, sms).design
    timed_calls = {"ms": (kb[F16], None), "bf16_bands_ms": (kb[torch.bfloat16], None),
                   "grid_ms": (kb[F16], grid)}
    for key, (bands16, plan) in timed_calls.items():
        call = stream_call(bands16, st, plan, kw, work)
        rec[key] = time_ms(call)
        rec[key.replace("ms", "device_ms")] = device_ms(call, STREAM_KERNELS)
    check(rec["design"] == "grid" or rec["ms"] <= REDESIGN_SLACK * rec["grid_ms"],
          f"B4 f16 bands: the wavefront is slower than the grid design: {rec}")
    rec["plain_ms"] = time_ms(lambda: cg_stream._iteration_ref(kb[F16], *st[:6], st.scal, **kw),
                              reps=3, burst=1)
    rec["bound_ms"], rec["bound_by"] = bound_of(spec, torch.float32,
                                                stream_bytes(ndiag, n, 2, 4, False),
                                                stream_flops(ndiag, n, False))
    emit(rec)
    rows["stream_iteration_f16b"] = {
        "max_abs_err": rec["x1_max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        "n": n, "dtype": "float32", "bf16_bands_ms": rec["bf16_bands_ms"],
        "design": rec["design"], "grid_ms": rec["grid_ms"], "device_ms": rec["device_ms"],
        "grid_device_ms": rec["grid_device_ms"]}
    del kb, st, work
    sync()
    # B5
    dia1 = lap2d_fd(RESIDENT_GRID)
    n1, offsets1 = dia1.shape[0], tuple(dia1.offsets)
    bands, state = seeded_state(dia1, torch.float32)
    kb = {F16: bands.to(F16), torch.bfloat16: bands.to(torch.bfloat16)}
    del bands
    rec = {"phase": "f16_kernel", "kernel": "dia_cg_chunk",
           "problem": f"lap2d_fd({RESIDENT_GRID})", "n": n1, "dtype": "float32",
           "bands_dtype": "torch.float16"}
    for design in ("resident", "global"):
        plan = chunk_plan(design, n1, offsets1, torch.float32, F16, False)
        for chunk, rtol in ((1, VEC_RTOL[torch.float32]), (CHUNK, CHUNK_RTOL[torch.float32])):
            got, ref, twin = ([t.clone() for t in state] for _ in range(3))
            chunk_call(cg_kernel.dia_cg_chunk, kb[F16], got, offsets1, chunk, False, plan=plan)
            ran = cg_kernel.dia_cg_chunk.plan.design
            chunk_call(cg_kernel.dia_cg_chunk, kb[torch.bfloat16], twin, offsets1, chunk, False,
                       plan=plan)
            chunk_call(cg_kernel.dia_cg_chunk_ref, kb[F16], ref, offsets1, chunk, False)
            sync()
            key = f"{design}_x{chunk}"
            rec[f"{key}_bitwise"] = all(torch.equal(a, w) for a, w in zip(got[:3], ref[:3]))
            rec[f"{key}_max_abs_err"] = max(float((a - w).abs().max())
                                            for a, w in zip(got[:3], ref[:3]))
            vec_rel = max(rel_err(a, w, w.abs().max()) for a, w in zip(got[:3], ref[:3]))
            rec[f"{key}_bitwise_bf16_bands"] = all(torch.equal(a, w) for a, w in zip(got, twin))
            check(ran == design and rec[f"{key}_bitwise_bf16_bands"] and vec_rel <= rtol
                  and torch.equal(got[3][1:], ref[3][1:]),
                  f"B5 f16 bands {design} x{chunk}: {ran}, vectors {vec_rel}, {rec}")
            del got, ref, twin
        rec[f"{design}_ms"] = time_ms(lambda: chunk_call(
            cg_kernel.dia_cg_chunk, kb[F16], state, offsets1, CHUNK, False, plan=plan),
            reps=10, burst=2)
    rec["plain_ms"] = time_ms(lambda: chunk_call(cg_kernel.dia_cg_chunk_ref, kb[F16], state,
                                                 offsets1, CHUNK, False), reps=3, burst=1)
    rec["bound_ms"], rec["bound_by"] = resident_bound(spec, len(offsets1), n1, 2, False, CHUNK)
    emit(rec)
    rows["dia_cg_vmem_f16b"] = {
        "max_abs_err": rec["resident_x1_max_abs_err"], "ms": rec["resident_ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None, "design": "resident", "global_ms": rec["global_ms"], "n": n1,
        "dtype": "float32"}
    del kb, state
    sync()
    # B10
    e = sstep_checks("f32_f16b", "chebyshev", dia, sstep_kw(dia, bounds))
    recs = sstep_times(spec, "f32_f16b", dia, sstep_kw(dia, bounds))
    for site in ("sstep_gram", "sstep_recover"):
        rows[f"{site}_f16b"] = sstep_row(recs[site], e[site], dtype="float32")
    sync()
    # the solves, against the bfloat16-band runs
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    op = as_operator(dia, torch.float32, device=DEV)
    b_dev = torch.as_tensor(b, dtype=torch.float32, device=DEV)
    nearzero = SolveConfig().nearzero
    b1 = source_term(n1)
    tol1 = 1e-5 * float(np.linalg.norm(b1))
    op1 = as_operator(dia1, torch.float32, device=DEV)
    b1_dev = torch.as_tensor(b1, dtype=torch.float32, device=DEV)
    vmem_bf16 = dia_cg_solve_vmem(op1, b1_dev, tol=tol1, bands_dtype=torch.bfloat16, device=DEV)
    if fused_x is None:  # the fused path fell back to B4: its bfloat16-band kernels alone
        fused_x = ss.dia_sstep_stream_solve(op, b_dev, s=SSTEP_S, bounds=bounds, tol=tol,
                                            nearzero=nearzero, bands_dtype=torch.bfloat16,
                                            device=DEV).x
    solves = {
        "stream_iteration_f16b": ("stream_iteration_f32_f16b", main_x, lambda: dia_cg_solve_stream(
            op, b_dev, tol=tol, nearzero=nearzero, bands_dtype=F16, device=DEV)),
        "sstep_gram_f16b": ("sstep_gram_f32_f16b", fused_x, lambda: ss.dia_sstep_stream_solve(
            op, b_dev, s=SSTEP_S, bounds=bounds, tol=tol, nearzero=nearzero, bands_dtype=F16,
            device=DEV)),
        "dia_cg_vmem_f16b": ("dia_cg_vmem_f32_f16b", vmem_bf16.x, lambda: dia_cg_solve_vmem(
            op1, b1_dev, tol=tol1, bands_dtype=F16, device=DEV)),
    }
    for row, (key, want, fn) in solves.items():
        reset_launches()
        res, k, seconds = timed(fn)
        builds = {name: c for name, c in BUILD_LAUNCHES.items() if c}
        same = same_bits(res.x, want)
        emit({"phase": "f16_solve", "row": row, "k": k, "converged": bool(res.converged),
              "seconds": seconds, "launches_by_build": builds, "bitwise_bf16_bands": same})
        check(bool(res.converged) and same and builds.get(key, 0) >= 1
              and all(name.endswith("_f32_f16b") for name in builds),
              f"f16 bands {row}: converged {bool(res.converged)}, x bitwise the bf16-band "
              f"run's: {same}, launches {builds}")
        counts[row] = builds[key]
        if row == "sstep_gram_f16b":
            counts["sstep_recover_f16b"] = builds["sstep_recover_f32_f16b"]
        del res
    del op, op1, b_dev, b1_dev, vmem_bf16
    sync()
    return rows, counts


# ---------------------------------------------------------------------------
# The last modules of cgx (A13, A15, A2/A3): records and the phase timer,
# checkpoint and resume, the slope method, the autotuner, the sweeps, the
# native MatrixMarket parser and GridDiaOperator
# ---------------------------------------------------------------------------

DENSE_N_GRID = 100  # lap2d_fd(100) densified: N = 10,000, the reference's dense regime
DENSE_N_TILES = (1024, 128)  # the dense kernel phase's tiles there (the CLI's "1024 16")
CKPT_SEGMENT = 512
CKPT_MAXITER = 1024
CKPT_RTOL = 1e-13  # the sharded resume's x against the single-device one's, relative
SLOPE_KS_DIA = (64, 128, 192)
SLOPE_KS_DENSE = (50, 100, 150)
SLOPE_REPS = 3
SLOPE_B3_FLOOR = 0.9  # an iteration's s/iter against its own mat-vec's ms
SLOPE_PCT_GATE = 105.0
SWEEP_THREADS = (128, 256, 1024)
SWEEP_WIDTHS = (128, 512, 4096)
SWEEP_STRONG = (1024, 2048)
SWEEP_WEAK = (1024,)
NATIVE_GRID = 1000  # lap2d_fd(1000): N = 1e6, its lower COO a file of about 49 MB
GRID_DIA_ITERS = 512
GRID_DIA_RTOL = 1e-13


def dense_reference_problem(dtype):
    """lap2d_fd(100) densified on the card, and a seeded x."""
    a = densify_on_device(as_operator(lap2d_fd(DENSE_N_GRID), dtype, device=DEV)).a
    x = torch.as_tensor(np.random.default_rng(SEED).standard_normal(a.shape[0]), dtype=dtype,
                        device=DEV)
    return a, x


# trace() around B3 calls in a process of its own (argv: log dir, device,
# calls). Late in this script's process a torch.profiler window has kept no
# device record at all (on an H100 80GB HBM3: none of 1 or 20 B3 calls, nor
# of a lead kernel), where short processes keep every one; a fresh process
# checks trace() itself.
TRACE_PROBE = """
import sys
import torch
from cgx_torch.mats.generators import lap2d_fd
from cgx_torch.ops import matvec
from cgx_torch.solver.operators import as_operator, densify_on_device
from cgx_torch.utils.timer import trace
log_dir, dev, calls = sys.argv[1], sys.argv[2], int(sys.argv[3])
a = densify_on_device(as_operator(lap2d_fd(100), torch.float32, device=dev)).a
x = torch.ones(a.shape[0], dtype=torch.float32, device=dev)
matvec.dense_matvec(a, x, block_rows=1024, block_cols=128)
with trace(log_dir):
    for _ in range(calls):
        matvec.dense_matvec(a, x, block_rows=1024, block_cols=128)
"""


def start_trace_probe(tmp: Path) -> tuple:
    """TRACE_PROBE started beside the phases that follow (it takes about
    20 s to reach the card and trace); phase_records_timer waits for it.
    Returns (its log directory, the process, its start time)."""
    log_dir = tmp / "trace"
    proc = subprocess.Popen([sys.executable, "-c", TRACE_PROBE, str(log_dir), DEV,
                             str(DEVICE_CALLS)], cwd=Path(__file__).resolve().parent)
    return log_dir, proc, time.perf_counter()


def phase_records_timer(spec, tmp: Path, trace_run: tuple) -> None:
    """A PhaseTimer around one B3 call (N = 10,000, float32), synchronised
    on the card: its end event has completed when the phase stops, and its
    seconds cover the call's device time. trace() around DEVICE_CALLS B3
    calls, in a process of its own (TRACE_PROBE, ``trace_run`` from
    start_trace_probe), writes a Chrome trace naming B3's kernel. A SolveRecord of a capped dense
    solve through B3, with its JSON, both CSV rows and the [STEP k] line."""
    br, bc = DENSE_N_TILES
    a, x = dense_reference_problem(torch.float32)
    matvec.dense_matvec(a, x, block_rows=br, block_cols=bc)  # first touch
    sync()
    timer = PhaseTimer()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with timer.phase("dense_matvec", x):
        start.record()
        y = matvec.dense_matvec(a, x, block_rows=br, block_cols=bc)
        end.record()
    done = end.query()  # the phase waited for the card
    device_s = start.elapsed_time(end) / 1e3
    log_dir, proc, started = trace_run
    check(proc.wait(timeout=600) == 0, f"records_timer: the trace process exited {proc.returncode}")
    trace_seconds = time.perf_counter() - started
    files = sorted(log_dir.glob("*.json"))
    text = files[0].read_text() if len(files) == 1 else ""
    b = torch.as_tensor(source_term(a.shape[0]), dtype=torch.float32, device=DEV)
    reset_launches()
    t0 = time.perf_counter()
    res = cg_solve(PallasDenseOperator(a, br, bc), b, maxiter=64, history=16, device=DEV)
    k = int(res.iterations)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    r = torch.mv(a.double(), res.x.double()) - b.double()
    rec = SolveRecord.from_result(
        res, n=a.shape[0], elapsed_s=seconds, fmt="dense", precision="fp32",
        true_relative_residual=float(torch.linalg.norm(r) / torch.linalg.norm(b.double())))
    rows = tmp / "rows"
    rows.mkdir()
    rec.append_mpi_row(rows / "mpi.txt")
    rec.append_cuda_row(rows / "cuda.txt", br, bc)
    mpi_row = (rows / "mpi.txt").read_text().strip()
    cuda_row = (rows / "cuda.txt").read_text().strip()
    print(rec.debug_line(), flush=True)
    out = {"phase": "records_timer", "n": a.shape[0], "dtype": "float32", "tiles": [br, bc],
           "timer_seconds": timer.report()["dense_matvec"], "device_seconds": device_s,
           "end_event_done": done, "timer_summary": timer.summary(),
           "trace_files": [f.name for f in files], "trace_calls": DEVICE_CALLS,
           "trace_b3_mentions": text.count("dense_matvec_persistent_kernel"),
           "trace_kernels": text.count('"cat": "kernel"'), "trace_seconds": trace_seconds,
           "trace_names_b3": "dense_matvec_persistent_kernel" in text,
           "record": json.loads(rec.to_json()), "mpi_row": mpi_row, "cuda_row": cuda_row,
           "step_line": rec.debug_line().strip(), "b3_launches": launches["dense_matvec"]}
    emit(out)
    check(done and out["timer_seconds"] >= device_s,
          f"records_timer: the phase did not wait for the card ({out['timer_seconds']} s "
          f"against {device_s} s of device time)")
    check(timer.counts == {"dense_matvec": 1} and "dense_matvec" in out["timer_summary"],
          f"records_timer: counts {timer.counts}")
    check(out["trace_names_b3"], f"records_timer: the trace {out['trace_files']} has no B3 kernel")
    check(k == 64 and rec.iterations == 64 and not rec.converged and rec.history is not None
          and 0 < len(rec.history) <= 16 and all(math.isfinite(h) for h in rec.history),
          f"records_timer: record {out['record']}")
    check(mpi_row == f"{a.shape[0]},1,{seconds}" and cuda_row == f"{br},{bc},{seconds}"
          and rec.debug_line().startswith("\t[STEP 64] residual = "),
          f"records_timer: rows {mpi_row!r}, {cuda_row!r}")
    check(launches["dense_matvec"] == 65, f"records_timer: B3 launches {launches}")
    del a, x, y


def phase_slope(spec, b3_fp32_ms: float) -> None:
    """The slope method on the card: measure_dia_cg on lap2d_fd(3200) in
    fp64 (the plain reference recurrence) and measure_dense_cg on
    lap2d_fd(100) densified in fp32 with B3 ("pallas", the dense phase's
    tiles) and torch.matmul ("xla"); s/iter, the Theil-Sen spread, the
    share of the data sheet's memory rate and row_trusted. Gates: a
    positive slope, no share above 105%, and B3's s/iter no less than 0.9x
    this run's B3 ms (an iteration holds its mat-vec)."""
    check(slope.chip_hbm_gbps(device=DEV) * 1e9 == spec["hbm_bytes_per_s"],
          f"slope: HBM_GBPS {slope.HBM_GBPS} against the card's {spec['hbm_bytes_per_s']}")
    br, bc = DENSE_N_TILES
    runs = []
    reset_launches()
    runs.append(("dia", slope.measure_dia_cg(lap2d_fd(GRID), dtype="float64", ks=SLOPE_KS_DIA,
                                             reps=SLOPE_REPS, device=DEV)))
    sync()
    dense = lap2d_fd(DENSE_N_GRID).to_dense()
    for kernel in ("pallas", "xla"):
        runs.append((kernel, slope.measure_dense_cg(dense, dtype="float32", block_rows=br,
                                                    block_cols=bc, kernel=kernel,
                                                    ks=SLOPE_KS_DENSE, reps=SLOPE_REPS,
                                                    device=DEV)))
        sync()
    launches = read_launches()
    for name, out in runs:
        us = out["s_per_iter"] * 1e6
        pct = 100.0 * out["fraction_of_peak"]
        rec = {"phase": "slope", "run": name, "n": out["n"], "dtype": out["dtype"],
               "ks": list(out["ks"]), "reps": out["reps"], "us_per_iter": us,
               "us_per_iter_lsq": out["s_per_iter_lsq"] * 1e6, "floor_s": out["floor"],
               "fit_rel_err": out["fit_rel_err"], "ts_spread": out["ts_spread"],
               "bytes_per_iter": out["bytes_per_iter"], "achieved_gbps": out["achieved_gbps"],
               "peak_gbps": out["peak_gbps"], "pct_of_peak": pct,
               "row_trusted": slope.row_trusted(us, out["ts_spread"], pct),
               "gflops": out.get("gflops"), "b3_ms": b3_fp32_ms if name == "pallas" else None,
               "b3_launches": launches["dense_matvec"] if name == "pallas" else None}
        emit(rec)
        check(us > 0, f"slope {name}: s/iter {us} us is not positive")
        check(pct <= SLOPE_PCT_GATE, f"slope {name}: {pct}% of the memory rate's peak")
        if name == "pallas":
            check(out["s_per_iter"] * 1e3 >= SLOPE_B3_FLOOR * b3_fp32_ms,
                  f"slope: B3's iteration {us} us beats its own mat-vec {b3_fp32_ms} ms")
    check(launches["dense_matvec"] > 0, f"slope: B3 did not run: {launches}")


def phase_autotune(spec, tmp: Path) -> None:
    """autotune_dense_tiles(10000, float32, force=True) with the cache in
    this run's temporary directory; tuned_tiles returns its pair; the CLI
    with --pallas and no tiles on N = 10,000 (fp32, 1e-5 ||b||) builds its
    operator with that pair, and its k is within 2% of the plain dense
    loop's with the same tiles and dots."""
    cache = tmp / "autotune.json"
    saved = os.environ.get("CGX_TORCH_AUTOTUNE_CACHE")
    os.environ["CGX_TORCH_AUTOTUNE_CACHE"] = str(cache)
    try:
        n = DENSE_N_GRID ** 2
        reset_launches()
        t0 = time.perf_counter()
        pair = autotune.autotune_dense_tiles(n, torch.float32, force=True, device=DEV)
        tune_seconds = time.perf_counter() - t0
        tune_launches = read_launches()["dense_matvec"]
        name = torch.cuda.get_device_name(0) if DEV == "cuda" else "cpu"
        entry = json.loads(cache.read_text())[f"{name}|{n}|float32"]
        tuned = autotune.tuned_tiles(n, torch.float32, device=DEV)
        b = source_term(n)
        tol = 1e-5 * float(np.linalg.norm(b))
        run, m, launches = cli_run([str(n), str(tmp / "strong.txt"), "--pallas", "--precision",
                                    "fp32", "--tol", repr(tol)])
        k = int(m.group(1))
        br, bc = run.op.block_rows, run.op.block_cols
        a = run.op.a
        plain = cg_solve(lambda v: matvec.dense_matvec_ref(a, v, block_rows=br, block_cols=bc),
                         torch.as_tensor(b, dtype=torch.float32, device=DEV), tol=tol,
                         device=DEV)
        k_plain = int(plain.iterations)
    finally:
        if saved is None:
            os.environ.pop("CGX_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["CGX_TORCH_AUTOTUNE_CACHE"] = saved
    clamped = (max(8, min((pair[0] // 8) * 8 or 8, 1024)),
               max(128, min((pair[1] // 128) * 128 or 128, 4096)))
    rec = {"phase": "autotune", "n": n, "dtype": "float32", "pair": list(pair),
           "seconds": entry["seconds"], "candidates_tried": entry["candidates_tried"],
           "candidates": [list(c) for c in autotune.DEFAULT_CANDIDATES],
           "tune_seconds": tune_seconds, "tune_b3_launches": tune_launches,
           "tuned_tiles": list(tuned), "cli_tiles": [br, bc], "cli_k": k, "k_plain": k_plain,
           "cli_seconds": run.seconds, "cli_converged": bool(run.result.converged),
           "cli_b3_launches": launches["dense_matvec"], "tol": tol}
    emit(rec)
    check(tuned == pair, f"autotune: tuned_tiles {tuned} against the tuned pair {pair}")
    check(entry["candidates_tried"] == len(autotune.DEFAULT_CANDIDATES),
          f"autotune: {entry['candidates_tried']} candidates of {autotune.DEFAULT_CANDIDATES}")
    check((br, bc) == clamped, f"autotune: the CLI took {(br, bc)}, the cache holds {pair}")
    check(rec["cli_converged"] and launches["dense_matvec"] >= k + 1,
          f"autotune: the CLI run converged={rec['cli_converged']}, launches {launches}")
    check(abs(k - k_plain) <= 0.02 * k_plain, f"autotune: CLI k={k} vs plain k={k_plain}")
    del run, plain, a


def phase_sweeps(spec, mesh) -> None:
    """kernel_sweep(10000) over threads (128, 256, 1024) x widths (128,
    512, 4096), and strong_scaling((1024, 2048)) and weak_scaling((1024,))
    on the one-rank NCCL mesh: every row in cgx's schema with positive
    seconds, one row for each configuration dense_plan accepts."""
    reset_launches()
    t0 = time.perf_counter()
    tiles = sweeps.kernel_sweep(DENSE_N_GRID ** 2, threads=SWEEP_THREADS,
                                block_widths=SWEEP_WIDTHS, device=DEV)
    tile_seconds = time.perf_counter() - t0
    b3 = read_launches()["dense_matvec"]
    accepted = [(t, w) for t in SWEEP_THREADS for w in SWEEP_WIDTHS
                if autotune.feasible(DENSE_N_GRID ** 2, max(128, min(w, DENSE_N_GRID ** 2)),
                                     torch.float32, mesh.device)]
    t0 = time.perf_counter()
    strong = sweeps.strong_scaling(SWEEP_STRONG, device=DEV)
    weak = sweeps.weak_scaling(SWEEP_WEAK, device=DEV)
    scaling_seconds = time.perf_counter() - t0
    rec = {"phase": "sweeps", "world": mesh.size, "backend": dist.get_backend(mesh.group),
           "kernel_rows": tiles, "strong_rows": strong, "weak_rows": weak,
           "kernel_seconds": tile_seconds, "scaling_seconds": scaling_seconds,
           "b3_launches": b3, "accepted": [list(c) for c in accepted]}
    emit(rec)

    def schema(rows, firsts):
        parts = [r.split(",") for r in rows]
        return [tuple(int(v) for v in p[:2]) for p in parts] == firsts and all(
            len(p) == 3 and float(p[2]) > 0 for p in parts)

    check(schema(tiles, accepted), f"sweeps: kernel rows {tiles} against {accepted}")
    check(schema(strong, [(n, 1) for n in SWEEP_STRONG]), f"sweeps: strong rows {strong}")
    check(schema(weak, [(n, 1) for n in SWEEP_WEAK]), f"sweeps: weak rows {weak}")
    check(b3 >= 3 * len(accepted), f"sweeps: B3 launches {b3}")


def phase_native(spec, tmp: Path) -> None:
    """The native parser on the card's host: it must build (no silent
    NumPy fallback). lap2d_fd(1000)'s lower COO written by mmwrite_native,
    read back through COOMatrix.read (the native route above 1 MiB), its
    arrays the NumPy parser's bit for bit; then solved through the
    whole-solve kernel B5 (solve, fp32, use_pallas; the resident budget
    raised to N = 1e6 where the crossover phase set it lower), with the
    generator's operator's k and x bit for bit."""
    check(native.native_available(), "native: the MatrixMarket parser did not build")
    coo = lap2d_fd_coo_lower(NATIVE_GRID)
    path = tmp / f"lap2d_fd_{NATIVE_GRID}.mtx"
    t0 = time.perf_counter()
    native.mmwrite_native(path, coo.shape, coo.rows, coo.cols, coo.values, symmetric=True)
    write_s = time.perf_counter() - t0
    calls = []
    real_read = native.mmread_native
    native.mmread_native = lambda p: (calls.append(p), real_read(p))[1]
    try:
        t0 = time.perf_counter()
        read = COOMatrix.read(path)
        native_s = time.perf_counter() - t0
    finally:
        native.mmread_native = real_read
    t0 = time.perf_counter()
    ref = mmio.mmread(path)
    numpy_s = time.perf_counter() - t0
    same = all(np.array_equal(getattr(read, f), getattr(ref, f)) and
               getattr(read, f).dtype == getattr(ref, f).dtype for f in ("rows", "cols", "values"))
    dia_file = DIAMatrix.from_coo(read)
    dia_gen = lap2d_fd(NATIVE_GRID)
    n, ndiag = dia_gen.shape[0], len(dia_gen.offsets)
    b = source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    cfg = SolveConfig(precision="fp32", use_pallas=True, tolerance=tol)
    state = cg_kernel.resident_state_bytes(ndiag, n, 4, 4, precond=False)
    budget = config.RESIDENT_BUDGET_BYTES
    config.RESIDENT_BUDGET_BYTES = max(budget, state)
    try:
        runs = {}
        for name, dia in (("file", dia_file), ("generator", dia_gen)):
            reset_launches()
            res, k, seconds = timed(lambda: solve(dia, b, cfg, device=DEV))
            runs[name] = (res, k, seconds, read_launches())
    finally:
        config.RESIDENT_BUDGET_BYTES = budget
    (rf, kf, sf, lf), (rg, kg, _, _) = runs["file"], runs["generator"]
    rec = {"phase": "native", "problem": f"lap2d_fd({NATIVE_GRID})", "n": n,
           "file_bytes": os.path.getsize(path), "nnz": int(len(coo.values)),
           "write_seconds": write_s, "native_read_seconds": native_s,
           "numpy_read_seconds": numpy_s, "native_route": calls == [path],
           "arrays_bitwise_numpy": same, "bands_equal_generator": bool(
               np.array_equal(dia_file.bands, dia_gen.bands)
               and tuple(dia_file.offsets) == tuple(dia_gen.offsets)),
           "library": native.library_path().name, "tol": tol, "k": kf, "k_generator": kg,
           "seconds": sf, "converged": bool(rf.converged), "x_bitwise": same_x(rf, rg),
           "b5_launches": lf.get("dia_cg_vmem2d", 0), "budget_raised": state > budget}
    emit(rec)
    path.unlink()
    check(rec["file_bytes"] > 1 << 20 and rec["native_route"],
          f"native: COOMatrix.read took the native parser: {rec['native_route']}")
    check(same and rec["bands_equal_generator"], "native: the arrays differ from NumPy's")
    check(rec["converged"] and kf == kg and rec["x_bitwise"],
          f"native: k={kf} vs the generator's {kg}, x bitwise {rec['x_bitwise']}")
    check(rec["b5_launches"] > 0, f"native: B5 did not run: {lf}")


def phase_grid_dia(spec) -> None:
    """GridDiaOperator.from_host(lap2d_fd(3200)) in fp64: its mat-vec the
    flat operator's bit for bit; cg_solve capped at 512 iterations with
    the flat run's k and x within 1e-13 relative (the dots sum over the
    grid in another order); from_host(lap2d_reference(10000)) refused."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    t0 = time.perf_counter()
    grid = GridDiaOperator.from_host(dia, device=DEV)
    build_s = time.perf_counter() - t0
    flat = as_operator(dia, device=DEV)
    x = torch.as_tensor(np.random.default_rng(SEED).standard_normal(n), device=DEV)
    matvec_bitwise = same_bits(grid.matvec(x), flat.matvec(x))
    b = torch.as_tensor(source_term(n), device=DEV)
    rg, kg, sg = timed(lambda: cg_solve(grid, b, maxiter=GRID_DIA_ITERS, device=DEV))
    rf, kf, sfl = timed(lambda: cg_solve(flat, b, maxiter=GRID_DIA_ITERS, device=DEV))
    rel = float((rg.x - rf.x).abs().max() / rf.x.abs().max())
    try:
        GridDiaOperator.from_host(lap2d_reference(10000), device=DEV)
        refused = None
    except ValueError as e:
        refused = str(e)
    rec = {"phase": "grid_dia", "problem": f"lap2d_fd({GRID})", "n": n, "dtype": "float64",
           "g": grid.g, "ndim": grid.ndim, "deltas": [list(d) for d in grid.deltas],
           "build_seconds": build_s, "matvec_bitwise": matvec_bitwise, "k": kg, "k_flat": kf,
           "x_rel_diff": rel, "x_bitwise": same_x(rg, rf), "seconds": sg, "flat_seconds": sfl,
           "us_per_iter": sg / GRID_DIA_ITERS * 1e6, "flat_us_per_iter": sfl / GRID_DIA_ITERS * 1e6,
           "reference_refused": refused}
    emit(rec)
    check(matvec_bitwise, "grid_dia: the grid mat-vec differs from the flat one")
    check(kg == kf == GRID_DIA_ITERS and rel <= GRID_DIA_RTOL,
          f"grid_dia: k={kg} vs {kf}, x off by {rel}")
    check(refused is not None and "wrap" in refused,
          f"grid_dia: lap2d_reference(10000) was not refused ({refused})")
    del grid, flat, rg, rf


def phase_checkpoint(spec, mesh, tmp: Path) -> None:
    """cg_solve_resumable on lap2d_fd(3200), fp64, source_term, segments
    of 512: uninterrupted to maxiter 1024; interrupted (to 512, then a
    second call to 1024 on the same file), equal k and x bit for bit;
    sharded_cg_solve_resumable on the one-rank NCCL mesh, resumed from the
    single-device 512-iteration file, equal k and x within 1e-13 relative
    (bitwise where the one rank's dots are the single device's). The
    seconds of each segment (its device work and the copies of x, r and p
    to the host) and of each checkpoint write (3 x 82 MB)."""
    dia = lap2d_fd(GRID)
    n = dia.shape[0]
    op = as_operator(dia, device=DEV)
    b = torch.as_tensor(source_term(n), device=DEV)
    events = []
    real_save = CGCheckpoint.save

    def timed_save(self, path):
        t0 = time.perf_counter()
        real_save(self, path)
        events.append((t0, time.perf_counter()))

    def segments(fn) -> tuple:
        """(result, segment seconds, write seconds) of one resumable call."""
        events.clear()
        sync()
        t0 = time.perf_counter()
        res = fn()
        int(res.iterations)
        seg, prev = [], t0
        for start, stop in events:
            seg.append(start - prev)
            prev = stop
        return res, seg, [stop - start for start, stop in events]

    CGCheckpoint.save = timed_save
    try:
        straight, seg_a, write_a = segments(lambda: cg_solve_resumable(
            op, b, tmp / "straight.npz", maxiter=CKPT_MAXITER, segment=CKPT_SEGMENT, device=DEV))
        first, seg_b1, write_b1 = segments(lambda: cg_solve_resumable(
            op, b, tmp / "cut.npz", maxiter=CKPT_SEGMENT, segment=CKPT_SEGMENT, device=DEV))
        shutil.copy(tmp / "cut.npz", tmp / "for_mesh.npz")
        resumed, seg_b2, write_b2 = segments(lambda: cg_solve_resumable(
            op, b, tmp / "cut.npz", maxiter=CKPT_MAXITER, segment=CKPT_SEGMENT, device=DEV))
        sharded, seg_c, write_c = segments(lambda: sharded_cg_solve_resumable(
            dia, source_term(n), tmp / "for_mesh.npz", mesh=mesh, maxiter=CKPT_MAXITER,
            segment=CKPT_SEGMENT))
    finally:
        CGCheckpoint.save = real_save
    ck = CGCheckpoint.load(tmp / "for_mesh.npz")
    rel = float((sharded.x - straight.x).abs().max() / straight.x.abs().max())
    k = int(straight.iterations)
    rec = {"phase": "checkpoint", "problem": f"lap2d_fd({GRID})", "n": n, "dtype": "float64",
           "segment": CKPT_SEGMENT, "maxiter": CKPT_MAXITER, "k": k,
           "k_first": int(first.iterations), "k_resumed": int(resumed.iterations),
           "k_sharded": int(sharded.iterations), "resumed_bitwise": same_x(resumed, straight),
           "sharded_rel_diff": rel, "sharded_bitwise": same_x(sharded, straight),
           "mesh_checkpoint_k": ck.k, "write_bytes": 3 * n * 8,
           "segment_seconds": {"uninterrupted": seg_a, "first": seg_b1, "resumed": seg_b2,
                               "sharded": seg_c},
           "write_seconds": {"uninterrupted": write_a, "first": write_b1, "resumed": write_b2,
                             "sharded": write_c},
           "world": mesh.size, "backend": dist.get_backend(mesh.group)}
    emit(rec)
    for f in tmp.glob("*.npz"):
        f.unlink()
    check(k == CKPT_MAXITER and int(first.iterations) == CKPT_SEGMENT and ck.k == CKPT_MAXITER,
          f"checkpoint: k {k}, first {int(first.iterations)}, the mesh's file {ck.k}")
    check(int(resumed.iterations) == k and rec["resumed_bitwise"],
          f"checkpoint: the resumed solve left the uninterrupted one (k {int(resumed.iterations)})")
    check(int(sharded.iterations) == k and rel <= CKPT_RTOL,
          f"checkpoint: the mesh's resume k {int(sharded.iterations)}, x off by {rel}")
    check(len(seg_a) == 2 and len(seg_b1) == len(seg_b2) == len(seg_c) == 1,
          f"checkpoint: segments {rec['segment_seconds']}")
    del op, b, straight, first, resumed, sharded


def main() -> int:
    spec = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp, cli_replay(Path(tmp)) as replay:
        return run_phases(spec, Path(tmp), replay)


def run_phases(spec, replay_tmp: Path, replay: subprocess.Popen) -> int:
    """Every phase after the build, in order; the CLI's CPU replay runs
    beside them in ``replay_tmp``."""
    records = phase_kernels(spec)
    phase_b1_sizes(spec)
    # each kernel's launches come from a path that runs it, counted from 0 just before it
    launches = {name: n for name, n in phase_goldens().items() if name in THREE_KERNEL}
    records.update(phase_stream_kernel(spec))
    main_launches, b4_main, main_x = phase_main(spec)
    launches.update({name: n for name, n in main_launches.items()
                     if name in ("stream_iteration", "stream_iteration_stacked")})
    launches["stream_iteration_pcg"] = phase_stream_pcg(spec)["stream_iteration_pcg"]
    phase_stream_goldens()
    dense_records, b3_fp32_ms = phase_dense_kernels(spec)
    records.update(dense_records)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update({name: n for name, n in phase_cli_reference(spec, Path(tmp)).items()
                         if name.startswith("dense_")})
        phase_cli_mpi(spec, Path(tmp))
        phase_cli_fp32(spec, Path(tmp))
        launches.update(phase_bf16_cli(spec, Path(tmp)))
    records.update(phase_resident_kernel(spec))
    phase_resident_goldens()
    launches.update({name: n for name, n in phase_resident_path(spec).items()
                     if name in RESIDENT_SITES})
    records.update(phase_bf16_kernels(spec))
    launches.update(phase_bf16_resident(spec))
    launches.update(phase_bf16_main(spec))
    phase_crossover(spec)
    phase_mixed(spec)
    launches.update({name: n for name, n in phase_mixed_above(spec).items() if name in BF16_SITES})
    bounds, bounds_seconds = phase_sstep_bounds()
    records.update(phase_sstep_kernels(spec, bounds))
    sstep_launches, fused_x = phase_sstep_path(spec, bounds, bounds_seconds, b4_main)
    launches.update(sstep_launches)
    phase_sstep_goldens()
    # ROADMAP A6's rest
    rows, counts = phase_bf16_sstep_kernels(spec, bounds)
    records.update(rows)
    launches.update(counts)
    launches.update(phase_bf16_sstep(spec))
    rows, counts = phase_f16_bands(spec, main_x, fused_x, bounds)
    records.update(rows)
    launches.update(counts)
    del main_x, fused_x
    sync()
    for site, halo in phase_sstep_halo(spec).items():
        records[site].update(halo)
    records.update(phase_stream_matvec(spec))
    with nccl_mesh() as mesh:
        launches.update(phase_sharded(spec, mesh, b4_main))
        phase_sharded_goldens(mesh)
        phase_bf16_mesh(mesh)
        phase_sharded_precond(mesh)
        phase_sharded_methods(mesh)
        for site, n_halo in phase_sharded_sstep(spec, mesh).items():
            records[site]["halo_launches"] = n_halo  # on the sharded fused path
    mg = phase_mg_main(spec, b4_main)
    phase_mg_goldens()
    with tempfile.TemporaryDirectory() as tmp:
        phase_precond_paths(Path(tmp))
    op, b, apply, calls, tw = phase_tw_main()
    phase_dd_main(op, b, apply, calls, tw)
    del op, b, apply
    sync()
    phase_ozaki_dense()
    with nccl_mesh() as mesh:
        phase_sharded_mixed(spec, mesh)
        k_sharded_mg = phase_sharded_mg(spec, mesh, mg)
        phase_sharded_tw(spec, mesh, tw)
        phase_sharded_block_mg(spec, mesh, mg, k_sharded_mg)
        every = phase_sharded_batched(spec, mesh)
        # B8's count on the sequence's path beside the one-RHS route's
        records["dia_matvec_stream2d_planes"]["sequence_launches"] = phase_sharded_sequence(
            spec, mesh, every)
    phase_gv_main(spec, b4_main, mg)
    phase_cheby_main(spec, b4_main, replay_tmp)
    phase_cli_methods(spec, replay_tmp, replay)
    phase_block_main(spec, mg)
    phase_multi_rhs_paths()
    # ROADMAP A13, A15 and the A2/A3 leftovers: the last modules of cgx
    phase_slope(spec, b3_fp32_ms)
    with tempfile.TemporaryDirectory() as tmp:
        phase_autotune(spec, Path(tmp))
    with tempfile.TemporaryDirectory() as probe_tmp:
        trace_run = start_trace_probe(Path(probe_tmp))  # beside the phases after the timed ones
        with tempfile.TemporaryDirectory() as tmp:
            phase_native(spec, Path(tmp))
        phase_grid_dia(spec)
        sync()
        with nccl_mesh() as mesh, tempfile.TemporaryDirectory() as tmp:
            phase_checkpoint(spec, mesh, Path(tmp))
            phase_sweeps(spec, mesh)
        phase_records_timer(spec, Path(probe_tmp), trace_run)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = records[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        # the s-step sites' basis_plan design and the slab design's time,
                        # the PCG's pcg_plan design and the three-launch design's time
                        "design": rec.get("design"), "slab_ms": rec.get("slab_ms"),
                        "three_ms": rec.get("three_ms"), "grid_ms": rec.get("grid_ms"),
                        "global_ms": rec.get("global_ms"),
                        "sync_floor_ms": rec.get("sync_floor_ms"),
                        "hbm_per_iter_bound_ms": rec.get("hbm_per_iter_bound_ms"),
                        # B10's halo mode (the sharded fused route): a shard of
                        # 2,560,000 rows and its halo, and its launches there
                        "halo_ms": rec.get("halo_ms"), "halo_bound_ms": rec.get("halo_bound_ms"),
                        "halo_plain_ms": rec.get("halo_plain_ms"),
                        "halo_design": rec.get("halo_design"),
                        "halo_launches": rec.get("halo_launches"),
                        # B8 on the sharded solve_sequence's harvest and deflated solves
                        "sequence_launches": rec.get("sequence_launches"),
                        # the vectors' dtype, and whether the site has a bfloat16-vector
                        # build (all but the replay, which works on the float64 state)
                        "dtype": rec.get("dtype"),
                        "bf16_build": name in BF16_BUILT or f"{name}_bf16" in BF16_BUILT,
                        # a float16-band row's bfloat16-band twin on the same inputs
                        "bf16_bands_ms": rec.get("bf16_bands_ms"),
                        # the bf16 rows' other design, preconditioner and shape
                        "pcg_ms": rec.get("pcg_ms"), "pcg_global_ms": rec.get("pcg_global_ms"),
                        "pcg_bound_ms": rec.get("pcg_bound_ms"), "n": rec.get("n"),
                        # device-only ms (Kineto) of the design that ran and of the design
                        # before a redesign (grid: B4/B7's grid design; three: B6's three
                        # launches; warp: B3's whole-warp spans), and of the library call
                        "device_ms": rec.get("device_ms"),
                        "grid_device_ms": rec.get("grid_device_ms"),
                        "three_device_ms": rec.get("three_device_ms"),
                        "warp_ms": rec.get("warp_ms"), "warp_device_ms": rec.get("warp_device_ms"),
                        "library_device_ms": rec.get("library_device_ms")})
    print(json.dumps({"kernels": kernels, "not_ported": NOT_PORTED}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

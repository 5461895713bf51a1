#!/usr/bin/env python3
"""Time two end-to-end paths of one checkout of cgx_torch, for comparing
two versions on one card.

    python3 ab_paths.py CHECKOUT LABEL

runs, from CHECKOUT (the root of a checkout: this one, or another unpacked
with ``git archive`` into a directory ``.gitignore`` lists), after its
``chip_smoke.py`` device and build phases: the reference project's CLI run
(``lap2D_5pt_n100.mtx 1024 16 true``: fp64, N = 10,000, the dense kernel)
RUNS times in-process, ``solve(lap2d_fd(3200), fp32, method="sstep")``
(N = 10,240,000) once on each s-step route: "auto" (the fused s-step
kernels) and ``sstep_powers="pallas"`` (the matrix-powers and replay
kernels), and the stream PCG solve ``solve(lap2d_fd(3200), fp32,
use_pallas=True, precond="neumann")`` (kernel B6) once; then the time of
one B6 iteration and of one B8 planes product (float32 and float64) on
lap2d_fd(3200), as the checkout runs them; then the resident path,
``solve(lap2d_fd(1000), fp32, use_pallas=True)`` (N = 1,000,000, kernel
B5) without and with ``precond="neumann"``, and ``precision="mixed"`` on
the same problem at a relative tolerance of 1e-11, once each after a
warm-up; the time of one 64-iteration B5 chunk there, and of one B1
``dia_matvec_dot`` on lap2d_fd(3200), float32. It prints one line,
``RESULT {json}``, with the CLI's seconds (the first run included: it pays
the first calls), each solve's k and seconds, the kernels' ms, and the
peak device memory (``torch.cuda.max_memory_allocated``) that 64 fused
blocks take above their operator and right-hand side, given the solve's
bounds (the fused loop's state and workspace). Host clocks vary between
calls and cards, so compare two checkouts only within one call, in turns
(A, B, B, A). It needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

RUNS = 6


def main(root: str, label: str) -> int:
    os.chdir(root)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from cgx_torch import SolveConfig, as_operator, dia_sstep_stream_solve, solve
    from cgx_torch.solver.chebyshev import spectral_bounds
    from cgx_torch.mats.generators import lap2d_fd, lap2d_fd_coo_lower, source_term
    from cgx_torch.ops import cg_stream, dia_spmv

    cs.phase_device()
    cs.phase_build()
    out = {"label": label, "checkout": root, "cli_seconds": []}
    with tempfile.TemporaryDirectory() as tmp:
        mtx = Path(tmp) / "lap2D_5pt_n100.mtx"
        lap2d_fd_coo_lower(100).write(mtx, comment=" 2D 5-point Laplacian, 100x100 grid")
        argv = [str(mtx), "1024", "16", "true", str(Path(tmp) / "out.txt")]
        for _ in range(RUNS):
            run, m, _ = cs.cli_run(argv)
            out["cli_seconds"].append(run.seconds)
            out["cli_k"] = int(m.group(1))
    dia = lap2d_fd(cs.GRID)
    b = source_term(dia.shape[0])
    op = as_operator(dia, torch.float32, device="cuda")
    b_dev = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    tol = 1e-5 * float(np.linalg.norm(b))
    for key, extra in (("sstep", {"method": "sstep"}),
                       ("sstep_pallas", {"method": "sstep", "sstep_powers": "pallas"}),
                       ("stream_pcg", {"use_pallas": True, "precond": "neumann"})):
        cfg = SolveConfig(precision="fp32", tolerance=tol, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(op, b_dev, cfg, device="cuda")
        torch.cuda.synchronize()
        out[key] = {"k": int(res.iterations), "seconds": time.perf_counter() - t0}
        del res
    bounds = spectral_bounds(op, dia.shape[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dia_sstep_stream_solve(op, b_dev, s=4, bounds=bounds, tol=0.0, maxiter=256, device="cuda")
    out["fused_loop_peak_bytes_above_inputs"] = torch.cuda.max_memory_allocated() - held
    del op, b_dev
    torch.cuda.empty_cache()
    offsets, n = tuple(dia.offsets), dia.shape[0]
    kw = dict(offsets=offsets, tol=0.0, nearzero=1e-14, maxiter=10**9)
    bands, st = cs.stream_state(dia, torch.float32, True, False)
    work = cg_stream.workspace("cuda", n)
    out["b6_ms"] = cs.time_ms(lambda: cg_stream.step(bands, st, work=work, **kw))
    del bands, st, work
    for dtype in (torch.float32, torch.float64):
        bands = torch.as_tensor(dia.bands, dtype=dtype, device="cuda")
        planes = dia_spmv.stream2d_band_planes(bands, rows=256, cols=512).contiguous()
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(n), dtype=dtype,
                            device="cuda")
        out[f"b8_planes_ms_{str(dtype)[6:]}"] = cs.time_ms(
            lambda: dia_spmv.dia_matvec_stream2d_planes(planes, x, offsets=offsets))
        del bands, planes, x
        torch.cuda.empty_cache()
    bands = torch.as_tensor(dia.bands, dtype=torch.float32, device="cuda")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(n), dtype=torch.float32,
                        device="cuda")
    out["b1_dot_ms"] = cs.time_ms(lambda: dia_spmv.dia_matvec_dot(bands, x, offsets=offsets))
    del bands, x
    torch.cuda.empty_cache()
    resident(cs, out)
    print("RESULT " + json.dumps(out), flush=True)


def resident(cs, out: dict) -> None:
    """The resident path's solves at N = 1e6 (each after one warm-up) and
    one B5 chunk, as the checkout runs them."""
    import numpy as np
    import torch

    from cgx_torch import SolveConfig, as_operator, solve
    from cgx_torch.mats.generators import lap2d_fd, source_term
    from cgx_torch.ops import cg_kernel

    dia = lap2d_fd(cs.RESIDENT_GRID)
    b = source_term(dia.shape[0])
    tol = 1e-5 * float(np.linalg.norm(b))
    op32 = as_operator(dia, torch.float32, device="cuda")
    op64 = as_operator(dia, torch.float64, device="cuda")
    b32 = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    b64 = torch.as_tensor(b, dtype=torch.float64, device="cuda")
    for key, op, rhs, cfg in (
            ("resident", op32, b32, SolveConfig(precision="fp32", use_pallas=True, tolerance=tol)),
            ("resident_pcg", op32, b32, SolveConfig(precision="fp32", use_pallas=True,
                                                     tolerance=tol, precond="neumann")),
            ("mixed", op64, b64, SolveConfig(precision="mixed", tolerance=1e-11))):
        for _ in range(2):  # the first pays the first calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(op, rhs, cfg, device="cuda")
            torch.cuda.synchronize()
            out[key] = {"k": int(res.iterations), "seconds": time.perf_counter() - t0}
            del res
    bands, state = cs.seeded_state(dia, torch.float32)
    out["b5_chunk_ms"] = cs.time_ms(lambda: cs.chunk_call(cg_kernel.dia_cg_chunk, bands, state,
                                                          tuple(dia.offsets), cs.CHUNK, False),
                                    reps=10, burst=2)
    del bands, state, op32, op64
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))

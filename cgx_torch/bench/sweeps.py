"""Benchmark sweep harness (counterpart of ``cgx/bench/sweeps.py``;
reference L6: the cg.run SLURM scripts).

The reference's three experiment families, with its CSV schemas, so the
analysis (:mod:`cgx_torch.bench.analysis`) reads either dataset:

- strong scaling (MPI/cg.run:15-19): N in {1024,2048,4096,8192} x
  p in {1,2,4,...}; schema ``N,psize,seconds``.
- weak scaling (MPI/cg.run:22-44): ladders N(p) = N0 * sqrt(p) with
  iterations fixed at 200; schema ``N,psize,seconds``.
- kernel sweep (CUDA/cg.run:20-30): the tile sweep of the dense mat-vec
  kernel B3 (NUM_THREADS -> block_rows, BLOCK_WIDTH -> block_cols);
  schema ``threads,block_width,seconds``.

The scaling sweeps run one process a rank, as the sharded solver does:
every rank of the process group calls them with the same arguments. The
mesh sizes are ``make_mesh(p)`` subgroups for every p up to the world
size (one rank with no process group). The ranks of a mesh time its
solves; a rank outside a mesh of p only takes part in making it. Rank 0
of the world is in every mesh: its rows are complete, and it alone
appends them to ``out_file``.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cgx_torch.config import DEFAULT_TOLERANCE
from cgx_torch.mats.generators import lap2d_reference, source_term
from cgx_torch.ops._util import resolve_device
from cgx_torch.parallel.mesh import make_mesh
from cgx_torch.parallel.sharded_cg import sharded_cg_solve


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _fetch(res) -> None:
    """Wait for the card and fetch one scalar of the result (a tensor or
    a result record whose first field is one)."""
    leaf = res[0] if isinstance(res, tuple) else res
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    leaf.reshape(-1)[0].item()


def _time_solve(fn, repeats: int = 1) -> float:
    """Best-of-N wall time: ``fn(jitter)`` receives a fresh random
    relative perturbation scale per run, so no run repeats another's
    computation, and each timed region ends with a device synchronise
    and a scalar fetch."""
    rng = np.random.default_rng(time.time_ns() % (2**63))
    best = math.inf
    for _ in range(repeats):
        jitter = 1e-6 * rng.standard_normal()
        t0 = time.perf_counter()
        _fetch(fn(jitter))
        best = min(best, time.perf_counter() - t0)
    return best


def _device_counts(device_counts: Optional[Sequence[int]]) -> Sequence[int]:
    if device_counts is None:
        nd = _world_size()
        device_counts = [p for p in (1, 2, 4, 8, 16, 32, 64) if p <= nd]
    return device_counts


def strong_scaling(
    sizes: Sequence[int] = (1024, 2048, 4096, 8192),
    device_counts: Optional[Sequence[int]] = None,
    out_file: Optional[str] = None,
    *,
    fmt: str = "dense",
    tol: float = DEFAULT_TOLERANCE,
    repeats: int = 1,
    device="cuda",
) -> List[str]:
    """Strong-scaling sweep; returns (and optionally appends) CSV rows
    ``N,psize,seconds`` (strong_scaling.txt schema)."""
    dev = resolve_device(device)
    rows = []
    for n in sizes:
        dia = lap2d_reference(n)
        mat = dia.to_dense() if fmt == "dense" else dia
        b = source_term(n)
        for p in _device_counts(device_counts):
            mesh = make_mesh(p, device=dev)  # every rank takes part in a subgroup
            if not mesh.is_member:
                continue
            elapsed = _time_solve(
                lambda jit_eps: sharded_cg_solve(
                    mat, b * (1.0 + jit_eps), mesh=mesh, tol=tol
                ).x,
                repeats,
            )
            rows.append(f"{n},{p},{elapsed}")
    _maybe_write(out_file, rows)
    return rows


def weak_scaling(
    base_sizes: Sequence[int] = (1024, 1448, 2048),
    device_counts: Optional[Sequence[int]] = None,
    out_file: Optional[str] = None,
    *,
    fmt: str = "dense",
    maxiter: int = 200,
    repeats: int = 1,
    device="cuda",
) -> List[str]:
    """Weak-scaling ladders N(p) = N0 * sqrt(p), iterations fixed
    (cg.run:22-44 uses maxIter=200; work per device N^2/p constant)."""
    dev = resolve_device(device)
    rows = []
    for n0 in base_sizes:
        for p in _device_counts(device_counts):
            n = int(round(n0 * math.sqrt(p)))
            dia = lap2d_reference(n)
            mat = dia.to_dense() if fmt == "dense" else dia
            b = source_term(n)
            mesh = make_mesh(p, device=dev)
            if not mesh.is_member:
                continue
            elapsed = _time_solve(
                lambda jit_eps: sharded_cg_solve(
                    mat, b * (1.0 + jit_eps), mesh=mesh, maxiter=maxiter,
                    tol=0.0,
                ).x,
                repeats,
            )
            rows.append(f"{n},{p},{elapsed}")
    _maybe_write(out_file, rows)
    return rows


def kernel_sweep(
    n: int = 10000,
    threads: Sequence[int] = (8, 32, 128, 256, 512, 1024),
    block_widths: Sequence[int] = (128, 256, 512, 1024, 4096),
    out_file: Optional[str] = None,
    *,
    dtype=None,
    repeats: int = 2,
    device="cuda",
) -> List[str]:
    """Tile sweep of the dense mat-vec kernel (CUDA/cg.run phase 2's
    analogue: threads x BLOCK_WIDTH over the mat-vec). Times a single
    mat-vec rather than a full solve; schema ``threads,block_width,
    seconds`` (CUDA_T.txt). A configuration is skipped only where
    :func:`~cgx_torch.ops.matvec.dense_plan` refuses it."""
    from cgx_torch.bench.autotune import feasible
    from cgx_torch.ops.matvec import dense_matvec

    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32
    dia = lap2d_reference(n)
    a = torch.as_tensor(dia.to_dense(), dtype=dtype, device=dev).contiguous()
    x = torch.as_tensor(source_term(n), dtype=dtype, device=dev)
    rows = []
    for t in threads:
        tr = max(8, min(t, n))
        for bw in block_widths:
            bc = max(128, min(bw, n))
            if not feasible(n, bc, dtype, dev):
                continue
            fn = lambda jit_eps: dense_matvec(  # noqa: E731
                a, x * (1.0 + jit_eps), block_rows=tr, block_cols=bc,
            )
            _fetch(fn(0.0))  # first touch
            elapsed = _time_solve(fn, repeats)
            rows.append(f"{t},{bw},{elapsed}")
    _maybe_write(out_file, rows)
    return rows


def _maybe_write(out_file: Optional[str], rows: List[str]) -> None:
    if out_file and _is_writer():
        with open(out_file, "a") as f:
            for row in rows:
                f.write(row + "\n")

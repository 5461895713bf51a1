"""CLI driver with both reference grammars (counterpart of
``cgx/cli/main.py``).

MPI grammar (MPI/cg_main.cc:13-69):

    python -m cgx_torch.cli.main <N> <out.txt> [maxIter]

  generates the reference Laplacian of size N, solves it (dense by
  default) and appends the CSV row ``N,psize,elapsed``.

CUDA grammar (CUDA/cg_main.cc:16-63):

    python -m cgx_torch.cli.main <matrix.mtx> <NUM_THREADS> <BLOCK_WIDTH> \\
        <true|false> <out.txt>

  reads the MatrixMarket file and solves it dense. ``true`` runs the
  mat-vec through the dense CUDA kernel, its tiles mapped from
  (NUM_THREADS, BLOCK_WIDTH) as cgx maps them; ``false`` through
  ``torch.matmul``. Appends ``NUM_THREADS,BLOCK_WIDTH,elapsed``.

Options as cgx's, plus ``--device {cuda,cpu}`` (default ``cuda``, which
raises without a card). Both grammars print the reference's DEBUG line

    \\t[STEP k] residual = R, ||x|| = X, ||Ax - b||/||b|| = E

Where the port differs from cgx's CLI, by design:

- fp64 with ``true`` or ``--pallas`` runs the float64 kernel: cgx drops
  to XLA there only because Pallas on the TPU has no fp64;
- the dots of an fp32 run are fp32, as cgx's are when run from a shell
  (it takes fp64 dots only under ``jax_enable_x64``);
- on CUDA the kernels are built before the clock starts, and the clock
  stops after ``torch.cuda.synchronize()``, so ``elapsed`` is the solve.

``--method pipelined`` and ``--method sstep`` run as cgx branches them
(cli/main.py:341-377), the latter with ``--sstep-s``, ``--sstep-basis``,
``--sstep-powers`` and ``--sstep-replace-every`` passed through.
``--precond jacobi|block_jacobi|neumann|chebyshev|mg`` run as cgx builds
them (cli/main.py:285-340): ``block_jacobi`` with
``--precond-block-size`` (default min(32, N)), ``chebyshev`` degree 3 on
Lanczos bounds, ``mg`` a 2-D V-cycle with ``--mg-smoother`` and
``--mg-cycle`` (fp32 under ``--precision fp64`` runs the cycle in fp32);
``mg`` needs a banded operator (``--format dia``) and otherwise prints an
error and returns 1; neumann on a non-banded operator falls back to
jacobi with a warning. The ``[STEP k]`` line then shows
``residual_norm``, as cgx's does (cli/main.py:398-406).

``--devices P`` (P > 1) runs the sharded route
(:mod:`cgx_torch.parallel.sharded_cg`) with ``--strategy``, one process
per rank, as cgx's ``--devices`` does on one host (cli/main.py:197-240):

    torchrun --nproc-per-node P python -m cgx_torch.cli.main N out.txt --devices P

P must equal the world size. The process group is initialized from
torchrun's environment if it is not yet (NCCL on the card, gloo with
``--device cpu``), and destroyed again at the end. Rank 0 alone prints
and appends the CSV row, whose ``psize`` is P. ``--precond
jacobi|block_jacobi|neumann|chebyshev`` run there too, ``block_jacobi``
with ``--precond-block-size`` (default min(32, the shard size), a
divisor of the shard size).

``--method gvpipe`` and ``chebyshev`` (A11), ``--method sstep`` or
``--precond mg`` with ``--devices`` (A14) and ``--precision bf16`` (A6)
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cgx_torch.config import DEFAULT_TOLERANCE
from cgx_torch.mats.containers import COOMatrix, CSRMatrix, DIAMatrix, ELLMatrix
from cgx_torch.mats.generators import lap2d_reference, source_term
from cgx_torch.ops._util import resolve_device
from cgx_torch.solver.cg import CGResult, cg_solve
from cgx_torch.solver.chebyshev import spectral_bounds
from cgx_torch.solver.multigrid import mg_preconditioner
from cgx_torch.solver.operators import DiaOperator, PallasDenseOperator, as_operator
from cgx_torch.solver.pipelined import pipelined_cg_solve
from cgx_torch.solver.precond import block_jacobi, chebyshev_poly, jacobi, neumann_banded
from cgx_torch.solver.sstep import sstep_cg_solve

DEFAULT_TILES = (256, 512)  # dense_matvec's static defaults (cgx/bench/autotune.py:38)
_DTYPES = {"fp64": torch.float64, "fp32": torch.float32}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cgx-torch",
        description="conjugate-gradient solver on PyTorch and CUDA (reference-parity CLI)",
    )
    p.add_argument("positionals", nargs="+", help="reference-grammar positionals")
    p.add_argument("--format", dest="fmt", default=None,
                   choices=["dense", "dia", "ell", "csr"])
    p.add_argument("--precision", default="fp64", choices=["fp64", "fp32", "bf16"])
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--strategy", default="auto",
                   choices=["auto", "allgather", "reducescatter", "halo"])
    p.add_argument("--method", default="reference",
                   choices=["reference", "pipelined", "gvpipe", "chebyshev", "sstep"])
    p.add_argument("--precond", default=None,
                   choices=["jacobi", "block_jacobi", "neumann", "chebyshev", "mg"])
    p.add_argument("--precond-block-size", type=int, default=None)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--history", type=int, default=0)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--mg-smoother", default="richardson", choices=["richardson", "gs"])
    p.add_argument("--mg-cycle", default="fp64", choices=["fp32", "fp64"])
    p.add_argument("--sstep-s", type=int, default=4)
    p.add_argument("--sstep-basis", default="chebyshev", choices=["chebyshev", "newton"])
    p.add_argument("--sstep-powers", default="off", choices=["off", "deephalo", "pallas"])
    p.add_argument("--sstep-replace-every", type=int, default=2)
    p.add_argument("--gv-replace-every", type=int, default=25)
    p.add_argument("--no-debug", action="store_true")
    p.add_argument("--pallas", action="store_true",
                   help="run the dense mat-vec through the CUDA kernel")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solve runs (default cuda; raises without a card)")
    return p


class Run(NamedTuple):
    """What one CLI run did: its exit code and, when it solved, the
    operator, the result, the solve's seconds and the CSV row written."""

    rc: int
    op: object = None
    result: Optional[CGResult] = None
    seconds: float = float("nan")
    csv_row: str = ""


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to cgx_torch yet")


def run(argv=None) -> Run:
    """Parse ``argv``, solve and report, as :func:`main` does; return
    the :class:`Run` record."""
    args = _build_parser().parse_args(argv)
    pos = args.positionals
    if args.precision == "bf16":
        raise _unported("--precision bf16 (bf16 storage, ROADMAP A6)")
    if args.method in ("gvpipe", "chebyshev"):
        raise _unported(f"--method {args.method} (ROADMAP A11)")
    dev = resolve_device(args.device)
    dtype = _DTYPES[args.precision]
    tol = args.tol if args.tol is not None else DEFAULT_TOLERANCE
    tiles = None

    if _is_int(pos[0]):
        # ---- MPI grammar: N out.txt [maxIter] ----
        if len(pos) < 2:
            print("usage: cgx-torch <N> <out.txt> [maxIter]", file=sys.stderr)
            return Run(1)
        n = int(pos[0])
        out_file = pos[1]
        maxiter = int(pos[2]) if len(pos) >= 3 else args.maxiter
        mat = lap2d_reference(n)
        csv_row_fn = lambda psize, secs: f"{n},{psize},{secs}"  # noqa: E731
    else:
        # ---- CUDA grammar: mtx NT BW T out.txt ----
        if len(pos) < 5:
            print("usage: cgx-torch <matrix.mtx> <NUM_THREADS> <BLOCK_WIDTH> "
                  "<true|false> <out.txt>", file=sys.stderr)
            return Run(1)
        num_threads = _stoi(pos[1])
        block_width = _stoi(pos[2])
        out_file = pos[4]
        mat = COOMatrix.read(pos[0])
        n = mat.shape[0]
        maxiter = args.maxiter
        csv_row_fn = lambda psize, secs: f"{num_threads},{block_width},{secs}"  # noqa: E731
        if pos[3].strip().lower() == "true":
            args.pallas = True
            tiles = (num_threads, block_width)
    fmt = args.fmt or "dense"
    b_np = source_term(n)

    # the operator in the requested format, on the host
    if isinstance(mat, COOMatrix):
        host = {
            "dense": lambda: mat.to_dense(),
            "dia": lambda: DIAMatrix.from_coo(mat),
            "ell": lambda: ELLMatrix.from_coo(mat),
            "csr": lambda: CSRMatrix.from_coo(mat),
        }[fmt]()
    else:  # DIAMatrix from the generator
        host = {
            "dense": lambda: mat.to_dense(),
            "dia": lambda: mat,
            "ell": lambda: _dia_to_ell(mat),
            "csr": lambda: _dia_to_csr(mat),
        }[fmt]()

    if args.devices is not None and args.devices > 1:
        return _run_sharded(args, host, b_np, n, tol, maxiter, fmt, dev, csv_row_fn, out_file)

    if args.pallas and fmt == "dense":
        nt, bw = tiles or DEFAULT_TILES
        # the reference's NUM_THREADS x BLOCK_WIDTH sweep, clamped as cgx clamps it
        br = max(8, min((nt // 8) * 8 or 8, 1024))
        bc = max(128, min((bw // 128) * 128 or 128, 4096))
        op = PallasDenseOperator(torch.tensor(host, dtype=dtype, device=dev), br, bc)
    else:
        op = as_operator(host, dtype=dtype, device=dev)
    b = torch.tensor(b_np, dtype=dtype, device=dev)
    if dev.type == "cuda":
        from cgx_torch import _build

        _build.load()  # nvcc runs here, not inside the timed solve
        torch.cuda.synchronize(dev)
    if args.precond == "mg" and not isinstance(op, DiaOperator) and not isinstance(host,
                                                                                 DIAMatrix):
        print("error: --precond mg needs a banded grid operator (--format dia)", file=sys.stderr)
        return Run(1)

    t1 = time.perf_counter()
    pc = _precond(args, op, host, n, dtype, dev)
    if args.method == "pipelined":
        res = pipelined_cg_solve(op, b, tol=tol, maxiter=maxiter, history=args.history,
                                 precond=pc, device=dev)
    elif args.method == "sstep":
        if pc is not None:
            print("warning: sstep takes no preconditioner; ignoring", file=sys.stderr)
        res = sstep_cg_solve(op, b, tol=tol, maxiter=maxiter, s=args.sstep_s,
                             basis=args.sstep_basis, replace_every=args.sstep_replace_every,
                             powers=args.sstep_powers, device=dev)
    else:
        res = cg_solve(op, b, tol=tol, maxiter=maxiter, history=args.history, precond=pc,
                       device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t1
    row = _report(args, host, b_np, n, res, fmt, elapsed, csv_row_fn(1, elapsed), out_file)
    return Run(0, op, res, elapsed, row)


def _precond(args, op, host, n: int, dtype, dev):
    """The single-device preconditioner of ``--precond`` (cgx
    cli/main.py:285-340): jacobi; block_jacobi; chebyshev; mg on the
    banded operator (or the host DIA matrix), 2-D, its cycle in fp32 when
    ``--mg-cycle fp32`` meets ``--precision fp64``; neumann on a banded
    operator (two sweeps, as ``solve`` builds it; jacobi with a warning
    otherwise)."""
    name = args.precond
    if name is None:
        return None
    base = op if hasattr(op, "diagonal") else as_operator(host, dtype=dtype, device=dev)
    if name == "jacobi":
        return jacobi(base.diagonal())
    if name == "block_jacobi":
        return block_jacobi(base, args.precond_block_size or min(32, n), dtype=dtype)
    if name == "chebyshev":
        lo, hi = spectral_bounds(base, n)
        return chebyshev_poly(base.matvec, lo, hi, degree=3)
    if name == "mg":
        src = base if isinstance(base, DiaOperator) else host
        if args.mg_cycle == "fp32" and args.precision == "fp64":
            return mg_preconditioner(src, smoother=args.mg_smoother, dtype=torch.float32,
                                     device=dev).apply_mixed
        return mg_preconditioner(src, smoother=args.mg_smoother, device=dev).apply
    if isinstance(base, DiaOperator):
        return neumann_banded(base.bands, base.offsets, sweeps=2)
    print("warning: --precond neumann needs a banded operator; falling back to jacobi",
          file=sys.stderr)
    return jacobi(base.diagonal())


def _report(args, host, b_np, n: int, res: CGResult, fmt: str, elapsed: float, row: str,
            out_file: str) -> str:
    """The ``[STEP k]`` line, the time, and the CSV row appended."""
    if not args.no_debug:
        x = res.x.cpu().numpy().astype(np.float64)
        if n <= 20000:
            r_true = _as_dense_np(host) @ x - b_np
            rel = np.linalg.norm(r_true) / np.linalg.norm(b_np)
        else:
            rel = float("nan")
        # reference parity: sqrt(rsold), stale by one iteration (cg.cc:152); under a
        # preconditioner rsold is <r, z>, so the residual norm instead (cgx cli/main.py:398-406)
        if args.precond is None:
            shown = float(np.sqrt(res.rsold.cpu().numpy().astype(np.float64)))
        else:
            shown = float(res.residual_norm.cpu().numpy().astype(np.float64))
        print("\t[STEP {}] residual = {:e}, ||x|| = {:e}, ||Ax - b||/||b|| = {:e}".format(
            int(res.iterations), shown, float(np.linalg.norm(x)), rel))

    print(f"Time for CG ({fmt} solver)  = {elapsed} [s]")
    with open(out_file, "a") as f:
        f.write(row + "\n")
    return row


def _run_sharded(args, host, b_np, n: int, tol: float, maxiter, fmt: str, dev, csv_row_fn,
                 out_file: str) -> Run:
    """``--devices P``: the sharded solve on P ranks, this process one of
    them (cgx cli/main.py:197-240). Rank 0 reports."""
    import torch.distributed as dist

    from cgx_torch.parallel.mesh import make_mesh
    from cgx_torch.parallel.multihost import initialize_from_env
    from cgx_torch.parallel.sharded_cg import sharded_cg_solve

    if args.method == "sstep":
        raise _unported("--method sstep with --devices (the sharded s-step, ROADMAP A14)")
    if args.precond == "mg":
        raise _unported("--precond mg with --devices (mg_sharded, ROADMAP A14)")
    own_group = not dist.is_initialized()
    if own_group:
        if "WORLD_SIZE" not in os.environ and "SLURM_NTASKS" not in os.environ:
            raise ValueError(f"--devices {args.devices} runs one process a rank: start it as "
                             f"torchrun --nproc-per-node {args.devices} ...")
        initialize_from_env(backend="gloo" if dev.type == "cpu" else "nccl")
    try:
        world = dist.get_world_size()
        if world != args.devices:
            raise ValueError(f"--devices {args.devices} but the process group has {world} ranks")
        mesh = make_mesh(args.devices, device=dev)
        host_mat = host if isinstance(host, (DIAMatrix, ELLMatrix, CSRMatrix)) else (
            _as_dense_np(host))
        b_host = b_np if args.precision == "fp64" else b_np.astype(np.float32)
        if dev.type == "cuda":
            from cgx_torch import _build

            _build.load()  # nvcc runs here, not inside the timed solve
        dist.barrier()
        t1 = time.perf_counter()
        res = sharded_cg_solve(host_mat, b_host, mesh=mesh, strategy=args.strategy,
                               method=args.method, precond=args.precond,
                               precond_block_size=args.precond_block_size, tol=tol,
                               maxiter=maxiter, history=args.history)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t1
        row = ""
        if mesh.rank == 0:
            row = _report(args, host, b_np, n, res, fmt, elapsed,
                          csv_row_fn(args.devices, elapsed), out_file)
        return Run(0, host_mat, res, elapsed, row)
    finally:
        if own_group:
            dist.destroy_process_group()


def main(argv=None) -> int:
    """The CLI's entry point (``cgx-torch``); returns the exit code."""
    return run(argv).rc


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def _stoi(s: str) -> int:
    """std::stoi parity: parse the leading integer, ignore trailing junk
    (the reference's cg.run passes '2,'-style tokens)."""
    out = []
    for i, c in enumerate(s):
        if c.isdigit() or (i == 0 and c in "+-"):
            out.append(c)
        else:
            break
    if not out:
        raise ValueError(f"cannot parse integer from {s!r}")
    return int("".join(out))


def _as_dense_np(host) -> np.ndarray:
    if isinstance(host, np.ndarray):
        return host
    if isinstance(host, DIAMatrix):
        return host.to_dense()
    if isinstance(host, CSRMatrix):
        n = host.shape[0]
        dense = np.zeros(host.shape)
        rows = np.repeat(np.arange(n), np.diff(host.indptr))
        dense[rows, host.indices] = host.values
        return dense
    if isinstance(host, ELLMatrix):
        dense = np.zeros(host.shape)
        rows = np.repeat(np.arange(host.shape[0]), host.indices.shape[1])
        # add.at: ELL padding points at column 0 with value 0, which may
        # coincide with a real (i, 0) entry
        np.add.at(dense, (rows, host.indices.ravel()), host.values.ravel())
        return dense
    raise TypeError(type(host))


def _dia_coo(dia: DIAMatrix) -> COOMatrix:
    dense = dia.to_dense()
    rows, cols = np.nonzero(dense)
    return COOMatrix(dia.shape, rows.astype(np.int32), cols.astype(np.int32), dense[rows, cols])


def _dia_to_ell(dia: DIAMatrix) -> ELLMatrix:
    return ELLMatrix.from_coo(_dia_coo(dia))


def _dia_to_csr(dia: DIAMatrix) -> CSRMatrix:
    return CSRMatrix.from_coo(_dia_coo(dia))


if __name__ == "__main__":
    sys.exit(main())

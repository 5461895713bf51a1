"""Checkpoint and resume for long CG solves (counterpart of
``cgx/utils/checkpoint.py``; the reference keeps the solver state in RAM
for one solve() call only).

CG state is small (three vectors and two scalars), so a checkpoint is an
``.npz`` file in cgx's format: ``x``, ``r``, ``p`` (NumPy arrays in the
vectors' dtype; bfloat16 vectors are written as float32, which holds
them exactly), ``rsold`` (a float) and ``k`` (an int), written to a
temporary name in the target directory and renamed into place. A file
that either package writes, the other resumes.

:func:`cg_solve_resumable` runs a solve in segments of the reference
recurrence, writes a checkpoint after each and resumes from the file
when it exists at entry. ``maxiter`` counts the whole solve, the
iterations of the checkpoint included, so calling again with a larger
``maxiter`` on the same path is the resume. The restart is exact: the
recurrence continues from the saved (x, r, p, rsold), so a resumed
solve follows the uninterrupted one bit for bit.

:func:`sharded_cg_solve_resumable` does the same on a mesh, one process
a rank (:mod:`cgx_torch.parallel`): every rank reads the checkpoint at
entry, and after each segment rank 0 alone writes the global, unpadded
vectors while the others wait at a barrier. A checkpoint moves between
the single-device and the sharded solve, and between mesh sizes.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.cg import _CHUNK, CGResult, _as_matvec, as_vector


@dataclasses.dataclass
class CGCheckpoint:
    """Resumable CG state: (x, r, p, rsold, k)."""

    x: np.ndarray
    r: np.ndarray
    p: np.ndarray
    rsold: float
    k: int

    def save(self, path) -> None:
        path = os.fspath(path)
        d = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                np.savez(f, x=self.x, r=self.r, p=self.p,
                         rsold=self.rsold, k=self.k)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @classmethod
    def load(cls, path) -> "CGCheckpoint":
        with np.load(path) as z:
            return cls(
                x=z["x"], r=z["r"], p=z["p"],
                rsold=float(z["rsold"]), k=int(z["k"]),
            )


def _op_matvec(tree, x):
    return tree.matvec(x)


def segment_loop(tree, x, r, p, rsold, tol, nz, *, budget: int,
                 matvec=None, dot=None, marks=None):
    """``budget`` reference-recurrence CG iterations from explicit state,
    or fewer where the test ``sqrt(<r, r>) < tol`` stops it (cgx's
    ``segment_loop``: the alpha clamp ``rsold / max(<p, Ap>, rsold nz)``
    and break-before-update). Returns cgx's 8-tuple ``(k, x, r, p,
    rsold, rsnew, conv, brk)`` of tensors, ``k`` the iterations that did
    not converge.

    ``matvec(tree, v)`` defaults to ``tree.matvec(v)`` and ``dot`` to
    :func:`~cgx_torch.ops.reduce.vdot`; the sharded entry passes its
    strategy mat-vec and an all-reduced dot. The host reads ``conv``
    once every 32 iterations; an iteration that runs after convergence
    inside those 32 is frozen: x, r, p, rsold, rsnew and k keep their
    values. ``marks`` as for :func:`cgx_torch.solver.cg.run_recurrence`."""
    if matvec is None:
        matvec = _op_matvec
    if dot is None:
        dot = vdot
    dev = x.device
    tol = torch.as_tensor(tol, dtype=rsold.dtype, device=dev)
    nz = torch.as_tensor(nz, dtype=rsold.dtype, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    # a zero initial residual would make alpha 0/0 (see cg.py)
    conv = (torch.sqrt(rsold) < tol) | (rsold == 0)
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    rsnew = rsold
    done = 0  # iterations run; while none converged, equal to k
    with f32_exact():
        while done < budget and not bool(conv):  # the one host read per chunk
            steps = min(_CHUNK, budget - done)
            for _ in range(steps):
                if marks is not None:
                    marks.next_iteration()
                active = ~conv
                ap = matvec(tree, p)
                conj = dot(p, ap)
                brk = brk | (active & (conj <= 0))
                alpha = (rsold / torch.maximum(conj, rsold * nz)).to(x.dtype)
                x = torch.where(active, x + alpha * p, x)
                r = torch.where(active, r - alpha * ap, r)
                rs = dot(r, r)
                c = torch.sqrt(rs) < tol
                keep = ~active | c
                p = torch.where(keep, p, r + (rs / rsold).to(x.dtype) * p)
                rsold = torch.where(keep, rsold, rs)
                k = torch.where(keep, k, k + 1)
                rsnew = torch.where(active, rs, rsnew)
                conv = conv | c
            done += steps
    if marks is not None:
        marks.end_loop()
    return k, x, r, p, rsold, rsnew, conv, brk


def _host_vector(v: torch.Tensor) -> np.ndarray:
    """A vector as NumPy in its dtype (bfloat16 as float32, exactly)."""
    v = v.detach()
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()


def _result(x, total_k: int, rsnew, conv, rsold, brk, dtype) -> CGResult:
    dev = x.device
    return CGResult(
        x=x,
        iterations=torch.tensor(total_k, dtype=torch.int32, device=dev),
        residual_norm=torch.sqrt(rsnew),
        converged=torch.as_tensor(conv, device=dev),
        rsold=rsold,
        history=torch.zeros((0,), dtype=dtype, device=dev),
        breakdown=torch.as_tensor(brk, device=dev),
    )


def cg_solve_resumable(
    op,
    b,
    checkpoint_path,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    segment: int = 100,
    device="cuda",
) -> CGResult:
    """CG with periodic checkpointing.

    Runs in ``segment``-iteration slices; after each slice the state is
    written atomically to ``checkpoint_path``. If the file exists at
    entry, the solve resumes from it (its vectors cast to ``b``'s
    dtype). ``op`` is an operator with ``.matvec``, a 2-D tensor or a
    callable, its tensors on ``device``; ``b`` a tensor there or NumPy.
    The start state is x = 0, r = b - A x, p = r, rsold = <r, p>.
    """
    dev = resolve_device(device)
    b = as_vector(b, dev, "b")
    mv = _as_matvec(op, dev)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n
    tol_ = torch.tensor(tol, dtype=b.dtype, device=dev)
    nz_ = torch.tensor(nearzero, dtype=b.dtype, device=dev)

    with f32_exact():
        if os.path.exists(checkpoint_path):
            ck = CGCheckpoint.load(checkpoint_path)
            x, r, p = (torch.tensor(v, dtype=b.dtype, device=dev) for v in (ck.x, ck.r, ck.p))
            rsold = torch.tensor(ck.rsold, dtype=b.dtype, device=dev)
            total_k = ck.k
        else:
            x = torch.zeros_like(b)
            r = b - mv(x)
            p = r
            rsold = vdot(r, p)
            total_k = 0

    conv = torch.zeros((), dtype=torch.bool, device=dev)
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    rsnew = rsold
    while total_k < maxiter and not bool(conv):
        budget = min(segment, maxiter - total_k)
        k, x, r, p, rsold, rsnew, conv, brk_s = segment_loop(
            None, x, r, p, rsold, tol_, nz_, budget=int(budget),
            matvec=lambda _tree, v: mv(v))
        brk = brk | brk_s
        total_k += int(k)
        CGCheckpoint(
            x=_host_vector(x), r=_host_vector(r), p=_host_vector(p),
            rsold=float(rsold), k=total_k,
        ).save(checkpoint_path)
    return _result(x, total_k, rsnew, conv, rsold, brk, b.dtype)


def sharded_cg_solve_resumable(
    mat,
    b,
    checkpoint_path,
    *,
    mesh=None,
    n_devices: Optional[int] = None,
    strategy: str = "auto",
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    segment: int = 100,
    device=None,
) -> CGResult:
    """Row-block-sharded CG with periodic checkpointing, called by every
    rank of the mesh with the same host ``mat`` and ``b``.

    The segments of :func:`cg_solve_resumable`, on this rank's rows:
    each iteration is the strategy's mat-vec (its exchange) and two
    all-reduces, one a dot, as cgx's segment is (its ``_PsumDot``), all
    through :mod:`cgx_torch.utils.collectives`. The start state is r =
    p = b and rsold = <b, b> with one all-reduce (x0 = 0). After each
    segment x, r and p are gathered; rank 0 writes them, unpadded, in
    the single-device format, and every rank waits at a barrier. Every
    rank returns the whole x. ``mesh`` defaults to
    ``make_mesh(n_devices)`` over the process group (one rank with no
    group); ``device`` to the mesh's.
    """
    from cgx_torch.mats.containers import COOMatrix, CSRMatrix
    from cgx_torch.parallel import sharded_cg as sc
    from cgx_torch.parallel.mesh import ROWS_AXIS
    from cgx_torch.parallel.partition import padded_size
    from cgx_torch.utils import collectives

    mesh, dev = sc._member_mesh(mesh, n_devices, device, ROWS_AXIS)
    b_np = sc._host(b)
    if b_np.dtype not in (np.float32, np.float64):
        b_np = b_np.astype(np.float64)
    dtype = torch.float32 if b_np.dtype == np.float32 else torch.float64
    n = b_np.shape[0]
    if maxiter is None:
        maxiter = n
    n_pad = padded_size(n, mesh.size)
    n_loc = n_pad // mesh.size
    if isinstance(mat, COOMatrix):
        mat = CSRMatrix.from_coo(mat)
    # cgx's resumable entry builds its operator with the plain local product
    mv, _diag, _strategy, _kernel = sc._build_op(mat, n, n_pad, n_loc, mesh, dtype, dev,
                                                 strategy, "emulated", "xla")
    dot = sc._PsumDot(mesh, None)

    def _vec(host_vec):
        return sc._row_block(np.asarray(host_vec, b_np.dtype), n_pad, mesh, n_loc, dtype, dev)

    collectives.begin_program()
    with f32_exact():
        if os.path.exists(checkpoint_path):
            ck = CGCheckpoint.load(checkpoint_path)
            if ck.x.shape[0] != n:
                raise ValueError(
                    f"checkpoint is for N={ck.x.shape[0]}, problem has N={n}"
                )
            x, r, p = _vec(ck.x), _vec(ck.r), _vec(ck.p)
            rsold = torch.tensor(ck.rsold, dtype=dtype, device=dev)
            total_k = ck.k
        else:
            # x0 = 0 (reference drivers): r = b, p = b, rsold = <b, b>
            x = torch.zeros(n_loc, dtype=dtype, device=dev)
            r = p = _vec(b_np)
            rsold = dot(r, r)
            total_k = 0

    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    nz_ = torch.tensor(nearzero, dtype=dtype, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    rsnew = rsold
    x_full = None
    while total_k < maxiter and not bool(conv):
        budget = min(segment, maxiter - total_k)
        collectives.begin_program()
        k, x, r, p, rsold, rsnew, conv, brk_s = segment_loop(
            None, x, r, p, rsold, tol_, nz_, budget=int(budget),
            matvec=lambda _tree, v: mv(v), dot=dot, marks=collectives)
        brk = brk | brk_s
        total_k += int(k)
        collectives.begin_output()
        x_full, r_full, p_full = (collectives.all_gather(v, mesh)[:n] for v in (x, r, p))
        if mesh.rank == 0:
            CGCheckpoint(
                x=_host_vector(x_full), r=_host_vector(r_full), p=_host_vector(p_full),
                rsold=float(rsold), k=total_k,
            ).save(checkpoint_path)
        if mesh.group is not None:
            dist.barrier(group=mesh.group)
    if x_full is None:
        collectives.begin_output()
        x_full = collectives.all_gather(x, mesh)[:n]
    return _result(x_full, total_k, rsnew, conv, rsold, brk, dtype)

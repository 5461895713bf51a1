"""Banded CG through the hand-written CUDA kernels (counterpart of
``cgx/solver/fast.py``).

Per iteration this launches exactly three kernels:

    1. (Ap, conj)      <- dia_matvec_dot(bands, p)   [(ndiag+2)N traffic]
    2. (x', r', rsnew) <- fused_update_rs(...)       [4N read, 2N write]
    3. p'              <- fused_axpby(p, r, beta, 1) [2N read, 1N write]

16N words an iteration for a 5-band operator. The scalar recurrence
(:func:`cgx_torch.solver.cg.run_recurrence`) stays on the device, and
the kernels read alpha and beta through device pointers. Vectors,
scalars and dots are all in the operator's dtype, float32 or float64,
as in cgx's loop. The start residual ``b - A x0`` takes ``dia_matvec``:
cgx used ``dia_matvec_dot`` there and dropped the dot. Unlike cgx's
loop, the bands are not padded: the kernel tests bounds instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.axpy import fused_axpby, fused_update_rs
from cgx_torch.ops.dia_spmv import dia_matvec, dia_matvec_dot
from cgx_torch.solver.cg import CGResult, as_vector, run_recurrence
from cgx_torch.solver.operators import DiaOperator


def dia_cg_solve_pallas(
    op: DiaOperator,
    b,
    x0=None,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    history: int = 0,
    device="cuda",
) -> CGResult:
    """CG on a banded operator with the three-kernel loop, in the
    operator's dtype (float32 or float64). Same name and recurrence as
    cgx's; ``block`` and ``interpret`` were TPU launch knobs and are gone.
    """
    dev = resolve_device(device)
    if not isinstance(op, DiaOperator):
        raise TypeError(f"dia_cg_solve_pallas needs a DiaOperator, got {type(op)}")
    bands, offsets = op.bands, tuple(op.offsets)
    b = as_vector(b, dev, "b")
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    if bands.dtype != b.dtype:
        raise TypeError(f"bands are {bands.dtype} but b is {b.dtype}")

    def mv_dot(p):
        return dia_matvec_dot(bands, p, offsets=offsets)

    with f32_exact():
        r = b - dia_matvec(bands, x0, offsets=offsets)
        return run_recurrence(
            x0, r, torch.sum(r * r),
            mv_dot=mv_dot, update=fused_update_rs, axpby=fused_axpby,
            tol=torch.tensor(tol, dtype=b.dtype, device=dev),
            nearzero=torch.tensor(nearzero, dtype=b.dtype, device=dev),
            maxiter=b.shape[0] if maxiter is None else int(maxiter),
            history=int(history),
        )

"""Mixed-precision iterative refinement (counterpart of
``cgx/solver/refine.py``): fp32 inner CG, fp64 outer sweeps.

    outer (fp64):  r = b - A x        # true residual
    inner (fp32):  A d ~= r / ||r||   # loose tolerance, unit-norm right-hand side
    outer:         x <- x + ||r|| d   # fp64 accumulation

:func:`refine_fixed_sweeps` runs its inner solves on the whole-solve
kernel (B5, :mod:`cgx_torch.ops.cg_kernel`) with the in-kernel Neumann
preconditioner; :func:`iterative_refinement` picks its inner by the
resident budget: B5, B5 with bfloat16 bands, or the streaming
Neumann-PCG kernel (B6, :mod:`cgx_torch.ops.cg_stream`).
``refine_pcg_sweeps`` and its ``_dd`` and ``_tw`` variants are not ported
yet (ROADMAP A9, A12).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cgx_torch import config
from cgx_torch.config import DEFAULT_TOLERANCE
from cgx_torch.ops._util import resolve_device
from cgx_torch.ops.cg_kernel import (
    LAYOUTS,
    _dia_cg_vmem,
    _dia_cg_vmem2d,
    dia_cg_solve_vmem,
    resident_state_bytes,
)
from cgx_torch.ops.cg_stream import dia_cg_solve_stream_pcg
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.cg import as_vector, cg_solve
from cgx_torch.solver.fast import dia_cg_solve_pallas
from cgx_torch.solver.operators import DenseOperator, DiaOperator


class RefineResult(NamedTuple):
    x: torch.Tensor  # fp64 solution
    outer_iterations: int
    inner_iterations: torch.Tensor  # int32 per-sweep inner counts
    residual_norm: torch.Tensor  # true fp64 ||b - A x||
    converged: torch.Tensor


class _LowPrecisionView:
    """Wrap an fp64 operator, casting through the given dtype."""

    def __init__(self, op, dtype):
        self.op = op
        self.dtype = dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.matvec(x.to(torch.float64)).to(self.dtype)


def iterative_refinement(
    op64,
    b64,
    *,
    inner_dtype=torch.float32,
    tol: float = DEFAULT_TOLERANCE,
    rtol: float = 1e-11,
    max_outer: int = 8,
    inner_tol_factor: float = 1e-6,
    inner_maxiter: Optional[int] = None,
    use_pallas: bool = False,
    inner_op=None,
    device="cuda",
) -> RefineResult:
    """Solve ``A x = b`` to an fp64 true residual with low-precision
    inner CG; converged when ``||b - A x|| < max(tol, rtol ||b||)``.

    With ``use_pallas`` and a banded operator the inner solve is, as in
    cgx (refine.py:142-156), the whole-solve kernel with its Neumann
    preconditioner while its state fits
    :data:`cgx_torch.config.RESIDENT_BUDGET_BYTES`; then the same kernel
    with bfloat16 bands (a nearby SPD inner matrix, which the fp64 outer
    corrects for) while that fits; then the streaming Neumann-PCG kernel
    when the bands hold offset 0; else the three-kernel loop. ``block``
    and ``interpret`` were TPU knobs and are gone."""
    dev = resolve_device(device)
    b64 = as_vector(b64, dev, "b64", torch.float64)
    n = b64.shape[0]
    if inner_maxiter is None:
        inner_maxiter = n

    if inner_op is not None:
        op_lo = inner_op
    elif isinstance(op64, DiaOperator):
        op_lo = DiaOperator(op64.bands.to(inner_dtype), tuple(op64.offsets))
    elif isinstance(op64, DenseOperator):
        op_lo = DenseOperator(op64.a.to(inner_dtype))
    else:
        op_lo = None

    x = torch.zeros_like(b64)
    inner_counts = []
    outer = 0
    b_norm = float(torch.sqrt(vdot(b64, b64)))
    target = max(tol, rtol * b_norm)
    for outer in range(1, max_outer + 1):
        r64 = b64 - op64.matvec(x)
        res_norm = torch.sqrt(vdot(r64, r64))
        if float(res_norm) < target:
            outer -= 1
            break
        # the correction problem scaled to unit norm centres fp32's range
        r_lo = (r64 / res_norm).to(inner_dtype)
        inner_tol = max(inner_tol_factor, 1.2e-7)
        if use_pallas and isinstance(op_lo, DiaOperator):
            itemsize = torch.finfo(inner_dtype).bits // 8
            ndiag = op_lo.bands.shape[0]
            state = resident_state_bytes(ndiag, n, itemsize, itemsize, precond=True)
            state_bf16 = resident_state_bytes(ndiag, n, 2, itemsize, precond=True)
            if state <= config.RESIDENT_BUDGET_BYTES:
                inner = dia_cg_solve_vmem(op_lo, r_lo, tol=inner_tol, maxiter=inner_maxiter,
                                          chunk=min(512, inner_maxiter), precond=True,
                                          layout="2d", device=dev)
            elif itemsize == 4 and state_bf16 <= config.RESIDENT_BUDGET_BYTES:
                inner = dia_cg_solve_vmem(op_lo, r_lo, tol=inner_tol, maxiter=inner_maxiter,
                                          chunk=min(512, inner_maxiter), precond=True,
                                          bands_dtype=torch.bfloat16, layout="2d", device=dev)
            elif itemsize == 4 and 0 in tuple(op_lo.offsets):
                inner = dia_cg_solve_stream_pcg(op_lo, r_lo, tol=inner_tol,
                                                maxiter=inner_maxiter, device=dev)
            else:
                inner = dia_cg_solve_pallas(op_lo, r_lo, tol=inner_tol, maxiter=inner_maxiter,
                                            device=dev)
        else:
            view = op_lo if op_lo is not None else _LowPrecisionView(op64, inner_dtype)
            inner = cg_solve(view, r_lo, tol=inner_tol, maxiter=inner_maxiter, device=dev)
        inner_counts.append(int(inner.iterations))
        x = x + res_norm * inner.x.to(torch.float64)

    r64 = b64 - op64.matvec(x)
    res_norm = torch.sqrt(vdot(r64, r64))
    return RefineResult(
        x=x,
        outer_iterations=outer,
        inner_iterations=torch.tensor(inner_counts, dtype=torch.int32, device=dev),
        residual_norm=res_norm,
        converged=res_norm < target,
    )


def refine_fixed_sweeps(
    op64: DiaOperator,
    b64,
    *,
    sweeps: int = 4,
    rtol: float = 1e-11,
    inner_tol: float = 1e-6,
    inner_maxiter: Optional[int] = None,
    chunk: int = 512,
    precond: bool = True,
    layout: str = "1d",
    cols: int = 512,
    device="cuda",
) -> RefineResult:
    """Up to ``sweeps`` refinement sweeps with the whole-solve fp32 (P)CG
    kernel as the inner solver, stopping once the fp64 true residual is
    below ``rtol ||b||``: the body of cgx's ``_refine_sweeps_jit``
    (refine.py:203-257) as a host loop that reads the fp64 residual norm
    once a sweep. Each inner solve gets the unit-norm residual."""
    dev = resolve_device(device)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    b64 = as_vector(b64, dev, "b64", torch.float64)
    n = b64.shape[0]
    inner_maxiter = n if inner_maxiter is None else int(inner_maxiter)
    offsets = tuple(op64.offsets)
    bands32 = op64.bands.to(torch.float32)
    tiny = torch.finfo(torch.float64).tiny
    target = rtol * float(torch.sqrt(vdot(b64, b64)))

    x = torch.zeros_like(b64)
    r64 = b64
    rnorm = torch.sqrt(vdot(b64, b64))
    k = 0
    while float(rnorm) >= target and k < sweeps:  # the one host read a sweep
        safe = torch.clamp(rnorm, min=tiny)
        r32 = (r64 / safe).to(torch.float32)
        common = dict(offsets=offsets, maxiter=inner_maxiter, chunk=int(chunk),
                      precond=bool(precond))
        if layout == "2d":
            inner = _dia_cg_vmem2d(bands32, r32, inner_tol, 1e-14, cols=int(cols), **common)
        else:
            inner = _dia_cg_vmem(bands32, r32, inner_tol, 1e-14, **common)
        x = x + safe * inner.x.to(torch.float64)
        r64 = b64 - op64.matvec(x)
        rnorm = torch.sqrt(vdot(r64, r64))
        k += 1
    return RefineResult(
        x=x,
        outer_iterations=k,
        inner_iterations=torch.zeros((k,), dtype=torch.int32, device=dev),
        residual_norm=rnorm,
        converged=rnorm < target,
    )

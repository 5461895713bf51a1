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
:func:`refine_pcg_sweeps` and its ``_dd`` and ``_tw`` variants run a
preconditioned fp32 inner (an fp32 multigrid V-cycle, say) in plain
torch, as cgx's run ``cg_loop``; their outer accumulates the solution
in fp64, in double-double fp64 pairs (:mod:`cgx_torch.ops.dd`) or in
triple-word float32 (:mod:`cgx_torch.ops.tw32`), so that the last two
certify a true residual below fp64's evaluation floor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from cgx_torch import config
from cgx_torch.config import DEFAULT_TOLERANCE
from cgx_torch.ops import dd, tw32
from cgx_torch.ops._util import check_device, f32_exact, resolve_device
from cgx_torch.ops.cg_kernel import (
    LAYOUTS,
    _dia_cg_vmem,
    _dia_cg_vmem2d,
    dia_cg_solve_vmem,
    resident_state_bytes,
)
from cgx_torch.ops.cg_stream import dia_cg_solve_stream_pcg
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.cg import CGResult, as_vector, cg_loop, cg_solve
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


# ---------------------------------------------------------------------------
# Refinement around a preconditioned inner (cgx refine.py:319-767)
# ---------------------------------------------------------------------------


def _pcg_inner(mv: Callable, r_lo: torch.Tensor, precond: Optional[Callable], inner_tol: float,
               inner_maxiter: int) -> CGResult:
    """cgx's inner solve of the PCG sweeps (refine.py:351-362): the
    reference recurrence from zero on the unit-norm right-hand side, its
    dots in the inner dtype (``dot_precision=None``, not ``solve``'s fp64
    dots for fp32), the alpha clamp at 1e-14, at full float32."""
    dt, dev = r_lo.dtype, r_lo.device
    with f32_exact():
        return cg_loop(mv, r_lo, torch.zeros_like(r_lo),
                       dots=lambda pairs: tuple(vdot(u, v) for u, v in pairs),
                       precond=precond, tol=torch.tensor(inner_tol, dtype=dt, device=dev),
                       nearzero=torch.tensor(1e-14, dtype=dt, device=dev),
                       maxiter=int(inner_maxiter), history=0)


def _pcg_setup(op64: DiaOperator, b64, tol: float, rtol: float, device):
    """The device, b64 and the target ``max(tol, rtol ||b||)`` of a
    PCG-sweeps call."""
    dev = resolve_device(device)
    check_device(op64.bands, dev, "the operator's bands")
    b64 = as_vector(b64, dev, "b64", torch.float64)
    return dev, b64, torch.clamp(rtol * torch.sqrt(vdot(b64, b64)), min=float(tol))


def refine_pcg_sweeps(
    op64: DiaOperator,
    b64,
    *,
    precond: Optional[Callable],
    sweeps: int = 8,
    rtol: float = 1e-11,
    tol: float = 0.0,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 400,
    inner_dtype=torch.float32,
    device="cuda",
) -> RefineResult:
    """Mixed-precision refinement with a preconditioned fp32 CG inner
    (cgx ``refine_pcg_sweeps``): each sweep hands the unit-norm fp64
    residual to the inner solve with ``precond`` (e.g. ``mg_preconditioner(
    op, dtype=torch.float32).apply``), adds the correction in fp64 and
    forms the fp64 true residual, until ``||b - A x|| < max(tol, rtol
    ||b||)`` or ``sweeps`` sweeps. cgx runs it as one XLA program; here
    the host reads the residual once a sweep (and the inner's
    ``converged`` at its own cadence). ``inner_iterations`` holds the
    total of the inner counts."""
    dev, b64, target = _pcg_setup(op64, b64, tol, rtol, device)
    op_lo = DiaOperator(op64.bands.to(inner_dtype), tuple(op64.offsets))
    tiny = torch.finfo(torch.float64).tiny
    x = torch.zeros_like(b64)
    r64, rnorm = b64, torch.sqrt(vdot(b64, b64))
    k, inner_total = 0, torch.zeros((), dtype=torch.int32, device=dev)
    while k < sweeps and bool(rnorm >= target):  # the one host read a sweep
        safe = torch.clamp(rnorm, min=tiny)
        inner = _pcg_inner(op_lo.matvec, (r64 / safe).to(inner_dtype), precond, inner_tol,
                           inner_maxiter)
        x = x + safe * inner.x.to(torch.float64)
        r64 = b64 - op64.matvec(x)
        rnorm = torch.sqrt(vdot(r64, r64))
        k += 1
        inner_total = inner_total + inner.iterations
    return RefineResult(x=x, outer_iterations=k, inner_iterations=inner_total.reshape(1),
                        residual_norm=rnorm, converged=rnorm < target)


class DDRefineResult(NamedTuple):
    x_hi: torch.Tensor  # fp64 leading word of the solution pair
    x_lo: torch.Tensor  # fp64 trailing word (x = x_hi + x_lo, unevaluated)
    outer_iterations: int
    inner_iterations: torch.Tensor  # int32, (1,): the total of the inner counts
    residual_norm: torch.Tensor  # dd-evaluated true ||b - A x||
    converged: torch.Tensor
    residual_history: torch.Tensor  # per-sweep dd ||r|| (nan: the sweep did not run)

    @property
    def x(self) -> torch.Tensor:  # the fp64 view
        return self.x_hi


def refine_pcg_sweeps_dd(
    op64: DiaOperator,
    b64,
    *,
    precond: Optional[Callable],
    sweeps: int = 10,
    rtol: float = 1e-12,
    tol: float = 0.0,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 400,
    inner_dtype=torch.float32,
    device="cuda",
) -> DDRefineResult:
    """:func:`refine_pcg_sweeps` with a double-double outer (cgx
    ``refine_pcg_sweeps_dd``): the solution is an unevaluated fp64 pair,
    each correction added by an error-free sum, and each sweep's true
    residual evaluated in double-double (:func:`cgx_torch.ops.dd.
    residual_dd`), so refinement goes on below fp64's evaluation floor.
    ``residual_norm`` is that dd-evaluated ``||b - A (x_hi + x_lo)||``.
    Valid where fp64 is IEEE: the CPU and the H100 (cgx's TPU is not)."""
    dev, b64, target = _pcg_setup(op64, b64, tol, rtol, device)
    op_lo = DiaOperator(op64.bands.to(inner_dtype), tuple(op64.offsets))
    bands64, offsets = op64.bands, tuple(op64.offsets)
    tiny = torch.finfo(torch.float64).tiny
    x_hi = torch.zeros_like(b64)
    x_lo = torch.zeros_like(b64)
    r_hi, rnorm = b64, torch.sqrt(vdot(b64, b64))
    hist = torch.full((int(sweeps),), float("nan"), dtype=torch.float64, device=dev)
    k, inner_total = 0, torch.zeros((), dtype=torch.int32, device=dev)
    while k < sweeps and bool(rnorm >= target):  # the one host read a sweep
        safe = torch.clamp(rnorm, min=tiny)
        # the correction needs only fp32 accuracy: the leading residual word
        # sits about 1e16 above the pair's floor
        inner = _pcg_inner(op_lo.matvec, (r_hi / safe).to(inner_dtype), precond, inner_tol,
                           inner_maxiter)
        c = safe * inner.x.to(torch.float64)
        s, e = dd.two_sum(x_hi, c)  # x + c by an error-free sum, element by element
        x_hi2 = s + (e + x_lo)
        x_lo = (s - x_hi2) + (e + x_lo)
        x_hi = x_hi2
        (r_hi, _), rnorm = dd.residual_dd(bands64, offsets, b64, x_hi, x_lo)
        hist[k] = rnorm
        k += 1
        inner_total = inner_total + inner.iterations
    return DDRefineResult(x_hi=x_hi, x_lo=x_lo, outer_iterations=k,
                          inner_iterations=inner_total.reshape(1), residual_norm=rnorm,
                          converged=rnorm < target, residual_history=hist)


class TWRefineResult(NamedTuple):
    x_words: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # x = w0 + w1 + w2, float32
    outer_iterations: int
    inner_iterations: torch.Tensor  # int32, (1,): the total of the inner counts
    residual_norm: torch.Tensor  # tw-evaluated true ||b - A x||
    converged: torch.Tensor
    residual_history: torch.Tensor  # per-sweep tw ||r|| (nan: the sweep did not run)

    @property
    def x(self) -> torch.Tensor:  # the fp64 view (rounded to fp64)
        return tw32.tw_to_f64(self.x_words)

    @property
    def x_hi(self) -> torch.Tensor:
        return self.x


def refine_pcg_sweeps_tw(
    op64: DiaOperator,
    b64,
    *,
    precond: Optional[Callable] = None,
    sweeps: int = 16,
    rtol: float = 1e-12,
    tol: float = 0.0,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 400,
    inner_dtype=torch.float32,
    device="cuda",
) -> TWRefineResult:
    """:func:`refine_pcg_sweeps` with a triple-word float32 outer (cgx
    ``refine_pcg_sweeps_tw``, ``bench.py``'s fp64-quality flagship): the
    solution is an unevaluated float32 triple, each correction ``||r||
    d`` added exactly (the scale rounded to float32 first, which only
    perturbs it by about 6e-8, absorbed by the next sweep), and each
    sweep's true residual evaluated in triple words (:func:`cgx_torch.
    ops.tw32.residual_tw`) against the float32 bands where they are the
    fp64 bands exactly, else against their exact three-word split.
    ``residual_norm`` is that tw-evaluated ``||b - A x||``."""
    dev, b64, target = _pcg_setup(op64, b64, tol, rtol, device)
    offsets = tuple(op64.offsets)
    bands32 = op64.bands.to(torch.float32)
    op_lo = DiaOperator(bands32.to(inner_dtype), offsets)  # through float32, as cgx
    outer_bands = bands32 if tw32.bands_f32_exact(op64.bands) else tw32.split_bands_tw(
        op64.bands)
    b_tw = tw32.tw_from_f64(b64)
    tiny = torch.finfo(torch.float64).tiny
    x = tw32.tw_zero_like(b64)
    r0, rnorm = b_tw[0], torch.sqrt(vdot(b64, b64))
    hist = torch.full((int(sweeps),), float("nan"), dtype=torch.float64, device=dev)
    k, inner_total = 0, torch.zeros((), dtype=torch.int32, device=dev)
    while k < sweeps and bool(rnorm >= target):  # the one host read a sweep
        safe32 = torch.clamp(rnorm, min=tiny).to(torch.float32)
        # the correction needs only fp32 accuracy: the leading residual word
        # sits about 1e21 above the triple's floor
        inner = _pcg_inner(op_lo.matvec, (r0 / safe32).to(inner_dtype), precond, inner_tol,
                           inner_maxiter)
        d32 = inner.x.to(torch.float32)
        zeros = torch.zeros_like(d32)
        x = tw32.tw_add_tw(x, tw32.tw_scale_f32((d32, zeros, zeros), safe32))
        r_tw, rnorm = tw32.residual_tw(outer_bands, offsets, b_tw, x)
        r0 = r_tw[0]
        hist[k] = rnorm
        k += 1
        inner_total = inner_total + inner.iterations
    return TWRefineResult(x_words=x, outer_iterations=k, inner_iterations=inner_total.reshape(1),
                          residual_norm=rnorm, converged=rnorm < target, residual_history=hist)

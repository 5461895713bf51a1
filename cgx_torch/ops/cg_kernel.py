"""Whole-solve banded CG: CUDA kernel B5 and its plain version.

Counterpart of ``cgx/ops/cg_kernel.py``. One launch of the kernel
(``cgx_torch/csrc/cg_kernel.cu``, whose header note gives the bound and
the design) runs a chunk of iterations of the reference recurrence on a
persistent cooperative grid, on float32, float64 or bfloat16 vectors
(cgx's TPU kernel has float32 and bfloat16). The dots sum in float64
and the scalar state, packed as ``[rsold, converged, k, breakdown]``,
stays in float64: for
float32 data that is the arithmetic of ``cg_solve(...,
dot_precision=torch.float64)``, the plain loop of
``solve(precision="fp32")`` (cgx's kernel keeps float32 scalars; the
kernel's note says why the port does not). The host chains chunks until
``converged`` or ``k >= maxiter``, reading the packed scalars once per
chunk, as cgx's ``while_loop`` does.

The kernel has two designs, picked by :func:`resident_plan`:
"resident" (state on chip across the chunk: x, r and Ap in registers,
p, c and where room allows the bands in shared memory, one block an SM)
where a block's vectors fit, else "global" (the state in device memory,
the design before). Pass ``plan=GLOBAL_PLAN`` (or a plan of your own) to
:func:`dia_cg_chunk` to force one; ``dia_cg_chunk.plan`` records the last
CUDA call's.

cgx has two TPU kernels for this, ``_dia_cg_vmem`` (``layout="1d"``) and
``_dia_cg_vmem2d`` (``layout="2d"``, vectors as (rows, cols) planes);
they differ only in TPU layout, so one CUDA kernel over flat vectors
serves both. The port keeps ``layout`` and ``cols`` in the signatures,
validates them as cgx does, and counts launches per layout in
``dia_cg_chunk.launches``. On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs :func:`dia_cg_chunk_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from cgx_torch._build import PARTIALS
from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import (
    NARROW_BANDS,
    band_dtypes,
    band_storage,
    check_operands,
    count_build,
    entry_suffix,
    launch,
    SHARED_OPTIN,
    resolve_device,
    round_up,
    sms_of,
    vector_dtypes,
)
from cgx_torch.ops.dia_spmv import _check, _offsets_arg, dia_matvec, dia_matvec_ref
from cgx_torch.solver.cg import CGResult, as_vector
from cgx_torch.utils import timer

LAYOUTS = ("1d", "2d")
SITES = {"1d": "dia_cg_vmem", "2d": "dia_cg_vmem2d"}  # the cgx site each layout stands for
_PARTIALS = 3 * PARTIALS  # the kernel's <p, Ap>, <r, r> and <r, z> partials, one per block


RES_THREADS = 512  # kResThreads of csrc/cg_kernel.cu: one block an SM
# rows a thread keeps in registers (x, r and Ap each), by the vectors' dtype: the
# kernel is built for these
RES_ROWS_PER_THREAD = {torch.float32: (4, 8, 16), torch.float64: (4, 8),
                       torch.bfloat16: (4, 8, 16)}
RES_STATIC = 1024  # shared bytes kept for the kernel's static shared memory (the block sums)


class ResidentPlan(NamedTuple):
    """How the whole-solve kernel runs. ``design`` is "resident" or
    "global". For the resident design: ``grid`` blocks (one an SM), each
    on ``rows`` contiguous rows (the last on fewer), RES_THREADS threads
    with ``rows_per_thread`` rows each in registers; the halo, ``left``
    rows below a block and ``right`` above, that its products read;
    ``bands_shared``: the block's bands in shared memory too; ``shared``
    bytes a block (the bands where they are there, then p, and c with the
    preconditioner, over the rows and halo)."""

    design: str
    grid: int
    rows: int
    rows_per_thread: int
    left: int
    right: int
    bands_shared: bool
    shared: int

    def as_arg(self):
        """The plan array of csrc/cg_kernel.cu launch_resident, and its length."""
        vals = (RES_THREADS, self.rows, self.rows_per_thread, self.left, self.right,
                int(self.bands_shared), self.shared)
        return (ctypes.c_longlong * len(vals))(*vals), len(vals)


GLOBAL_PLAN = ResidentPlan("global", 0, 0, 0, 0, 0, False, 0)  # its grid is set in C


@functools.lru_cache(maxsize=64)
def resident_plan(n: int, offsets: Tuple[int, ...], dtype: torch.dtype,
                  bands_dtype: torch.dtype, precond: bool, sms: int) -> ResidentPlan:
    """The whole-solve kernel's design on n rows. One block an SM (fewer
    where n is smaller), each on ceil(n / sms) rows. The rule: "resident"
    where a thread's rows fit the register arrays the kernel is built
    for (RES_ROWS_PER_THREAD) and p (and c) over a block's rows and halo
    fit its shared memory, the bands too where they also fit; else
    "global". At N = 1,000,000 with 5 bands, 7,576 rows a block (16 a
    thread): float32 bands and vectors take 189,824 bytes, with the
    preconditioner 228,128, so both keep the bands on chip, as do bfloat16
    bands; float64 vectors need 16 rows a thread and run "global"."""
    offsets = tuple(int(o) for o in offsets)
    item = torch.finfo(dtype).bits // 8
    band_item = torch.finfo(bands_dtype).bits // 8
    grid0 = max(1, min(sms, n))
    rows = -(-n // grid0)
    grid = -(-n // rows)
    per_thread = next((r for r in RES_ROWS_PER_THREAD[dtype] if r * RES_THREADS >= rows), None)
    if per_thread is None:
        return GLOBAL_PLAN
    left, right = max(0, -min(offsets)), max(0, max(offsets))
    vectors = (rows + left + right) * item * (2 if precond else 1)
    bands = round_up(len(offsets) * rows * band_item, 16)
    for bands_shared, shared in ((True, bands + vectors), (False, vectors)):
        if shared + RES_STATIC <= SHARED_OPTIN:
            return ResidentPlan("resident", grid, rows, per_thread, left, right, bands_shared,
                                shared)
    return GLOBAL_PLAN


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """<u, v> in float64, as the kernel sums its dots: exact products,
    bfloat16 ones included."""
    return torch.sum(u.to(torch.float64) * v.to(torch.float64))


_ENTRIES = ("cgx_dia_cg_chunk", "cgx_dia_cg_resident")  # B5's two designs


def resident_state_bytes(
    ndiag: int,
    n: int,
    bands_itemsize: int,
    vec_itemsize: int,
    *,
    precond: bool = False,
) -> int:
    """Device bytes one whole-solve run keeps live: the bands, the x, r,
    p and Ap vectors (and c = D^-1 r with ``precond``), the partials of
    the three dots and the packed scalars in and out (all float64).
    Replaces cgx's ``vmem2d_scoped_bytes``; compared against
    :data:`cgx_torch.config.RESIDENT_BUDGET_BYTES` by the dispatches of
    ``solve`` and the refinement."""
    vec_units = 5 if precond else 4
    return n * (ndiag * bands_itemsize + vec_units * vec_itemsize) + (_PARTIALS + 8) * 8


def _diag_index(offsets: Sequence[int]) -> int:
    if 0 not in offsets:
        raise ValueError(f"the Neumann preconditioner needs offset 0 in the band set, got {offsets}")
    return offsets.index(0)


def dia_cg_chunk_ref(
    bands: torch.Tensor,
    p: torch.Tensor,
    x: torch.Tensor,
    r: torch.Tensor,
    scal: torch.Tensor,
    *,
    offsets: Sequence[int],
    tol: float,
    nearzero: float,
    maxiter: int,
    chunk: int,
    precond: bool = False,
) -> torch.Tensor:
    """Plain version of one chunk: ``chunk`` iterations of the body of
    cgx's ``_chunk_kernel`` (cg_kernel.py:120-162) in torch, with its
    frozen-iteration rules. Every iteration is computed; x and r are
    written only while active, p, rsold and k only while active and not
    converging. Advances p, x and r in place; returns the new
    ``[rsold, converged, k, breakdown]`` (float64). Dots and scalars are
    float64; alpha and beta round to the data's dtype where they scale
    vectors, as in the kernel and in ``cg_solve(dot_precision=float64)``.
    bfloat16 or float16 bands widen exactly to the vectors' dtype, as in
    the kernel."""
    offsets = tuple(int(o) for o in offsets)
    bands = bands.to(x.dtype)

    def s(v, dtype=torch.float64):
        return torch.tensor(v, dtype=dtype, device=x.device)

    tol_t, maxiter_t, one = s(tol), s(maxiter), s(1.0)
    nearzero_t = s(nearzero, x.dtype)  # as cg_solve holds it; rsold * nearzero is float64
    invd = 1.0 / bands[_diag_index(offsets)] if precond else None
    rsold, conv, k, brk = scal.clone().unbind()
    pv, xv, rv = p, x, r
    for _ in range(chunk):
        active = (conv == 0) & (k < maxiter_t)
        ap = dia_matvec_ref(bands, pv, offsets=offsets)
        conj = _dot(pv, ap)
        brk = torch.where(active & (conj <= 0), one, brk)
        alpha = (rsold / torch.maximum(conj, rsold * nearzero_t)).to(x.dtype)
        x_new = xv + alpha * pv
        r_new = rv - alpha * ap
        rr = _dot(r_new, r_new)
        conv_now = torch.sqrt(rr) < tol_t
        if precond:
            c = invd * r_new
            new_dir = 2.0 * c - invd * dia_matvec_ref(bands, c, offsets=offsets)
            rsnew = _dot(r_new, new_dir)
        else:
            new_dir, rsnew = r_new, rr
        p_next = new_dir + (rsnew / rsold).to(x.dtype) * pv
        xv = torch.where(active, x_new, xv)
        rv = torch.where(active, r_new, rv)
        advance = active & ~conv_now
        pv = torch.where(advance, p_next, pv)
        rsold = torch.where(advance, rsnew, rsold)
        k = torch.where(advance, k + one, k)
        conv = torch.where(active & conv_now, one, conv)
    p.copy_(pv)
    x.copy_(xv)
    r.copy_(rv)
    return torch.stack([rsold, conv, k, brk])


def _check_chunk(bands, p, x, r, scal, offsets, layout) -> Tuple[int, ...]:
    dtypes = vector_dtypes(*_ENTRIES)
    offsets = _check("dia_cg_chunk", bands, x, offsets, narrow=band_dtypes(*_ENTRIES),
                     dtypes=dtypes)
    check_operands("dia_cg_chunk", {"p": p, "x": x, "r": r}, dtypes=dtypes)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if not (isinstance(scal, torch.Tensor) and scal.shape == (4,) and scal.dtype == torch.float64
            and scal.device == x.device and scal.is_contiguous()):
        raise ValueError("dia_cg_chunk: scal must be a contiguous float64 (4,) tensor on x's device")
    return offsets


def _launch_chunk(bands, p, x, r, scal, offsets, tol, nearzero, maxiter, chunk, precond,
                  plan: Optional[ResidentPlan], empty: bool = False) -> torch.Tensor:
    """One launch of the kernel in ``plan``'s design (default
    :func:`resident_plan`); returns the new scalars."""
    d0 = _diag_index(offsets) if precond else -1
    n = x.shape[0]
    if plan is None:
        plan = resident_plan(n, offsets, x.dtype, bands.dtype, bool(precond), sms_of(x.device))
    partials = torch.empty(_PARTIALS, dtype=torch.float64, device=x.device)
    out = torch.empty_like(scal)
    suffix = entry_suffix(x.dtype, bands.dtype)
    common = (scal.data_ptr(), out.data_ptr(), n, _offsets_arg(offsets), len(offsets), d0,
              float(tol), float(torch.tensor(nearzero, dtype=x.dtype)), float(maxiter), int(chunk),
              int(precond))
    if plan.design == "resident":
        pub = torch.empty((6 if precond else 4) * n, dtype=x.dtype, device=x.device)
        bar = torch.zeros(1, dtype=torch.int32, device=x.device)  # the grid barrier's count
        arg, arg_len = plan.as_arg()
        launch("cgx_dia_cg_resident", x, bands.data_ptr(), p.data_ptr(), x.data_ptr(),
               r.data_ptr(), pub.data_ptr(), partials.data_ptr(), _PARTIALS, bar.data_ptr(),
               *common, arg, arg_len, plan.grid, int(empty), suffix=suffix)
        dia_cg_chunk.grid = plan.grid
    else:
        if empty:
            raise ValueError("the sync floor is a launch of the resident design")
        ap = torch.empty_like(x)
        c = torch.empty_like(x) if precond else None
        grid = ctypes.c_int(0)
        launch("cgx_dia_cg_chunk", x, bands.data_ptr(), p.data_ptr(), x.data_ptr(), r.data_ptr(),
               ap.data_ptr(), None if c is None else c.data_ptr(), partials.data_ptr(), _PARTIALS,
               *common, ctypes.byref(grid), suffix=suffix)
        dia_cg_chunk.grid = grid.value
    dia_cg_chunk.plan = plan
    return out


def dia_cg_chunk(
    bands: torch.Tensor,
    p: torch.Tensor,
    x: torch.Tensor,
    r: torch.Tensor,
    scal: torch.Tensor,
    *,
    offsets: Sequence[int],
    tol: float,
    nearzero: float,
    maxiter: int,
    chunk: int,
    precond: bool = False,
    layout: str = "1d",
    plan: Optional[ResidentPlan] = None,
) -> torch.Tensor:
    """Up to ``chunk`` CG iterations in one launch of the whole-solve
    kernel. Advances p, x and r in place and returns the new packed
    scalars ``[rsold, converged, k, breakdown]`` (a float64 (4,) tensor).
    ``layout`` names the cgx site the call stands for (:data:`SITES`) and
    picks the launch counter, in ``launches`` and by build in
    ``BUILD_LAUNCHES``; the kernel is the same. ``bands`` are in the vectors'
    dtype (float32, float64 or bfloat16), or bfloat16 or float16 under
    float32 vectors. On a CUDA tensor the kernel runs ``plan``'s design (default
    :func:`resident_plan`)."""
    offsets = _check_chunk(bands, p, x, r, scal, offsets, layout)
    if x.device.type == "cpu":
        out = dia_cg_chunk_ref(bands, p, x, r, scal, offsets=offsets, tol=tol, nearzero=nearzero,
                               maxiter=maxiter, chunk=chunk, precond=precond)
    else:
        out = _launch_chunk(bands, p, x, r, scal, offsets, tol, nearzero, maxiter, chunk, precond,
                            plan)
    dia_cg_chunk.launches[layout] += 1
    count_build(SITES[layout], x.dtype, bands.dtype)
    return out


dia_cg_chunk.launches = {layout: 0 for layout in LAYOUTS}
dia_cg_chunk.grid = None  # blocks of the last CUDA launch
dia_cg_chunk.plan = None  # the ResidentPlan of the last CUDA launch


def resident_sync_floor(bands, p, x, r, scal, *, offsets: Sequence[int], chunk: int,
                        precond: bool = False, plan: Optional[ResidentPlan] = None) -> None:
    """One launch of the resident design that runs ``chunk`` iterations of
    its grid syncs and ordered sums only (no vector is read or written):
    the fixed cost an on-chip design cannot go below, for
    ``chip_smoke.py`` to time. CUDA only; counts no launch."""
    offsets = _check_chunk(bands, p, x, r, scal, offsets, "1d")
    if x.device.type != "cuda":
        raise ValueError("resident_sync_floor: the sync floor is a measurement on the card")
    _launch_chunk(bands, p, x, r, scal, offsets, 0.0, 1e-14, 10**9, chunk, precond, plan,
                  empty=True)


def _solve(bands, b, *, offsets, tol, nearzero, maxiter, chunk, precond, layout,
           plan=None) -> CGResult:
    """cgx's _dia_cg_vmem set-up (cg_kernel.py:189-243) and its chunk
    loop, from x0 = 0, on flat vectors; every chunk in ``plan``'s design
    (default :func:`resident_plan`'s; checks pass ``GLOBAL_PLAN``)."""
    offsets = tuple(int(o) for o in offsets)
    if bands.dtype != b.dtype and not (b.dtype == torch.float32 and bands.dtype in NARROW_BANDS):
        raise TypeError(f"bands are {bands.dtype} but b is {b.dtype}")
    x = torch.zeros_like(b)
    r = b.clone()
    rr0 = _dot(b, b)
    if precond:
        # p0 = z0 = M^-1 b = 2 c0 - D^-1 A c0 with c0 = D^-1 b, through kernel B1
        # on the (widened) bands the kernel streams
        bw = bands.to(b.dtype)
        invd = 1.0 / bw[_diag_index(offsets)]
        c0 = invd * b
        p = 2.0 * c0 - invd * dia_matvec(bw, c0, offsets=offsets)
        del bw
        rsold0 = _dot(b, p)
    else:
        p = b.clone()
        rsold0 = rr0
    # a zero start residual would make alpha 0/0 inside the kernel
    pre_conv = (torch.sqrt(rr0) < tol) | (rr0 == 0)
    zero = torch.zeros((), dtype=torch.float64, device=b.device)
    scal = torch.stack([rsold0, pre_conv.to(torch.float64), zero, zero])
    with timer.read():
        _, converged, k, _ = scal.tolist()  # the one host read per chunk
    with timer.loop():
        while converged == 0.0 and k < maxiter:
            with timer.enqueue(dia_cg_chunk):
                scal = dia_cg_chunk(bands, p, x, r, scal, offsets=offsets, tol=tol,
                                    nearzero=nearzero, maxiter=maxiter, chunk=chunk,
                                    precond=precond, layout=layout, plan=plan)
            with timer.read():
                _, converged, k, _ = scal.tolist()
    return CGResult(
        x=x,
        iterations=scal[2].to(torch.int32),
        residual_norm=torch.sqrt(_dot(r, r)),
        converged=scal[1] == 1.0,
        rsold=scal[0],
        history=torch.zeros((0,), dtype=torch.float64, device=b.device),
        breakdown=scal[3] == 1.0,
    )


def _dia_cg_vmem(bands, b, tol, nearzero, *, offsets, maxiter: int, chunk: int,
                 precond: bool = False) -> CGResult:
    """Site ``cg_kernel.py:245`` on raw bands (for the refinement)."""
    return _solve(bands, b, offsets=offsets, tol=tol, nearzero=nearzero, maxiter=maxiter,
                  chunk=chunk, precond=precond, layout="1d")


def _dia_cg_vmem2d(bands, b, tol, nearzero, *, offsets, maxiter: int, chunk: int, cols: int,
                   precond: bool = False) -> CGResult:
    """Site ``cg_kernel.py:479`` on raw bands (for the refinement). The
    planes were a TPU tiling; ``cols`` changes nothing here."""
    return _solve(bands, b, offsets=offsets, tol=tol, nearzero=nearzero, maxiter=maxiter,
                  chunk=chunk, precond=precond, layout="2d")


def dia_cg_solve_vmem(
    op,
    b,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    chunk: int = 64,
    precond: bool = False,
    bands_dtype=None,
    layout: str = "1d",
    cols: int = 512,
    device="cuda",
) -> CGResult:
    """CG on a banded operator, a chunk of iterations per kernel launch.

    ``op`` is a :class:`cgx_torch.DiaOperator` of float32, float64 or
    bfloat16; ``b`` a tensor on ``device`` (or NumPy) of the same dtype.
    ``precond=True`` runs PCG with the degree-1 Neumann preconditioner
    inside the kernel (one more band pass an iteration); then ``rsold``
    holds <r, z>, not <r, r>. ``layout`` is ``"1d"`` or ``"2d"`` (cgx's
    two sites; the same kernel here) and ``cols`` the 2-D plane width,
    kept for cgx's signature. cgx's TPU guard against VMEM capacity has
    no counterpart: the resident budget only routes ``solve``.
    ``bands_dtype=torch.bfloat16`` or ``torch.float16`` (float32 only)
    streams the bands in that dtype: the solve then runs on the rounded
    operator, exact for stencil constants and a nearby SPD matrix
    otherwise (the refinement's inner, cgx cg_kernel.py:549-582)."""
    dev = resolve_device(device)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if int(cols) < 1:
        raise ValueError(f"cols must be positive, got {cols}")
    b = as_vector(b, dev, "b")
    n = b.shape[0]
    bands = op.bands
    storage = band_storage(b.dtype, bands_dtype)
    if storage is not None:
        bands = bands.to(storage)
    common = dict(offsets=tuple(op.offsets), maxiter=n if maxiter is None else int(maxiter),
                  chunk=int(chunk), precond=bool(precond))
    if layout == "2d":
        return _dia_cg_vmem2d(bands, b, tol, nearzero, cols=int(cols), **common)
    return _dia_cg_vmem(bands, b, tol, nearzero, **common)

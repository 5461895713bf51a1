"""Whole-solve banded CG: CUDA kernel B5 and its plain version.

Counterpart of ``cgx/ops/cg_kernel.py``. One launch of the kernel
(``cgx_torch/csrc/cg_kernel.cu``, whose header note gives the bound and
the design) runs a chunk of iterations of the reference recurrence on a
persistent cooperative grid, on float32 or float64 vectors (cgx's TPU
kernel has float32 only). The dots sum in float64 and the scalar state,
packed as ``[rsold, converged, k, breakdown]``, stays in float64: for
float32 data that is the arithmetic of ``cg_solve(...,
dot_precision=torch.float64)``, the plain loop of
``solve(precision="fp32")`` (cgx's kernel keeps float32 scalars; the
kernel's note says why the port does not). The host chains chunks until
``converged`` or ``k >= maxiter``, reading the packed scalars once per
chunk, as cgx's ``while_loop`` does.

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
from typing import Optional, Sequence

import torch

from cgx_torch._build import PARTIALS
from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import (
    BF16_BANDS_SUFFIX,
    KERNEL_DTYPES,
    band_storage,
    check_operands,
    launch,
    resolve_device,
)
from cgx_torch.ops.dia_spmv import _check, _offsets_arg, dia_matvec, dia_matvec_ref
from cgx_torch.solver.cg import CGResult, as_vector

LAYOUTS = ("1d", "2d")
_PARTIALS = 3 * PARTIALS  # the kernel's <p, Ap>, <r, r> and <r, z> partials, one per block


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """<u, v> in float64, as the kernel sums its dots."""
    return torch.sum(u.to(torch.float64) * v.to(torch.float64))


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
    bfloat16 bands widen exactly to the vectors' dtype, as in the kernel."""
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
) -> torch.Tensor:
    """Up to ``chunk`` CG iterations in one launch of the whole-solve
    kernel. Advances p, x and r in place and returns the new packed
    scalars ``[rsold, converged, k, breakdown]`` (a float64 (4,) tensor).
    ``layout`` names the cgx site the call stands for and picks the
    launch counter (``launches_bf16`` counts those with bfloat16 bands
    again); the kernel is the same. ``bands`` are in the vectors'
    dtype, or bfloat16 under float32 vectors."""
    offsets = _check("dia_cg_chunk", bands, x, offsets, bf16_bands=True)
    check_operands("dia_cg_chunk", {"p": p, "x": x, "r": r})
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if not (isinstance(scal, torch.Tensor) and scal.shape == (4,) and scal.dtype == torch.float64
            and scal.device == x.device and scal.is_contiguous()):
        raise ValueError("dia_cg_chunk: scal must be a contiguous float64 (4,) tensor on x's device")
    d0 = _diag_index(offsets) if precond else -1
    if x.device.type == "cpu":
        out = dia_cg_chunk_ref(bands, p, x, r, scal, offsets=offsets, tol=tol, nearzero=nearzero,
                               maxiter=maxiter, chunk=chunk, precond=precond)
    else:
        ap = torch.empty_like(x)
        c = torch.empty_like(x) if precond else None
        partials = torch.empty(_PARTIALS, dtype=torch.float64, device=x.device)
        out = torch.empty_like(scal)
        grid = ctypes.c_int(0)
        launch("cgx_dia_cg_chunk", x, bands.data_ptr(), p.data_ptr(), x.data_ptr(), r.data_ptr(),
               ap.data_ptr(), None if c is None else c.data_ptr(), partials.data_ptr(), _PARTIALS,
               scal.data_ptr(), out.data_ptr(), x.shape[0], _offsets_arg(offsets), len(offsets),
               d0, float(tol), float(torch.tensor(nearzero, dtype=x.dtype)), float(maxiter),
               int(chunk), int(precond),
               ctypes.byref(grid), suffix=(BF16_BANDS_SUFFIX if bands.dtype == torch.bfloat16
                                           else KERNEL_DTYPES[x.dtype]))
        dia_cg_chunk.grid = grid.value
    dia_cg_chunk.launches[layout] += 1
    if bands.dtype == torch.bfloat16:
        dia_cg_chunk.launches_bf16[layout] += 1
    return out


dia_cg_chunk.launches = {layout: 0 for layout in LAYOUTS}
dia_cg_chunk.launches_bf16 = {layout: 0 for layout in LAYOUTS}  # those with bfloat16 bands
dia_cg_chunk.grid = None  # blocks of the last CUDA launch


def _solve(bands, b, *, offsets, tol, nearzero, maxiter, chunk, precond, layout) -> CGResult:
    """cgx's _dia_cg_vmem set-up (cg_kernel.py:189-243) and its chunk
    loop, from x0 = 0, on flat vectors."""
    offsets = tuple(int(o) for o in offsets)
    if bands.dtype != b.dtype and not (bands.dtype == torch.bfloat16 and b.dtype == torch.float32):
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
    _, converged, k, _ = scal.tolist()  # the one host read per chunk
    while converged == 0.0 and k < maxiter:
        scal = dia_cg_chunk(bands, p, x, r, scal, offsets=offsets, tol=tol, nearzero=nearzero,
                            maxiter=maxiter, chunk=chunk, precond=precond, layout=layout)
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

    ``op`` is a :class:`cgx_torch.DiaOperator` of float32 or float64;
    ``b`` a tensor on ``device`` (or NumPy) of the same dtype.
    ``precond=True`` runs PCG with the degree-1 Neumann preconditioner
    inside the kernel (one more band pass an iteration); then ``rsold``
    holds <r, z>, not <r, r>. ``layout`` is ``"1d"`` or ``"2d"`` (cgx's
    two sites; the same kernel here) and ``cols`` the 2-D plane width,
    kept for cgx's signature. cgx's TPU guard against VMEM capacity has
    no counterpart: the resident budget only routes ``solve``.
    ``bands_dtype=torch.bfloat16`` (float32 only) streams the bands in
    bfloat16: the solve then runs on the rounded operator, exact for
    stencil constants and a nearby SPD matrix otherwise (the
    refinement's inner, cgx cg_kernel.py:549-582)."""
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

"""The s-step matrix-powers kernel B9 and its plain version (counterpart
of ``cgx/ops/dia_powers.py``).

``dia_sstep_basis_planes`` builds the (2s+1, n) Krylov basis
``[T_0..T_s(A)p, T_0..T_{s-1}(A)r]`` of a banded operator (Chebyshev on
(theta, delta), or scaled Newton with ``shifts``) in one launch of the
kernel in ``cgx_torch/csrc/dia_powers.cu``, whose header note gives the
bound and the designs; :func:`dia_sstep_basis_ref` is the plain version,
the 2s-1 mat-vecs of :func:`cgx_torch.solver.sstep.basis_columns_fn`,
which the kernel equals bit for bit. On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs the plain
version. It counts its calls in ``.launches``.

:func:`basis_plan` is the host-side plan of the basis generator that B9
and both launches of the fused s-step block (B10,
:mod:`cgx_torch.ops.sstep_stream`) share: the wavefront design
(``csrc/sstep_basis.cuh`` ``gen_wave``, every level in a ring in shared
memory) where its rings fit one block's shared memory, else the slab
design (each level a pass through a block-private scratch in device
memory). :func:`slab_plan` forces the latter.

cgx's TPU kernel reads halo'd (rows, cols) planes of the bands, built
once per solve by ``sstep_powers_band_planes``. The CUDA kernel reads the
flat (ndiag, n) bands, so the port's "planes" are the bands made
contiguous; ``rows`` and ``cols`` are validated as cgx validates them
(``cols % 128``) and otherwise unused. :func:`_powers_geometry` is cgx's
TPU plane geometry, which no CUDA kernel needs; it keeps cgx's API, and
its tests hold it to cgx's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

import torch

from cgx_torch.ops._util import (
    MIN_TILE,
    SHARED_OPTIN,
    check_operands,
    launch,
    round_up,
    slab_grid,
    sms_of,
)
from cgx_torch.ops.cg_stream import LANES
from cgx_torch.ops.dia_spmv import _check as _check_bands
from cgx_torch.ops.dia_spmv import _offsets_arg, dia_matvec_ref

MAX_S = 16  # kMaxS of csrc/sstep_basis.cuh
BLOCKS_PER_SM = 2  # the slab design's grid: each block owns one slab of about n / grid rows
# The wavefront design (csrc/sstep_basis.cuh gen_wave)
WAVE_THREADS = 512  # kWaveThreads: one block an SM, and W, the rows a level advances a step
WAVE_MAX_S = 4  # kWaveMaxS: the Gram's 45 float64 sums of s = 4 in two threads' registers
WAVE_STATIC = 2048  # of them kept for a kernel's static shared memory (slots, coefficients)
GRAM_SLAB_SHARED = 64 * 1024  # kGramShared: the slab design's Gram sub-tile


def sublanes(dtype: torch.dtype) -> int:
    """Rows of cgx's TPU sublane tile for ``dtype`` (8 for 32-bit)."""
    return 8 * 4 // (torch.finfo(dtype).bits // 8)


def _powers_geometry(offsets, s: int, rows: int, cols: int, dtype, n: int):
    """cgx's TPU geometry ``(n_p, p_rows, p_halo, m_rows, pm, height)``:
    the margins in (rows, cols) planes, rounded to the sublane tile."""
    wp, wr = s + 1, s
    n_p = round_up(n, rows * cols)
    p_rows = max(abs(o) // cols + 1 for o in offsets)
    sub = sublanes(dtype)
    p_halo = round_up(max(wp - 1, wr - 1) * p_rows, sub)
    m_rows = round_up(p_rows, sub)
    pm = p_halo + m_rows
    return n_p, p_rows, p_halo, m_rows, pm, rows + 2 * pm


def _check_layout(rows: int, cols: int) -> None:
    if int(cols) % LANES != 0:
        raise ValueError(f"cols must be a multiple of {LANES}, got {cols}")
    if int(rows) < 1:
        raise ValueError(f"rows must be positive, got {rows}")


def sstep_powers_band_planes(bands: torch.Tensor, *, offsets, s: int, rows: int = 256,
                             cols: int = 512, align_dtype=None) -> torch.Tensor:
    """The bands as :func:`dia_sstep_basis_planes` reads them, built once
    per solve: contiguous (ndiag, n). ``rows``, ``cols`` and
    ``align_dtype`` are cgx's TPU plane layout, validated only."""
    _check_layout(rows, cols)
    if not 1 <= int(s) <= MAX_S:
        raise ValueError(f"s must be in 1..{MAX_S}, got {s}")
    return bands.contiguous()


def dia_sstep_basis_ref(bands: torch.Tensor, p: torch.Tensor, r: torch.Tensor, *,
                        offsets: Sequence[int], s: int, theta: float, delta: float,
                        shifts: Tuple[float, ...] = ()) -> torch.Tensor:
    """Plain (2s+1, n) basis: the p-chain of width s+1, then the r-chain of
    width s, by 2s-1 plain mat-vecs (bands widened to p's dtype)."""
    from cgx_torch.solver.sstep import basis_columns_fn

    bw = bands.to(p.dtype)
    offsets = tuple(int(o) for o in offsets)
    cols = basis_columns_fn(lambda v: dia_matvec_ref(bw, v, offsets=offsets), p.dtype, theta,
                            delta, tuple(shifts))
    return torch.stack(cols(p, s + 1) + cols(r, s))


class BasisPlan(NamedTuple):
    """How a basis kernel runs. ``design`` is "wavefront" or "slab".
    For the wavefront: ``width`` W, the consumer's lag ``lag_use`` (the
    frontier), each level's ``lags``, ``rings`` (values) and
    ``ring_offsets`` in basis order (p-chain, then r-chain). ``shared``:
    dynamic shared bytes a block (the slab design's Gram sub-tile);
    ``grid`` blocks, each on one ``slab`` of rows."""

    design: str
    width: int
    lag_use: int
    lags: Tuple[int, ...]
    rings: Tuple[int, ...]
    ring_offsets: Tuple[int, ...]
    shared: int
    grid: int
    slab: int

    def as_arg(self):
        """The plan array of csrc/sstep_basis.cuh make_wave_plan, and its length."""
        vals = (self.width, self.lag_use, self.slab, self.shared, *self.lags, *self.rings,
                *self.ring_offsets)
        return (ctypes.c_longlong * len(vals))(*vals), len(vals)


def level_of(l: int, s: int) -> Tuple[int, int]:
    """Level l of the basis (p-chain, then r-chain) as (index in its
    chain, the chain's width)."""
    return (l, s + 1) if l <= s else (l - s - 1, s)


def wave_schedule(s: int, reach: int, width: int):
    """``(lag_use, lags, rings)`` of the wavefront. Level k >= 1 of the
    p-chain lags the p-chain's level 1 by (k - 1)(R + W); the r-chain one
    level later, so that both chains' tops lag (s - 1)(R + W); the
    consumer (the Gram's products, the recover's combinations, B9's
    stores) reads one step behind the tops; the copies of level 0 one step
    ahead of it. A ring holds its level from the newest row it writes back
    to the oldest row a reader still reads in the same step: the next
    level's stencil (its lag + R), the three-term step two levels up, the
    consumer."""
    R, W = int(reach), int(width)
    lag_use = (s - 1) * (R + W) + W

    def lag(k: int, chain_width: int) -> int:
        if k == 0:
            return lag_use - W
        return (k - 1 + (chain_width == s)) * (R + W)

    lags, rings = [], []
    for l in range(2 * s + 1):
        k, cw = level_of(l, s)
        readers = [lag_use]
        if k >= 1 and k + 1 < cw:
            readers.append(lag(k + 1, cw) + R)
        if k >= 1 and k + 2 < cw:
            readers.append(lag(k + 2, cw))
        lags.append(lag(k, cw))
        rings.append(max(readers) - lags[-1] + W)
    return lag_use, tuple(lags), tuple(rings)


@functools.lru_cache(maxsize=64)
def basis_plan(n: int, offsets: Tuple[int, ...], s: int, dtype: torch.dtype, sms: int, *,
               min_slab: int = MIN_TILE) -> BasisPlan:
    """The design of the basis kernels on n rows (B9, and both launches of
    a fused s-step block, so that the two pick alike). The rule: the
    wavefront where s <= WAVE_MAX_S and its rings fit one block's shared
    memory, with one block an SM; else the slab design with BLOCKS_PER_SM
    blocks an SM. At N = 10,240,000, s = 4 and R = 3200 float32 vectors
    take the wavefront (48,000 values, 192,000 bytes), float64 ones the
    slab (384,000 bytes). W is the kernel's block, WAVE_THREADS rows.
    ``min_slab``: the fewest rows a block's slab may have (a small n takes
    fewer blocks)."""
    s = int(s)
    m = 2 * s + 1
    npairs = m * (m + 1) // 2
    item = torch.finfo(dtype).bits // 8
    reach = max(abs(int(o)) for o in offsets)
    if s <= WAVE_MAX_S:
        w = WAVE_THREADS
        lag_use, lags, rings = wave_schedule(s, reach, w)
        offs = tuple(int(v) for v in np.cumsum((0,) + rings[:-1]))
        # the Gram's block reduction and G reuse the rings' memory
        shared = max(sum(rings) * item, WAVE_THREADS // 32 * npairs * 8, m * m * 8)
        if shared + WAVE_STATIC <= SHARED_OPTIN:
            grid = slab_grid(n, sms, min_slab)
            return BasisPlan("wavefront", w, lag_use, lags, rings, offs, shared, grid,
                             -(-n // grid))
    return slab_plan(n, s, dtype, sms, min_slab=min_slab)


def slab_plan(n: int, s: int, dtype: torch.dtype, sms: int, *,
              min_slab: int = MIN_TILE) -> BasisPlan:
    """The slab design's plan: BLOCKS_PER_SM blocks an SM, each on one
    slab, and the Gram's sub-tile bytes (what basis_plan picks where the
    wavefront does not fit; ``chip_smoke.py`` also runs it beside the
    wavefront)."""
    m = 2 * int(s) + 1
    item = torch.finfo(dtype).bits // 8
    grid = slab_grid(n, BLOCKS_PER_SM * sms, min_slab)
    rows = GRAM_SLAB_SHARED // (m * item) // 32 * 32
    return BasisPlan("slab", 0, 0, (), (), (), m * rows * item, grid, -(-n // grid))


def slab_scratch(plan: BasisPlan, offsets: Sequence[int], s: int, keep: int = 0) -> int:
    """Values of the slab design's block-private scratch (csrc/
    sstep_basis.cuh block_scratch): two working levels a block, and
    ``keep`` levels of its slab; none for the wavefront."""
    if plan.design != "slab":
        return 0
    reach = max(abs(int(o)) for o in offsets)
    return plan.grid * (2 * (plan.slab + 2 * max(int(s) - 1, 0) * reach) + keep * plan.slab)


def shifts_arg(shifts: Sequence[float]):
    """(double array, count) for the C entries; count 0 for Chebyshev."""
    return (ctypes.c_double * max(1, len(shifts)))(*shifts), len(shifts)


def check_basis(fn: str, bands, vectors: dict, offsets, s: int, shifts) -> Tuple[int, ...]:
    """Validate a basis kernel's operands before any pointer reaches C."""
    check_operands(fn, vectors)
    first = next(iter(vectors.values()))
    if not 1 <= int(s) <= MAX_S:
        raise ValueError(f"{fn}: s must be in 1..{MAX_S}, got {s}")
    if shifts and len(shifts) < int(s):
        raise ValueError(f"{fn}: {len(shifts)} Newton shifts for s = {s}")
    return _check_bands(fn, bands, first, offsets, bf16_bands=True)


def dia_sstep_basis_planes(bands_pl: torch.Tensor, p: torch.Tensor, r: torch.Tensor, *,
                           offsets: Sequence[int], s: int, theta: float, delta: float,
                           shifts: Tuple[float, ...] = (), rows: int = 256, cols: int = 512,
                           plan: Optional[BasisPlan] = None) -> torch.Tensor:
    """The (2s+1, n) s-step basis of (p, r) from prepared bands
    (:func:`sstep_powers_band_planes`), one launch of kernel B9, in the
    design of :func:`basis_plan` (``plan=slab_plan(...)`` forces the slab
    design on the card)."""
    _check_layout(rows, cols)
    offsets = check_basis("dia_sstep_basis_planes", bands_pl, {"p": p, "r": r}, offsets, s,
                          shifts)
    if bands_pl.dtype != p.dtype:
        raise ValueError("dia_sstep_basis_planes: the bands must be in the vectors' dtype")
    s = int(s)
    if p.device.type == "cpu":
        out = dia_sstep_basis_ref(bands_pl, p, r, offsets=offsets, s=s, theta=theta,
                                  delta=delta, shifts=shifts)
    else:
        n = p.shape[0]
        if plan is None:
            plan = basis_plan(n, offsets, s, p.dtype, sms_of(p.device))
        out = torch.empty((2 * s + 1, n), dtype=p.dtype, device=p.device)
        sh, nsh = shifts_arg(shifts)
        head = (bands_pl.data_ptr(), p.data_ptr(), r.data_ptr(), out.data_ptr())
        basis = (_offsets_arg(offsets), len(offsets), s, float(theta), float(delta), sh, nsh)
        if plan.design == "wavefront":
            launch("cgx_dia_sstep_basis_wave", p, *head, n, *basis, *plan.as_arg(), plan.grid)
        else:
            scratch = torch.empty(slab_scratch(plan, offsets, s), dtype=p.dtype, device=p.device)
            launch("cgx_dia_sstep_basis", p, *head, scratch.data_ptr(), scratch.numel(), n,
                   *basis, plan.slab, plan.grid)
        dia_sstep_basis_planes.grid = plan.grid
        dia_sstep_basis_planes.design = plan.design
        dia_sstep_basis_planes.plan = plan
    dia_sstep_basis_planes.launches += 1
    return out


def dia_sstep_basis(bands: torch.Tensor, p: torch.Tensor, r: torch.Tensor, *,
                    offsets: Sequence[int], s: int, theta: float, delta: float,
                    shifts: Tuple[float, ...] = (), rows: int = 256,
                    cols: int = 512) -> torch.Tensor:
    """The (2s+1, n) s-step basis in one launch (cgx's entry that pads per
    call); chained use prepares the bands once and calls
    :func:`dia_sstep_basis_planes`."""
    planes = sstep_powers_band_planes(bands, offsets=offsets, s=s, rows=rows, cols=cols)
    return dia_sstep_basis_planes(planes, p, r, offsets=offsets, s=s, theta=theta, delta=delta,
                                  shifts=shifts, rows=rows, cols=cols)


dia_sstep_basis_planes.launches = 0
dia_sstep_basis_planes.grid = None  # blocks of the last CUDA launch
dia_sstep_basis_planes.design = None  # basis_plan's design of the last CUDA launch, and the plan
dia_sstep_basis_planes.plan = None

"""Banded (DIA) mat-vec: CUDA kernels B1 and B8 and their plain versions.

Counterpart of ``cgx/ops/dia_spmv.py``: ``dia_matvec`` and
``dia_matvec_dot`` (B1: on B8's kernel, with a dot epilogue for the
second, where :func:`matvec_plan` places x's rings and n fills the card,
else the grid-stride kernels of ``cgx_torch/csrc/dia_spmv.cu``), and the
streaming forms ``dia_matvec_stream`` and ``dia_matvec_stream2d_planes``
(B8, ``cgx_torch/csrc/dia_stream.cu``, one kernel with two entry points),
with ``dia_matvec_stream2d`` and ``stream2d_band_planes``. Each source's
header note gives the bound and the design. On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the
plain version beside it, which is also what the tests and
``chip_smoke.py`` compare the kernel with. Each wrapper counts its
runs in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cgx_torch._build import PARTIALS
from cgx_torch.ops._util import check_operands, launch, round_up, sms_of

MAX_DIAGS = 16  # kMaxDiags of csrc/dia_row.cuh
LANES = 128  # cgx's lane width: its streaming kernels' block and cols are multiples of it
# B8 (csrc/dia_stream.cu)
STREAM_THREADS = 256  # kStreamThreads: a block's most threads
STREAM_ROWS = 4  # kStreamRows: consecutive rows a thread owns, 16 bytes of float
STREAM_MIRROR = 4  # kMirror: ring values mirrored past its end
SM_SHARED = 233472  # shared memory of an H100 SM (228 KB), split among its blocks
# blocks an SM: each holds 4 band values a diagonal a thread in registers
STREAM_BLOCKS_PER_SM = {torch.float32: 4, torch.float64: 2}


def dia_matvec_ref(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int]
) -> torch.Tensor:
    """Plain ``y = A x``: shifted AXPYs over a zero-padded ``x``, the
    zero-outside-``[0, n)`` semantics of ``cgx.solver.operators.banded_matvec``."""
    n = bands.shape[1]
    pad = max(max(abs(o) for o in offsets), 1)
    xp = F.pad(x, (pad, pad))
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + bands[d] * xp[pad + off : pad + off + n]
    return y


def dia_matvec_dot_ref(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``(A x, <x, A x>)``, the dot accumulated in the data type."""
    y = dia_matvec_ref(bands, x, offsets=offsets)
    return y, torch.sum(x * y)


def _check(fn: str, bands, x, offsets, *, bf16_bands: bool = False) -> Tuple[int, ...]:
    """Validate bands, x and offsets; ``bf16_bands`` also accepts
    bfloat16 bands under float32 x (the kernels that stream them)."""
    check_operands(fn, {"x": x})
    if not isinstance(bands, torch.Tensor) or bands.dim() != 2:
        raise ValueError(f"{fn}: bands must be a 2-D (ndiag, n) tensor")
    narrow = bf16_bands and bands.dtype == torch.bfloat16 and x.dtype == torch.float32
    if (bands.dtype != x.dtype and not narrow) or bands.device != x.device:
        raise ValueError(f"{fn}: bands ({bands.dtype}, {bands.device}) and x "
                         f"({x.dtype}, {x.device}) differ")
    offsets = tuple(int(o) for o in offsets)
    if bands.shape != (len(offsets), x.shape[0]):
        raise ValueError(f"{fn}: bands shape {tuple(bands.shape)} does not match "
                         f"{len(offsets)} offsets and n={x.shape[0]}")
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"{fn}: {len(offsets)} diagonals (the kernel takes 1..{MAX_DIAGS})")
    if not bands.is_contiguous():
        raise ValueError(f"{fn}: bands must be contiguous")
    return offsets


def _offsets_arg(offsets):
    return (ctypes.c_longlong * len(offsets))(*offsets)


class MatvecPlan(NamedTuple):
    """How B1's two entries run: ``design`` "stream" (B8's kernel,
    csrc/dia_stream.cu, on ``stream``, its :func:`stream_plan`) where x's
    rings fit, else "grid" (csrc/dia_spmv.cu, one thread a row in a
    grid-stride loop; ``stream`` None)."""

    design: str
    stream: Optional["StreamPlan"]


GRID_PLAN = MatvecPlan("grid", None)  # the grid-stride design, which a caller may force


def matvec_plan(n: int, offsets: Tuple[int, ...], dtype: torch.dtype, sms: int) -> MatvecPlan:
    """B1's design on n rows: B8's staged-x kernel where
    :func:`stream_plan` places x's rings (every 2D and 3D stencil the
    solvers build) and n gives every SM a tile (n >= tile * sms: 135,168
    rows with 1024-row tiles on 132 SMs), else the grid-stride kernels.
    Below that B8 leaves SMs idle with 4 rows a thread: on an H100 at
    N = 10,000 the grid-stride kernels took 2.5 and 3.9 us of device time
    against B8's 4.5 and 6.4 (float64), at N = 1e6 B8 took 9.1 and 12.7
    against 17.3 and 21.8 (float32; PERF.md, chip_smoke.py b1_sizes)."""
    layout = _stream_layout(tuple(offsets), dtype)
    if layout is None or n < layout[1] * sms:
        return GRID_PLAN
    return MatvecPlan("stream", stream_plan(n, tuple(offsets), dtype, sms))


def _b1_plan(x: torch.Tensor, offsets, plan: Optional[MatvecPlan]) -> MatvecPlan:
    return plan if plan is not None else matvec_plan(x.shape[0], offsets, x.dtype,
                                                     sms_of(x.device))


def dia_matvec(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int],
    plan: Optional[MatvecPlan] = None,
) -> torch.Tensor:
    """``y = A x`` for banded A given as (ndiag, n) bands and offsets.
    On a CUDA tensor it runs the design of ``plan`` (default
    :func:`matvec_plan`; pass :data:`GRID_PLAN` to force the grid-stride
    kernel), recorded in ``dia_matvec.plan``."""
    offsets = _check("dia_matvec", bands, x, offsets)
    if x.device.type == "cpu":
        y = dia_matvec_ref(bands, x, offsets=offsets)
    else:
        y = torch.empty_like(x)
        plan = _b1_plan(x, offsets, plan)
        if plan.design == "stream":  # B8's flat entry: the same function, bitwise
            arg, arg_len = plan.stream.as_arg()
            launch("cgx_dia_matvec_stream", x, bands.data_ptr(), x.shape[0], x.data_ptr(),
                   y.data_ptr(), x.shape[0], _offsets_arg(offsets), len(offsets), arg, arg_len,
                   plan.stream.grid)
        else:
            launch("cgx_dia_matvec", x, bands.data_ptr(), x.data_ptr(), y.data_ptr(),
                   x.shape[0], _offsets_arg(offsets), len(offsets))
        dia_matvec.plan = plan
    dia_matvec.launches += 1
    return y


def dia_matvec_dot(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int],
    plan: Optional[MatvecPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A x, <x, A x>)`` in one pass over the bands; the dot is a 0-d
    tensor on the device, summed in the data type. ``plan`` as for
    :func:`dia_matvec`; on B8's design the kernel is B8's with a dot
    epilogue, so ``y`` is bitwise :func:`dia_matvec`'s."""
    offsets = _check("dia_matvec_dot", bands, x, offsets)
    if x.device.type == "cpu":
        y, dot = dia_matvec_dot_ref(bands, x, offsets=offsets)
    else:
        y = torch.empty_like(x)
        dot = torch.empty((), dtype=x.dtype, device=x.device)
        partials = torch.empty(PARTIALS, dtype=x.dtype, device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        plan = _b1_plan(x, offsets, plan)
        if plan.design == "stream":
            arg, arg_len = plan.stream.as_arg()
            launch("cgx_dia_matvec_stream_dot", x, bands.data_ptr(), x.shape[0], x.data_ptr(),
                   y.data_ptr(), x.shape[0], _offsets_arg(offsets), len(offsets), arg, arg_len,
                   plan.stream.grid, partials.data_ptr(), PARTIALS, ticket.data_ptr(),
                   dot.data_ptr())
        else:
            launch("cgx_dia_matvec_dot", x, bands.data_ptr(), x.data_ptr(), y.data_ptr(),
                   partials.data_ptr(), PARTIALS, ticket.data_ptr(), dot.data_ptr(),
                   x.shape[0], _offsets_arg(offsets), len(offsets))
        dia_matvec_dot.plan = plan
    dia_matvec_dot.launches += 1
    return y, dot


def _check_block(fn: str, name: str, value: int) -> None:
    """cgx's alignment checks of the TPU window (dia_spmv.py:180, :276):
    the Hopper kernel tiles its own rows, but takes the same arguments."""
    if value <= 0 or value % LANES:
        raise ValueError(f"{fn}: {name}={value} must be a positive multiple of {LANES}")


class StreamPlan(NamedTuple):
    """How kernel B8 runs (csrc/dia_stream.cu): ``threads`` a block, each
    owning STREAM_ROWS consecutive rows of a ``tile``; ``grid`` blocks,
    each walking ``tiles_per_block`` consecutive tiles; the offsets'
    ``clusters`` as (least offset, greatest offset, ring length Q, first
    value in shared memory), each a ring of x indexed by row modulo Q;
    ``diag_cluster``, each diagonal's cluster; ``shared`` bytes a block."""

    threads: int
    tile: int
    grid: int
    tiles_per_block: int
    clusters: Tuple[Tuple[int, int, int, int], ...]
    diag_cluster: Tuple[int, ...]
    shared: int

    def as_arg(self):
        """The plan array of csrc/dia_stream.cu make_stream_plan, and its length."""
        vals = (self.threads, self.tiles_per_block, self.shared, len(self.clusters),
                len(self.diag_cluster), *(v for c in self.clusters for v in c),
                *self.diag_cluster)
        return (ctypes.c_longlong * len(vals))(*vals), len(vals)


def _ring(tile: int, lo: int, hi: int) -> int:
    """A cluster's ring: a tile's window [t + lo, t + tile + hi) rounded out
    to the 16-byte grid, and the next tile's rows."""
    return round_up(2 * tile + (hi - lo) + 8, 4)


def _clusters(offsets, tile: int, item: int, budget: int):
    """The sorted offsets in clusters of neighbours: one while the rings fit
    ``budget`` bytes, else split at the widest gaps; None if even one a
    diagonal does not fit."""
    srt = sorted(set(offsets))
    cuts = sorted(range(1, len(srt)), key=lambda j: srt[j] - srt[j - 1], reverse=True)
    for ncut in range(len(srt)):
        bounds = [0, *sorted(cuts[:ncut]), len(srt)]
        groups = [(srt[a], srt[b - 1]) for a, b in zip(bounds, bounds[1:])]
        if sum(_ring(tile, lo, hi) + STREAM_MIRROR for lo, hi in groups) * item <= budget:
            return groups
    return None


@functools.lru_cache(maxsize=64)
def _stream_layout(offsets: Tuple[int, ...], dtype: torch.dtype):
    """``(threads, tile, clusters)`` of B8 for these offsets and dtype:
    STREAM_THREADS threads (fewer where even one cluster a diagonal
    outgrows the budget); None where no block size places x's rings."""
    item = torch.finfo(dtype).bits // 8
    budget = SM_SHARED // STREAM_BLOCKS_PER_SM[dtype] - 1024
    for threads in (STREAM_THREADS, STREAM_THREADS // 2, STREAM_THREADS // 4):
        tile = STREAM_ROWS * threads
        groups = _clusters(offsets, tile, item, budget)
        if groups is not None:
            return threads, tile, groups
    return None


@functools.lru_cache(maxsize=64)
def stream_plan(n: int, offsets: Tuple[int, ...], dtype: torch.dtype, sms: int) -> StreamPlan:
    """B8's plan on n rows: STREAM_THREADS threads a block (fewer where
    even one cluster a diagonal outgrows the budget), tiles of 4 rows a
    thread, STREAM_BLOCKS_PER_SM[dtype] blocks an SM with a budget of
    shared memory each, every block on a contiguous run of tiles. At
    lap2d_fd(3200) the offsets take one cluster, a ring of 8,456 values
    (33,840 bytes with its mirror in float32, 67,680 in float64)."""
    item = torch.finfo(dtype).bits // 8
    per_sm = STREAM_BLOCKS_PER_SM[dtype]
    layout = _stream_layout(tuple(offsets), dtype)
    if layout is None:
        raise ValueError(f"B8 cannot stage x for offsets {offsets} in {dtype}")
    threads, tile, groups = layout
    clusters, start = [], 0
    for lo, hi in groups:
        q = _ring(tile, lo, hi)
        clusters.append((lo, hi, q, start))
        start += q + STREAM_MIRROR
    diag_cluster = tuple(next(c for c, (lo, hi) in enumerate(groups) if lo <= o <= hi)
                         for o in offsets)
    tiles = max(1, -(-n // tile))
    per_block = -(-tiles // min(tiles, per_sm * sms))
    return StreamPlan(threads, tile, -(-tiles // per_block), per_block, tuple(clusters),
                      diag_cluster, start * item)


def _stream(fn, bands: torch.Tensor, stride: int, x: torch.Tensor, offsets) -> torch.Tensor:
    y = torch.empty_like(x)
    plan = stream_plan(x.shape[0], offsets, x.dtype, sms_of(x.device))
    arg, arg_len = plan.as_arg()
    launch("cgx_dia_matvec_stream", x, bands.data_ptr(), stride, x.data_ptr(), y.data_ptr(),
           x.shape[0], _offsets_arg(offsets), len(offsets), arg, arg_len, plan.grid)
    fn.launches += 1
    fn.plan = plan
    return y


def dia_matvec_stream_ref(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int], block: int = 131072
) -> torch.Tensor:
    """Plain version of :func:`dia_matvec_stream`: the zero-boundary
    product, summed in offset order (``block`` is checked, not used)."""
    _check_block("dia_matvec_stream", "block", block)
    return dia_matvec_ref(bands, x, offsets=offsets)


def dia_matvec_stream(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int], block: int = 131072
) -> torch.Tensor:
    """``y = A x`` for banded A, x staged through shared memory (B8, the
    flat form; cgx streams x from HBM in ``block``-row windows, which the
    Hopper kernel replaces by its own tiles; ``block`` keeps cgx's check)."""
    _check_block("dia_matvec_stream", "block", block)
    offsets = _check("dia_matvec_stream", bands, x, offsets)
    if x.device.type == "cpu":
        dia_matvec_stream.launches += 1
        return dia_matvec_ref(bands, x, offsets=offsets)
    return _stream(dia_matvec_stream, bands, x.shape[0], x, offsets)


def stream2d_band_planes(bands, *, rows: int = 256, cols: int = 512):
    """Pre-padded (ndiag, rows_p, cols) band planes for
    :func:`dia_matvec_stream2d_planes`, built once per operator: the bands
    padded with zeros to a multiple of ``rows * cols``. NumPy arrays or
    tensors; the flat band values are ``planes.reshape(ndiag, -1)[:, :n]``."""
    ndiag, n = bands.shape
    n_p = round_up(n, rows * cols)
    if isinstance(bands, torch.Tensor):
        return F.pad(bands, (0, n_p - n)).reshape(ndiag, n_p // cols, cols)
    return np.pad(bands, ((0, 0), (0, n_p - n))).reshape(ndiag, n_p // cols, cols)


def _check_planes(fn: str, bands_p, x, offsets, rows: int, cols: int) -> Tuple[int, ...]:
    """cgx's checks (dia_spmv.py:340-345) and the operands'."""
    _check_block(fn, "cols", cols)
    check_operands(fn, {"x": x})
    if not isinstance(bands_p, torch.Tensor) or bands_p.dim() != 3:
        raise ValueError(f"{fn}: band planes must be a 3-D (ndiag, rows_p, cols) tensor")
    if bands_p.dtype != x.dtype or bands_p.device != x.device:
        raise ValueError(f"{fn}: band planes ({bands_p.dtype}, {bands_p.device}) and x "
                         f"({x.dtype}, {x.device}) differ")
    ndiag, rows_p, cols_ = bands_p.shape
    if cols_ != cols or rows <= 0 or rows_p % rows:
        raise ValueError(f"{fn}: band planes {tuple(bands_p.shape)} do not match "
                         f"rows={rows} cols={cols}")
    if rows_p * cols < x.shape[0]:
        raise ValueError(f"{fn}: band planes {tuple(bands_p.shape)} hold fewer than "
                         f"n={x.shape[0]} rows")
    offsets = tuple(int(o) for o in offsets)
    if ndiag != len(offsets) or not 1 <= ndiag <= MAX_DIAGS:
        raise ValueError(f"{fn}: {ndiag} band planes for {len(offsets)} offsets "
                         f"(the kernel takes 1..{MAX_DIAGS})")
    if not bands_p.is_contiguous():
        raise ValueError(f"{fn}: band planes must be contiguous")
    return offsets


def dia_matvec_stream2d_planes_ref(
    bands_p: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int], rows: int = 256,
    cols: int = 512,
) -> torch.Tensor:
    """Plain version of :func:`dia_matvec_stream2d_planes`."""
    offsets = _check_planes("dia_matvec_stream2d_planes", bands_p, x, offsets, rows, cols)
    return _planes_ref(bands_p, x, offsets)


def _planes_ref(bands_p, x, offsets):
    """The product over the planes' first n entries a band, the flat bands."""
    return dia_matvec_ref(bands_p.reshape(len(offsets), -1)[:, : x.shape[0]], x, offsets=offsets)


def dia_matvec_stream2d_planes(
    bands_p: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int], rows: int = 256,
    cols: int = 512,
) -> torch.Tensor:
    """``y = A x`` over pre-padded band planes (:func:`stream2d_band_planes`),
    the chained-use entry point (B8, the planes form): the planes are flat
    bands of row stride ``rows_p * cols``, so the kernel reads them in
    place."""
    offsets = _check_planes("dia_matvec_stream2d_planes", bands_p, x, offsets, rows, cols)
    if x.device.type == "cpu":
        dia_matvec_stream2d_planes.launches += 1
        return _planes_ref(bands_p, x, offsets)
    return _stream(dia_matvec_stream2d_planes, bands_p, bands_p.shape[1] * cols, x, offsets)


def dia_matvec_stream2d(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int], rows: int = 256,
    cols: int = 512,
) -> torch.Tensor:
    """:func:`dia_matvec_stream2d_planes` on bands padded into planes on
    each call (cgx's convenience form; its launch counts there)."""
    _check_block("dia_matvec_stream2d", "cols", cols)
    offsets = _check("dia_matvec_stream2d", bands, x, offsets)
    planes = stream2d_band_planes(bands, rows=rows, cols=cols).contiguous()
    return dia_matvec_stream2d_planes(planes, x, offsets=offsets, rows=rows, cols=cols)


dia_matvec.launches = 0
dia_matvec_dot.launches = 0
dia_matvec.plan = None  # MatvecPlan of the last CUDA launch
dia_matvec_dot.plan = None
dia_matvec_stream.launches = 0
dia_matvec_stream2d_planes.launches = 0
dia_matvec_stream.plan = None  # stream_plan of the last CUDA launch
dia_matvec_stream2d_planes.plan = None

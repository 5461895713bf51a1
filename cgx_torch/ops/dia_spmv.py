"""Banded (DIA) mat-vec: CUDA kernels B1 and B8 and their plain versions.

Counterpart of ``cgx/ops/dia_spmv.py``: ``dia_matvec`` and
``dia_matvec_dot`` (B1, ``cgx_torch/csrc/dia_spmv.cu``), and the
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
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cgx_torch._build import PARTIALS
from cgx_torch.ops._util import check_operands, launch, round_up

MAX_DIAGS = 16  # kMaxDiags of csrc/dia_row.cuh
LANES = 128  # cgx's lane width: its streaming kernels' block and cols are multiples of it


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


def dia_matvec(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int]
) -> torch.Tensor:
    """``y = A x`` for banded A given as (ndiag, n) bands and offsets."""
    offsets = _check("dia_matvec", bands, x, offsets)
    if x.device.type == "cpu":
        y = dia_matvec_ref(bands, x, offsets=offsets)
    else:
        y = torch.empty_like(x)
        launch("cgx_dia_matvec", x, bands.data_ptr(), x.data_ptr(), y.data_ptr(),
               x.shape[0], _offsets_arg(offsets), len(offsets))
    dia_matvec.launches += 1
    return y


def dia_matvec_dot(
    bands: torch.Tensor, x: torch.Tensor, *, offsets: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A x, <x, A x>)`` in one pass over the bands; the dot is a 0-d
    tensor on the device."""
    offsets = _check("dia_matvec_dot", bands, x, offsets)
    if x.device.type == "cpu":
        y, dot = dia_matvec_dot_ref(bands, x, offsets=offsets)
    else:
        y = torch.empty_like(x)
        dot = torch.empty((), dtype=x.dtype, device=x.device)
        partials = torch.empty(PARTIALS, dtype=x.dtype, device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        launch("cgx_dia_matvec_dot", x, bands.data_ptr(), x.data_ptr(), y.data_ptr(),
               partials.data_ptr(), PARTIALS, ticket.data_ptr(), dot.data_ptr(),
               x.shape[0], _offsets_arg(offsets), len(offsets))
    dia_matvec_dot.launches += 1
    return y, dot


def _check_block(fn: str, name: str, value: int) -> None:
    """cgx's alignment checks of the TPU window (dia_spmv.py:180, :276):
    the Hopper kernel tiles its own rows, but takes the same arguments."""
    if value <= 0 or value % LANES:
        raise ValueError(f"{fn}: {name}={value} must be a positive multiple of {LANES}")


def _stream(fn, bands: torch.Tensor, stride: int, x: torch.Tensor, offsets) -> torch.Tensor:
    y = torch.empty_like(x)
    launch("cgx_dia_matvec_stream", x, bands.data_ptr(), stride, x.data_ptr(), y.data_ptr(),
           x.shape[0], _offsets_arg(offsets), len(offsets))
    fn.launches += 1
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
dia_matvec_stream.launches = 0
dia_matvec_stream2d_planes.launches = 0

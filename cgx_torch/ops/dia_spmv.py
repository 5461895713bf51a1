"""Banded (DIA) mat-vec: CUDA kernels B1 and their plain versions.

Counterpart of ``cgx/ops/dia_spmv.py`` (``dia_matvec`` and
``dia_matvec_dot``). The kernels are in ``cgx_torch/csrc/dia_spmv.cu``,
whose header note gives the bound and the design. On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the
plain version beside it, which is also what the tests and
``chip_smoke.py`` compare the kernel with. Each wrapper counts its
runs in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from cgx_torch._build import PARTIALS
from cgx_torch.ops._util import check_operands, launch

MAX_DIAGS = 16  # kMaxDiags of csrc/dia_spmv.cu


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


dia_matvec.launches = 0
dia_matvec_dot.launches = 0

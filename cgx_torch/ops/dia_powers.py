"""The s-step matrix-powers kernel B9 and its plain version (counterpart
of ``cgx/ops/dia_powers.py``).

``dia_sstep_basis_planes`` builds the (2s+1, n) Krylov basis
``[T_0..T_s(A)p, T_0..T_{s-1}(A)r]`` of a banded operator (Chebyshev on
(theta, delta), or scaled Newton with ``shifts``) in one launch of the
kernel in ``cgx_torch/csrc/dia_powers.cu``, whose header note gives the
bound and the design; :func:`dia_sstep_basis_ref` is the plain version,
the 2s-1 mat-vecs of :func:`cgx_torch.solver.sstep.basis_columns_fn`,
which the kernel equals bit for bit. On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs the plain
version. It counts its calls in ``.launches``.

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
from typing import NamedTuple, Sequence, Tuple

import torch

from cgx_torch.ops._util import check_operands, launch, round_up
from cgx_torch.ops.cg_stream import LANES
from cgx_torch.ops.dia_spmv import _check as _check_bands
from cgx_torch.ops.dia_spmv import _offsets_arg, dia_matvec_ref

MAX_S = 16  # kMaxS of csrc/sstep_basis.cuh
BLOCKS_PER_SM = 2  # the grid: each block owns one slab of about n / grid rows
MIN_TILE = 1024  # rows of the smallest slab: a small n takes fewer blocks


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


class LaunchShape(NamedTuple):
    """The grid of a basis kernel: rows of a block's slab, blocks, and the
    block-private scratch (values of the vectors' dtype) they need."""

    tile: int
    grid: int
    scratch: int


def launch_shape(n: int, offsets: Sequence[int], s: int, device, keep: int = 0) -> LaunchShape:
    """BLOCKS_PER_SM blocks an SM (fewer for a small n), each on one slab
    of ``tile`` rows, and ``block_scratch`` of csrc/sstep_basis.cuh for
    each: two working levels, and ``keep`` levels of the slab."""
    reach = max(abs(int(o)) for o in offsets)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = max(1, min(BLOCKS_PER_SM * sms, -(-n // MIN_TILE)))
    tile = -(-n // grid)
    return LaunchShape(tile, grid, grid * (2 * (tile + 2 * max(s - 1, 0) * reach) + keep * tile))


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
                           shifts: Tuple[float, ...] = (), rows: int = 256,
                           cols: int = 512) -> torch.Tensor:
    """The (2s+1, n) s-step basis of (p, r) from prepared bands
    (:func:`sstep_powers_band_planes`), one launch of kernel B9."""
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
        shape = launch_shape(n, offsets, s, p.device)
        out = torch.empty((2 * s + 1, n), dtype=p.dtype, device=p.device)
        scratch = torch.empty(shape.scratch, dtype=p.dtype, device=p.device)
        sh, nsh = shifts_arg(shifts)
        launch("cgx_dia_sstep_basis", p, bands_pl.data_ptr(), p.data_ptr(), r.data_ptr(),
               out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, _offsets_arg(offsets),
               len(offsets), s, float(theta), float(delta), sh, nsh, shape.tile, shape.grid)
        dia_sstep_basis_planes.grid = shape.grid
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

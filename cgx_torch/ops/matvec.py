"""Dense tiled mat-vec: CUDA kernels B3 and their plain versions.

Counterpart of ``cgx/ops/matvec.py`` (``dense_matvec`` and
``dense_matvec_dot``), with cgx's signatures minus ``interpret``. The
kernels are in ``cgx_torch/csrc/matvec.cu``, whose header note gives
the bound and the design. ``block_rows`` and ``block_cols`` fix the
summation grouping, as the TPU kernel's grid did: ``y`` is the sum of
the column tiles' partial products in tile order, and the dot the sum
of the row tiles' partials in tile order. Any ``(n_rows, n_cols)``
matrix and any positive tile sizes are taken; nothing is padded.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version beside it, which is also what the
tests and ``chip_smoke.py`` compare the kernel with. Each wrapper
counts its runs in ``.launches``. Both kernels run on the persistent
grid of :func:`dense_plan`, which the CPU tests hold; ``dense_matvec_dot``
is ``dense_matvec``'s kernel with a dot epilogue, so its ``y`` is
bitwise ``dense_matvec``'s.

bfloat16 ``a`` and ``x`` (the CLI's ``--precision bf16`` with a dense
``true``/``--pallas`` run): a row is summed in float and ``y`` rounds to
bfloat16 once (cgx's TPU kernel rounds after each column tile); the
dot's products ``x * y`` round to bfloat16 and are summed in float, so
``dense_matvec_dot`` returns a float32 dot. A bfloat16 tile of 128 or
64 columns holds 16 or 8 of the kernel's 16-byte vectors, so its spans
take a half or a quarter of a warp (:func:`span_lanes`, the plan's
``lanes``) and every lane loads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from cgx_torch.ops._util import (
    SHARED_OPTIN, check_operands, count_build, f32_exact, launch, vector_dtypes
)

DENSE_THREADS = 512  # kDenseThreads of csrc/matvec.cu: one block an SM
DENSE_MAX_ROWS = 4096  # rows a block: their sums leave room for x (more blocks than SMs past it)


class DensePlan(NamedTuple):
    """How ``dense_matvec``'s kernel runs: ``aligned`` (every row start,
    tile and chunk 16-byte aligned: vector loads throughout; else the
    peeled scalar head and tail); ``staging`` of x in shared memory:
    "whole", by "chunks" of ``chunk_cols`` (whole tiles), or "global"
    (read in place, a tile being wider than a block's shared memory);
    ``shared`` bytes a block (x's chunk, its rows' tile sums over a chunk,
    their running sums); ``grid`` blocks, one an SM, each on
    ``rows_per_cta`` contiguous rows; ``lanes`` a span of eight tiles
    takes (32, a warp; 16 or 8 for bfloat16 tiles of at most 16 or 8
    16-byte vectors on the aligned path, so that every lane loads)."""

    aligned: bool
    staging: str
    chunk_cols: int
    shared: int
    grid: int
    rows_per_cta: int
    lanes: int = 32


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the kernels sum a row and the dot in: float32 for
    bfloat16 vectors, else the vectors' own (csrc/bf16.cuh Acc)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def dense_shared(chunk_cols: int, block_cols: int, rows: int, item: int, staged: bool,
                 acc_item: int = None) -> int:
    """csrc/matvec.cu dense_shared: x's chunk (``item`` bytes a value),
    the tile sums and the running sums (``acc_item``, default ``item``)."""
    acc_item = item if acc_item is None else acc_item
    tiles = -(-chunk_cols // block_cols)
    return (_align16(chunk_cols * item) if staged else 0) + _align16(rows * tiles * acc_item) + \
        rows * acc_item


@functools.lru_cache(maxsize=64)  # the CG loop asks for the same plan every iteration
def dense_plan(n_rows: int, n_cols: int, block_cols: int, dtype: torch.dtype, sms: int, *,
               pointers_aligned: bool = True) -> DensePlan:
    """The persistent grid of ``dense_matvec`` on an (n_rows, n_cols)
    matrix: one block an SM, rows split evenly (at most DENSE_MAX_ROWS a
    block, which binds only on a card with few SMs); x staged whole where it
    and the tile sums fit a block's shared memory, else by the widest
    chunk of whole tiles that does, else read in place. In double at
    N = 10,000 with 128-column tiles: 80,000 bytes of x and 48,032 of
    tile sums; at 40,000, chunks of 66 tiles (8,448 columns)."""
    item = torch.finfo(dtype).bits // 8
    acc = torch.finfo(acc_dtype(dtype)).bits // 8
    aligned = bool(pointers_aligned and n_cols * item % 16 == 0 and block_cols * item % 16 == 0)
    rows = min(DENSE_MAX_ROWS, max(1, -(-n_rows // max(1, min(sms, n_rows)))))
    grid = max(1, -(-n_rows // rows))  # every block has rows
    tiles = max(1, -(-n_cols // block_cols))

    def widest(staged: bool) -> int:  # tiles a chunk may hold
        per_tile = (block_cols * item if staged else 0) + rows * acc
        t = min(tiles, max(0, (SHARED_OPTIN - rows * acc - 32) // per_tile))
        while t > 0 and dense_shared(min(t * block_cols, max(n_cols, 1)), block_cols, rows, item,
                                     staged, acc) > SHARED_OPTIN:
            t -= 1
        return t

    t = widest(True)
    staging = "whole" if t == tiles else "chunks"
    if t == 0:
        staging, t = "global", widest(False)
        if t == 0:
            raise ValueError(f"dense_matvec: {rows} rows a block do not fit its shared memory")
    chunk = max(n_cols, 1) if t == tiles else t * block_cols
    shared = dense_shared(chunk, block_cols, rows, item, staging != "global", acc)
    return DensePlan(aligned, staging, chunk, shared, grid, rows,
                     span_lanes(block_cols, dtype) if aligned else 32)


def span_lanes(block_cols: int, dtype: torch.dtype) -> int:
    """Lanes a span of eight tiles takes on the aligned path: a lane loads
    one 16-byte vector of each tile a round, so a tile of ``v`` vectors
    keeps ``v`` lanes busy. bfloat16 tiles of 128 columns (the CLI's
    "1024 16" maps to 1024 x 128) hold 16 vectors and tiles of 64 hold 8:
    they take a half or a quarter of a warp, and a warp two or four spans
    at once. Wider bfloat16 tiles, and every float32 and float64 tile,
    take the whole warp (the float builds keep their grouping bit for
    bit)."""
    if dtype != torch.bfloat16:
        return 32
    vectors = -(-block_cols * 2 // 16)
    return 8 if vectors <= 8 else 16 if vectors <= 16 else 32


def dense_matvec_ref(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512
) -> torch.Tensor:
    """Plain ``y = A x``, accumulated over column tiles in index order
    as the TPU kernel does (``matvec.py:54-66``); each tile's product is
    one ``torch.matmul`` at full float32. ``block_rows`` does not change
    ``y``. bfloat16 ``a`` and ``x`` are summed in float32 and ``y``
    rounds once, as the kernel does."""
    acc = acc_dtype(a.dtype)
    y = torch.zeros(a.shape[0], dtype=acc, device=a.device)
    with f32_exact():
        for c0 in range(0, a.shape[1], block_cols):
            cols = slice(c0, c0 + block_cols)
            y = y + torch.matmul(a[:, cols].to(acc), x[cols].to(acc))
    return y.to(a.dtype)


def dense_matvec_dot_ref(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``(A x, <x, A x>)``: the dot is summed per row tile and the
    tile sums in row-tile order (``matvec.py:138-140``), in the data
    type. Rows past ``len(x)`` of a tall matrix add nothing."""
    y = dense_matvec_ref(a, x, block_rows=block_rows, block_cols=block_cols)
    m = min(a.shape[0], a.shape[1])
    acc = acc_dtype(a.dtype)
    prods = (x[:m] * y[:m]).to(acc)  # bfloat16 products round before they are summed
    dot = torch.zeros((), dtype=acc, device=a.device)
    for r0 in range(0, m, block_rows):
        dot = dot + torch.sum(prods[r0 : r0 + block_rows])
    return y, dot


def _check(fn: str, a, x, block_rows, block_cols) -> Tuple[int, int]:
    check_operands(fn, {"x": x}, dtypes=vector_dtypes(f"cgx_{fn}"))
    if not isinstance(a, torch.Tensor) or a.dim() != 2:
        raise ValueError(f"{fn}: a must be a 2-D (n_rows, n_cols) tensor")
    if a.dtype != x.dtype or a.device != x.device:
        raise ValueError(f"{fn}: a ({a.dtype}, {a.device}) and x ({x.dtype}, {x.device}) differ")
    if a.shape[1] != x.shape[0]:
        raise ValueError(f"{fn}: a has {a.shape[1]} columns but x has {x.shape[0]} entries")
    if not a.is_contiguous():
        raise ValueError(f"{fn}: a must be contiguous (row-major)")
    br, bc = int(block_rows), int(block_cols)
    if br < 1 or bc < 1:
        raise ValueError(f"{fn}: tile sizes must be positive, got {br} x {bc}")
    return br, bc


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_of(a: torch.Tensor, x: torch.Tensor, block_cols: int) -> DensePlan:
    """The persistent grid both dense kernels run on, for these operands."""
    return dense_plan(a.shape[0], a.shape[1], block_cols, x.dtype, _sm_count(x.device.index),
                      pointers_aligned=a.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)


def _plan_args(plan: DensePlan, block_cols: int) -> tuple:
    return (block_cols, plan.chunk_cols, plan.rows_per_cta, int(plan.staging != "global"),
            int(plan.aligned), plan.shared, plan.grid, plan.lanes)


def dense_matvec(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512,
    plan: DensePlan = None
) -> torch.Tensor:
    """``y = A x`` with the (block_rows x block_cols) summation grouping,
    on :func:`dense_plan`'s plan (``plan=`` forces another, e.g. with
    ``lanes=32`` the whole-warp spans on bfloat16)."""
    br, bc = _check("dense_matvec", a, x, block_rows, block_cols)
    if x.device.type == "cpu":
        y = dense_matvec_ref(a, x, block_rows=br, block_cols=bc)
    else:
        n_rows, n_cols = a.shape
        y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
        plan = _plan_of(a, x, bc) if plan is None else plan
        launch("cgx_dense_matvec", x, a.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows, n_cols,
               *_plan_args(plan, bc))
        dense_matvec.plan = plan
    dense_matvec.launches += 1
    count_build("dense_matvec", x.dtype, a.dtype)
    return y


def dense_matvec_dot(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512,
    plan: DensePlan = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A x, <x, A x>)`` in one pass over A; the dot is a 0-d tensor
    on the device. The kernel is ``dense_matvec``'s on the same plan
    (``plan=`` as there) with a dot epilogue, so ``y`` is bitwise
    ``dense_matvec``'s."""
    br, bc = _check("dense_matvec_dot", a, x, block_rows, block_cols)
    if x.device.type == "cpu":
        y, dot = dense_matvec_dot_ref(a, x, block_rows=br, block_cols=bc)
    else:
        n_rows, n_cols = a.shape
        y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
        dot = torch.empty((), dtype=acc_dtype(x.dtype), device=x.device)
        # per-row products, then one sum per row tile
        scratch = torch.empty(n_rows + -(-n_rows // br), dtype=acc_dtype(x.dtype),
                              device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        plan = _plan_of(a, x, bc) if plan is None else plan
        launch("cgx_dense_matvec_dot", x, a.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows,
               n_cols, *_plan_args(plan, bc), scratch.data_ptr(), scratch[n_rows:].data_ptr(),
               ticket.data_ptr(), dot.data_ptr(), br)
        dense_matvec_dot.plan = plan
    dense_matvec_dot.launches += 1
    count_build("dense_matvec_dot", x.dtype, a.dtype)
    return y, dot


dense_matvec.launches = 0
dense_matvec.plan = None  # the DensePlan of the last CUDA launch
dense_matvec_dot.launches = 0
dense_matvec_dot.plan = None

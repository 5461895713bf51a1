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
counts its runs in ``.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cgx_torch.ops._util import check_operands, f32_exact, launch


def dense_matvec_ref(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512
) -> torch.Tensor:
    """Plain ``y = A x``, accumulated over column tiles in index order
    as the TPU kernel does (``matvec.py:54-66``); each tile's product is
    one ``torch.matmul`` at full float32. ``block_rows`` does not change
    ``y``."""
    y = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    with f32_exact():
        for c0 in range(0, a.shape[1], block_cols):
            y = y + torch.matmul(a[:, c0 : c0 + block_cols], x[c0 : c0 + block_cols])
    return y


def dense_matvec_dot_ref(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``(A x, <x, A x>)``: the dot is summed per row tile and the
    tile sums in row-tile order (``matvec.py:138-140``), in the data
    type. Rows past ``len(x)`` of a tall matrix add nothing."""
    y = dense_matvec_ref(a, x, block_rows=block_rows, block_cols=block_cols)
    m = min(a.shape[0], a.shape[1])
    prods = x[:m] * y[:m]
    dot = torch.zeros((), dtype=a.dtype, device=a.device)
    for r0 in range(0, m, block_rows):
        dot = dot + torch.sum(prods[r0 : r0 + block_rows])
    return y, dot


def _check(fn: str, a, x, block_rows, block_cols) -> Tuple[int, int]:
    check_operands(fn, {"x": x})
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


def dense_matvec(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512
) -> torch.Tensor:
    """``y = A x`` with the (block_rows x block_cols) summation grouping."""
    br, bc = _check("dense_matvec", a, x, block_rows, block_cols)
    if x.device.type == "cpu":
        y = dense_matvec_ref(a, x, block_rows=br, block_cols=bc)
    else:
        y = torch.empty(a.shape[0], dtype=x.dtype, device=x.device)
        launch("cgx_dense_matvec", x, a.data_ptr(), x.data_ptr(), y.data_ptr(),
               a.shape[0], a.shape[1], bc)
    dense_matvec.launches += 1
    return y


def dense_matvec_dot(
    a: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256, block_cols: int = 512
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A x, <x, A x>)`` in one pass over A; the dot is a 0-d tensor
    on the device."""
    br, bc = _check("dense_matvec_dot", a, x, block_rows, block_cols)
    if x.device.type == "cpu":
        y, dot = dense_matvec_dot_ref(a, x, block_rows=br, block_cols=bc)
    else:
        n_rows = a.shape[0]
        y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
        dot = torch.empty((), dtype=x.dtype, device=x.device)
        # per-row products, then one sum per row tile
        scratch = torch.empty(n_rows + -(-n_rows // br), dtype=x.dtype, device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        launch("cgx_dense_matvec_dot", x, a.data_ptr(), x.data_ptr(), y.data_ptr(),
               scratch.data_ptr(), scratch[n_rows:].data_ptr(), ticket.data_ptr(),
               dot.data_ptr(), n_rows, a.shape[1], br, bc)
    dense_matvec_dot.launches += 1
    return y, dot


dense_matvec.launches = 0
dense_matvec_dot.launches = 0

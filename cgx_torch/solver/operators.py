"""Device-side linear operators (counterpart of ``cgx/solver/operators.py``).

- :class:`DiaOperator`: banded ``y = sum_d bands[d] * shift(x, offsets[d])``
  in plain torch, with the zero-outside-``[0, n)`` semantics of cgx's
  ``banded_matvec`` (cgx leaves this mat-vec to XLA). The solvers that
  want the CUDA kernel call :mod:`cgx_torch.ops.dia_spmv` on its bands.
- :class:`DenseOperator`: ``A @ x`` through ``torch.matmul``.

Operators are plain dataclasses over tensors; they have nothing to
train, so they are not ``nn.Module``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.mats.containers import (
    COOMatrix,
    CSRMatrix,
    DenseMatrix,
    DIAMatrix,
    ELLMatrix,
)
from cgx_torch.ops._util import check_device, resolve_device
from cgx_torch.ops.dia_spmv import dia_matvec_ref

_NP_TO_TORCH = {np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32}


@dataclasses.dataclass
class DenseOperator:
    """Dense operator: ``A @ x``."""

    a: torch.Tensor  # (n, n)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.a, x)

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.a)


@dataclasses.dataclass
class DiaOperator:
    """Banded operator: ``bands[d, i] = A[i, i + offsets[d]]``."""

    bands: torch.Tensor  # (ndiag, n)
    offsets: Tuple[int, ...] = ()

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.bands.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def device(self) -> torch.device:
        return self.bands.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return dia_matvec_ref(self.bands, x, offsets=self.offsets)

    def diagonal(self) -> torch.Tensor:
        return self.bands[self.offsets.index(0)]


def _torch_dtype(dtype, default: torch.dtype) -> torch.dtype:
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def operator_from_numpy(
    arr: np.ndarray,
    offsets: Optional[Tuple[int, ...]] = None,
    *,
    dtype=None,
    device="cuda",
):
    """The port's operator from the NumPy arrays of a cgx operator, on
    an explicit device and dtype (default: the array's own dtype).

    - ``operator_from_numpy(np.asarray(op.bands), op.offsets)`` for a
      cgx ``DiaOperator``;
    - ``operator_from_numpy(np.asarray(op.a))`` for a cgx ``DenseOperator``.
    """
    dev = resolve_device(device)
    arr = np.asarray(arr)
    own = _NP_TO_TORCH.get(arr.dtype, torch.float64)
    t = torch.tensor(arr, dtype=_torch_dtype(dtype, own), device=dev)  # a copy
    if offsets is None:
        if t.dim() != 2 or t.shape[0] != t.shape[1]:
            raise ValueError(f"a dense operator needs a square matrix, got {tuple(t.shape)}")
        return DenseOperator(t)
    offsets = tuple(int(o) for o in offsets)
    if t.dim() != 2 or t.shape[0] != len(offsets):
        raise ValueError(f"bands of shape {tuple(t.shape)} do not match {len(offsets)} offsets")
    return DiaOperator(t.contiguous(), offsets)


def as_operator(mat, dtype=None, *, device="cuda"):
    """The natural device operator for a host container, an ndarray or a
    2-D tensor (counterpart of ``cgx.as_operator``). A tensor must
    already be on ``device``."""
    dev = resolve_device(device)
    if isinstance(mat, DIAMatrix):
        return operator_from_numpy(mat.bands, mat.offsets, dtype=dtype or torch.float64,
                                   device=dev)
    if isinstance(mat, (DenseMatrix, np.ndarray)):
        a = mat.a if isinstance(mat, DenseMatrix) else mat
        return operator_from_numpy(a, dtype=dtype or torch.float64, device=dev)
    if isinstance(mat, torch.Tensor) and mat.dim() == 2:
        check_device(mat, dev, "the matrix")
        return DenseOperator(mat if dtype is None else mat.to(_torch_dtype(dtype, None)))
    if isinstance(mat, (ELLMatrix, CSRMatrix, COOMatrix)) or (
        hasattr(mat, "tocoo") and hasattr(mat, "shape")
    ):
        raise NotImplementedError(
            f"{type(mat).__name__} input: the ELL and CSR operators are not "
            "ported yet (ROADMAP A3); convert to DIAMatrix or dense"
        )
    raise TypeError(f"no operator mapping for {type(mat)}")

"""Preconditioners (counterpart of ``cgx/solver/precond.py``): ``jacobi``
and ``neumann_banded``, in plain torch as cgx leaves them to XLA.

Each constructor returns ``apply(r) -> z = M^-1 r`` for
:func:`cgx_torch.cg_solve`'s ``precond``. ``block_jacobi``,
``chebyshev_banded`` and ``chebyshev_poly`` are not ported yet (ROADMAP
A7).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cgx_torch.ops.dia_spmv import dia_matvec_ref


def jacobi(diag: torch.Tensor, eps: float = 0.0) -> Callable:
    """Jacobi (diagonal) preconditioner: ``z = r / diag(A)``; entries with
    ``|d| <= eps`` are left unscaled."""
    inv = 1.0 / torch.where(diag.abs() > eps, diag, torch.ones_like(diag))

    def apply(r: torch.Tensor) -> torch.Tensor:
        return inv * r

    return apply


def neumann_banded(bands: torch.Tensor, offsets: Sequence[int], omega: float = 1.0,
                   sweeps: int = 1) -> Callable:
    """Truncated-Neumann polynomial preconditioner for banded matrices:
    ``z = sum_{k<sweeps} (I - omega D^-1 A)^k (omega D^-1 r)``.
    ``sweeps=1`` is scaled Jacobi; ``sweeps=2`` is ``2 D^-1 r - D^-1 A
    D^-1 r``, the whole-solve kernel's in-kernel preconditioner."""
    offsets = tuple(int(o) for o in offsets)
    inv_d = omega / bands[offsets.index(0)]

    def apply(r: torch.Tensor) -> torch.Tensor:
        c = inv_d * r
        z = c
        for _ in range(sweeps - 1):
            z = c + z - inv_d * dia_matvec_ref(bands, z, offsets=offsets)
        return z

    return apply

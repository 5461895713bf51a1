"""Differentiable CG solves by the implicit function theorem
(counterpart of ``cgx/solver/autodiff.py``).

For SPD A and ``x = A^-1 b``:

    dL/db = A^-1 g             (one more CG solve with the same A)
    dL/dA = -(A^-1 g) x^T      (projected onto the operator's structure)

so the backward pass is one more solve and one structured outer
product, whatever the forward iteration count, with no stored iterates.
Each solve is a ``torch.autograd.Function`` that takes the operator's
value tensors (a dense ``a``, banded ``bands``, ELL or CSR ``values``)
as explicit inputs, so that their ``.grad`` fills; index tensors take no
gradient, and a stored zero stays zero.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import check_device, resolve_device
from cgx_torch.solver.blockcg import block_cg_solve
from cgx_torch.solver.cg import cg_solve
from cgx_torch.solver.operators import CsrOperator, DenseOperator, DiaOperator, EllOperator


def _values_of(op) -> torch.Tensor:
    """The operator's differentiable tensor."""
    if isinstance(op, DenseOperator):
        return op.a
    if isinstance(op, DiaOperator):
        return op.bands
    if isinstance(op, (EllOperator, CsrOperator)):
        return op.values
    raise TypeError(f"no cotangent rule for {type(op)}")


def _with_values(op, values: torch.Tensor):
    """``op`` with its value tensor replaced (its indices kept)."""
    if isinstance(op, DenseOperator):
        return DenseOperator(values)
    if isinstance(op, DiaOperator):
        return DiaOperator(values, tuple(op.offsets))
    if isinstance(op, EllOperator):
        return EllOperator(values, op.indices)
    return CsrOperator(values, op.indices, op.row_ids, op.n, op.slots)


def _shifted(x: torch.Tensor, offsets, n: int):
    """``x[i + off]`` for each offset, zero outside [0, n): the banded
    product's convention (``pad + off``, as cgx's cotangent has it)."""
    pad = max(max(abs(o) for o in offsets), 1)
    xp = F.pad(x.mT, (pad, pad)).mT if x.dim() == 2 else F.pad(x, (pad, pad))
    return [xp[pad + off: pad + off + n] for off in offsets]


def _matvec_cotangent(op, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y x^T`` projected onto the operator's stored values (cgx
    ``_matvec_cotangent``, autodiff.py:37)."""
    if isinstance(op, DenseOperator):
        return torch.outer(y, x)
    if isinstance(op, DiaOperator):
        return torch.stack([y * xs for xs in _shifted(x, op.offsets, op.shape[0])])
    if isinstance(op, EllOperator):
        return y[:, None] * x[op.indices]
    if isinstance(op, CsrOperator):
        return y[op.row_ids] * x[op.indices]
    raise TypeError(f"no cotangent rule for {type(op)}")


def _block_cotangent(op, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Y X^T`` of (n, s) blocks projected onto the operator's structure
    (cgx ``_matvec_cotangent_block``, autodiff.py:104): dense and banded."""
    if isinstance(op, DenseOperator):
        return y @ x.T
    if isinstance(op, DiaOperator):
        return torch.stack([torch.einsum("ns,ns->n", y, xs)
                            for xs in _shifted(x, op.offsets, op.shape[0])])
    raise TypeError(f"no block cotangent rule for {type(op)}")


class _CGSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, kw, b, values):
        op = _with_values(op, values)
        x = cg_solve(op, b, device=b.device, **kw).x
        ctx.op, ctx.kw = op, kw
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # A is symmetric: the b-gradient solves A y = g
        y = cg_solve(ctx.op, g.contiguous(), device=g.device, **ctx.kw).x
        return None, None, y, -_matvec_cotangent(ctx.op, y, x)


class _BlockCGSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, kw, b, values):
        op = _with_values(op, values)
        x = block_cg_solve(op, b, device=b.device, **kw).x
        ctx.op, ctx.kw = op, kw
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        y = block_cg_solve(ctx.op, g.contiguous(), device=g.device, **ctx.kw).x
        return None, None, y, -_block_cotangent(ctx.op, y, x)


def _operator_and_b(op, b, device):
    dev = resolve_device(device)
    if isinstance(op, torch.Tensor) and op.dim() == 2:
        op = DenseOperator(op)
    values = _values_of(op)
    check_device(values, dev, "the operator's values")
    check_device(b, dev, "b")
    return op, values


def cg_solve_differentiable(
    op,
    b: torch.Tensor,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    *,
    device="cuda",
) -> torch.Tensor:
    """``x = A^-1 b`` as a differentiable function of ``b`` and the
    operator's values (cgx ``cg_solve_differentiable``, autodiff.py:63):
    Dense, DIA, ELL and CSR operators. Returns only x (use
    :func:`cgx_torch.cg_solve` for the whole record)."""
    op, values = _operator_and_b(op, b, device)
    kw = dict(tol=tol, maxiter=maxiter, nearzero=nearzero)
    return _CGSolve.apply(op, kw, b, values)


def block_cg_solve_differentiable(
    op,
    b_block: torch.Tensor,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    *,
    device="cuda",
) -> torch.Tensor:
    """``X = A^-1 B``, every column in one breakdown-free block-CG
    Krylov space, as a differentiable function of ``B`` and the
    operator's values (cgx ``block_cg_solve_differentiable``,
    autodiff.py:124): Dense and DIA operators."""
    op, values = _operator_and_b(op, b_block, device)
    if not isinstance(op, (DenseOperator, DiaOperator)):
        raise TypeError(f"no block cotangent rule for {type(op)}")
    kw = dict(tol=tol, maxiter=maxiter)
    return _BlockCGSolve.apply(op, kw, b_block, values)

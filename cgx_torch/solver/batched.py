"""Batched multi-RHS CG (counterpart of ``cgx/solver/batched.py``).

cgx maps ``cg_solve`` over a (batch, n) b with ``jax.vmap``: its while
loop runs until every member has stopped, and a member that has stopped
keeps its state. Here one reference recurrence runs over the whole
(batch, n) block, one mat-vec of the block an iteration, with a ``k``,
``converged`` and ``breakdown`` per row, and every row frozen from its
own convergence on. The host reads whether all rows have converged once
per ``_CHUNK`` iterations, as the single-vector loop does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.solver.blockcg import block_matvec
from cgx_torch.solver.cg import _CHUNK, CGResult, _as_matvec, as_vector


def rows_matvec(a, dev: torch.device) -> Callable:
    """``V (batch, n) -> A`` applied to every row of ``V``: an operator's
    block product (:func:`cgx_torch.solver.blockcg.block_matvec`) on the
    rows as columns, a single-vector callable row by row under
    ``torch.func.vmap``."""
    if callable(a) and not hasattr(a, "matvec"):
        return torch.func.vmap(_as_matvec(a, dev))
    block = block_matvec(a)
    return lambda v: block(v.mT).mT


def _rows_dot(u: torch.Tensor, v: torch.Tensor, precision) -> torch.Tensor:
    if precision is not None:
        u, v = u.to(precision), v.to(precision)
    return torch.sum(u * v, dim=-1)


def cg_solve_batched(
    a,
    b,
    x0=None,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    history: int = 0,
    dot_precision: Optional[torch.dtype] = None,
    device="cuda",
) -> CGResult:
    """Solve ``A X = B`` for the rows of ``b`` (batch, n), each by the
    reference recurrence (cgx ``cg_solve_batched``, batched.py:24).
    Returns a :class:`~cgx_torch.solver.cg.CGResult` whose fields carry a
    leading batch axis; ``maxiter`` defaults to n."""
    dev = resolve_device(device)
    b = as_vector(b, dev, "b")
    if b.dim() != 2:
        raise ValueError("b must be (batch, n) for the batched solver")
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    maxiter = b.shape[1] if maxiter is None else int(maxiter)
    acc = b.dtype if dot_precision is None else dot_precision
    mv = rows_matvec(a, dev)
    with f32_exact():
        return _batched_loop(mv, b, x0, torch.tensor(tol, dtype=acc, device=dev),
                             torch.tensor(nearzero, dtype=b.dtype, device=dev), maxiter,
                             int(history), dot_precision)


def _batched_loop(mv, b, x0, tol, nearzero, maxiter: int, history: int, dot_precision):
    """cgx's ``cg_loop`` (cg.py:71) for every row at once, unpreconditioned."""
    batch, dev = b.shape[0], b.device
    rows = torch.arange(batch, device=dev)

    def dot(u, v):
        return _rows_dot(u, v, dot_precision)

    x = x0
    r = b - mv(x0)
    p = r
    rsold = dot(r, r)
    rsnew = rsold
    converged = (torch.sqrt(rsold) < tol) | (rsold == 0)
    breakdown = torch.zeros(batch, dtype=torch.bool, device=dev)
    k = torch.zeros(batch, dtype=torch.int32, device=dev)
    # one slot past each trace takes the writes that cgx drops
    hist = torch.full((batch, history + 1), float("nan"), dtype=rsold.dtype, device=dev)
    trash = torch.full((batch,), history, dtype=torch.int32, device=dev)

    done = 0
    while done < maxiter and not bool(converged.all()):  # the one host sync per chunk
        steps = min(_CHUNK, maxiter - done)
        for _ in range(steps):
            active = ~converged
            ap = mv(p)
            conj = dot(p, ap)
            breakdown = breakdown | (active & (conj <= 0))
            alpha = (rsold / torch.maximum(conj, rsold * nearzero)).to(b.dtype)
            col = active[:, None]
            x = torch.where(col, x + alpha[:, None] * p, x)
            r = torch.where(col, r - alpha[:, None] * ap, r)
            rr = dot(r, r)
            res = torch.sqrt(rr)
            if history:
                slot = torch.where(active, torch.clamp(k, max=history), trash)
                hist[rows, slot.long()] = torch.where(active, res, hist[rows, slot.long()])
            conv = res < tol
            beta = (rr / rsold).to(b.dtype)
            upd = active & ~conv
            p = torch.where(upd[:, None], r + beta[:, None] * p, p)
            rsold = torch.where(upd, rr, rsold)
            k = torch.where(upd, k + 1, k)
            rsnew = torch.where(active, rr, rsnew)
            converged = converged | (active & conv)
        done += steps
    return CGResult(
        x=x,
        iterations=k,
        residual_norm=torch.sqrt(rsnew),
        converged=converged,
        rsold=rsold,
        history=hist[:, :history],
        breakdown=breakdown,
    )

"""Chronopoulos-Gear (communication-reduced) CG, optionally
preconditioned (counterpart of ``cgx/solver/pipelined.py``).

Recurrence (u = M^-1 r; plain CG is M = I, u == r):

    r0 = b - A x0 ; u0 = M^-1 r0 ; w0 = A u0
    loop k = 0, 1, ...:
        gamma = <r, u> ; delta = <w, u> [; rr = <r, r>]  # one fused reduction
        if sqrt(rr) < tol: break        # rr == gamma when M == I
        beta  = 0 if k == 0 else gamma / gamma_old
        alpha = gamma / max(delta - beta gamma / alpha_old, gamma NEARZERO)
              (delta in place of the difference when k == 0)
        p = u + beta p ; s = w + beta s      # s == A p by induction
        x = x + alpha p ; r = r - alpha s
        u = M^-1 r ; w = A u
        gamma_old, alpha_old = gamma, alpha

Every scalar of an iteration comes from the vectors of the iteration
before, which is what lets the streaming kernels of
:mod:`cgx_torch.ops.cg_stream` fuse a whole iteration into one launch;
this loop is the plain version they are held against. Breakdown
(``denom <= 0``) is flagged only on an iteration that does not converge.

As in :mod:`cgx_torch.solver.cg`, ``k``, ``converged`` and
``breakdown`` stay on the device; the host reads ``converged`` once per
``_CHUNK`` iterations, and an iteration after convergence inside a
chunk is frozen (every vector, ``k``, ``gamma_old``, ``alpha_old`` and
the history keep their values), so the result does not depend on the
chunk size.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.cg import _CHUNK, CGResult, _as_matvec, as_vector


def pipelined_cg_loop(
    x0: torch.Tensor,
    b: torch.Tensor,
    *,
    matvec: Callable,
    tol: torch.Tensor,
    nearzero: torch.Tensor,
    maxiter: int,
    history: int,
    dot_precision: Optional[torch.dtype] = None,
    precond: Optional[Callable] = None,
) -> CGResult:
    """The recurrence from ``x0`` (cgx ``pipelined.py:49-184``). ``tol``
    is a 0-d tensor of the dots' dtype, ``nearzero`` one of ``b``'s."""
    dtype, dev = b.dtype, b.device
    acc = dtype if dot_precision is None else dot_precision

    def dots(*pairs):
        return tuple(vdot(a, c, precision=dot_precision) for a, c in pairs)

    def pc(v):
        return v if precond is None else precond(v)

    r = b - matvec(x0)
    u = pc(r)
    w = matvec(u)
    x, p, s = x0, torch.zeros_like(r), torch.zeros_like(r)
    (rr0,) = dots((r, r))
    zero = torch.zeros((), dtype=acc, device=dev)
    # a zero start residual would make alpha 0/0 (cgx pipelined.py:83-84)
    converged = (torch.sqrt(rr0) < tol) | (rr0 == 0)
    breakdown = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    g_old = rr0  # a real <r, r>, so a pre-converged exit reports a meaningful rsold
    a_old = torch.ones((), dtype=acc, device=dev)
    trash = torch.full((), history, dtype=torch.int32, device=dev)
    # one slot past the trace takes the writes that cgx drops
    hist = torch.full((history + 1,), float("nan"), dtype=acc, device=dev)

    done = 0
    while done < maxiter and not bool(converged):  # the one host sync per chunk
        for _ in range(min(_CHUNK, maxiter - done)):
            if precond is None:
                gamma, delta = dots((r, u), (w, u))
                rr = gamma
            else:
                gamma, delta, rr = dots((r, u), (w, u), (r, r))
            res = torch.sqrt(rr)
            conv_now = res < tol
            if history:
                slot = torch.where(~converged, torch.clamp(k, max=history), trash)
                hist.index_put_((slot.long().reshape(1),), res.reshape(1))
            upd = ~converged & ~conv_now
            first = k == 0
            beta = torch.where(first, zero, gamma / g_old)
            denom = torch.where(first, delta, delta - beta * gamma / a_old)
            breakdown = breakdown | (upd & (denom <= 0))
            alpha = (gamma / torch.maximum(denom, gamma * nearzero)).to(dtype)
            beta_v = beta.to(dtype)
            p_new = u + beta_v * p
            s_new = w + beta_v * s
            x_new = x + alpha * p_new
            r_new = r - alpha * s_new
            u_new = pc(r_new)
            w_new = matvec(u_new)
            x, r, p, s, w = (torch.where(upd, new, old) for new, old in
                             ((x_new, x), (r_new, r), (p_new, p), (s_new, s), (w_new, w)))
            u = r if precond is None else torch.where(upd, u_new, u)
            g_old = torch.where(upd, gamma, g_old)
            a_old = torch.where(upd, alpha.to(acc), a_old)
            k = torch.where(upd, k + 1, k)
            converged = converged | conv_now
        done += min(_CHUNK, maxiter - done)
    (rr,) = dots((r, r))
    return CGResult(
        x=x,
        iterations=k,
        residual_norm=torch.sqrt(rr),
        converged=converged,
        rsold=g_old,
        history=hist[:history],
        breakdown=breakdown,
    )


def pipelined_cg_solve(
    a,
    b,
    x0=None,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    history: int = 0,
    dot_precision: Optional[torch.dtype] = None,
    precond: Optional[Callable] = None,
    device="cuda",
) -> CGResult:
    """Solve ``A x = b`` by Chronopoulos-Gear CG in plain torch.

    Arguments as :func:`cgx_torch.cg_solve`: ``a`` is an operator with
    ``.matvec``, a 2-D tensor or a callable; ``precond`` an optional
    ``r -> M^-1 r`` (e.g. :func:`cgx_torch.solver.precond.neumann_banded`),
    with which the three scalars of an iteration still come from one
    point of the recurrence."""
    dev = resolve_device(device)
    b = as_vector(b, dev, "b")
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    acc = b.dtype if dot_precision is None else dot_precision
    with f32_exact():
        return pipelined_cg_loop(
            x0, b,
            matvec=_as_matvec(a, dev),
            tol=torch.tensor(tol, dtype=acc, device=dev),
            nearzero=torch.tensor(nearzero, dtype=b.dtype, device=dev),
            maxiter=b.shape[0] if maxiter is None else int(maxiter),
            history=int(history),
            dot_precision=dot_precision,
            precond=precond,
        )

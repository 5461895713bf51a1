"""Conjugate-gradient core (counterpart of ``cgx/solver/cg.py``).

The reference recurrence, in the order of the reference solver (MPI
``CGSolver::solve`` cg.cc:38-156, CUDA cg.cu:166-305):

    r = b - A x0 ; p = r ; rsold = <r, r>
    while k < maxiter:
        Ap    = A p
        conj  = <p, Ap>
        alpha = rsold / max(conj, rsold * NEARZERO)     # cg.cc:107
        x    += alpha p ; r -= alpha Ap
        rsnew = <r, r>
        if sqrt(rsnew) < tol: break                     # cg.cc:120 (abs!)
        p     = r + (rsnew / rsold) p
        rsold = rsnew ; k += 1

``k`` is the 0-based index of the converging iteration (or maxiter),
and on convergence ``p``, ``rsold`` and ``k`` are not updated
(break-before-update), as in cgx. With a preconditioner (cgx
cg.py:93-131) ``z = M^-1 r`` takes the place of ``r`` in ``p`` and in
``rsold = <r, z>``; the stopping test stays on ``sqrt(<r, r>)``.

No host sync per iteration: every scalar (alpha, beta, rsold, k,
converged, breakdown) stays on the device as a 0-d tensor, and the host
reads ``converged`` once per ``_CHUNK`` iterations. With a
preconditioner the chunks grow 1, 2, 4, ... up to ``_CHUNK``, so that a
solve of a few iterations (a multigrid-preconditioned one converges in
about 8) runs at most about as many frozen iterations as live ones, each
of which still applies the preconditioner. An iteration that runs after
convergence inside a chunk is frozen: alpha is 0, and ``p``, ``rsold``,
``k`` and the history keep their values, so the result does not depend
on the chunk size. :func:`run_recurrence` is shared with the
three-kernel loop of :mod:`cgx_torch.solver.fast`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import check_device, f32_exact, resolve_device
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.operators import DenseOperator, GridDiaOperator

_CHUNK = 32  # iterations between host reads of `converged`


class CGResult(NamedTuple):
    """Solve record, field for field as cgx's ``CGResult``."""

    x: torch.Tensor
    iterations: torch.Tensor  # int32: reference-parity k
    residual_norm: torch.Tensor  # sqrt(rsnew) at exit (recursive residual)
    converged: torch.Tensor  # bool
    rsold: torch.Tensor  # sqrt(rsold) is the reference's DEBUG print
    history: torch.Tensor  # (history,) residual-norm trace, nan-padded
    breakdown: torch.Tensor  # <p, Ap> <= 0 was seen: A is not SPD


def run_recurrence(
    x: torch.Tensor,
    r: torch.Tensor,
    rr0: torch.Tensor,
    *,
    mv_dot: Callable,
    update: Callable,
    axpby: Callable,
    tol: torch.Tensor,
    nearzero: torch.Tensor,
    maxiter: int,
    history: int,
    precond: Optional[Callable] = None,
    marks=None,
) -> CGResult:
    """The reference recurrence from ``x`` with residual ``r`` and
    ``rr0 = <r, r>``, through three callables:

    - ``mv_dot(p) -> (Ap, <p, Ap>)``;
    - ``update(x, p, r, Ap, alpha) -> (x + alpha p, r - alpha Ap, <r', r'>)``;
    - ``axpby(p, r, a, b) -> a p + b r``, called with ``(beta, 1)``, or
      with ``(1, 0)`` to keep ``p``;

    and ``precond(r) -> (z, <r, z>)``, or None for ``z = r`` (then
    ``p = r`` and ``rsold = rr0``, the unpreconditioned recurrence).
    Scalars are 0-d tensors; ``tol`` has the dtype of the dots.

    ``marks``, if given, has ``next_iteration()``, called as each loop
    iteration starts, and ``end_loop()``, called when the loop is over:
    the sharded solver passes :mod:`cgx_torch.utils.collectives`, whose
    record of the collectives splits by them."""
    dtype, dev = x.dtype, x.device
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    trash = torch.full((), history, dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    p, rsold = (r, rr0) if precond is None else precond(r)
    rsnew = rr0
    # a zero start residual would make alpha 0/0 (see cgx cg.py:139-144)
    converged = (torch.sqrt(rr0) < tol) | (rr0 == 0)
    breakdown = torch.zeros((), dtype=torch.bool, device=dev)
    # one slot past the trace takes the writes that cgx drops
    hist = torch.full((history + 1,), float("nan"), dtype=rr0.dtype, device=dev)

    done = 0
    chunk = _CHUNK if precond is None else 1
    while done < maxiter and not bool(converged):  # the one host sync per chunk
        steps = min(chunk, maxiter - done)
        for _ in range(steps):
            if marks is not None:
                marks.next_iteration()
            active = ~converged
            ap, conj = mv_dot(p)
            breakdown = breakdown | (active & (conj <= 0))
            alpha = (rsold / torch.maximum(conj, rsold * nearzero)).to(dtype)
            x, r, rr = update(x, p, r, ap, torch.where(active, alpha, zero))
            res = torch.sqrt(rr)
            if history:
                slot = torch.where(active, torch.clamp(k, max=history), trash)
                hist.index_put_((slot.long().reshape(1),), res.reshape(1))
            conv = res < tol
            keep = ~active | conv
            new_dir, rs = (r, rr) if precond is None else precond(r)
            beta = (rs / rsold).to(dtype)
            p = axpby(p, new_dir, torch.where(keep, one, beta), torch.where(keep, zero, one))
            rsold = torch.where(keep, rsold, rs)
            k = torch.where(keep, k, k + 1)
            rsnew = torch.where(active, rr, rsnew)
            converged = converged | conv
        done += steps
        chunk = min(2 * chunk, _CHUNK)
    if marks is not None:
        marks.end_loop()
    return CGResult(
        x=x,
        iterations=k,
        residual_norm=torch.sqrt(rsnew),
        converged=converged,
        rsold=rsold,
        history=hist[:history],
        breakdown=breakdown,
    )


def as_vector(v, dev: torch.device, name: str, dtype=None) -> torch.Tensor:
    """A tensor on ``dev``: NumPy input is copied there; a tensor must
    already be there."""
    if isinstance(v, torch.Tensor):
        check_device(v, dev, name)
        return v if dtype is None else v.to(dtype)
    return torch.tensor(np.asarray(v), dtype=dtype, device=dev)  # a copy


def _as_matvec(a, dev: torch.device) -> Callable:
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        a = DenseOperator(a)
    if hasattr(a, "matvec"):
        for name in ("bands", "a", "values"):
            if isinstance(getattr(a, name, None), torch.Tensor):
                check_device(getattr(a, name), dev, f"the operator's {name}")
        return a.matvec
    if callable(a):
        return a
    raise TypeError(f"cannot interpret {type(a)} as a linear operator")


def cg_solve(
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
    """Solve ``A x = b`` by the reference CG recurrence, in plain torch.

    Args:
      a: an operator with ``.matvec``, a 2-D tensor, or a callable
        ``x -> A x``; its tensors must be on ``device``. A
        :class:`~cgx_torch.solver.operators.GridDiaOperator` without a
        preconditioner runs the loop on grid-shaped vectors.
      b: right-hand side (tensor on ``device``, or NumPy).
      x0: initial guess (zeros by default).
      tol: *absolute* tolerance ``sqrt(<r,r>) < tol``.
      maxiter: iteration cap; defaults to N.
      nearzero: alpha-denominator clamp factor.
      history: length of the residual trace.
      dot_precision: dtype the dots accumulate in (e.g. fp64 for fp32
        vectors); default the vectors' dtype.
      precond: ``r -> M^-1 r`` (see :mod:`cgx_torch.solver.precond`), or
        None.
      device: where the solve runs; ``"cuda"`` unless ``"cpu"`` is asked.
    """
    dev = resolve_device(device)
    b = as_vector(b, dev, "b")
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    acc = b.dtype if dot_precision is None else dot_precision
    n = b.shape[0]
    mv = _as_matvec(a, dev)
    grid = isinstance(a, GridDiaOperator) and precond is None
    if grid:
        # a grid-stencil operator runs the whole loop in its (g,)*ndim
        # layout, as cgx's does (cg.py:222-245): every vector grid-shaped,
        # the dots summed over all axes
        shape = (a.g,) * a.ndim
        mv, b, x0 = a.matvec_grid, b.reshape(shape), x0.reshape(shape)
    with f32_exact():
        res = cg_loop(
            mv, b, x0,
            dots=lambda pairs: tuple(vdot(u, v, precision=dot_precision) for u, v in pairs),
            precond=precond,
            tol=torch.tensor(tol, dtype=acc, device=dev),
            nearzero=torch.tensor(nearzero, dtype=b.dtype, device=dev),
            maxiter=n if maxiter is None else int(maxiter),
            history=int(history),
        )
    return res._replace(x=res.x.reshape(-1)) if grid else res


def cg_loop(
    mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    dots: Callable,
    precond: Optional[Callable],
    tol: torch.Tensor,
    nearzero: torch.Tensor,
    maxiter: int,
    history: int,
    marks=None,
) -> CGResult:
    """The reference recurrence from ``x0`` through ``mv(v) -> A v`` and
    ``dots(pairs) -> tuple`` of the dots of a list of ``(u, v)`` pairs
    (cgx ``cg_loop``, whose ``dot`` hook the sharded solver gives an
    all-reduced dot, ``sharded_cg.py:823-832``); ``precond`` is
    ``r -> M^-1 r`` or None. With a preconditioner ``<r, r>`` and
    ``<r, z>`` go into one ``dots`` call, as neither waits on the other
    (cgx's two reductions, which XLA's combiner fuses). Every scalar is
    0-d on the device; ``tol`` has the dots' dtype. ``marks`` as for
    :func:`run_recurrence`."""

    def dot(u, v):
        return dots([(u, v)])[0]

    def mv_dot(p):
        ap = mv(p)
        return ap, dot(p, ap)

    fused = {}  # the (z, <r, z>) of the update's fused reduction, for apply_precond

    def update(x, p, r, ap, alpha):
        r = r - alpha * ap
        x = x + alpha * p
        if precond is None:
            return x, r, dot(r, r)
        z = precond(r)
        rr, rz = dots([(r, r), (r, z)])
        fused["z"] = (z, rz)
        return x, r, rr

    def axpby(p, r, a_, b_):
        return r * b_ + p * a_  # r + beta p, as cgx's new_dir + beta * p

    def apply_precond(r):
        if "z" in fused:  # run_recurrence asks for the r the update just made
            return fused.pop("z")
        z = precond(r)
        return z, dot(r, z)

    r = b - mv(x0)
    return run_recurrence(
        x0, r, dot(r, r),
        mv_dot=mv_dot, update=update, axpby=axpby,
        precond=None if precond is None else apply_precond,
        tol=tol, nearzero=nearzero, maxiter=maxiter, history=history, marks=marks,
    )

"""Ghysels-Vanroose communication-hiding pipelined CG (counterpart of
``cgx/solver/gvpipe.py``).

Recurrence (u = M^-1 r; plain CG is M = I, so u == r, m == w, q == s):

    r0 = b - A x0 ; u0 = M^-1 r0 ; w0 = A u0
    loop k = 0, 1, ...:
        gamma = <r, u> ; delta = <w, u> [; rr = <r, r>]  # one fused reduction
        m = M^-1 w ; n = A m        # needs no scalar of this iteration
        if sqrt(rr) < tol: break    # rr == gamma when M == I
        beta  = 0 if k == 0 else gamma / gamma_old
        alpha = gamma / max(delta - beta gamma / alpha_old, gamma NEARZERO)
              (delta in place of the difference when k == 0)
        z = n + beta z ; q = m + beta q ; s = w + beta s ; p = u + beta p
        x = x + alpha p ; r = r - alpha s ; u = u - alpha q ; w = w - alpha z
        gamma_old, alpha_old = gamma, alpha

The mat-vec input ``m`` comes from the carried ``w``, so on the sharded
route the all-reduce of the dots and the mat-vec do not wait on each
other. The deeper recursions drift faster than classic CG's; every
``replace_every`` iterations a guarded replacement recomputes r, u, w,
s, q and z from their definitions (cgx gvpipe.py:176-189), while the
carried ``gamma`` stays above ``eps * gamma_0 * max(1, <b, b> / <r0,
r0>)`` (the explicit residual's noise floor, gvpipe.py:103-118).
``replace_every=0`` switches it off. Unlike :mod:`cgx_torch.solver.cg`
and :mod:`cgx_torch.solver.pipelined`, a breakdown (``denom <= 0`` on an
iteration that does not converge) ends the loop with the last finite
state (gvpipe.py:148-160).

As in the other loops, ``k``, ``converged`` and ``breakdown`` stay on
the device; the host reads them once per ``_CHUNK`` iterations (with a
preconditioner after chunks of 1, 2, 4, ... up to ``_CHUNK``), and an
iteration after the loop has ended inside a chunk is frozen. While the
loop is live the device's ``k`` equals the host's iteration index, so
the host knows which iterations are replacement candidates without
reading the device: only those compute the replacement's mat-vecs, and
``torch.where`` on the device guard (live, and gamma above the floor)
selects them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.reduce import vdot
from cgx_torch.solver.cg import _CHUNK, CGResult, _as_matvec, as_vector


def gv_cg_loop(
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
    dots: Optional[Callable] = None,
    replace_every: int = 25,
    marks=None,
) -> CGResult:
    """The recurrence from ``x0`` (cgx ``gv_cg_loop``, gvpipe.py:74).
    ``tol`` is a 0-d tensor of the dots' dtype, ``nearzero`` one of
    ``b``'s. ``dots(pairs) -> tuple`` computes the dots of a list of
    pairs in one fused reduction (the sharded solver all-reduces them in
    one collective); by default each is a local
    :func:`cgx_torch.ops.reduce.vdot`. ``marks`` as for
    :func:`cgx_torch.solver.cg.run_recurrence`."""
    dtype, dev = b.dtype, b.device
    acc = dtype if dot_precision is None else dot_precision
    if dots is None:
        def dots(pairs):
            return tuple(vdot(a, c, precision=dot_precision) for a, c in pairs)
    has_pc = precond is not None

    def pc(v):
        return precond(v) if has_pc else v

    r = b - matvec(x0)
    u = pc(r)
    w = matvec(u)
    if has_pc:
        rr0, g0, bb0 = dots([(r, r), (r, u), (b, b)])
    else:
        rr0, bb0 = dots([(r, r), (b, b)])
        g0 = rr0
    one = torch.ones((), dtype=acc, device=dev)
    zero = torch.zeros((), dtype=acc, device=dev)
    # the replacement floor: the explicit residual's error, scaled by the
    # b-energy ratio for warm starts (cgx gvpipe.py:103-117)
    scale = torch.maximum(one, bb0 / rr0)
    g_floor = torch.finfo(dtype).eps * g0 * scale
    # a zero start residual would make alpha 0/0
    converged = (torch.sqrt(rr0) < tol) | (rr0 == 0)
    breakdown = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    x = x0
    p, s, z = torch.zeros_like(r), torch.zeros_like(r), torch.zeros_like(r)
    q = s
    g_old = rr0  # a real <r, r>, so a pre-converged exit reports a meaningful rsold
    a_old = one
    trash = torch.full((), history, dtype=torch.int32, device=dev)
    # one slot past the trace takes the writes that cgx drops
    hist = torch.full((history + 1,), float("nan"), dtype=acc, device=dev)

    def replace(x, p):
        """r, u, w, s, q and z from their definitions: r = b - A x,
        u = M^-1 r, w = A u, s = A p, q = M^-1 s, z = A q."""
        r_t = b - matvec(x)
        u_t = pc(r_t)
        w_t = matvec(u_t)
        s_t = matvec(p)
        q_t = pc(s_t)
        z_t = matvec(q_t)
        return r_t, u_t, w_t, s_t, q_t, z_t

    done = 0
    chunk = _CHUNK if precond is None else 1
    while done < maxiter and not bool(converged | breakdown):  # the one host sync per chunk
        steps = min(chunk, maxiter - done)
        for i in range(steps):
            if marks is not None:
                marks.next_iteration()
            live = ~(converged | breakdown)
            it = done + i  # the device's k while the loop is live
            if replace_every > 0 and it > 0 and it % replace_every == 0:
                do_rep = live & (g_old > g_floor)
                new = replace(x, p)
                r, u, w, s, q, z = (torch.where(do_rep, nv, ov) for nv, ov in
                                    zip(new, (r, u, w, s, q, z)))
                if not has_pc:  # the aliases u == r and q == s hold for the replaced set
                    u, q = r, s
            if has_pc:
                gamma, delta, rr = dots([(r, u), (w, u), (r, r)])
            else:
                gamma, delta = dots([(r, u), (w, u)])
                rr = gamma
            # the mat-vec input is the carried w: no wait on this iteration's reduction
            m = pc(w)
            n_vec = matvec(m)
            res = torch.sqrt(rr)
            if history:
                slot = torch.where(live, torch.clamp(k, max=history), trash)
                hist.index_put_((slot.long().reshape(1),), res.reshape(1))
            conv_now = res < tol
            first = k == 0
            beta = torch.where(first, zero, gamma / g_old)
            denom = torch.where(first, delta, delta - beta * gamma / a_old)
            breakdown = breakdown | (live & ~conv_now & (denom <= 0))
            converged = converged | (live & conv_now)
            upd = ~(converged | breakdown)
            alpha = (gamma / torch.maximum(denom, gamma * nearzero)).to(dtype)
            beta_v = beta.to(dtype)
            z_new = n_vec + beta_v * z
            s_new = w + beta_v * s
            p_new = u + beta_v * p
            x_new = x + alpha * p_new
            r_new = r - alpha * s_new
            w_new = w - alpha * z_new
            x, r, w, p, s, z = (torch.where(upd, nv, ov) for nv, ov in
                                ((x_new, x), (r_new, r), (w_new, w), (p_new, p), (s_new, s),
                                 (z_new, z)))
            if has_pc:
                q_new = m + beta_v * q
                u_new = u - alpha * q_new
                u, q = torch.where(upd, u_new, u), torch.where(upd, q_new, q)
            else:
                u, q = r, s
            g_old = torch.where(upd, gamma, g_old)
            a_old = torch.where(upd, alpha.to(acc), a_old)
            k = torch.where(upd, k + 1, k)
        done += steps
        chunk = min(2 * chunk, _CHUNK)
    if marks is not None:
        marks.end_loop()
    # the final <r, r> through the loop's reduction: a sharded solve's is global
    (rr,) = dots([(r, r)])
    return CGResult(
        x=x,
        iterations=k,
        residual_norm=torch.sqrt(rr),
        converged=converged,
        rsold=g_old,
        history=hist[:history],
        breakdown=breakdown,
    )


def gv_cg_solve(
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
    replace_every: int = 25,
    device="cuda",
) -> CGResult:
    """Solve ``A x = b`` by Ghysels-Vanroose pipelined CG in plain torch
    (cgx ``gv_cg_solve``, gvpipe.py:288).

    Arguments as :func:`cgx_torch.cg_solve`; ``precond`` is an optional
    ``r -> M^-1 r``, and ``replace_every`` the guarded residual
    replacement's cadence (0 switches it off)."""
    dev = resolve_device(device)
    b = as_vector(b, dev, "b")
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    acc = b.dtype if dot_precision is None else dot_precision
    with f32_exact():
        return gv_cg_loop(
            x0, b,
            matvec=_as_matvec(a, dev),
            tol=torch.tensor(tol, dtype=acc, device=dev),
            nearzero=torch.tensor(nearzero, dtype=b.dtype, device=dev),
            maxiter=b.shape[0] if maxiter is None else int(maxiter),
            history=int(history),
            dot_precision=dot_precision,
            precond=precond,
            replace_every=int(replace_every),
        )

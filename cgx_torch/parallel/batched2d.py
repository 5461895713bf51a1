"""Batched multi-RHS CG over a 2-D mesh of ranks, rows x rhs (counterpart
of ``cgx/parallel/batched2d.py``).

The matrix rows are cut across one axis of the mesh (the reference's row
decomposition) and the right-hand sides across the other (data
parallelism: no communication between rhs groups). A :class:`Mesh2D`
holds two 1-D :class:`~cgx_torch.parallel.mesh.Mesh`es: ``rows``, the
ranks that share this rank's rhs index (its halos and column dots), and
``rhs``, the ranks that share its row index (the convergence vote).
Global rank r sits at (r // n_rhs_groups, r % n_rhs_groups), as cgx's
row-major reshape of the devices puts it.

An iteration communicates what the 1-D row cut does, the halo pair and
the column dots' all-reduce over ``rows``, plus cgx's vote over ``rhs``:
one all-reduce of the count of live columns, where a column is live
while unconverged and under its budget (cgx's ``_live_vote``). cgx's
while loop reads the vote every iteration; the port all-reduces it every
iteration, on the device, and the host reads it once per 32 iterations,
as the port's other loops read ``converged``. Each column freezes on its
own mask, so the iterations past the last live column change nothing.
The loops are cgx's three: the reference recurrence (two all-reduces
over ``rows``), Chronopoulos-Gear (one of every local column's dots) and
Ghysels-Vanroose (the same one, its mat-vec off the reduction's path,
with the per-column guarded replacement on its cadence and breakdown
freezing). The block mat-vec is the 1-D route's on the ``rows`` mesh
(:func:`cgx_torch.parallel.sharded_cg._build_op`: the halo product, or
the gathered block where the bandwidth exceeds the row shard, cgx's
``_Dia2DAllGather``), and Jacobi and Neumann its preconditioners, which
take (n_loc, r_loc) blocks (cgx's ``_Jacobi2D`` and ``_Neumann2D``); cgx's
``_TreeMv2D`` only takes the bands from its tree and has no counterpart.
Plain torch, as cgx's is XLA code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.mats.containers import DIAMatrix
from cgx_torch.ops._util import f32_exact
from cgx_torch.parallel.mesh import ROWS_AXIS, Mesh, local_device
from cgx_torch.parallel.partition import padded_size
from cgx_torch.parallel.sharded_cg import (
    _build_op,
    _host,
    _inv_diag_rows,
    _JacobiPrecond,
    _NeumannPrecond,
    _row_block,
    _solve_dtype,
)
from cgx_torch.utils import collectives

ROWS, RHS = ROWS_AXIS, "rhs"
_CHUNK = 32  # iterations between the host's reads of the vote


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (rows x rhs) mesh of ``shape`` (n_row_groups, n_rhs_groups):
    ``rows`` and ``rhs`` are this rank's two 1-D meshes (``rank == -1``
    in both where this rank is outside the mesh), ``ranks`` the members'
    global ranks, row-major."""

    shape: Tuple[int, int]
    rows: Mesh
    rhs: Mesh
    ranks: Tuple[int, ...]
    device: torch.device
    axis_names: Tuple[str, str] = (ROWS, RHS)

    @property
    def is_member(self) -> bool:
        return self.rows.is_member

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_mesh2d(n_row_groups: int, n_rhs_groups: int, group=None, *, device="cuda") -> Mesh2D:
    """A (rows x rhs) mesh over the first ``n_row_groups * n_rhs_groups``
    ranks of ``group`` (the world by default; cgx's ``make_mesh2d``).

    Every rank of ``group`` must call it, members or not: it makes every
    ``rows`` and ``rhs`` subgroup with ``dist.new_group``, in the same order
    on every rank (a subgroup equal to ``group`` reuses it; one of a single
    rank has identity collectives and no group). Without an
    initialized process group only the (1 x 1) mesh exists, with identity
    collectives."""
    pr, pc = int(n_row_groups), int(n_rhs_groups)
    need = pr * pc
    dev = local_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is not initialized")
        if need > 1:
            raise ValueError(f"need {need} devices, have 1")
        return Mesh2D((1, 1), Mesh(None, 1, 0, (0,), dev, ROWS), Mesh(None, 1, 0, (0,), dev, RHS),
                      (0,), dev)
    group = dist.group.WORLD if group is None else group
    everyone = tuple(dist.get_process_group_ranks(group))
    if need > len(everyone):
        raise ValueError(f"need {need} devices, have {len(everyone)}")
    ranks = everyone[:need]

    def subgroup(members):
        if tuple(members) == everyone:
            return group
        # a one-rank subgroup's collectives are the identity: no group needed
        return None if len(members) == 1 else dist.new_group(ranks=list(members))

    rows_of = [tuple(ranks[i * pc + j] for i in range(pr)) for j in range(pc)]
    rhs_of = [tuple(ranks[i * pc + j] for j in range(pc)) for i in range(pr)]
    rows_groups = [subgroup(m) for m in rows_of]  # every rank makes every group, in order
    rhs_groups = [subgroup(m) for m in rhs_of]
    me = dist.get_rank()
    if me not in ranks:
        return Mesh2D((pr, pc), Mesh(None, pr, -1, (), dev, ROWS), Mesh(None, pc, -1, (), dev, RHS),
                      ranks, dev)
    i, j = divmod(ranks.index(me), pc)
    return Mesh2D((pr, pc), Mesh(rows_groups[j], pr, i, rows_of[j], dev, ROWS),
                  Mesh(rhs_groups[i], pc, j, rhs_of[i], dev, RHS), ranks, dev)


# ---------------------------------------------------------------------------
# The loops, on this rank's (n_loc, r_loc) block
# ---------------------------------------------------------------------------


class _Columns:
    """The loops' collectives: per-column dots over ``rows``, the vote over
    ``rhs``, and the host's reads of it (``marks`` takes the record's
    iteration marks)."""

    def __init__(self, mesh: Mesh2D, maxiter: int, marks):
        self.mesh, self.maxiter, self.marks = mesh, int(maxiter), marks

    def dots(self, pairs):
        """Every pair's column sums stacked, ONE all-reduce over ``rows``
        (cgx's ``_coldots``)."""
        stacked = torch.stack([torch.sum(a * b, dim=0) for a, b in pairs])
        return tuple(collectives.all_reduce(stacked, self.mesh.rows).unbind())

    def vote(self, live: torch.Tensor) -> torch.Tensor:
        """The count of live columns over ``rhs``, on the device (cgx's
        ``_live_vote``)."""
        return collectives.all_reduce(live.to(torch.int32).sum().reshape(1), self.mesh.rhs)

    def run(self, live_of, body):
        """cgx's while loop: each iteration the vote (``live_of()`` on the
        carried state), then ``body()``; the host reads the vote at the
        first iteration and every ``_CHUNK``-th, and stops where no column
        of the mesh is live. The exit test's vote, the one cgx's loop
        evaluates past its last body, moves to the set-up."""
        it = 0
        while True:
            if self.marks is not None:
                self.marks.next_iteration()
            count = self.vote(live_of())
            if it % _CHUNK == 0 and not bool(count[0] > 0):
                if self.marks is not None:
                    self.marks.end_loop(exit_test=True)
                return it
            body(it)
            it += 1


def _freeze(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[None, :], new, old)


def _loop(mv, pc, b, tol, nearzero, cols: _Columns):
    """cgx's ``_loop``: the reference recurrence a column, frozen from its
    convergence on; with a preconditioner ``<R, R>`` and ``<R, Z>`` ride
    one all-reduce, so an iteration has two either way."""
    dtype, maxiter = b.dtype, cols.maxiter
    x = torch.zeros_like(b)
    r = b
    if pc is None:
        z = r
        (rsold,) = cols.dots([(r, r)])
        rr0 = rsold
    else:
        z = pc(r)
        rsold, rr0 = cols.dots([(r, z), (r, r)])
    st = {"k": torch.zeros(b.shape[1], dtype=torch.int32, device=b.device), "x": x, "r": r,
          "p": z, "rsold": rsold, "rr": rr0, "conv": (torch.sqrt(rr0) < tol) | (rr0 == 0),
          "brk": torch.zeros(b.shape[1], dtype=torch.bool, device=b.device)}

    def live():
        return ~st["conv"] & (st["k"] < maxiter)

    def body(_it):
        k, p, rsold, conv = st["k"], st["p"], st["rsold"], st["conv"]
        active = ~conv & (k < maxiter)
        ap = mv(p)
        (conj,) = cols.dots([(p, ap)])
        st["brk"] = st["brk"] | (active & (conj <= 0))
        alpha = torch.where(active, rsold / torch.maximum(conj, rsold * nearzero),
                            torch.zeros_like(rsold)).to(dtype)
        st["x"] = st["x"] + alpha[None, :] * p
        r = st["r"] - alpha[None, :] * ap
        if pc is None:
            (rr,) = cols.dots([(r, r)])
            rsnew, znew = rr, r
        else:
            znew = pc(r)
            rsnew, rr = cols.dots([(r, znew), (r, r)])
        conv_now = torch.sqrt(rr) < tol
        adv = active & ~conv_now
        beta = torch.where(adv, rsnew / rsold, torch.zeros_like(rsold)).to(dtype)
        st["p"] = _freeze(adv, znew + beta[None, :] * p, p)
        st["rsold"] = torch.where(adv, rsnew, rsold)
        st["k"] = torch.where(adv, k + 1, k)
        st["conv"] = conv | (active & conv_now)
        st["r"], st["rr"] = r, rr

    cols.run(live, body)
    return st["x"], st["k"], torch.sqrt(st["rr"]), st["conv"], st["brk"]


def _pipelined_loop(mv, pc, b, tol, nearzero, cols: _Columns):
    """cgx's ``_pipelined_loop``: Chronopoulos-Gear a column, every local
    column's scalars in ONE all-reduce an iteration (two planes, three
    with a preconditioner)."""
    dtype, maxiter, nrhs = b.dtype, cols.maxiter, b.shape[1]
    r = b
    u = r if pc is None else pc(r)
    w = mv(u)
    (rr0,) = cols.dots([(r, r)])
    st = {"k": torch.zeros(nrhs, dtype=torch.int32, device=b.device), "x": torch.zeros_like(b),
          "r": r, "u": u, "p": torch.zeros_like(r), "s": torch.zeros_like(r), "w": w,
          "g_old": rr0, "a_old": torch.ones(nrhs, dtype=dtype, device=b.device),
          "conv": (torch.sqrt(rr0) < tol) | (rr0 == 0),
          "brk": torch.zeros(nrhs, dtype=torch.bool, device=b.device)}

    def live():
        return ~st["conv"] & (st["k"] < maxiter)

    def body(_it):
        k, r, u, w, conv = st["k"], st["r"], st["u"], st["w"], st["conv"]
        if pc is None:
            gamma, delta = cols.dots([(r, u), (w, u)])
            rr = gamma
        else:
            gamma, delta, rr = cols.dots([(r, u), (w, u), (r, r)])
        conv_now = torch.sqrt(rr) < tol
        active = ~conv & (k < maxiter)
        adv = active & ~conv_now
        first = k == 0
        beta = torch.where(first, torch.zeros_like(gamma), gamma / st["g_old"])
        denom = torch.where(first, delta, delta - beta * gamma / st["a_old"])
        st["brk"] = st["brk"] | (adv & (denom <= 0))
        alpha = gamma / torch.maximum(denom, gamma * nearzero)
        alpha_m = torch.where(adv, alpha, torch.zeros_like(alpha)).to(dtype)
        beta_v = beta.to(dtype)
        p = _freeze(adv, u + beta_v[None, :] * st["p"], st["p"])
        s = _freeze(adv, w + beta_v[None, :] * st["s"], st["s"])
        st["x"] = st["x"] + alpha_m[None, :] * p
        r_new = r - alpha_m[None, :] * s
        u_new = r_new if pc is None else pc(r_new)
        w_new = mv(u_new)
        st["p"], st["s"] = p, s
        st["r"] = _freeze(adv, r_new, r)
        st["u"] = _freeze(adv, u_new, u)
        st["w"] = _freeze(adv, w_new, w)
        st["g_old"] = torch.where(adv, gamma, st["g_old"])
        st["a_old"] = torch.where(adv, alpha, st["a_old"])
        st["k"] = torch.where(adv, k + 1, k)
        st["conv"] = conv | (active & conv_now)

    cols.run(live, body)
    (rr_fin,) = cols.dots([(st["r"], st["r"])])
    return st["x"], st["k"], torch.sqrt(rr_fin), st["conv"], st["brk"]


def _gv_loop(mv, pc, b, tol, nearzero, cols: _Columns, replace_every: int = 25):
    """cgx's ``_gv_loop``: Ghysels-Vanroose a column, ONE all-reduce of the
    scalars an iteration whose mat-vec input is the carried W; on the
    cadence (``k % replace_every == 0``, k > 0, above the floor) a column
    takes the guarded residual replacement, its four mat-vecs run where
    any column of the mesh takes it (the second vote over ``rhs``); a
    broken-down column freezes and stops voting."""
    dtype, maxiter, nrhs = b.dtype, cols.maxiter, b.shape[1]
    has_pc = pc is not None
    r = b
    u = r if pc is None else pc(r)
    w = mv(u)
    if has_pc:
        rr0, g0 = cols.dots([(r, r), (r, u)])
    else:
        (rr0,) = cols.dots([(r, r)])
        g0 = rr0
    # the loop starts from x = 0, so <r0, r0> = <b, b> scales the floor
    g_floor = torch.finfo(dtype).eps * g0
    zero = torch.zeros_like(r)
    st = {"k": torch.zeros(nrhs, dtype=torch.int32, device=b.device), "x": torch.zeros_like(b),
          "r": r, "u": u, "w": w, "p": zero, "s": zero, "q": zero, "z": zero, "g_old": g0,
          "a_old": torch.ones(nrhs, dtype=rr0.dtype, device=b.device),
          "conv": (torch.sqrt(rr0) < tol) | (rr0 == 0),
          "brk": torch.zeros(nrhs, dtype=torch.bool, device=b.device)}

    def live():
        return ~(st["conv"] | st["brk"]) & (st["k"] < maxiter)

    def replace():
        r_t = b - mv(st["x"])
        u_t = r_t if pc is None else pc(r_t)
        w_t = mv(u_t)
        s_t = mv(st["p"])
        q_t = s_t if pc is None else pc(s_t)
        return r_t, u_t, w_t, s_t, q_t, mv(q_t)

    def body(it):
        k, g_old = st["k"], st["g_old"]
        active = ~(st["conv"] | st["brk"]) & (k < maxiter)
        if replace_every > 0:
            col_rep = (k > 0) & (k % replace_every == 0) & (g_old > g_floor) & active
            # cgx's lax.cond predicate, all-reduced every iteration as cgx's; a
            # live column's k is the iteration index, so the host knows the
            # candidate iterations without reading it, and only they replace
            any_rep = collectives.all_reduce(col_rep.to(torch.int32).sum().reshape(1),
                                             cols.mesh.rhs)
            if it > 0 and it % replace_every == 0:
                sel = col_rep & (any_rep > 0)
                for name, new in zip(("r", "u", "w", "s", "q", "z"), replace()):
                    st[name] = _freeze(sel, new, st[name])
        r, u, w = st["r"], st["u"], st["w"]
        if pc is None:
            gamma, delta = cols.dots([(r, u), (w, u)])
            rr = gamma
        else:
            gamma, delta, rr = cols.dots([(r, u), (w, u), (r, r)])
        m_ = w if pc is None else pc(w)
        nv = mv(m_)
        conv_now = torch.sqrt(rr) < tol
        adv = active & ~conv_now
        first = k == 0
        beta = torch.where(first, torch.zeros_like(gamma), gamma / g_old)
        denom = torch.where(first, delta, delta - beta * gamma / st["a_old"])
        brk_now = adv & (denom <= 0)
        st["brk"] = st["brk"] | brk_now
        adv = adv & ~brk_now
        alpha = gamma / torch.maximum(denom, gamma * nearzero)
        alpha_m = torch.where(adv, alpha, torch.zeros_like(alpha)).to(dtype)
        beta_v = beta.to(dtype)
        z_n = _freeze(adv, nv + beta_v[None, :] * st["z"], st["z"])
        s_n = _freeze(adv, w + beta_v[None, :] * st["s"], st["s"])
        p_n = _freeze(adv, u + beta_v[None, :] * st["p"], st["p"])
        q_n = s_n if pc is None else _freeze(adv, m_ + beta_v[None, :] * st["q"], st["q"])
        st["x"] = st["x"] + alpha_m[None, :] * p_n
        st["r"] = _freeze(adv, r - alpha_m[None, :] * s_n, r)
        st["u"] = st["r"] if pc is None else _freeze(adv, u - alpha_m[None, :] * q_n, u)
        st["w"] = _freeze(adv, w - alpha_m[None, :] * z_n, w)
        st["p"], st["s"], st["q"], st["z"] = p_n, s_n, q_n, z_n
        st["g_old"] = torch.where(adv, gamma, g_old)
        st["a_old"] = torch.where(adv, alpha, st["a_old"])
        st["k"] = torch.where(adv, k + 1, k)
        st["conv"] = st["conv"] | (active & conv_now)

    cols.run(live, body)
    (rr_fin,) = cols.dots([(st["r"], st["r"])])
    return st["x"], st["k"], torch.sqrt(rr_fin), st["conv"], st["brk"]


def sharded_cg_solve_batched(
    mat: DIAMatrix,
    B,
    *,
    mesh: Optional[Mesh2D] = None,
    row_groups: Optional[int] = None,
    rhs_groups: Optional[int] = None,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    method: str = "reference",
    precond: Optional[str] = None,
    gv_replace_every: int = 25,
    device=None,
):
    """Solve ``A X = B`` for the rows of ``B`` (nrhs, n) over a (rows x
    rhs) mesh (cgx's ``sharded_cg_solve_batched``, batched2d.py:421), each
    right-hand side by its own recurrence.

    Args:
      mat: a banded host matrix, the same on every rank.
      B: (nrhs, n) host array, the same on every rank; float32 solves in
        float32 (the dots too, as cgx's).
      mesh: a :class:`Mesh2D`; by default ``make_mesh2d(row_groups or 1,
        rhs_groups or 1)``.
      method: ``"reference"`` (two all-reduces over ``rows`` an
        iteration), ``"pipelined"`` (one, of every local column's
        scalars) or ``"gvpipe"`` (the same one, off the mat-vec's path,
        with the replacement every ``gv_replace_every`` iterations).
      precond: None, ``"jacobi"`` or ``"neumann"`` (one more mat-vec).

    n is padded to the row groups and nrhs to the rhs groups: a padded
    column is zero and converges at k = 0. Returns cgx's tuple ``(X
    (nrhs, n), iterations (nrhs,), residual_norm (nrhs,), converged
    (nrhs,), breakdown (nrhs,))``, whole on every rank."""
    if mesh is None:
        mesh = make_mesh2d(row_groups or 1, rhs_groups or 1,
                           device="cuda" if device is None else device)
    if not mesh.is_member:
        raise ValueError("this rank is not in the mesh: only its members solve")
    dev = mesh.device if device is None else local_device(device)
    pr, pc_groups = mesh.shape
    B = _host(B)
    nrhs, n = B.shape
    maxiter = n if maxiter is None else int(maxiter)
    dtype = _solve_dtype(B)
    n_pad, r_pad = padded_size(n, pr), padded_size(nrhs, pc_groups)
    n_loc, r_loc = n_pad // pr, r_pad // pc_groups
    j = mesh.rhs.rank
    b_pad = np.zeros((n_pad, r_pad), dtype=B.dtype)
    b_pad[:n, :nrhs] = B.T
    b_loc = _row_block(b_pad[:, j * r_loc:(j + 1) * r_loc], n_pad, mesh.rows, n_loc, dtype, dev)
    # the halo mat-vec over rows, or cgx's _Dia2DAllGather (the gathered
    # block) where the bandwidth exceeds the row shard; both take the block
    mv, diag, _strategy, _kernel = _build_op(mat, n, n_pad, n_loc, mesh.rows, dtype, dev,
                                             "auto", "emulated", "xla")
    pc = None
    if precond is not None:  # cgx's _Jacobi2D and _Neumann2D
        inv_loc = _inv_diag_rows(diag, n, n_pad, mesh.rows, n_loc, dtype, dev)
        if precond == "jacobi":
            pc = _JacobiPrecond(inv_loc)
        elif precond == "neumann":
            pc = _NeumannPrecond(mv, inv_loc)
        else:
            raise ValueError(f"unknown precond {precond!r}")
    if method == "reference":
        loop = _loop
    elif method == "pipelined":
        loop = _pipelined_loop
    elif method == "gvpipe":
        def loop(*args):
            return _gv_loop(*args, replace_every=int(gv_replace_every))
    else:
        raise ValueError(f"unknown method {method!r}")
    cols = _Columns(mesh, maxiter, collectives)
    collectives.begin_program()
    with f32_exact():
        x, k, res, conv, brk = loop(mv, pc, b_loc, torch.tensor(tol, dtype=dtype, device=dev),
                                    torch.tensor(nearzero, dtype=dtype, device=dev), cols)
    collectives.begin_output()
    # the row blocks over rows, then the columns over rhs; every rank gets all
    x_cols = collectives.all_gather(x.mT.contiguous(), mesh.rhs)  # (r_pad, n_loc)
    x_full = collectives.all_gather(x_cols.mT.contiguous(), mesh.rows)  # (n_pad, r_pad)
    k_all, res_all, conv_all, brk_all = (
        collectives.all_gather(t.contiguous(), mesh.rhs)[:nrhs]
        for t in (k, res, conv.to(torch.int32), brk.to(torch.int32)))
    return x_full.mT[:nrhs, :n], k_all, res_all, conv_all.bool(), brk_all.bool()

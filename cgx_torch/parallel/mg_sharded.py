"""Multigrid-preconditioned CG over a 1-D mesh of ranks (counterpart of
``cgx/parallel/mg_sharded.py``, its single-right-hand-side part).

The sharded CG loop (halo mat-vecs, all-reduced dots) with cgx's sharded
Galerkin V-cycle as its preconditioner:

- each rank owns a contiguous block of grid rows, so while the local
  row count stays even the 2x2 transfers are shard-local (aggregation:
  a reshape and a mean-pool or broadcast, no collective; bilinear: the
  trailing axes local, the row axis one grid row of halo from each
  neighbour);
- every level's smoother runs the halo mat-vec of its own bandwidth;
- once a level cannot be pooled locally or is small (``_TAIL_MAX``),
  the residual is gathered once and the tail solved replicated by its
  dense inverse.

The mesh size must divide the grid side; sharded coarsening goes on
while ``g_level / p`` is even. The hierarchy is built on every rank, on
the host in NumPy (cgx's code, :mod:`cgx_torch.solver.multigrid`) or, on
CUDA for N >= 2^18, by the port's band probing on the rank's device
(:func:`~cgx_torch.solver.multigrid.galerkin_probe`, the single-device
"auto" rule). The cycle is plain torch, as cgx's is XLA code: no
hand-written kernel runs on this route. The block form,
:func:`sharded_mg_block_cg_solve`, runs breakdown-free block CG with one
cycle of the whole (n_loc, s) block an iteration.
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.mats.containers import DIAMatrix
from cgx_torch.ops._util import f32_exact
from cgx_torch.parallel.mesh import ROWS_AXIS, Mesh
from cgx_torch.parallel.sharded_cg import (
    _DiaHalo,
    _host,
    _member_mesh,
    _PsumBlockGram,
    _PsumDots,
    _rows,
    _solve_dtype,
)
from cgx_torch.solver.blockcg import BlockCGResult, bf_block_cg_loop
from cgx_torch.solver.cg import CGResult, cg_loop
from cgx_torch.solver.multigrid import (
    MGPreconditioner as MG,
    _color_masks,
    _galerkin_bilinear,
    _galerkin_bilinear_dev,
    _galerkin_cached,
    _galerkin_dia,
    _galerkin_dia_dev,
)
from cgx_torch.utils import collectives

# cgx's replicated tail caps: 33^2 covers a g = 32 coarsest 2-D grid; 3-D
# Galerkin levels widen (up to 7 points an axis), so 16^3 and a margin
_TAIL_MAX = {2: 1100, 3: 4200}
# the hierarchy is probed on the card from this size (MGPreconditioner's rule)
DEVICE_SETUP_MIN = 1 << 18


class _ShardedVCycle:
    """The sharded V-cycle (cgx's ``_ShardedVCycle``): ``levels`` is the
    (bands, offsets, damp) of each sharded level on this rank, the fine
    level first (in the cycle's dtype); ``smooth`` Gauss-Seidel's
    (colour masks, inverse diagonal) a level, or None for Richardson;
    ``tail_inv`` the replicated dense inverse of the coarsest level.
    ``mixed``: an fp32 cycle inside an fp64 recurrence (r cast down and
    the correction back). The cycle takes one vector (n_loc,) or a block
    of columns (n_loc, s), rows on axis 0 as the halo mat-vec's: every
    level then sends ONE halo message a direction for the whole block and
    gathers the tail once, as cgx's vmapped ``_ColumnsVCycle`` does. cgx threads the levels through its program as a
    tree, with ``_TreeMV`` to take the fine bands from it; here each level's
    halo mat-vec holds its own bands, and the CG loop calls the fine one
    (``_build_sharded_mg``'s ``base_mv``) directly."""

    def __init__(self, mesh: Mesh, grids: Tuple[int, ...], levels, tail_inv: torch.Tensor, *,
                 pre: int, post: int, overcorrection: float, transfer: str, ndim: int,
                 smoother: str, smooth, mixed: bool):
        self.mesh, self.p = mesh, mesh.size
        self.grids, self.ndim = tuple(grids), int(ndim)
        self.pre, self.post, self.over = int(pre), int(post), float(overcorrection)
        self.transfer, self.smoother, self.mixed = transfer, smoother, bool(mixed)
        self.damps = [damp for _b, _o, damp in levels]
        self.mvs = [_DiaHalo(mesh, bands, offsets, grids[lvl] ** ndim // self.p)
                    for lvl, (bands, offsets, _d) in enumerate(levels)]
        self.tail_inv, self.smooth = tail_inv, smooth
        self.dtype = tail_inv.dtype

    def _local_shape(self, level: int) -> Tuple[int, ...]:
        g = self.grids[level]
        return (g // self.p,) + (g,) * (self.ndim - 1)

    def _restrict_local(self, r, level):
        shape, cols = self._local_shape(level), tuple(r.shape[1:])
        pooled = sum(((s // 2, 2) for s in shape), ())
        axes = tuple(2 * i + 1 for i in range(self.ndim))
        return r.reshape(pooled + cols).mean(dim=axes).reshape((-1,) + cols)

    def _prolong_local(self, e, level):
        cols = tuple(e.shape[1:])
        a = e.reshape(tuple(s // 2 for s in self._local_shape(level)) + cols)
        for axis in range(self.ndim):
            a = torch.repeat_interleave(a, 2, dim=axis)
        return a.reshape((-1,) + cols)

    # bilinear: the trailing axes are shard-local; the row axis takes one
    # grid row from each neighbour (zeros past the mesh's ends, the
    # Dirichlet exterior). The pair are exact adjoints, as on one device.

    def _row_halos(self, first_row, last_row):
        """(the left neighbour's last row, the right neighbour's first)."""
        return collectives.halo_exchange(first_row.contiguous(), last_row.contiguous(),
                                         self.mesh)

    def _restrict_bilinear(self, r, level):
        cols = tuple(r.shape[1:])
        a = r.reshape(self._local_shape(level) + cols)
        for axis in range(1, self.ndim):
            a = MG._down_axis(a, axis)
        f0, f1 = a[0::2], a[1::2]
        # fine slab 2i-1 of coarse slab 0 is the left neighbour's last; fine
        # slab 2i+2 of the last coarse slab the right neighbour's first
        from_left, from_right = self._row_halos(a[:1], a[-1:])
        f1m = torch.cat([from_left, f1[:-1]])
        f0p = torch.cat([f0[1:], from_right])
        return (0.75 * (f0 + f1) + 0.25 * (f1m + f0p)).reshape((-1,) + cols)

    def _prolong_bilinear(self, e, level):
        shape, cols = self._local_shape(level), tuple(e.shape[1:])
        a = e.reshape(tuple(s // 2 for s in shape) + cols)
        from_left, from_right = self._row_halos(a[:1], a[-1:])
        am1 = torch.cat([from_left, a[:-1]])
        ap1 = torch.cat([a[1:], from_right])
        r0 = 0.75 * a + 0.25 * am1
        r1 = 0.75 * a + 0.25 * ap1
        rows = torch.stack([r0, r1], dim=1).reshape((shape[0],) + tuple(a.shape[1:]))
        for axis in range(1, self.ndim):
            rows = MG._up_axis(rows, axis)
        return rows.reshape((-1,) + cols)

    def _gs_sweep(self, level, z, r, *, start=0, reverse=False):
        """One multicolour Gauss-Seidel sweep with the level's halo mat-vec."""
        colors, dinv = self.smooth[level]
        mv = self.mvs[level]
        nc = colors.shape[0]
        for i in range(start, nc):
            mask = colors[nc - 1 - i] if reverse else colors[i]
            z = z + _rows(mask * dinv, z) * (r - mv(z))
        return z

    def _tail(self, r):
        """The replicated coarsest solve: the residual gathered once."""
        r_full = collectives.all_gather(r, self.mesh)
        e_full = torch.matmul(self.tail_inv, r_full)
        n_loc = r.shape[0]
        start = self.mesh.rank * n_loc
        return e_full[start: start + n_loc]

    def _v(self, level: int, r):
        if level == len(self.grids):
            return self._tail(r)
        mv, damp = self.mvs[level], self.damps[level]
        if self.smoother == "gs":
            colors, dinv = self.smooth[level]
            z = _rows(colors[0] * dinv, r) * r  # the first colour from z = 0: no mat-vec
            z = self._gs_sweep(level, z, r, start=1)
            for _ in range(self.pre - 1):
                z = self._gs_sweep(level, z, r)
        else:
            z = damp * r
            for _ in range(self.pre - 1):
                z = z + damp * (r - mv(z))
        resid = r - mv(z)
        if self.transfer == "bilinear":
            corr = self._prolong_bilinear(
                self._v(level + 1, self._restrict_bilinear(resid, level)), level)
        else:
            corr = self._prolong_local(self._v(level + 1, self._restrict_local(resid, level)),
                                       level)
        z = z + self.over * corr
        if self.smoother == "gs":
            # the adjoint (reversed-colour) sweeps keep the cycle SPD
            for _ in range(self.post):
                z = self._gs_sweep(level, z, r, reverse=True)
        else:
            for _ in range(self.post):
                z = z + damp * (r - mv(z))
        return z

    def __call__(self, r):
        with f32_exact():
            if self.mixed:
                return self._v(0, r.to(self.dtype)).to(r.dtype)
            return self._v(0, r)


_TAIL_INV: dict = {}
_TAIL_INV_MAX_BYTES = 256 * 1024 * 1024


def _tail_inverse(cur: DIAMatrix) -> np.ndarray:
    """The replicated tail's dense inverse, memoised by a hash of its bands
    as the Galerkin products are (:func:`~cgx_torch.solver.multigrid.
    _galerkin_cached`): a sequence of solves on one operator, or of
    set-ups, inverts it once. Oldest entries go first past 256 MB."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(cur.bands).tobytes())
    key = (tuple(int(o) for o in cur.offsets), cur.shape, h.hexdigest())
    hit = _TAIL_INV.get(key)
    if hit is None:
        hit = np.linalg.inv(cur.to_dense())
        while _TAIL_INV and sum(v.nbytes for v in _TAIL_INV.values()) + hit.nbytes \
                > _TAIL_INV_MAX_BYTES:
            _TAIL_INV.pop(next(iter(_TAIL_INV)))
        if hit.nbytes <= _TAIL_INV_MAX_BYTES:
            _TAIL_INV[key] = hit
    return hit


def _coarsen(cur: DIAMatrix, g: int, ndim: int, transfer: str, dev: torch.device) -> DIAMatrix:
    """The Galerkin product of one level: cgx's host build, or band probing
    on the rank's CUDA device from DEVICE_SETUP_MIN fine rows."""
    if dev.type == "cuda" and cur.shape[0] >= DEVICE_SETUP_MIN:
        build = _galerkin_bilinear_dev if transfer == "bilinear" else _galerkin_dia_dev
        return build(cur, g, ndim, device=dev)
    return _galerkin_cached(_galerkin_bilinear if transfer == "bilinear" else _galerkin_dia,
                            cur, g, ndim)


def _build_sharded_mg(mat: DIAMatrix, n: int, g: Optional[int], mesh: Mesh, *, pre_smooth: int,
                      post_smooth: int, omega: float, overcorrection: Optional[float],
                      transfer: str, smoother: str, ndim: int, cycle_precision: str = "fp64",
                      solve_dtype=torch.float64, device=None):
    """The hierarchy and this rank's share of it (cgx's
    ``_build_sharded_mg``): returns ``(vcycle, base_mv, g)``, the fine
    mat-vec in ``solve_dtype``, the cycle in it too or in float32 for
    ``cycle_precision="fp32"`` under a float64 solve."""
    p = mesh.size
    dev = mesh.device if device is None else device
    if g is None:
        g = int(round(n ** (1.0 / ndim)))
    if g ** ndim != n:
        raise ValueError(f"b length {n} is not a {g}^{ndim} grid")
    if g % p != 0:
        raise ValueError(f"mesh size {p} must divide the grid side {g}")
    if transfer not in ("bilinear", "aggregation"):
        raise ValueError(f"unknown transfer {transfer!r}")
    if smoother not in ("richardson", "gs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if overcorrection is None:
        # bilinear's correction is exact on smooth error; aggregation's needs cgx's 1.8
        overcorrection = 1.8 if transfer == "aggregation" else 1.0
    fine = DIAMatrix(mat.shape, tuple(int(o) for o in mat.offsets),
                     np.asarray(mat.bands, np.float64))

    # the sharded levels: while the local rows stay even, the halo fits and
    # the level is larger than the replicated tail's cap
    grids: List[int] = []
    level_mats: List[DIAMatrix] = []
    damps: List[float] = []
    cur, cur_g = fine, g
    tail_max = _TAIL_MAX.get(ndim, 1100)
    while True:
        m_loc, n_loc = cur_g // p, cur_g ** ndim // p
        halo = max(max(abs(o) for o in cur.offsets), 1)
        if not (m_loc % 2 == 0 and halo <= n_loc and cur_g ** ndim > tail_max
                and cur_g % 2 == 0):
            break
        grids.append(cur_g)
        level_mats.append(cur)
        damps.append(float(omega / np.max(cur.bands[list(cur.offsets).index(0)])))
        cur = _coarsen(cur, cur_g, ndim, transfer, dev)
        cur_g //= 2
    # no sharded level is legal (a tail-sized grid on many ranks): the cycle
    # is then one replicated exact solve
    fine_halo = max(max(abs(o) for o in fine.offsets), 1)
    if fine_halo > n // p:
        raise ValueError(f"fine-level halo {fine_halo} exceeds the shard size {n // p}; use "
                         "fewer shards or plain sharded_cg_solve")
    if cur.shape[0] > tail_max:
        raise ValueError(f"replicated tail would be {cur.shape[0]} > {tail_max}; use more "
                         "coarsenable geometry (g = p * 2^k) or plain sharded_cg_solve")
    if cycle_precision not in ("fp64", "fp32"):
        raise ValueError(f"unknown cycle_precision {cycle_precision!r}")
    if solve_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported solve dtype {solve_dtype}")
    # an fp32 cycle inside fp64 CG; with an fp32 b the whole solve is fp32
    mixed = cycle_precision == "fp32" and solve_dtype == torch.float64
    cyc = torch.float32 if (mixed or solve_dtype == torch.float32) else solve_dtype

    def rows_of(arr, level_g):
        n_loc = level_g ** ndim // p
        lo = mesh.rank * n_loc
        return torch.tensor(np.ascontiguousarray(arr[..., lo: lo + n_loc]), dtype=cyc,
                            device=dev)

    levels = [(rows_of(m.bands, grids[lvl]), tuple(int(o) for o in m.offsets), damps[lvl])
              for lvl, m in enumerate(level_mats)]
    smooth = None
    if smoother == "gs":
        smooth = []
        for lvl, m in enumerate(level_mats):
            masks = _color_masks(grids[lvl], ndim, m.offsets)
            if masks is None:
                raise ValueError(f"smoother='gs' needs grid-stencil levels (level {lvl} offsets "
                                 f"{m.offsets} do not decode on the {grids[lvl]}^{ndim} grid)")
            d0 = list(m.offsets).index(0)
            smooth.append((rows_of(np.stack(masks), grids[lvl]),
                           rows_of(1.0 / m.bands[d0], grids[lvl])))
    tail_inv = torch.tensor(_tail_inverse(cur), dtype=cyc, device=dev)
    vcycle = _ShardedVCycle(mesh, tuple(grids), levels, tail_inv, pre=pre_smooth,
                            post=post_smooth, overcorrection=overcorrection, transfer=transfer,
                            ndim=ndim, smoother=smoother, smooth=smooth, mixed=mixed)
    n_loc = n // p
    lo = mesh.rank * n_loc
    fine_loc = torch.tensor(np.ascontiguousarray(fine.bands[:, lo: lo + n_loc]),
                            dtype=solve_dtype, device=dev)
    base_mv = _DiaHalo(mesh, fine_loc, tuple(fine.offsets), n_loc)
    return vcycle, base_mv, g


def sharded_mg_cg_setup(
    mat: DIAMatrix,
    b,
    g: Optional[int] = None,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    history: int = 0,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega: float = 0.8,
    overcorrection: Optional[float] = None,
    transfer: str = "bilinear",
    smoother: str = "richardson",
    cycle_precision: str = "fp64",
    ndim: int = 2,
    axis_name: str = ROWS_AXIS,
    device=None,
) -> Callable[[], CGResult]:
    """The set-up of :func:`sharded_mg_cg_solve`: the mesh, the hierarchy
    and this rank's share of it and of ``b``; returns the solve as a call,
    which repeats it on the same hierarchy. ``mat`` is a
    banded host matrix on a g^ndim grid (g inferred when omitted), ``b``
    a host array of length g^ndim, the same on every rank; a float32
    ``b`` solves in float32. ``cycle_precision="fp32"`` runs the cycle in
    float32 inside the float64 recurrence. The mesh size must divide g.
    Per iteration: the fine halo mat-vec, the cycle's level halos and its
    one tail gather, and the CG dots (the conjugacy dot, then <r, r> and
    <r, z> in one all-reduce)."""
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    b = _host(b)
    dtype = _solve_dtype(b)
    n = b.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    vcycle, base_mv, g = _build_sharded_mg(
        mat, n, g, mesh, pre_smooth=pre_smooth, post_smooth=post_smooth, omega=omega,
        overcorrection=overcorrection, transfer=transfer, smoother=smoother, ndim=ndim,
        cycle_precision=cycle_precision, solve_dtype=dtype, device=dev)
    n_loc = n // mesh.size
    lo = mesh.rank * n_loc
    b_loc = torch.tensor(np.ascontiguousarray(b[lo: lo + n_loc]), dtype=dtype, device=dev)
    tol_t = torch.tensor(tol, dtype=dtype, device=dev)
    nearzero_t = torch.tensor(nearzero, dtype=dtype, device=dev)

    def run() -> CGResult:
        collectives.begin_program()
        with f32_exact():
            res = cg_loop(base_mv, b_loc, torch.zeros_like(b_loc),
                          dots=_PsumDots(mesh, None, separate=True), precond=vcycle,
                          tol=tol_t, nearzero=nearzero_t, maxiter=maxiter,
                          history=int(history), marks=collectives)
        collectives.begin_output()
        return res._replace(x=collectives.all_gather(res.x, mesh))

    return run


def sharded_mg_cg_solve(mat: DIAMatrix, b, g: Optional[int] = None, **options) -> CGResult:
    """Row-sharded CG preconditioned by the sharded Galerkin V-cycle
    (cgx's ``sharded_mg_cg_solve``, mg_sharded.py:428):
    :func:`sharded_mg_cg_setup` (see there for the options) and one
    solve."""
    return sharded_mg_cg_setup(mat, b, g, **options)()


def sharded_mg_block_cg_setup(
    mat: DIAMatrix,
    b_block,
    g: Optional[int] = None,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    rank_tol: float = 1e-12,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega: float = 0.8,
    overcorrection: Optional[float] = None,
    transfer: str = "bilinear",
    smoother: str = "richardson",
    cycle_precision: str = "fp64",
    ndim: int = 2,
    axis_name: str = ROWS_AXIS,
    device=None,
) -> Callable[[], BlockCGResult]:
    """The set-up of :func:`sharded_mg_block_cg_solve`: the mesh, the
    hierarchy and this rank's share of it and of the (n, s) ``b_block``;
    returns the solve as a call, which repeats it on the same hierarchy.
    ``run.vcycle`` is the rank's cycle."""
    b_block = _host(b_block)
    if b_block.ndim != 2:
        raise ValueError("b_block must be (n, s)")
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    n = b_block.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    dtype = _solve_dtype(b_block)
    vcycle, base_mv, g = _build_sharded_mg(
        mat, n, g, mesh, pre_smooth=pre_smooth, post_smooth=post_smooth, omega=omega,
        overcorrection=overcorrection, transfer=transfer, smoother=smoother, ndim=ndim,
        cycle_precision=cycle_precision, solve_dtype=dtype, device=dev)
    n_loc = n // mesh.size
    lo = mesh.rank * n_loc
    b_loc = torch.tensor(np.ascontiguousarray(b_block[lo: lo + n_loc]), dtype=dtype, device=dev)

    def run() -> BlockCGResult:
        collectives.begin_program()
        with f32_exact():
            res = bf_block_cg_loop(base_mv, b_loc, torch.zeros_like(b_loc), tol, maxiter=maxiter,
                                   rank_tol=rank_tol, gram=_PsumBlockGram(mesh), precond=vcycle,
                                   marks=collectives)
        collectives.begin_output()
        return res._replace(x=collectives.all_gather(res.x, mesh))

    run.vcycle = vcycle
    return run


def sharded_mg_block_cg_solve(mat: DIAMatrix, b_block, g: Optional[int] = None,
                              **options) -> BlockCGResult:
    """Row-sharded breakdown-free block CG preconditioned by the sharded
    Galerkin V-cycle (cgx's ``sharded_mg_block_cg_solve``,
    mg_sharded.py:545, "the production multi-RHS path"):
    :func:`sharded_mg_block_cg_setup` (options as :func:`sharded_mg_cg_setup`,
    with ``rank_tol``) and one solve. One Krylov space for every column of
    the (n, s) ``b_block``, the cycle applied to the whole block at once:
    cgx vmaps its cycle over the columns, so each level exchanges one
    batched halo message a direction and the tail is gathered once for the
    block; the port's cycle takes the block as it is, with the same
    collectives. An iteration: the block halo mat-vec, one cycle of width
    s, the (3s, 3s) Gram all-reduce and the (3s, s) strip's. A float32 b
    solves in float32. Returns a :class:`~cgx_torch.solver.blockcg.
    BlockCGResult` with the whole (n, s) x on every rank."""
    return sharded_mg_block_cg_setup(mat, b_block, g, **options)()

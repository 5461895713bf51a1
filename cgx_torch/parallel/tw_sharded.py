"""Sharded triple-word float32 refinement (counterpart of
``cgx/parallel/tw_sharded.py``): fp64-quality answers on a mesh of ranks.

The triple-word sweeps of :func:`cgx_torch.solver.refine.
refine_pcg_sweeps_tw` run on every rank over its rows:

- the solution and residual words shard like any vector (triple-word
  arithmetic is elementwise float32);
- the outer triple-word banded product takes the neighbours' rows of
  the three words in one exchange a direction, then runs the error-free
  chain of :func:`cgx_torch.ops.tw32.banded_matvec_tw`, equal to it bit
  for bit on every row, edges included;
- the outer residual norm is summed in the single-device order: the
  fp64 view of the residual is gathered once a sweep and reduced whole,
  so the sweeps' scale factors do not depend on the mesh;
- the float32 inner is the sharded machinery: MG-PCG
  (:mod:`cgx_torch.parallel.mg_sharded`) on an operator that decodes on
  a grid, plain halo CG otherwise.

``inner_dot="gathered"`` reduces every dot of the inner in the same
order (both operands gathered), so the whole solve is bitwise the
single-device one; the default ``"psum"`` keeps the reference's local
dot and all-reduce and certifies the same gate. No hand-written kernel
runs on this route (cgx's is XLA code).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cgx_torch.mats.containers import COOMatrix, DIAMatrix
from cgx_torch.ops import tw32
from cgx_torch.ops._util import f32_exact
from cgx_torch.ops.reduce import vdot
from cgx_torch.parallel.mesh import ROWS_AXIS, Mesh, local_device, make_mesh
from cgx_torch.parallel.sharded_cg import _DiaHalo, _host, _PsumDots
from cgx_torch.solver.cg import cg_loop
from cgx_torch.utils import collectives


class TWShardedResult(NamedTuple):
    x_words: Tuple  # the float32 triple, gathered: the whole solution
    outer_iterations: int
    inner_iterations: torch.Tensor
    residual_norm: torch.Tensor  # the triple-word true ||b - A x||
    converged: torch.Tensor
    residual_history: torch.Tensor

    @property
    def x(self) -> torch.Tensor:
        return tw32.tw_to_f64(self.x_words)


def _tw_halo_matvec(bands_loc: torch.Tensor, offsets, x, mesh: Mesh):
    """The halo'd triple-word banded product, bitwise
    :func:`cgx_torch.ops.tw32.banded_matvec_tw` on the rank's rows: the
    three words extended by one exchange a direction (stacked), zeros past
    the mesh's ends as ``_shift32``'s, then the same chain a band.
    ``bands_loc`` is the (ndiag, n_loc) float32 bands or the (3, ndiag,
    n_loc) split of :func:`~cgx_torch.ops.tw32.split_bands_tw`."""
    n_loc = x[0].shape[0]
    h = max(max(abs(int(o)) for o in offsets), 1)
    if h > n_loc:
        raise ValueError(f"halo {h} exceeds shard size {n_loc}")
    xs = torch.stack(x)  # (3, n_loc)
    left, right = collectives.halo_exchange(xs[:, :h].contiguous(), xs[:, -h:].contiguous(),
                                            mesh)
    ext = torch.cat([left, xs, right], dim=1)
    planes = bands_loc.dim() == 3
    acc = None
    for d, off in enumerate(offsets):
        t0, t1, t2 = (ext[i, h + off: h + off + n_loc] for i in range(3))
        if planes:
            c0, c1, c2 = bands_loc[0, d], bands_loc[1, d], bands_loc[2, d]
            p00, q00 = tw32.two_prod32(c0, t0)
            p01, q01 = tw32.two_prod32(c0, t1)
            p10, q10 = tw32.two_prod32(c1, t0)
            lo = c0 * t2 + c1 * t1 + c2 * t0 + q01 + q10
            s1, e1 = tw32.two_sum32(p01, q00)
            s2, e2 = tw32.two_sum32(s1, p10)
            term = tw32.tw_renorm(p00, s2, lo + e1 + e2)
        else:
            bd = bands_loc[d]
            p0, q0 = tw32.two_prod32(bd, t0)
            p1, q1 = tw32.two_prod32(bd, t1)
            p2 = bd * t2 + q1
            s1, e1 = tw32.two_sum32(p1, q0)
            term = tw32.tw_renorm(p0, s1, p2 + e1)
        acc = term if acc is None else tw32.tw_add_tw(acc, term)
    return acc


class _GatheredDot:
    """Dots in the single-device order: both operands gathered whole and
    reduced as one device reduces them, so the scalars are bitwise those
    of one device on any mesh (parity; the production dots are
    :class:`~cgx_torch.parallel.sharded_cg._PsumDots`). Takes a list of
    pairs, as ``cg_loop``'s ``dots``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, pairs):
        return tuple(vdot(collectives.all_gather(a, self.mesh),
                          collectives.all_gather(b, self.mesh)) for a, b in pairs)


def _tw_sharded_loop(bands_loc, b64_loc, target, *, offsets, sweeps: int, inner_tol: float,
                     inner_maxiter: int, matvec, precond, dots, mesh: Mesh, marks=None):
    """The sweeps on the rank (cgx's ``_tw_sharded_loop``, the recurrence
    of ``refine_pcg_sweeps_tw``): the rank's words, the residual norm, the
    sweeps run, the inner iterations and the norm a sweep. The host reads
    the norm once a sweep."""
    f32 = torch.float32
    dev = b64_loc.device
    b_tw = tw32.tw_from_f64(b64_loc)
    tiny = torch.finfo(torch.float64).tiny

    def canon_norm(v):
        vg = collectives.all_gather(v, mesh)
        return torch.sqrt(torch.sum(vg * vg))

    x = tw32.tw_zero_like(b64_loc)
    r0, rnorm = b_tw[0], canon_norm(b64_loc)
    hist = torch.full((int(sweeps),), float("nan"), dtype=torch.float64, device=dev)
    k, inner_total = 0, torch.zeros((), dtype=torch.int32, device=dev)
    inner_tol_t = torch.tensor(inner_tol, dtype=f32, device=dev)
    nz = torch.tensor(1e-14, dtype=f32, device=dev)
    while k < sweeps and bool(rnorm >= target):  # the one host read a sweep
        if marks is not None:
            marks.next_iteration()
        safe32 = torch.clamp(rnorm, min=tiny).to(f32)
        r_in = (r0 / safe32).to(f32)
        with f32_exact():
            inner = cg_loop(matvec, r_in, torch.zeros_like(r_in), dots=dots, precond=precond,
                            tol=inner_tol_t, nearzero=nz, maxiter=int(inner_maxiter), history=0)
        d32 = inner.x.to(f32)
        zeros = torch.zeros_like(d32)
        x = tw32.tw_add_tw(x, tw32.tw_scale_f32((d32, zeros, zeros), safe32))
        ax = _tw_halo_matvec(bands_loc, offsets, x, mesh)
        r_tw = tw32.tw_add_tw(b_tw, tw32.tw_neg(ax))
        rnorm = canon_norm(r_tw[0].to(torch.float64) + r_tw[1].to(torch.float64))
        r0 = r_tw[0]
        hist[k] = rnorm
        k += 1
        inner_total = inner_total + inner.iterations
    if marks is not None:
        marks.end_loop()
    return x, rnorm, k, inner_total, hist


def sharded_tw_setup(
    mat,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    rtol: float = 1e-12,
    tol: float = 0.0,
    sweeps: int = 16,
    inner_tol: float = 1e-6,
    inner_maxiter: Optional[int] = None,
    precond: Optional[str] = "auto",
    ndim: Optional[int] = None,
    smoother: str = "richardson",
    inner_dot: str = "psum",
    axis_name: str = ROWS_AXIS,
    device=None,
) -> Callable[[], TWShardedResult]:
    """The set-up of :func:`sharded_tw_solve`: the mesh, the outer bands,
    the inner's hierarchy or mat-vec and this rank's share of ``b``;
    returns the sweeps as a call, which repeats them on the same set-up.

    Args:
      mat: a host ``DIAMatrix`` (a ``COOMatrix`` is converted); the mesh
        size must divide N.
      b: a host array, the same on every rank.
      precond: "auto" (MG-PCG inner where the operator decodes on a grid,
        plain halo CG otherwise), "mg" (the grid required) or None.
      inner_dot: "psum" (local dots, one all-reduce) or "gathered" (every
        dot in the single-device order: bitwise the single-device solve).
      inner_maxiter: the inner cap; default 80 with MG, else N.
    """
    if isinstance(mat, COOMatrix):
        mat = DIAMatrix.from_coo(mat)
    if not isinstance(mat, DIAMatrix):
        raise ValueError("sharded_tw_solve needs a banded (DIA) operator")
    if inner_dot not in ("psum", "gathered"):
        raise ValueError(f"unknown inner_dot {inner_dot!r}")
    if mesh is None:
        mesh = make_mesh(n_devices, device="cuda" if device is None else device,
                         axis_name=axis_name)
    if not mesh.is_member:
        raise ValueError("this rank is not in the mesh: only its members solve")
    dev = mesh.device if device is None else local_device(device)
    p = mesh.size
    n = int(mat.shape[0])
    if n % p:
        raise ValueError(f"mesh size {p} must divide n={n}")
    n_loc = n // p
    lo = mesh.rank * n_loc
    offsets = tuple(int(o) for o in mat.offsets)
    halo = max(max(abs(o) for o in offsets), 1)
    if halo > n_loc:
        raise ValueError(f"halo {halo} exceeds shard size {n_loc}; use fewer devices")
    bands64 = np.asarray(mat.bands, np.float64)
    bands32 = bands64.astype(np.float32)
    # the outer residual's bands: exact in float32, or their exact 3-word
    # split, so that the gate certifies the true operator
    if tw32.bands_f32_exact(bands64):
        outer = torch.tensor(np.ascontiguousarray(bands32[:, lo: lo + n_loc]), device=dev)
    else:
        outer = tw32.split_bands_tw(bands64[:, lo: lo + n_loc]).to(dev)
    b64 = torch.as_tensor(_host(b, np.float64))
    # ||b|| summed as one device sums it
    target = torch.clamp(rtol * torch.sqrt(vdot(b64, b64)), min=float(tol)).to(dev)
    b_loc = b64[lo: lo + n_loc].to(dev)

    dots = _PsumDots(mesh, None, separate=True) if inner_dot == "psum" else _GatheredDot(mesh)
    inner_mv = inner_pc = None
    if precond in ("auto", "mg"):
        from cgx_torch.parallel.mg_sharded import _build_sharded_mg
        from cgx_torch.solver.multigrid import infer_grid_ndim

        try:
            nd = ndim or infer_grid_ndim(n, offsets)
            vcycle, base_mv, _g = _build_sharded_mg(
                mat, n, None, mesh, pre_smooth=2, post_smooth=2, omega=0.8,
                overcorrection=None, transfer="bilinear", smoother=smoother, ndim=nd,
                cycle_precision="fp32", solve_dtype=torch.float32, device=dev)
            inner_mv, inner_pc = base_mv, vcycle
        except ValueError:
            if precond == "mg":
                raise
    elif precond is not None:
        raise ValueError(f"unknown precond {precond!r}")
    if inner_mv is None:
        inner_mv = _DiaHalo(mesh, torch.tensor(np.ascontiguousarray(bands32[:, lo: lo + n_loc]),
                                               device=dev), offsets, n_loc)
    if inner_maxiter is None:
        # MG inners converge in tens of iterations; plain CG needs the Krylov budget
        inner_maxiter = 80 if inner_pc is not None else n

    def run() -> TWShardedResult:
        collectives.begin_program()
        x, res, k, inner_total, hist = _tw_sharded_loop(
            outer, b_loc, target, offsets=offsets, sweeps=int(sweeps),
            inner_tol=float(inner_tol), inner_maxiter=int(inner_maxiter), matvec=inner_mv,
            precond=inner_pc, dots=dots, mesh=mesh, marks=collectives)
        collectives.begin_output()
        words = tuple(collectives.all_gather(w.contiguous(), mesh) for w in x)
        return TWShardedResult(x_words=words, outer_iterations=k,
                               inner_iterations=inner_total.reshape(1), residual_norm=res,
                               converged=res < target, residual_history=hist)

    return run


def sharded_tw_solve(mat, b, **options) -> TWShardedResult:
    """Triple-word float32 refinement of ``A x = b`` over a mesh of ranks
    (cgx's ``sharded_tw_solve``, tw_sharded.py:222): converged when the
    triple-word true residual is below ``max(tol, rtol ||b||)``, as
    :func:`cgx_torch.solver.refine.refine_pcg_sweeps_tw`.
    :func:`sharded_tw_setup` (see there for the options) and the sweeps."""
    return sharded_tw_setup(mat, b, **options)()

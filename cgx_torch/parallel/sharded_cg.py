"""Distributed CG over a 1-D mesh of ranks (counterpart of
``cgx/parallel/sharded_cg.py``, the route of one right-hand side).

The reference's communication an iteration (SURVEY §2.5) is two
``MPI_Allreduce`` of one scalar (cg.cc:106, 117) and one
``MPI_Allgatherv`` of p (cg.cc:135). cgx runs the whole solve as one
``shard_map`` program; the port runs the same program once per rank
(SPMD), on ``torch.distributed``: NCCL on the card, gloo on the CPU.
Every rank calls the same entry point with the same host arguments,
keeps its row block of the padded operator and vectors on its device,
and gets the same :class:`~cgx_torch.solver.cg.CGResult`, whose ``x`` is
the full length-n vector, gathered once after the loop.

Every collective goes through :mod:`cgx_torch.utils.collectives`, in
the same order on every rank: cgx's ``psum`` of dots is one
``all_reduce`` of the partials, its ``ppermute`` halos one
``batch_isend_irecv`` with the two neighbours, ``all_gather`` and
``psum_scatter`` the tensor forms. Convergence decisions come from
all-reduced scalars, so every rank leaves the loop at the same k; the
host reads ``converged`` once per 32 iterations, as the single-device
loops do, and the frozen iterations after convergence issue their
collectives all the same.

Strategies (cgx's):

- ``allgather``: every format; p is gathered and the local rows applied;
- ``reducescatter``: dense only; ``psum_scatter(A_loc^T p_loc)``, A = A^T;
- ``halo``: banded only; the two neighbours' edge rows of p, O(bandwidth)
  elements instead of O(N). The local product is ``"xla"`` (plain torch
  shifted products) or ``"stream2d"``: kernel B8
  (:func:`cgx_torch.ops.dia_spmv.dia_matvec_stream2d_planes`) on the
  shard's pre-padded band planes, its zero-boundary result patched in the
  h edge rows that see the halo. ``"auto"`` takes B8 for a float32 shard
  of at least :data:`STREAM_LOCAL_MIN_ELEMS` rows on CUDA (cgx's rule).

The methods are ``reference`` (two all-reduces an iteration),
``pipelined`` (Chronopoulos-Gear: one all-reduce of two dots, three with
a preconditioner), ``gvpipe`` (Ghysels-Vanroose: the same one all-reduce,
which the iteration's mat-vec does not wait on, and the guarded residual
replacement's four more mat-vecs every ``gv_replace_every`` iterations)
``chebyshev`` (the Chebyshev iteration on ``bounds``: no all-reduce
but one every ``check_every`` iterations) and ``sstep`` (s iterations a
Gram all-reduce: the basis from per-mat-vec halos, ``sstep_powers="off"``;
from one deep halo a block, ``"deephalo"``; or by kernels B10 per shard
on neighbour halos, ``"fused"``, :mod:`cgx_torch.parallel.sstep_fused`),
with no preconditioner, ``jacobi``, ``block_jacobi``
(the shard's diagonal blocks inverted once, applied as one local batched
product: no collective), ``neumann`` or ``chebyshev`` (degree 3, three
strategy mat-vecs an application). A dense fp64 operator takes cgx's
Ozaki int8 slices under ``dense_fp64="ozaki"`` (allgather only).
The multi-RHS and recycling solves are cgx's: :func:`sharded_block_cg_solve`,
:func:`sharded_cg_solve_harvest`, :func:`sharded_deflated_cg_solve`,
:func:`sharded_block_deflated_cg_solve` (the 2-D rows x rhs mesh is
:mod:`cgx_torch.parallel.batched2d`). Operations that cgx leaves to XLA
are plain torch here.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.mats.containers import COOMatrix, CSRMatrix, DenseMatrix, DIAMatrix, ELLMatrix
from cgx_torch.ops import dia_spmv
from cgx_torch.ops.ozaki import _ozaki_apply, _pad_cols, build_slices_np
from cgx_torch.ops._util import f32_exact
from cgx_torch.ops.reduce import vdot
from cgx_torch.ops.tw32 import comp_block_gram
from cgx_torch.parallel.mesh import ROWS_AXIS, Mesh, local_device, make_mesh
from cgx_torch.parallel.partition import pad_bands, pad_dense, pad_vector, padded_size
from cgx_torch.solver.blockcg import bf_block_cg_loop, bf_block_deflated_cg_loop, block_cg_loop
from cgx_torch.solver.cg import CGResult, cg_loop
from cgx_torch.solver.chebyshev import cheby_loop, host_matvec, host_spectral_bounds
from cgx_torch.solver.deflated import (
    _harvest_cg_loop,
    _local_tallT,
    _ritz_from_cg_window,
    deflated_cg_loop,
    lanczos_ritz,
)
from cgx_torch.solver.gvpipe import gv_cg_loop
from cgx_torch.solver.operators import CsrOperator, EllOperator, _torch_dtype
from cgx_torch.solver.pipelined import pipelined_cg_loop
from cgx_torch.solver.precond import chebyshev_poly, diag_blocks, invert_spd_blocks
from cgx_torch.solver.sstep import _local_gram, basis_columns_fn, newton_shifts, sstep_cg_loop
from cgx_torch.utils import collectives

# Per-shard rows from which "auto" streams the local banded product through
# B8 (cgx's threshold, sharded_cg.py:1124, measured there on a TPU; kept as
# the rule, not as a number about the H100).
STREAM_LOCAL_MIN_ELEMS = 2_000_000
# cgx's per-shard band-plane tile (sharded_cg.py:192-195)
PLANE_ROWS, PLANE_COLS = 256, 512

METHODS = ("reference", "pipelined", "gvpipe", "chebyshev", "sstep")
SSTEP_POWERS = ("off", "deephalo", "fused")
PRECONDS = (None, "jacobi", "block_jacobi", "neumann", "chebyshev")
CHEBYSHEV_DEGREE = 3  # cgx's sharded polynomial (sharded_cg.py:794)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _host(v, dtype=None) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v) if dtype is None else np.asarray(v, dtype)


# ---------------------------------------------------------------------------
# Local mat-vecs, one a strategy and format; each holds its shard's operator
# and maps p_loc to (A p)_loc, with its collectives.
# ---------------------------------------------------------------------------


class _DenseAllGather:
    def __init__(self, mesh: Mesh, a_loc: torch.Tensor):
        self.mesh, self.a_loc = mesh, a_loc

    def __call__(self, p_loc):
        return torch.matmul(self.a_loc, collectives.all_gather(p_loc, self.mesh))


class _DenseOzakiAllGather:
    """Dense fp64 rows as Ozaki int8 slices (cgx's ``_DenseOzakiAllGather``):
    p gathered, the local rows applied by :func:`cgx_torch.ops.ozaki.
    _ozaki_apply`; the same collectives as :class:`_DenseAllGather`."""

    def __init__(self, mesh: Mesh, c_loc: torch.Tensor, sigma_loc: torch.Tensor,
                 num_slices: int = 8):
        self.mesh, self.c_loc, self.sigma_loc = mesh, c_loc, sigma_loc
        self.num_slices = num_slices

    def __call__(self, p_loc):
        return _ozaki_apply(self.c_loc, self.sigma_loc, collectives.all_gather(p_loc, self.mesh),
                            num_slices=self.num_slices)


class _DenseReduceScatter:
    """Symmetric A: ``Ap = psum_scatter(A_loc^T p_loc)``."""

    def __init__(self, mesh: Mesh, a_loc: torch.Tensor):
        self.mesh, self.a_loc = mesh, a_loc

    def __call__(self, p_loc):
        return collectives.reduce_scatter(torch.matmul(p_loc, self.a_loc), self.mesh)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row vector ``v`` broadcast against ``like``: (n_loc,) or an
    (n_loc, s) block of columns (rows always on axis 0, as cgx's)."""
    return v if like.dim() == 1 else v[:, None]


class _DiaAllGather:
    """Banded rows with p gathered; p is (n_loc,) or an (n_loc, s) block."""

    def __init__(self, mesh: Mesh, bands_loc: torch.Tensor, offsets, n_loc: int):
        self.mesh, self.bands_loc, self.offsets, self.n_loc = mesh, bands_loc, offsets, n_loc

    def __call__(self, p_loc):
        p_full = collectives.all_gather(p_loc, self.mesh)
        start = self.mesh.rank * self.n_loc
        pad = max(max(abs(o) for o in self.offsets), 1)
        p_pad = F.pad(p_full, (0, 0) * (p_full.dim() - 1) + (pad, pad))
        y = torch.zeros_like(p_loc)
        for d, off in enumerate(self.offsets):
            lo = pad + start + off
            y = y + _rows(self.bands_loc[d], p_loc) * p_pad[lo: lo + self.n_loc]
        return y


class _DiaHalo:
    """Banded mat-vec with a halo exchange: O(h) elements an iteration.

    The left halo is the left neighbour's last h entries, the right halo
    the right neighbour's first h; an edge rank gets zeros, which matches
    the matrix having no entries past its boundary. ``local_kernel``:

    - ``"xla"``: shifted products of the extended vector, plain torch,
      over the shard's flat bands (ndiag, n_loc);
    - ``"stream2d"``: kernel B8 on the shard's pre-padded band planes
      (ndiag, rows_lp, cols), built once; its zero-boundary result is
      exact in rows [h, n_loc - h), and the h rows at each edge are
      recomputed from the halo'd vector by the same formula and patched
      in. The flat bands are the planes' first n_loc entries a band.

    Both issue the same two ppermutes, and give the same y bit for bit.
    The "xla" product also takes an (n_loc, s) block of columns (rows on
    axis 0, cgx's layout): each direction's halo is then one message of
    h s elements for the whole block; "stream2d" is a single-vector
    product (the block solves build their operator with "xla", as cgx).
    """

    def __init__(self, mesh: Mesh, bands_loc: torch.Tensor, offsets, n_loc: int,
                 local_kernel: str = "xla", rows: int = PLANE_ROWS, cols: int = PLANE_COLS):
        if local_kernel not in ("xla", "stream2d"):
            raise ValueError(f"unknown local_kernel {local_kernel!r}")
        self.mesh, self.offsets, self.n_loc = mesh, tuple(offsets), n_loc
        self.local_kernel, self.rows, self.cols = local_kernel, rows, cols
        self.halo = max(max(abs(o) for o in self.offsets), 1)
        if self.halo > n_loc:
            raise ValueError(f"halo {self.halo} exceeds shard size {n_loc}; "
                             "use strategy='allgather' or fewer shards")
        self.bands = bands_loc  # flat bands, or the planes for "stream2d"
        self.flat = bands_loc.reshape(len(self.offsets), -1)[:, :n_loc]
        self.zeros = torch.zeros(self.halo, dtype=bands_loc.dtype, device=bands_loc.device)

    def _edge_rows(self, ext: torch.Tensor, ext_start: int, start: int) -> torch.Tensor:
        """Exact rows [start, start + h) of the halo'd product, from
        ``ext`` = the extended vector from its element ``ext_start``."""
        h = self.halo
        y = torch.zeros_like(self.zeros)
        for d, off in enumerate(self.offsets):
            lo = h + start + off - ext_start
            y = y + self.flat[d, start: start + h] * ext[lo: lo + h]
        return y

    def __call__(self, p_loc):
        h = self.halo
        zeros = self.zeros if p_loc.dim() == 1 else p_loc.new_zeros((h,) + p_loc.shape[1:])
        left, right = collectives.halo_exchange(p_loc[:h], p_loc[-h:], self.mesh, zeros)
        return self.local(p_loc, left, right)

    def local(self, p_loc, left, right):
        """The shard's rows of A p, given the two halos."""
        h, n_loc = self.halo, self.n_loc
        if self.local_kernel == "stream2d":
            if p_loc.dim() != 1:
                raise ValueError("the 'stream2d' local product takes one vector; build a "
                                 "block solve's operator with local_kernel='xla'")
            y = dia_spmv.dia_matvec_stream2d_planes(self.bands, p_loc, offsets=self.offsets,
                                                    rows=self.rows, cols=self.cols)
            if n_loc >= 2 * h:  # each edge needs only 3h entries of the extended vector
                top = self._edge_rows(torch.cat([left, p_loc[: 2 * h]]), 0, 0)
                bottom = self._edge_rows(torch.cat([p_loc[n_loc - 2 * h:], right]),
                                         n_loc - h, n_loc - h)
            else:
                ext = torch.cat([left, p_loc, right])
                top, bottom = self._edge_rows(ext, 0, 0), self._edge_rows(ext, 0, n_loc - h)
            y[:h] = top
            y[n_loc - h:] = bottom
            return y
        p_ext = torch.cat([left, p_loc, right])
        y = torch.zeros_like(p_loc)
        for d, off in enumerate(self.offsets):
            y = y + _rows(self.flat[d], p_loc) * p_ext[h + off: h + off + n_loc]
        return y


def extended_rows(t: torch.Tensor, d: int, mesh: Mesh) -> torch.Tensor:
    """``t`` (the shard's rows on its last axis) with the neighbours' d
    edge rows on either side, zeros past the mesh's ends: one exchange a
    direction (the deep-halo and fused s-step routes' bands and x0)."""
    zeros = torch.zeros(t.shape[:-1] + (d,), dtype=t.dtype, device=t.device)
    left, right = collectives.halo_exchange(t[..., :d].contiguous(), t[..., -d:].contiguous(),
                                            mesh, zeros)
    return torch.cat([left, t, right], dim=-1)


class _DeepHaloBasis:
    """The s-step basis of a block from one deep halo (cgx's
    ``_DeepHaloBasis``, the distributed matrix-powers scheme): each rank
    receives ``s h`` rows of p and r from each neighbour in one exchange a
    direction (the two vectors' edges stacked in one message), then builds
    all 2s+1 columns on its extended rows with plain banded products; each
    application spoils h more rows at the halo's outer edges, and the depth
    keeps the shard's own rows exact. A block costs 2 exchanges and the
    Gram's all-reduce, against 2(2s-1) exchanges with per-mat-vec halos.
    The extended bands are exchanged once a solve (:meth:`prepare`, where
    cgx threads them through its loop as a tree, ``_TreeFirstMV``)."""

    def __init__(self, mesh: Mesh, offsets, n_loc: int, s: int, theta: float, delta: float,
                 shifts=()):
        self.mesh, self.offsets, self.n_loc = mesh, tuple(int(o) for o in offsets), int(n_loc)
        self.s, self.theta, self.delta = int(s), float(theta), float(delta)
        self.shifts = tuple(float(v) for v in shifts)
        self.h = max(max(abs(o) for o in self.offsets), 1)
        self.depth = self.s * self.h
        if self.depth > self.n_loc:
            raise ValueError(f"matrix-powers halo depth s*h = {self.depth} exceeds shard size "
                             f"{self.n_loc}; reduce sstep_s, use fewer shards, or "
                             "sstep_powers='off'")
        self.bands_ext = None

    def prepare(self, bands_loc: torch.Tensor) -> None:
        """The shard's bands with the neighbours' d band columns around
        them: two exchanges, once a solve."""
        self.bands_ext = extended_rows(bands_loc, self.depth, self.mesh)

    def __call__(self, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        d = self.depth
        bands_ext, offsets = self.bands_ext, self.offsets
        cols = basis_columns_fn(lambda v: dia_spmv.dia_matvec_ref(bands_ext, v, offsets=offsets),
                                p.dtype, self.theta, self.delta, self.shifts)
        zeros = torch.zeros((2, d), dtype=p.dtype, device=p.device)
        left, right = collectives.halo_exchange(torch.stack([p[:d], r[:d]]),
                                                torch.stack([p[-d:], r[-d:]]), self.mesh, zeros)
        p_ext = torch.cat([left[0], p, right[0]])
        r_ext = torch.cat([left[1], r, right[1]])
        v = torch.stack(cols(p_ext, self.s + 1) + cols(r_ext, self.s))
        return v[:, d: d + self.n_loc]


class _PsumGram:
    """``V V^T`` of the shard's (m, n_loc) basis, then ONE all-reduce of
    the (m, m) block: the s-step method's one reduction a block (cgx's
    ``_PsumGram``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce(_local_gram(v), self.mesh)


class _SStepLoop:
    """:func:`cgx_torch.solver.sstep.sstep_cg_loop` on the shard (cgx's
    ``_SStepLoop``): the strategy mat-vec, the basis interval, the Newton
    shifts, the replacement cadence, the Gram hook and, for
    ``"deephalo"``, the deep-halo basis, whose bands are prepared once a
    solve. ``gram_precision`` is the Gram's and the replay's dtype (None:
    the vectors', cgx's arithmetic)."""

    def __init__(self, theta, delta, mv, s, maxiter, gram, shifts=(), replace_every=0,
                 basis=None, bands_loc=None, gram_precision=None):
        self.theta, self.delta, self.mv, self.s, self.maxiter = theta, delta, mv, s, maxiter
        self.gram, self.shifts, self.replace_every = gram, tuple(shifts), replace_every
        self.basis, self.bands_loc, self.gram_precision = basis, bands_loc, gram_precision

    def __call__(self, b, x0, tol: float, nearzero: float, marks=None) -> CGResult:
        if self.basis is not None:
            self.basis.prepare(self.bands_loc)  # loop-invariant: once a solve
        return sstep_cg_loop(self.mv, b, x0, tol, nearzero, s=self.s, maxiter=self.maxiter,
                             theta=self.theta, delta=self.delta, shifts=self.shifts,
                             basis_fn=self.basis, replace_every=self.replace_every,
                             gram_precision=self.gram_precision, gram=self.gram, marks=marks)


class _SparseAllGather:
    """CSR or ELL rows: p gathered, the shard's rows applied by the
    port's operator, its column indices global (cgx's ``_CsrAllGather``
    and ``_EllAllGather``; the CSR row sums are padded-row gathers, so
    their order is fixed, where cgx's ``segment_sum`` scatters)."""

    def __init__(self, mesh: Mesh, op_loc):
        self.mesh, self.op_loc = mesh, op_loc

    def __call__(self, p_loc):
        return self.op_loc.matvec(collectives.all_gather(p_loc, self.mesh))


class _PsumBlockGram:
    """The (a, b) block Gram ``A^T B`` of the shard, compensated across
    chunks (:func:`cgx_torch.ops.tw32.comp_block_gram`, the single-device
    arithmetic), then ONE all-reduce of it: a block CG's reductions (cgx's
    ``_PsumBlockGram``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce(comp_block_gram(a, b).contiguous(), self.mesh)


class _PsumTallT:
    """The (j,) contraction ``M^T v`` of the shard, then ONE all-reduce:
    the deflated loop's fused ``[W, AW]^T r`` over the mesh (cgx's
    ``_PsumTallT``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, m_: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce(_local_tallT(m_, v), self.mesh)


class _PsumFused:
    """Dots and tall contractions of the shard reduced by ONE all-reduce
    of them concatenated: the deflated PCG's last launch, ``<r, z>``,
    ``<r, r>`` and ``(AW)^T z``, which XLA's combiner merges for cgx
    (recorded as cgx's: width 3, k + 2 elements). The port's loops have no
    combiner, so :func:`cgx_torch.solver.deflated.deflated_cg_loop` hands
    them over together (its ``fuse`` hook)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, pairs, talls):
        parts = [vdot(a, b).reshape(1) for a, b in pairs] + [_local_tallT(m_, v)
                                                          for m_, v in talls]
        out = collectives.all_reduce(torch.cat(parts), self.mesh, width=len(parts))
        pieces = out.split([p.numel() for p in parts])
        return tuple(p[0] for p in pieces[:len(pairs)]) + pieces[len(pairs):]


class _PsumDots:
    """The local dots of a list of pairs, then ONE all-reduce of them
    stacked: the Chronopoulos-Gear single reduction an iteration. cgx
    stacks them into one ``psum`` (recorded with width 1); the reference
    loop's are separate ``psum``s, one a dot (the reference's cblas_ddot
    and MPI_Allreduce pair, cg.cc:105-106, 116-117), which XLA's combiner
    launches as one where neither waits on the other (``separate=True``,
    recorded with the number of dots as the width)."""

    def __init__(self, mesh: Mesh, precision, separate: bool = False):
        self.mesh, self.precision, self.separate = mesh, precision, separate

    def __call__(self, pairs):
        stacked = torch.stack([vdot(a, b, precision=self.precision) for a, b in pairs])
        width = len(pairs) if self.separate else 1
        return tuple(collectives.all_reduce(stacked, self.mesh, width=width).unbind())


class _NeumannPrecond:
    """Degree-1 Neumann apply ``z = 2 D^-1 r - D^-1 A (D^-1 r)``: one more
    strategy mat-vec, with its collectives, an application; r is (n_loc,)
    or an (n_loc, s) block (cgx's ``_TreeBlockNeumann``: one block
    mat-vec and its halo pair)."""

    def __init__(self, mv: Callable, inv_diag: torch.Tensor):
        self.mv, self.inv_diag = mv, inv_diag

    def __call__(self, r):
        d = _rows(self.inv_diag, r)
        c = d * r
        return 2.0 * c - d * self.mv(c)


class _JacobiPrecond:
    """``z = r / diag(A)``, purely local; r is (n_loc,) or an (n_loc, s)
    block (cgx's ``_TreeBlockJacobi``)."""

    def __init__(self, inv_diag: torch.Tensor):
        self.inv_diag = inv_diag

    def __call__(self, r):
        return _rows(self.inv_diag, r) * r


class _BlockJacobiPrecond:
    """``z = blockdiag(A)^-1 r`` on the shard's own blocks (cgx's
    ``_TreeBlockJacobiPrecond``): one local batched product ``(nb_loc, m,
    m) @ (nb_loc, m)``, no collective, since no block straddles a shard.
    The solver loops run it at full float32."""

    def __init__(self, inv_blocks: torch.Tensor):
        self.inv = inv_blocks

    def __call__(self, r):
        nb, m, _ = self.inv.shape
        return torch.matmul(self.inv, r.reshape(nb, m, 1)).reshape(r.shape)


# ---------------------------------------------------------------------------
# Building the operator
# ---------------------------------------------------------------------------


def _resolve_local_kernel(local_kernel: str, n_loc: int, dtype, device) -> str:
    """cgx's rule (sharded_cg.py:1127-1134): ``"auto"`` is ``"stream2d"``
    on an accelerator (here CUDA) for a shard of at most 4-byte elements
    and at least STREAM_LOCAL_MIN_ELEMS rows, else ``"xla"`` (on the CPU,
    and for fp64, as cgx decides)."""
    if local_kernel != "auto":
        if local_kernel not in ("xla", "stream2d"):
            raise ValueError(f"unknown local_kernel {local_kernel!r}")
        return local_kernel
    if torch.device(device).type != "cuda":
        return "xla"
    if _torch_dtype(dtype, None).itemsize > 4:
        return "xla"
    return "stream2d" if n_loc >= STREAM_LOCAL_MIN_ELEMS else "xla"


def _build_op(mat, n: int, n_pad: int, n_loc: int, mesh: Mesh, dtype: torch.dtype,
              dev: torch.device, strategy: str, dense_fp64: str, local_kernel: str):
    """This rank's shard of the operator in its format's layout, and the
    strategy mat-vec (cgx ``_build_op``, sharded_cg.py:1137). Returns
    (mat-vec, the diagonal of A on the host, the strategy, the local
    kernel)."""
    np_dt = _np_dtype(dtype)
    lo, hi = mesh.rank * n_loc, (mesh.rank + 1) * n_loc
    kernel = None
    if isinstance(mat, DIAMatrix):
        bands = pad_bands(np.asarray(mat.bands, dtype=np_dt), n_pad)[:, lo:hi]
        offsets = tuple(int(o) for o in mat.offsets)
        halo = max(max(abs(o) for o in offsets), 1)
        if strategy == "auto":
            # halo exchange when the bandwidth fits in a shard, all-gather otherwise
            strategy = "halo" if halo <= n_loc else "allgather"
        if strategy == "halo":
            kernel = _resolve_local_kernel(local_kernel, n_loc, dtype, dev)
            if kernel == "stream2d":
                # the per-shard band planes, built once (sharded_cg.py:1169-1184)
                bands = dia_spmv.stream2d_band_planes(bands, rows=PLANE_ROWS, cols=PLANE_COLS)
            bands_loc = torch.tensor(np.ascontiguousarray(bands), device=dev)
            mv = _DiaHalo(mesh, bands_loc, offsets, n_loc, local_kernel=kernel)
        elif strategy == "allgather":
            mv = _DiaAllGather(mesh, torch.tensor(bands, device=dev), offsets, n_loc)
        else:
            raise ValueError(f"strategy {strategy!r} not supported for DIA matrices")
        diag = mat.bands[list(mat.offsets).index(0)]
    elif isinstance(mat, CSRMatrix):
        if strategy not in ("auto", "allgather"):
            raise ValueError(f"strategy {strategy!r} not supported for CSR matrices")
        strategy = "allgather"
        lengths = np.diff(mat.indptr)
        row_of = np.repeat(np.arange(n, dtype=np.int64), lengths)
        sel = (row_of >= lo) & (row_of < hi)
        op_loc = CsrOperator(torch.tensor(mat.values[sel], dtype=dtype, device=dev),
                             torch.tensor(mat.indices[sel], dtype=torch.int64, device=dev),
                             torch.tensor(row_of[sel] - lo, dtype=torch.int64, device=dev),
                             n=n_loc)
        mv = _SparseAllGather(mesh, op_loc)
        on_diag = mat.indices == row_of
        diag = np.zeros(n, dtype=np.float64)
        np.add.at(diag, row_of[on_diag], mat.values[on_diag])
    elif isinstance(mat, ELLMatrix):
        if strategy not in ("auto", "allgather"):
            raise ValueError(f"strategy {strategy!r} not supported for ELLPACK matrices")
        strategy = "allgather"
        k = mat.values.shape[1]
        vals = np.zeros((n_pad, k), dtype=np_dt)
        vals[:n] = mat.values
        idx = np.zeros((n_pad, k), dtype=np.int64)
        idx[:n] = mat.indices
        mv = _SparseAllGather(mesh, EllOperator(torch.tensor(vals[lo:hi], device=dev),
                                                torch.tensor(idx[lo:hi], device=dev)))
        on_diag = mat.indices == np.arange(n, dtype=mat.indices.dtype)[:, None]
        diag = np.where(on_diag, mat.values, 0.0).sum(axis=1)
    else:
        a = mat.a if isinstance(mat, DenseMatrix) else _host(mat)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError("matrix must be square")
        if dense_fp64 not in ("emulated", "ozaki", "auto"):
            raise ValueError(f"unknown dense_fp64 {dense_fp64!r}")
        # "auto" keeps the fp64 product: the H100's fp64 is native (cgx's "auto"
        # takes Ozaki on an accelerator, sharded_cg.py:1241-1244, for the TPU's
        # emulated fp64)
        if dtype == torch.float64 and dense_fp64 == "ozaki":
            if strategy not in ("auto", "allgather"):
                raise ValueError("dense_fp64='ozaki' supports the allgather strategy")
            c, sigma = build_slices_np(pad_dense(a, n_pad))
            c_loc = _pad_cols(torch.tensor(np.ascontiguousarray(c[:, lo:hi]), device=dev))
            strategy, mv = "allgather", _DenseOzakiAllGather(
                mesh, c_loc, torch.tensor(sigma[lo:hi], device=dev))
        else:
            a_loc = torch.tensor(pad_dense(a.astype(np_dt), n_pad)[lo:hi], device=dev)
            if strategy in ("auto", "allgather"):
                strategy, mv = "allgather", _DenseAllGather(mesh, a_loc)
            elif strategy == "reducescatter":
                mv = _DenseReduceScatter(mesh, a_loc)
            else:
                raise ValueError(f"strategy {strategy!r} not supported for dense matrices")
        diag = np.diagonal(a)
    return mv, diag, strategy, kernel


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def make_sharded_solver(
    mat,
    n: int,
    *,
    dtype=np.float64,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    strategy: str = "auto",
    method: str = "reference",
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    history: int = 0,
    dot_precision=None,
    jacobi: bool = False,
    precond: Optional[str] = None,
    precond_block_size: Optional[int] = None,
    bounds: Optional[tuple] = None,
    dense_fp64: str = "emulated",
    local_kernel: str = "auto",
    check_every: int = 32,
    sstep_s: int = 4,
    sstep_basis: str = "chebyshev",
    sstep_replace_every: Optional[int] = None,
    sstep_powers: str = "off",
    sstep_bands_dtype="auto",
    gv_replace_every: int = 25,
    axis_name: str = ROWS_AXIS,
    device=None,
) -> "ShardedCGSolver":
    """Build an operator-resident row-block-sharded CG solver (cgx's
    signature).

    Each rank keeps its shard of the operator on its device once; the
    returned :class:`ShardedCGSolver` solves repeated right-hand sides.
    ``n`` is the system size, ``dtype`` the solve's (NumPy or torch).

    Args:
      mat: a host container (``DIAMatrix``, ``ELLMatrix``, ``CSRMatrix``,
        ``COOMatrix`` (converted to CSR), ``DenseMatrix``) or a square
        ndarray; the same on every rank.
      mesh: a :class:`~cgx_torch.parallel.mesh.Mesh`; by default
        ``make_mesh(n_devices)`` over the process group.
      strategy: ``"allgather"``, ``"reducescatter"`` (dense), ``"halo"``
        (DIA) or ``"auto"`` (halo for DIA when the bandwidth fits in a
        shard, else allgather).
      method: ``"reference"`` (two all-reduces an iteration),
        ``"pipelined"`` (one, of two dots; three with a preconditioner),
        ``"gvpipe"`` (the same one, off the mat-vec's path; cgx
        sharded_cg.py:810-821) or ``"chebyshev"`` (the Chebyshev
        iteration on ``bounds``, one all-reduce every ``check_every``
        iterations, no preconditioner: one given is not applied, as in
        cgx) or ``"sstep"`` (``sstep_s`` iterations a Gram all-reduce, on
        ``bounds``; no preconditioner).
      tol, nearzero: per-call defaults (absolute tolerance, alpha clamp).
      maxiter: iteration cap; defaults to N, 4N for ``"chebyshev"``.
      dot_precision: dtype the dots accumulate in (float64 for float32
        vectors); default the vectors'.
      precond: None, ``"jacobi"`` (local), ``"block_jacobi"`` (a DIA or
        dense matrix: the diagonal blocks inverted once on the host, each
        shard's applied by one local batched product, no collective),
        ``"neumann"`` (degree 1: one more strategy mat-vec) or
        ``"chebyshev"`` (degree 3: three strategy mat-vecs, on ``bounds``);
        ``jacobi=True`` is an alias of ``"jacobi"``.
      precond_block_size: block-Jacobi's rows a block; default min(32,
        the shard size). It must divide the shard size: no block may
        straddle two shards.
      bounds: ``(lmin, lmax)`` of the Chebyshev preconditioner or method,
        or of the s-step basis; default :func:`cgx_torch.solver.chebyshev.
        host_spectral_bounds` of ``mat``. The methods need ``0 < lmin <
        lmax``.
      dense_fp64: a dense fp64 operator's product: ``"emulated"`` and
        ``"auto"`` the fp64 ``torch.matmul`` (the H100's fp64 is native),
        ``"ozaki"`` cgx's int8 slices (:mod:`cgx_torch.ops.ozaki`), under
        the allgather strategy.
      local_kernel: ``"auto"``, ``"xla"`` or ``"stream2d"``, the local
        product of the halo strategy (see :func:`_resolve_local_kernel`).
      check_every: the Chebyshev method's iterations between convergence
        checks.
      sstep_s: the s-step method's iterations a Gram all-reduce.
      sstep_basis: ``"chebyshev"`` or ``"newton"`` (Leja-ordered Ritz
        shifts).
      sstep_replace_every: the guarded residual replacement's cadence in
        blocks (0 = off; None: 0 for s <= 8, else 1); refused by
        ``"fused"``, as cgx refuses it.
      sstep_powers: ``"off"`` (2s-1 strategy mat-vecs a block, their
        halos each), ``"deephalo"`` (:class:`_DeepHaloBasis`: one deep
        halo a block; needs s h <= the shard size) or ``"fused"``
        (kernels B10 per shard, :mod:`cgx_torch.parallel.sstep_fused`;
        s <= 8, the shard must tile by :func:`~cgx_torch.parallel.
        sstep_fused.fused_plane_geometry`). "deephalo" and "fused" need a
        DIA matrix under the halo strategy. The Gram and the replay run in
        ``dot_precision`` (float64 for float32 vectors as ``solve`` asks;
        None: cgx's arithmetic); "fused" always in float64.
      sstep_bands_dtype: the streamed bands of ``"fused"``: "auto"
        (bfloat16 where every band value is exact in it), None (the
        solve's dtype) or a dtype (the operator rounded to it).
      gv_replace_every: the gvpipe method's residual-replacement cadence
        (0 = off).
      axis_name: the name of the mesh's axis, when the mesh is made here.
      device: where this rank computes; default the mesh's
        (``cuda:LOCAL_RANK`` unless the mesh was made for the CPU).

    N is padded to a multiple of the mesh size with zero rows; padded
    entries of b, x, r and p stay exactly zero through every iteration.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if jacobi and precond is None:
        precond = "jacobi"
    if precond not in PRECONDS:
        raise ValueError(f"unknown precond {precond!r}")
    _check_sstep_options(method, sstep_powers, sstep_replace_every, sstep_s, sstep_bands_dtype)
    if method == "sstep":
        # the s-step bases consume the flat local bands (cgx sharded_cg.py:708-712)
        local_kernel = "xla"
        if precond is not None:
            raise ValueError(f"method={method!r} does not take a preconditioner")
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    dtype = _torch_dtype(dtype, None)
    n = int(n)
    n_pad = padded_size(n, mesh.size)
    n_loc = n_pad // mesh.size
    if isinstance(mat, COOMatrix):
        mat = CSRMatrix.from_coo(mat)
    mv, diag, strategy, kernel = _build_op(mat, n, n_pad, n_loc, mesh, dtype, dev, strategy,
                                           dense_fp64, local_kernel)
    lo = mesh.rank * n_loc
    pc = None
    if precond == "block_jacobi":  # cgx sharded_cg.py:754-778
        if not (isinstance(mat, (DIAMatrix, DenseMatrix))
                or (isinstance(mat, np.ndarray) and mat.ndim == 2)):
            raise ValueError("precond='block_jacobi' needs a DIA or dense matrix")
        m_bj = precond_block_size or min(32, n_loc)
        if n_loc % m_bj != 0:
            raise ValueError(f"precond_block_size {m_bj} must divide the shard size {n_loc} "
                             "(blocks may not straddle shards)")
        inv_blocks = invert_spd_blocks(diag_blocks(mat, m_bj, n_rows=n_pad))
        pc = _BlockJacobiPrecond(torch.tensor(
            inv_blocks[lo // m_bj: (lo + n_loc) // m_bj].astype(_np_dtype(dtype)), device=dev))
    elif precond == "chebyshev":  # cgx sharded_cg.py:790-795
        lmin, lmax = bounds if bounds is not None else host_spectral_bounds(mat)
        pc = chebyshev_poly(mv, float(lmin), float(lmax), degree=CHEBYSHEV_DEGREE)
    elif precond is not None:
        inv_loc = _inv_diag_rows(diag, n, n_pad, mesh, n_loc, dtype, dev)
        pc = _JacobiPrecond(inv_loc) if precond == "jacobi" else _NeumannPrecond(mv, inv_loc)
    sstep = None
    if method == "sstep":
        sstep = _sstep_loop(mat, n, n_loc, mesh, mv, dtype, bounds, maxiter, sstep_s,
                            sstep_basis, sstep_replace_every, sstep_powers, sstep_bands_dtype,
                            _torch_dtype(dot_precision, None))
    cheby = None
    if method == "chebyshev":  # cgx sharded_cg.py:833-848
        if bounds is None:
            bounds = host_spectral_bounds(mat)
        lmin, lmax = float(bounds[0]), float(bounds[1])
        if not (0 < lmin < lmax):
            raise ValueError(f"invalid spectral bounds {bounds}")
        cheby = (lmin, lmax, int(check_every))
    if maxiter is None:
        maxiter = 4 * n if method == "chebyshev" else n
    dot_precision = _torch_dtype(dot_precision, None)
    return ShardedCGSolver(
        mesh=mesh, device=dev, n=n, n_pad=n_pad, dtype=dtype, mv=mv, precond=pc, method=method,
        maxiter=int(maxiter), history=int(history),
        dot_precision=dot_precision, tol=float(tol), nearzero=float(nearzero),
        strategy=strategy, local_kernel=kernel, cheby=cheby,
        gv_replace_every=int(gv_replace_every), sstep=sstep,
    )


def _check_sstep_options(method, powers, replace_every, s, bands_dtype) -> None:
    """cgx's build-time refusals of the s-step options (sharded_cg.py:713-739)."""
    if method == "sstep" and powers not in SSTEP_POWERS:
        if powers in ("pallas", "interpret"):
            raise ValueError(f"sstep_powers={powers!r} is a single-device mode; use "
                             "sstep_powers='deephalo' or 'fused' for sharded solves")
        raise ValueError(f"unknown sstep_powers {powers!r}")
    if method == "sstep" and powers == "fused":
        if replace_every is not None:
            raise ValueError(
                "sstep_powers='fused' has no residual-replacement cadence (the fused block's "
                "recurrence lives inside the kernel); sstep_replace_every is only meaningful "
                "with sstep_powers='off'/'deephalo'")
        if int(s) > 8:
            raise ValueError("sstep_powers='fused' supports sstep_s <= 8 (larger s needs the "
                             "residual-replacement cadence of sstep_powers='off'/'deephalo')")
    elif not (bands_dtype is None or (isinstance(bands_dtype, str) and bands_dtype == "auto")):
        raise ValueError(
            "sstep_bands_dtype is only consumed by method='sstep' with sstep_powers='fused' "
            f"(got sstep_bands_dtype={bands_dtype!r} with method={method!r}, "
            f"sstep_powers={powers!r})")


def _sstep_loop(mat, n: int, n_loc: int, mesh: Mesh, mv, dtype: torch.dtype, bounds,
                maxiter, s: int, basis: str, replace_every, powers: str, bands_dtype,
                gram_precision):
    """The s-step loop of the sharded solver (cgx sharded_cg.py:849-948):
    :class:`_SStepLoop` for "off" and "deephalo", :class:`~cgx_torch.
    parallel.sstep_fused._SStepFusedLoop` for "fused"."""
    if bounds is None:
        bounds = host_spectral_bounds(mat)
    lmin, lmax = float(bounds[0]), float(bounds[1])
    if not 0 < lmin < lmax:
        raise ValueError(f"invalid spectral bounds {bounds}")
    theta, delta = (lmax + lmin) / 2.0, (lmax - lmin) / 2.0
    s = int(s)
    maxiter = n if maxiter is None else int(maxiter)
    if basis == "newton":
        shifts = newton_shifts(mat, n, s, (lmin, lmax))
    elif basis == "chebyshev":
        shifts = ()
    else:
        raise ValueError(f"unknown s-step basis {basis!r}")
    if powers in ("deephalo", "fused") and not (isinstance(mat, DIAMatrix)
                                               and isinstance(mv, _DiaHalo)):
        raise ValueError(f"sstep_powers={powers!r} needs a DIA matrix with the 'halo' (or "
                         "'auto') strategy")
    if powers == "fused":
        from cgx_torch.parallel.sstep_fused import _SStepFusedLoop, fused_plane_geometry

        if isinstance(bands_dtype, str):  # "auto": bfloat16 exactly where the bands are
            host = np.asarray(mat.bands).astype(_np_dtype(dtype))
            t = torch.from_numpy(host)
            exact = bool(torch.equal(t.to(torch.bfloat16).to(t.dtype), t))
            bdt = torch.bfloat16 if exact else None
        else:
            bdt = _torch_dtype(bands_dtype, None)
        rows, cols, pm = fused_plane_geometry(mv.offsets, s, n_loc, dtype, bdt)
        return _SStepFusedLoop(mesh, mv.flat, mv.offsets, n_loc, s, maxiter, theta, delta,
                               shifts, rows, cols, pm, bdt)
    deep = None
    if powers == "deephalo":
        deep = _DeepHaloBasis(mesh, mv.offsets, n_loc, s, theta, delta, shifts)
    if replace_every is None:
        replace_every = 1 if s > 8 else 0
    return _SStepLoop(theta, delta, mv, s, maxiter, _PsumGram(mesh), shifts=shifts,
                      replace_every=int(replace_every), basis=deep,
                      bands_loc=mv.flat if deep is not None else None,
                      gram_precision=gram_precision)


class ShardedCGSolver:
    """Operator-resident sharded CG solver (see :func:`make_sharded_solver`).

    Calling it solves ``A x = b`` for a new right-hand side on every rank
    of the mesh; ``x0`` warm starts, and ``tol``/``nearzero`` override
    the build-time defaults per call. ``strategy`` and ``local_kernel``
    say what ``"auto"`` resolved to (``local_kernel`` is None outside the
    halo strategy)."""

    def __init__(self, *, mesh, device, n, n_pad, dtype, mv, precond, method, maxiter, history,
                 dot_precision, tol, nearzero, strategy, local_kernel, cheby=None,
                 gv_replace_every=25, sstep=None):
        self.mesh = mesh
        self.device = device
        self.n = n
        self._n_pad = n_pad
        self._n_loc = n_pad // mesh.size
        self.dtype = dtype
        self._mv = mv
        self._precond = precond
        self.method = method
        self._maxiter = maxiter
        self._history = history
        self._dot_precision = dot_precision
        self._scalar_dtype = dtype if dot_precision is None else dot_precision
        self._tol = tol
        self._nearzero = nearzero
        self.strategy = strategy
        self.local_kernel = local_kernel
        self._cheby = cheby  # (lmin, lmax, check_every) of the Chebyshev method
        self._gv_replace_every = gv_replace_every
        self._sstep = sstep  # the s-step loop (_SStepLoop or _SStepFusedLoop)

    def _shard(self, v, name: str) -> torch.Tensor:
        v = _host(v, _np_dtype(self.dtype))
        if v.shape != (self.n,):
            raise ValueError(f"{name} must be ({self.n},); got {v.shape}")
        lo = self.mesh.rank * self._n_loc
        return torch.tensor(pad_vector(v, self._n_pad)[lo: lo + self._n_loc], device=self.device)

    def solve(self, b, x0=None, *, tol: Optional[float] = None,
              nearzero: Optional[float] = None) -> CGResult:
        b_loc = self._shard(b, "b")
        # a float64 x0 must not promote a float32 solve: cast like b
        x0_loc = torch.zeros_like(b_loc) if x0 is None else self._shard(x0, "x0")
        tol_t = torch.tensor(self._tol if tol is None else tol, dtype=self._scalar_dtype,
                             device=self.device)
        nz_t = torch.tensor(self._nearzero if nearzero is None else nearzero, dtype=self.dtype,
                            device=self.device)
        collectives.begin_program()
        common = dict(tol=tol_t, nearzero=nz_t, maxiter=self._maxiter, history=self._history,
                      precond=self._precond)
        with f32_exact():
            if self.method == "sstep":
                res = self._sstep(b_loc, x0_loc, float(self._tol if tol is None else tol),
                                  float(self._nearzero if nearzero is None else nearzero),
                                  marks=collectives)
            elif self.method == "chebyshev":  # cgx's _ChebyLoop, sharded_cg.py:2172
                psum = _PsumDots(self.mesh, self._dot_precision)
                lmin, lmax, check_every = self._cheby
                res = cheby_loop(self._mv, b_loc, x0_loc, lmin, lmax, tol_t,
                                 maxiter=self._maxiter, check_every=check_every,
                                 dot=lambda u, v: psum([(u, v)])[0], marks=collectives)
            elif self.method == "gvpipe":
                res = gv_cg_loop(x0_loc, b_loc, matvec=self._mv,
                                 dot_precision=self._dot_precision,
                                 dots=_PsumDots(self.mesh, self._dot_precision),
                                 replace_every=self._gv_replace_every, marks=collectives,
                                 **common)
            elif self.method == "pipelined":
                res = pipelined_cg_loop(x0_loc, b_loc, matvec=self._mv,
                                        dot_precision=self._dot_precision,
                                        dots=_PsumDots(self.mesh, self._dot_precision),
                                        marks=collectives, **common)
            else:
                res = cg_loop(self._mv, b_loc, x0_loc,
                              dots=_PsumDots(self.mesh, self._dot_precision, separate=True),
                              marks=collectives, **common)
        collectives.begin_output()
        return res._replace(x=collectives.all_gather(res.x, self.mesh)[: self.n])

    __call__ = solve


def sharded_cg_solve(mat, b, *, x0=None, sstep_fallback: str = "auto", **kwargs) -> CGResult:
    """Solve ``A x = b`` with row-block-sharded CG over a mesh of ranks:
    :func:`make_sharded_solver` and one solve (see there for the options).
    ``b`` (and ``x0``) are host arrays, the same on every rank; a float32
    ``b`` solves in float32.

    ``sstep_fallback`` (cgx's, sharded_cg.py:1052-1116): after a
    ``method="sstep"`` solve whose replay broke down unconverged, "auto"
    finishes on the reference recurrence from the frozen iterate (for the
    iterations left), "adaptive" first restarts the sharded s-step at
    s // 2 (down to 2), "off" returns the frozen result."""
    if sstep_fallback not in ("auto", "adaptive", "off"):
        raise ValueError(f"unknown sstep_fallback {sstep_fallback!r}")
    b = _host(b)
    dtype = b.dtype if b.dtype in (np.float32, np.float64) else np.float64
    solver = make_sharded_solver(mat, b.shape[0], dtype=dtype, **kwargs)
    res = solver.solve(b, x0=x0)
    if (sstep_fallback == "off" or kwargs.get("method") != "sstep" or not bool(res.breakdown)
            or bool(res.converged)):
        return res
    used = int(res.iterations)
    left = int(kwargs.get("maxiter") or b.shape[0]) - used
    if left <= 0:
        return res
    x_f = _host(res.x)
    s_cur = int(kwargs.get("sstep_s", 4))
    if sstep_fallback == "adaptive" and s_cur >= 4:
        kw2 = dict(kwargs, sstep_s=s_cur // 2, maxiter=left)
        res2 = sharded_cg_solve(mat, b, x0=x_f, sstep_fallback="adaptive", **kw2)
    else:
        kw2 = {k: v for k, v in kwargs.items() if not k.startswith("sstep_")}
        kw2.update(method="reference", maxiter=left)
        res2 = sharded_cg_solve(mat, b, x0=x_f, sstep_fallback="off", **kw2)
    return res2._replace(iterations=res2.iterations + used)


class _RefineLoop:
    """Sharded mixed-precision refinement on the shard (cgx's
    ``_RefineLoop``): ``sweeps`` rounds of an fp32 inner CG on the
    normalized fp64 residual, through the strategy's fp32 mat-vec and one
    all-reduce a dot, then the fp64 correction, the fp64 true residual
    (the fp64 mat-vec's halos) and one all-reduce of its norm, stopping
    once ``||r|| < rtol ||b||`` (read on the host once a sweep). A sweep is
    an iteration of the collectives' record; the inner's ride in it."""

    def __init__(self, mesh: Mesh, mv64, mv32, sweeps: int, inner_tol: float,
                 inner_maxiter: int):
        self.mesh, self.mv64, self.mv32 = mesh, mv64, mv32
        self.sweeps, self.inner_tol, self.inner_maxiter = sweeps, inner_tol, inner_maxiter

    def _dot64(self, a, b):
        return collectives.all_reduce(vdot(a, b).reshape(1), self.mesh)[0]

    def __call__(self, b64, x0, rtol: float, nearzero: float, marks=None) -> CGResult:
        dev = b64.device
        f32 = torch.float32
        tol = rtol * torch.sqrt(self._dot64(b64, b64))
        x = x0
        r = b64 - self.mv64(x0)
        rr = self._dot64(r, r)
        counts = torch.zeros(self.sweeps, dtype=torch.int32, device=dev)
        tiny = torch.finfo(torch.float64).tiny
        inner_tol = torch.tensor(self.inner_tol, dtype=f32, device=dev)
        nz = torch.tensor(nearzero, dtype=f32, device=dev)
        dots = _PsumDots(self.mesh, None, separate=True)
        k = 0
        # a converged solve runs no further inner CG (the one host read a sweep)
        while k < self.sweeps and bool(torch.sqrt(rr) >= tol):
            if marks is not None:
                marks.next_iteration()
            # normalized, so that fp32's range is centred for any ||b||
            scale = torch.sqrt(torch.clamp(rr, min=tiny))
            r32 = (r / scale).to(f32)
            inner = cg_loop(self.mv32, r32, torch.zeros_like(r32), dots=dots, precond=None,
                            tol=inner_tol, nearzero=nz, maxiter=self.inner_maxiter, history=0)
            x = x + inner.x.to(torch.float64) * scale
            r = b64 - self.mv64(x)
            rr = self._dot64(r, r)
            counts[k] = inner.iterations
            k += 1
        if marks is not None:
            marks.end_loop()
        res = torch.sqrt(rr)
        return CGResult(
            x=x,
            # the outer sweeps used; the inner counts a sweep ride in history
            iterations=torch.tensor(k, dtype=torch.int32, device=dev),
            residual_norm=res,
            converged=res < tol,
            rsold=rr,
            history=counts.to(torch.float64),
            breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        )


def sharded_refine_fixed_sweeps(
    mat: DIAMatrix,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    strategy: str = "auto",
    sweeps: int = 4,
    rtol: float = 1e-11,
    inner_tol: float = 1e-6,
    inner_maxiter: Optional[int] = None,
    axis_name: str = ROWS_AXIS,
    device=None,
) -> CGResult:
    """Sharded mixed-precision solve (cgx's ``sharded_refine_fixed_sweeps``,
    sharded_cg.py:1456): an fp32 inner sharded CG and fp64 outer
    refinement sweeps, with the relative tolerance of
    :func:`cgx_torch.solver.refine.refine_fixed_sweeps`: converged means
    ``||b - A x|| < rtol ||b||``. The fp32 inner runs the strategy's mat-vec
    and all-reduces (its local product B8 by the halo strategy's "auto"
    rule); fp64 only the outer mat-vec, the residual and one all-reduce a
    sweep. ``iterations`` is the outer sweeps used, ``history`` each
    sweep's inner count. ``b`` is a host array, the same on every rank."""
    if not isinstance(mat, DIAMatrix):
        raise TypeError("sharded_refine_fixed_sweeps needs a DIAMatrix")
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    b = _host(b, np.float64)
    n = b.shape[0]
    inner_maxiter = n if inner_maxiter is None else int(inner_maxiter)
    n_pad = padded_size(n, mesh.size)
    n_loc = n_pad // mesh.size
    lo = mesh.rank * n_loc
    offsets = tuple(int(o) for o in mat.offsets)
    bands64 = pad_bands(np.asarray(mat.bands, np.float64), n_pad)[:, lo: lo + n_loc]
    bands32 = bands64.astype(np.float32)
    halo = max(max(abs(o) for o in offsets), 1)
    if strategy == "auto":
        strategy = "halo" if halo <= n_loc else "allgather"
    if strategy == "halo":
        mv64 = _DiaHalo(mesh, torch.tensor(bands64, device=dev), offsets, n_loc)
        # the fp32 inner, where the iterations are, may run B8; the fp64 outer stays plain
        lk32 = _resolve_local_kernel("auto", n_loc, torch.float32, dev)
        if lk32 == "stream2d":
            bands32 = dia_spmv.stream2d_band_planes(bands32, rows=PLANE_ROWS, cols=PLANE_COLS)
        mv32 = _DiaHalo(mesh, torch.tensor(np.ascontiguousarray(bands32), device=dev), offsets,
                        n_loc, local_kernel=lk32)
    elif strategy == "allgather":
        mv64 = _DiaAllGather(mesh, torch.tensor(bands64, device=dev), offsets, n_loc)
        mv32 = _DiaAllGather(mesh, torch.tensor(bands32, device=dev), offsets, n_loc)
    else:
        raise ValueError(f"strategy {strategy!r} not supported here")
    b_loc = torch.tensor(pad_vector(b, n_pad)[lo: lo + n_loc], device=dev)
    loop = _RefineLoop(mesh, mv64, mv32, int(sweeps), float(inner_tol), inner_maxiter)
    collectives.begin_program()
    with f32_exact():
        res = loop(b_loc, torch.zeros_like(b_loc), float(rtol), NEARZERO, marks=collectives)
    collectives.begin_output()
    return res._replace(x=collectives.all_gather(res.x, mesh)[:n])


# ---------------------------------------------------------------------------
# The multi-RHS and recycling solves (cgx sharded_cg.py:1581-2168): the
# block, harvest, deflated and block-deflated loops of cgx_torch.solver on
# the shard, their reductions through the hooks above
# ---------------------------------------------------------------------------


class _PsumDot:
    """One dot of the shard, then one all-reduce (cgx's ``_PsumDot``)."""

    def __init__(self, mesh: Mesh, precision=None):
        self.dots = _PsumDots(mesh, precision)

    def __call__(self, u, v):
        return self.dots([(u, v)])[0]


def _member_mesh(mesh: Optional[Mesh], n_devices, device, axis_name: str):
    """``mesh`` (by default ``make_mesh(n_devices)`` over the process
    group) and this rank's device; a rank outside the mesh is refused."""
    if mesh is None:
        mesh = make_mesh(n_devices, device="cuda" if device is None else device,
                         axis_name=axis_name)
    if not mesh.is_member:
        raise ValueError("this rank is not in the mesh: only its members solve")
    return mesh, (mesh.device if device is None else local_device(device))


def _solve_dtype(arr: np.ndarray) -> torch.dtype:
    """A float32 b solves in float32, any other in float64 (cgx's
    canonical dtype with x64 on)."""
    return torch.float32 if arr.dtype == np.float32 else torch.float64


def _row_block(arr, n_pad: int, mesh: Mesh, n_loc: int, dtype, dev) -> torch.Tensor:
    """This rank's rows of ``arr`` ((n,) or (n, s)), zero-padded to n_pad."""
    lo = mesh.rank * n_loc
    rows = pad_vector(np.asarray(arr), n_pad)[lo: lo + n_loc]
    return torch.tensor(np.ascontiguousarray(rows), dtype=dtype, device=dev)


def _inv_diag_rows(diag, n: int, n_pad: int, mesh: Mesh, n_loc: int, dtype, dev):
    """This rank's rows of 1 / diag(A), zero on the padded rows."""
    inv = np.zeros(n_pad, dtype=_np_dtype(dtype))
    inv[:n] = 1.0 / np.asarray(diag, dtype=_np_dtype(dtype))
    return torch.tensor(inv[mesh.rank * n_loc: (mesh.rank + 1) * n_loc], device=dev)


def _block_op(mat, n: int, n_pad: int, n_loc: int, mesh: Mesh, dtype, dev, strategy: str,
              dense_fp64: str = "emulated"):
    """The strategy mat-vec of a block solve (its local product the plain
    one, as cgx's ``_build_op`` default) and the diagonal; cgx's refusal
    of the formats whose block product it lacks."""
    mv, diag, _strategy, _kernel = _build_op(mat, n, n_pad, n_loc, mesh, dtype, dev, strategy,
                                             dense_fp64, "xla")
    if isinstance(mv, (_SparseAllGather, _DenseReduceScatter)):
        raise ValueError("sharded block CG supports DIA (halo/allgather) and dense (allgather) "
                         "operators")
    return mv, diag


def _deflation_data(mat, n: int, k: int, w, lanczos_m):
    """W (by default ``lanczos_ritz`` of ``mat`` on the host), A W by the
    host mat-vec, the inverse of W^T A W and (AW)^T AW, in float64 on the
    host (cgx sharded_cg.py:1762-1771)."""
    if w is None:
        w = lanczos_ritz(mat, n, int(k), m=lanczos_m)
    w = _host(w, np.float64)
    if w.ndim != 2 or w.shape[0] != n:
        raise ValueError(f"w must be (n, k); got {w.shape}")
    hmv = host_matvec(mat)
    aw = np.stack([hmv(w[:, j]) for j in range(w.shape[1])], axis=1)
    return w, aw, np.linalg.inv(w.T @ aw), aw.T @ aw


def _csr_of_coo(mat):
    return CSRMatrix.from_coo(mat) if isinstance(mat, COOMatrix) else mat


def sharded_block_cg_solve(
    mat,
    b_block,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    strategy: str = "auto",
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    jitter_eps: float = 1e-15,
    method: str = "breakdown_free",
    rank_tol: float = 1e-12,
    precond: Optional[str] = None,
    bounds: Optional[tuple] = None,
    dense_fp64: str = "emulated",
    axis_name: str = ROWS_AXIS,
    device=None,
):
    """Row-block-sharded block CG: one Krylov space for every column of
    the (n, s) ``b_block`` over the mesh (cgx's ``sharded_block_cg_solve``,
    sharded_cg.py:2029; :mod:`cgx_torch.solver.blockcg` on the shard). An
    iteration: one block mat-vec (a halo of h s elements a direction, or
    one gather) and the Gram all-reduces, ONE (3s, 3s) for
    ``method="breakdown_free"`` (the default), two (s, s) for
    ``"oleary"``. ``precond`` None, ``"jacobi"``, ``"neumann"`` (one more
    block mat-vec) or ``"chebyshev"`` (degree 3 on ``bounds``, default
    :func:`~cgx_torch.solver.chebyshev.host_spectral_bounds`), breakdown-free
    only; it adds the (3s, s) strip's all-reduce. DIA (halo or allgather)
    and dense (allgather) operators; ``dense_fp64`` as
    :func:`make_sharded_solver`. ``b_block`` is a host array, the same on
    every rank; a float32 one solves in float32. The small Gram algebra
    runs on each rank's host on the all-reduced Grams, so every rank takes
    the same decisions. Returns a :class:`~cgx_torch.solver.blockcg.
    BlockCGResult` with the whole (n, s) x on every rank."""
    b_block = _host(b_block)
    if b_block.ndim != 2:
        raise ValueError("b_block must be (n, s)")
    if method not in ("breakdown_free", "oleary"):
        raise ValueError(f"unknown block CG method {method!r}")
    if precond is not None and method != "breakdown_free":
        raise ValueError("precond requires method='breakdown_free'")
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    n = b_block.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    n_pad = padded_size(n, mesh.size)
    n_loc = n_pad // mesh.size
    dtype = _solve_dtype(b_block)
    mat = _csr_of_coo(mat)
    mv, diag = _block_op(mat, n, n_pad, n_loc, mesh, dtype, dev, strategy, dense_fp64)
    pc = None
    if precond is not None:  # cgx sharded_cg.py:2101-2123
        inv_loc = _inv_diag_rows(diag, n, n_pad, mesh, n_loc, dtype, dev)
        if precond == "jacobi":
            pc = _JacobiPrecond(inv_loc)
        elif precond == "neumann":
            pc = _NeumannPrecond(mv, inv_loc)
        elif precond == "chebyshev":
            lmin, lmax = bounds if bounds is not None else host_spectral_bounds(mat)
            pc = chebyshev_poly(mv, float(lmin), float(lmax), degree=CHEBYSHEV_DEGREE)
        else:
            raise ValueError(f"unknown precond {precond!r}")
    b_loc = _row_block(b_block, n_pad, mesh, n_loc, dtype, dev)
    gram = _PsumBlockGram(mesh)
    collectives.begin_program()
    with f32_exact():
        if method == "breakdown_free":
            res = bf_block_cg_loop(mv, b_loc, torch.zeros_like(b_loc), tol, maxiter=maxiter,
                                   rank_tol=rank_tol, gram=gram, precond=pc, marks=collectives)
        else:
            res = block_cg_loop(mv, b_loc, torch.zeros_like(b_loc), tol, maxiter=maxiter,
                                jitter_eps=jitter_eps, gram=gram, marks=collectives)
    collectives.begin_output()
    return res._replace(x=collectives.all_gather(res.x, mesh)[:n])


def sharded_cg_solve_harvest(
    mat,
    b,
    *,
    k: int = 8,
    window: Optional[int] = None,
    ritz_tol: float = 1e-3,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    strategy: str = "auto",
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    strict: bool = True,
    local_kernel: str = "auto",
    axis_name: str = ROWS_AXIS,
    device=None,
):
    """Row-block-sharded plain CG that also harvests a deflation basis from
    its own iterates (cgx's ``sharded_cg_solve_harvest``, sharded_cg.py:1601):
    returns ``(result, w)``, ``w`` an (n, k') orthonormal host array of
    converged Ritz vectors for :func:`sharded_deflated_cg_solve`'s ``w=``.
    The Lanczos window stays row-sharded during the loop, (window, n_loc)
    a rank, so an iteration's collectives are the plain reference solve's;
    after the loop the captured rows are gathered once to every rank (set
    apart in the record, with the gather of x) and the Ritz extraction runs
    on each rank's host on the same inputs. ``local_kernel`` as
    :func:`make_sharded_solver` ("auto": B8 for a float32 shard of at
    least :data:`STREAM_LOCAL_MIN_ELEMS` rows on CUDA). With
    ``strict=False`` a failed extraction returns ``(result, None)``.
    The gather's seconds are kept in ``sharded_cg_solve_harvest.
    gather_seconds``."""
    b = _host(b)
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    n = b.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    window = int(min(max(8 * k, 64) if window is None else window, maxiter, n))
    n_pad = padded_size(n, mesh.size)
    n_loc = n_pad // mesh.size
    dtype = _solve_dtype(b)
    mv, _diag, _strategy, _kernel = _build_op(_csr_of_coo(mat), n, n_pad, n_loc, mesh, dtype,
                                              dev, strategy, "emulated", local_kernel)
    b_loc = _row_block(b, n_pad, mesh, n_loc, dtype, dev)
    collectives.begin_program()
    with f32_exact():
        res, win, av, bv = _harvest_cg_loop(
            mv, b_loc, torch.zeros_like(b_loc), torch.tensor(tol, dtype=dtype, device=dev),
            torch.tensor(nearzero, dtype=dtype, device=dev), maxiter=maxiter, window=window,
            dot=_PsumDot(mesh), marks=collectives)
    collectives.begin_output()
    res = res._replace(x=collectives.all_gather(res.x, mesh)[:n])
    steps = min(int(res.iterations) + 1, window)
    t0 = time.perf_counter()
    # the captured rows of every rank, (P, steps, n_loc), as the (steps, n) window
    shards = collectives.all_gather(win[:steps].reshape(-1), mesh)
    win_full = shards.reshape(mesh.size, steps, n_loc).transpose(0, 1).reshape(steps, -1)[:, :n]
    win_np = win_full.cpu().numpy()
    sharded_cg_solve_harvest.gather_seconds = time.perf_counter() - t0
    del shards, win_full, win
    try:
        w = _ritz_from_cg_window(win_np, av.cpu().numpy(), bv.cpu().numpy(), steps, int(k),
                                 ritz_tol)
    except ValueError:
        if strict:
            raise
        return res, None
    return res, w


sharded_cg_solve_harvest.gather_seconds = None


def sharded_deflated_cg_solve(
    mat,
    b,
    *,
    k: int = 8,
    w=None,
    lanczos_m: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    strategy: str = "auto",
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    precond: Optional[str] = None,
    x0=None,
    local_kernel: str = "auto",
    axis_name: str = ROWS_AXIS,
    device=None,
) -> CGResult:
    """Row-block-sharded deflated CG (cgx's ``sharded_deflated_cg_solve``,
    sharded_cg.py:1712; :func:`cgx_torch.solver.deflated.deflated_cg_loop`
    on the shard). W comes from ``lanczos_ritz`` of ``mat`` on the host
    unless an (n, k) ``w`` is given; A W, the (k, k) inverse of W^T A W and
    (AW)^T AW are built on the host in float64. W and A W are row-sharded
    and zero-padded, the two (k, k) matrices replicated. An iteration: the
    conjugacy dot, the fused (2k,) ``[W, AW]^T r`` and ``<r, r>``, one
    all-reduce each. ``precond`` None, ``"jacobi"`` or ``"neumann"``
    (deflated PCG): the guard then contracts ``W^T r`` (k), and ``<r, z>``,
    ``<r, r>`` and ``(AW)^T z`` ride one all-reduce of k + 2 elements.
    ``x0`` warm-starts; ``local_kernel`` as :func:`make_sharded_solver`."""
    b = _host(b)
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    n = b.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    n_pad = padded_size(n, mesh.size)
    n_loc = n_pad // mesh.size
    dtype = _solve_dtype(b)
    mat = _csr_of_coo(mat)
    w, aw, minv, awtaw = _deflation_data(mat, n, k, w, lanczos_m)
    mv, diag, _strategy, _kernel = _build_op(mat, n, n_pad, n_loc, mesh, dtype, dev, strategy,
                                             "emulated", local_kernel)
    pc = None
    if precond is not None:
        inv_loc = _inv_diag_rows(diag, n, n_pad, mesh, n_loc, dtype, dev)
        if precond == "jacobi":
            pc = _JacobiPrecond(inv_loc)
        elif precond == "neumann":
            pc = _NeumannPrecond(mv, inv_loc)
        else:
            raise ValueError(f"unknown precond {precond!r}")
    b_loc = _row_block(b, n_pad, mesh, n_loc, dtype, dev)
    if x0 is None:
        x0_loc = torch.zeros_like(b_loc)
    else:
        x0 = _host(x0, _np_dtype(dtype))
        if x0.shape != (n,):
            raise ValueError(f"x0 must be ({n},); got {x0.shape}")
        x0_loc = _row_block(x0, n_pad, mesh, n_loc, dtype, dev)

    def small(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    collectives.begin_program()
    with f32_exact():
        res = deflated_cg_loop(
            mv, b_loc, x0_loc, _row_block(w, n_pad, mesh, n_loc, dtype, dev),
            _row_block(aw, n_pad, mesh, n_loc, dtype, dev), small(minv), small(awtaw),
            torch.tensor(tol, dtype=dtype, device=dev),
            torch.tensor(nearzero, dtype=dtype, device=dev), maxiter=maxiter,
            dot=_PsumDot(mesh), tallT=_PsumTallT(mesh), fuse=_PsumFused(mesh), precond=pc,
            marks=collectives)
    collectives.begin_output()
    return res._replace(x=collectives.all_gather(res.x, mesh)[:n])


def sharded_block_deflated_cg_solve(
    mat,
    b_block,
    *,
    k: int = 8,
    w=None,
    lanczos_m: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    strategy: str = "auto",
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    rank_tol: float = 1e-12,
    axis_name: str = ROWS_AXIS,
    device=None,
):
    """Row-block-sharded deflated breakdown-free block CG (cgx's
    ``sharded_block_deflated_cg_solve``, sharded_cg.py:1859): one block
    Krylov space for every column of the (n, s) ``b_block`` and W's
    recycled Ritz vectors (W as :func:`sharded_deflated_cg_solve`). An
    iteration: one block mat-vec and three all-reduces, the (3s, 3s) Gram,
    the fused (2k, s) ``[W, AW]^T R`` and the (3s, s) strip. DIA and dense
    operators."""
    b_block = _host(b_block)
    if b_block.ndim != 2:
        raise ValueError("b_block must be (n, s)")
    mesh, dev = _member_mesh(mesh, n_devices, device, axis_name)
    n = b_block.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    n_pad = padded_size(n, mesh.size)
    n_loc = n_pad // mesh.size
    dtype = _solve_dtype(b_block)
    mat = _csr_of_coo(mat)
    w, aw, minv, awtaw = _deflation_data(mat, n, k, w, lanczos_m)
    mv, _diag = _block_op(mat, n, n_pad, n_loc, mesh, dtype, dev, strategy)
    b_loc = _row_block(b_block, n_pad, mesh, n_loc, dtype, dev)
    collectives.begin_program()
    with f32_exact():
        res = bf_block_deflated_cg_loop(
            mv, b_loc, torch.zeros_like(b_loc), _row_block(w, n_pad, mesh, n_loc, dtype, dev),
            _row_block(aw, n_pad, mesh, n_loc, dtype, dev),
            torch.tensor(minv, dtype=dtype, device=dev),
            torch.tensor(awtaw, dtype=dtype, device=dev), tol, maxiter=maxiter,
            rank_tol=rank_tol, gram=_PsumBlockGram(mesh), marks=collectives)
    collectives.begin_output()
    return res._replace(x=collectives.all_gather(res.x, mesh)[:n])

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

The methods are ``reference`` (two all-reduces an iteration) and
``pipelined`` (Chronopoulos-Gear: one all-reduce of two dots, three with
a preconditioner), with no preconditioner, ``jacobi``, ``block_jacobi``
(the shard's diagonal blocks inverted once, applied as one local batched
product: no collective), ``neumann`` or ``chebyshev`` (degree 3, three
strategy mat-vecs an application). A dense fp64 operator takes cgx's
Ozaki int8 slices under ``dense_fp64="ozaki"`` (allgather only).
What is not ported yet raises ``NotImplementedError`` naming its ROADMAP
item. Operations that cgx leaves to XLA are plain torch here.
"""

from __future__ import annotations

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
from cgx_torch.parallel.mesh import ROWS_AXIS, Mesh, local_device, make_mesh
from cgx_torch.parallel.partition import pad_bands, pad_dense, pad_vector, padded_size
from cgx_torch.solver.cg import CGResult, cg_loop
from cgx_torch.solver.chebyshev import host_spectral_bounds
from cgx_torch.solver.operators import CsrOperator, EllOperator, _torch_dtype
from cgx_torch.solver.pipelined import pipelined_cg_loop
from cgx_torch.solver.precond import chebyshev_poly, diag_blocks, invert_spd_blocks
from cgx_torch.utils import collectives

# Per-shard rows from which "auto" streams the local banded product through
# B8 (cgx's threshold, sharded_cg.py:1124, measured there on a TPU; kept as
# the rule, not as a number about the H100).
STREAM_LOCAL_MIN_ELEMS = 2_000_000
# cgx's per-shard band-plane tile (sharded_cg.py:192-195)
PLANE_ROWS, PLANE_COLS = 256, 512

_UNPORTED_METHODS = {"sstep": "the sharded s-step, ROADMAP A14",
                     "gvpipe": "ROADMAP A11", "chebyshev": "ROADMAP A11"}
PRECONDS = (None, "jacobi", "block_jacobi", "neumann", "chebyshev")
CHEBYSHEV_DEGREE = 3  # cgx's sharded polynomial (sharded_cg.py:794)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to cgx_torch yet")


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


class _DiaAllGather:
    def __init__(self, mesh: Mesh, bands_loc: torch.Tensor, offsets, n_loc: int):
        self.mesh, self.bands_loc, self.offsets, self.n_loc = mesh, bands_loc, offsets, n_loc

    def __call__(self, p_loc):
        p_full = collectives.all_gather(p_loc, self.mesh)
        start = self.mesh.rank * self.n_loc
        pad = max(max(abs(o) for o in self.offsets), 1)
        p_pad = F.pad(p_full, (pad, pad))
        y = torch.zeros_like(p_loc)
        for d, off in enumerate(self.offsets):
            lo = pad + start + off
            y = y + self.bands_loc[d] * p_pad[lo: lo + self.n_loc]
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
        left, right = collectives.halo_exchange(p_loc[:h], p_loc[-h:], self.mesh, self.zeros)
        return self.local(p_loc, left, right)

    def local(self, p_loc, left, right):
        """The shard's rows of A p, given the two halos."""
        h, n_loc = self.halo, self.n_loc
        if self.local_kernel == "stream2d":
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
            y = y + self.flat[d] * p_ext[h + off: h + off + n_loc]
        return y


class _SparseAllGather:
    """CSR or ELL rows: p gathered, the shard's rows applied by the
    port's operator, its column indices global (cgx's ``_CsrAllGather``
    and ``_EllAllGather``; the CSR row sums are padded-row gathers, so
    their order is fixed, where cgx's ``segment_sum`` scatters)."""

    def __init__(self, mesh: Mesh, op_loc):
        self.mesh, self.op_loc = mesh, op_loc

    def __call__(self, p_loc):
        return self.op_loc.matvec(collectives.all_gather(p_loc, self.mesh))


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
    strategy mat-vec, with its collectives, an application."""

    def __init__(self, mv: Callable, inv_diag: torch.Tensor):
        self.mv, self.inv_diag = mv, inv_diag

    def __call__(self, r):
        c = self.inv_diag * r
        return 2.0 * c - self.inv_diag * self.mv(c)


class _JacobiPrecond:
    """``z = r / diag(A)``, purely local."""

    def __init__(self, inv_diag: torch.Tensor):
        self.inv_diag = inv_diag

    def __call__(self, r):
        return self.inv_diag * r


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
    axis_name: str = ROWS_AXIS,
    device=None,
) -> "ShardedCGSolver":
    """Build an operator-resident row-block-sharded CG solver (cgx's
    signature, less the options of its unported methods).

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
      method: ``"reference"`` (two all-reduces an iteration) or
        ``"pipelined"`` (one, of two dots; three with a preconditioner).
        ``"sstep"`` (A14), ``"gvpipe"`` and ``"chebyshev"`` (A11) raise.
      tol, nearzero: per-call defaults (absolute tolerance, alpha clamp).
      maxiter: iteration cap; defaults to N.
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
      bounds: ``(lmin, lmax)`` of the Chebyshev preconditioner; default
        :func:`cgx_torch.solver.chebyshev.host_spectral_bounds` of ``mat``.
      dense_fp64: a dense fp64 operator's product: ``"emulated"`` and
        ``"auto"`` the fp64 ``torch.matmul`` (the H100's fp64 is native),
        ``"ozaki"`` cgx's int8 slices (:mod:`cgx_torch.ops.ozaki`), under
        the allgather strategy.
      local_kernel: ``"auto"``, ``"xla"`` or ``"stream2d"``, the local
        product of the halo strategy (see :func:`_resolve_local_kernel`).
      axis_name: the name of the mesh's axis, when the mesh is made here.
      device: where this rank computes; default the mesh's
        (``cuda:LOCAL_RANK`` unless the mesh was made for the CPU).

    cgx's options of the s-step, gvpipe and Chebyshev methods
    (``check_every``, ``sstep_*``, ``gv_replace_every``) come with those
    methods (A11, A14).

    N is padded to a multiple of the mesh size with zero rows; padded
    entries of b, x, r and p stay exactly zero through every iteration.
    """
    if method in _UNPORTED_METHODS:
        raise _unported(f"method={method!r} on the sharded route ({_UNPORTED_METHODS[method]})")
    if method not in ("reference", "pipelined"):
        raise ValueError(f"unknown method {method!r}")
    if jacobi and precond is None:
        precond = "jacobi"
    if precond not in PRECONDS:
        raise ValueError(f"unknown precond {precond!r}")
    if mesh is None:
        mesh = make_mesh(n_devices, device="cuda" if device is None else device,
                         axis_name=axis_name)
    if not mesh.is_member:
        raise ValueError("this rank is not in the mesh: only its members solve")
    dev = mesh.device if device is None else local_device(device)
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
        inv = np.zeros(n_pad, dtype=_np_dtype(dtype))
        inv[:n] = 1.0 / np.asarray(diag, dtype=_np_dtype(dtype))
        inv_loc = torch.tensor(inv[lo: lo + n_loc], device=dev)
        pc = _JacobiPrecond(inv_loc) if precond == "jacobi" else _NeumannPrecond(mv, inv_loc)
    dot_precision = _torch_dtype(dot_precision, None)
    return ShardedCGSolver(
        mesh=mesh, device=dev, n=n, n_pad=n_pad, dtype=dtype, mv=mv, precond=pc, method=method,
        maxiter=n if maxiter is None else int(maxiter), history=int(history),
        dot_precision=dot_precision, tol=float(tol), nearzero=float(nearzero),
        strategy=strategy, local_kernel=kernel,
    )


class ShardedCGSolver:
    """Operator-resident sharded CG solver (see :func:`make_sharded_solver`).

    Calling it solves ``A x = b`` for a new right-hand side on every rank
    of the mesh; ``x0`` warm starts, and ``tol``/``nearzero`` override
    the build-time defaults per call. ``strategy`` and ``local_kernel``
    say what ``"auto"`` resolved to (``local_kernel`` is None outside the
    halo strategy)."""

    def __init__(self, *, mesh, device, n, n_pad, dtype, mv, precond, method, maxiter, history,
                 dot_precision, tol, nearzero, strategy, local_kernel):
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
            if self.method == "pipelined":
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


def sharded_cg_solve(mat, b, *, x0=None, **kwargs) -> CGResult:
    """Solve ``A x = b`` with row-block-sharded CG over a mesh of ranks:
    :func:`make_sharded_solver` and one solve (see there for the options).
    ``b`` (and ``x0``) are host arrays, the same on every rank; a float32
    ``b`` solves in float32."""
    b = _host(b)
    dtype = b.dtype if b.dtype in (np.float32, np.float64) else np.float64
    solver = make_sharded_solver(mat, b.shape[0], dtype=dtype, **kwargs)
    return solver.solve(b, x0=x0)


def _unported_entry(name: str, item: str):
    def entry(*args, **kwargs):
        raise _unported(f"{name} ({item})")
    entry.__name__ = entry.__qualname__ = name
    entry.__doc__ = f"cgx's ``{name}``: not ported yet ({item}); raises NotImplementedError."
    return entry


# cgx's other sharded solves, the rest of ROADMAP A14
sharded_refine_fixed_sweeps = _unported_entry("sharded_refine_fixed_sweeps", "ROADMAP A14")
sharded_block_cg_solve = _unported_entry("sharded_block_cg_solve", "ROADMAP A14")
sharded_deflated_cg_solve = _unported_entry("sharded_deflated_cg_solve", "ROADMAP A14")
sharded_block_deflated_cg_solve = _unported_entry("sharded_block_deflated_cg_solve",
                                                  "ROADMAP A14")
sharded_cg_solve_harvest = _unported_entry("sharded_cg_solve_harvest", "ROADMAP A14")
sharded_cg_solve_batched = _unported_entry("sharded_cg_solve_batched (batched2d)",
                                           "ROADMAP A14")
sharded_mg_cg_solve = _unported_entry("sharded_mg_cg_solve (mg_sharded)", "ROADMAP A14, after A10")
sharded_tw_solve = _unported_entry("sharded_tw_solve (tw_sharded)", "ROADMAP A14, after A12")

"""Sharded fused streaming s-step CG (counterpart of
``cgx/parallel/sstep_fused.py``): kernels B10 run per shard in their halo
mode, and the mesh pays one Gram all-reduce a block of s iterations.

It joins the two communication-avoiding halves, as cgx does:

- between ranks, the deep-halo scheme of
  :class:`cgx_torch.parallel.sharded_cg._DeepHaloBasis`: each rank holds
  its ``n_loc`` rows with ``d = pm * cols`` rows of each neighbour on
  either side, refreshed once a block by one stacked exchange a
  direction (the edges of p and r in one message), so that the whole
  block's basis is built locally;
- on the rank, the fused two-launch block (:mod:`cgx_torch.ops.
  sstep_stream`): the Gram launch regenerates the basis on chip and sums
  ``G = V V^T`` in float64, the recover launch regenerates it and writes
  x, r and p, so that the basis never reaches device memory.

The launches run in the halo mode (``window``): the generator reads the
extended rows, whose halo holds the neighbours' rows (zeros past the
mesh's ends), and the Gram sums and the recover writes only the shard's
own rows. ``d`` covers the s applications' reach (``pm * cols >= s h``),
so those rows' levels are the whole vector's. A block is: the exchange
into the halves the next launch reads, the Gram-only launch (``part``),
one all-reduce of the shard's float64 G, the replay kernel on the summed
G (``live_only``), and the recover. cgx all-reduces double-float32 (hi,
lo) pairs and folds them after the sum; the port's G is float64, one
(m, m) all-reduce (ROADMAP.md §C).

Once a solve: the band edges (two exchanges), the edges of x0 for the
first residual (two), the global max of |b| and |x0| for the exact
power-of-two prescale (cgx's ``pmax``) and the sum of ``||r0||^2``.

cgx's TPU planes set the geometry: :func:`fused_plane_geometry` picks
cgx's (rows, cols, pm) tiling of the shard or raises with the concrete
numbers, as cgx's does. The CUDA kernels read flat rows and need none of
it but the halo depth ``pm * cols``; the contract is kept so that a
configuration cgx refuses is refused here too, and never run on
another route. The depth is cgx's too, though the basis needs only
``s h`` rows (lap2d_fd(3200) in 2,560,000-row shards at s = 4: 20,480
against 12,800), so that every exchange moves cgx's volume (ROADMAP.md
§C). On the CPU the launches run their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.ops import sstep_stream as ss
from cgx_torch.ops.dia_powers import _powers_geometry, sublanes
from cgx_torch.ops.dia_spmv import dia_matvec_ref
from cgx_torch.parallel.mesh import Mesh
from cgx_torch.parallel.sharded_cg import extended_rows
from cgx_torch.solver.cg import CGResult
from cgx_torch.solver.operators import _torch_dtype
from cgx_torch.solver.sstep import _BLOCKS, _basis_matrix
from cgx_torch.utils import collectives

# cgx's lane widths of the plane layout, widest first
_COLS_CANDIDATES = (512, 256, 128)


def fused_plane_geometry(offsets: Tuple[int, ...], s: int, n_loc: int, dtype,
                         bands_dtype=None,
                         cols_candidates: Tuple[int, ...] = _COLS_CANDIDATES
                         ) -> Tuple[int, int, int]:
    """cgx's ``(rows, cols, pm)`` tiling of an ``n_loc``-row shard, or
    ``ValueError`` (cgx ``fused_plane_geometry``, its rules and message):
    ``n_loc`` a multiple of ``rows * cols``, ``rows >= pm``, the halo
    ``pm * cols <= n_loc``, ``rows`` a multiple of the sublane tile of the
    narrower of ``dtype`` and ``bands_dtype``; the widest cols, then the
    smallest rows >= 256, else the largest rows below."""
    dtype = _torch_dtype(dtype, None)
    align = dtype
    if bands_dtype is not None:
        bdt = _torch_dtype(bands_dtype, None)
        if bdt.itemsize < dtype.itemsize:
            align = bdt
    sub = sublanes(align)
    tried = []
    for cols in cols_candidates:
        if n_loc % cols:
            tried.append(f"cols={cols}: n_loc % cols != 0")
            continue
        ni = n_loc // cols
        pm = _powers_geometry(tuple(offsets), int(s), sub, cols, align, n_loc)[4]
        if pm * cols > n_loc:
            tried.append(f"cols={cols}: halo pm*cols={pm * cols} > n_loc")
            continue
        cands = [r for r in range(sub, ni + 1, sub) if ni % r == 0 and r >= pm]
        if not cands:
            tried.append(f"cols={cols}: no rows in [{max(pm, sub)}, {ni}] divides interior "
                         f"{ni} (pm={pm})")
            continue
        preferred = [r for r in cands if r >= 256]
        return (min(preferred) if preferred else max(cands)), cols, pm
    raise ValueError(
        "sstep_powers='fused': no (rows, cols) plane tiling of the shard "
        f"(n_loc={n_loc}, offsets={tuple(offsets)}, s={s}) satisfies the fused-kernel "
        f"constraints [{'; '.join(tried)}]. Use sstep_powers='deephalo' (no tiling "
        "constraint), fewer shards, or a shard-divisible problem size.")


class _SStepFusedLoop:
    """The s-step loop of ``sstep_powers="fused"`` on one rank (cgx's
    ``_SStepFusedLoop``): ``(b_loc, x0_loc, tol, nearzero) -> CGResult``
    with the shard's x and the mesh's scalars. ``bands_loc`` is the shard's
    flat (ndiag, n_loc) bands in the solve's dtype; ``bands_dtype`` the
    streamed bands' (bfloat16, float16 or None)."""

    def __init__(self, mesh: Mesh, bands_loc: torch.Tensor, offsets, n_loc: int, s: int,
                 maxiter: int, theta: float, delta: float, shifts, rows: int, cols: int,
                 pm: int, bands_dtype: Optional[torch.dtype]):
        self.mesh, self.bands_loc = mesh, bands_loc
        self.offsets = tuple(int(o) for o in offsets)
        self.n_loc, self.s, self.maxiter = int(n_loc), int(s), int(maxiter)
        self.theta, self.delta = float(theta), float(delta)
        self.shifts = tuple(float(v) for v in shifts)
        self.rows, self.cols, self.pm = int(rows), int(cols), int(pm)
        self.bands_dtype = bands_dtype
        self.depth = self.pm * self.cols
        if self.depth > self.n_loc:
            raise ValueError(f"halo depth pm*cols={self.depth} exceeds the shard size "
                             f"{self.n_loc}")
        if self.n_loc % (self.rows * self.cols):
            raise ValueError(f"shard size {self.n_loc} does not tile into ({self.rows}, "
                             f"{self.cols}) blocks")

    def __call__(self, b: torch.Tensor, x0: torch.Tensor, tol: float, nearzero: float,
                 marks=None) -> CGResult:
        dtype, dev = b.dtype, b.device
        s, m, d, n_loc = self.s, 2 * self.s + 1, self.depth, self.n_loc
        bands = self.bands_loc
        bdt = self.bands_dtype if self.bands_dtype not in (None, dtype) else None
        if bdt is not None:
            # round once, so that the first residual and the streamed bands
            # are one operator (bitwise a no-op for bands exact in bdt)
            bands = bands.to(bdt).to(dtype)
        # the band edges, once a solve
        bands_ext = extended_rows(bands, d, self.mesh)
        bands_pl = (bands_ext.to(bdt) if bdt is not None else bands_ext).contiguous()

        # the exact power-of-two prescale from the global max (cgx's pmax)
        amax = torch.maximum(torch.max(torch.abs(b)), torch.max(torch.abs(x0))).reshape(1)
        amax = collectives.all_reduce_max(amax, self.mesh)[0]
        _, e = torch.frexp(amax)
        one = torch.ones((), dtype=dtype, device=dev)
        down_t, up_t = torch.ldexp(one, -e), torch.ldexp(one, e)
        down, up = float(down_t), float(up_t)
        b, x0 = b * down_t, x0 * down_t
        tol_s = float(tol) * down

        # r0 = b - A x0 on the extended rows, from the edges of x0
        r0 = b - dia_matvec_ref(bands_ext, extended_rows(x0, d, self.mesh),
                                offsets=self.offsets)[d:d + n_loc]
        rs0 = collectives.all_reduce(torch.sum(r0.to(torch.float64) ** 2).reshape(1),
                                     self.mesh)[0]
        n_ext = n_loc + 2 * d
        p = torch.zeros((2, n_ext), dtype=dtype, device=dev)
        r = torch.zeros_like(p)
        x = torch.zeros(n_ext, dtype=dtype, device=dev)
        p[0, d:d + n_loc] = r0
        r[0, d:d + n_loc] = r0
        x[d:d + n_loc] = x0
        state = torch.zeros(ss.STATE_LEN, dtype=torch.float64, device=dev)
        state[ss.RSOLD] = rs0
        state[ss.RSNEW] = rs0
        state[ss.CONV] = ((torch.sqrt(rs0) < tol_s) | (rs0 == 0)).to(torch.float64)
        bmat = torch.as_tensor(_basis_matrix(s, self.theta, self.delta, np.float64, self.shifts),
                               device=dev)
        work = None if dev.type == "cpu" else ss.workspace(dev, n_loc, self.offsets, s, dtype)
        kw = dict(offsets=self.offsets, s=s, theta=self.theta, delta=self.delta,
                  shifts=self.shifts, work=work, window=(d, d + n_loc))
        zeros_e = torch.zeros((2, d), dtype=dtype, device=dev)
        gram = state[ss.GRAM:ss.GRAM + m * m]
        blocks = 0
        while not ss._stopped(state[:ss.COEF].tolist(), self.maxiter):  # one read per _BLOCKS
            for _ in range(_BLOCKS):
                if marks is not None:
                    marks.next_iteration()
                # the halo rows of the halves the launches read, from the
                # neighbours' own rows (the parity is the state's block count,
                # which every live block advances; after the stop none reads)
                q = blocks & 1
                left, right = collectives.halo_exchange(
                    torch.stack([p[q, d:2 * d], r[q, d:2 * d]]),
                    torch.stack([p[q, n_loc:n_loc + d], r[q, n_loc:n_loc + d]]), self.mesh,
                    zeros_e)
                p[q, :d], r[q, :d] = left[0], left[1]
                p[q, d + n_loc:], r[q, d + n_loc:] = right[0], right[1]
                ss._sstep_gram(bands_pl, p, r, state, bmat, tol=tol_s, nearzero=nearzero,
                               maxiter=self.maxiter, part=True, **kw)
                collectives.all_reduce(gram, self.mesh)
                ss.sstep_replay(state, bmat, s=s, tol=tol_s, nearzero=nearzero,
                                maxiter=self.maxiter, live_only=True)
                ss._sstep_recover(bands_pl, p, r, x, state, **kw)
                blocks += 1
        if marks is not None:
            marks.end_loop()
        return CGResult(
            x=x[d:d + n_loc] * up_t,
            iterations=state[ss.K].to(torch.int32),
            residual_norm=torch.sqrt(state[ss.RSNEW]).to(dtype) * up,
            converged=state[ss.CONV] != 0,
            rsold=state[ss.RSOLD].to(dtype) * (up * up),
            history=torch.zeros((0,), dtype=dtype, device=dev),
            breakdown=state[ss.BRK] != 0,
        )

"""Geometric multigrid preconditioner for grid Laplacians (counterpart of
``cgx/solver/multigrid.py``).

CG on the g x g 5-point Laplacian needs O(g) iterations (488 at g = 100);
CG preconditioned by a V-cycle needs O(10) whatever g. The construction
is cgx's:

- smoothing: scalar Richardson ``z += (omega / max diag)(r - A z)``, or
  multicolour Gauss-Seidel (masked pointwise-Jacobi steps, the
  post-smoother in reversed colour order), so the cycle is symmetric;
- transfers: cell-centred (bi/tri)linear, ``R = P^T`` (the default), or
  2^ndim aggregation (mean-pool and broadcast, with an overcorrection);
- coarse operators: Galerkin products ``A_c = R A P`` built once, on
  the host with NumPy bincounts (a copy of cgx's code) or on the device
  by band probing (:func:`galerkin_probe`); every level stays banded;
- coarsest level: a dense inverse up to 4096 unknowns, else a degree-40
  Chebyshev solve on host spectral bounds.

Every product of the cycle is the plain banded mat-vec
(:func:`cgx_torch.ops.dia_spmv.dia_matvec_ref`), as cgx's cycle is XLA's
``banded_matvec``: the coarse levels carry 21 to 125 bands, past the
banded kernels' 16. The hierarchy lives on the fine operator's device;
the host keeps only the static offsets, grids and damping factors.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
from typing import List, Optional

import numpy as np
import torch

from cgx_torch.mats.containers import DIAMatrix
from cgx_torch.ops._util import check_device, f32_exact, resolve_device
from cgx_torch.ops.dia_spmv import dia_matvec_ref
from cgx_torch.solver.chebyshev import host_spectral_bounds
from cgx_torch.solver.operators import DiaOperator
from cgx_torch.solver.precond import _np64, chebyshev_banded

# Galerkin band probing: max words of one (batch, n_fine) intermediate
# before the probes run in batches of PROBE_WORDS_BUDGET // n_fine (cgx's
# rule, kept as it is).
PROBE_WORDS_BUDGET = 2 * 10**8

_CHEB_DEGREE = 40  # the coarsest level's Chebyshev degree


# --- host Galerkin build (NumPy, cgx's code) -----------------------------


def _group_index(g: int, ndim: int = 2) -> np.ndarray:
    """Flat fine index -> flat coarse index for 2^ndim aggregation."""
    gc = g // 2
    idx = np.arange(g**ndim)
    out = np.zeros_like(idx)
    rem = idx
    for axis in range(ndim):
        coord = rem // (g ** (ndim - 1 - axis))
        rem = rem % (g ** (ndim - 1 - axis))
        out = out * gc + coord // 2
    return out


def _dia_to_coo(mat: DIAMatrix):
    n = mat.shape[0]
    rows_l, cols_l, vals_l = [], [], []
    for d, off in enumerate(mat.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        r = np.arange(lo, hi)
        v = mat.bands[d, lo:hi]
        keep = v != 0.0
        rows_l.append(r[keep])
        cols_l.append(r[keep] + off)
        vals_l.append(v[keep])
    return np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals_l)


def _accumulate_bands(bands: dict, crow, ccol, vals, n_c: int) -> None:
    """Scatter-add COO triplets into per-offset band vectors: a small
    histogram finds the offsets, one ``np.bincount`` per offset adds the
    rows (O(nnz), no global sort)."""
    off = (ccol - crow).astype(np.int64)
    if off.size == 0:
        return
    omin = int(off.min())
    hist = np.bincount(off - omin)
    for oi in np.nonzero(hist)[0]:
        o = int(oi) + omin
        m = off == o
        band = bands.get(o)
        if band is None:
            band = np.zeros(n_c)
            bands[o] = band
        band += np.bincount(crow[m], weights=vals[m], minlength=n_c)


def _bands_to_dia(bands: dict, n_c: int) -> DIAMatrix:
    offs = sorted(o for o, b in bands.items() if b.any())
    arr = np.stack([bands[o] for o in offs])
    return DIAMatrix((n_c, n_c), tuple(int(o) for o in offs), arr)


def _galerkin_dia(mat: DIAMatrix, g: int, ndim: int = 2) -> DIAMatrix:
    """``A_c = (1/2^ndim) Agg A Agg^T`` as a banded matrix (aggregation)."""
    grp = _group_index(g, ndim)
    rows, cols, vals = _dia_to_coo(mat)
    n_c = (g // 2) ** ndim
    bands: dict = {}
    _accumulate_bands(bands, grp[rows].astype(np.int64), grp[cols].astype(np.int64),
                      vals / float(2**ndim), n_c)
    return _bands_to_dia(bands, n_c)


def _bilinear_p(g: int, ndim: int = 2):
    """Cell-centred (bi/tri)linear prolongation P (g^ndim x gc^ndim) as
    ``(idx, w)``, each (g^ndim, 2^ndim): per fine cell the tensor product
    of 1-D weights (3/4 on the containing coarse cell, 1/4 on the nearest
    neighbour, 0 past the boundary)."""
    gc = g // 2
    f = np.arange(g)
    main = f // 2
    nb = np.where(f % 2 == 0, f // 2 - 1, f // 2 + 1)
    nb_ok = (nb >= 0) & (nb < gc)
    nb = np.clip(nb, 0, gc - 1)
    ax_idx = np.stack([main, nb], axis=1)  # (g, 2)
    ax_w = np.stack([np.full(g, 0.75), np.where(nb_ok, 0.25, 0.0)], axis=1)  # (g, 2)
    n_f = g**ndim
    coords = []
    rem = np.arange(n_f)
    for axis in range(ndim):
        coords.append(rem // (g ** (ndim - 1 - axis)))
        rem = rem % (g ** (ndim - 1 - axis))
    idx = np.zeros((n_f, 1), dtype=np.int64)
    w = np.ones((n_f, 1))
    for c in coords:
        idx = (idx[:, :, None] * gc + ax_idx[c][:, None, :]).reshape(n_f, -1)
        w = (w[:, :, None] * ax_w[c][:, None, :]).reshape(n_f, -1)
    return idx, w


def _galerkin_bilinear(mat: DIAMatrix, g: int, ndim: int = 2) -> DIAMatrix:
    """``A_c = P^T A P`` with the cell-centred (bi/tri)linear P. The
    stencil widens level by level (per-axis reach r -> (r + 3) // 2, so
    at most 25 bands in 2-D, 125 in 3-D) and stays banded."""
    pidx, pw = _bilinear_p(g, ndim)
    rows, cols, vals = _dia_to_coo(mat)
    n_c = (g // 2) ** ndim
    width = pidx.shape[1]
    bands: dict = {}
    for a in range(width):
        wa = pw[rows, a]
        ia = pidx[rows, a]
        for b_ in range(width):
            v = vals * wa * pw[cols, b_]
            keep = v != 0.0
            _accumulate_bands(bands, ia[keep], pidx[cols[keep], b_], v[keep], n_c)
    return _bands_to_dia(bands, n_c)


_GALERKIN_CACHE: dict = {}
_GALERKIN_CACHE_MAX_BYTES = 256 * 1024 * 1024  # bounds host memory, not entries


def _galerkin_cached(fn, mat: DIAMatrix, g: int, ndim: int) -> DIAMatrix:
    """Memoised Galerkin products, keyed by a blake2b hash of the bands:
    the host build is pure in (bands, offsets, g, ndim, transfer), and
    callers rebuild the same chain. Oldest entries go first past 256 MB."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(mat.bands).tobytes())
    key = (fn.__name__, g, ndim, tuple(mat.offsets), h.hexdigest())
    hit = _GALERKIN_CACHE.get(key)
    if hit is not None:
        return hit
    out = fn(mat, g, ndim)
    total = out.bands.nbytes
    for k in list(_GALERKIN_CACHE):
        if sum(v.bands.nbytes for v in _GALERKIN_CACHE.values()) + total \
                <= _GALERKIN_CACHE_MAX_BYTES:
            break
        _GALERKIN_CACHE.pop(k)
    if total <= _GALERKIN_CACHE_MAX_BYTES:
        _GALERKIN_CACHE[key] = out
    return out


# --- offsets on the grid --------------------------------------------------


def _decode_offsets(offsets, g: int, ndim: int, max_reach: int = 2):
    """Flat DIA offsets -> per-axis offsets with |d| <= max_reach per
    axis, or None if one does not decode."""
    out = []
    for o in offsets:
        o = int(o)
        coords = []
        rem = o
        for axis in range(ndim - 1, -1, -1):
            step = g**axis
            d = int(np.round(rem / step)) if axis > 0 else rem
            if abs(d) > max_reach:
                return None
            coords.append(d)
            rem -= d * step
        if rem != 0:
            return None
        out.append(tuple(reversed(coords)))
    return out


def _axis_reach(offsets, g: int, ndim: int) -> int:
    """The largest per-axis reach of the offsets on a g^ndim grid."""
    coords = _decode_offsets(offsets, g, ndim, max_reach=16)
    if coords is None:
        raise ValueError(f"offsets {offsets} do not decode on the {g}^{ndim} grid")
    return max((abs(d) for c in coords for d in c), default=1) or 1


def _coarse_reach(offsets, g: int, ndim: int, transfer: str) -> int:
    """The exact per-axis reach bound of ``R A P``: (r + 3) // 2 under the
    bilinear pair, (r + 1) // 2 under aggregation."""
    r = _axis_reach(offsets, g, ndim)
    return (r + 3) // 2 if transfer == "bilinear" else (r + 1) // 2


def _color_masks(g: int, ndim: int, offsets) -> Optional[List[np.ndarray]]:
    """Gauss-Seidel colour masks of a banded grid level: colour by the
    per-axis coordinate mod (R + 1), R the stencil's reach, so that no two
    cells of a colour are coupled; red-black where R = 1 and every
    off-diagonal offset flips the parity (the 5- and 7-point stencils).
    A list of {0, 1} float64 masks of length g^ndim, or None when the
    offsets do not decode."""
    coords = _decode_offsets(offsets, g, ndim)
    if coords is None:
        return None
    reach = max((max(abs(d) for d in c) for c in coords), default=1)
    grids = np.meshgrid(*(np.arange(g) for _ in range(ndim)), indexing="ij")
    if reach <= 1 and all(sum(c) % 2 == 1 for c in coords if any(c)):
        total = sum(grids) % 2
        return [(total == c).astype(np.float64).reshape(-1) for c in (0, 1)]
    q = reach + 1
    color = sum((grids[a] % q) * (q**a) for a in range(ndim))
    masks = [(color == c).astype(np.float64).reshape(-1) for c in range(q**ndim)]
    return [m for m in masks if m.any()]


# --- device Galerkin build by band probing --------------------------------
#
# A_c = R A P is banded with per-axis reach <= r_c, so the (2 r_c + 1)^ndim
# lattice-class indicator vectors recover every band exactly: each probe is
# one prolong -> banded mat-vec -> restrict on the fine grid, and two coarse
# columns of one class differ by >= 2 r_c + 1 along every axis, so at most
# one lies within reach of any row.


def galerkin_probe(bands: torch.Tensor, offsets, g: int, ndim: int = 2,
                   transfer: str = "bilinear"):
    """The Galerkin product on the bands' device, by band probing.

    Args:
      bands: (ndiag, g^ndim) DIA bands of the fine level.
      offsets: the fine level's DIA offsets.
      transfer: ``"bilinear"`` (``P^T A P``) or ``"aggregation"``
        (mean-pool . A . broadcast), the V-cycle's own pair.

    Returns ``(coarse_bands, coarse_offsets)``: (n_off, (g/2)^ndim) bands
    on the same device and dtype, all-zero candidates dropped. The probes
    run batched (in batches of ``PROBE_WORDS_BUDGET // n_fine`` when all
    of them would pass it), one gather extracts the candidates, and one
    small product at full float32 merges offsets that alias on a small
    grid. Only the candidates' nonzero flags come to the host.
    """
    offsets = tuple(int(o) for o in offsets)
    run, flat_offsets = _probe_builder(offsets, int(g), int(ndim), transfer, bands.dtype)
    cand, nz = run(bands)
    nz = nz.cpu().numpy()
    keep = [i for i in range(len(flat_offsets)) if nz[i]]
    coarse_offsets = tuple(int(flat_offsets[i]) for i in keep)
    return cand[torch.as_tensor(keep, dtype=torch.int64, device=bands.device)], coarse_offsets


def _grid_coords(n_c: int, gc: int, ndim: int, dev) -> torch.Tensor:
    """(ndim, n_c) coarse coordinates of the flat coarse indices."""
    rem = torch.arange(n_c, device=dev)
    coords = []
    for a in range(ndim):
        step = gc ** (ndim - 1 - a)
        coords.append(rem // step)
        rem = rem % step
    return torch.stack(coords)


@functools.lru_cache(maxsize=64)
def _probe_builder(offsets, g, ndim, transfer, dtype):
    """The probe program of one (offsets, g, ndim, transfer, dtype) and its
    static candidate offsets, cached as cgx caches its jitted builder: the
    lattice classes, the candidate deltas and the alias-merge matrix."""
    gc = g // 2
    n_c = gc**ndim
    rc = _coarse_reach(offsets, g, ndim, transfer)
    q = 2 * rc + 1
    if transfer == "bilinear":
        prolong = lambda v: MGPreconditioner._prolong_bilinear(v, gc, ndim)  # noqa: E731
        restrict = lambda y: MGPreconditioner._restrict_bilinear(y, g, ndim)  # noqa: E731
    elif transfer == "aggregation":
        prolong = lambda v: MGPreconditioner._prolong(v, gc, ndim)  # noqa: E731
        restrict = lambda y: MGPreconditioner._restrict(y, g, ndim)  # noqa: E731
    else:
        raise ValueError(f"unknown transfer {transfer!r}")

    classes = np.array(list(itertools.product(range(q), repeat=ndim)), np.int64)
    deltas = np.array(list(itertools.product(range(-rc, rc + 1), repeat=ndim)), np.int64)
    # distinct per-axis deltas alias to one flat offset on a small coarse
    # grid (gc = 4: (-1, -2) and (-2, 2) are both -6); the flat band is
    # their sum, as the host build accumulates it
    flat_of_delta = deltas @ np.array([gc ** (ndim - 1 - a) for a in range(ndim)], np.int64)
    flat_offsets = sorted(set(int(x) for x in flat_of_delta))
    merge_np = np.zeros((len(flat_offsets), len(deltas)))
    for j, f in enumerate(flat_of_delta):
        merge_np[flat_offsets.index(int(f)), j] = 1.0

    def run(bands: torch.Tensor):
        dev = bands.device
        coords = _grid_coords(n_c, gc, ndim, dev)
        match = coords[None, :, :] % q == torch.as_tensor(classes, device=dev)[:, :, None]
        probes = match.all(dim=1).to(dtype)  # (n_classes, n_c)
        del match

        def apply(v):
            return restrict(dia_matvec_ref(bands, prolong(v), offsets=offsets))

        n_fine = (2**ndim) * n_c
        if probes.shape[0] * n_fine > PROBE_WORDS_BUDGET:  # read at each call
            bs = max(1, PROBE_WORDS_BUDGET // n_fine)
            y = torch.cat([apply(probes[i:i + bs]) for i in range(0, probes.shape[0], bs)])
        else:
            y = apply(probes)  # (n_classes, n_c)
        del probes
        # the flat class of column x + d for every candidate d and position x
        delta_t = torch.as_tensor(deltas, device=dev)
        cls = torch.zeros((len(deltas), n_c), dtype=torch.int64, device=dev)
        for a in range(ndim):
            cls = cls * q + (coords[a][None, :] + delta_t[:, a:a + 1]) % q
        cand = torch.gather(y, 0, cls)  # cand[k, i] = y[cls[k, i], i]
        del y, cls
        with f32_exact():
            merged = torch.matmul(torch.as_tensor(merge_np, dtype=dtype, device=dev), cand)
        return merged, (merged != 0).any(dim=1)

    return run, flat_offsets


def _galerkin_bilinear_dev(mat: DIAMatrix, g: int, ndim: int = 2, *,
                           device="cuda") -> DIAMatrix:
    """:func:`galerkin_probe` (bilinear) from and to a host matrix; equal
    to :func:`_galerkin_bilinear` up to rounding."""
    return _probe_host(mat, g, ndim, "bilinear", device)


def _galerkin_dia_dev(mat: DIAMatrix, g: int, ndim: int = 2, *, device="cuda") -> DIAMatrix:
    """:func:`galerkin_probe` (aggregation) from and to a host matrix."""
    return _probe_host(mat, g, ndim, "aggregation", device)


def _probe_host(mat: DIAMatrix, g: int, ndim: int, transfer: str, device) -> DIAMatrix:
    bands = torch.tensor(mat.bands, dtype=torch.float64, device=resolve_device(device))
    out, offs = galerkin_probe(bands, mat.offsets, g, ndim, transfer)
    n_c = (g // 2) ** ndim
    return DIAMatrix((n_c, n_c), offs, _np64(out))


# --- the preconditioner ----------------------------------------------------


class MGPreconditioner:
    """Symmetric V-cycle (or W-cycle) preconditioner ``z = M^-1 r`` over a
    banded operator on a g^ndim grid; ``apply`` and ``apply_mixed`` are
    usable as ``cg_solve(..., precond=...)``.

    Arguments and defaults are cgx's. ``galerkin_setup="auto"`` builds the
    hierarchy on the device when the operator is on CUDA and N >= 2^18
    (cgx: on an accelerator), else on the host. ``dtype`` is the cycle's
    arithmetic (default the operator's); under a wider operator the
    cycle keeps its own copy of the fine bands in ``dtype``, and the
    hierarchy is built in the operator's precision and then cast.
    """

    def __init__(
        self,
        fine: DiaOperator,
        g: int,
        *,
        ndim: int = 2,
        min_coarse_grid: Optional[int] = None,
        pre_smooth: int = 2,
        post_smooth: int = 2,
        omega: float = 0.8,
        overcorrection: Optional[float] = None,
        transfer: str = "bilinear",
        smoother: str = "richardson",
        dtype=None,
        galerkin_setup: str = "auto",
        cycle: str = "v",
    ):
        if transfer not in ("bilinear", "aggregation"):
            raise ValueError(f"unknown transfer {transfer!r}")
        self.transfer = transfer
        if smoother not in ("richardson", "gs"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        # the W-cycle's iterated correction M_c(2I - A_c M_c) stays SPD; an
        # F-cycle's two coarse visits use different operators (asymmetric)
        if cycle not in ("v", "w"):
            raise ValueError(f"unknown cycle {cycle!r} ('v' or 'w'; F-cycles are "
                             "asymmetric and unusable as CG preconditioners)")
        self.cycle = cycle
        if overcorrection is None:
            overcorrection = 1.8 if transfer == "aggregation" else 1.0
        if g**ndim != fine.shape[0]:
            raise ValueError(f"operator size {fine.shape[0]} is not a {g}^{ndim} grid")
        self.ndim = int(ndim)
        if min_coarse_grid is None:
            # the coarsest dense solve stays small (<= ~4096 unknowns)
            min_coarse_grid = max(4, min(32 if ndim == 2 else 8, g // 2))
        if pre_smooth < 1 or post_smooth < 1:
            raise ValueError("pre_smooth/post_smooth must be >= 1: the symmetric smoothing "
                             "pair is what makes the V-cycle SPD")
        self.g = g
        self.pre = int(pre_smooth)
        self.post = int(post_smooth)
        dtype = dtype or fine.dtype
        self.dtype = dtype
        dev = fine.bands.device
        self.device = dev
        build_bands = fine.bands  # the hierarchy builds in the operator's precision
        build_offsets = tuple(int(o) for o in fine.offsets)
        if fine.dtype != dtype:
            # the cycle's own copy of the fine bands, so that the fine level's
            # smoothing runs in the cycle's dtype (cgx multigrid.py:568-579)
            fine = DiaOperator(fine.bands.to(dtype), build_offsets)
        self.fine = fine

        if galerkin_setup not in ("auto", "host", "device"):
            raise ValueError(f"unknown galerkin_setup {galerkin_setup!r}")
        if galerkin_setup == "auto":
            use_device = dev.type == "cuda" and fine.shape[0] >= 1 << 18
        else:
            use_device = galerkin_setup == "device"
        self.galerkin_setup = "device" if use_device else "host"

        self.grids: List[int] = [g]
        # levels[k] = (bands, offsets) of coarse level k + 1: tensors in the
        # build dtype on the device path, float64 NumPy on the host path
        levels: List = []
        cur_g = g
        if use_device:
            cur, offs = build_bands, build_offsets
            while cur_g % 2 == 0 and cur_g // 2 >= min_coarse_grid:
                cur, offs = galerkin_probe(cur, offs, cur_g, ndim, transfer)
                cur_g //= 2
                self.grids.append(cur_g)
                levels.append((cur, offs))
        else:
            galerkin = _galerkin_bilinear if transfer == "bilinear" else _galerkin_dia
            cur = DIAMatrix(fine.shape, build_offsets, _np64(build_bands))
            while cur_g % 2 == 0 and cur_g // 2 >= min_coarse_grid:
                cur = _galerkin_cached(galerkin, cur, cur_g, ndim)
                cur_g //= 2
                self.grids.append(cur_g)
                levels.append((cur.bands, tuple(cur.offsets)))
        if not levels:
            raise ValueError(f"grid {g} cannot be coarsened (need even g with "
                             f"g/2 >= {min_coarse_grid})")
        cb, co = levels[-1]
        n_last = cb.shape[1]
        coarsest = DIAMatrix((n_last, n_last), co, _np64(cb))  # a small download

        self.omega = float(omega)
        self.overcorrection = float(overcorrection)

        def on_device(a) -> torch.Tensor:
            if isinstance(a, torch.Tensor):
                return a.to(dtype).contiguous()
            return torch.tensor(a, dtype=dtype, device=dev)

        def damp_of(bands, offsets) -> torch.Tensor:
            top = bands[offsets.index(0)].max()
            return torch.tensor(self.omega / float(top), dtype=dtype, device=dev)

        self.fine_damp = damp_of(build_bands, build_offsets)
        self.coarse_ops = [DiaOperator(on_device(b), offs) for b, offs in levels[:-1]]
        self.coarse_damp = [damp_of(b, offs) for b, offs in levels[:-1]]

        # Gauss-Seidel: per smoothing level the stacked colour masks and
        # the pointwise inverse diagonal (taken in the build precision)
        self.colors: Optional[List[torch.Tensor]] = None
        self.dinv: Optional[List[torch.Tensor]] = None
        if smoother == "gs":
            self.colors, self.dinv = [], []
            for lvl, (b, offs) in enumerate([(build_bands, build_offsets)] + levels[:-1]):
                masks = _color_masks(self.grids[lvl], ndim, offs)
                if masks is None:
                    raise ValueError(
                        "smoother='gs' needs grid-stencil levels "
                        f"(level {lvl} offsets {offs} do not decode on the "
                        f"{self.grids[lvl]}^{ndim} grid)")
                self.dinv.append(on_device(1.0 / b[offs.index(0)]))
                self.colors.append(torch.tensor(np.stack(masks), dtype=dtype, device=dev))

        self.coarsest_inv: Optional[torch.Tensor] = None
        self.coarsest_cheb = None
        if coarsest.shape[0] <= 4096:
            self.coarsest_inv = torch.tensor(np.linalg.inv(coarsest.to_dense()), dtype=dtype,
                                             device=dev)
        else:
            # an odd grid can stop coarsening while still large (1000 -> 500
            # -> 250 -> 125): a fixed-degree Chebyshev solve, a linear
            # symmetric map, keeps the cycle SPD
            lo, hi = host_spectral_bounds(coarsest)
            self.coarsest_cheb = chebyshev_banded(
                torch.tensor(coarsest.bands, dtype=dtype, device=dev), coarsest.offsets,
                max(lo, 1e-12), hi, degree=_CHEB_DEGREE)

    # --- grid transfers: the last dimension is the grid, any before it a batch

    @staticmethod
    def _restrict(r: torch.Tensor, g: int, ndim: int = 2) -> torch.Tensor:
        gc = g // 2
        lead = tuple(r.shape[:-1])
        shape = lead + sum(((gc, 2) for _ in range(ndim)), ())
        axes = tuple(len(lead) + 2 * i + 1 for i in range(ndim))
        return r.reshape(shape).mean(dim=axes).reshape(lead + (-1,))

    @staticmethod
    def _prolong(e: torch.Tensor, gc: int, ndim: int = 2) -> torch.Tensor:
        # P = Agg^T: each coarse value broadcast to its 2^ndim cell
        lead = tuple(e.shape[:-1])
        a = e.reshape(lead + (gc,) * ndim)
        for axis in range(ndim):
            a = torch.repeat_interleave(a, 2, dim=len(lead) + axis)
        return a.reshape(lead + (-1,))

    # tensor-product 1-D linear resampling per axis: fine 2i gets .75 c_i +
    # .25 c_{i-1}, fine 2i+1 gets .75 c_i + .25 c_{i+1}, zero past the
    # boundary; the pair below are exact adjoints

    @staticmethod
    def _up_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
        a = a.movedim(axis, 0)
        zero = torch.zeros_like(a[:1])
        am1 = torch.cat([zero, a[:-1]])
        ap1 = torch.cat([a[1:], zero])
        r0 = 0.75 * a + 0.25 * am1
        r1 = 0.75 * a + 0.25 * ap1
        out = torch.stack([r0, r1], dim=1).reshape((2 * a.shape[0],) + tuple(a.shape[1:]))
        return out.movedim(0, axis)

    @staticmethod
    def _down_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
        a = a.movedim(axis, 0)
        f0 = a[0::2]
        f1 = a[1::2]
        zero = torch.zeros_like(f0[:1])
        f1m = torch.cat([zero, f1[:-1]])
        f0p = torch.cat([f0[1:], zero])
        out = 0.75 * (f0 + f1) + 0.25 * (f1m + f0p)
        return out.movedim(0, axis)

    @staticmethod
    def _prolong_bilinear(e: torch.Tensor, gc: int, ndim: int = 2) -> torch.Tensor:
        lead = tuple(e.shape[:-1])
        a = e.reshape(lead + (gc,) * ndim)
        for axis in range(ndim):
            a = MGPreconditioner._up_axis(a, len(lead) + axis)
        return a.reshape(lead + (-1,))

    @staticmethod
    def _restrict_bilinear(r: torch.Tensor, g: int, ndim: int = 2) -> torch.Tensor:
        lead = tuple(r.shape[:-1])
        a = r.reshape(lead + (g,) * ndim)
        for axis in range(ndim):
            a = MGPreconditioner._down_axis(a, len(lead) + axis)
        return a.reshape(lead + (-1,))

    # --- the cycle -------------------------------------------------------------

    @property
    def levels(self) -> int:
        """Smoothing levels; the coarsest solve sits below them."""
        return 1 + len(self.coarse_ops)

    def _matvec(self, level: int, v: torch.Tensor) -> torch.Tensor:
        op = self.fine if level == 0 else self.coarse_ops[level - 1]
        return dia_matvec_ref(op.bands, v, offsets=op.offsets)

    def _damp(self, level: int) -> torch.Tensor:
        return self.fine_damp if level == 0 else self.coarse_damp[level - 1]

    def _coarsest(self, r: torch.Tensor) -> torch.Tensor:
        if self.coarsest_inv is not None:
            with f32_exact():
                if r.dim() > 1:  # a batch of residuals, one a row
                    return torch.matmul(r, self.coarsest_inv.mT)
                return torch.matmul(self.coarsest_inv, r)
        return self.coarsest_cheb(r)

    def _vcycle(self, level: int, r: torch.Tensor) -> torch.Tensor:
        if level == self.levels:
            return self._coarsest(r)
        g = self.grids[level]
        if self.smoother == "gs":
            # the first colour's update from z = 0 needs no mat-vec
            z = self.colors[level][0] * self.dinv[level] * r
            z = self._gs_sweep(level, z, r, start=1)
            for _ in range(self.pre - 1):
                z = self._gs_sweep(level, z, r)
        else:
            damp = self._damp(level)
            z = damp * r  # the first Richardson sweep from z = 0
            for _ in range(self.pre - 1):
                z = z + damp * (r - self._matvec(level, z))
        resid = r - self._matvec(level, z)
        if self.transfer == "bilinear":
            r_c = self._restrict_bilinear(resid, g, self.ndim)
        else:
            r_c = self._restrict(resid, g, self.ndim)
        e_c = self._vcycle(level + 1, r_c)
        if self.cycle == "w" and level + 1 < self.levels:
            # the second, symmetric correction M_c(2I - A_c M_c) r_c; the
            # coarsest solve needs none
            e_c = e_c + self._vcycle(level + 1, r_c - self._matvec(level + 1, e_c))
        if self.transfer == "bilinear":
            corr = self._prolong_bilinear(e_c, g // 2, self.ndim)
        else:
            corr = self._prolong(e_c, g // 2, self.ndim)
        z = z + self.overcorrection * corr
        if self.smoother == "gs":
            for _ in range(self.post):  # the adjoint sweep keeps the cycle symmetric
                z = self._gs_sweep(level, z, r, reverse=True)
        else:
            for _ in range(self.post):
                z = z + damp * (r - self._matvec(level, z))
        return z

    def _gs_sweep(self, level: int, z, r, *, start: int = 0, reverse: bool = False):
        """One multicolour Gauss-Seidel sweep: per colour, a masked
        pointwise-Jacobi step from the freshest z."""
        colors, dinv = self.colors[level], self.dinv[level]
        nc = colors.shape[0]
        for i in range(start, nc):
            mask = colors[nc - 1 - i] if reverse else colors[i]
            z = z + mask * dinv * (r - self._matvec(level, z))
        return z

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """``z = M^-1 r``: one symmetric cycle from a zero guess. ``r`` may
        carry leading batch dimensions (the columns of a block solve), each
        row cycled as a single vector is."""
        return self._vcycle(0, r)

    def apply_mixed(self, r: torch.Tensor) -> torch.Tensor:
        """``z = M^-1 r`` with the cycle run in the preconditioner's dtype
        and the result cast back to r's (an fp32 cycle inside fp64 CG)."""
        return self._vcycle(0, r.to(self.dtype)).to(r.dtype)


def infer_grid_ndim(n: int, offsets) -> int:
    """The grid dimension of a banded operator: the one whose side g
    (g^ndim = N) puts the widest offset nearest g^(ndim-1) (2-D 5-point:
    +-g; 3-D 7-point: +-g^2); 2 when none fits."""
    maxoff = max((abs(int(o)) for o in offsets), default=1) or 1
    best, best_score = 2, None
    for ndim in (2, 3):
        g = int(round(n ** (1.0 / ndim)))
        if g < 2 or g**ndim != n:
            continue
        score = abs(maxoff - g ** (ndim - 1))
        if best_score is None or score < best_score:
            best, best_score = ndim, score
    return best


def mg_preconditioner(mat, g: Optional[int] = None, *, ndim: int = 2, device=None,
                      **kwargs) -> MGPreconditioner:
    """A V-cycle preconditioner for a grid Laplacian.

    Args:
      mat: a host :class:`~cgx_torch.mats.containers.DIAMatrix` (copied to
        ``device`` in float64, ``"cuda"`` unless asked) or a
        :class:`~cgx_torch.solver.operators.DiaOperator` (on its own
        device; ``device``, if given, must be it).
      g: the grid side; N^(1/ndim) when omitted.
      ndim: 2 for ``lap2d_fd``, 3 for ``lap3d_fd``.
      kwargs: :class:`MGPreconditioner`'s.
    """
    if isinstance(mat, DIAMatrix):
        op = DiaOperator(torch.tensor(mat.bands, dtype=torch.float64,
                                      device=resolve_device(device or "cuda")),
                         tuple(int(o) for o in mat.offsets))
    else:
        op = mat
        if device is not None:
            check_device(op.bands, resolve_device(device), "the operator's bands")
    if g is None:
        g = int(round(op.shape[0] ** (1.0 / ndim)))
    return MGPreconditioner(op, g, ndim=ndim, **kwargs)

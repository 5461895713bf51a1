"""Fused streaming s-step CG: CUDA kernels B10 and the replay kernel, and
their plain versions (counterpart of ``cgx/ops/sstep_stream.py``).

A block of s iterations is two launches that each stream the bands, p
and r once and regenerate the Krylov basis on chip
(``cgx_torch/csrc/sstep_stream.cu`` and ``sstep_recover.cu``, whose
header notes give the bound and the designs; both launches of a block
run the design of :func:`cgx_torch.ops.dia_powers.basis_plan`, recorded
in ``.design`` and ``.plan``):

- :func:`_sstep_gram` (site ``sstep_stream.py:395``): the Gram matrix
  ``G = V V^T`` in float64, then, in the launch's last block, the replay
  of the s iterations in float64 (:func:`cgx_torch.solver.sstep.
  replay_block`), which writes the recovery coefficients and the
  scalars to a packed float64 state on the device;
- :func:`_sstep_recover` (site ``sstep_stream.py:466``):
  ``x += (sum xc_i V_i)`` in place, ``r = sum d_i V_i`` and
  ``p = sum c_i V_i`` into the other half of their ping-pong pairs;
- :func:`sstep_replay`: the replay alone, one block, on a Gram matrix
  the caller put in the state (the matrix-powers route,
  :mod:`cgx_torch.solver.sstep`, and the sharded route).

The halo mode (the sharded route, :mod:`cgx_torch.parallel.sstep_fused`):
``window=(lo, hi)`` makes both launches cover only the rows ``[lo, hi)``
of vectors and bands that hold a shard's own rows there and its
neighbours' rows around them. The generator reads every row, the Gram
sums and the recover writes only the window's. ``part=True`` makes the
Gram launch store the shard's G and mark the block live without the
replay, so that the caller sums the shards' G over the mesh and replays
after (:func:`sstep_replay` with ``live_only=True``).

The state (float64, ``STATE_LEN``) holds ``[k, rsold, rsnew, conv, brk,
blk, live]``, the coefficients ``[xc, d, c]`` from ``COEF`` and G from
``GRAM``. A Gram launch that finds the solve stopped (converged, broken
down or at maxiter) does nothing and leaves ``live`` 0; a recover
launch runs only after a live Gram launch, and advances ``blk``, whose
parity picks the pairs' current half. So the host queues blocks freely
and reads the stop flag once per ``_BLOCKS`` blocks.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version beside it, which reads the state on the
host. Each counts its calls in ``.launches``, the two launches also by
build in ``cgx_torch.ops._util.BUILD_LAUNCHES``.
:func:`dia_sstep_stream_solve` keeps cgx's signature; ``rows`` and
``cols`` were TPU tiling (validated as cgx validates them, otherwise
unused: cgx's auto-grow of ``rows`` guarded an in-place hazard the
ping-pong pairs do not have). float64 runs too, which cgx's TPU kernels
refuse. bfloat16 vectors (with bfloat16 bands) run on the ``_bf16``
builds, each basis operation and each recovery product and sum rounded
to bfloat16 as the plain versions' bfloat16 tensors round them, the Gram
and the replay in float64 as on every build; float32 vectors stream
bfloat16 or float16 bands.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import (
    count_build,
    entry_suffix,
    launch,
    pow2_rhs_scale,
    resolve_device,
    vector_dtypes,
)
from cgx_torch.ops.cg_stream import _resolve_bands_dtype
from cgx_torch.ops.dia_powers import (
    MAX_S,
    BasisPlan,
    _check_layout,
    basis_plan,
    check_basis,
    dia_sstep_basis_ref,
    shifts_arg,
    slab_scratch,
    sms_of,
)
from cgx_torch.ops.dia_spmv import _offsets_arg, dia_matvec_ref
from cgx_torch.solver.cg import CGResult, as_vector
from cgx_torch.solver.operators import DiaOperator
from cgx_torch.solver.sstep import _BLOCKS, _basis_matrix, newton_shifts, replay_block

# each launch's C entries, one a design (both built for bfloat16 vectors too)
_GRAM = ("cgx_sstep_gram", "cgx_sstep_gram_wave")
_RECOVER = ("cgx_sstep_recover", "cgx_sstep_recover_wave")
# the packed float64 state (csrc/sstep_basis.cuh, enum State)
K, RSOLD, RSNEW, CONV, BRK, BLK, LIVE = range(7)
MAX_M = 2 * MAX_S + 1
COEF = 8
GRAM = COEF + 3 * MAX_M
STATE_LEN = GRAM + MAX_M * MAX_M


class Workspace(NamedTuple):
    """Scratch of the two launches on N rows: their plan (one design for
    both, :func:`cgx_torch.ops.dia_powers.basis_plan`), the slab design's
    block-private basis levels (empty for the wavefront), the Gram
    partials and the ticket (zero between launches; the kernels reset
    it)."""

    plan: BasisPlan
    scratch: torch.Tensor
    partials: torch.Tensor
    ticket: torch.Tensor


def workspace_values(plan: BasisPlan, offsets, s: int) -> Tuple[int, int]:
    """Values of a workspace of ``plan``: the scratch (the slab design
    keeps each block's slab of all m levels after its two working
    levels; the wavefront none) and the float64 Gram partials."""
    m = 2 * int(s) + 1
    return slab_scratch(plan, offsets, s, keep=m), plan.grid * m * (m + 1) // 2


def workspace(device, n: int, offsets, s: int, dtype: torch.dtype,
              plan: Optional[BasisPlan] = None) -> Workspace:
    """The workspace of :func:`basis_plan`'s design, or of ``plan``
    (``slab_plan(...)`` forces the slab design on the card)."""
    if plan is None:
        plan = basis_plan(n, tuple(int(o) for o in offsets), int(s), dtype, sms_of(device))
    scratch, partials = workspace_values(plan, offsets, s)
    return Workspace(plan, torch.empty(scratch, dtype=dtype, device=device),
                     torch.empty(partials, dtype=torch.float64, device=device),
                     torch.zeros(1, dtype=torch.int32, device=device))


def _stopped(h, maxiter: int) -> bool:
    return h[CONV] != 0.0 or h[BRK] != 0.0 or not h[K] < maxiter


def _replay_ref(state, bmat, *, s: int, tol: float, nearzero: float, maxiter: int) -> None:
    """Plain version of the replay: replay_block in float64 on the state's G."""
    m = 2 * s + 1
    dev = state.device
    g = state[GRAM:GRAM + m * m].view(m, m)
    xc, d, c, k, rs, rsnew, conv, brk = replay_block(
        g, bmat, s, state[K].to(torch.int32), state[RSNEW], state[CONV] != 0, state[BRK] != 0,
        tol=torch.tensor(tol, dtype=torch.float64, device=dev),
        nearzero=torch.tensor(nearzero, dtype=torch.float64, device=dev), maxiter=maxiter)
    state[COEF:COEF + 3 * m] = torch.cat([xc, d, c])
    state[K:BRK + 1] = torch.stack([k.to(torch.float64), rs, rsnew, conv.to(torch.float64),
                                    brk.to(torch.float64)])


def _window(window, n: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` a launch covers: all n, or the halo mode's window."""
    lo, hi = (0, n) if window is None else (int(window[0]), int(window[1]))
    if not 0 <= lo < hi <= n:
        raise ValueError(f"window [{lo}, {hi}) is not a non-empty range of the {n} rows")
    return lo, hi


def _gram_ref(bands, p, r, state, bmat, *, offsets, s, theta, delta, shifts, tol, nearzero,
              maxiter, window=None, part: bool = False) -> None:
    """Plain version of the Gram launch: the basis of the current halves,
    G = V V^T over the window's rows with the products in float64, the
    replay (none with ``part``), the live mark. A stopped solve changes
    nothing, but ``part`` zeroes G."""
    h = state[:COEF].tolist()
    m = 2 * s + 1
    if _stopped(h, maxiter):
        if part:
            state[GRAM:GRAM + m * m] = 0.0
        return
    lo, hi = _window(window, p.shape[1])
    q = int(h[BLK]) & 1
    v = dia_sstep_basis_ref(bands, p[q], r[q], offsets=offsets, s=s, theta=theta, delta=delta,
                            shifts=shifts)[:, lo:hi].to(torch.float64)
    state[GRAM:GRAM + m * m] = (v @ v.T).reshape(-1)
    if not part:
        _replay_ref(state, bmat, s=s, tol=tol, nearzero=nearzero, maxiter=maxiter)
    state[LIVE] = 1.0


def _recover_ref(bands, p, r, x, state, *, offsets, s, theta, delta, shifts,
                 window=None) -> None:
    """Plain version of the recover launch: the coefficient combinations
    in level order, the coefficients rounded to the vectors' dtype, and
    x plus its whole increment (cgx's loop; its kernel adds term by term),
    on the window's rows."""
    h = state[:COEF].tolist()
    if h[LIVE] == 0.0:
        return
    lo, hi = _window(window, p.shape[1])
    q = int(h[BLK]) & 1
    v = dia_sstep_basis_ref(bands, p[q], r[q], offsets=offsets, s=s, theta=theta, delta=delta,
                            shifts=shifts)[:, lo:hi]
    m = 2 * s + 1
    coef = state[COEF:COEF + 3 * m].view(3, m).to(x.dtype)
    xa, ra, pa = (torch.zeros_like(v[0]) for _ in range(3))
    for i in range(m):
        xa = xa + coef[0, i] * v[i]
        ra = ra + coef[1, i] * v[i]
        pa = pa + coef[2, i] * v[i]
    x[lo:hi].copy_(x[lo:hi] + xa)
    r[1 - q, lo:hi].copy_(ra)
    p[1 - q, lo:hi].copy_(pa)
    state[BLK] += 1.0
    state[LIVE] = 0.0


def _check_state(fn: str, state, bmat, s: int, dev) -> None:
    if not (isinstance(state, torch.Tensor) and state.shape == (STATE_LEN,)
            and state.dtype == torch.float64 and state.device == dev and state.is_contiguous()):
        raise ValueError(f"{fn}: state must be a contiguous float64 ({STATE_LEN},) tensor on "
                         f"{dev}")
    m = 2 * int(s) + 1
    if bmat is not None and not (isinstance(bmat, torch.Tensor) and bmat.shape == (m, m)
                                 and bmat.dtype == torch.float64 and bmat.device == dev
                                 and bmat.is_contiguous()):
        raise ValueError(f"{fn}: bmat must be a contiguous float64 ({m}, {m}) tensor on {dev}")


def _check_block(fn: str, bands, p, r, x, state, bmat, offsets, s, shifts,
                 entries) -> Tuple[int, ...]:
    """Validate one launch's operands before any pointer reaches C, for
    the vectors and bands its C ``entries`` are built for."""
    for name, t in (("p", p), ("r", r)):
        if not (isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[0] == 2
                and t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous (2, N) ping-pong pair")
    vectors = {"p0": p[0], "p1": p[1], "r0": r[0], "r1": r[1]}
    if x is not None:
        vectors["x"] = x
    offsets = check_basis(fn, bands, vectors, offsets, s, shifts, entries)
    _check_state(fn, state, bmat, s, p.device)
    return offsets


def _suffix(bands, like) -> str:
    return entry_suffix(like.dtype, bands.dtype)


def _sstep_gram(bands, p, r, state, bmat, *, offsets: Sequence[int], s: int, theta: float,
                delta: float, shifts: Tuple[float, ...] = (), tol: float, nearzero: float,
                maxiter: int, work: Optional[Workspace] = None, window=None,
                part: bool = False) -> None:
    """The Gram launch of one s-step block (kernel B10) and its replay;
    in the halo mode over ``window``, and with ``part`` the Gram only.
    ``work`` is a workspace for the window's rows."""
    offsets = _check_block("_sstep_gram", bands, p, r, None, state, bmat, offsets, s, shifts,
                           _GRAM)
    s = int(s)
    kw = dict(offsets=offsets, s=s, theta=theta, delta=delta, shifts=tuple(shifts))
    lo, hi = _window(window, p.shape[1])
    if p.device.type == "cpu":
        _gram_ref(bands, p, r, state, bmat, tol=tol, nearzero=nearzero, maxiter=maxiter,
                  window=window, part=part, **kw)
    else:
        n = p.shape[1]
        work = workspace(p.device, hi - lo, offsets, s, p.dtype) if work is None else work
        plan = work.plan
        sh, nsh = shifts_arg(shifts)
        head = (bands.data_ptr(), p[0].data_ptr(), p[1].data_ptr(), r[0].data_ptr(),
                r[1].data_ptr(), state.data_ptr(), bmat.data_ptr())
        basis = (_offsets_arg(offsets), len(offsets), s, float(theta), float(delta), sh, nsh,
                 float(tol), float(nearzero), float(maxiter))
        if plan.design == "wavefront":
            launch("cgx_sstep_gram_wave", p, *head, work.partials.data_ptr(),
                   work.partials.numel(), work.ticket.data_ptr(), n, *basis, *plan.as_arg(),
                   plan.grid, lo, hi, int(part), suffix=_suffix(bands, p))
        else:
            launch("cgx_sstep_gram", p, *head, work.scratch.data_ptr(), work.scratch.numel(),
                   work.partials.data_ptr(), work.partials.numel(), work.ticket.data_ptr(), n,
                   *basis, plan.slab, plan.grid, lo, hi, int(part), suffix=_suffix(bands, p))
        _sstep_gram.grid = plan.grid
        _sstep_gram.design = plan.design
        _sstep_gram.plan = plan
    _sstep_gram.launches += 1
    count_build("sstep_gram", p.dtype, bands.dtype)
    _sstep_gram.bands_dtype = bands.dtype


def _sstep_recover(bands, p, r, x, state, *, offsets: Sequence[int], s: int, theta: float,
                   delta: float, shifts: Tuple[float, ...] = (),
                   work: Optional[Workspace] = None, window=None) -> None:
    """The recover launch of one s-step block (kernel B10); in the halo
    mode over ``window``."""
    offsets = _check_block("_sstep_recover", bands, p, r, x, state, None, offsets, s, shifts,
                           _RECOVER)
    s = int(s)
    kw = dict(offsets=offsets, s=s, theta=theta, delta=delta, shifts=tuple(shifts))
    lo, hi = _window(window, p.shape[1])
    if p.device.type == "cpu":
        _recover_ref(bands, p, r, x, state, window=window, **kw)
    else:
        n = p.shape[1]
        work = workspace(p.device, hi - lo, offsets, s, p.dtype) if work is None else work
        plan = work.plan
        sh, nsh = shifts_arg(shifts)
        head = (bands.data_ptr(), p[0].data_ptr(), p[1].data_ptr(), r[0].data_ptr(),
                r[1].data_ptr(), x.data_ptr(), state.data_ptr())
        basis = (_offsets_arg(offsets), len(offsets), s, float(theta), float(delta), sh, nsh)
        if plan.design == "wavefront":
            launch("cgx_sstep_recover_wave", p, *head, work.ticket.data_ptr(), n, *basis,
                   *plan.as_arg(), plan.grid, lo, hi, suffix=_suffix(bands, p))
        else:
            launch("cgx_sstep_recover", p, *head, work.scratch.data_ptr(), work.scratch.numel(),
                   work.ticket.data_ptr(), n, *basis, plan.slab, plan.grid, lo, hi,
                   suffix=_suffix(bands, p))
        _sstep_recover.grid = plan.grid
        _sstep_recover.design = plan.design
        _sstep_recover.plan = plan
    _sstep_recover.launches += 1
    count_build("sstep_recover", p.dtype, bands.dtype)


def sstep_replay(state, bmat, *, s: int, tol: float, nearzero: float, maxiter: int,
                 live_only: bool = False) -> None:
    """Replay s iterations from the Gram matrix in ``state[GRAM:]``: one
    block of the replay kernel, or its plain version on the CPU. With
    ``live_only`` only after a live Gram-only launch (the sharded route)."""
    _check_state("sstep_replay", state, bmat, s, state.device)
    if not 1 <= int(s) <= MAX_S:
        raise ValueError(f"sstep_replay: s must be in 1..{MAX_S}, got {s}")
    if state.device.type == "cpu":
        if not live_only or state[LIVE].item() != 0.0:
            _replay_ref(state, bmat, s=int(s), tol=tol, nearzero=nearzero, maxiter=maxiter)
    else:
        launch("cgx_sstep_replay", state, state.data_ptr(), bmat.data_ptr(), int(s), float(tol),
               float(nearzero), float(maxiter), int(live_only))
    sstep_replay.launches += 1


for _fn in (_sstep_gram, _sstep_recover, sstep_replay):
    _fn.launches = 0
    _fn.grid = None  # blocks of the last CUDA launch
_sstep_gram.bands_dtype = None  # the band storage of the last call
for _fn in (_sstep_gram, _sstep_recover):
    _fn.design = None  # basis_plan's design of the last CUDA launch, and the plan
    _fn.plan = None


class BlockState(NamedTuple):
    """What the launches advance: x in place, the p and r pairs, the
    packed state; and the operator matrix B of the replay."""

    x: torch.Tensor
    p: torch.Tensor
    r: torch.Tensor
    state: torch.Tensor
    bmat: torch.Tensor


def initial_state(bands, b, x0, tol: float, *, offsets, s: int, theta: float, delta: float,
                  shifts=()) -> BlockState:
    """cgx's set-up (sstep_stream.py:707-713): r0 = b - A x0 through the
    plain mat-vec on ``bands`` (in b's dtype), <r0, r0> in float64,
    p0 = r0, and the stop flag if ``sqrt(<r0, r0>) < tol`` or it is 0."""
    n = b.shape[0]
    r0 = b - dia_matvec_ref(bands, x0, offsets=tuple(offsets))
    rs0 = torch.sum(r0.to(torch.float64) ** 2)
    p = torch.zeros((2, n), dtype=b.dtype, device=b.device)
    r = torch.zeros_like(p)
    p[0] = r0
    r[0] = r0
    state = torch.zeros(STATE_LEN, dtype=torch.float64, device=b.device)
    state[RSOLD] = rs0
    state[RSNEW] = rs0
    state[CONV] = ((torch.sqrt(rs0) < tol) | (rs0 == 0)).to(torch.float64)
    bmat = torch.as_tensor(_basis_matrix(s, theta, delta, np.float64, tuple(shifts)),
                           device=b.device)
    return BlockState(x0.clone(), p, r, state, bmat)


def block(bands, st: BlockState, *, offsets, s: int, theta: float, delta: float, shifts=(),
          tol: float, nearzero: float, maxiter: int, work: Optional[Workspace] = None) -> None:
    """One s-step block on ``st``: a Gram launch and a recover launch."""
    kw = dict(offsets=offsets, s=s, theta=theta, delta=delta, shifts=shifts, work=work)
    _sstep_gram(bands, st.p, st.r, st.state, st.bmat, tol=tol, nearzero=nearzero,
                maxiter=maxiter, **kw)
    _sstep_recover(bands, st.p, st.r, st.x, st.state, **kw)


def _sstep_stream_loop(bands, b, x0, tol: float, nearzero: float, *, offsets, s: int,
                       maxiter: int, theta: float, delta: float, shifts=(),
                       bands_dtype=None) -> CGResult:
    """Chain blocks until the stop or maxiter, reading the state once per
    ``_BLOCKS`` blocks (cgx ``_sstep_stream_loop``). With
    ``bands_dtype`` bfloat16 or float16 the launches stream rounded
    bands and the set-up mat-vec uses the same rounded operator."""
    offsets = tuple(int(o) for o in offsets)
    if bands_dtype is not None:
        bands = bands.to(bands_dtype)
    st = initial_state(bands.to(b.dtype), b, x0, tol, offsets=offsets, s=s, theta=theta,
                       delta=delta, shifts=shifts)
    work = (None if b.device.type == "cpu"
            else workspace(b.device, b.shape[0], offsets, s, b.dtype))
    kw = dict(offsets=offsets, s=s, theta=theta, delta=delta, shifts=tuple(shifts), tol=tol,
              nearzero=nearzero, maxiter=maxiter, work=work)
    while not _stopped(st.state[:COEF].tolist(), maxiter):  # one host read per _BLOCKS blocks
        for _ in range(_BLOCKS):
            block(bands, st, **kw)
    state = st.state
    return CGResult(
        x=st.x,
        iterations=state[K].to(torch.int32),
        residual_norm=torch.sqrt(state[RSNEW]).to(b.dtype),
        converged=state[CONV] != 0,
        rsold=state[RSOLD].to(b.dtype),
        history=torch.zeros((0,), dtype=b.dtype, device=b.device),
        breakdown=state[BRK] != 0,
    )


def dia_sstep_stream_solve(
    op,
    b,
    x0=None,
    *,
    s: int = 4,
    bounds: Optional[Tuple[float, float]] = None,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    basis: str = "chebyshev",
    rows: int = 512,
    cols: int = 512,
    bands_dtype="auto",
    device="cuda",
) -> CGResult:
    """s-step CG by the fused two-launch block (kernels B10): the Krylov
    basis never reaches device memory.

    ``op`` is a :class:`cgx_torch.DiaOperator` of float32, float64 or
    bfloat16 and ``b`` a tensor on ``device`` (or NumPy) of its dtype;
    ``x0`` a start.
    ``bounds`` (lmin, lmax) come from :func:`cgx_torch.solver.chebyshev.
    spectral_bounds` when omitted; ``basis`` is "chebyshev" or "newton".
    ``bands_dtype``: None, ``torch.bfloat16`` or ``torch.float16`` under
    float32 vectors (the solve runs on the rounded operator) or "auto"
    (bf16 only when that rounding is exact, so the recurrence is bitwise
    the one of float32 bands; bfloat16 vectors stream bfloat16 bands). ``b`` is
    prescaled by an exact power of two, so that the Gram of a huge ``b``
    stays finite. The Gram and the replay are float64 (ROADMAP C), so the
    result follows :func:`cgx_torch.solver.sstep.sstep_cg_loop` with
    ``gram_precision=torch.float64`` rather than cgx's float32 replay."""
    dev = resolve_device(device)
    if not isinstance(op, DiaOperator):
        raise TypeError("dia_sstep_stream_solve needs a DiaOperator")
    _check_layout(rows, cols)
    if basis not in ("chebyshev", "newton"):
        raise ValueError(f"unknown s-step basis {basis!r}")
    b = as_vector(b, dev, "b")
    if op.bands.dtype != b.dtype:
        raise TypeError(f"bands are {op.bands.dtype} but b is {b.dtype}")
    if b.dtype not in vector_dtypes(*_GRAM, *_RECOVER):
        raise TypeError(f"the s-step kernels take float32, float64 or bfloat16, not {b.dtype}")
    n = b.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    if bounds is None:
        from cgx_torch.solver.chebyshev import spectral_bounds

        bounds = spectral_bounds(op, n)
    lmin, lmax = float(bounds[0]), float(bounds[1])
    if not 0 < lmin < lmax:
        raise ValueError(f"invalid spectral bounds {bounds}")
    theta, delta = (lmax + lmin) / 2.0, (lmax - lmin) / 2.0
    shifts = newton_shifts(op, n, int(s), (lmin, lmax)) if basis == "newton" else ()
    bands_dtype = _resolve_bands_dtype(op, b.dtype, bands_dtype)
    x0 = torch.zeros_like(b) if x0 is None else as_vector(x0, dev, "x0", b.dtype)
    down, up = (float(v) for v in pow2_rhs_scale(b, x0))
    res = _sstep_stream_loop(op.bands, b * down, x0 * down, float(tol) * down, float(nearzero),
                             offsets=op.offsets, s=int(s), maxiter=maxiter, theta=theta,
                             delta=delta, shifts=shifts, bands_dtype=bands_dtype)
    return res._replace(x=res.x * up, residual_norm=res.residual_norm * up,
                        rsold=res.rsold * (up * up))

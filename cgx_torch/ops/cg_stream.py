"""Streaming Chronopoulos-Gear CG: CUDA kernels B4, B7 and B6 and their
plain versions.

Counterpart of ``cgx/ops/cg_stream.py``. Above the resident budget the
state of a banded solve does not stay on chip, so each iteration is one
launch that streams the bands and the vectors once
(``cgx_torch/csrc/cg_stream.cu``, whose header note gives the bound and
the design). The arithmetic is that of
:func:`cgx_torch.solver.pipelined.pipelined_cg_solve` with float64 dots:
the dots and the scalar state stay in float64 on the device, packed as
``[gamma, delta, rr, gamma_old, alpha_old, k, stop, breakdown]``, and
each launch derives alpha and beta from what the launch before left
(cgx keeps float32 scalars on the host; in the whole-solve kernel float
scalars moved the counts past the 2% gate, ROADMAP C).

- :func:`_stream_iteration` (site ``cg_stream.py:404``): r, w and s in
  three ping-pong pairs, each a (2, N) tensor;
- :func:`_stream_iteration_stacked` (site ``cg_stream.py:930``): r, w
  and s in one (2, 3, N) tensor, the TPU's (3, rows, cols) stack with
  its ping-pong pair; the same kernel, so bitwise the split result;
- :func:`_stream_iteration_pcg` (site ``cg_stream.py:1203``): the
  iteration with the degree-1 Neumann preconditioner
  ``M^-1 = 2 D^-1 - D^-1 A D^-1``, in the design :func:`pcg_plan`
  picks: one launch on a wavefront whose levels c' and u' stay in
  shared-memory rings where the rings fit, else three launches (an
  update launch, a preconditioner launch and a mat-vec-and-dots launch).

A launch reads the pair's ``k % 2`` half and writes the other (k is the
device's count, which a frozen launch keeps), advances p, x (and u) in
place and rewrites the scalars. On a CUDA tensor each wrapper launches
its kernel or raises; on a CPU tensor it runs the plain version beside
it. Each counts in ``.launches`` the kernel launches its calls make (or
stand for, on the CPU): one an iteration, and for the Neumann PCG one or
three, as its plan says.

The host loops :func:`_dia_cg_stream` and :func:`_dia_cg_stream_pcg`
do cgx's set-up (x0 = 0, w0 = A b or A u0 through the plain mat-vec, as
cgx leaves that to XLA) and chain launches, reading the scalars once per
``_CHUNK`` launches. :func:`dia_cg_solve_stream` and
:func:`dia_cg_solve_stream_pcg` keep cgx's signatures: ``rows`` and
``cols`` were TPU tiling (validated as cgx validates them, otherwise
unused), ``pad_stride`` a TPU lane-roll layout (the flat layout here is
the same operator). float64 runs too, which cgx's TPU kernel refuses.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from cgx_torch.config import DEFAULT_TOLERANCE, NEARZERO
from cgx_torch.ops._util import (
    SHARED_OPTIN,
    band_dtypes,
    band_storage,
    check_operands,
    count_build,
    entry_suffix,
    pow2_rhs_scale,
    resolve_device,
    round_up,
    slab_grid,
    sms_of,
    vector_dtypes,
)
from cgx_torch.ops.dia_spmv import _check as _check_bands
from cgx_torch.ops.dia_spmv import _offsets_arg, dia_matvec_ref
from cgx_torch.solver.cg import _CHUNK, CGResult, as_vector

LANES = 128  # cgx's TPU lane count: cols must stay a multiple of it
LAYOUTS = ("split", "stacked")
# the packed float64 scalars (csrc/cg_stream.cu, enum Scalar)
GAMMA, DELTA, RR, GAMMA_OLD, ALPHA_OLD, K, STOP, BREAKDOWN = range(8)
_SCALARS = 8
ROWS_PER_BLOCK = 1024  # kThreads * kRowsPerThread of csrc/cg_stream.cu
# The PCG's wavefront design (csrc/cg_stream.cu pcg_wave_kernel)
PCG_THREADS = 512  # kPcgThreads: one block an SM, and W, the rows a level advances a step
PCG_STATIC = 1024  # shared bytes kept for the kernel's static shared memory (the block sums)


class Workspace(NamedTuple):
    """Scratch of a launch on N rows: each block's gamma, delta and rr
    partials, and the ticket that picks the last block (zero between
    launches; the kernel resets it)."""

    partials: torch.Tensor
    ticket: torch.Tensor


def workspace(device, n: int) -> Workspace:
    blocks = -(-n // ROWS_PER_BLOCK)
    return Workspace(torch.empty(3 * blocks, dtype=torch.float64, device=device),
                     torch.zeros(1, dtype=torch.int32, device=device))


class PcgPlan(NamedTuple):
    """How the Neumann-PCG iteration runs. ``design`` is "wavefront"
    (one launch, ``launches`` 1) or "three" (three launches). For the
    wavefront: ``width`` W; the ``lags`` of L0 (c', the frontier), L1
    (u') and L2 (w'); the ``rings`` of c', u' and r' (values) and their
    ``ring_offsets`` in the shared buffer; ``shared`` bytes a block;
    ``grid`` blocks, each on one ``slab`` of rows."""

    design: str
    width: int
    lags: Tuple[int, int, int]
    rings: Tuple[int, int, int]
    ring_offsets: Tuple[int, int, int]
    shared: int
    grid: int
    slab: int

    @property
    def launches(self) -> int:
        return 1 if self.design == "wavefront" else 3

    def as_arg(self):
        """The plan array of csrc/cg_stream.cu make_pcg_plan, and its length."""
        vals = (self.width, self.slab, self.shared, *self.lags[1:], *self.rings,
                *self.ring_offsets)
        return (ctypes.c_longlong * len(vals))(*vals), len(vals)


def pcg_schedule(reach: int, width: int):
    """``(lags, rings)`` of the wavefront: L1 lags L0 by R + W and L2
    lags L1 by R + W (a level's stencil reaches R rows ahead, and it
    reads only rows the level below finished in an earlier step). A ring
    holds its level from the oldest row a reader reads in a step to the
    newest row the level writes in it: c' from R rows before L1's window
    (2R + 2W), u' from R rows before L2's (2R + 2W), r' from L1's window,
    where gamma' reads it (R + 2W)."""
    R, W = int(reach), int(width)
    lags = (0, R + W, 2 * (R + W))
    rings = (lags[1] + W + R, lags[2] - lags[1] + W + R, lags[1] + W)
    return lags, rings


def three_plan(n: int) -> PcgPlan:
    """The three-launch design's plan: a block for each ROWS_PER_BLOCK
    rows (what pcg_plan picks where the rings do not fit;
    ``chip_smoke.py`` also runs it beside the wavefront)."""
    grid = -(-n // ROWS_PER_BLOCK)
    return PcgPlan("three", 0, (0, 0, 0), (0, 0, 0), (0, 0, 0), 0, grid, ROWS_PER_BLOCK)


@functools.lru_cache(maxsize=64)
def pcg_plan(n: int, offsets: Tuple[int, ...], dtype: torch.dtype, sms: int) -> PcgPlan:
    """The design of the Neumann-PCG iteration on n rows. The rule: the
    wavefront where its three rings (in the vectors' dtype) fit one
    block's shared memory, one block an SM (``sms`` blocks, fewer where
    a slab would have fewer than MIN_TILE rows); else three launches. At
    R = 3200 and W = 512 the rings hold 19,072 values: 76,288 bytes in
    float32, 152,576 in float64, so both take the wavefront at
    N = 10,240,000. The design depends on the reach and the dtype only,
    not on ``sms``."""
    item = torch.finfo(dtype).bits // 8
    reach = max(abs(int(o)) for o in offsets)
    lags, rings = pcg_schedule(reach, PCG_THREADS)
    shared = sum(rings) * item
    if shared + PCG_STATIC > SHARED_OPTIN:
        return three_plan(n)
    offs = (0, rings[0], rings[0] + rings[1])
    grid = slab_grid(n, sms)
    return PcgPlan("wavefront", PCG_THREADS, lags, rings, offs, shared, grid, -(-n // grid))


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """<u, v> in float64, as the kernels sum their dots: exact products,
    bfloat16 ones included."""
    return torch.sum(u.to(torch.float64) * v.to(torch.float64))


_ENTRIES = ("cgx_cg_stream", "cgx_pcg_wave")  # one C entry a design, each with a _bf16 build


def _nan_max(a: float, b: float) -> float:
    """max that propagates a NaN from either side, as torch.maximum does."""
    return a if (a != a or a > b) else b


def _check(fn: str, bands, p, x, u, pairs, scal, offsets) -> Tuple[int, ...]:
    """Validate one launch's operands before any pointer reaches C."""
    vectors = {"p": p, "x": x} if u is None else {"p": p, "x": x, "u": u}
    dtypes = vector_dtypes(*_ENTRIES)
    # the PCG's designs (cgx_pcg_wave, or cgx_cg_stream's three launches) stream
    # bfloat16 bands only; the plain iteration float16 ones too
    narrow = band_dtypes(*(_ENTRIES if u is not None else _ENTRIES[:1]))
    check_operands(fn, vectors, dtypes=dtypes)
    n = x.shape[0]
    for name, t in pairs.items():
        if not (isinstance(t, torch.Tensor) and t.dtype == x.dtype and t.device == x.device
                and t.shape == (2, n) and t.stride(-1) == 1):
            raise ValueError(f"{fn}: {name} must be a (2, {n}) {x.dtype} pair on {x.device} "
                             "with unit stride along the rows")
    if not (isinstance(scal, torch.Tensor) and scal.shape == (_SCALARS,)
            and scal.dtype == torch.float64 and scal.device == x.device and scal.is_contiguous()):
        raise ValueError(f"{fn}: scal must be a contiguous float64 ({_SCALARS},) tensor on x's "
                         "device")
    return _check_bands(fn, bands, x, offsets, narrow=narrow, dtypes=dtypes)


class Step(NamedTuple):
    """What a launch derives from the scalars before it touches a vector:
    alpha and beta (0-d tensors in the vectors' dtype), the breakdown
    flag, the parity q of the pair halves it reads, and the scalars it
    read."""

    alpha: torch.Tensor
    beta: torch.Tensor
    brk: float
    q: int
    gamma: float
    k: float


def step_scalars(scal, dtype, *, nearzero, maxiter) -> Optional[Step]:
    """The kernels' prelude on the host: None for a frozen launch (stop
    set, or k >= maxiter), else alpha, beta and the breakdown flag from
    the float64 scalars, as csrc/cg_stream.cu derives them."""
    gamma, delta, _, gamma_old, alpha_old, k, stop, brk = scal.tolist()
    if stop != 0.0 or not k < maxiter:
        return None
    first = k == 0.0
    beta_d = 0.0 if first else gamma / gamma_old
    denom = delta if first else delta - beta_d * gamma / alpha_old
    if denom <= 0.0:
        brk = 1.0
    alpha = torch.tensor(gamma / _nan_max(denom, gamma * nearzero), dtype=dtype)
    return Step(alpha, torch.tensor(beta_d, dtype=dtype), brk, int(k) & 1, gamma, k)


def new_scalars(scal, st: Step, gamma_new: float, delta_new: float, rr_new: float, *,
                tol) -> None:
    """The last block's rewrite of the scalars after an active launch."""
    stop_new = 0.0 if (rr_new > 0.0 and math.sqrt(rr_new) >= tol) else 1.0
    scal.copy_(torch.tensor([gamma_new, delta_new, rr_new, st.gamma, float(st.alpha), st.k + 1.0,
                             stop_new, st.brk], dtype=torch.float64))


def _iteration_ref(bands, p, x, u, r, w, s, scal, *, offsets, tol, nearzero, maxiter) -> None:
    """Plain version of the three sites' kernels: one iteration with the
    kernel's arithmetic in torch, the dots summed by ``torch.sum`` in
    float64. ``r``, ``w`` and ``s`` are pairs (indexable by 0 and 1) of
    1-D tensors; ``u`` is None without the preconditioner. Reads the
    scalars on the host."""
    st = step_scalars(scal, x.dtype, nearzero=nearzero, maxiter=maxiter)
    if st is None:
        return  # frozen, as the kernel
    dt = x.dtype
    alpha, beta, q = st.alpha.to(x.device), st.beta.to(x.device), st.q
    bw = bands.to(dt)  # exact: bfloat16 widens to float32
    s_new = w[q] + beta * s[q]
    r_new = r[q] - alpha * s_new
    p_new = (r[q] if u is None else u) + beta * p
    x.copy_(x + alpha * p_new)
    p.copy_(p_new)
    if u is None:
        u_new = r_new
    else:
        invd = 1.0 / bw[offsets.index(0)]
        c = invd * r_new
        u_new = 2.0 * c - invd * dia_matvec_ref(bw, c, offsets=offsets)
        u.copy_(u_new)
    w_new = dia_matvec_ref(bw, u_new, offsets=offsets)
    r[1 - q].copy_(r_new)
    w[1 - q].copy_(w_new)
    s[1 - q].copy_(s_new)
    gamma_new, delta_new = _dot(r_new, u_new).item(), _dot(w_new, u_new).item()
    rr_new = gamma_new if u is None else _dot(r_new, r_new).item()
    new_scalars(scal, st, gamma_new, delta_new, rr_new, tol=tol)


def _count(fn, bands, x, launches: int = 1) -> None:
    """Count the kernel launches one call stands for: one, or the PCG
    plan's one or three (csrc/cg_stream.cu), in ``fn.launches`` and by
    build in ``BUILD_LAUNCHES``."""
    fn.launches += launches
    count_build(fn.__name__.removeprefix("_"), x.dtype, bands.dtype, launches)
    fn.bands_dtype = bands.dtype


def _launcher(fn, bands, p, x, u, r, w, s, scal, offsets, tol, nearzero, maxiter, work,
              plan=None):
    """A call that launches the kernel for site ``fn`` on these operands
    (already checked) and counts it. Its C arguments are built once, so a
    host loop on buffers that stay put pays only the call; it runs on
    the stream that was current here, with x's device current. The PCG
    runs ``plan`` (default :func:`pcg_plan`'s)."""
    from cgx_torch import _build

    n = x.shape[0]
    work = workspace(x.device, n) if work is None else work
    suffix = entry_suffix(x.dtype, bands.dtype)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    pairs = [t.data_ptr() for t in (r[0], r[1], w[0], w[1], s[0], s[1])]
    grid = ctypes.c_int(0)
    c = None
    if u is not None and plan is None:
        plan = pcg_plan(n, offsets, x.dtype, sms_of(x.device))
    if plan is not None and plan.design == "wavefront":
        entry = getattr(lib, "cgx_pcg_wave" + suffix)
        grid.value = plan.grid
        plan_arg, plan_len = plan.as_arg()
        args = (bands.data_ptr(), p.data_ptr(), x.data_ptr(), u.data_ptr(), *pairs,
                work.partials.data_ptr(), work.partials.numel(), work.ticket.data_ptr(),
                scal.data_ptr(), n, _offsets_arg(offsets), len(offsets), float(tol),
                float(nearzero), float(maxiter), plan_arg, plan_len, plan.grid, stream)
    else:
        entry = getattr(lib, "cgx_cg_stream" + suffix)
        c = None if u is None else torch.empty_like(x)  # D^-1 r', between the PCG's launches
        args = (bands.data_ptr(), p.data_ptr(), x.data_ptr(), *(None if v is None else v.data_ptr()
                                                                 for v in (u, c)),
                *pairs, work.partials.data_ptr(), work.partials.numel(), work.ticket.data_ptr(),
                scal.data_ptr(), n, _offsets_arg(offsets), len(offsets),
                offsets.index(0) if u is not None else -1, float(tol), float(nearzero),
                float(maxiter), int(u is not None), ctypes.byref(grid), stream)
    launches = 1 if plan is None else plan.launches

    def go() -> None:
        rc = entry(*args)
        if rc != 0:
            raise RuntimeError(f"{entry.__name__}: the CUDA launch failed with cudaError {rc}")
        fn.grid = grid.value
        if plan is not None:
            fn.design, fn.plan = plan.design, plan
        _count(fn, bands, x, launches)

    # the tensors whose addresses args holds live as long as the call
    go.operands = (bands, p, x, u, c, r, w, s, scal, work)
    return go


def _launch(fn, bands, p, x, u, r, w, s, scal, offsets, tol, nearzero, maxiter, work,
            plan=None) -> None:
    """One launch of the kernel on the given halves of the pairs."""
    with torch.cuda.device(x.device):
        _launcher(fn, bands, p, x, u, r, w, s, scal, offsets, tol, nearzero, maxiter, work,
                  plan)()


def _stream_iteration(bands, p, x, r, w, s, scal, *, offsets: Sequence[int], tol: float,
                      nearzero: float, maxiter: int, work: Optional[Workspace] = None) -> None:
    """One Chronopoulos-Gear iteration, r, w and s each a (2, N) pair."""
    offsets = _check("_stream_iteration", bands, p, x, None, {"r": r, "w": w, "s": s}, scal,
                     offsets)
    if x.device.type == "cpu":
        _iteration_ref(bands, p, x, None, r, w, s, scal, offsets=offsets, tol=tol,
                       nearzero=nearzero, maxiter=maxiter)
        _count(_stream_iteration, bands, x)
    else:
        _launch(_stream_iteration, bands, p, x, None, r, w, s, scal, offsets, tol, nearzero,
                maxiter, work)


def _stream_iteration_stacked(bands, p, x, rws, scal, *, offsets: Sequence[int], tol: float,
                              nearzero: float, maxiter: int,
                              work: Optional[Workspace] = None) -> None:
    """One iteration with r, w and s stacked in one (2, 3, N) tensor:
    ``rws[q]`` holds the (3, N) stack of parity q."""
    n = x.shape[0]
    if not (isinstance(rws, torch.Tensor) and rws.shape == (2, 3, n) and rws.is_contiguous()):
        raise ValueError(f"_stream_iteration_stacked: rws must be a contiguous (2, 3, {n}) tensor")
    r, w, s = rws[:, 0], rws[:, 1], rws[:, 2]
    offsets = _check("_stream_iteration_stacked", bands, p, x, None, {"rws": r}, scal, offsets)
    if x.device.type == "cpu":
        _iteration_ref(bands, p, x, None, r, w, s, scal, offsets=offsets, tol=tol,
                       nearzero=nearzero, maxiter=maxiter)
        _count(_stream_iteration_stacked, bands, x)
    else:
        _launch(_stream_iteration_stacked, bands, p, x, None, r, w, s, scal, offsets, tol,
                nearzero, maxiter, work)


def _stream_iteration_pcg(bands, p, x, u, r, w, s, scal, *, offsets: Sequence[int], tol: float,
                          nearzero: float, maxiter: int, work: Optional[Workspace] = None,
                          plan: Optional[PcgPlan] = None) -> None:
    """One Neumann-preconditioned iteration; u advances in place. On the
    card in the design of :func:`pcg_plan` (``plan=three_plan(n)``
    forces three launches); on the CPU counted as that design's launches."""
    offsets = _check("_stream_iteration_pcg", bands, p, x, u, {"r": r, "w": w, "s": s}, scal,
                     offsets)
    _diag_index(offsets)
    if x.device.type == "cpu":
        _iteration_ref(bands, p, x, u, r, w, s, scal, offsets=offsets, tol=tol,
                       nearzero=nearzero, maxiter=maxiter)
        if plan is None:  # the design is the same on any number of SMs
            plan = pcg_plan(x.shape[0], offsets, x.dtype, 1)
        _count(_stream_iteration_pcg, bands, x, plan.launches)
    else:
        _launch(_stream_iteration_pcg, bands, p, x, u, r, w, s, scal, offsets, tol, nearzero,
                maxiter, work, plan)


for _fn in (_stream_iteration, _stream_iteration_stacked, _stream_iteration_pcg):
    _fn.launches = 0
    _fn.grid = None  # blocks of the last CUDA launch
    _fn.bands_dtype = None  # the band storage of the last call
_stream_iteration_pcg.design = None  # pcg_plan's design of the last CUDA launch, and the plan
_stream_iteration_pcg.plan = None


def _diag_index(offsets: Sequence[int]) -> int:
    if 0 not in offsets:
        raise ValueError("the Neumann-preconditioned streaming kernel needs the main diagonal "
                         f"(offset 0) in the band set; got {tuple(offsets)}")
    return tuple(offsets).index(0)


class StreamState(NamedTuple):
    """The state one launch advances: p and x (and u with the
    preconditioner) in place, the r, w, s pairs (views of ``rws`` in the
    stacked layout) and the packed scalars."""

    p: torch.Tensor
    x: torch.Tensor
    u: Optional[torch.Tensor]
    r: torch.Tensor
    w: torch.Tensor
    s: torch.Tensor
    rws: Optional[torch.Tensor]
    scal: torch.Tensor


def initial_state(bands, b, tol: float, *, offsets, precond: bool = False,
                  stacked: bool = False) -> StreamState:
    """cgx's set-up from x0 = 0 (cg_stream.py:525-547, :1291-1320) on
    flat vectors: r = b, s = p = x = 0 and, through the plain mat-vec (as
    cgx leaves it to XLA), w = A b, or with the preconditioner u = M^-1 b
    and w = A u; the dots in float64. ``bands`` are in b's dtype."""
    offsets = tuple(int(o) for o in offsets)
    n = b.shape[0]
    if precond:
        invd = 1.0 / bands[_diag_index(offsets)]
        c0 = invd * b
        u = 2.0 * c0 - invd * dia_matvec_ref(bands, c0, offsets=offsets)
        del invd, c0
    else:
        u = None
    u0 = b if u is None else u
    w0 = dia_matvec_ref(bands, u0, offsets=offsets)
    if stacked:
        rws = torch.zeros((2, 3, n), dtype=b.dtype, device=b.device)
        r, w, s = rws[:, 0], rws[:, 1], rws[:, 2]
    else:
        rws = None
        r, w, s = (torch.zeros((2, n), dtype=b.dtype, device=b.device) for _ in range(3))
    r[0].copy_(b)
    w[0].copy_(w0)
    gamma0, rr0 = _dot(b, u0), _dot(b, b)
    one = torch.ones((), dtype=torch.float64, device=b.device)
    stop = torch.where((rr0 > 0) & (torch.sqrt(rr0) >= tol), 0 * one, one)
    scal = torch.stack([gamma0, _dot(w0, u0), rr0, gamma0, one, 0 * one, stop, 0 * one])
    return StreamState(torch.zeros_like(b), torch.zeros_like(b), u, r, w, s, rws, scal)


def step(bands, st: StreamState, *, offsets, tol: float, nearzero: float, maxiter: int,
         work: Optional[Workspace] = None, plan: Optional[PcgPlan] = None) -> None:
    """One iteration on ``st``, through the wrapper of its site: the PCG
    kernel (in ``plan``'s design) when ``st`` carries u, else the stacked
    or the split one."""
    kw = dict(offsets=offsets, tol=tol, nearzero=nearzero, maxiter=maxiter, work=work)
    if st.u is not None:
        _stream_iteration_pcg(bands, st.p, st.x, st.u, st.r, st.w, st.s, st.scal, plan=plan, **kw)
    elif st.rws is not None:
        _stream_iteration_stacked(bands, st.p, st.x, st.rws, st.scal, **kw)
    else:
        _stream_iteration(bands, st.p, st.x, st.r, st.w, st.s, st.scal, **kw)


def _run(bands, st: StreamState, *, offsets, tol: float, nearzero: float,
         maxiter: int) -> CGResult:
    """Chain iterations until stop or maxiter, reading the scalars once per
    ``_CHUNK`` iterations; those past the stop are frozen. On a card the
    operands are checked once and each launch reuses its C arguments
    (:func:`_launcher`): the host's cost of a launch bounds an iteration
    at small N."""
    scal = st.scal
    kw = dict(offsets=offsets, tol=tol, nearzero=nearzero, maxiter=maxiter)
    if st.x.device.type == "cpu":
        def go():
            step(bands, st, **kw)
        device = contextlib.nullcontext()
    else:
        site = (_stream_iteration_pcg if st.u is not None
                else _stream_iteration_stacked if st.rws is not None else _stream_iteration)
        _check(site.__name__, bands, st.p, st.x, st.u, {"r": st.r, "w": st.w, "s": st.s}, scal,
               offsets)
        device = torch.cuda.device(st.x.device)
        with device:
            go = _launcher(site, bands, st.p, st.x, st.u, st.r, st.w, st.s, scal,
                           work=workspace(st.x.device, st.x.shape[0]), **kw)
    with device:
        stop, k = scal[[STOP, K]].tolist()
        while stop == 0.0 and k < maxiter:
            for _ in range(min(_CHUNK, maxiter - int(k))):
                go()
            stop, k = scal[[STOP, K]].tolist()
    res = torch.sqrt(scal[RR])
    return CGResult(
        x=st.x,
        iterations=scal[K].to(torch.int32),
        residual_norm=res,
        converged=res < tol,
        rsold=scal[GAMMA_OLD],
        history=torch.zeros((0,), dtype=st.x.dtype, device=st.x.device),
        breakdown=scal[BREAKDOWN] == 1.0,
    )


def _dia_cg_stream(bands, b, tol: float, nearzero: float, *, offsets, maxiter: int,
                   layout: str = "split", bands_dtype=None) -> CGResult:
    """cgx's ``_dia_cg_stream`` (cg_stream.py:478-603) from x0 = 0;
    ``bands_dtype=torch.bfloat16`` streams rounded bands, and the set-up
    mat-vec uses the same rounded operator."""
    offsets = tuple(int(o) for o in offsets)
    if bands_dtype is not None:
        bands = bands.to(bands_dtype)
    st = initial_state(bands.to(b.dtype), b, tol, offsets=offsets, stacked=layout == "stacked")
    return _run(bands, st, offsets=offsets, tol=tol, nearzero=nearzero, maxiter=maxiter)


def _dia_cg_stream_pcg(bands, b, tol: float, nearzero: float, *, offsets,
                       maxiter: int) -> CGResult:
    """cgx's ``_dia_cg_stream_pcg`` (cg_stream.py:1273-1362) from x0 = 0;
    the stopping rule is on rr = <r, r>."""
    offsets = tuple(int(o) for o in offsets)
    st = initial_state(bands, b, tol, offsets=offsets, precond=True)
    return _run(bands, st, offsets=offsets, tol=tol, nearzero=nearzero, maxiter=maxiter)


def _stride_remap(offsets, stride: int, stride2: int):
    """Balanced decomposition o = a*stride + c, |c| <= stride//2 ->
    (new offsets a*stride2 + c, the c values) (cgx cg_stream.py:94-104)."""
    new, cs = [], []
    for o in offsets:
        a, c = divmod(o, stride)
        if c > stride // 2:
            a, c = a + 1, c - stride
        new.append(a * stride2 + c)
        cs.append(c)
    return tuple(new), tuple(cs)


def _stride_couples(bands, offsets, stride: int) -> bool:
    """True if a band entry with a nonzero in-row component couples
    across a grid-row boundary of length ``stride`` (cgx's
    ``_stride_crossing_nonzero``, counting nonzeros, not summing)."""
    _, cs = _stride_remap(offsets, stride, stride)
    i = torch.arange(bands.shape[1], device=bands.device) % stride
    bad = torch.zeros((), dtype=torch.int64, device=bands.device)
    for d, c in enumerate(cs):
        if c:
            m = (i >= stride - c) if c > 0 else (i < -c)
            bad = bad + ((bands[d] != 0) & m).sum()
    return bool(bad > 0)


def _check_pad_stride(offsets, cols: int, bands, pad_stride) -> None:
    """cgx's ``pad_stride``: a TPU layout that pads each grid row to a
    multiple of ``cols`` so that the +-grid offsets become free row
    shifts. The port's flat layout is the same operator without it, so
    False and "auto" change nothing; True keeps cgx's refusal when every
    candidate stride would change the operator (cg_stream.py:164-208)."""
    if not pad_stride or pad_stride == "auto":
        return
    cands = []
    for stride in sorted({abs(o) for o in offsets if abs(o) > 1}):
        stride2 = round_up(stride, cols)
        if stride2 == stride:
            continue
        _, cs = _stride_remap(offsets, stride, stride2)
        if any(abs(c) >= cols for c in cs):
            continue
        if any(o % cols and not c % cols for o, c in zip(offsets, cs)):
            cands.append(stride)
    if cands and all(_stride_couples(bands, offsets, st) for st in cands):
        raise ValueError("pad_stride=True but the operator couples across grid-row boundaries on "
                         "a lane-component offset: padding would change the matrix (use "
                         "pad_stride='auto' or False)")


def _validate(op, b, rows, cols, dev):
    if int(cols) % LANES != 0:
        raise ValueError(f"cols must be a multiple of {LANES}, got {cols}")
    if rows is not None and int(rows) < 1:
        raise ValueError(f"rows must be positive, got {rows}")
    b = as_vector(b, dev, "b")
    if op.bands.dtype != b.dtype:
        raise TypeError(f"bands are {op.bands.dtype} but b is {b.dtype}")
    if b.dtype not in vector_dtypes(*_ENTRIES):
        raise TypeError(f"the streaming kernels take float32, float64 or bfloat16, not {b.dtype}")
    return b


def _resolve_bands_dtype(op, dtype, bands_dtype):
    """None, or torch.bfloat16 for bf16 band storage. "auto" takes bf16
    only when the round trip reproduces the bands bit for bit (one
    device check), so the solved operator is untouched."""
    if isinstance(bands_dtype, str):
        if bands_dtype != "auto":
            raise ValueError(f"unknown bands_dtype {bands_dtype!r}")
        if dtype != torch.float32:
            return None
        exact = bool(torch.equal(op.bands.to(torch.bfloat16).to(dtype), op.bands))
        return torch.bfloat16 if exact else None
    return band_storage(dtype, bands_dtype)


def dia_cg_solve_stream(
    op,
    b,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    rows: Optional[int] = None,
    cols: int = 512,
    layout: str = "split",
    pad_stride=False,
    bands_dtype=None,
    device="cuda",
) -> CGResult:
    """Chronopoulos-Gear CG on a banded operator, one launch of the
    streaming kernel per iteration: the path of banded solves whose state
    is above the resident budget.

    ``op`` is a :class:`cgx_torch.DiaOperator` of float32, float64 or
    bfloat16 and ``b`` a tensor on ``device`` (or NumPy) of the same dtype. ``layout``
    is ``"split"`` or ``"stacked"`` (cgx's two sites; the same kernel,
    bitwise the same result). ``bands_dtype`` is None, ``torch.bfloat16``
    (the solve then runs on the rounded operator) or ``"auto"`` (bf16
    only when that rounding is exact). ``b`` is prescaled by an exact
    power of two (:func:`cgx_torch.ops._util.pow2_rhs_scale`) so that
    ``<r, r>`` of a huge ``b`` stays finite. ``rows``, ``cols`` and
    ``pad_stride`` are cgx's TPU layout knobs, validated as cgx does;
    ``block``-like tuning and ``interpret`` are gone."""
    dev = resolve_device(device)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    b = _validate(op, b, rows, cols, dev)
    offsets = tuple(int(o) for o in op.offsets)
    bands_dtype = _resolve_bands_dtype(op, b.dtype, bands_dtype)
    _check_pad_stride(offsets, int(cols), op.bands, pad_stride)
    n = b.shape[0]
    down, up = (float(v) for v in pow2_rhs_scale(b))
    res = _dia_cg_stream(op.bands, b * down, float(tol) * down,
                         float(torch.tensor(nearzero, dtype=b.dtype)), offsets=offsets,
                         maxiter=n if maxiter is None else int(maxiter), layout=layout,
                         bands_dtype=bands_dtype)
    return res._replace(x=res.x * up, residual_norm=res.residual_norm * up,
                        rsold=res.rsold * (up * up))


def dia_cg_solve_stream_pcg(
    op,
    b,
    *,
    tol: float = DEFAULT_TOLERANCE,
    maxiter: Optional[int] = None,
    nearzero: float = NEARZERO,
    rows: Optional[int] = None,
    cols: int = 512,
    pad_stride=False,
    device="cuda",
) -> CGResult:
    """Neumann-preconditioned streaming CG: one launch per iteration where
    :func:`pcg_plan` takes the wavefront (c' and u' kept on chip), else
    three; ``M^-1 = 2 D^-1 - D^-1 A D^-1`` applied inside, the arithmetic of
    ``pipelined_cg_solve(precond=neumann_banded(sweeps=2),
    dot_precision=float64)``. Stops on the unpreconditioned residual
    ``sqrt(<r, r>) < tol``; ``rsold`` holds <r, u>. Needs offset 0 in
    the band set. Arguments as :func:`dia_cg_solve_stream` (cgx's PCG
    entry has no prescale and no ``bands_dtype``; neither has this)."""
    dev = resolve_device(device)
    b = _validate(op, b, rows, cols, dev)
    offsets = tuple(int(o) for o in op.offsets)
    _diag_index(offsets)
    _check_pad_stride(offsets, int(cols), op.bands, pad_stride)
    return _dia_cg_stream_pcg(op.bands, b, float(tol),
                              float(torch.tensor(nearzero, dtype=b.dtype)), offsets=offsets,
                              maxiter=b.shape[0] if maxiter is None else int(maxiter))

"""The wavefront design of the plain streaming iteration
(cgx_torch/csrc/cg_stream.cu stream_wave_kernel, sites B4 and B7), on the
CPU: stream_plan's choice of design (the wavefront where its ring of r'
fits one block's shared memory, n is even and the pointers lie on their
pairs' grid; else the grid design), and a pure-torch walk of the plan
that forms each level the way the kernel does (s', r', p', x' at the
frontier L0 by pairs of rows, r' kept in a ring; w' = A r' and the dots at
L1, lag rows behind; one barrier a step; the halo rows of r' formed again
from the read halves of r, w and s), against the plain version bitwise,
and a whole solve driven by the walk against cgx's streaming CG in
interpret mode.

The walk tags each ring slot with the row it holds and fails on a read
of any other row (a ring too short), on a write to a slot read in the
same step (a race between the threads of one step on the card), and on a
pair of rows that does not start on an even row (a misaligned load)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
from cgx.mats.generators import source_term
from cgx.ops.cg_stream import dia_cg_solve_stream as cgx_stream
from cgx_torch.mats.generators import lap2d_fd, lap2d_reference, lap3d_fd
from cgx_torch.ops import cg_stream as cs

MAIN_N, MAIN_OFFSETS = 10_240_000, (-3200, -1, 0, 1, 3200)  # lap2d_fd(3200)
H100_SMS = 132
KW = dict(tol=0.0, nearzero=1e-14, maxiter=10**6)
BF16 = torch.bfloat16


class Ring:
    """The ring of r', q values, each slot tagged with its row."""

    def __init__(self, q, dtype):
        self.q = q
        self.val = torch.full((q,), float("nan"), dtype=dtype)
        self.tag = torch.full((q,), -1, dtype=torch.int64)
        self.read = torch.zeros(q, dtype=torch.bool)

    def get(self, rows):
        slots = rows % self.q
        assert torch.equal(self.tag[slots], rows), "a row was overwritten before its last read"
        self.read[slots] = True
        return self.val[slots]

    def put(self, rows, vals):
        slots = rows % self.q
        assert not self.read[slots].any(), "a slot read in this step is rewritten"
        self.val[slots] = vals
        self.tag[slots] = rows


def _taps(bw, rows, offsets, n, ring):
    """sum_d band_d(row) * r'[row + off_d] in offset order from the ring, a
    row's term skipped where row + off_d is outside [0, n)."""
    acc = torch.zeros(rows.numel(), dtype=bw.dtype)
    for d, off in enumerate(offsets):
        j = rows + off
        ok = (j >= 0) & (j < n)
        v = torch.zeros(rows.numel(), dtype=bw.dtype)
        v[ok] = ring.get(j[ok])
        acc = torch.where(ok, acc + bw[d, rows] * v, acc)
    return acc


def walk(plan, bands, st, *, offsets, tol, nearzero, maxiter):
    """One launch of ``plan``'s wavefront on ``st`` (no u), in place as the
    kernel: p and x advanced, the other halves of the pairs written, the
    scalars rewritten from the blocks' float64 partials summed in block
    order. Returns (gamma', delta'), or None for a frozen launch."""
    sc = cs.step_scalars(st.scal, st.x.dtype, nearzero=nearzero, maxiter=maxiter)
    if sc is None:
        return None
    offsets = tuple(offsets)
    n, dtype = st.x.shape[0], st.x.dtype
    reach, w, lag, q_ring = max(abs(o) for o in offsets), plan.width, plan.lag, plan.ring
    assert w == cs.WAVE_WIDTH and n % 2 == 0 and plan.slab % 2 == 0 and lag % 2 == 0
    bw = bands.to(dtype)
    q, alpha, beta = sc.q, sc.alpha, sc.beta
    r, wv, s = st.r[q], st.w[q], st.s[q]
    r_out, w_out, s_out = st.r[1 - q], st.w[1 - q], st.s[1 - q]
    parts = []
    for b in range(plan.grid):
        t0, t1 = b * plan.slab, min(n, (b + 1) * plan.slab)
        g = dl = torch.zeros((), dtype=torch.float64)
        if t0 < t1:
            lo0 = max(0, t0 - reach) // 2 * 2
            hi0 = (min(n, t1 + reach) + 1) // 2 * 2
            ring = Ring(q_ring, dtype)
            for t in range(math.ceil((t1 - lo0 + lag) / w)):
                ring.read.zero_()
                a0 = lo0 + t * w
                a1 = a0 - lag
                assert a0 % 2 == 0 and a1 % 2 == 0, "a thread's pair starts on an odd row"
                win = torch.arange(w)
                rows1 = a1 + win
                rows1 = rows1[(rows1 >= t0) & (rows1 < t1)]
                rows0 = a0 + win
                rows0 = rows0[(rows0 >= lo0) & (rows0 < hi0)]
                # L1: w' = A r' from the ring, delta'
                if rows1.numel():
                    rc = ring.get(rows1)
                    wn = _taps(bw, rows1, offsets, n, ring)
                    w_out[rows1] = wn
                    dl = dl + torch.sum(wn.double() * rc.double())
                # L0: s', r' everywhere; p', x' and gamma' at the slab's rows
                if rows0.numel():
                    sn = wv[rows0] + beta * s[rows0]
                    rn = r[rows0] - alpha * sn
                    own = (rows0 >= t0) & (rows0 < t1)
                    o = rows0[own]
                    pn = r[o] + beta * st.p[o]
                    st.x[o] = st.x[o] + alpha * pn
                    st.p[o] = pn
                    r_out[o] = rn[own]
                    s_out[o] = sn[own]
                    g = g + torch.sum(rn[own].double() * rn[own].double())
                    ring.put(rows0, rn)  # after every read of the step: one barrier
        parts.append((g, dl))
    gamma, delta = (float(sum(p[i] for p in parts)) for i in range(2))
    cs.new_scalars(st.scal, sc, gamma, delta, gamma, tol=tol)
    return gamma, delta


def _state(dia, dtype, seed=0):
    """Bands and cgx's start state from a seeded b, with a seeded x."""
    rng = np.random.default_rng(seed)
    bands = torch.as_tensor(dia.bands, dtype=dtype)
    b, x = (torch.as_tensor(rng.standard_normal(dia.shape[0]), dtype=dtype) for _ in range(2))
    st = cs.initial_state(bands, b, 0.0, offsets=tuple(dia.offsets))
    st.x.copy_(x)
    return bands, st


def _clone(st):
    return cs.StreamState(st.p.clone(), st.x.clone(), None, st.r.clone(), st.w.clone(),
                          st.s.clone(), None, st.scal.clone())


def _small_plan(n, offsets, dtype, grid):
    """stream_plan's wavefront on ``grid`` slabs (a small n takes fewer: the
    schedule holds for any even slabs that cover [0, n))."""
    plan = cs.stream_plan(n, tuple(offsets), dtype, grid)
    assert plan.design == "wavefront"
    slab = -(-n // grid) + (-(-n // grid)) % 2
    return plan._replace(grid=-(-n // slab), slab=slab)


@pytest.mark.parametrize("dtype", [BF16, torch.float32, torch.float64])
def test_main_shape_plan(dtype):
    """N = 10,240,000, R = 3200 on 132 SMs: every vector dtype takes the
    wavefront, one block an SM, W = 1024 (512 threads of two rows), L1
    R + W behind L0, a ring of 2R + 2W = 8,448 values of r': 16,896 bytes
    in bfloat16, 33,792 in float32 and 67,584 in float64, inside the
    227 KB a block may use. The iteration moves (ndiag + 10) N words; the
    halo adds 2R rows of r, w and s a slab, 1.65% more."""
    plan = cs.stream_plan(MAIN_N, MAIN_OFFSETS, dtype, H100_SMS)
    item = torch.finfo(dtype).bits // 8
    assert plan.design == "wavefront" and plan.launches == 1
    assert plan.width == 1024 == cs.WAVE_WIDTH and plan.grid == H100_SMS
    assert plan.slab == 77_576 and plan.grid * plan.slab >= MAIN_N > (plan.grid - 1) * plan.slab
    assert plan.lag == 3200 + 1024 and plan.ring == 8448
    assert plan.shared == 8448 * item == {2: 16_896, 4: 33_792, 8: 67_584}[item]
    assert plan.shared + cs.PCG_STATIC <= cs.SHARED_OPTIN
    arg, n_arg = plan.as_arg()
    assert n_arg == 5 and list(arg) == [1024, 77_576, plan.shared, 4224, 8448]
    must = (len(MAIN_OFFSETS) + 10) * MAIN_N * item
    halo = plan.grid * 2 * 3200 * 3 * item
    assert must == {2: 307_200_000, 4: 614_400_000, 8: 1_228_800_000}[item]
    assert halo == 2_534_400 * item and 0.016 < halo / must < 0.017


def test_plan_rule():
    """The grid design where the wavefront cannot run: n odd, a pointer off
    its pairs' grid, or a ring over a block's shared memory. lap3d_fd(216)
    (R = 46,656) fits in bfloat16 (95,360 values, 190,720 bytes) but not in
    float32; lap3d_fd(256) (R = 65,536) fits in neither. An odd reach
    (lap2d_reference's 101) keeps the lag even. The grid plan has a block
    for each ROWS_PER_BLOCK rows; stream_plan does not depend on sms."""
    assert cs.stream_plan(MAIN_N + 1, MAIN_OFFSETS, BF16, H100_SMS) == cs.grid_plan(MAIN_N + 1)
    assert cs.stream_plan(MAIN_N, MAIN_OFFSETS, BF16, H100_SMS, aligned=False) == \
        cs.grid_plan(MAIN_N)
    grid = cs.grid_plan(MAIN_N)
    assert grid.design == "grid" and grid.grid == 10_000 and grid.slab == cs.ROWS_PER_BLOCK
    for g, fits in ((216, {BF16: True, torch.float32: False, torch.float64: False}),
                    (256, {BF16: False, torch.float32: False, torch.float64: False})):
        offs = (-g * g, -g, -1, 0, 1, g, g * g)
        for dtype, ok in fits.items():
            plan = cs.stream_plan(g ** 3, offs, dtype, H100_SMS)
            assert (plan.design == "wavefront") is ok, (g, dtype, plan)
            ring = 2 * g * g + 2 * cs.WAVE_WIDTH
            item = torch.finfo(dtype).bits // 8
            assert (ring * item + cs.PCG_STATIC <= cs.SHARED_OPTIN) is ok
    p3 = cs.stream_plan(216 ** 3, (-46656, -216, -1, 0, 1, 216, 46656), BF16, H100_SMS)
    assert p3.ring == 95_360 and p3.shared == 190_720
    odd = cs.stream_plan(10_000, (-101, -1, 0, 1, 101), torch.float64, H100_SMS)
    assert odd.design == "wavefront" and odd.lag == 1126 and odd.ring % 2 == 0
    assert odd.ring >= odd.lag + odd.width + 101
    assert odd.grid == 10 and odd.slab == 1000
    assert cs.stream_plan(10_000, (-101, -1, 0, 1, 101), torch.float64, 7) == odd._replace(
        grid=7, slab=1430)


CASES = {"fd40": lambda: lap2d_fd(40), "3d8": lambda: lap3d_fd(8),
         "ref50": lambda: lap2d_reference(2500), "fd100": lambda: lap2d_fd(100)}
DTYPES = {"bf16": (BF16, None), "f32": (torch.float32, None), "f64": (torch.float64, None),
          "f32_bf16b": (torch.float32, BF16)}


@pytest.mark.parametrize("grid", [1, 3, 5])
@pytest.mark.parametrize("dtypes", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_bitwise(case, dtypes, grid):
    """Two launches of the walk: p, x, r', s' and w' bitwise the plain
    version's, the dots within 1e-12 (float64 sums in another order), k,
    stop and breakdown equal; the second from the plain version's
    scalars, on the other halves of the pairs. lap3d_fd(8) has 7
    diagonals and slabs shorter than 2R; lap2d_reference(2500) an odd
    reach (51); every grid has slab edges inside [0, n) and at its ends."""
    dia = CASES[case]()
    offs = tuple(dia.offsets)
    dtype, bands_dtype = DTYPES[dtypes]
    bands, st = _state(dia, dtype)
    if bands_dtype is not None:
        bands = bands.to(bands_dtype)
    n = dia.shape[0]
    plan = _small_plan(n, offs, dtype, grid)
    got, want = _clone(st), _clone(st)
    for _ in range(2):
        dots = walk(plan, bands, got, offsets=offs, **KW)
        cs._iteration_ref(bands, want.p, want.x, None, want.r, want.w, want.s, want.scal,
                          offsets=offs, **KW)
        for a, b in zip(got[:2] + got[3:6], want[:2] + want[3:6]):
            assert torch.equal(a, b)
        assert torch.equal(got.scal[cs.K:], want.scal[cs.K:])
        for i, d in enumerate(dots):
            assert abs(d - float(want.scal[i])) <= 1e-12 * abs(float(want.scal[i]))
        got.scal.copy_(want.scal)


def test_wrappers_on_cpu_take_any_plan():
    """On the CPU the split and stacked wrappers run the plain version in
    either design and count one launch an iteration; step passes the plan
    to the site."""
    dia = lap2d_fd(12)
    offs = tuple(dia.offsets)
    bands, st = _state(dia, torch.float32)
    n = dia.shape[0]
    before = (cs._stream_iteration.launches, cs._stream_iteration_stacked.launches)
    ref = _clone(st)
    for plan in (None, cs.grid_plan(n), cs.stream_plan(n, offs, torch.float32, 1)):
        cs.step(bands, st, offsets=offs, plan=plan, **KW)
        cs._iteration_ref(bands, ref.p, ref.x, None, ref.r, ref.w, ref.s, ref.scal,
                          offsets=offs, **KW)
    assert torch.equal(st.x, ref.x) and torch.equal(st.scal, ref.scal)
    rws = torch.stack([torch.stack([st.r[q], st.w[q], st.s[q]]) for q in range(2)])
    cs._stream_iteration_stacked(bands, st.p, st.x, rws, st.scal, offsets=offs,
                                 plan=cs.grid_plan(n), **KW)
    assert (cs._stream_iteration.launches, cs._stream_iteration_stacked.launches) == \
        (before[0] + 3, before[1] + 1)


def test_walk_solve_matches_cgx():
    """A whole solve of lap2d_fd(24), each iteration a walk over 3 slabs,
    from x0 = 0, against cgx's dia_cg_solve_stream in interpret mode on
    the same numpy inputs, within the gate of
    tests/test_torch_cg_stream.py::test_matches_cgx: k within one of
    cgx's, x within cgx's stream tolerances, and the true residual."""
    g = 24
    dia = cgx_lap2d_fd(g)
    offs, n = tuple(dia.offsets), g * g
    b = np.asarray(source_term(n), np.float32)
    bands = np.asarray(dia.bands, np.float32)
    tol = 1e-3 * float(np.linalg.norm(b.astype(np.float64)))
    want = cgx_stream(cgx.DiaOperator(jnp.asarray(bands), offs), jnp.asarray(b), tol=tol,
                      interpret=True, rows=8, cols=128)
    bt = torch.as_tensor(bands)
    st = cs.initial_state(bt, torch.as_tensor(b), tol, offsets=offs)
    plan = _small_plan(n, offs, torch.float32, 3)
    nearzero = float(torch.tensor(cgx_torch.config.NEARZERO, dtype=torch.float32))
    while walk(plan, bt, st, offsets=offs, tol=tol, nearzero=nearzero, maxiter=n) is not None:
        pass
    k = int(st.scal[cs.K])
    assert st.scal[cs.STOP] == 1.0 and math.sqrt(float(st.scal[cs.RR])) < tol
    assert abs(k - int(want.iterations)) <= 1
    wx = np.asarray(want.x, np.float64)
    np.testing.assert_allclose(st.x.numpy().astype(np.float64), wx, rtol=3e-3,
                               atol=1e-2 * np.abs(wx).max())
    x = st.x.numpy().astype(np.float64)
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-2

"""The schedule of the wavefront design of the streaming Neumann-PCG
iteration (cgx_torch/csrc/cg_stream.cu pcg_wave_kernel, site B6), on the
CPU: pcg_plan's choice of design at the main shapes, and a pure-torch
walk of the plan that forms each level the way the kernel does (c' at
the frontier L0 with the updates, u' at L1 and w' at L2, each R + W
rows behind the level below, from rings indexed modulo their lengths,
one barrier a step, the halo recomputed from r, w, s and the bands
only), against the plain version bitwise, and a whole solve driven by
the walk against cgx's streaming PCG in interpret mode.

The walk tags each ring slot with the row it holds and fails on a read
of any other row (a ring too short), on a write to a slot that a reader
uses in the same step (a race between the threads of one step on the
card), and on a read of u at a row this launch already rewrote."""

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
from cgx.mats.generators import source_term
from cgx.ops.cg_stream import dia_cg_solve_stream_pcg as cgx_stream_pcg
from cgx_torch.mats.generators import lap2d_fd, lap3d_fd
from cgx_torch.ops import cg_stream as cs

MAIN_N, MAIN_R, MAIN_OFFSETS = 10_240_000, 3200, (-3200, -1, 0, 1, 3200)  # lap2d_fd(3200)
H100_SMS = 132
KW = dict(tol=0.0, nearzero=1e-14, maxiter=10**6)


class Dots(NamedTuple):
    gamma: float
    delta: float
    rr: float


class Ring:
    """A level's ring of q values, each slot tagged with its row."""

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
    """sum_d band_d(row) * v[row + off_d] in offset order, v read from the
    ring, terms outside [0, n) skipped (dia_row's order and skips)."""
    acc = torch.zeros(rows.numel(), dtype=bw.dtype)
    for d, off in enumerate(offsets):
        j = rows + off
        ok = (j >= 0) & (j < n)
        xs = torch.zeros(rows.numel(), dtype=bw.dtype)
        xs[ok] = ring.get(j[ok])
        acc = torch.where(ok, acc + bw[d, rows] * xs, acc)
    return acc


def walk(plan, bands, st, *, offsets, tol, nearzero, maxiter, rings=None):
    """One launch of ``plan``'s wavefront on the state ``st`` (with u),
    in place as the kernel: p, x and u advanced, the other halves of the
    pairs written, the scalars rewritten from the blocks' float64
    partials summed in block order. Returns the dots, or None for a
    frozen launch."""
    sc = cs.step_scalars(st.scal, st.x.dtype, nearzero=nearzero, maxiter=maxiter)
    if sc is None:
        return None
    offsets = tuple(offsets)
    n, dtype = st.x.shape[0], st.x.dtype
    reach, w = max(abs(o) for o in offsets), plan.width
    lag1, lag2 = plan.lags[1], plan.lags[2]
    rings = plan.rings if rings is None else rings
    bw = bands.to(dtype)
    diag = bw[offsets.index(0)]
    q, alpha, beta = sc.q, sc.alpha, sc.beta
    r, wv, s = st.r[q], st.w[q], st.s[q]
    r_out, w_out, s_out = st.r[1 - q], st.w[1 - q], st.s[1 - q]
    u_written = torch.zeros(n, dtype=torch.bool)
    parts = []
    for b in range(plan.grid):
        t0, t1 = b * plan.slab, min(n, (b + 1) * plan.slab)
        g = dl = rr = torch.zeros((), dtype=torch.float64)
        if t0 < t1:
            lo0, hi0 = max(0, t0 - 2 * reach), min(n, t1 + 2 * reach)
            lo1, hi1 = max(0, t0 - reach), min(n, t1 + reach)
            f = lo0
            cr, ur, rq = (Ring(qq, dtype) for qq in rings)
            for t in range(math.ceil((t1 - f + lag2) / w)):
                for ring in (cr, ur, rq):
                    ring.read.zero_()
                a0 = f + t * w
                win = torch.arange(w)
                rows0 = a0 + win
                rows0 = rows0[(rows0 >= lo0) & (rows0 < hi0)]
                rows1 = a0 - lag1 + win
                rows1 = rows1[(rows1 >= lo1) & (rows1 < hi1)]
                rows2 = a0 - lag2 + win
                rows2 = rows2[(rows2 >= t0) & (rows2 < t1)]
                # L2: w' = A u' from the u' ring, delta'
                if rows2.numel():
                    un = ur.get(rows2)
                    wn = _taps(bw, rows2, offsets, n, ur)
                    w_out[rows2] = wn
                    dl = dl + torch.sum(wn.double() * un.double())
                # L1: u' = 2 c' - D^-1 A c' from the c' ring
                if rows1.numel():
                    cc = cr.get(rows1)
                    un1 = 2.0 * cc - (1.0 / diag[rows1]) * _taps(bw, rows1, offsets, n, cr)
                    own1 = (rows1 >= t0) & (rows1 < t1)
                    g = g + torch.sum(rq.get(rows1[own1]).double() * un1[own1].double())
                # L0: the updates at the slab's rows, c' = D^-1 r' everywhere
                if rows0.numel():
                    sn = wv[rows0] + beta * s[rows0]
                    rn = r[rows0] - alpha * sn
                    cn = (1.0 / diag[rows0]) * rn
                    own0 = (rows0 >= t0) & (rows0 < t1)
                    o = rows0[own0]
                    assert not u_written[o].any(), "u read after this launch rewrote it"
                    pn = st.u[o] + beta * st.p[o]
                    st.x[o] = st.x[o] + alpha * pn
                    st.p[o] = pn
                    r_out[o] = rn[own0]
                    s_out[o] = sn[own0]
                    rr = rr + torch.sum(rn[own0].double() * rn[own0].double())
                # the step's ring values, after every read of the step: one barrier
                if rows1.numel():
                    ur.put(rows1, un1)
                    st.u[rows1[own1]] = un1[own1]
                    u_written[rows1[own1]] = True
                if rows0.numel():
                    cr.put(rows0, cn)
                    rq.put(rows0, rn)
        parts.append((g, dl, rr))
    dots = Dots(*(float(sum(p[i] for p in parts)) for i in range(3)))
    cs.new_scalars(st.scal, sc, *dots, tol=tol)
    return dots


def _state(dia, dtype, seed=0):
    """Bands and cgx's start state from a seeded b, with a seeded x (as
    the kernel tests of tests/test_torch_wrappers.py)."""
    rng = np.random.default_rng(seed)
    bands = torch.as_tensor(dia.bands, dtype=dtype)
    b, x = (torch.as_tensor(rng.standard_normal(dia.shape[0]), dtype=dtype) for _ in range(2))
    st = cs.initial_state(bands, b, 0.0, offsets=tuple(dia.offsets), precond=True)
    st.x.copy_(x)
    return bands, st


def _clone(st):
    return cs.StreamState(st.p.clone(), st.x.clone(), st.u.clone(), st.r.clone(), st.w.clone(),
                          st.s.clone(), None, st.scal.clone())


def _small_plan(n, offsets, dtype, grid):
    """pcg_plan's wavefront on ``grid`` slabs (a small n takes fewer: the
    schedule holds for any slabs that cover [0, n))."""
    plan = cs.pcg_plan(n, tuple(offsets), dtype, grid)
    assert plan.design == "wavefront"
    return plan._replace(grid=grid, slab=-(-n // grid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_main_shape_plan(dtype):
    """N = 10,240,000, R = 3200 on 132 SMs: float32 and float64 both take
    the wavefront, one block an SM, W = 512, L1 and L2 R + W apart, rings
    of 7,424 (c'), 7,424 (u') and 4,224 (r') values: 19,072, 76,288 bytes
    in float32 and 152,576 in float64, inside the 227 KB a block may use.
    The iteration moves 17 N words; the halo adds 4R rows of r, w, s and
    the diagonal and 2R rows of the bands a slab: 43,929,600 bytes in
    float32 over 132 slabs."""
    plan = cs.pcg_plan(MAIN_N, MAIN_OFFSETS, dtype, H100_SMS)
    item = torch.finfo(dtype).bits // 8
    assert plan.design == "wavefront" and plan.launches == 1
    assert plan.width == 512 and plan.grid == H100_SMS
    assert plan.grid * plan.slab >= MAIN_N > (plan.grid - 1) * plan.slab
    assert plan.lags == (0, MAIN_R + 512, 2 * (MAIN_R + 512))
    assert plan.rings == (7424, 7424, 4224) and sum(plan.rings) == 19_072
    assert plan.ring_offsets == (0, 7424, 14_848)
    assert plan.shared == 19_072 * item == {4: 76_288, 8: 152_576}[item]
    assert plan.shared + cs.PCG_STATIC <= cs.SHARED_OPTIN <= 227 * 1024
    arg, n_arg = plan.as_arg()
    assert n_arg == 11 and list(arg) == [512, plan.slab, plan.shared, 3712, 7424, 7424, 7424,
                                         4224, 0, 7424, 14_848]
    must = (len(MAIN_OFFSETS) + 12) * MAIN_N * item
    halo = plan.grid * (4 * MAIN_R * 4 + 2 * MAIN_R * len(MAIN_OFFSETS)) * item
    assert must == {4: 696_320_000, 8: 1_392_640_000}[item]
    if dtype == torch.float32:
        assert halo == 43_929_600


def test_plan_seven_point_and_three_launches():
    """lap3d_fd(48) (7 diagonals, R = 2304) takes the wavefront in float64;
    where the rings outgrow a block (R = 8000 in float64: 344,576 bytes)
    the plan takes three launches, a block for each 1024 rows, and the
    wrapper on the CPU counts three."""
    dia = lap3d_fd(48)
    plan = cs.pcg_plan(dia.shape[0], tuple(dia.offsets), torch.float64, H100_SMS)
    assert plan.design == "wavefront" and plan.rings == (5632, 5632, 3328)
    assert plan.grid == 108 and plan.slab == 1024  # 110,592 rows: no slab under 1024 rows
    far = (-8000, -1, 0, 1, 8000)
    three = cs.pcg_plan(MAIN_N, far, torch.float64, H100_SMS)
    assert sum(cs.pcg_schedule(8000, 512)[1]) * 8 == 344_576 > cs.SHARED_OPTIN
    assert three == cs.three_plan(MAIN_N) and three.launches == 3
    assert three.grid == 10_000 and three.slab == cs.ROWS_PER_BLOCK
    assert cs.pcg_plan(MAIN_N, far, torch.float32, H100_SMS).design == "wavefront"

    bands, st = _state(lap2d_fd(12), torch.float32)
    before = cs._stream_iteration_pcg.launches
    cs.step(bands, st, offsets=(-12, -1, 0, 1, 12), plan=cs.three_plan(144), **KW)
    cs.step(bands, st, offsets=(-12, -1, 0, 1, 12), **KW)
    assert cs._stream_iteration_pcg.launches == before + 3 + 1


CASES = {"fd40": lambda: lap2d_fd(40), "3d8": lambda: lap3d_fd(8), "fd100": lambda: lap2d_fd(100)}


@pytest.mark.parametrize("grid", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_bitwise(case, dtype, grid):
    """One launch of the walk: p, x, u, r', s' and w' bitwise the plain
    version's, the dots within 1e-12 (float64 sums in another order), k,
    stop and breakdown equal. lap3d_fd(8) has 7 diagonals and slabs
    shorter than 4R (103 rows at R = 64 on 5 slabs); every grid has slab
    edges inside [0, n) and at its ends. A second launch, from the plain
    version's scalars (the dots' last bits move a float64 alpha), reads
    the other halves of the pairs."""
    dia = CASES[case]()
    offs = tuple(dia.offsets)
    bands, st = _state(dia, dtype)
    plan = _small_plan(dia.shape[0], offs, dtype, grid)
    got, want = _clone(st), _clone(st)
    for _ in range(2):
        got.scal.copy_(want.scal)
        walk(plan, bands, got, offsets=offs, **KW)
        cs._iteration_ref(bands, want.p, want.x, want.u, want.r, want.w, want.s, want.scal,
                          offsets=offs, **KW)
        for a, b in zip(got[:6], want[:6]):
            assert torch.equal(a, b)
        assert torch.equal(got.scal[cs.K:], want.scal[cs.K:])
        dots, ref = got.scal[:3], want.scal[:3]
        assert float(((dots - ref).abs() / ref.abs()).max()) <= 1e-12


def test_walk_frozen_changes_nothing():
    bands, st = _state(lap2d_fd(40), torch.float32)
    plan = _small_plan(1600, (-40, -1, 0, 1, 40), torch.float32, 3)
    st.scal[cs.STOP] = 1.0
    before = _clone(st)
    assert walk(plan, bands, st, offsets=(-40, -1, 0, 1, 40), **KW) is None
    for a, b in zip(st, before):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("ring", range(3))
def test_ring_one_step_short_fails(ring, grid):
    """Each ring is as short as its readers allow: one step (W values)
    less and the walk finds a row overwritten before its last read, or a
    slot rewritten in the step that reads it. lap2d_fd(64) is long enough
    for each level to reach its steady state."""
    dia = lap2d_fd(64)
    offs = tuple(dia.offsets)
    bands, st = _state(dia, torch.float32)
    plan = _small_plan(dia.shape[0], offs, torch.float32, grid)
    rings = list(plan.rings)
    rings[ring] -= plan.width
    with pytest.raises(AssertionError, match="overwritten|rewritten"):
        walk(plan, bands, st, offsets=offs, rings=tuple(rings), **KW)


def test_walk_solve_matches_cgx():
    """A whole Neumann-PCG solve of lap2d_fd(24), each iteration a walk
    over 3 slabs, from x0 = 0, against cgx's dia_cg_solve_stream_pcg in
    interpret mode on the same numpy inputs, within the gate of
    tests/test_torch_cg_stream.py::test_matches_cgx: k within one of
    cgx's, x within cgx's stream tolerances, and the true residual."""
    g = 24
    dia = cgx_lap2d_fd(g)
    offs, n = tuple(dia.offsets), g * g
    b = np.asarray(source_term(n), np.float32)
    bands = np.asarray(dia.bands, np.float32)
    tol = 1e-3 * float(np.linalg.norm(b.astype(np.float64)))
    want = cgx_stream_pcg(cgx.DiaOperator(jnp.asarray(bands), offs), jnp.asarray(b), tol=tol,
                          interpret=True, rows=8, cols=128)
    bt = torch.as_tensor(bands)
    st = cs.initial_state(bt, torch.as_tensor(b), tol, offsets=offs, precond=True)
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

"""The schedule of the wavefront design of the s-step basis kernels
(cgx_torch/csrc/sstep_basis.cuh gen_wave: the Gram and recover launches
of kernel B10, the matrix-powers kernel B9), on the CPU: basis_plan's
choice of design at the main shapes, the workspace it needs, and a
pure-torch walk of the plan that forms every level the way the kernels
do (rings indexed modulo their lengths, levels at the plan's lags, one
barrier a step) and runs each consumer at the frontier (the Gram's
products, the recover's combinations, B9's stores) against the plain
versions, bitwise, and cgx's own Gram.

The walk tags each ring slot with the row it holds and fails on a read
of any other row (a ring too short) and on a write to a slot that a
reader uses in the same step (a race between the threads of one step on
the card)."""

import math
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
from cgx_torch.mats.generators import lap2d_fd
from cgx_torch.ops import dia_powers as dp
from cgx_torch.ops import sstep_stream as ss
from cgx_torch.ops.dia_powers import dia_sstep_basis_ref

MAIN_N, MAIN_R, MAIN_OFFSETS = 10_240_000, 3200, (-3200, -1, 0, 1, 3200)  # lap2d_fd(3200)
H100_SMS = 132


class Walk(NamedTuple):
    formed: torch.Tensor  # (m, n): each slab row of each level as it is formed
    frontier: torch.Tensor  # (m, n): each slab row of each level as the frontier reads it
    gram: torch.Tensor  # G = V V^T in float64, summed at the frontier
    recovered: Optional[tuple]  # (x + sum xc_i V_i, sum d_i V_i, sum c_i V_i) at the frontier


def walk(plan, bands, p, r, *, offsets, s, theta, delta, shifts=(), rings=None, coef=None,
         x=None) -> Walk:
    """Run ``plan``'s wavefront in torch. ``coef`` (3, m) in the vectors'
    dtype and ``x``: the recover's combinations too."""
    n, m, dtype = p.shape[0], 2 * s + 1, p.dtype
    reach, w = max(abs(o) for o in offsets), plan.width
    rings = plan.rings if rings is None else rings
    bw = bands.to(dtype)
    th, dl, sg = (torch.tensor(v, dtype=dtype) for v in (theta, delta, delta / 2.0))
    sh = [torch.tensor(v, dtype=dtype) for v in shifts]
    formed, at_front = (torch.full((m, n), float("nan"), dtype=dtype) for _ in range(2))
    gram = torch.zeros(m, m, dtype=torch.float64)
    recovered = None if coef is None else tuple(torch.full((n,), float("nan"), dtype=dtype)
                                                for _ in range(3))
    for b in range(plan.grid):
        t0 = b * plan.slab
        if t0 >= n:
            break
        t1 = min(n, t0 + plan.slab)
        f0 = max(0, t0 - (s - 1) * reach)
        ring = [torch.full((q,), float("nan"), dtype=dtype) for q in rings]
        tag = [torch.full((q,), -1, dtype=torch.int64) for q in rings]
        for t in range(math.ceil((t1 - f0 + plan.lag_use) / w)):
            f = f0 + t * w
            read = [torch.zeros(q, dtype=torch.bool) for q in rings]

            def get(l, rows):
                slots = rows % rings[l]
                assert torch.equal(tag[l][slots], rows), f"level {l}: a row was overwritten"
                read[l][slots] = True
                return ring[l][slots]

            writes = []
            for l in range(m):
                k, cw = dp.level_of(l, s)
                v0 = p if l <= s else r
                grow = 0 if k == 0 else (cw - 1 - k) * reach
                rows = torch.arange(f - plan.lags[l], f - plan.lags[l] + w)
                rows = rows[(rows >= max(0, t0 - grow)) & (rows < min(n, t1 + grow))]
                if rows.numel() == 0:
                    continue
                if k == 0:
                    writes.append((l, rows, v0[rows]))
                    continue
                src = (lambda rr: v0[rr]) if k == 1 else (lambda rr, l=l: get(l - 1, rr))
                mv = torch.zeros(rows.numel(), dtype=dtype)
                for d, off in enumerate(offsets):  # dia_matvec_ref's terms, in offset order
                    j = rows + off
                    ok = (j >= 0) & (j < n)
                    xs = torch.zeros(rows.numel(), dtype=dtype)
                    xs[ok] = src(j[ok])
                    mv = mv + bw[d, rows] * xs
                tc = src(rows)
                if shifts:
                    val = (mv - sh[k - 1] * tc) / sg
                elif k == 1:
                    val = (mv - th * tc) / dl
                else:
                    to = v0[rows] if k == 2 else get(l - 2, rows)
                    val = 2.0 * (mv - th * tc) / dl - to
                writes.append((l, rows, val))
            rows = torch.arange(f - plan.lag_use, f - plan.lag_use + w)
            rows = rows[(rows >= t0) & (rows < t1)]
            if rows.numel():
                v = torch.stack([get(l, rows) for l in range(m)])
                at_front[:, rows] = v
                gram += v.double() @ v.double().T
                if coef is not None:  # in level order, as the plain recover
                    acc = [torch.zeros(rows.numel(), dtype=dtype) for _ in range(3)]
                    for l in range(m):
                        acc = [a + coef[c, l] * v[l] for c, a in enumerate(acc)]
                    recovered[0][rows] = x[rows] + acc[0]
                    recovered[1][rows] = acc[1]
                    recovered[2][rows] = acc[2]
            for l, rows, val in writes:  # after every read of the step: one barrier
                slots = rows % rings[l]
                assert not read[l][slots].any(), f"level {l}: a slot read in this step is rewritten"
                ring[l][slots] = val
                tag[l][slots] = rows
                own = (rows >= t0) & (rows < t1)
                formed[l, rows[own]] = val[own]
    return Walk(formed, at_front, gram, recovered)


def _case(g, s, basis, dtype=torch.float32):
    dia = lap2d_fd(g)
    n = dia.shape[0]
    rng = np.random.default_rng(g * 10 + s)
    bands = torch.as_tensor(dia.bands, dtype=dtype)
    p, r = (torch.as_tensor(rng.standard_normal(n), dtype=dtype) for _ in range(2))
    lmax = float(np.abs(dia.bands).sum(axis=0).max())
    lmin = lmax / (4.0 * g * g)
    shifts = tuple(lmin + (lmax - lmin) * (1 - math.cos(math.pi * (i + 0.5) / s)) / 2
                   for i in range(s)) if basis == "newton" else ()
    kw = dict(offsets=tuple(dia.offsets), s=s, theta=(lmax + lmin) / 2, delta=(lmax - lmin) / 2,
              shifts=shifts)
    return bands, p, r, kw


def _small_plan(n, kw, grid, dtype=torch.float32):
    plan = dp.basis_plan(n, kw["offsets"], kw["s"], dtype, grid, min_slab=64)
    assert plan.design == "wavefront" and plan.grid == grid
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_main_shape_plan(dtype):
    """N = 10,240,000, s = 4, R = 3200 on 132 SMs: float32 vectors (with
    float32 or bfloat16 bands: the rings hold vectors) take the wavefront
    within the 227 KB a block may use, one block an SM; float64 the slab
    design, two blocks an SM."""
    plan = dp.basis_plan(MAIN_N, MAIN_OFFSETS, 4, dtype, H100_SMS)
    assert plan.grid * plan.slab >= MAIN_N > (plan.grid - 1) * plan.slab
    if dtype == torch.float32:
        assert plan.design == "wavefront"
        assert plan.width == 512 and plan.grid == H100_SMS
        assert plan.shared == sum(plan.rings) * 4 == 192_000
        assert plan.shared + dp.WAVE_STATIC <= dp.SHARED_OPTIN <= 227 * 1024
        assert plan.lag_use == 3 * (MAIN_R + 512) + 512
        arg, n_arg = plan.as_arg()
        assert n_arg == 4 + 3 * 9 and list(arg)[:4] == [512, plan.lag_use, plan.slab, 192_000]
    else:
        assert plan.design == "slab" and plan.grid == 2 * H100_SMS
        rings = dp.wave_schedule(4, MAIN_R, dp.WAVE_THREADS)[2]
        assert sum(rings) * 8 == 384_000 > dp.SHARED_OPTIN


@pytest.mark.parametrize("s,design", [(1, "wavefront"), (4, "wavefront"), (5, "slab"),
                                      (8, "slab")])
def test_plan_rule_in_s(s, design):
    """Beyond s = 4 the 2s+1 levels' sums outgrow a thread's registers."""
    assert dp.basis_plan(MAIN_N, (-40, -1, 0, 1, 40), s, torch.float32, H100_SMS).design == design


def test_plan_rings_are_contiguous_and_cover_their_readers():
    plan = dp.basis_plan(MAIN_N, MAIN_OFFSETS, 4, torch.float32, H100_SMS)
    ends = np.cumsum(plan.rings)
    assert plan.ring_offsets == (0, *map(int, ends[:-1]))
    w, lags = plan.width, plan.lags
    for l in range(9):
        k, cw = dp.level_of(l, 4)
        assert plan.rings[l] >= plan.lag_use - lags[l] + w  # the Gram's window
        if 1 <= k < cw - 1:  # the next level's stencil
            assert plan.rings[l] >= lags[l + 1] + MAIN_R - lags[l] + w
            assert lags[l + 1] - lags[l] == MAIN_R + w
    assert lags[4] == lags[8] == plan.lag_use - w  # both chains' tops feed the Gram together


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("basis", ["chebyshev", "newton"])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("g", [24, 40])
def test_walk_levels_bitwise_and_gram(g, s, basis, grid):
    """Every level of the walk is bitwise the plain basis; G within 1e-12
    of sum |v_i v_j| of the plain Gram launch's."""
    bands, p, r, kw = _case(g, s, basis)
    plan = _small_plan(p.shape[0], kw, grid)
    wk = walk(plan, bands, p, r, **kw)
    gram = wk.gram
    want = dia_sstep_basis_ref(bands, p, r, **kw)
    assert torch.equal(wk.formed, want) and torch.equal(wk.frontier, want)
    st = ss.initial_state(bands, r, torch.zeros_like(r), 0.0, **kw)
    st.p[0].copy_(p)
    ss._gram_ref(bands, st.p, st.r, st.state, st.bmat, tol=0.0, nearzero=1e-14, maxiter=10**6,
                 **kw)
    m = 2 * s + 1
    v = want.double()
    scale = v.abs() @ v.abs().T
    g_ref = st.state[ss.GRAM:ss.GRAM + m * m].view(m, m)
    assert float(((gram - g_ref).abs() / scale).max()) <= 1e-12


@pytest.mark.parametrize("g", [24, 40])
def test_walk_float64_and_bf16_bands(g):
    """The schedule is the same for any band and vector storage."""
    dia = lap2d_fd(g)
    for dtype, bdtype in ((torch.float64, torch.float64), (torch.float32, torch.bfloat16)):
        bands, p, r, kw = _case(g, 4, "chebyshev", dtype)
        kb = bands.to(bdtype)
        plan = _small_plan(dia.shape[0], kw, 3, dtype=dtype)
        assert torch.equal(walk(plan, kb, p, r, **kw).formed, dia_sstep_basis_ref(kb, p, r, **kw))


@pytest.mark.parametrize("level", range(9))
def test_ring_one_step_short_fails(level):
    """Each ring is as short as its readers allow: one step (W values)
    less and the walk finds a row overwritten before its last read. The
    slab of lap2d_fd(64) is long enough for every level to reach its
    steady state."""
    bands, p, r, kw = _case(64, 4, "chebyshev")
    plan = _small_plan(p.shape[0], kw, 1)
    rings = list(plan.rings)
    rings[level] -= plan.width
    with pytest.raises(AssertionError, match="overwritten|rewritten"):
        walk(plan, bands, p, r, rings=tuple(rings), **kw)


def test_walk_gram_matches_cgx():
    """The walk's G of lap2d_fd(47) over 3 slabs against cgx's Gram kernel
    in interpret mode on the same numpy inputs, at cgx's double-float32
    accuracy (2e-5 of the scale, as tests/test_torch_sstep_stream.py)."""
    import jax.numpy as jnp

    from cgx.ops.dia_powers import _powers_geometry, sstep_powers_band_planes
    from cgx.ops.sstep_stream import _sstep_gram as cgx_gram

    s, g, theta, delta = 4, 47, 4.0, 3.9
    dia = cgx_lap2d_fd(g)
    n, offsets = g * g, tuple(dia.offsets)
    rng = np.random.default_rng(0)
    p, r = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    bands = np.asarray(dia.bands, np.float32)
    rows, cols = 8, 128
    n_p, _, _, _, pm, _ = _powers_geometry(offsets, s, rows, cols, jnp.float32, n)

    def plane(v):
        return jnp.pad(jnp.asarray(v), (pm * cols, pm * cols + (n_p - n))).reshape(-1, cols)

    g2 = np.asarray(cgx_gram(sstep_powers_band_planes(jnp.asarray(bands), offsets=offsets, s=s,
                                                      rows=rows, cols=cols),
                             plane(p), plane(r), offsets=offsets, s=s, theta=theta, delta=delta,
                             shifts=(), rows=rows, cols=cols, interpret=True), np.float64)
    want = g2[0] + g2[1]
    kw = dict(offsets=offsets, s=s, theta=theta, delta=delta)
    plan = _small_plan(n, kw, 3)
    got = walk(plan, torch.as_tensor(bands), torch.as_tensor(p), torch.as_tensor(r), **kw).gram
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.max(np.abs(want)))


# (vector dtype, band dtype) of the consumers' walks: float64 throughout, and
# float32 vectors under bfloat16 bands (the fused route's storage)
CONSUMER_CASES = {"f64": (torch.float64, torch.float64), "bf16": (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("case", sorted(CONSUMER_CASES))
@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("basis", ["chebyshev", "newton"])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("g", [24, 40])
def test_walk_recover_and_stores_bitwise(g, s, basis, grid, case):
    """The recover's consumer on the walked schedule gives x + sum xc_i V_i,
    sum d_i V_i and sum c_i V_i bitwise the plain recover launch's (from
    the plain Gram launch's coefficients and a seeded x); B9's stores from
    the rings at the frontier give the plain basis bitwise, as do the
    levels as they are formed."""
    dtype, bdtype = CONSUMER_CASES[case]
    bands, p, r, kw = _case(g, s, basis, dtype)
    kb = bands.to(bdtype)
    n, m = p.shape[0], 2 * s + 1
    st = ss.initial_state(kb.to(dtype), r, torch.zeros_like(r), 0.0, **kw)
    st.p[0].copy_(p)
    st.x.copy_(torch.as_tensor(np.random.default_rng(g + s).standard_normal(n), dtype=dtype))
    ss._gram_ref(kb, st.p, st.r, st.state, st.bmat, tol=0.0, nearzero=1e-14, maxiter=10**6, **kw)
    coef = st.state[ss.COEF:ss.COEF + 3 * m].view(3, m).to(dtype)
    plan = _small_plan(n, kw, grid, dtype=dtype)
    wk = walk(plan, kb, p, r, coef=coef, x=st.x.clone(), **kw)
    ss._recover_ref(kb, st.p, st.r, st.x, st.state, **kw)
    for got, want in zip(wk.recovered, (st.x, st.r[1], st.p[1])):
        assert torch.equal(got, want)
    basis_ref = dia_sstep_basis_ref(kb, p, r, **kw)
    assert torch.equal(wk.frontier, basis_ref) and torch.equal(wk.formed, basis_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 5])
def test_plan_rule_at_main_reach(s, dtype):
    """At R = 3200 on 132 SMs: float32 vectors take the wavefront for
    s <= 4, float64 ones for s <= 3 (s = 4 needs 384,000 bytes of rings);
    s = 5 takes the slab design. B9 and both launches of the fused block
    read this one plan."""
    plan = dp.basis_plan(MAIN_N, MAIN_OFFSETS, s, dtype, H100_SMS)
    item = torch.finfo(dtype).bits // 8
    fits = s <= 4 and (dtype == torch.float32 or s <= 3)
    assert plan.design == ("wavefront" if fits else "slab")
    if fits:
        assert plan.grid == H100_SMS and plan.shared == sum(plan.rings) * item
    else:
        assert plan.grid == 2 * H100_SMS and plan.rings == ()


@pytest.mark.parametrize("consumer", ["recover", "stores"])
@pytest.mark.parametrize("level", range(9))
def test_ring_one_step_short_fails_for_each_consumer(level, consumer):
    """The recover's combinations and B9's stores read at the Gram's
    frontier, so the Gram's rings serve them as they are and no shorter:
    one step (W values) off any ring and the walk finds a row overwritten
    before its last read."""
    bands, p, r, kw = _case(64, 4, "chebyshev")
    plan = _small_plan(p.shape[0], kw, 1)
    rings = list(plan.rings)
    rings[level] -= plan.width
    extra = {}
    if consumer == "recover":
        extra = dict(coef=torch.ones(3, 9), x=torch.zeros_like(p))
    with pytest.raises(AssertionError, match="overwritten|rewritten"):
        walk(plan, bands, p, r, rings=tuple(rings), **extra, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_workspace_values_at_main_shapes(dtype):
    """The fused block's workspace is a function of (n, offsets, s, dtype,
    SMs): at N = 10,240,000, s = 4, R = 3200 the float32 wavefront needs no
    scratch, only the 132 blocks' Gram partials; the float64 slab design
    keeps each of its 264 blocks' two working levels and nine slab levels
    (slabs of 38,788 rows). Forcing the slab design on float32 takes the
    491,111,808 bytes the wavefront no longer needs."""
    slab_values = 264 * (2 * (38_788 + 6 * MAIN_R) + 9 * 38_788)
    plan = dp.basis_plan(MAIN_N, MAIN_OFFSETS, 4, dtype, H100_SMS)
    want = (0, 132 * 45) if dtype == torch.float32 else (slab_values, 264 * 45)
    assert ss.workspace_values(plan, MAIN_OFFSETS, 4) == want
    forced = dp.slab_plan(MAIN_N, 4, dtype, H100_SMS)
    assert ss.workspace_values(forced, MAIN_OFFSETS, 4) == (slab_values, 264 * 45)
    if dtype == torch.float32:
        assert slab_values * 4 == 491_111_808

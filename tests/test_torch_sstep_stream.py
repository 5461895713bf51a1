"""cgx_torch's fused streaming s-step block (kernels B10 and the replay
kernel, here through their plain versions) against cgx's
dia_sstep_stream_solve and _sstep_gram in interpret mode, on the same
numpy inputs (mirrors tests/test_sstep_stream.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd, lap3d_fd, source_term
from cgx.ops.dia_powers import _powers_geometry, sstep_powers_band_planes
from cgx.ops.sstep_stream import _sstep_gram as cgx_gram
from cgx.ops.sstep_stream import dia_sstep_stream_solve as cgx_fused
from cgx.solver.sstep import _basis_matrix as cgx_bmat
from cgx.solver.sstep import replay_block as cgx_replay
from cgx_torch.ops import sstep_stream as ss
from cgx_torch.solver.sstep import sstep_cg_solve

THETA, DELTA = 4.0, 3.9


def _ops(dia, bands=None, dtype=np.float32):
    bands = np.asarray(dia.bands if bands is None else bands, dtype)
    return (cgx.DiaOperator(jnp.asarray(bands), tuple(dia.offsets)),
            cgx_torch.operator_from_numpy(bands, dia.offsets, device="cpu"))


def _rel(dia, x, b):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b))


def _fresh_state(bands, p, r, s, offsets):
    """A live block's operands: p and r in half 0 of their pairs."""
    st = ss.initial_state(bands, r, torch.zeros_like(r), 0.0, offsets=offsets, s=s, theta=THETA,
                          delta=DELTA)
    st.p[0].copy_(p)
    st.r[0].copy_(r)
    return st


def test_gram_matches_cgx():
    """The Gram launch's G against cgx's double-f32 Gram over 3 of its
    (8, 128) blocks, the last ragged (cgx's 2e-5 of the scale), and
    against the float64 products of the same basis (1e-12); G lands in
    the state, symmetric."""
    s, g = 4, 47
    dia = lap2d_fd(g)
    n = g * g
    rng = np.random.default_rng(0)
    p, r = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    bands = np.asarray(dia.bands, np.float32)
    offsets = tuple(dia.offsets)
    rows, cols = 8, 128
    n_p, _, _, _, pm, _ = _powers_geometry(offsets, s, rows, cols, jnp.float32, n)

    def plane(v):
        return jnp.pad(jnp.asarray(v), (pm * cols, pm * cols + (n_p - n))).reshape(-1, cols)

    g2 = np.asarray(cgx_gram(sstep_powers_band_planes(jnp.asarray(bands), offsets=offsets, s=s,
                                                      rows=rows, cols=cols),
                             plane(p), plane(r), offsets=offsets, s=s, theta=THETA, delta=DELTA,
                             shifts=(), rows=rows, cols=cols, interpret=True), np.float64)
    want = g2[0] + g2[1]
    tb = torch.as_tensor(bands)
    st = _fresh_state(tb, torch.as_tensor(p), torch.as_tensor(r), s, offsets)
    ss._sstep_gram(tb, st.p, st.r, st.state, st.bmat, offsets=offsets, s=s, theta=THETA,
                   delta=DELTA, tol=0.0, nearzero=1e-14, maxiter=10**6)
    m = 2 * s + 1
    got = st.state[ss.GRAM:ss.GRAM + m * m].view(m, m).numpy()
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    v = ss.dia_sstep_basis_ref(tb, torch.as_tensor(p), torch.as_tensor(r), offsets=offsets, s=s,
                               theta=THETA, delta=DELTA).double()
    exact = (v @ v.T).numpy()
    assert np.max(np.abs(got - exact) / (v.abs() @ v.abs().T).numpy()) <= 1e-12
    assert np.array_equal(got, got.T) and float(st.state[ss.LIVE]) == 1.0


@pytest.mark.parametrize("g,s,rows", [(32, 4, 8), (33, 3, 8), (48, 6, 16)])
def test_stream_solve_matches_cgx(g, s, rows):
    """cgx's cases (tests/test_sstep_stream.py:72-96), with a tail-padded
    size: converged, true residual under 3e-3; for s <= 4 k within s of
    cgx's and x within 2e-3 of max|x| (at s = 6 the fp32
    replay amplifies reassociation noise, and cgx asserts quality only)."""
    dia = lap2d_fd(g)
    cop, op = _ops(dia)
    b = np.asarray(source_term(g * g), np.float32)
    tol = 1e-3 * float(np.linalg.norm(b))
    got = cgx_torch.dia_sstep_stream_solve(op, b, s=s, tol=tol, maxiter=4000, rows=rows,
                                           cols=128, device="cpu")
    assert bool(got.converged) and not bool(got.breakdown)
    assert got.x.dtype == torch.float32 and got.iterations.dtype == torch.int32
    assert _rel(dia, got.x.numpy(), b) < 3e-3
    if s <= 4:
        # cgx's fused kernels interpreted at s = 4; at s = 3 its s-step loop,
        # which cgx's own test holds them to
        want = (cgx_fused(cop, jnp.asarray(b), s=s, tol=tol, maxiter=4000, rows=rows, cols=128,
                          interpret=True) if s == 4 else
                cgx.solver.sstep.sstep_cg_solve(cop, jnp.asarray(b), s=s, tol=tol, maxiter=4000))
        assert bool(want.converged)
        assert abs(int(got.iterations) - int(want.iterations)) <= s
        wx = np.asarray(want.x)
        np.testing.assert_allclose(got.x.numpy(), wx, rtol=0, atol=2e-3 * np.abs(wx).max())


def test_stream_solve_follows_the_float64_loop():
    """The fused block's arithmetic is sstep_cg_loop's with a float64 Gram
    and replay: the same count within s (the recovery sums in level order
    where the loop multiplies a matrix), the same quality."""
    dia = lap2d_fd(40)
    _, op = _ops(dia)
    b = np.asarray(source_term(1600), np.float32)
    kw = dict(s=4, tol=1e-4 * float(np.linalg.norm(b)), maxiter=4000, device="cpu")
    fused = cgx_torch.dia_sstep_stream_solve(op, b, **kw)
    loop = sstep_cg_solve(op, b, powers="off", gram_precision=torch.float64, **kw)
    assert bool(fused.converged) and bool(loop.converged)
    assert abs(int(fused.iterations) - int(loop.iterations)) <= 4
    assert abs(_rel(dia, fused.x.numpy(), b) - _rel(dia, loop.x.numpy(), b)) < 1e-3


def test_newton_basis_and_warm_start():
    dia = lap2d_fd(32)
    cop, op = _ops(dia)
    b = np.asarray(source_term(1024), np.float32)
    bn = float(np.linalg.norm(b))
    kw = dict(s=4, maxiter=4000, rows=8, cols=128)
    newton = cgx_torch.dia_sstep_stream_solve(op, b, tol=1e-3 * bn, basis="newton",
                                              device="cpu", **kw)
    want = cgx.solver.sstep.sstep_cg_solve(cop, jnp.asarray(b), s=4, tol=1e-3 * bn,
                                           maxiter=4000, basis="newton")
    assert bool(newton.converged) and _rel(dia, newton.x.numpy(), b) < 3e-3
    assert abs(int(newton.iterations) - int(want.iterations)) <= 4
    full = cgx_torch.dia_sstep_stream_solve(op, b, tol=1e-4 * bn, device="cpu", **kw)
    warm = cgx_torch.dia_sstep_stream_solve(op, b, full.x, tol=1e-3 * bn, device="cpu", **kw)
    assert bool(warm.converged) and int(warm.iterations) == 0
    zero = cgx_torch.dia_sstep_stream_solve(op, np.zeros(1024, np.float32), device="cpu", **kw)
    assert bool(zero.converged) and int(zero.iterations) == 0 and not zero.x.any()


def test_large_offsets():
    """lap3d_fd(12): offsets +-144 beyond cgx's tile, where cgx auto-grows
    rows; the ping-pong halves have no such hazard. Against the count of
    cgx's s-step loop, as cgx's own test holds its kernels."""
    dia = lap3d_fd(12)
    cop, op = _ops(dia)
    b = np.random.default_rng(3).standard_normal(1728).astype(np.float32)
    tol = 1e-3 * float(np.linalg.norm(b))
    kw = dict(s=2, tol=tol, maxiter=4000)
    want = cgx.solver.sstep.sstep_cg_solve(cop, jnp.asarray(b), **kw)
    got = cgx_torch.dia_sstep_stream_solve(op, b, rows=8, cols=128, device="cpu", **kw)
    assert bool(got.converged) and _rel(dia, got.x.numpy(), b) < 3e-3
    assert abs(int(got.iterations) - int(want.iterations)) <= 2


def test_bands_dtype_auto_bitwise_and_gate():
    """"auto" streams bf16 bands only when the round trip is exact, and
    then the solve is bitwise the float32-band one; an inexact operator
    keeps float32 bands (cgx test_sstep_stream.py:240-279)."""
    dia = lap2d_fd(40)
    _, op = _ops(dia)
    b = np.asarray(source_term(1600), np.float32)
    kw = dict(s=4, tol=1e-3 * float(np.linalg.norm(b)), maxiter=2000, device="cpu")
    before = ss._sstep_gram.launches
    auto = cgx_torch.dia_sstep_stream_solve(op, b, bands_dtype="auto", **kw)
    assert ss._sstep_gram.bands_dtype == torch.bfloat16 and ss._sstep_gram.launches > before
    f32 = cgx_torch.dia_sstep_stream_solve(op, b, bands_dtype=None, **kw)
    assert ss._sstep_gram.bands_dtype == torch.float32
    assert int(auto.iterations) == int(f32.iterations) and torch.equal(auto.x, f32.x)
    _, op2 = _ops(dia, np.asarray(dia.bands, np.float32) * np.float32(1.0 + 2.0 ** -12))
    auto2 = cgx_torch.dia_sstep_stream_solve(op2, b, bands_dtype="auto", **kw)
    assert ss._sstep_gram.bands_dtype == torch.float32
    f32_2 = cgx_torch.dia_sstep_stream_solve(op2, b, bands_dtype=None, **kw)
    assert torch.equal(auto2.x, f32_2.x)


def test_float64_runs_to_the_reference_gate():
    """cgx's TPU kernels refuse float64; the port's run it: at tol 1e-10
    the count within s of the plain float64 loop, true residual < 1e-11."""
    dia = lap2d_fd(24)
    _, op = _ops(dia, dtype=np.float64)
    b = source_term(576)
    got = cgx_torch.dia_sstep_stream_solve(op, b, s=4, tol=1e-10, device="cpu")
    plain = sstep_cg_solve(op, b, s=4, tol=1e-10, device="cpu")
    assert bool(got.converged) and got.x.dtype == torch.float64
    assert abs(int(got.iterations) - int(plain.iterations)) <= 4
    assert _rel(dia, got.x.numpy(), b) < 1e-11


def test_replay_matches_cgx_in_float64():
    """The plain replay (sstep_replay on the CPU) against cgx's
    replay_block on the same float64 Gram of a real basis."""
    s, m = 4, 9
    dia = lap2d_fd(24)
    rng = np.random.default_rng(1)
    p = torch.as_tensor(rng.standard_normal(576))
    v = ss.dia_sstep_basis_ref(torch.as_tensor(dia.bands), p, p, offsets=dia.offsets, s=s,
                               theta=THETA, delta=DELTA)
    g = (v @ v.T).numpy()
    st = torch.zeros(ss.STATE_LEN, dtype=torch.float64)
    st[ss.GRAM:ss.GRAM + m * m] = torch.as_tensor(g.reshape(-1))
    st[ss.RSNEW] = float(g[s + 1, s + 1])
    bmat = torch.as_tensor(cgx_bmat(s, THETA, DELTA, np.float64))
    before = ss.sstep_replay.launches
    ss.sstep_replay(st, bmat, s=s, tol=1e-6, nearzero=1e-14, maxiter=100)
    assert ss.sstep_replay.launches == before + 1
    want = cgx_replay(jnp.asarray(g), jnp.asarray(bmat.numpy()), s, jnp.asarray(0),
                      jnp.asarray(g[s + 1, s + 1]), jnp.asarray(False), jnp.asarray(False),
                      tol=jnp.asarray(1e-6), nearzero=jnp.asarray(1e-14), maxiter=100)
    coef = st[ss.COEF:ss.COEF + 3 * m].numpy()
    wcoef = np.concatenate([np.asarray(w) for w in want[:3]])
    np.testing.assert_allclose(coef, wcoef, rtol=1e-12, atol=1e-12 * np.abs(wcoef).max())
    assert int(st[ss.K]) == int(want[3]) == 4
    assert float(st[ss.RSOLD]) == pytest.approx(float(want[4]), rel=1e-12)


def test_frozen_block_changes_nothing(monkeypatch):
    """After the stop a block is a Gram launch that does nothing and a
    recover launch that does nothing, both counted; no kernel is built
    for CPU tensors."""
    import cgx_torch._build as build

    def no_build():
        raise AssertionError("a CPU call must not build the CUDA kernels")

    monkeypatch.setattr(build, "load", no_build)
    dia = lap2d_fd(16)
    bands = torch.as_tensor(np.asarray(dia.bands, np.float32))
    b = torch.as_tensor(np.asarray(source_term(256), np.float32))
    kw = dict(offsets=dia.offsets, s=2, theta=THETA, delta=DELTA, tol=1e-2, nearzero=1e-14,
              maxiter=10**6)
    st = ss.initial_state(bands, b, torch.zeros_like(b), 1e-2, offsets=dia.offsets, s=2,
                          theta=THETA, delta=DELTA)
    st.state[ss.CONV] = 1.0
    snap = [t.clone() for t in st[:4]]
    counts = ss._sstep_gram.launches, ss._sstep_recover.launches
    ss.block(bands, st, **kw)
    assert all(torch.equal(a, c) for a, c in zip(st[:4], snap))
    assert (ss._sstep_gram.launches, ss._sstep_recover.launches) == (counts[0] + 1,
                                                                      counts[1] + 1)
    st.state[ss.CONV] = 0.0
    ss.block(bands, st, **kw)  # a live block advances the parity and clears the mark
    assert float(st.state[ss.BLK]) == 1.0 and float(st.state[ss.LIVE]) == 0.0
    assert torch.equal(st.p[0], snap[1][0]) and not torch.equal(st.p[1], snap[1][1])


def test_input_validation():
    dia = lap2d_fd(16)
    _, op = _ops(dia)
    b = np.asarray(source_term(256), np.float32)
    with pytest.raises(TypeError, match="DiaOperator"):
        cgx_torch.dia_sstep_stream_solve(torch.eye(4), np.ones(4, np.float32), device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        cgx_torch.dia_sstep_stream_solve(op, b, cols=100, device="cpu")
    with pytest.raises(ValueError, match="basis"):
        cgx_torch.dia_sstep_stream_solve(op, b, basis="monomial", device="cpu")
    with pytest.raises(ValueError, match="spectral bounds"):
        cgx_torch.dia_sstep_stream_solve(op, b, bounds=(1.0, 0.5), device="cpu")
    with pytest.raises(TypeError):
        cgx_torch.dia_sstep_stream_solve(op, b.astype(np.float64), device="cpu")
    bands = op.bands
    st = ss.initial_state(bands, torch.as_tensor(b), torch.zeros(256), 0.0, offsets=dia.offsets,
                          s=2, theta=THETA, delta=DELTA)
    kw = dict(offsets=dia.offsets, s=2, theta=THETA, delta=DELTA)
    with pytest.raises(ValueError, match="state"):
        ss._sstep_recover(bands, st.p, st.r, st.x, st.state[:-1], **kw)
    with pytest.raises(ValueError, match="ping-pong"):
        ss._sstep_recover(bands, st.p[0], st.r, st.x, st.state, **kw)
    with pytest.raises(ValueError, match="bmat"):
        ss._sstep_gram(bands, st.p, st.r, st.state, st.bmat[:3], tol=0.0, nearzero=1e-14,
                       maxiter=10, **kw)

"""cgx_torch's s-step CG (solver/sstep.py, solver/chebyshev.py's bounds,
ops/tw32.py) against cgx's on the same numpy inputs, on the CPU: the
Lanczos bounds and the basis pieces bit for bit, the loop in cgx's
arithmetic within cgx's tolerances, the fallback, the prescale and the
routing of solve(method="sstep") (mirrors tests/test_sstep.py)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd, lap2d_reference, source_term
from cgx.ops import tw32 as cgx_tw32
from cgx.solver import chebyshev as cgx_cheb
from cgx.solver import sstep as cgx_sstep
from cgx_torch import SolveConfig
from cgx_torch.ops import sstep_stream, tw32
from cgx_torch.solver import api, chebyshev, sstep


def _ops(dia, dtype=np.float32):
    bands = np.asarray(dia.bands, dtype)
    return (cgx.DiaOperator(jnp.asarray(bands), tuple(dia.offsets)),
            cgx_torch.operator_from_numpy(bands, dia.offsets, device="cpu"))


def _rel(dia, x, b):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b))


@pytest.mark.parametrize("make", [lambda: lap2d_fd(24), lambda: lap2d_reference(300)],
                         ids=["fd24", "ref300"])
def test_lanczos_bounds_bit_for_bit(make):
    """The host path is cgx's code: the same (lmin, lmax) to the bit; the
    card's path (run here on CPU tensors) agrees to 1e-12 relative; the
    Newton shifts are cgx's."""
    dia = make()
    n = dia.shape[0]
    cop, op = _ops(dia)
    assert chebyshev.spectral_bounds(op, n) == cgx_cheb.spectral_bounds(cop, n)
    port_dia = cgx_torch.DIAMatrix(dia.shape, tuple(dia.offsets), np.asarray(dia.bands))
    assert chebyshev.gershgorin_bounds(port_dia) == cgx_cheb.gershgorin_bounds(dia)
    host = chebyshev.lanczos_bounds(chebyshev.host_matvec(op), n)
    card = chebyshev.lanczos_bounds(chebyshev.device_matvec(op), n, device=torch.device("cpu"))
    assert max(abs(a - c) / abs(c) for a, c in zip(card, host)) <= 1e-12
    bounds = cgx_cheb.spectral_bounds(cop, n)
    assert sstep.newton_shifts(op, n, 4, bounds) == cgx_sstep.newton_shifts(cop, n, 4, bounds)


def test_leja_order_and_basis_matrix_match_cgx():
    rng = np.random.default_rng(0)
    for size in (0, 1, 5, 16):
        vals = rng.uniform(-3, 9, size)
        assert np.array_equal(sstep.leja_order(vals), cgx_sstep.leja_order(vals))
    for s in range(1, 7):
        shifts = tuple(cgx_sstep.leja_order(rng.uniform(0.1, 8, s)))
        for sh in ((), shifts):
            assert np.array_equal(sstep._basis_matrix(s, 4.1, 3.7, np.float64, sh),
                                  cgx_sstep._basis_matrix(s, 4.1, 3.7, np.float64, sh))


def test_tw32_matches_cgx_and_is_exact():
    """two_sum32 and two_prod32 bit for bit against cgx's, and exact:
    s + e and p + e equal the float64 sum and product."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(4096) * 2.0 ** rng.integers(-40, 40, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096) * 2.0 ** rng.integers(-40, 40, 4096)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for ours, theirs, exact in ((tw32.two_sum32, cgx_tw32.two_sum32, a.astype(np.float64) + b),
                                (tw32.two_prod32, cgx_tw32.two_prod32,
                                 a.astype(np.float64) * b)):
        got = [t.numpy() for t in ours(ta, tb)]
        want = [np.asarray(t) for t in theirs(jnp.asarray(a), jnp.asarray(b))]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert np.array_equal(got[0].astype(np.float64) + got[1], exact)


def test_qf_comp_under_cancellation():
    """The compensated float32 form keeps float32 accuracy relative to its
    result through heavy cancellation, as cgx's (test_sstep_stream.py:205)."""
    rng = np.random.default_rng(0)
    m = 9
    for _ in range(4):
        g = (rng.standard_normal((m, m)) * 1e20).astype(np.float32)
        g = (g + g.T) / 2
        a = rng.standard_normal(m).astype(np.float32)
        gl, al = np.asarray(g, np.longdouble), np.asarray(a, np.longdouble)
        v = gl @ al
        b = (al - (al @ v / (v @ v)) * v * (1 - 1e-6)).astype(np.float32)
        ref = float(al @ gl @ np.asarray(b, np.longdouble))
        got = float(sstep._qf_comp(torch.as_tensor(a), torch.as_tensor(g), torch.as_tensor(b)))
        want = float(cgx_sstep._qf_comp(jnp.asarray(a), jnp.asarray(g), jnp.asarray(b)))
        assert abs(got - ref) <= 1e-5 * abs(ref) and abs(want - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize(
    "s,powers,replace",
    [(1, "off", 0), (4, "off", 0), (4, "interpret", 0), (4, "off", 1)],
    ids=["s1", "s4", "s4-powers", "s4-replace"],
)
def test_fp32_matches_cgx(s, powers, replace):
    """fp32 on lap2d_reference(400) at 1e-3 ||b||, where the recursive
    residual still tracks the true one in float32 (below it the counts of
    either package wander by tens): k within s of cgx's, x within 2e-3 of
    max|x|. "off" is cgx's arithmetic; "interpret" runs B9's plain version
    with the kernels' float64 Gram and replay, against cgx's interpreted
    powers kernel."""
    dia = lap2d_reference(400)
    cop, op = _ops(dia)
    b = np.asarray(source_term(400), np.float32)
    bounds = cgx_cheb.spectral_bounds(cop, 400)
    kw = dict(s=s, tol=1e-3 * float(np.linalg.norm(b)), bounds=bounds, replace_every=replace,
              powers=powers)
    want = cgx_sstep.sstep_cg_solve(cop, jnp.asarray(b), powers_block=(8, 128), **kw)
    got = sstep.sstep_cg_solve(op, b, device="cpu", **kw)
    assert bool(got.converged) and bool(want.converged) and not bool(got.breakdown)
    assert abs(int(got.iterations) - int(want.iterations)) <= s
    wx = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), wx, rtol=0, atol=2e-3 * np.abs(wx).max())
    assert _rel(dia, got.x.numpy(), source_term(400)) < 3e-3


def test_fp64_trajectory_at_the_reference_tolerance():
    """fp64 at tol 1e-10 (cgx test_sstep.py:25-49): k within s of cgx's,
    x to 1e-8, the reference's quality gate."""
    dia = lap2d_reference(400)
    cop, op = _ops(dia, np.float64)
    b = source_term(400)
    want = cgx_sstep.sstep_cg_solve(cop, jnp.asarray(b), s=4, tol=1e-10)
    got = sstep.sstep_cg_solve(op, b, s=4, tol=1e-10, device="cpu")
    assert bool(got.converged) and got.x.dtype == torch.float64
    assert abs(int(got.iterations) - int(want.iterations)) <= 4
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(want.x)).max())
    assert _rel(dia, got.x.numpy(), b) < 1e-11


def _collapse():
    """cgx's rank-collapse scenario (test_sstep.py:261-300): b the lowest
    mode of lap2d_fd(64), a stated lmin far above its eigenvalue."""
    g = 64
    dia = lap2d_fd(g)
    cop, op = _ops(dia)
    xx = np.arange(1, g + 1) / (g + 1)
    b = (np.sin(np.pi * xx)[:, None] * np.sin(np.pi * xx)[None, :]).ravel().astype(np.float32)
    kw = dict(s=4, tol=1e-5 * float(np.linalg.norm(b)), maxiter=g * g, bounds=(0.5, 8.0))
    return dia, cop, op, b, kw


@pytest.mark.parametrize("powers", ["off", "fused"])
def test_rank_collapse_fallback(powers):
    """The replay freezes at a valid iterate (within s of cgx's for "off");
    "auto" finishes on B4 (plain version here) and converges."""
    dia, cop, op, b, kw = _collapse()
    frozen = sstep.sstep_cg_solve(op, b, powers=powers, fallback="off", device="cpu", **kw)
    assert bool(frozen.breakdown) and not bool(frozen.converged)
    assert _rel(dia, frozen.x.numpy(), b) <= 1.0
    if powers == "off":
        want = cgx_sstep.sstep_cg_solve(cop, jnp.asarray(b), fallback="off", **kw)
        assert bool(want.breakdown) and abs(int(frozen.iterations) - int(want.iterations)) <= 4
    from cgx_torch.ops import cg_stream

    before = cg_stream._stream_iteration.launches
    res = sstep.sstep_cg_solve(op, b, powers=powers, fallback="auto", device="cpu", **kw)
    assert bool(res.converged) and not bool(res.breakdown)
    assert cg_stream._stream_iteration.launches > before
    assert int(res.iterations) > int(frozen.iterations) and _rel(dia, res.x.numpy(), b) < 1e-4


@pytest.mark.parametrize("powers", ["off", "fused"])
def test_adaptive_ladder_avoids_the_plain_restart(powers, monkeypatch):
    """"adaptive" restarts s-step at s // 2 and finishes there: the plain
    solvers are rigged to raise (cgx test_sstep.py:303-345)."""
    dia, _, op, b, kw = _collapse()

    def boom(*a, **k):
        raise AssertionError("plain-solver fallback must not run")

    from cgx_torch.ops import cg_stream

    monkeypatch.setattr(cg_stream, "dia_cg_solve_stream", boom)
    monkeypatch.setattr(sstep, "cg_solve", boom)
    res = sstep.sstep_cg_solve(op, b, powers=powers, fallback="adaptive", device="cpu", **kw)
    assert bool(res.converged) and not bool(res.breakdown)
    assert _rel(dia, res.x.numpy(), b) < 3e-4


@pytest.mark.parametrize("powers", ["off", "fused"])
def test_huge_rhs_prescale(powers):
    """2^100 b: without the exact power-of-2 prescale the Gram overflows
    float32; with it the solve is the unscaled one, scaled, bit for bit."""
    dia = lap2d_fd(16)
    _, op = _ops(dia)
    b = np.asarray(source_term(256), np.float32)
    big = b * np.float32(2.0 ** 100)
    tol = 1e-3 * float(np.linalg.norm(b))
    kw = dict(s=4, maxiter=2000, powers=powers, device="cpu")
    ref = sstep.sstep_cg_solve(op, b, tol=tol, **kw)
    got = sstep.sstep_cg_solve(op, big, tol=tol * 2.0 ** 100, **kw)
    assert bool(got.converged) and not bool(got.breakdown)
    assert int(got.iterations) == int(ref.iterations)
    assert torch.equal(got.x, ref.x * np.float32(2.0 ** 100))


def test_solve_routes_method_sstep():
    """solve(method="sstep") on a CPU operator: "auto" is "off", cgx's
    count; "pallas" counts B9 and replay launches; the ValueErrors of
    cgx's api.py:292-293 and _single_powers."""
    dia = cgx_torch.lap2d_reference(256)
    b = source_term(256)
    cfg = SolveConfig(method="sstep", tolerance=1e-6)
    got = cgx_torch.solve(dia, b, cfg, device="cpu")
    want = cgx.solve(lap2d_reference(256), b, cgx.SolveConfig(method="sstep", tolerance=1e-6))
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    from cgx_torch.ops import dia_powers

    counts = dia_powers.dia_sstep_basis_planes.launches, sstep_stream.sstep_replay.launches
    fp32 = SolveConfig(method="sstep", precision="fp32", tolerance=1e-6 * np.linalg.norm(b),
                       sstep_powers="pallas")
    res = cgx_torch.solve(dia, b, fp32, device="cpu")
    assert bool(res.converged)
    assert dia_powers.dia_sstep_basis_planes.launches > counts[0]
    assert sstep_stream.sstep_replay.launches > counts[1]
    for bad, err in ((dict(sstep_powers="deephalo"), "sharded"),
                     (dict(sstep_powers="bogus"), "unknown sstep_powers"),
                     (dict(precond="jacobi"), "preconditioner")):
        with pytest.raises(ValueError, match=err):
            cgx_torch.solve(dia, b, SolveConfig(method="sstep", **bad), device="cpu")
    # a banded operator whose bands report a CUDA device (no card needed here)
    card_op = cgx_torch.DiaOperator(types.SimpleNamespace(
        device=types.SimpleNamespace(type="cuda"), dtype=torch.float32), (0,))
    auto = SolveConfig(method="sstep", sstep_powers="auto")
    assert api._single_powers(auto, card_op) == "fused"
    assert api._single_powers(SolveConfig(sstep_s=8), card_op) == "off"
    assert api._single_powers(auto, cgx_torch.operator_from_numpy(
        np.ones((1, 4)), (0,), device="cpu")) == "off"
    assert api._single_powers(SolveConfig(sstep_powers="interpret"), card_op) == "interpret"


def test_argument_validation():
    dia = lap2d_fd(16)
    _, op = _ops(dia)
    b = np.asarray(source_term(256), np.float32)
    for kw, err in ((dict(fallback="bogus"), "fallback"), (dict(powers="deephalo"), "powers"),
                    (dict(basis="monomial"), "basis"), (dict(bounds=(2.0, 1.0)), "bounds"),
                    (dict(powers="fused", replace_every=1), "replacement")):
        with pytest.raises(ValueError, match=err):
            sstep.sstep_cg_solve(op, b, device="cpu", **kw)
    with pytest.raises(TypeError, match="DiaOperator"):
        sstep.sstep_cg_solve(torch.eye(16) * 4, np.ones(16, np.float32), powers="pallas",
                             bounds=(1.0, 5.0), device="cpu")
    zero = sstep.sstep_cg_solve(op, np.zeros(256, np.float32), device="cpu")
    assert bool(zero.converged) and int(zero.iterations) == 0

"""cgx_torch's Chronopoulos-Gear CG against cgx's
(tests/test_pipelined.py), on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver.pipelined import pipelined_cg_solve as cgx_pipelined
from cgx.solver.precond import neumann_banded as cgx_neumann
from cgx_torch import SolveConfig
from cgx_torch.solver.pipelined import pipelined_cg_solve
from cgx_torch.solver.precond import neumann_banded

N = 700
HIST = 24
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(scope="module")
def dia():
    return cgx.lap2d_reference(N)


def _pair(dia, dtype, precond):
    """cgx's operator and preconditioner, and the port's, on the same bands."""
    op = cgx.DiaOperator.from_host(dia, dtype=JNP[dtype])
    opt = cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=dtype, device="cpu")
    if not precond:
        return op, None, opt, None
    return (op, cgx_neumann(op.bands, op.offsets, sweeps=2), opt,
            neumann_banded(opt.bands, opt.offsets, sweeps=2))


# (dtype, dot_precision, the history's rtol against cgx's): over HIST
# iterations float64 agreed within 1.1e-14 and float32 with float64 dots
# within 3.4e-6 (the vectors' rounding, in another summation order);
# the bounds leave some 30x. rsold is <r, u> at the last update, some
# 1e-6 of its start: there float32's rounding of r shows, 0.6% apart in
# both cases (float64: 3e-14).
CASES = [(torch.float64, None, 1e-12, 1e-10), (torch.float32, torch.float64, 1e-4, 3e-2)]


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("dtype,dots,rtol,rsold_rtol", CASES, ids=["fp64", "fp32"])
def test_matches_cgx(dia, dtype, dots, rtol, rsold_rtol, precond):
    """The same k, the residual trace within rtol, x within the vectors'
    rounding over the solve, and rsold within rsold_rtol."""
    b = cgx.source_term(N)
    tol = 1e-6 * np.linalg.norm(b)
    op, pc, opt, pct = _pair(dia, dtype, precond)
    want = cgx_pipelined(op, jnp.asarray(b, JNP[dtype]), tol=tol, history=HIST,
                         dot_precision=None if dots is None else jnp.float64, precond=pc)
    got = pipelined_cg_solve(opt, torch.as_tensor(b, dtype=dtype), tol=tol, history=HIST,
                             dot_precision=dots, precond=pct, device="cpu")
    assert bool(got.converged) and not bool(got.breakdown)
    assert int(got.iterations) == int(want.iterations)
    assert got.iterations.dtype == torch.int32 and got.x.dtype == dtype
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history), rtol=rtol)
    wx = np.asarray(want.x, np.float64)
    xtol = 1e-10 if dtype == torch.float64 else 1e-3
    np.testing.assert_allclose(got.x.numpy(), wx, rtol=xtol, atol=xtol * np.abs(wx).max())
    assert float(got.rsold) == pytest.approx(float(want.rsold), rel=rsold_rtol)


def test_fp32_dots_within_one_iteration(dia):
    """float32 dots sum in another order than XLA's: within one iteration."""
    b = cgx.source_term(N)
    tol = 1e-6 * np.linalg.norm(b)
    op, _, opt, _ = _pair(dia, torch.float32, False)
    want = cgx_pipelined(op, jnp.asarray(b, jnp.float32), tol=tol)
    got = pipelined_cg_solve(opt, torch.as_tensor(b, dtype=torch.float32), tol=tol, device="cpu")
    assert bool(got.converged) and abs(int(got.iterations) - int(want.iterations)) <= 1


def test_x0_and_maxiter(dia):
    """A warm start takes the same k as cgx's from the same x0, and the
    cap holds mid-chunk with the same iterate."""
    rng = np.random.default_rng(3)
    b = cgx.source_term(N)
    x0 = rng.standard_normal(N)
    tol = 1e-8 * np.linalg.norm(b)
    op, _, opt, _ = _pair(dia, torch.float64, False)
    want = cgx_pipelined(op, jnp.asarray(b), jnp.asarray(x0), tol=tol)
    got = pipelined_cg_solve(opt, b, x0, tol=tol, device="cpu")
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(want.x)).max())
    for cap in (37, 64):
        want = cgx_pipelined(op, jnp.asarray(b), tol=0.0, maxiter=cap)
        got = pipelined_cg_solve(opt, b, tol=0.0, maxiter=cap, device="cpu")
        assert int(got.iterations) == int(want.iterations) == cap
        assert not bool(got.converged)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                                   atol=1e-9 * np.abs(np.asarray(want.x)).max())


@pytest.mark.parametrize("precond", [False, True])
def test_zero_rhs_is_preconverged(dia, precond):
    _, _, opt, pct = _pair(dia, torch.float64, precond)
    got = pipelined_cg_solve(opt, np.zeros(N), precond=pct, history=4, device="cpu")
    assert bool(got.converged) and int(got.iterations) == 0
    assert torch.equal(got.x, torch.zeros(N, dtype=torch.float64))
    assert float(got.residual_norm) == 0.0 and float(got.rsold) == 0.0
    assert torch.isnan(got.history).all()


def test_chunk_invariance(dia, monkeypatch):
    """Frozen iterations: the host-read interval changes nothing."""
    import cgx_torch.solver.pipelined as pipelined

    b = cgx.source_term(N)
    _, _, opt, pct = _pair(dia, torch.float32, True)
    kw = dict(tol=1e-5 * np.linalg.norm(b), history=HIST, precond=pct, device="cpu")
    many = pipelined_cg_solve(opt, torch.as_tensor(b, dtype=torch.float32), **kw)
    monkeypatch.setattr(pipelined, "_CHUNK", 1)
    one = pipelined_cg_solve(opt, torch.as_tensor(b, dtype=torch.float32), **kw)
    for field in many._fields:
        assert torch.equal(getattr(one, field), getattr(many, field)), field


@pytest.mark.parametrize("precond", [None, "neumann"])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_solve_method_pipelined_matches_cgx(dia, precision, precond):
    """solve(method="pipelined") runs the loop with float64 dots for fp32
    and the configured preconditioner, as cgx api.py:302-309 does."""
    b = cgx.source_term(N)
    cfg = dict(precision=precision, tolerance=1e-6 * np.linalg.norm(b), precond=precond,
               method="pipelined")
    want = cgx.solve(dia, b, cgx.SolveConfig(**cfg))
    got = cgx_torch.solve(cgx_torch.lap2d_reference(N), b, SolveConfig(**cfg), device="cpu")
    assert bool(got.converged)
    assert int(got.iterations) == int(want.iterations)
    dtype = torch.float64 if precision == "fp64" else torch.float32
    _, _, opt, pct = _pair(dia, dtype, precond is not None)
    direct = pipelined_cg_solve(opt, torch.as_tensor(b, dtype=dtype), tol=cfg["tolerance"],
                                precond=pct, dot_precision=torch.float64, device="cpu")
    assert torch.equal(got.x, direct.x)

"""cgx_torch.solver.deflated and solve_sequence against cgx's on the CPU
(x64): Ritz values, cgx's W carried across, the harvest, deflated PCG,
and solve_sequence with varying operators, a warm start, a failed
harvest and a zero right-hand side (tests/test_deflated.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver.deflated import DeflationBasis as CgxBasis
from cgx_torch.solver.deflated import (
    DeflationBasis,
    cg_solve_harvest,
    deflated_cg_solve,
    lanczos_ritz,
)

N = 400  # lap2d_reference(400), cgx's deflation problem


@pytest.fixture(scope="module")
def ops():
    return (cgx.as_operator(cgx.lap2d_reference(N)),
            cgx_torch.as_operator(cgx_torch.lap2d_reference(N), device="cpu"))


def _rayleigh(op_mv, w):
    return np.sort([w[:, j] @ op_mv(w[:, j]) for j in range(w.shape[1])])


def test_ritz_values_match_cgx(ops):
    """The same Lanczos pass on the host: the Rayleigh quotients of the
    harvested W within 1e-10, and the same range."""
    opc, opt = ops
    wc = cgx.lanczos_ritz(opc, N, 8)
    wt = lanczos_ritz(opt, N, 8)
    assert wt.shape == wc.shape
    mv = cgx_torch.lap2d_reference(N).mat_vec
    np.testing.assert_allclose(_rayleigh(mv, wt), _rayleigh(mv, wc), rtol=1e-10)
    np.testing.assert_allclose(wt @ wt.T, wc @ wc.T, atol=1e-10)
    with pytest.raises(ValueError, match="no Ritz pair converged"):
        lanczos_ritz(opt, N, 4, m=8, ritz_tol=1e-14)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_cgx_basis_carried_across(ops, precond):
    """A cgx DeflationBasis's W builds the port's basis, and deflated
    (P)CG on it takes cgx's k, x within 1e-12; the history too."""
    from cgx.solver.precond import jacobi as cgx_jacobi

    from cgx_torch.solver.precond import jacobi

    opc, opt = ops
    basis_c = CgxBasis.from_lanczos(opc, k=16)
    basis_t = cgx_torch.basis_from_cgx(basis_c, opt)
    np.testing.assert_allclose(basis_t.minv.numpy(), np.asarray(basis_c.minv), rtol=1e-10,
                               atol=1e-12)
    b = np.random.default_rng(1).standard_normal(N)
    pcc = None if precond is None else cgx_jacobi(opc.diagonal())
    pct = None if precond is None else jacobi(opt.diagonal())
    want = cgx.deflated_cg_solve(opc, jnp.asarray(b), basis_c, tol=1e-10, history=8,
                                 precond=pcc)
    got = deflated_cg_solve(opt, b, basis_t, tol=1e-10, history=8, precond=pct, device="cpu")
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    want_x = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - want_x)) <= 1e-12 * np.max(np.abs(want_x))
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history), rtol=1e-9)


def test_from_lanczos_and_zero_rhs(ops):
    _, opt = ops
    basis = DeflationBasis.from_lanczos(opt, k=8)
    res = deflated_cg_solve(opt, np.zeros(N), basis, device="cpu")
    assert bool(res.converged) and int(res.iterations) == 0 and not torch.any(res.x)


def test_harvest_matches_cgx(ops):
    """The harvesting solve is plain CG (cgx's k), and its W spans cgx's
    range: the deflated solves on the two bases take the same k."""
    opc, opt = ops
    b = cgx_torch.source_term(N)
    res_c, basis_c = cgx.cg_solve_harvest(opc, jnp.asarray(b), k=16)
    res_t, basis_t = cg_solve_harvest(opt, b, k=16, device="cpu")
    assert int(res_t.iterations) == int(res_c.iterations)
    assert torch.equal(res_t.converged, torch.tensor(bool(res_c.converged)))
    wt, wc = basis_t.w.numpy(), np.asarray(basis_c.w)
    assert wt.shape == wc.shape
    # the window's late rows follow the trajectory's rounding (about 1e-5
    # relative at convergence), and its SVD picks any basis of the range
    np.testing.assert_allclose(wt @ wt.T, wc @ wc.T, atol=1e-5)
    b2 = np.random.default_rng(2).standard_normal(N)
    want = cgx.deflated_cg_solve(opc, jnp.asarray(b2), basis_c, tol=1e-10)
    got = deflated_cg_solve(opt, b2, basis_t, tol=1e-10, device="cpu")
    assert int(got.iterations) == int(want.iterations)


def test_harvest_errors(ops):
    _, opt = ops
    b = cgx_torch.source_term(N)
    with pytest.raises(ValueError, match="no Ritz pair|nothing"):
        cg_solve_harvest(opt, b, k=4, maxiter=1, device="cpu")
    res, basis = cg_solve_harvest(opt, b, k=4, window=2, strict=False, device="cpu")
    assert basis is None and bool(res.converged)
    with pytest.raises(TypeError, match="matvec"):
        cg_solve_harvest(np.eye(4), np.ones(4), device="cpu")


def _ks(results):
    return [int(r.iterations) for r in results]


@pytest.mark.parametrize("kw", [{}, {"warm_start": True},
                                {"config": "jacobi"}], ids=["plain", "warm", "pcg"])
def test_solve_sequence_matches_cgx(kw):
    kw = dict(kw)
    cfg = kw.pop("config", None)
    b0 = cgx_torch.source_term(N)
    bs = [b0, b0 * 1.001, np.random.default_rng(3).standard_normal(N)]
    want = cgx.solve_sequence(cgx.lap2d_reference(N), bs, cgx.SolveConfig(precond=cfg), k=16,
                              **kw)
    got = cgx_torch.solve_sequence(cgx_torch.lap2d_reference(N), bs,
                                   cgx_torch.SolveConfig(precond=cfg), k=16, device="cpu", **kw)
    assert _ks(got) == _ks(want)
    for g, w in zip(got, want):
        assert bool(g.converged)
        w_x = np.asarray(w.x)
        assert np.max(np.abs(g.x.numpy() - w_x)) <= 1e-10 * np.max(np.abs(w_x))


def test_solve_sequence_varying_operators():
    from cgx.mats.generators import poisson2d_var as cgx_var

    g = 20
    rng = np.random.default_rng(6)
    base = np.exp(0.3 * rng.standard_normal((g, g)))
    coefs = [base * (1.0 + 0.01 * t * rng.standard_normal((g, g))) for t in range(3)]
    bs = [rng.standard_normal(g * g) for _ in range(3)]
    want = cgx.solve_sequence([cgx_var(g, c) for c in coefs], bs, k=16)
    got = cgx_torch.solve_sequence([cgx_torch.poisson2d_var(g, c) for c in coefs], bs, k=16,
                                   device="cpu")
    assert _ks(got) == _ks(want)
    with pytest.raises(ValueError, match="matrices for"):
        cgx_torch.solve_sequence([cgx_torch.poisson2d_var(g, c) for c in coefs[:2]], bs, k=8,
                                 device="cpu")


def test_solve_sequence_failed_harvest_and_zero_rhs():
    """A window too short for any Ritz pair leaves the rest to plain CG
    (cgx's k); a zero right-hand side later in the sequence converges at
    k = 0; an empty sequence is empty."""
    bs = [cgx_torch.source_term(N), cgx_torch.source_term(N)]
    cfg = dict(tolerance=1e-10)
    want = cgx.solve_sequence(cgx.lap2d_reference(N), bs, k=8, window=2,
                              config=cgx.SolveConfig(**cfg))
    got = cgx_torch.solve_sequence(cgx_torch.lap2d_reference(N), bs, k=8, window=2,
                                   config=cgx_torch.SolveConfig(**cfg), device="cpu")
    assert _ks(got) == _ks(want) and _ks(got)[0] == _ks(got)[1]
    zero = cgx_torch.solve_sequence(cgx_torch.lap2d_reference(N), [bs[0], np.zeros(N)], k=8,
                                    device="cpu")
    assert bool(zero[1].converged) and int(zero[1].iterations) == 0
    assert cgx_torch.solve_sequence(cgx_torch.lap2d_reference(N), [], device="cpu") == []


def test_solve_sequence_errors():
    dia = cgx_torch.lap2d_reference(64)
    bs = [cgx_torch.source_term(64)]
    with pytest.raises(ValueError, match="reference recurrence"):
        cgx_torch.solve_sequence(dia, bs, cgx_torch.SolveConfig(method="pipelined"),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        cgx_torch.solve_sequence(dia, bs, mesh=cgx_torch.make_mesh(device="cpu"), device="cpu")

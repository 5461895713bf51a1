"""cgx_torch's Chebyshev iteration (chebyshev_solve) against cgx's on
the CPU (x64): given and estimated bounds, check cadences 1 and 32, the
4N default maxiter through solve, and cgx's errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver.chebyshev import chebyshev_solve as cgx_cheby
from cgx_torch.solver.chebyshev import chebyshev_solve

G = 24
N = G * G


@pytest.fixture(scope="module")
def problem():
    b = cgx_torch.source_term(N)
    return (cgx.as_operator(cgx.lap2d_fd(G)), cgx_torch.as_operator(cgx_torch.lap2d_fd(G),
                                                                     device="cpu"), b)


def _analytic_bounds(g: int):
    """The 5-point Dirichlet stencil's extreme eigenvalues."""
    c = np.cos(np.pi / (g + 1))
    return 4.0 * (1 - c), 4.0 * (1 + c)


@pytest.mark.parametrize("check_every", [1, 32])
@pytest.mark.parametrize("bounds", ["given", "estimated"])
def test_matches_cgx(problem, check_every, bounds):
    """k equal to cgx's (a multiple of check_every), x within 1e-12."""
    opc, opt, b = problem
    bnd = _analytic_bounds(G) if bounds == "given" else None
    tol = 1e-8 * np.linalg.norm(b)
    want = cgx_cheby(opc, jnp.asarray(b), bounds=bnd, tol=tol, check_every=check_every)
    got = chebyshev_solve(opt, b, bounds=bnd, tol=tol, check_every=check_every, device="cpu")
    assert bool(got.converged) and bool(want.converged)
    k = int(got.iterations)
    assert k == int(want.iterations) and k % check_every == 0
    want_x = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - want_x)) <= 1e-12 * np.max(np.abs(want_x))
    assert float(got.rsold) == pytest.approx(float(want.rsold), rel=1e-8)


def test_estimated_bounds_match_cgx(problem):
    from cgx.solver.chebyshev import spectral_bounds as cgx_bounds

    from cgx_torch.solver.chebyshev import spectral_bounds

    opc, opt, _ = problem
    assert spectral_bounds(opt, N) == pytest.approx(cgx_bounds(opc, N), rel=1e-12)


def test_fp32_and_x0(problem):
    dc, dt = cgx.lap2d_fd(G), cgx_torch.lap2d_fd(G)
    b = cgx_torch.source_term(N)
    x0 = np.random.default_rng(2).standard_normal(N)
    tol = 1e-4 * np.linalg.norm(b)
    want = cgx_cheby(cgx.as_operator(dc, dtype=jnp.float32), jnp.asarray(b, jnp.float32),
                     jnp.asarray(x0, jnp.float32), bounds=_analytic_bounds(G), tol=tol,
                     check_every=8)
    got = chebyshev_solve(cgx_torch.as_operator(dt, torch.float32, device="cpu"),
                          torch.tensor(b, dtype=torch.float32), x0, bounds=_analytic_bounds(G),
                          tol=tol, check_every=8, device="cpu")
    assert got.x.dtype == torch.float32
    assert int(got.iterations) == int(want.iterations)
    want_x = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - want_x)) <= 1e-5 * np.max(np.abs(want_x))


def test_solve_default_maxiter_is_4n():
    """solve(method="chebyshev") defaults maxiter to 4N (cgx api.py:203-205):
    a tolerance it cannot reach stops at 4N, as cgx's does."""
    dc, dt = cgx.lap2d_fd(8), cgx_torch.lap2d_fd(8)
    b = cgx_torch.source_term(64)
    cfg = dict(method="chebyshev", tolerance=1e-30, check_every=4)
    want = cgx.solve(dc, b, cgx.SolveConfig(**cfg))
    got = cgx_torch.solve(dt, b, cgx_torch.SolveConfig(**cfg), device="cpu")
    assert int(got.iterations) == int(want.iterations) == 4 * 64
    assert not bool(got.converged)


def test_solve_matches_cgx_and_refuses_a_preconditioner():
    dc, dt = cgx.lap2d_fd(G), cgx_torch.lap2d_fd(G)
    b = cgx_torch.source_term(N)
    cfg = dict(method="chebyshev", tolerance=1e-8 * np.linalg.norm(b))
    want = cgx.solve(dc, b, cgx.SolveConfig(**cfg))
    got = cgx_torch.solve(dt, b, cgx_torch.SolveConfig(**cfg), device="cpu")
    assert int(got.iterations) == int(want.iterations)
    with pytest.raises(ValueError, match="does not take a preconditioner"):
        cgx_torch.solve(dt, b, cgx_torch.SolveConfig(precond="jacobi", **cfg), device="cpu")


def test_errors():
    b = np.ones(16)
    with pytest.raises(ValueError, match="bounds= is required"):
        chebyshev_solve(lambda v: 2.0 * v, b, device="cpu")
    with pytest.raises(ValueError, match="invalid spectral bounds"):
        chebyshev_solve(torch.eye(16, dtype=torch.float64), b, bounds=(2.0, 1.0), device="cpu")
    got = chebyshev_solve(lambda v: 2.0 * v, b, bounds=(1.0, 3.0), tol=1e-12, check_every=1,
                          device="cpu")
    assert bool(got.converged) and torch.allclose(got.x, torch.full((16,), 0.5,
                                                                    dtype=torch.float64))

"""cgx_torch.solver.gvpipe against cgx.solver.gvpipe on the CPU (x64):
the same numpy-seeded inputs, the same iteration counts above the fp64
floor, x within 1e-12, and cgx's own windows (tests/test_gvpipe.py)
where a solve reaches the floor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver.gvpipe import gv_cg_solve as cgx_gv
from cgx_torch.solver.gvpipe import gv_cg_solve

G = 32
N = G * G
RTOL = 1e-8  # relative to ||b||: the trajectories stay above the fp64 floor


@pytest.fixture(scope="module")
def problem():
    b = cgx_torch.source_term(N)
    return (cgx.as_operator(cgx.lap2d_fd(G)), cgx_torch.as_operator(cgx_torch.lap2d_fd(G),
                                                                     device="cpu"), b)


def _x_close(got, want, tol=1e-12):
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) <= tol * np.max(np.abs(want))


def _true_rel(x, b):
    a = cgx_torch.lap2d_fd(G)
    return np.linalg.norm(a.mat_vec(np.asarray(x, np.float64)) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("replace_every", [0, 10, 25])
def test_fp64_matches_cgx(problem, replace_every):
    """k equal and x within 1e-12 relative, with the guarded replacement
    off, at cadence 10 and at cgx's default 25; the history too."""
    opc, opt, b = problem
    tol = RTOL * np.linalg.norm(b)
    want = cgx_gv(opc, jnp.asarray(b), tol=tol, replace_every=replace_every, history=16)
    got = gv_cg_solve(opt, b, tol=tol, replace_every=replace_every, history=16, device="cpu")
    assert bool(got.converged) and not bool(got.breakdown)
    assert int(got.iterations) == int(want.iterations)
    _x_close(got.x, want.x)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history), rtol=1e-12)
    assert float(got.rsold) == pytest.approx(float(want.rsold), rel=1e-9)


def test_reference_tolerance_in_cgx_window(problem):
    """At the reference's absolute tol 1e-10 (the fp64 floor), cgx's own
    bound: converged, k <= 1.15 k_classic + 2, true residual < 1e-12, and
    within 2 of cgx's k."""
    opc, opt, b = problem
    want = cgx_gv(opc, jnp.asarray(b), tol=1e-10)
    got = gv_cg_solve(opt, b, tol=1e-10, device="cpu")
    k_classic = int(cgx_torch.cg_solve(opt, b, tol=1e-10, device="cpu").iterations)
    assert bool(got.converged)
    assert int(got.iterations) <= 1.15 * k_classic + 2
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    assert _true_rel(got.x, b) < 1e-12


@pytest.mark.parametrize("pc_name", ["jacobi", "neumann", "mg"])
def test_preconditioned_matches_cgx(problem, pc_name):
    from cgx.solver import precond as cp
    from cgx.solver.multigrid import mg_preconditioner as cgx_mg

    from cgx_torch.solver import precond as tp
    from cgx_torch.solver.multigrid import mg_preconditioner

    opc, opt, b = problem
    if pc_name == "jacobi":
        pcc, pct = cp.jacobi(opc.diagonal()), tp.jacobi(opt.diagonal())
    elif pc_name == "neumann":
        pcc = cp.neumann_banded(opc.bands, opc.offsets, sweeps=2)
        pct = tp.neumann_banded(opt.bands, opt.offsets, sweeps=2)
    else:
        pcc, pct = cgx_mg(opc, ndim=2).apply, mg_preconditioner(opt, ndim=2).apply
    tol = RTOL * np.linalg.norm(b)
    want = cgx_gv(opc, jnp.asarray(b), tol=tol, precond=pcc)
    got = gv_cg_solve(opt, b, tol=tol, precond=pct, device="cpu")
    assert bool(got.converged)
    assert int(got.iterations) == int(want.iterations)
    _x_close(got.x, want.x)


def test_dense_operator_with_x0(problem):
    opc, opt, b = problem
    a = np.asarray(cgx.lap2d_fd(G).to_dense())
    x0 = np.random.default_rng(0).standard_normal(N)
    tol = RTOL * np.linalg.norm(b)
    want = cgx_gv(jnp.asarray(a), jnp.asarray(b), x0=jnp.asarray(x0), tol=tol)
    got = gv_cg_solve(torch.tensor(a), b, x0=x0, tol=tol, device="cpu")
    assert bool(got.converged)
    assert int(got.iterations) == int(want.iterations)
    _x_close(got.x, want.x)


def test_fp32_with_fp64_dots(problem):
    """fp32 vectors with float64 dots: k within 2% of cgx's and the true
    residual within 2x."""
    dc, dt = cgx.lap2d_fd(G), cgx_torch.lap2d_fd(G)
    b = cgx_torch.source_term(N)
    tol = 1e-5 * np.linalg.norm(b)
    want = cgx_gv(cgx.as_operator(dc, dtype=jnp.float32), jnp.asarray(b, jnp.float32), tol=tol,
                  dot_precision=jnp.float64)
    got = gv_cg_solve(cgx_torch.as_operator(dt, torch.float32, device="cpu"),
                      torch.tensor(b, dtype=torch.float32), tol=tol, dot_precision=torch.float64,
                      device="cpu")
    assert got.x.dtype == torch.float32 and bool(got.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 0.02 * int(want.iterations)
    rg, rw = _true_rel(got.x, b), _true_rel(want.x, b)
    assert max(rg, rw) <= 2 * min(rg, rw)


def test_pre_converged_start(problem):
    opc, opt, _ = problem
    want = cgx_gv(opc, jnp.zeros(N), tol=1e-10)
    got = gv_cg_solve(opt, np.zeros(N), tol=1e-10, device="cpu")
    assert bool(got.converged) and int(got.iterations) == int(want.iterations) == 0
    assert not torch.any(got.x)


def test_unreplaced_recursion_breaks_down_honestly(problem):
    """replace_every=0 at the reference's tol 1e-10: the GV recursion
    floors and the loop exits on denom <= 0 with its last finite state,
    with cgx's flags (converged False, breakdown True). The exit lands
    where the drifted recursion stalls, a rounding-floor event whose k
    follows the dots' summation order (cgx 133, the port 136 here), so
    k is held within 5% of cgx's; x stays a good solution."""
    opc, opt, b = problem
    want = cgx_gv(opc, jnp.asarray(b), tol=1e-10, replace_every=0)
    got = gv_cg_solve(opt, b, tol=1e-10, replace_every=0, device="cpu")
    assert (bool(got.converged), bool(got.breakdown)) == (bool(want.converged),
                                                          bool(want.breakdown)) == (False, True)
    assert torch.isfinite(got.x).all()
    assert int(got.iterations) < N
    assert abs(int(got.iterations) - int(want.iterations)) <= 0.05 * int(want.iterations)
    assert _true_rel(got.x, b) < 1e-9


def test_solve_routes_gvpipe():
    """solve(method="gvpipe") with gv_replace_every and a preconditioner,
    as cgx routes it (api.py:310-318)."""
    dc, dt = cgx.lap2d_fd(24), cgx_torch.lap2d_fd(24)
    b = cgx_torch.source_term(576)
    for kw in ({}, {"precond": "jacobi"}, {"gv_replace_every": 10}):
        cfg = dict(method="gvpipe", tolerance=RTOL * np.linalg.norm(b), history=4, **kw)
        want = cgx.solve(dc, b, cgx.SolveConfig(**cfg))
        got = cgx_torch.solve(dt, b, cgx_torch.SolveConfig(**cfg), device="cpu")
        assert int(got.iterations) == int(want.iterations)
        _x_close(got.x, want.x)

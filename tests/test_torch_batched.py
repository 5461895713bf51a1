"""cgx_torch.solver.batched and solve's multi_rhs routes against cgx's on
the CPU (x64): per-column k and x, the history, frozen columns, and the
2-D b through solve(multi_rhs="batched"|"block") with x0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver.batched import cg_solve_batched as cgx_batched
from cgx_torch.solver.batched import cg_solve_batched

G = 16
N = G * G


@pytest.fixture(scope="module")
def ops():
    return cgx.as_operator(cgx.lap2d_fd(G)), cgx_torch.as_operator(cgx_torch.lap2d_fd(G),
                                                                   device="cpu")


def _x_close(got, want, tol=1e-12):
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("x0", [False, True], ids=["zero", "x0"])
def test_per_column_matches_cgx(ops, x0):
    """Columns of different scale converge at their own k (the small one
    first, then frozen), each as cgx's vmapped cg_solve: k, x, history,
    residual norms."""
    opc, opt = ops
    rng = np.random.default_rng(0)
    b = rng.standard_normal((4, N)) * np.array([[1.0], [1e3], [1e-3], [10.0]])
    start = rng.standard_normal((4, N)) if x0 else None
    want = cgx_batched(opc, jnp.asarray(b), None if start is None else jnp.asarray(start),
                       tol=1e-8, history=12)
    got = cg_solve_batched(opt, b, start, tol=1e-8, history=12, device="cpu")
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    assert len(set(got.iterations.tolist())) > 1
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    _x_close(got.x, want.x)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history), rtol=1e-10)
    np.testing.assert_allclose(got.residual_norm.numpy(), np.asarray(want.residual_norm),
                               rtol=1e-6)


def test_dense_and_fp32(ops):
    a = np.asarray(cgx.lap2d_fd(G).to_dense())
    b = np.random.default_rng(1).standard_normal((3, N))
    want = cgx_batched(jnp.asarray(a), jnp.asarray(b), tol=1e-8)
    got = cg_solve_batched(torch.tensor(a), b, tol=1e-8, device="cpu")
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    _x_close(got.x, want.x)
    opc32 = cgx.as_operator(cgx.lap2d_fd(G), dtype=jnp.float32)
    opt32 = cgx_torch.as_operator(cgx_torch.lap2d_fd(G), torch.float32, device="cpu")
    want = cgx_batched(opc32, jnp.asarray(b, jnp.float32), tol=1e-3)
    got = cg_solve_batched(opt32, torch.tensor(b, dtype=torch.float32), tol=1e-3, device="cpu")
    assert got.x.dtype == torch.float32
    assert np.max(np.abs(got.iterations.numpy() - np.asarray(want.iterations))) <= 1


def test_maxiter_and_rejects_1d(ops):
    opc, opt = ops
    b = np.random.default_rng(2).standard_normal((2, N))
    want = cgx_batched(opc, jnp.asarray(b), tol=1e-30, maxiter=7)
    got = cg_solve_batched(opt, b, tol=1e-30, maxiter=7, device="cpu")
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist() == [7, 7]
    _x_close(got.x, want.x)
    with pytest.raises(ValueError, match="batch, n"):
        cg_solve_batched(opt, np.ones(N), device="cpu")


@pytest.mark.parametrize("multi_rhs", ["batched", "block"])
@pytest.mark.parametrize("x0", [False, True], ids=["zero", "x0"])
def test_solve_2d_b_matches_cgx(multi_rhs, x0):
    """solve with an (n, s) b (cgx api.py:174-185): batched per column, or
    one block Krylov space; x0 of b's shape (the shift identity)."""
    rng = np.random.default_rng(3)
    b = rng.standard_normal((N, 3))
    start = rng.standard_normal((N, 3)) if x0 else None
    cfg = dict(multi_rhs=multi_rhs, tolerance=1e-9)
    want = cgx.solve(cgx.lap2d_fd(G), b, cgx.SolveConfig(**cfg), x0=start)
    got = cgx_torch.solve(cgx_torch.lap2d_fd(G), b, cgx_torch.SolveConfig(**cfg), x0=start,
                          device="cpu")
    assert got.x.shape == (N, 3)
    np.testing.assert_array_equal(np.asarray(got.iterations), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    _x_close(got.x, want.x, 1e-10)


def test_solve_2d_b_block_preconditioned_and_fp32():
    b = np.random.default_rng(4).standard_normal((N, 2))
    for cfg in (dict(precond="mg", tolerance=1e-9), dict(precision="fp32", tolerance=1e-3)):
        want = cgx.solve(cgx.lap2d_fd(G), b, cgx.SolveConfig(**cfg))
        got = cgx_torch.solve(cgx_torch.lap2d_fd(G), b, cgx_torch.SolveConfig(**cfg),
                              device="cpu")
        assert int(got.iterations) == int(want.iterations)
        assert bool(got.converged.all())


def test_solve_2d_b_errors():
    dia, b = cgx_torch.lap2d_fd(8), np.ones((64, 2))
    mesh = cgx_torch.make_mesh(device="cpu")
    for cfg, err, match in [
        (dict(multi_rhs="batched", method="pipelined"), ValueError, "needs a mesh"),
        (dict(multi_rhs="batched", precond="jacobi"), ValueError, "no preconditioner"),
        (dict(method="gvpipe"), ValueError, "single-RHS solves only"),
        (dict(precision="mixed"), ValueError, "fp64/fp32"),
        (dict(multi_rhs="nope"), ValueError, "unknown multi_rhs"),
    ]:
        with pytest.raises(err, match=match):
            cgx_torch.solve(dia, b, cgx_torch.SolveConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="x0 must match"):
        cgx_torch.solve(dia, b, x0=np.ones((64, 3)), device="cpu")

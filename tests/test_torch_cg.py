"""cgx_torch.cg_solve (plain torch) against cgx.cg_solve on the same
inputs, on the CPU in fp64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
import cgx_torch.solver.cg as ct_cg
from cgx.mats.generators import lap2d_fd, lap2d_reference, source_term

# tests/test_golden.py GOLDENS: (generator, arg, tol, k)
GOLDENS = [
    (lap2d_reference, 256, 1e-6, 73),
    (lap2d_reference, 1024, 1e-6, 150),
    (lap2d_fd, 16, 1e-6, 58),
    (lap2d_fd, 32, 1e-6, 119),
]
# tests/test_golden.py FLAGSHIP: first 8 recursive residuals at tol 1e-10
FLAGSHIP = [
    (lap2d_fd, 100, 488),
    (lap2d_reference, 10000, 607),
]


def _op(dia, dtype=torch.float64):
    return cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=dtype, device="cpu")


def _true_rel(dia, x, b):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("gen,arg,tol,k", GOLDENS)
def test_golden_counts_match_cgx(gen, arg, tol, k):
    dia = gen(arg)
    b = source_term(dia.shape[0])
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b), tol=tol)
    got = cgx_torch.cg_solve(_op(dia), b, tol=tol, device="cpu")
    assert bool(got.converged) and int(want.iterations) == k
    assert int(got.iterations) == k
    assert got.iterations.dtype == torch.int32
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(want.x)).max())


@pytest.mark.parametrize("gen,arg,k", FLAGSHIP)
def test_flagship_pair(gen, arg, k):
    """k within +-3 of the golden (counts at tol 1e-10 sit on the fp64
    floor, README.md:235-240), the residual trajectory's first 8 entries
    within rtol 1e-10 of cgx's, and the reference's quality gate."""
    dia = gen(arg)
    b = source_term(dia.shape[0])
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b), tol=1e-10, history=8)
    got = cgx_torch.cg_solve(_op(dia), b, tol=1e-10, history=8, device="cpu")
    assert bool(got.converged)
    assert abs(int(got.iterations) - k) <= 3
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history)[:8], rtol=1e-10)
    assert _true_rel(dia, got.x.numpy(), b) < 1e-11


def test_breakdown_on_indefinite_matrix():
    a = np.diag(np.r_[np.ones(8), -np.ones(8)]) + 0.1 * np.eye(16, k=1) + 0.1 * np.eye(16, k=-1)
    b = np.random.default_rng(0).standard_normal(16)
    want = cgx.cg_solve(cgx.DenseOperator(jnp.asarray(a)), jnp.asarray(b), maxiter=10)
    got = cgx_torch.cg_solve(torch.as_tensor(a), torch.as_tensor(b), maxiter=10, device="cpu")
    assert bool(want.breakdown) and bool(got.breakdown)
    assert int(got.iterations) == int(want.iterations)


def test_zero_rhs_is_preconverged():
    dia = lap2d_reference(64)
    got = cgx_torch.cg_solve(_op(dia), np.zeros(64), device="cpu")
    assert bool(got.converged) and int(got.iterations) == 0
    assert torch.equal(got.x, torch.zeros(64, dtype=torch.float64))
    assert float(got.residual_norm) == 0.0


def test_history_matches_cgx_and_is_nan_padded():
    dia = lap2d_reference(256)
    b = source_term(256)
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b), tol=1e-6, history=100)
    got = cgx_torch.cg_solve(_op(dia), b, tol=1e-6, history=100, device="cpu")
    k = int(got.iterations)
    assert got.history.shape == (100,)
    np.testing.assert_allclose(got.history.numpy()[: k + 1], np.asarray(want.history)[: k + 1],
                               rtol=1e-10)
    assert np.isnan(got.history.numpy()[k + 1:]).all()
    assert float(got.residual_norm) == pytest.approx(float(want.residual_norm), rel=1e-8)
    assert float(got.rsold) == pytest.approx(float(want.rsold), rel=1e-8)


def test_history_shorter_than_the_solve():
    dia = lap2d_reference(256)
    b = source_term(256)
    full = cgx_torch.cg_solve(_op(dia), b, tol=1e-6, history=80, device="cpu")
    short = cgx_torch.cg_solve(_op(dia), b, tol=1e-6, history=5, device="cpu")
    assert torch.equal(short.history, full.history[:5])
    assert torch.equal(short.x, full.x)


def test_maxiter_caps_without_convergence():
    dia = lap2d_reference(256)
    b = source_term(256)
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b), tol=0.0, maxiter=30)
    got = cgx_torch.cg_solve(_op(dia), b, tol=0.0, maxiter=30, device="cpu")
    assert int(got.iterations) == 30 and not bool(got.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10)


@pytest.mark.parametrize("maxiter", [None, 45])
def test_chunk_size_invariance(monkeypatch, maxiter):
    """The host reads `converged` once per chunk; iterations run after
    convergence inside a chunk are frozen, so chunk 1 and chunk 32 give
    bitwise the same result; so do chunk 1 and the growing chunks (1, 2,
    4, ... 32) of a preconditioned solve, here a multigrid one."""
    from cgx_torch.solver.multigrid import mg_preconditioner

    dia = lap2d_fd(16)
    b = source_term(dia.shape[0])
    mg = mg_preconditioner(_op(dia))
    for precond, tol in ((None, 1e-6), (mg.apply, 1e-10)):
        results = []
        for chunk in (1, 32):
            monkeypatch.setattr(ct_cg, "_CHUNK", chunk)
            results.append(cgx_torch.cg_solve(_op(dia), b, tol=tol, maxiter=maxiter, history=64,
                                              precond=precond, device="cpu"))
        one, many = results
        for field in one._fields:
            a, c = getattr(one, field), getattr(many, field)
            assert a.dtype == c.dtype and a.shape == c.shape, field
            if a.is_floating_point():
                assert torch.equal(a.view(torch.int64), c.view(torch.int64)), field  # bits, NaNs
            else:
                assert torch.equal(a, c), field


@pytest.mark.parametrize("precond", [None, "jacobi", "mg"])
def test_frozen_iterations_follow_the_chunk_schedule(precond):
    """Loop iterations run (each applies the preconditioner once, after one
    application at the start): 32 ceil((k+1)/32) without a preconditioner;
    with one the chunks grow 1, 2, 4, ... 32, and no chunk is longer than
    the iterations before it plus one, which caps the applications at
    2k + 2 (an MG-PCG solve of about 8 iterations would apply 33 at a
    fixed 32)."""
    from cgx_torch.solver.multigrid import mg_preconditioner

    dia = lap2d_fd(64)
    b = source_term(dia.shape[0])
    op = _op(dia)
    calls = []
    base = {None: None, "jacobi": cgx_torch.solver.precond.jacobi(op.diagonal()),
            "mg": mg_preconditioner(op).apply}[precond]
    mvs = []

    def counted_mv(v):
        mvs.append(1)
        return op.matvec(v)

    def counted_pc(r):
        calls.append(1)
        return base(r)

    res = cgx_torch.cg_solve(counted_mv, b, tol=1e-10 * np.linalg.norm(b),
                             precond=None if base is None else counted_pc, device="cpu")
    k = int(res.iterations)
    assert bool(res.converged)
    if precond is None:
        assert len(mvs) - 1 == 32 * -(-(k + 1) // 32)
    else:
        run, chunk = 0, 1
        while run < k + 1:
            run, chunk = run + chunk, min(2 * chunk, 32)
        assert len(mvs) - 1 == run and len(calls) == run + 1
        assert len(calls) <= 2 * k + 2


def test_fp32_with_fp64_dots_matches_cgx():
    dia = lap2d_reference(256)
    b = source_term(256)
    tol = 1e-4 * np.linalg.norm(b)
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia, dtype=jnp.float32),
                        jnp.asarray(b, jnp.float32), tol=tol, dot_precision=jnp.float64)
    got = cgx_torch.cg_solve(_op(dia, torch.float32), torch.as_tensor(b, dtype=torch.float32),
                             tol=tol, dot_precision=torch.float64, device="cpu")
    assert got.x.dtype == torch.float32 and got.rsold.dtype == torch.float64
    assert abs(int(got.iterations) - int(want.iterations)) <= 1


def test_dense_and_callable_operators_match_cgx():
    dia = lap2d_reference(144)
    a = dia.to_dense()
    b = source_term(144)
    want = cgx.cg_solve(cgx.DenseOperator(jnp.asarray(a)), jnp.asarray(b), tol=1e-8)
    at = torch.as_tensor(a)
    for op in (cgx_torch.DenseOperator(at), at, lambda v: at @ v):
        got = cgx_torch.cg_solve(op, b, tol=1e-8, device="cpu")
        assert int(got.iterations) == int(want.iterations)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9)


def test_warm_start_matches_cgx():
    dia = lap2d_fd(12)
    b = source_term(144)
    x0 = np.random.default_rng(2).standard_normal(144)
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b), jnp.asarray(x0), tol=1e-8)
    got = cgx_torch.cg_solve(_op(dia), b, torch.as_tensor(x0), tol=1e-8, device="cpu")
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9)


def _cgx_precond(kind, dia):
    from cgx.solver.precond import jacobi, neumann_banded

    op = cgx.DiaOperator.from_host(dia)
    if kind == "jacobi":
        return jacobi(op.diagonal())
    return neumann_banded(op.bands, op.offsets, sweeps=2)


def _port_precond(kind, op):
    from cgx_torch.solver.precond import jacobi, neumann_banded

    if kind == "jacobi":
        return jacobi(op.diagonal())
    return neumann_banded(op.bands, op.offsets, sweeps=2)


@pytest.mark.parametrize("kind", ["jacobi", "neumann"])
def test_precond_matches_cgx(kind):
    """cg_solve(precond=...) against cgx's: the count, the solution, and
    rsold = <r, z> (not <r, r>) on a variable-coefficient problem, where
    Jacobi is not a uniform scaling."""
    from cgx.mats.generators import poisson2d_var

    coeff = np.exp(np.random.default_rng(3).uniform(-2.0, 2.0, (24, 24)))
    dia = poisson2d_var(24, coeff)
    b = source_term(dia.shape[0])
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b), tol=1e-8,
                        precond=_cgx_precond(kind, dia))
    op = _op(dia)
    got = cgx_torch.cg_solve(op, b, tol=1e-8, precond=_port_precond(kind, op), device="cpu")
    plain = cgx_torch.cg_solve(op, b, tol=1e-8, device="cpu")
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert kind == "jacobi" or int(got.iterations) < int(plain.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(want.x)).max())
    assert float(got.rsold) == pytest.approx(float(want.rsold), rel=1e-6)
    assert float(got.residual_norm) == pytest.approx(float(want.residual_norm), rel=1e-6)


def test_identity_precond_is_the_unpreconditioned_loop_bit_for_bit():
    """With M = I the preconditioned recurrence performs exactly the
    operations of the plain one, so precond=None and precond=identity give
    the same bits (cgx precond.py:4-6); a zero RHS is pre-converged under a
    preconditioner too."""
    dia = lap2d_fd(16)
    b = source_term(256)
    plain = cgx_torch.cg_solve(_op(dia), b, tol=1e-6, history=64, device="cpu")
    ident = cgx_torch.cg_solve(_op(dia), b, tol=1e-6, history=64, precond=lambda r: r,
                               device="cpu")
    for field in plain._fields:
        a, c = getattr(plain, field), getattr(ident, field)
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int64), c.view(torch.int64)), field
        else:
            assert torch.equal(a, c), field
    zero = cgx_torch.cg_solve(_op(dia), np.zeros(256), precond=_port_precond("neumann", _op(dia)),
                              device="cpu")
    assert bool(zero.converged) and int(zero.iterations) == 0 and float(zero.residual_norm) == 0.0

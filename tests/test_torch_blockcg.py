"""cgx_torch.solver.blockcg against cgx.solver.blockcg on the CPU (x64):
both recurrences at s = 1, 3 and 4, duplicate and near-duplicate
columns, the preconditioned and dense paths, the deflated block solve,
TF32 off inside the loops, and cgx's errors (tests/test_blockcg.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver.blockcg import block_cg_solve as cgx_block
from cgx.solver.blockcg import block_deflated_cg_solve as cgx_block_deflated
from cgx_torch.solver import blockcg
from cgx_torch.solver.blockcg import block_cg_solve, block_deflated_cg_solve

G = 16
N = G * G
XTOL = 1e-10


@pytest.fixture(scope="module")
def ops():
    return cgx.as_operator(cgx.lap2d_fd(G)), cgx_torch.as_operator(cgx_torch.lap2d_fd(G),
                                                                   device="cpu")


def _same(got, want, xtol=XTOL):
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    assert bool(got.breakdown) == bool(want.breakdown)
    want_x = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - want_x)) <= xtol * np.max(np.abs(want_x))
    np.testing.assert_allclose(got.residual_norms.numpy(), np.asarray(want.residual_norms),
                               rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("s", [1, 3, 4])
@pytest.mark.parametrize("method", ["breakdown_free", "oleary"])
def test_matches_cgx(ops, method, s):
    opc, opt = ops
    b = np.random.default_rng(s).standard_normal((N, s))
    want = cgx_block(opc, jnp.asarray(b), tol=1e-10, method=method)
    got = block_cg_solve(opt, b, tol=1e-10, method=method, device="cpu")
    assert bool(got.converged.all()) and not bool(got.breakdown)
    _same(got, want)


def test_duplicate_columns(ops):
    """Two equal columns and a 1e-9 perturbation of them: the
    breakdown-free recurrence solves all three as cgx's does."""
    opc, opt = ops
    rng = np.random.default_rng(0)
    b0 = rng.standard_normal(N)
    b = np.stack([b0, b0, b0 + 1e-9 * rng.standard_normal(N)], axis=1)
    want = cgx_block(opc, jnp.asarray(b), tol=1e-10)
    got = block_cg_solve(opt, b, tol=1e-10, device="cpu")
    assert bool(got.converged.all()) and not bool(got.breakdown)
    _same(got, want, xtol=1e-9)


def test_near_duplicate_columns_break_oleary(ops):
    """The textbook recurrence breaks down on near-duplicate columns and
    says so, as cgx's does (tests/test_blockcg.py:106). Which iteration's
    jittered Cholesky fails first is decided by rounding in a Gram that is
    singular to working precision, so the two need not stop at the same k."""
    opc, opt = ops
    b0 = cgx_torch.source_term(N)
    b = np.stack([b0, b0 + 1e-9 * np.random.default_rng(0).standard_normal(N)], axis=1)
    want = cgx_block(opc, jnp.asarray(b), tol=1e-10, method="oleary")
    got = block_cg_solve(opt, b, tol=1e-10, method="oleary", device="cpu")
    assert bool(got.breakdown) and bool(want.breakdown)
    assert not bool(got.converged.any()) and not bool(np.asarray(want.converged).any())
    assert int(got.iterations) < N


def test_fp32_reports_the_true_residual(ops):
    """fp32, duplicate columns: the rank threshold scales with eps, and
    the residual norms and flags come from the true residual, as cgx's."""
    dia = cgx_torch.lap2d_fd(G)
    b0 = cgx_torch.source_term(N).astype(np.float32)
    b = np.stack([b0, b0], axis=1)
    opc32 = cgx.as_operator(cgx.lap2d_fd(G), dtype=jnp.float32)
    opt32 = cgx_torch.as_operator(dia, torch.float32, device="cpu")
    want = cgx_block(opc32, jnp.asarray(b), tol=1e-2)
    got = block_cg_solve(opt32, torch.tensor(b), tol=1e-2, device="cpu")
    assert got.x.dtype == torch.float32
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.residual_norms.numpy(), np.asarray(want.residual_norms),
                               rtol=0.5)
    x = got.x.numpy().astype(np.float64)
    for j in range(2):
        assert np.linalg.norm(dia.mat_vec(x[:, j]) - b0) / np.linalg.norm(b0) < 1e-5


@pytest.mark.parametrize("pc_name", ["mg", "jacobi"])
def test_preconditioned_matches_cgx(ops, pc_name):
    from cgx.solver.multigrid import mg_preconditioner as cgx_mg
    from cgx.solver.precond import jacobi as cgx_jacobi

    from cgx_torch.solver.multigrid import mg_preconditioner
    from cgx_torch.solver.precond import jacobi

    opc, opt = ops
    if pc_name == "mg":
        pcc, pct = cgx_mg(opc, ndim=2).apply, mg_preconditioner(opt, ndim=2).apply
    else:
        pcc, pct = cgx_jacobi(opc.diagonal()), jacobi(opt.diagonal())
    b = np.random.default_rng(7).standard_normal((N, 4))
    want = cgx_block(opc, jnp.asarray(b), tol=1e-10, precond=pcc)
    got = block_cg_solve(opt, b, tol=1e-10, precond=pct, device="cpu")
    assert bool(got.converged.all())
    _same(got, want)


def test_mg_applies_to_the_block_at_once(ops):
    """The multigrid cycle takes the (n, s) block as one batch: one apply
    an iteration, with each column as the single-vector apply gives it."""
    from cgx_torch.solver.multigrid import mg_preconditioner

    _, opt = ops
    mg = mg_preconditioner(opt, ndim=2)
    calls = []
    orig = mg._vcycle

    def counting(level, r):
        if level == 0:
            calls.append(tuple(r.shape))
        return orig(level, r)

    mg._vcycle = counting
    r = torch.tensor(np.random.default_rng(1).standard_normal((N, 3)))
    z = blockcg.columnwise(mg.apply)(r)
    assert calls == [(3, N)]
    for j in range(3):
        torch.testing.assert_close(z[:, j], orig(0, r[:, j]), rtol=1e-13, atol=1e-13)


def test_dense_path_matches_cgx():
    a = np.asarray(cgx.lap2d_fd(G).to_dense())
    b = np.random.default_rng(3).standard_normal((N, 3))
    want = cgx_block(jnp.asarray(a), jnp.asarray(b), tol=1e-10)
    got = block_cg_solve(torch.tensor(a), b, tol=1e-10, device="cpu")
    _same(got, want)


def test_callable_operator(ops):
    _, opt = ops
    b = np.random.default_rng(4).standard_normal((N, 2))
    mv = blockcg.block_matvec(opt)
    got = block_cg_solve(mv, b, tol=1e-10, device="cpu")
    want = block_cg_solve(opt, b, tol=1e-10, device="cpu")
    assert int(got.iterations) == int(want.iterations) and torch.equal(got.x, want.x)


def test_block_deflated_matches_cgx(ops):
    """cgx's Lanczos W carried to the port: the same deflated block k."""
    from cgx.solver.deflated import DeflationBasis as CgxBasis

    opc, opt = ops
    basis_c = CgxBasis.from_lanczos(opc, k=8)
    basis_t = cgx_torch.basis_from_cgx(basis_c, opt)
    b = np.random.default_rng(5).standard_normal((N, 3))
    want = cgx_block_deflated(opc, jnp.asarray(b), basis_c, tol=1e-10)
    got = block_deflated_cg_solve(opt, b, basis_t, tol=1e-10, device="cpu")
    assert bool(got.converged.all())
    _same(got, want)


@pytest.mark.parametrize("method", ["breakdown_free", "oleary", "deflated"])
def test_tf32_off_inside_the_loop(ops, method, monkeypatch):
    """Every product of the block loops runs at full float32: the
    mat-vec sees precision "highest" (TF32 off), whatever the caller set,
    and the caller's setting comes back."""
    _, opt = ops
    seen = []
    base = blockcg.block_matvec(opt)

    def mv(p):
        seen.append(torch.get_float32_matmul_precision())
        return base(p)

    b = np.random.default_rng(6).standard_normal((N, 2))
    basis = cgx_torch.DeflationBasis.from_lanczos(opt, k=4)
    monkeypatch.setattr(blockcg, "block_matvec", lambda a: mv)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        if method == "deflated":
            block_deflated_cg_solve(opt, b, basis, tol=1e-8, device="cpu")
        else:
            block_cg_solve(opt, b, tol=1e-8, method=method, device="cpu")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(old)
    assert seen and set(seen) == {"highest"}


def test_errors(ops):
    _, opt = ops
    b = np.ones((N, 2))
    with pytest.raises(ValueError, match="unknown block CG method"):
        block_cg_solve(opt, b, method="nope", device="cpu")
    with pytest.raises(ValueError, match="b_block must be"):
        block_cg_solve(opt, np.ones(N), device="cpu")
    with pytest.raises(ValueError, match="precond requires"):
        block_cg_solve(opt, b, method="oleary", precond=lambda r: r, device="cpu")
    with pytest.raises(TypeError, match="needs an operator"):
        block_deflated_cg_solve(lambda p: p, b, None, device="cpu")

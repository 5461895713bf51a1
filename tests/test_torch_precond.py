"""cgx_torch's preconditioners (solver/precond.py) and host spectral
bounds (solver/chebyshev.py) against cgx's on the same numpy inputs, on
the CPU (mirrors tests/test_precond_blockjacobi.py and the bounds and
polynomial tests of tests/test_chebyshev.py): the block extraction bit
for bit, PCG iteration counts equal to cgx's, the bounds within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver import chebyshev as cgx_cheb
from cgx.solver import precond as cgx_pc
from cgx_torch import SolveConfig
from cgx_torch.mats import generators as tgen
from cgx_torch.solver import chebyshev, precond


def _op(dia, dtype=torch.float64):
    return cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=dtype, device="cpu")


def _rel(dense, x, b):
    return float(np.linalg.norm(dense @ np.asarray(x, np.float64) - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def mat():
    return tgen.lap2d_fd(10)  # N = 100


@pytest.mark.parametrize("m", [1, 7, 10, 32, 100])
@pytest.mark.parametrize("form", ["dia", "operator", "dense", "dense_tensor"])
def test_diag_blocks_bitwise(mat, form, m):
    """The block diagonal (a non-dividing m pads with identity) from each
    form of the matrix, bit for bit cgx's from the DIA matrix."""
    src = {"dia": lambda: mat, "operator": lambda: _op(mat),
           "dense": lambda: mat.to_dense(),
           "dense_tensor": lambda: cgx_torch.DenseOperator(torch.tensor(mat.to_dense()))}[form]()
    want = cgx_pc.diag_blocks(cgx.lap2d_fd(10), m)
    got = precond.diag_blocks(src, m)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_diag_blocks_padded_rows_and_bad_size(mat):
    np.testing.assert_array_equal(precond.diag_blocks(mat, 8, n_rows=112),
                                  cgx_pc.diag_blocks(cgx.lap2d_fd(10), 8, n_rows=112))
    with pytest.raises(ValueError, match="block_size"):
        precond.diag_blocks(mat, 0)
    with pytest.raises(ValueError, match="n_rows"):
        precond.diag_blocks(mat, 8, n_rows=50)


def test_invert_spd_blocks_bitwise_and_rejects_non_spd(mat):
    blocks = precond.diag_blocks(mat, 7)
    np.testing.assert_array_equal(precond.invert_spd_blocks(blocks),
                                  cgx_pc.invert_spd_blocks(blocks))
    bad = np.stack([np.eye(3), np.diag([1.0, -2.0, 1.0])])
    with pytest.raises(ValueError, match="SPD"):
        precond.invert_spd_blocks(bad)
    with pytest.raises(ValueError, match="SPD"):
        cgx_pc.invert_spd_blocks(bad)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 100])
def test_block_jacobi_apply_matches_cgx(mat, m, dtype):
    """One apply on a seeded r: within 1e-14 (fp64) or 1e-6 (fp32) of
    cgx's; m = 1 is point Jacobi, m = n the direct solve."""
    r = np.random.default_rng(0).standard_normal(100)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(cgx_pc.block_jacobi(cgx.lap2d_fd(10), m, dtype=jdt)(jnp.asarray(r, jdt)))
    got = precond.block_jacobi(mat, m, dtype=dtype, device="cpu")(torch.tensor(r, dtype=dtype))
    assert got.dtype == dtype and got.shape == (100,)
    tol = 1e-14 if dtype == torch.float64 else 1e-6
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    if m == 1:
        np.testing.assert_allclose(got.numpy(), r / 4.0, rtol=tol)
    if m == 100 and dtype == torch.float64:
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(mat.to_dense(), r), rtol=1e-10)


def test_block_jacobi_is_symmetric(mat):
    u, v = (torch.tensor(a) for a in np.random.default_rng(3).standard_normal((2, 100)))
    bj = precond.block_jacobi(mat, 10, device="cpu")
    assert np.isclose(float(torch.dot(u, bj(v))), float(torch.dot(v, bj(u))), rtol=1e-12)


def test_block_jacobi_follows_the_operator_device(mat):
    """Inverses sit on the operator's device; a host container needs the
    card unless the caller asks for the CPU."""
    bj = precond.block_jacobi(_op(mat), 7)
    assert bj(torch.ones(100, dtype=torch.float64)).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            precond.block_jacobi(mat, 7)


@pytest.mark.parametrize("case", ["aniso_line", "var_contrast", "fd_default"])
def test_block_jacobi_pcg_matches_cgx(case):
    """PCG counts equal cgx's: line blocks on lap2d_aniso(32, 0.01) (cgx
    measured 339 -> 34), 8-row blocks on a jumping coefficient, the
    default block size on lap2d_fd(32); the true residual gate."""
    if case == "aniso_line":
        gen = lambda m: m.lap2d_aniso(32, 0.01)  # noqa: E731
        m_bj = 32
    elif case == "var_contrast":
        c = np.ones((24, 24))
        c[8:16, 8:16] = 1e3
        gen = lambda m: m.poisson2d_var(24, c)  # noqa: E731
        m_bj = 8
    else:
        gen = lambda m: m.lap2d_fd(32)  # noqa: E731
        m_bj = None
    want_mat, got_mat = gen(cgx), gen(tgen)
    n = got_mat.shape[0]
    b = tgen.source_term(n)
    cfg = dict(precond="block_jacobi", precond_block_size=m_bj)
    want = cgx.solve(want_mat, b, cgx.SolveConfig(**cfg))
    got = cgx_torch.solve(got_mat, b, SolveConfig(**cfg), device="cpu")
    plain = cgx_torch.solve(got_mat, b, device="cpu")
    assert bool(got.converged)
    assert int(got.iterations) == int(want.iterations)
    assert _rel(got_mat.to_dense(), got.x.numpy(), b) < 1e-9
    if case == "aniso_line":
        assert int(plain.iterations) > 300 and int(got.iterations) < 50


@pytest.mark.parametrize("make", [lambda m: m.lap2d_reference(400), lambda m: m.lap2d_fd(20)],
                         ids=["reference400", "fd20"])
def test_chebyshev_poly_pcg_matches_cgx(make):
    """chebyshev_poly(degree 3) on the Lanczos bounds (cgx's precond=
    "chebyshev") and chebyshev_banded on exact bounds: PCG counts equal
    cgx's, CG-safe, and the true residual gate."""
    want_mat, got_mat = make(cgx), make(tgen)
    n = got_mat.shape[0]
    b = tgen.source_term(n)
    want = cgx.solve(want_mat, b, cgx.SolveConfig(precond="chebyshev"))
    got = cgx_torch.solve(got_mat, b, SolveConfig(precond="chebyshev"), device="cpu")
    assert bool(got.converged) and not bool(got.breakdown)
    assert int(got.iterations) == int(want.iterations)
    assert _rel(got_mat.to_dense(), got.x.numpy(), b) < 1e-10

    w = np.linalg.eigvalsh(got_mat.to_dense())
    lo, hi = float(w.min()), float(w.max())
    pc_c = cgx_pc.chebyshev_banded(jnp.asarray(want_mat.bands), want_mat.offsets, lo, hi, 3)
    want = cgx.cg_solve(cgx.DiaOperator.from_host(want_mat), jnp.asarray(b), tol=1e-8,
                        precond=pc_c)
    op = _op(got_mat)
    pc_t = precond.chebyshev_banded(op.bands, op.offsets, lo, hi, degree=3)
    got = cgx_torch.cg_solve(op, b, tol=1e-8, precond=pc_t, device="cpu")
    assert bool(got.converged) and not bool(got.breakdown)
    assert int(got.iterations) == int(want.iterations)
    r = np.random.default_rng(5).standard_normal(n)
    z_t = pc_t(torch.tensor(r)).numpy()
    z_c = np.asarray(pc_c(jnp.asarray(r)))
    assert np.abs(z_t - z_c).max() <= 1e-13 * np.abs(z_c).max()


@pytest.mark.parametrize("make", [lambda m: m.lap2d_reference(256), lambda m: m.lap2d_fd(65),
                                  lambda m: m.lap3d_fd(6)],
                         ids=["reference256", "fd65", "3d6"])
def test_host_spectral_bounds_match_cgx(make):
    """Lanczos on the host, tightened by Gershgorin: within 1e-12 of cgx's,
    and bracketing the spectrum as cgx's test requires."""
    want_mat, got_mat = make(cgx), make(tgen)
    lo_c, hi_c = cgx_cheb.host_spectral_bounds(want_mat)
    lo, hi = chebyshev.host_spectral_bounds(got_mat)
    assert abs(lo - lo_c) <= 1e-12 * abs(lo_c) and abs(hi - hi_c) <= 1e-12 * abs(hi_c)
    w = np.linalg.eigvalsh(got_mat.to_dense())
    assert 0 < lo <= w.min() * 1.0001 and w.max() * 0.999 <= hi

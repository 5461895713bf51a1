"""The dense mat-vec (B3) and the sparse operators of cgx_torch against
cgx on the same inputs, on the CPU: the kernels' plain versions against
cgx's Pallas kernels in interpret mode, and the operators and their
solves against cgx's. The CUDA cases are in test_torch_wrappers.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import cgx
import cgx.ops.matvec as cgx_mv
import cgx.solver.operators as cgx_ops
import cgx_torch
from cgx.mats.containers import COOMatrix, CSRMatrix, ELLMatrix
from cgx.mats.generators import lap2d_fd, lap2d_reference
from cgx_torch.ops import matvec

# fp64: each product rounds once on both sides and only the order of the
# sums differs; fp32: the Pallas kernel traces under jax's x64-off mode
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(256, 256), (300, 300), (129, 257)]  # tests/test_kernels.py:24


def _inputs(rng, shape, dt):
    return rng.standard_normal(shape).astype(dt), rng.standard_normal(shape[1]).astype(dt)


def _assert_vec(got, want, dt):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= RTOL[dt] * np.max(np.abs(want))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_dense_matvec_plain_matches_cgx(rng, shape, dt):
    a, x = _inputs(rng, shape, dt)
    want = cgx_mv.dense_matvec(jnp.asarray(a), jnp.asarray(x), block_rows=64, block_cols=128,
                               interpret=True)
    got = matvec.dense_matvec_ref(torch.as_tensor(a), torch.as_tensor(x), block_rows=64,
                                  block_cols=128)
    assert got.dtype == torch.as_tensor(a).dtype and got.shape == (shape[0],)
    _assert_vec(got, want, dt)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_dense_matvec_dot_plain_matches_cgx(rng, shape, dt):
    a, x = _inputs(rng, shape, dt)
    want_y, want_d = cgx_mv.dense_matvec_dot(jnp.asarray(a), jnp.asarray(x), block_rows=64,
                                             block_cols=128, interpret=True)
    got_y, got_d = matvec.dense_matvec_dot_ref(torch.as_tensor(a), torch.as_tensor(x),
                                               block_rows=64, block_cols=128)
    _assert_vec(got_y, want_y, dt)
    m = min(shape)
    scale = float(np.sum(np.abs(x[:m].astype(np.float64) * np.asarray(want_y, np.float64)[:m])))
    assert got_d.dim() == 0 and abs(float(got_d) - float(want_d)) <= RTOL[dt] * scale


@pytest.mark.parametrize(
    "shape,tiles",
    [((1000, 1000), (1024, 128)),  # N divisible by neither tile, one row tile
     ((777, 500), (64, 96)),       # tall; tile widths off the warp's 32
     ((33, 700), (8, 4096)),       # one column tile wider than the matrix
     ((50, 50), (1, 1))],          # the smallest tiles
)
def test_dense_plain_ragged_tiles_match_numpy(rng, shape, tiles):
    a, x = _inputs(rng, shape, np.float64)
    br, bc = tiles
    y, d = matvec.dense_matvec_dot_ref(torch.as_tensor(a), torch.as_tensor(x),
                                       block_rows=br, block_cols=bc)
    want = a @ x
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    m = min(shape)
    assert abs(float(d) - x[:m] @ want[:m]) <= 1e-12 * np.sum(np.abs(x[:m] * want[:m]))


def test_dense_wrappers_on_cpu_run_plain_and_count(rng, monkeypatch):
    import cgx_torch._build as build

    def no_build():
        raise AssertionError("a CPU call must not build the CUDA kernels")

    monkeypatch.setattr(build, "load", no_build)
    a, x = (torch.as_tensor(v) for v in _inputs(rng, (129, 257), np.float64))
    before = (matvec.dense_matvec.launches, matvec.dense_matvec_dot.launches)
    y = matvec.dense_matvec(a, x, block_rows=64, block_cols=128)
    y2, d = matvec.dense_matvec_dot(a, x, block_rows=64, block_cols=128)
    assert (matvec.dense_matvec.launches, matvec.dense_matvec_dot.launches) == (
        before[0] + 1, before[1] + 1)
    ref_y, ref_d = matvec.dense_matvec_dot_ref(a, x, block_rows=64, block_cols=128)
    assert torch.equal(y, ref_y) and torch.equal(y2, ref_y) and torch.equal(d, ref_d)


def test_dense_wrappers_reject_bad_operands():
    a = torch.zeros(8, 8, dtype=torch.float64)
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError):  # columns do not match x
        matvec.dense_matvec(torch.zeros(8, 9, dtype=torch.float64), x)
    with pytest.raises(ValueError):  # a and x dtypes differ
        matvec.dense_matvec(a.float(), x)
    with pytest.raises(ValueError):  # column-major view
        matvec.dense_matvec(torch.zeros(8, 8, dtype=torch.float64).T[:, :], x)
    with pytest.raises(ValueError):  # tile sizes must be positive
        matvec.dense_matvec_dot(a, x, block_rows=0)
    with pytest.raises(TypeError):  # a dtype the kernels do not take
        matvec.dense_matvec(a.half(), x.half())
    with pytest.raises(ValueError):  # not a matrix
        matvec.dense_matvec(x, x)


def test_pallas_dense_operator_solve_matches_cgx():
    """tests/test_fast_refine.py:99-117 on both sides: the same k, and x
    within 1e-5 relative. That test's tol 1e-4 is 2.5e-9 of ||b||, under
    the fp32 floor, where the two loops stop one iteration apart (56 and
    57); 1e-5 ||b|| is above it."""
    g = 16
    dia = lap2d_fd(g)
    b = cgx.source_term(g * g).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    want = cgx.cg_solve(cgx_ops.PallasDenseOperator(jnp.asarray(dia.to_dense(), jnp.float32),
                                                    64, 128),
                        jnp.asarray(b), tol=tol, maxiter=g * g)
    op = cgx_torch.PallasDenseOperator(torch.tensor(dia.to_dense(), dtype=torch.float32), 64, 128)
    before = matvec.dense_matvec.launches
    got = cgx_torch.cg_solve(op, b, tol=tol, maxiter=g * g, device="cpu")
    assert int(got.iterations) == int(want.iterations)
    assert matvec.dense_matvec.launches - before >= int(got.iterations) + 1
    want_x = np.asarray(want.x, np.float64)
    assert np.max(np.abs(got.x.numpy() - want_x)) <= 1e-5 * np.max(np.abs(want_x))
    assert torch.equal(op.diagonal(), torch.full((g * g,), 4.0))


def _random_spd_coo(n=60, seed=3):
    """Symmetric, and diagonally dominant with a positive diagonal: SPD."""
    m = sps.random(n, n, density=0.08, random_state=seed, format="coo")
    return (m + m.T + sps.identity(n) * n).tocoo()


PROBLEMS = {
    "lap2d_fd(20)": lambda: cgx.mats.generators.lap2d_fd_coo_lower(20),
    "random_spd": lambda: COOMatrix.from_scipy(_random_spd_coo()),
}
FORMATS = ["ell", "csr", "coo", "scipy"]


def _host(coo, fmt, pkg):
    """The same matrix as a host input of cgx (pkg=cgx) or of the port."""
    mod = cgx.mats.containers if pkg == "cgx" else cgx_torch.mats.containers
    coo = mod.COOMatrix(coo.shape, coo.rows, coo.cols, coo.values, coo.symmetric)
    return {"ell": lambda: mod.ELLMatrix.from_coo(coo), "csr": lambda: mod.CSRMatrix.from_coo(coo),
            "coo": lambda: coo, "scipy": lambda: coo.to_scipy().tocsr()}[fmt]()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_sparse_operators_match_cgx(problem, fmt):
    coo = PROBLEMS[problem]()
    n = coo.shape[0]
    x = np.random.default_rng(1).standard_normal(n)
    want_op = cgx_ops.as_operator(_host(coo, fmt, "cgx"))
    op = cgx_torch.as_operator(_host(coo, fmt, "port"), device="cpu")
    assert type(op).__name__ == type(want_op).__name__  # EllOperator or CsrOperator
    assert op.dtype == torch.float64 and op.shape == (n, n)
    want = np.asarray(want_op.matvec(jnp.asarray(x)))
    got = op.matvec(torch.as_tensor(x)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    np.testing.assert_allclose(op.diagonal().numpy(), np.asarray(want_op.diagonal()), rtol=1e-12)
    np.testing.assert_allclose(got, coo.mat_vec(x), rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_sparse_operator_solves_match_cgx(fmt):
    coo = cgx.mats.generators.lap2d_fd_coo_lower(16)
    b = cgx.source_term(256)
    want = cgx.cg_solve(cgx_ops.as_operator(_host(coo, fmt, "cgx")), jnp.asarray(b), tol=1e-6)
    got = cgx_torch.solve(_host(coo, fmt, "port"), b, cgx_torch.SolveConfig(tolerance=1e-6),
                          device="cpu")
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(want.x)).max())


def _cgx_operators():
    dia = lap2d_reference(64)
    coo = COOMatrix.from_scipy(_random_spd_coo(64))
    return {
        "dia": cgx_ops.DiaOperator.from_host(dia),
        "dense": cgx_ops.DenseOperator.from_host(dia.to_dense()),
        "pallas_dense": cgx_ops.PallasDenseOperator(jnp.asarray(dia.to_dense()), 16, 128),
        "ell": cgx_ops.EllOperator.from_host(ELLMatrix.from_coo(coo)),
        "csr": cgx_ops.CsrOperator.from_host(CSRMatrix.from_coo(coo)),
    }


@pytest.mark.parametrize("kind", ["dia", "dense", "pallas_dense", "ell", "csr"])
def test_operator_from_cgx_computes_the_same_product(kind):
    src = _cgx_operators()[kind]
    op = cgx_torch.operator_from_cgx(src, device="cpu")
    assert type(op).__name__ == type(src).__name__
    if kind == "pallas_dense":
        assert (op.block_rows, op.block_cols) == (16, 128)
    x = np.random.default_rng(2).standard_normal(64)
    want = np.asarray(src.matvec(jnp.asarray(x)))
    got = op.matvec(torch.as_tensor(x)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    f32 = cgx_torch.operator_from_cgx(src, dtype=torch.float32, device="cpu")
    assert f32.dtype == torch.float32


def test_densify_on_device_matches_host_dense():
    dia = cgx_torch.lap2d_fd(9)
    op = cgx_torch.as_operator(dia, device="cpu")
    dense = cgx_torch.densify_on_device(op)
    assert torch.equal(dense.a, torch.tensor(dia.to_dense()))
    assert cgx_torch.densify_on_device(op, torch.float32).a.dtype == torch.float32
    want = np.asarray(cgx_ops.densify_on_device(cgx_ops.DiaOperator.from_host(lap2d_fd(9))).a)
    np.testing.assert_array_equal(dense.a.numpy(), want)

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

import test_torch_dense_walk as walk

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


# dense_matvec's launch plan (cgx_torch/csrc/matvec.cu, dense_matvec_persistent_kernel)
H100_SMS = 132


@pytest.mark.parametrize("sms", [1, 7, H100_SMS])
@pytest.mark.parametrize("n_rows", [1, 5, 131, 132, 133, 1001, 10_000, 16_384, 40_000])
def test_dense_plan_rows_cover_each_row_once(n_rows, sms):
    """The persistent grid's row ranges are contiguous, in block order,
    and cover [0, N) exactly once; no more blocks than SMs unless a
    block's rows would outgrow its shared memory."""
    plan = matvec.dense_plan(n_rows, n_rows, 128, torch.float64, sms)
    assert 1 <= plan.grid <= max(sms, -(-n_rows // matvec.DENSE_MAX_ROWS))
    covered = np.zeros(n_rows, dtype=int)
    end = 0
    rpc = plan.rows_per_cta  # block b: rows [b rpc, (b + 1) rpc) within [0, N)
    for lo, hi in ((min(b * rpc, n_rows), min((b + 1) * rpc, n_rows)) for b in range(plan.grid)):
        assert lo == end or lo == hi == n_rows
        covered[lo:hi] += 1
        end = hi
    assert end == n_rows and np.all(covered == 1)
    assert (plan.grid - 1) * plan.rows_per_cta < n_rows  # no block without rows


@pytest.mark.parametrize(
    "n,block_cols,dtype,staging,chunk",
    [(10_000, 128, torch.float32, "whole", 10_000),  # the reference's run, 1024 x 128
     (10_000, 128, torch.float64, "whole", 10_000),
     (16_384, 512, torch.float32, "whole", 16_384),  # the defaults, 256 x 512
     (16_384, 512, torch.float64, "whole", 16_384),
     (40_000, 128, torch.float32, "chunks", 133 * 128),  # x and the tile sums outgrow 227 KB
     (40_000, 128, torch.float64, "chunks", 66 * 128),
     (40_000, 40_000, torch.float64, "global", 40_000)],  # one tile wider than shared memory
)
def test_dense_plan_staging(n, block_cols, dtype, staging, chunk):
    """x is staged whole where it and the tile sums fit one block's
    shared memory, else by the widest chunk of whole tiles that fits, and
    read in place where not even one tile fits."""
    plan = matvec.dense_plan(n, n, block_cols, dtype, H100_SMS)
    item = torch.finfo(dtype).bits // 8
    assert (plan.staging, plan.chunk_cols) == (staging, chunk)
    assert plan.shared <= matvec.SHARED_OPTIN
    assert plan.shared == matvec.dense_shared(plan.chunk_cols, block_cols, plan.rows_per_cta,
                                              item, staging != "global")
    if staging == "chunks":
        assert plan.chunk_cols % block_cols == 0
        wider = plan.chunk_cols + block_cols  # one tile more does not fit
        assert matvec.dense_shared(wider, block_cols, plan.rows_per_cta, item,
                                   True) > matvec.SHARED_OPTIN


@pytest.mark.parametrize(
    "n,block_cols,dtype,aligned",
    [(10_000, 128, torch.float64, True), (10_000, 128, torch.float32, True),
     (1001, 37, torch.float64, False), (1001, 37, torch.float32, False),  # odd N: peeled
     (1001, 128, torch.float64, False),  # odd N: every other row starts off the grid
     (1002, 128, torch.float32, False),  # N not a multiple of 4 in float32
     (1002, 128, torch.float64, True), (1000, 100, torch.float32, True),
     (1000, 37, torch.float32, False)],  # tiles off the grid
)
def test_dense_plan_aligned_or_peeled(n, block_cols, dtype, aligned):
    """Vector loads throughout only where every row start, tile and chunk
    is 16 bytes aligned; else the peeled scalar head and tail."""
    assert matvec.dense_plan(n, n, block_cols, dtype, H100_SMS).aligned is aligned
    assert matvec.dense_plan(n, n, block_cols, dtype, H100_SMS,
                             pointers_aligned=False).aligned is False


# --- both dense kernels' summation grouping, walked in torch ----------------
# (the walks live in tests/test_torch_dense_walk.py, which imports no JAX, so
# that its CUDA cases hold the card's kernels to them)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", walk.CASES)
def test_dense_kernels_share_one_grouping(case, dtype):
    """dense_matvec's y by the lane model (persistent_walk) is bitwise the
    y that a line-by-line walk of dense_matvec_dot's kernel forms
    (kernel_walk: spans, vdot, peeled_part, transpose_sum8's shuffles,
    the running sums), on and off the 16-byte grid; the walk's dot agrees
    with the plain version; the one-warp-a-row grouping it replaced gives
    another y on random matrices. The CUDA cases of
    test_torch_dense_walk.py hold the card's kernels bitwise to the walk."""
    a, x, br, bc = walk.case_inputs(case, dtype)
    plan = matvec.dense_plan(a.shape[0], a.shape[1], bc, dtype, H100_SMS)
    y1 = walk.persistent_walk(a, x, bc, plan)  # dense_matvec
    y2, d = walk.kernel_walk(a, x, br, bc, plan)  # dense_matvec_dot
    assert torch.equal(y1, y2)
    want_y, want_d = matvec.dense_matvec_dot_ref(a, x, block_rows=br, block_cols=bc)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y1 - want_y).abs().max()) <= rtol * float(want_y.abs().max())
    m = min(a.shape)
    assert abs(float(d - want_d)) <= rtol * float((x[:m] * want_y[:m]).abs().sum())
    if not case.startswith("lap2d") and bc > 1:
        assert not torch.equal(walk.row_walk(a, x, bc), y1)

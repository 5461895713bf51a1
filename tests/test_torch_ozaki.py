"""cgx_torch's Ozaki dense operator (ops/ozaki.py) against cgx's
(cgx/ops/ozaki.py) on the same seeded numpy inputs, on the CPU, and
solve's dense_fp64 routing (cgx api.py:564-582).

The slices and scales are held bitwise against cgx's (device build and
build_slices_np). torch._int_mm, which runs on this CPU's torch, is held
bitwise against its plain version, a float64 product of the same slices
(exact in any order: every partial sum is an integer below 2^31). The
mat-vec's fp64 combine sums the S^2 pair partials in the library's
order, so it is held to cgx's within fp64 rounding of each dot's mass,
and to the fp64 product within tests/test_ozaki.py's 1e-14.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
from cgx.ops import ozaki as cgx_oz
from cgx.solver.operators import DenseOperator as CgxDense

import cgx_torch
from cgx_torch import SolveConfig
from cgx_torch.mats.generators import lap2d_fd, source_term
from cgx_torch.ops import ozaki
from cgx_torch.solver import api
from cgx_torch.solver.operators import DenseOperator
from cgx_torch.solver.refine import iterative_refinement
from tests.conftest import make_spd

MASS_TOL = 1e-14  # tests/test_ozaki.py's bound, relative to |A| |x|


def _rel_to_mass(y, y_ref, a, x):
    return np.max(np.abs(y - y_ref) / (np.abs(a) @ np.abs(x) + 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("n,seed", [(80, 3), (130, 4), (257, 1)])
def test_slices_bitwise_cgx_and_int8_bounded(n, seed):
    """The (S, n, n) int8 slices and the row scales bitwise cgx's (its
    device build and build_slices_np, and ours of both); the leading
    slice within 2^(BETA-1), the rest in [0, 2^BETA - 1]; the scales
    powers of two at least twice the row maxima."""
    a = make_spd(n, seed=seed)
    c, sigma = ozaki._build_slices(_t(a), 8)
    c_j, sigma_j = cgx_oz._build_slices(jnp.asarray(a), 8)
    assert c.dtype == torch.int8 and c.shape == (8, n, n)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(sigma.numpy(), np.asarray(sigma_j))
    c_np, sigma_np = ozaki.build_slices_np(a, 8)
    c_cnp, sigma_cnp = cgx_oz.build_slices_np(a, 8)
    np.testing.assert_array_equal(c_np, c_cnp)
    np.testing.assert_array_equal(sigma_np, sigma_cnp)
    np.testing.assert_array_equal(c_np, c.numpy())
    cf = c.numpy().astype(np.float64)
    assert np.max(np.abs(cf[0])) <= 2.0 ** (ozaki.BETA - 1)
    assert np.min(cf[1:]) >= 0 and np.max(cf[1:]) <= 2.0 ** ozaki.BETA - 1
    assert 2 * ozaki.BETA + np.log2(ozaki.NMAX) <= 31
    s = sigma.numpy()
    assert np.all(s >= 2 * np.max(np.abs(a), axis=1)) and np.all(np.exp2(np.round(np.log2(s))) == s)


def test_pow2_bound_at_exact_powers_and_zero():
    """Exact powers of two (the Laplacian's row maximum 4) take the
    power itself, doubled; zeros take 1; bitwise cgx's."""
    v = np.array([4.0, 1.0, 0.5, 3.0, 0.0, 2.0**40, 2.0**-40, 7.999999999, 1e300])
    np.testing.assert_array_equal(ozaki._pow2_bound(_t(v)).numpy(),
                                  np.asarray(cgx_oz._pow2_bound(jnp.asarray(v))))


def test_int_mm_bitwise_its_plain_version():
    """torch._int_mm of slice-shaped int8 operands (more than 16 rows,
    K and N multiples of 8) bitwise the float64 product of the same
    values, at the extremes of the int8 ranges too."""
    rng = np.random.default_rng(0)
    a = _t(rng.integers(-64, 65, (8 * 40, 72)).astype(np.int8))
    b = _t(rng.integers(0, 128, (72, 16)).astype(np.int8))
    got = ozaki.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, ozaki.int8_matmul_ref(a, b))
    full = torch.full((24, 4096), -64, dtype=torch.int8)
    top = torch.full((4096, 8), 127, dtype=torch.int8)
    assert torch.equal(ozaki.int8_matmul(full, top), ozaki.int8_matmul_ref(full, top))
    assert int(ozaki.int8_matmul(full, top)[0, 0]) == -64 * 127 * 4096


@pytest.mark.parametrize("n", [30, 257, 700])
def test_matvec_fp64_quality_and_cgx(n):
    """One-shot ozaki_matvec: within 1e-14 of the fp64 product relative to
    each dot's mass, and within 1e-15 of cgx's."""
    a = make_spd(n, seed=n)
    x = np.random.default_rng(n).standard_normal(n) * 1e6
    y = ozaki.ozaki_matvec(_t(a), _t(x)).numpy()
    assert _rel_to_mass(y, a @ x, a, x) < MASS_TOL
    want = np.asarray(cgx_oz.ozaki_matvec(jnp.asarray(a), jnp.asarray(x)))
    assert _rel_to_mass(y, want, a, x) < 1e-15


def test_ill_scaled_rows_and_x():
    rs = np.random.default_rng(7)
    n = 320
    a = make_spd(n, seed=9) * np.exp2(rs.integers(-30, 30, size=n))[:, None]
    x = rs.standard_normal(n) * np.exp2(rs.integers(-20, 20, size=n))
    assert _rel_to_mass(ozaki.ozaki_matvec(_t(a), _t(x)).numpy(), a @ x, a, x) < MASS_TOL


def test_zero_rows_and_zero_x():
    n = 64
    a = make_spd(n, seed=2)
    a[5, :] = 0.0
    assert not ozaki.ozaki_matvec(_t(a), torch.zeros(n, dtype=torch.float64)).any()
    x = np.random.default_rng(0).standard_normal(n)
    y = ozaki.ozaki_matvec(_t(a), _t(x)).numpy()
    assert y[5] == 0.0 and _rel_to_mass(y, a @ x, a, x) < MASS_TOL


def test_tiny_entry_boundary():
    """The reference source term's near-zero entries against a 1e5 column
    maximum: no slice leaves int8 (the clamp), the slices of b bitwise
    cgx's, and b reconstructed within 2^-50."""
    b = source_term(400)
    d, tau = ozaki._slice_vector(_t(b)[:, None], 8)
    d_j, tau_j = cgx_oz._slice_vector(jnp.asarray(b)[:, None], 8)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(tau.numpy(), np.asarray(tau_j))
    df = d.numpy().astype(np.float64)
    assert np.max(df) <= 2.0 ** ozaki.BETA - 1 and np.min(df) >= -(2.0 ** (ozaki.BETA - 1))
    recon = sum(df[t, :, 0] * 2.0 ** (-(t + 1) * ozaki.BETA) for t in range(8)) * float(tau[0])
    assert np.max(np.abs(recon - b)) <= 2.0 ** -50 * np.max(np.abs(b))
    a = make_spd(400, seed=5)
    assert _rel_to_mass(ozaki.ozaki_matvec(_t(a), _t(b)).numpy(), a @ b, a, b) < MASS_TOL


def test_operator_multi_rhs_and_diagonal():
    """OzakiDenseOperator on n = 150 (slices padded to 152 columns for
    _int_mm) and on a (n, 5) block: each column within 1e-14, equal to
    the one-shot product, the diagonal A's."""
    n, s = 150, 5
    a = make_spd(n, seed=11)
    op = ozaki.OzakiDenseOperator.from_dense(_t(a))
    assert op.shape == (n, n) and op.c.shape == (8, n, 152) and op.dtype == torch.float64
    assert not op.c[..., n:].any()
    c_j, _ = cgx_oz._build_slices(jnp.asarray(a), 8)
    np.testing.assert_array_equal(op.c[..., :n].numpy(), np.asarray(c_j))
    x = np.random.default_rng(1).standard_normal(n)
    assert torch.equal(op.matvec(_t(x)), ozaki.ozaki_matvec(_t(a), _t(x)))
    np.testing.assert_array_equal(op.diagonal().numpy(), np.diag(a))
    rs = np.random.default_rng(2)
    xs = rs.standard_normal((n, s)) * np.exp2(rs.integers(-8, 8, (n, s)))
    ys = op.matvec(_t(xs)).numpy()
    want = np.asarray(cgx_oz.OzakiDenseOperator.from_dense(jnp.asarray(a)).matvec(
        jnp.asarray(xs)))
    for j in range(s):
        assert _rel_to_mass(ys[:, j], a @ xs[:, j], a, xs[:, j]) < MASS_TOL
        assert _rel_to_mass(ys[:, j], want[:, j], a, xs[:, j]) < 1e-15
    with pytest.raises(ValueError, match="n <= "):
        ozaki.OzakiDenseOperator.from_dense(torch.zeros(2, ozaki.NMAX + 1, dtype=torch.float64))


def _dense(g):
    dia = lap2d_fd(g)
    return dia.to_dense(), source_term(g * g)


def test_cg_on_the_ozaki_operator_matches_cgx():
    """CG on lap2d_fd(20) densified, tol 1e-10: the Ozaki operator's k
    equal to cgx's Ozaki CG, within 2 of the fp64 product's, true
    residual below 1e-11."""
    a, b = _dense(20)
    op = ozaki.OzakiDenseOperator.from_dense(_t(a))
    res = cgx_torch.cg_solve(op, b, tol=1e-10, device="cpu")
    res64 = cgx_torch.cg_solve(DenseOperator(_t(a)), b, tol=1e-10, device="cpu")
    want = cgx.cg_solve(cgx_oz.OzakiDenseOperator.from_dense(jnp.asarray(a)), jnp.asarray(b),
                        tol=1e-10)
    assert bool(res.converged)
    assert int(res.iterations) == int(want.iterations)
    assert abs(int(res.iterations) - int(res64.iterations)) <= 2
    assert np.linalg.norm(a @ res.x.numpy() - b) / np.linalg.norm(b) < 1e-11


def test_refinement_with_an_ozaki_outer():
    """iterative_refinement with the Ozaki operator forming the outer fp64
    residual and a plain fp32 dense inner (inner_op=), as
    tests/test_ozaki.py:138: converged, true residual below 1e-11, the
    sweeps within 1 of cgx's."""
    a, b = _dense(20)
    op = ozaki.OzakiDenseOperator.from_dense(_t(a))
    res = iterative_refinement(op, b, tol=1e-10, inner_tol_factor=1e-6,
                               inner_op=DenseOperator(_t(a.astype(np.float32))), device="cpu")
    from cgx.solver.refine import iterative_refinement as cgx_refine

    want = cgx_refine(cgx_oz.OzakiDenseOperator.from_dense(jnp.asarray(a)), jnp.asarray(b),
                      tol=1e-10, inner_tol_factor=1e-6,
                      inner_op=CgxDense(jnp.asarray(a, jnp.float32)))
    assert bool(res.converged)
    assert abs(res.outer_iterations - want.outer_iterations) <= 1
    assert np.linalg.norm(a @ res.x.numpy() - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.parametrize("mode", ["ozaki", "emulated", "auto"])
def test_solve_dense_fp64_routing(mode, monkeypatch):
    """solve(dense, b, SolveConfig(dense_fp64=mode)) on lap2d_fd(16)
    densified: "ozaki" runs the Ozaki operator (its k equal to cgx's),
    "emulated" and "auto" the fp64 product (k equal to cgx's
    "emulated"); each reaches a true residual below 1e-11."""
    a, b = _dense(16)
    seen = []
    apply = ozaki._ozaki_apply

    def recorded(*args, **kwargs):
        seen.append(1)
        return apply(*args, **kwargs)

    monkeypatch.setattr(ozaki, "_ozaki_apply", recorded)
    res = cgx_torch.solve(cgx_torch.DenseMatrix(a), b,
                          SolveConfig(dense_fp64=mode, tolerance=1e-10), device="cpu")
    want = cgx.solve(cgx.DenseMatrix(a), b, cgx.SolveConfig(
        dense_fp64="ozaki" if mode == "ozaki" else "emulated", tolerance=1e-10))
    assert bool(seen) == (mode == "ozaki")
    assert bool(res.converged) and int(res.iterations) == int(want.iterations)
    assert np.linalg.norm(a @ res.x.numpy() - b) / np.linalg.norm(b) < 1e-11


def test_maybe_ozaki_rule():
    """_maybe_ozaki: "ozaki" slices a dense fp64 operator; "auto" keeps the
    fp64 product on the CPU and, by design, on CUDA too (the rule reads no
    device); fp32 and banded operators pass through; an unknown mode
    raises cgx's ValueError."""
    a, _ = _dense(4)
    dense = DenseOperator(_t(a))
    assert isinstance(api._maybe_ozaki(dense, SolveConfig(dense_fp64="ozaki")),
                      ozaki.OzakiDenseOperator)
    for mode in ("auto", "emulated"):
        assert api._maybe_ozaki(dense, SolveConfig(dense_fp64=mode)) is dense
    f32 = DenseOperator(_t(a.astype(np.float32)))
    assert api._maybe_ozaki(f32, SolveConfig(dense_fp64="ozaki")) is f32
    dia = cgx_torch.as_operator(lap2d_fd(4), device="cpu")
    assert api._maybe_ozaki(dia, SolveConfig(dense_fp64="ozaki")) is dia
    with pytest.raises(ValueError, match="unknown dense_fp64 mode"):
        api._maybe_ozaki(dense, SolveConfig(dense_fp64="bf16"))

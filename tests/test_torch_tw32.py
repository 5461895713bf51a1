"""cgx_torch's triple-word float32 module (ops/tw32.py) against cgx's
(cgx/ops/tw32.py) on the same seeded numpy inputs, on the CPU.

The words are held bitwise against cgx's wherever the two run the same
float32 operations: every function but residual_tw's fp64 norm and
comp_block_gram's per-chunk products, whose summation order is the
library's, and the eps^2 terms of the three-plane product, which
XLA:CPU contracts into FMAs (those within stated roundoff). The numpy
longdouble referee of tests/test_tw32.py (x86 80-bit, eps about
5.4e-20) holds the exactness claims themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgx.mats import generators as cgx_gen
from cgx.ops import tw32 as cgx_tw

from cgx_torch.mats.generators import lap2d_fd, poisson2d_var
from cgx_torch.ops import tw32


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _eq(got, want):
    """Bitwise equality of a tensor (or a tuple of them) with cgx's."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g.view(np.uint32 if g.dtype == np.float32 else np.uint64),
                                  w.view(np.uint32 if w.dtype == np.float32 else np.uint64))


def _ld(words):
    return sum(np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w, np.longdouble)
               for w in words)


def _f32(rng, n, spread=20):
    return (rng.standard_normal(n) * np.exp2(rng.integers(-spread, spread, n))).astype(np.float32)


def _triple(rng, n):
    """A canonical triple from a random fp64 vector (tw_from_f64, cgx's)."""
    x = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    return tuple(np.asarray(w) for w in cgx_tw.tw_from_f64(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["two_sum32", "fast_two_sum32", "two_prod32"])
def test_eft_pairs_bitwise_and_exact(name):
    """The error-free pairs bitwise cgx's, and exact: fp64 is an exact
    referee of a float32 sum or product."""
    rng = np.random.default_rng(0)
    a, b = _f32(rng, 4096), _f32(rng, 4096)
    if name == "fast_two_sum32":  # needs |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    got = getattr(tw32, name)(_t(a), _t(b))
    _eq(got, getattr(cgx_tw, name)(_j(a), _j(b)))
    exact = a.astype(np.float64) * b if name == "two_prod32" else a.astype(np.float64) + b
    assert np.all(got[0].numpy().astype(np.float64) + got[1].numpy() == exact)


def test_renorm_and_triple_ops_bitwise():
    """tw_renorm, tw_add_f32, tw_add_tw, tw_neg and tw_scale_f32 (by a
    scalar and by a vector) word for word cgx's."""
    rng = np.random.default_rng(1)
    n = 2048
    x, y = _triple(rng, n), _triple(rng, n)
    v = _f32(rng, n)
    c = tuple(_f32(rng, n, 10) * np.float32(scale) for scale in (1.0, 1e-8, 1e-16))
    tx, ty = tuple(map(_t, x)), tuple(map(_t, y))
    jx, jy = tuple(map(_j, x)), tuple(map(_j, y))
    _eq(tw32.tw_renorm(*map(_t, c)), cgx_tw.tw_renorm(*map(_j, c)))
    _eq(tw32.tw_add_f32(tx, _t(v)), cgx_tw.tw_add_f32(jx, _j(v)))
    _eq(tw32.tw_add_tw(tx, ty), cgx_tw.tw_add_tw(jx, jy))
    _eq(tw32.tw_neg(tx), cgx_tw.tw_neg(jx))
    a = np.float32(1.7318)
    _eq(tw32.tw_scale_f32(tx, torch.tensor(a)), cgx_tw.tw_scale_f32(jx, jnp.float32(a)))
    _eq(tw32.tw_scale_f32(tx, _t(v)), cgx_tw.tw_scale_f32(jx, _j(v)))
    z = tw32.tw_zero_like(torch.zeros(5, dtype=torch.float64))
    assert all(w.dtype == torch.float32 and not w.any() for w in z)


def test_from_f64_bitwise_and_round_trip_exact():
    """tw_from_f64 word for word cgx's, its triple exactly the fp64 value
    (longdouble referee); tw_to_f64 sums the words in cgx's order."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4096) * np.exp2(rng.integers(-40, 40, 4096).astype(np.float64))
    w = tw32.tw_from_f64(_t(x))
    _eq(w, cgx_tw.tw_from_f64(_j(x)))
    assert np.all(_ld(w) == np.asarray(x, np.longdouble))
    _eq(tw32.tw_to_f64(w), cgx_tw.tw_to_f64(cgx_tw.tw_from_f64(_j(x))))
    assert torch.equal(tw32.tw_to_f64(w), _t(x))


def test_add_scale_accuracy_longdouble():
    """tests/test_tw32.py's referee: x a + y within 5e-19 of the operand
    scale, three decades below fp64's 2.2e-16."""
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(2048), rng.standard_normal(2048)
    a = np.float32(1.7318)
    z = tw32.tw_add_tw(tw32.tw_scale_f32(tw32.tw_from_f64(_t(x)), torch.tensor(a)),
                       tw32.tw_from_f64(_t(y)))
    xl, yl = np.asarray(x, np.longdouble), np.asarray(y, np.longdouble)
    ref = xl * np.longdouble(a) + yl
    scale = np.abs(xl * np.longdouble(a)) + np.abs(yl)
    assert np.max(np.abs(_ld(z) - ref) / scale) < 5e-19


def _ld_matvec(bands, offsets, x_ld):
    n = x_ld.shape[0]
    bl = np.asarray(bands, np.longdouble)
    y = np.zeros(n, np.longdouble)
    for d, off in enumerate(offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        y[i0:i1] += bl[d, i0:i1] * x_ld[i0 + off: i1 + off]
    return y


@pytest.mark.parametrize("off", [0, 3, -3, 47, -47])
def test_shift_bitwise(off):
    x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    _eq(tw32._shift32(_t(x), off), cgx_tw._shift32(_j(x), off))


def test_banded_matvec_tw_below_the_fp64_floor():
    """lap2d_fd(48): the triple-word product word for word cgx's, and
    within 1e-18 of the longdouble product (fp64 errs at about 1e-16)."""
    g = 48
    dia = lap2d_fd(g)
    offsets = tuple(dia.offsets)
    x64 = np.random.default_rng(4).standard_normal(g * g) * 1e6
    bands32 = dia.bands.astype(np.float32)
    y = tw32.banded_matvec_tw(_t(bands32), offsets, tw32.tw_from_f64(_t(x64)))
    _eq(y, cgx_tw.banded_matvec_tw(_j(bands32), offsets, cgx_tw.tw_from_f64(_j(x64))))
    ref = _ld_matvec(dia.bands, offsets, np.asarray(x64, np.longdouble))
    assert float(np.max(np.abs(_ld(y) - ref)) / np.max(np.abs(ref))) < 1e-18


def test_split_bands_tw_carries_the_fp64_operator():
    """poisson2d_var's harmonic-mean bands do not round-trip float32: the
    exact three-plane split (bitwise cgx's, summing back to the bands)
    gives the fp64 operator's product to 1e-17, the single plane misses
    by more than 1e-9; bands_f32_exact tells the two apart."""
    g = 32
    rng = np.random.default_rng(5)
    coeff = np.exp(rng.standard_normal((g, g)))
    dia = poisson2d_var(g, coeff)
    np.testing.assert_array_equal(dia.bands, cgx_gen.poisson2d_var(g, coeff).bands)
    assert not tw32.bands_f32_exact(dia.bands)
    assert not tw32.bands_f32_exact(_t(dia.bands))
    assert tw32.bands_f32_exact(lap2d_fd(8).bands) and tw32.bands_f32_exact(
        _t(lap2d_fd(8).bands))
    planes = tw32.split_bands_tw(dia.bands)
    _eq(planes, cgx_tw.split_bands_tw(dia.bands))
    np.testing.assert_array_equal(sum(planes[i].double() for i in range(3)).numpy(), dia.bands)
    offs = tuple(dia.offsets)
    x64 = rng.standard_normal(g * g)
    x_tw = tw32.tw_from_f64(_t(x64))
    ref = _ld_matvec(dia.bands, offs, x64.astype(np.longdouble))
    scale = float(np.max(np.abs(ref)))
    y_split = tw32.banded_matvec_tw(planes, offs, x_tw)
    want = cgx_tw.banded_matvec_tw(_j(planes.numpy()), offs, cgx_tw.tw_from_f64(_j(x64)))
    # XLA:CPU contracts the eps^2 sum c0 t2 + c1 t1 + ... into FMAs, the port
    # keeps each product: the third word differs in its last bits, the triple
    # by less than 1e-19 of the product
    _eq(y_split[:2], want[:2])
    assert float(np.max(np.abs(_ld(y_split) - _ld(want)))) / scale < 1e-19
    assert float(np.max(np.abs(_ld(y_split) - ref))) / scale < 1e-17
    y_plain = tw32.banded_matvec_tw(_t(dia.bands.astype(np.float32)), offs, x_tw)
    assert float(np.max(np.abs(_ld(y_plain) - ref))) / scale > 1e-9


def test_residual_tw_matches_cgx_and_fp64():
    """r = b - A x: the words bitwise cgx's, the fp64 norm within 1e-14
    of cgx's (its sum order is the library's), and both within fp64
    rounding of a plain fp64 residual."""
    g = 32
    dia = lap2d_fd(g)
    offsets = tuple(dia.offsets)
    rng = np.random.default_rng(5)
    x, b = rng.standard_normal(g * g), rng.standard_normal(g * g)
    bands32 = dia.bands.astype(np.float32)
    r, rnorm = tw32.residual_tw(_t(bands32), offsets, tw32.tw_from_f64(_t(b)),
                                tw32.tw_from_f64(_t(x)))
    cr, cnorm = cgx_tw.residual_tw(_j(bands32), offsets, cgx_tw.tw_from_f64(_j(b)),
                                   cgx_tw.tw_from_f64(_j(x)))
    _eq(r, cr)
    assert abs(float(rnorm) - float(cnorm)) <= 1e-14 * float(cnorm)
    r64 = b - dia.mat_vec(x)
    got = r[0].double().numpy() + r[1].double().numpy()
    assert np.allclose(got, r64, rtol=0, atol=1e-13 * np.max(np.abs(r64)))
    assert abs(float(rnorm) - np.linalg.norm(r64)) < 1e-10 * np.linalg.norm(r64)


@pytest.mark.parametrize("n", [5, 8, 13])
def test_comp_tree_sum_bitwise(n):
    rng = np.random.default_rng(n)
    s, e = _f32(rng, n * 6).reshape(n, 2, 3), _f32(rng, n * 6, 2).reshape(n, 2, 3) * 1e-8
    _eq(tw32._comp_tree_sum32(_t(s), _t(e)), cgx_tw._comp_tree_sum32(_j(s), _j(e)))


def test_comp_small_matmul_bitwise_and_exact():
    """(hi, lo) of A @ B bitwise cgx's; hi + lo within 1e-13 of the
    exact product of the float32 inputs (fp64 referee)."""
    rng = np.random.default_rng(6)
    a, b = _f32(rng, 6 * 11, 6).reshape(6, 11), _f32(rng, 11 * 4, 6).reshape(11, 4)
    hi, lo = tw32.comp_small_matmul(_t(a), _t(b))
    _eq((hi, lo), cgx_tw.comp_small_matmul(_j(a), _j(b)))
    exact = np.asarray(a, np.longdouble) @ np.asarray(b, np.longdouble)
    got = hi.numpy().astype(np.longdouble) + lo.numpy()
    assert np.max(np.abs(got - exact)) <= 1e-13 * np.max(np.abs(exact))


@pytest.mark.parametrize("n,chunk", [(3000, 512), (1000, 512), (200, 512)],
                         ids=["tail", "pad", "one_chunk"])
def test_comp_block_gram_matches_cgx(n, chunk):
    """A^T B with the chunks combined by the compensated tree: within
    4e-7 of cgx's (the per-chunk float32 products sum in the library's
    order), and within 1e-5 of the fp64 Gram relative to sum |a_i b_j|;
    fp64 inputs take the plain product."""
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((n, 4)).astype(np.float32), rng.standard_normal((n, 3)).astype(
        np.float32)
    got = tw32.comp_block_gram(_t(a), _t(b), chunk=chunk).numpy()
    want = np.asarray(cgx_tw.comp_block_gram(_j(a), _j(b), chunk=chunk))
    mass = np.abs(a.astype(np.float64)).T @ np.abs(b.astype(np.float64))
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want) / mass) < 4e-7
    assert np.max(np.abs(got - a.astype(np.float64).T @ b) / mass) < 1e-5
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np.testing.assert_allclose(tw32.comp_block_gram(_t(a64), _t(b64)).numpy(), a64.T @ b64,
                               rtol=1e-12, atol=1e-12 * np.max(mass))


def test_comp_block_gram_runs_at_full_float32(monkeypatch):
    """The per-chunk products run with TF32 off and matmul precision
    "highest" whatever the caller set (ROADMAP.md, "Matmul precision"),
    and the caller's setting comes back."""
    seen = []
    einsum = torch.einsum

    def recorded(*args):
        seen.append(torch.get_float32_matmul_precision())
        return einsum(*args)

    monkeypatch.setattr(torch, "einsum", recorded)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        a = torch.ones((1500, 2), dtype=torch.float32)
        assert torch.equal(tw32.comp_block_gram(a, a), torch.full((2, 2), 1500.0))
        assert seen == ["highest"] and torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(old)

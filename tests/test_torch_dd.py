"""cgx_torch's double-double module (ops/dd.py) against cgx's
(cgx/ops/dd.py) on the same seeded numpy inputs, on the CPU.

Every function runs the same fp64 operations as cgx's; the pairs are
held bitwise where XLA:CPU contracts none of them into an FMA, else
within the stated roundoff, and the numpy longdouble referee of
tests/test_dd.py (x86 80-bit, eps about 5.4e-20) holds the exactness
claims.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgx.ops import dd as cgx_dd

from cgx_torch.mats.generators import lap2d_fd
from cgx_torch.ops import dd


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _eq(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
    np.testing.assert_array_equal(g.view(np.uint64), w.view(np.uint64))


def _ld(pair):
    return sum(np.asarray(p.numpy() if isinstance(p, torch.Tensor) else p, np.longdouble)
               for p in pair)


def _pair(rng, n):
    hi = rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
    lo = hi * 1e-17 * rng.standard_normal(n)
    s, e = cgx_dd.fast_two_sum(jnp.asarray(hi), jnp.asarray(lo))
    return np.asarray(s), np.asarray(e)


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod"])
def test_eft_pairs_bitwise_and_exact(name):
    """two_sum, fast_two_sum and two_prod (Veltkamp's split) bitwise
    cgx's and exact against longdouble (tests/test_dd.py's referee)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000)
    b = rng.standard_normal(1000) * (1e-12 if name != "two_prod" else 1.0)
    got = getattr(dd, name)(_t(a), _t(b))
    _eq(got, getattr(cgx_dd, name)(_j(a), _j(b)))
    al, bl = np.asarray(a, np.longdouble), np.asarray(b, np.longdouble)
    assert np.all(_ld(got) == (al * bl if name == "two_prod" else al + bl))


def test_split_bitwise():
    a = np.random.default_rng(1).standard_normal(512) * 1e5
    hi, lo = dd._split(_t(a))
    _eq((hi, lo), cgx_dd._split(_j(a)))
    assert torch.equal(hi + lo, _t(a))


def test_pair_arithmetic_bitwise():
    """dd_add, dd_add_fp, dd_neg, dd_scale_fp and dd_from_fp word for word
    cgx's; dd_add within 1e-30 of the operands' mass (longdouble sees
    2^-64)."""
    rng = np.random.default_rng(2)
    x, y = _pair(rng, 1024), _pair(rng, 1024)
    a = rng.standard_normal(1024)
    tx, ty, jx, jy = tuple(map(_t, x)), tuple(map(_t, y)), tuple(map(_j, x)), tuple(map(_j, y))
    _eq(dd.dd_add(tx, ty), cgx_dd.dd_add(jx, jy))
    _eq(dd.dd_add_fp(tx, _t(a)), cgx_dd.dd_add_fp(jx, _j(a)))
    _eq(dd.dd_neg(tx), cgx_dd.dd_neg(jx))
    _eq(dd.dd_scale_fp(tx, _t(a)), cgx_dd.dd_scale_fp(jx, _j(a)))
    _eq(dd.dd_from_fp(_t(a)), cgx_dd.dd_from_fp(_j(a)))
    got = _ld(dd.dd_add(tx, ty))
    ref = _ld(x) + _ld(y)
    assert np.max(np.abs(got - ref) / (np.abs(_ld(x)) + np.abs(_ld(y)))) < 1e-18


@pytest.mark.parametrize("off", [0, 5, -5, 48, -48])
def test_shift_bitwise(off):
    x = np.random.default_rng(3).standard_normal(100)
    _eq(dd._shift(_t(x), off, 100), cgx_dd._shift(_j(x), off, 100))


def _ld_matvec(bands, offsets, x_ld):
    n = x_ld.shape[0]
    bl = np.asarray(bands, np.longdouble)
    y = np.zeros(n, np.longdouble)
    for d, off in enumerate(offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        y[i0:i1] += bl[d, i0:i1] * x_ld[i0 + off: i1 + off]
    return y


def test_banded_matvec_dd_below_the_fp64_floor():
    """lap2d_fd(48), x of 1e6 scale with a trailing word: the pair
    bitwise cgx's (the integer stencil makes every product exact), and
    within 1e-18 of the longdouble product (fp64 errs near 1e-16; the
    referee itself rounds at about 5e-20)."""
    g = 48
    dia = lap2d_fd(g)
    offsets = tuple(dia.offsets)
    x_hi, x_lo = _pair(np.random.default_rng(4), g * g)
    x_hi = x_hi * 1e6
    x_lo = x_lo * 1e6
    y = dd.banded_matvec_dd(_t(dia.bands), offsets, _t(x_hi), _t(x_lo))
    _eq(y, cgx_dd.banded_matvec_dd(_j(dia.bands), offsets, _j(x_hi), _j(x_lo)))
    ref = _ld_matvec(dia.bands, offsets, _ld((x_hi, x_lo)))
    assert float(np.max(np.abs(_ld(y) - ref)) / np.max(np.abs(ref))) < 1e-18


def test_banded_matvec_dd_general_bands():
    """Random bands (two_prod's error terms nonzero): within 1e-30 of
    cgx's pair relative to the product's mass, and 1e-18 of longdouble."""
    n = 500
    rng = np.random.default_rng(5)
    offsets = (-7, -1, 0, 1, 7)
    bands = rng.standard_normal((5, n))
    x = rng.standard_normal(n)
    y = dd.banded_matvec_dd(_t(bands), offsets, _t(x), torch.zeros(n, dtype=torch.float64))
    want = cgx_dd.banded_matvec_dd(_j(bands), offsets, _j(x), jnp.zeros(n))
    ref = _ld_matvec(bands, offsets, np.asarray(x, np.longdouble))
    mass = _ld_matvec(np.abs(bands), offsets, np.abs(np.asarray(x, np.longdouble)))
    np.testing.assert_array_equal(y[0].numpy(), np.asarray(want[0]))
    assert np.max(np.abs(_ld(y) - _ld(want)) / mass) < 1e-30
    assert np.max(np.abs(_ld(y) - ref) / mass) < 1e-18


def test_residual_dd_and_norm():
    """residual_dd's pair bitwise cgx's, its norm within 1e-14 (the sum's
    order is the library's); dd_norm likewise."""
    g = 32
    dia = lap2d_fd(g)
    offsets = tuple(dia.offsets)
    rng = np.random.default_rng(6)
    x_hi, x_lo = _pair(rng, g * g)
    b = rng.standard_normal(g * g)
    r, rnorm = dd.residual_dd(_t(dia.bands), offsets, _t(b), _t(x_hi), _t(x_lo))
    cr, cnorm = cgx_dd.residual_dd(_j(dia.bands), offsets, _j(b), _j(x_hi), _j(x_lo))
    _eq(r, cr)
    assert abs(float(rnorm) - float(cnorm)) <= 1e-14 * float(cnorm)
    n_t = float(dd.dd_norm(_t(x_hi), _t(x_lo)))
    n_c = float(cgx_dd.dd_norm(_j(x_hi), _j(x_lo)))
    assert abs(n_t - n_c) <= 1e-14 * n_c

"""The plain versions of cgx_torch's four kernels against cgx's Pallas
kernels in interpret mode. The wrappers' own tests, the CUDA ones
included, are in test_torch_wrappers.py, which imports no JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx.ops.axpy as cgx_axpy
import cgx.ops.dia_spmv as cgx_dia
from cgx.mats.generators import lap2d_fd, lap2d_reference
from cgx_torch.ops import axpy, dia_spmv

# fp64: both sides round each product and sum once, so only the dots'
# summation order differs; fp32: the Pallas kernels trace under
# jax's x64-off mode, which may order and round differently.
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = {np.float64: torch.float64, np.float32: torch.float32}
# n not a multiple of cgx's 256-wide block (nor of the CUDA block)
PROBLEMS = {"lap2d_fd": lambda: lap2d_fd(23), "lap2d_reference": lambda: lap2d_reference(700)}


def _vec(rng, n, dt):
    return rng.standard_normal(n).astype(dt)


def _assert_vec(got, want, dt):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= RTOL[dt] * np.max(np.abs(want))


def _assert_dot(got, want, a, b, dt):
    """Dots against sum |a_i b_i|, the scale of their rounding."""
    scale = float(np.sum(np.abs(np.asarray(a, np.float64) * np.asarray(b, np.float64))))
    assert abs(float(got) - float(want)) <= RTOL[dt] * scale


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_dia_matvec_plain_matches_cgx(rng, problem, dt):
    dia = PROBLEMS[problem]()
    bands, offs = dia.bands.astype(dt), tuple(dia.offsets)
    x = _vec(rng, dia.shape[0], dt)
    want = cgx_dia.dia_matvec(jnp.asarray(bands), jnp.asarray(x), offsets=offs,
                              block=256, interpret=True)
    got = dia_spmv.dia_matvec_ref(torch.as_tensor(bands), torch.as_tensor(x), offsets=offs)
    assert got.dtype == DTYPES[dt]
    _assert_vec(got, want, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_dia_matvec_dot_plain_matches_cgx(rng, problem, dt):
    dia = PROBLEMS[problem]()
    bands, offs = dia.bands.astype(dt), tuple(dia.offsets)
    x = _vec(rng, dia.shape[0], dt)
    want_y, want_d = cgx_dia.dia_matvec_dot(jnp.asarray(bands), jnp.asarray(x), offsets=offs,
                                            block=256, interpret=True)
    got_y, got_d = dia_spmv.dia_matvec_dot_ref(torch.as_tensor(bands), torch.as_tensor(x),
                                               offsets=offs)
    assert got_d.dim() == 0 and got_d.dtype == DTYPES[dt]
    _assert_vec(got_y, want_y, dt)
    _assert_dot(got_d, want_d, x, want_y, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1000, 777])
def test_fused_update_rs_plain_matches_cgx(rng, n, dt):
    x, p, r, ap = (_vec(rng, n, dt) for _ in range(4))
    alpha = np.asarray(0.37, dt)
    wx, wr, wrs = cgx_axpy.fused_update_rs(*(jnp.asarray(v) for v in (x, p, r, ap, alpha)),
                                           block=256, interpret=True)
    gx, gr, grs = axpy.fused_update_rs_ref(*(torch.as_tensor(v) for v in (x, p, r, ap, alpha)))
    _assert_vec(gx, wx, dt)
    _assert_vec(gr, wr, dt)
    _assert_dot(grs, wrs, wr, wr, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1000, 777])
def test_fused_axpby_plain_matches_cgx(rng, n, dt):
    a, b = _vec(rng, n, dt), _vec(rng, n, dt)
    # the loop's form: p' = beta p + 1 r
    alpha, beta = np.asarray(-1.25, dt), np.asarray(1.0, dt)
    want = cgx_axpy.fused_axpby(*(jnp.asarray(v) for v in (a, b, alpha, beta)),
                                block=256, interpret=True)
    got = axpy.fused_axpby_ref(*(torch.as_tensor(v) for v in (a, b, alpha, beta)))
    _assert_vec(got, want, dt)

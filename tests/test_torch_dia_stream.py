"""Kernel B8's plain versions (cgx_torch.ops.dia_spmv's streaming forms)
against cgx's Pallas kernels dia_matvec_stream and dia_matvec_stream2d in
interpret mode, on the cases of tests/test_kernels.py:84-153; the band
planes against cgx's bitwise; cgx's argument checks. The CUDA kernel
against its plain version is in test_torch_wrappers.py (on a card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx.ops.dia_spmv as cgx_dia
from cgx.mats import generators as cgx_gen
from cgx_torch.mats import generators as gen
from cgx_torch.ops import dia_spmv

RTOL = 1e-12  # fp64; both sum the products in offset order

STREAM_CASES = {  # test_kernels.py:74-82
    "ref500_b256": ("lap2d_reference", 500, 256),
    "ref1024_b256": ("lap2d_reference", 1024, 256),
    "ref200_b256": ("lap2d_reference", 200, 256),
    "fd20_b128": ("lap2d_fd", 20, 128),
    "3d7_b128": ("lap3d_fd", 7, 128),
}
STREAM2D_CASES = {  # test_kernels.py:101-110
    "ref500_8x128": ("lap2d_reference", 500, 8, 128),
    "fd33_4x128": ("lap2d_fd", 33, 4, 128),
    "3d7_2x128": ("lap3d_fd", 7, 2, 128),
    "fd40_4x256": ("lap2d_fd", 40, 4, 256),
    "fd90_8x512": ("lap2d_fd", 90, 8, 512),
}


def _problem(make, n):
    """The port's and cgx's matrix (equal bands, tests/test_torch_mats.py)
    and a seeded x."""
    dia = getattr(gen, make)(n)
    np.testing.assert_array_equal(dia.bands, getattr(cgx_gen, make)(n).bands)
    x = np.random.default_rng(42).standard_normal(dia.shape[0])
    return dia, x


def _assert_close(got, want, dia, x):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.max(np.abs(want)))
    np.testing.assert_allclose(got, dia.mat_vec(x), rtol=RTOL, atol=RTOL * np.max(np.abs(want)))


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_plain_matches_cgx(case):
    make, n, block = STREAM_CASES[case]
    dia, x = _problem(make, n)
    offs = tuple(dia.offsets)
    want = cgx_dia.dia_matvec_stream(jnp.asarray(dia.bands), jnp.asarray(x), offsets=offs,
                                     block=block, interpret=True)
    bands, xt = torch.as_tensor(dia.bands), torch.as_tensor(x)
    got = dia_spmv.dia_matvec_stream_ref(bands, xt, offsets=offs, block=block)
    _assert_close(got, want, dia, x)
    # the wrapper on a CPU tensor is the plain version, and counts
    before = dia_spmv.dia_matvec_stream.launches
    assert torch.equal(dia_spmv.dia_matvec_stream(bands, xt, offsets=offs, block=block), got)
    assert dia_spmv.dia_matvec_stream.launches == before + 1


@pytest.mark.parametrize("case", STREAM2D_CASES)
def test_stream2d_plain_matches_cgx(case):
    make, n, rows, cols = STREAM2D_CASES[case]
    dia, x = _problem(make, n)
    offs = tuple(dia.offsets)
    want = cgx_dia.dia_matvec_stream2d(jnp.asarray(dia.bands), jnp.asarray(x), offsets=offs,
                                       rows=rows, cols=cols, interpret=True)
    bands, xt = torch.as_tensor(dia.bands), torch.as_tensor(x)
    planes = dia_spmv.stream2d_band_planes(bands, rows=rows, cols=cols).contiguous()
    got = dia_spmv.dia_matvec_stream2d_planes_ref(planes, xt, offsets=offs, rows=rows, cols=cols)
    _assert_close(got, want, dia, x)
    before = dia_spmv.dia_matvec_stream2d_planes.launches
    conv = dia_spmv.dia_matvec_stream2d(bands, xt, offsets=offs, rows=rows, cols=cols)
    assert torch.equal(conv, got)
    assert dia_spmv.dia_matvec_stream2d_planes.launches == before + 1
    # the plain form of the flat bands is the same product, bit for bit
    assert torch.equal(dia_spmv.dia_matvec_ref(bands, xt, offsets=offs), got)


@pytest.mark.parametrize("case", STREAM2D_CASES)
def test_band_planes_equal_cgx(case):
    make, n, rows, cols = STREAM2D_CASES[case]
    dia, _ = _problem(make, n)
    want = np.asarray(cgx_dia.stream2d_band_planes(dia.bands, rows=rows, cols=cols))
    host = dia_spmv.stream2d_band_planes(dia.bands, rows=rows, cols=cols)
    dev = dia_spmv.stream2d_band_planes(torch.as_tensor(dia.bands), rows=rows, cols=cols)
    assert isinstance(host, np.ndarray) and host.shape == want.shape
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev.numpy(), want)
    # the flat band values are the planes' first n entries a band
    np.testing.assert_array_equal(host.reshape(len(dia.offsets), -1)[:, : dia.shape[0]],
                                  dia.bands)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stream_fp32_and_fp64_equal_the_resident_plain(dtype):
    """test_kernels.py:141-150: streaming and resident products agree bit for bit."""
    dia, x = _problem("lap2d_fd", 40)
    bands = torch.as_tensor(dia.bands.astype(dtype))
    xt = torch.as_tensor(x.astype(dtype))
    offs = tuple(dia.offsets)
    a = dia_spmv.dia_matvec(bands, xt, offsets=offs)
    b = dia_spmv.dia_matvec_stream(bands, xt, offsets=offs, block=256)
    c = dia_spmv.dia_matvec_stream2d(bands, xt, offsets=offs, rows=4, cols=128)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_argument_checks():
    """cgx's: block and cols multiples of 128 (dia_spmv.py:180, :276),
    the planes' shape against rows and cols (:340-345); and the operands'."""
    dia, x = _problem("lap2d_fd", 20)
    offs = tuple(dia.offsets)
    bands, xt = torch.as_tensor(dia.bands), torch.as_tensor(x)
    planes = dia_spmv.stream2d_band_planes(bands, rows=4, cols=128).contiguous()
    with pytest.raises(ValueError, match="multiple of 128"):
        dia_spmv.dia_matvec_stream(bands, xt, offsets=offs, block=100)
    with pytest.raises(ValueError, match="multiple of 128"):
        dia_spmv.dia_matvec_stream_ref(bands, xt, offsets=offs, block=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        dia_spmv.dia_matvec_stream2d(bands, xt, offsets=offs, rows=4, cols=96)
    with pytest.raises(ValueError, match="do not match"):
        dia_spmv.dia_matvec_stream2d_planes(planes, xt, offsets=offs, rows=4, cols=256)
    with pytest.raises(ValueError, match="do not match"):
        dia_spmv.dia_matvec_stream2d_planes(planes, xt, offsets=offs, rows=3, cols=128)
    with pytest.raises(ValueError, match="fewer than"):
        dia_spmv.dia_matvec_stream2d_planes(planes[:, :2].contiguous(), xt, offsets=offs,
                                            rows=2, cols=128)
    with pytest.raises(ValueError, match="offsets"):
        dia_spmv.dia_matvec_stream2d_planes(planes, xt, offsets=offs[:-1], rows=4, cols=128)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv.dia_matvec_stream2d_planes(planes.transpose(1, 2).contiguous().transpose(1, 2),
                                            xt, offsets=offs, rows=4, cols=128)
    with pytest.raises(ValueError, match="3-D"):
        dia_spmv.dia_matvec_stream2d_planes(bands, xt, offsets=offs, rows=4, cols=128)
    with pytest.raises(ValueError, match="differ"):
        dia_spmv.dia_matvec_stream2d_planes(planes.float(), xt, offsets=offs, rows=4, cols=128)
    with pytest.raises(ValueError, match="offsets"):
        dia_spmv.dia_matvec_stream(bands, xt, offsets=offs[:-1])
    with pytest.raises(TypeError):
        dia_spmv.dia_matvec_stream(bands.half(), xt.half(), offsets=offs)

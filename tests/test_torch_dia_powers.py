"""cgx_torch's matrix-powers kernel B9 (here through its plain version)
against cgx's dia_sstep_basis in interpret mode, on the same numpy inputs
(mirrors tests/test_dia_powers.py), and the wrapper's CPU dispatch and
checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgx.mats.generators import lap2d_fd, lap2d_reference
from cgx.ops.dia_powers import _powers_geometry as cgx_geometry
from cgx.ops.dia_powers import dia_sstep_basis as cgx_basis
from cgx_torch.ops import dia_powers

THETA, DELTA = 4.0, 3.9
NEWTON = (3.0, 5.0, 3.5, 4.5, 2.0, 6.0)


def _inputs(dia, seed):
    rng = np.random.default_rng(seed)
    n = dia.shape[0]
    bands = np.asarray(dia.bands, np.float32)
    p, r = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    return bands, p, r


@pytest.mark.parametrize(
    "problem,s,shifts",
    [("ref4900", 1, ()), ("ref4900", 4, ()), ("ref4900", 4, NEWTON[:4]), ("ref123", 2, ()),
     ("fd48", 6, NEWTON)],
    ids=["cheb-s1", "cheb-s4", "newton-s4", "ragged-s2", "fd48-newton-s6"],
)
def test_plain_basis_matches_cgx(problem, s, shifts):
    """The plain basis against cgx's kernel at (rows=8, cols=128) tiles,
    several blocks and a ragged N (123), to cgx's own tolerances."""
    dia = {"ref4900": lambda: lap2d_reference(4900), "ref123": lambda: lap2d_reference(123),
           "fd48": lambda: lap2d_fd(48)}[problem]()
    bands, p, r = _inputs(dia, 3)
    want = cgx_basis(jnp.asarray(bands), jnp.asarray(p), jnp.asarray(r), offsets=dia.offsets,
                     s=s, theta=THETA, delta=DELTA, shifts=shifts, rows=8, cols=128,
                     interpret=True)
    got = dia_powers.dia_sstep_basis(torch.as_tensor(bands), torch.as_tensor(p),
                                     torch.as_tensor(r), offsets=dia.offsets, s=s, theta=THETA,
                                     delta=DELTA, shifts=shifts, rows=8, cols=128)
    assert got.shape == (2 * s + 1, dia.shape[0]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-4)


def test_wrapper_on_cpu_is_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper counts one launch, builds nothing, and
    returns the plain version bit for bit; the planes entry equals the
    per-call one."""
    import cgx_torch._build as build

    def no_build():
        raise AssertionError("a CPU call must not build the CUDA kernels")

    monkeypatch.setattr(build, "load", no_build)
    dia = lap2d_fd(40)
    bands, p, r = (torch.as_tensor(a) for a in _inputs(dia, 0))
    kw = dict(offsets=dia.offsets, s=4, theta=THETA, delta=DELTA)
    before = dia_powers.dia_sstep_basis_planes.launches
    got = dia_powers.dia_sstep_basis(bands, p, r, **kw)
    planes = dia_powers.sstep_powers_band_planes(bands, offsets=dia.offsets, s=4)
    again = dia_powers.dia_sstep_basis_planes(planes, p, r, **kw)
    assert dia_powers.dia_sstep_basis_planes.launches == before + 2
    assert torch.equal(got, dia_powers.dia_sstep_basis_ref(bands, p, r, **kw))
    assert torch.equal(got, again)


@pytest.mark.parametrize("s", [1, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geometry_matches_cgx(s, dtype):
    """cgx's TPU plane geometry, kept for validation and the fused route."""
    offsets = tuple(lap2d_fd(48).offsets)
    want = cgx_geometry(offsets, s, 8, 128, jnp.dtype(dtype), 2304)
    got = dia_powers._powers_geometry(offsets, s, 8, 128, getattr(torch, dtype), 2304)
    assert tuple(got) == tuple(want)


def test_input_validation():
    dia = lap2d_fd(16)
    bands, p, r = (torch.as_tensor(a) for a in _inputs(dia, 1))
    kw = dict(offsets=dia.offsets, theta=THETA, delta=DELTA)
    with pytest.raises(ValueError, match="multiple of 128"):
        dia_powers.dia_sstep_basis(bands, p, r, s=2, cols=100, **kw)
    with pytest.raises(ValueError, match="s must be"):
        dia_powers.dia_sstep_basis(bands, p, r, s=17, **kw)
    with pytest.raises(ValueError, match="Newton shifts"):
        dia_powers.dia_sstep_basis(bands, p, r, s=4, shifts=(1.0, 2.0), **kw)
    with pytest.raises(ValueError, match="vectors' dtype"):
        dia_powers.dia_sstep_basis_planes(bands.to(torch.bfloat16), p, r, s=2, **kw)
    with pytest.raises(TypeError):
        dia_powers.dia_sstep_basis(bands, p, r.double(), s=2, **kw)
    with pytest.raises(ValueError, match="shape"):
        dia_powers.dia_sstep_basis(bands, p, r[:-1], s=2, **kw)

"""float16 band storage under float32 vectors (ROADMAP A6) against cgx,
on the CPU.

cgx's streaming kernel (B4/B7), whole-solve kernel (B5) and fused s-step
block (B10) take an explicit ``bands_dtype``; with ``jnp.float16`` each
streams float16 bands and widens them on load, and the solve runs on the
rounded operator throughout. The port's ``_f32_f16b`` builds do the same
(here through their plain versions, which the builds equal bit for bit
on the card: ``chip_smoke.py``'s ``f16_bands``). On ``lap2d_fd`` the
stencil (4, -1) is exact in float16 and in bfloat16, so the count is
cgx's and x is bit for bit the bfloat16-band run's; on a perturbed
stencil the rounded operator is the one solved, as in cgx. ``"auto"``
still narrows to bfloat16 only, as cgx's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd, source_term
from cgx.ops.cg_kernel import dia_cg_solve_vmem as cgx_vmem
from cgx.ops.cg_stream import dia_cg_solve_stream as cgx_stream
from cgx.ops.sstep_stream import dia_sstep_stream_solve as cgx_fused
from cgx_torch.ops import cg_stream
from cgx_torch.ops import sstep_stream as ss
from cgx_torch.ops._util import BUILD_LAUNCHES
from cgx_torch.parallel import make_mesh, sharded_cg_solve

F16 = torch.float16
G = 32
# the tolerance of each route, relative to ||b||: 1e-5 for the streaming and
# whole-solve kernels; 1e-3 for the s-step, where cgx's float32 replay is still
# off float32's floor (at 1e-5 it takes more iterations than the port's float64
# replay, with every band dtype alike)
TOL_REL = {"stream": 1e-5, "vmem": 1e-5, "sstep": 1e-3}
# route: (cgx's entry, the port's, their common arguments, the build's key in BUILD_LAUNCHES)
ROUTES = {
    "stream": (cgx_stream, cgx_torch.dia_cg_solve_stream, dict(rows=8, cols=128),
               "stream_iteration_f32_f16b"),
    "vmem": (cgx_vmem, cgx_torch.dia_cg_solve_vmem, dict(chunk=32, layout="2d", cols=128),
             "dia_cg_vmem2d_f32_f16b"),
    "sstep": (cgx_fused, cgx_torch.dia_sstep_stream_solve, dict(s=4, rows=32, cols=128),
              "sstep_gram_f32_f16b"),
}


def _problem(route: str, bands=None):
    dia = lap2d_fd(G)
    bands = np.asarray(dia.bands if bands is None else bands, np.float32)
    b = np.asarray(source_term(G * G), np.float32)
    tol = TOL_REL[route] * float(np.linalg.norm(b.astype(np.float64)))
    return (cgx.DiaOperator(jnp.asarray(bands), tuple(dia.offsets)),
            cgx_torch.operator_from_numpy(bands, dia.offsets, dtype=torch.float32, device="cpu"),
            b, tol)


def _bounds(route: str, op) -> dict:
    """The s-step's Lanczos bounds, estimated once and given to both packages."""
    if route != "sstep":
        return {}
    from cgx_torch.solver.chebyshev import spectral_bounds

    return {"bounds": spectral_bounds(op, op.bands.shape[1])}


@pytest.fixture(scope="module")
def cgx_runs():
    """cgx's three float16-band solves of lap2d_fd(32), interpreted, once."""
    runs = {}
    for route, (fn, _, kw, _) in ROUTES.items():
        cop, op, b, tol = _problem(route)
        runs[route] = fn(cop, jnp.asarray(b), tol=tol, interpret=True, bands_dtype=jnp.float16,
                         **kw, **_bounds(route, op))
    return runs


@pytest.mark.parametrize("route", list(ROUTES))
def test_f16_bands_match_cgx(cgx_runs, route):
    """bands_dtype=float16 on lap2d_fd(32) at TOL_REL ||b||: converged in
    cgx's count (the s-step within s, its replay float64 where cgx's is
    float32, ROADMAP C; equal here), each launch on the _f32_f16b build,
    x bit for bit the bfloat16-band run's (the stencil is exact in both)."""
    _, port, kw, key = ROUTES[route]
    _, op, b, tol = _problem(route)
    want = cgx_runs[route]
    before = BUILD_LAUNCHES[key]
    got = port(op, torch.as_tensor(b), tol=tol, bands_dtype=F16, device="cpu", **kw,
               **_bounds(route, op))
    assert BUILD_LAUNCHES[key] > before
    bf16 = port(op, torch.as_tensor(b), tol=tol, bands_dtype=torch.bfloat16, device="cpu", **kw,
                **_bounds(route, op))
    assert bool(got.converged) and bool(want.converged)
    assert int(got.iterations) == int(bf16.iterations)
    assert abs(int(got.iterations) - int(want.iterations)) <= (kw["s"] if route == "sstep" else 0)
    assert got.x.dtype == torch.float32 and torch.equal(got.x, bf16.x)
    wx = np.asarray(want.x, np.float64)
    np.testing.assert_allclose(got.x.numpy(), wx, rtol=3e-3, atol=1e-2 * np.abs(wx).max())


@pytest.mark.parametrize("route", list(ROUTES))
def test_f16_bands_solve_the_rounded_operator(route):
    """A stencil not exact in float16 (the diagonal perturbed by up to
    1e-3): the float16-band solve is, bit for bit, the float32 solve of the
    operator rounded to float16, set-up residual included, as cgx's rounds
    its operator once (cg_stream.py:497-509, cg_kernel.py:575-582,
    sstep_stream.py:681-686); and not the unrounded operator's."""
    _, port, kw, _ = ROUTES[route]
    dia = lap2d_fd(G)
    bands = np.asarray(dia.bands, np.float32).copy()
    bands[2] += np.float32(1e-3) * np.arange(G * G, dtype=np.float32) / (G * G)
    _, op, b, tol = _problem(route, bands)
    assert not np.array_equal(bands.astype(np.float16).astype(np.float32), bands)
    rounded = cgx_torch.operator_from_numpy(bands.astype(np.float16).astype(np.float32),
                                            dia.offsets, dtype=torch.float32, device="cpu")
    bounds = _bounds(route, op)
    got = port(op, torch.as_tensor(b), tol=tol, bands_dtype=F16, device="cpu", **kw, **bounds)
    want = port(rounded, torch.as_tensor(b), tol=tol, bands_dtype=None, device="cpu", **kw,
                **bounds)
    full = port(op, torch.as_tensor(b), tol=tol, bands_dtype=None, device="cpu", **kw, **bounds)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x) and not torch.equal(got.x, full.x)


def test_auto_narrows_to_bfloat16_only():
    """"auto" takes bfloat16 where it is exact, never float16 (cgx
    cg_stream.py:747-752, sstep_stream.py:594-597), although float16 is
    exact on lap2d_fd too."""
    _, op, b, tol = _problem("stream")
    cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(b), tol=tol, bands_dtype="auto",
                                  device="cpu")
    assert cg_stream._stream_iteration.bands_dtype == torch.bfloat16
    cgx_torch.dia_sstep_stream_solve(op, torch.as_tensor(b), tol=tol, bands_dtype="auto",
                                     device="cpu", **_bounds("sstep", op))
    assert ss._sstep_gram.bands_dtype == torch.bfloat16


def test_sharded_fused_takes_f16_bands():
    """The sharded fused s-step's sstep_bands_dtype=float16 (cgx
    sharded_cg.py:587) on a mesh of one rank, lap2d_fd(64) (the smallest
    grid whose shard tiles cgx's planes): B10's _f32_f16b build in its
    halo mode, x bit for bit the bfloat16-band run's; under float64
    vectors the pair raises, naming it."""
    dia = cgx_torch.lap2d_fd(64)
    b = np.asarray(source_term(64 * 64), np.float32)
    kw = dict(mesh=make_mesh(device="cpu"), method="sstep", sstep_powers="fused",
              tol=TOL_REL["sstep"] * float(np.linalg.norm(b)))
    before = BUILD_LAUNCHES["sstep_gram_f32_f16b"]
    got = sharded_cg_solve(dia, b, sstep_bands_dtype=F16, **kw)
    assert BUILD_LAUNCHES["sstep_gram_f32_f16b"] > before
    bf16 = sharded_cg_solve(dia, b, sstep_bands_dtype=torch.bfloat16, **kw)
    assert bool(got.converged) and int(got.iterations) == int(bf16.iterations)
    assert got.x.dtype == torch.float32 and torch.equal(got.x, bf16.x)
    with pytest.raises(NotImplementedError, match="float16 under torch.float64"):
        sharded_cg_solve(dia, b.astype(np.float64), sstep_bands_dtype=F16, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_other_pairs_raise_naming_them(route):
    """float16 bands under bfloat16 vectors, and any narrower band under
    float64 vectors: no build, and no route of solve asks for them
    (ROADMAP C); the refusal names the pair."""
    _, port, kw, _ = ROUTES[route]
    dia = lap2d_fd(8)
    b = source_term(64)
    for vec, bands in ((torch.bfloat16, F16), (torch.float64, F16),
                       (torch.float64, torch.bfloat16)):
        op = cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=vec, device="cpu")
        name = str(bands).removeprefix("torch.")
        with pytest.raises(NotImplementedError, match=f"{name} under {vec}"):
            port(op, torch.as_tensor(b, dtype=vec), bands_dtype=bands, device="cpu", **kw,
                 bounds=(0.1, 8.0)) if route == "sstep" else port(
                op, torch.as_tensor(b, dtype=vec), bands_dtype=bands, device="cpu", **kw)

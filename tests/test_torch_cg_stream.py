"""cgx_torch's streaming CG (kernels B4, B7 and B6, here through their
plain versions) against cgx's dia_cg_solve_stream and
dia_cg_solve_stream_pcg in interpret mode, on the same numpy inputs and
with cgx's geometry rows=8, cols=128 (mirrors tests/test_cg_stream.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd, lap2d_reference, lap3d_fd, source_term
from cgx.ops.cg_stream import dia_cg_solve_stream as cgx_stream
from cgx.ops.cg_stream import dia_cg_solve_stream_pcg as cgx_stream_pcg
from cgx_torch.ops import cg_stream
from cgx_torch.ops._util import pow2_rhs_scale
from cgx_torch.solver.pipelined import pipelined_cg_solve
from cgx_torch.solver.precond import neumann_banded

GEOM = dict(rows=8, cols=128)


def _ops(dia, bands=None):
    bands = np.asarray(dia.bands if bands is None else bands, np.float32)
    return (cgx.DiaOperator(jnp.asarray(bands), tuple(dia.offsets)),
            cgx_torch.operator_from_numpy(bands, dia.offsets, dtype=torch.float32, device="cpu"))


def _close(got, want):
    """cgx's own tolerances for the stream kernels against the pipelined
    loop (tests/test_cg_stream.py:30-46): the two sum in other orders."""
    wx = np.asarray(want.x, np.float64)
    np.testing.assert_allclose(got.x.numpy().astype(np.float64), wx, rtol=3e-3,
                               atol=1e-2 * np.abs(wx).max())


@pytest.fixture(scope="module")
def problem2000():
    dia = lap2d_reference(2000)
    b = np.asarray(source_term(2000), np.float32)
    return dia, b, 1e-3 * float(np.linalg.norm(b.astype(np.float64)))


@pytest.mark.parametrize("solver", ["stream", "pcg"])
def test_matches_cgx(problem2000, solver):
    """lap2d_reference(2000), offsets +-1 and +-45: k within one of cgx's,
    x within cgx's tolerances, and k equal to the port's plain pipelined
    loop with float64 dots, whose arithmetic the kernels repeat."""
    dia, b, tol = problem2000
    cop, op = _ops(dia)
    bt = torch.as_tensor(b)
    if solver == "stream":
        want = cgx_stream(cop, jnp.asarray(b), tol=tol, interpret=True, **GEOM)
        got = cgx_torch.dia_cg_solve_stream(op, bt, tol=tol, device="cpu", **GEOM)
        pc = None
    else:
        want = cgx_stream_pcg(cop, jnp.asarray(b), tol=tol, interpret=True, **GEOM)
        got = cgx_torch.dia_cg_solve_stream_pcg(op, bt, tol=tol, device="cpu", **GEOM)
        pc = neumann_banded(op.bands, op.offsets, sweeps=2)
    assert bool(got.converged) and not bool(got.breakdown)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    assert got.x.dtype == torch.float32 and got.iterations.dtype == torch.int32
    _close(got, want)
    plain = pipelined_cg_solve(op, bt, tol=tol, precond=pc, dot_precision=torch.float64,
                               device="cpu")
    assert int(got.iterations) == int(plain.iterations)
    assert torch.equal(got.x, plain.x)
    x = got.x.numpy().astype(np.float64)
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-2


def test_split_and_stacked_are_bit_identical(problem2000):
    """The two layouts are one kernel on other addresses: bitwise equal,
    each counted at its own site."""
    dia, b, tol = problem2000
    _, op = _ops(dia)
    before = cg_stream._stream_iteration.launches, cg_stream._stream_iteration_stacked.launches
    r1, r2 = (cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(b), tol=tol, layout=layout,
                                            device="cpu", **GEOM)
              for layout in ("split", "stacked"))
    after = cg_stream._stream_iteration.launches, cg_stream._stream_iteration_stacked.launches
    assert int(r1.iterations) == int(r2.iterations)
    assert torch.equal(r1.x, r2.x) and torch.equal(r1.rsold, r2.rsold)
    launched = -(-int(r1.iterations) // 32) * 32
    assert [a - b_ for a, b_ in zip(after, before)] == [launched, launched]


@pytest.mark.parametrize("solver", ["stream", "pcg"])
def test_3d_stencil_large_offsets(solver):
    """lap3d_fd(12): offsets +-144 exceed cols=128 (cgx's q > 1 row shift
    and, for the PCG, its doubled halo); the flat kernels have no such
    case, so the result must agree."""
    dia = lap3d_fd(12)
    b = np.random.default_rng(5).standard_normal(1728).astype(np.float32)
    tol = 1e-3 * float(np.linalg.norm(b.astype(np.float64)))
    cop, op = _ops(dia)
    fns = {"stream": (cgx_stream, cgx_torch.dia_cg_solve_stream),
           "pcg": (cgx_stream_pcg, cgx_torch.dia_cg_solve_stream_pcg)}[solver]
    want = fns[0](cop, jnp.asarray(b), tol=tol, interpret=True, **GEOM)
    got = fns[1](op, torch.as_tensor(b), tol=tol, device="cpu", **GEOM)
    assert bool(got.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    np.testing.assert_allclose(got.x.numpy().astype(np.float64), np.asarray(want.x, np.float64),
                               rtol=3e-3, atol=1e-2)


@pytest.mark.parametrize("solver,cap", [("stream", 37), ("pcg", 23)])
def test_maxiter_cap_and_zero_rhs(solver, cap):
    dia = lap2d_reference(1024)
    b = np.asarray(source_term(1024), np.float32)
    cop, op = _ops(dia)
    fns = {"stream": (cgx_stream, cgx_torch.dia_cg_solve_stream),
           "pcg": (cgx_stream_pcg, cgx_torch.dia_cg_solve_stream_pcg)}[solver]
    want = fns[0](cop, jnp.asarray(b), tol=0.0, maxiter=cap, interpret=True, **GEOM)
    got = fns[1](op, torch.as_tensor(b), tol=0.0, maxiter=cap, device="cpu", **GEOM)
    assert int(got.iterations) == int(want.iterations) == cap
    assert not bool(got.converged) and torch.isfinite(got.x).all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(want.x)).max())
    zero = fns[1](op, torch.zeros(1024), device="cpu", **GEOM)
    assert bool(zero.converged) and int(zero.iterations) == 0
    assert torch.equal(zero.x, torch.zeros(1024))


def test_bf16_bands_exact_stencil():
    """bfloat16 band planes on lap2d_fd(24), whose 4 and -1 are bf16-exact:
    the rounded operator is the operator, so the count and x are those of
    the float32-band solve, and cgx's bf16 run takes the same count."""
    dia = lap2d_fd(24)
    n = 576
    b = np.asarray(source_term(n), np.float32)
    tol = 1e-4 * float(np.linalg.norm(b.astype(np.float64)))
    cop, op = _ops(dia)
    kw = dict(tol=tol, maxiter=2 * n, **GEOM)
    want = cgx_stream(cop, jnp.asarray(b), interpret=True, bands_dtype=jnp.bfloat16, **kw)
    fp32 = cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(b), device="cpu", **kw)
    lo = cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(b), bands_dtype=torch.bfloat16,
                                       device="cpu", **kw)
    assert bool(lo.converged)
    assert int(lo.iterations) == int(fp32.iterations)
    assert abs(int(lo.iterations) - int(want.iterations)) <= 1
    assert torch.equal(lo.x, fp32.x)
    _close(lo, want)


def test_bands_dtype_auto_exactness_gate():
    """"auto" takes bfloat16 only when the round trip is bit-exact: the
    same iterate as explicit bf16 on lap2d_fd(32), and as float32 bands
    once one entry is not representable (cgx test_cg_stream.py:386-451)."""
    dia = lap2d_fd(32)
    n = 1024
    b = np.asarray(source_term(n), np.float32)
    kw = dict(tol=1e-4 * float(np.linalg.norm(b)), maxiter=4000, device="cpu", **GEOM)
    _, op = _ops(dia)
    auto = cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(b), bands_dtype="auto", **kw)
    lo = cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(b), bands_dtype=torch.bfloat16, **kw)
    assert bool(auto.converged) and torch.equal(auto.x, lo.x)

    bands2 = np.asarray(dia.bands, np.float32).copy()
    bands2[0, 100] += np.float32(1e-3)  # in range, and not bf16-representable
    cop2, op2 = _ops(dia, bands2)
    auto2 = cgx_torch.dia_cg_solve_stream(op2, torch.as_tensor(b), bands_dtype="auto", **kw)
    fp32 = cgx_torch.dia_cg_solve_stream(op2, torch.as_tensor(b), **kw)
    lo2 = cgx_torch.dia_cg_solve_stream(op2, torch.as_tensor(b), bands_dtype=torch.bfloat16, **kw)
    assert torch.equal(auto2.x, fp32.x) and not torch.equal(auto2.x, lo2.x)
    want = cgx_stream(cop2, jnp.asarray(b), tol=kw["tol"], maxiter=4000, interpret=True,
                      bands_dtype="auto", **GEOM)
    assert abs(int(auto2.iterations) - int(want.iterations)) <= 1


def test_huge_rhs_prescale():
    """max|b| ~ 2^100: <r, r> ~ 2^200 overflows float32 without cgx's exact
    power-of-2 prescale. With it the solve is the unscaled one, scaled:
    the same k and x * 2^100 bit for bit, and cgx's count."""
    dia = lap2d_reference(1024)
    b = np.asarray(source_term(1024), np.float32)
    big = b * np.float32(2.0 ** 100)
    _, op = _ops(dia)
    tol = 1e-4 * float(np.linalg.norm(b.astype(np.float64)))
    small = cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(b), tol=tol, device="cpu", **GEOM)
    huge = cgx_torch.dia_cg_solve_stream(op, torch.as_tensor(big), tol=tol * 2.0 ** 100,
                                         device="cpu", **GEOM)
    assert bool(huge.converged) and torch.isfinite(huge.x).all()
    assert int(huge.iterations) == int(small.iterations)
    assert torch.equal(huge.x, small.x * np.float32(2.0 ** 100))
    down, up = pow2_rhs_scale(torch.as_tensor(big))
    _, e = np.frexp(np.abs(big).max())  # max|b| = m 2^e, m in [0.5, 1)
    assert float(down) * float(up) == 1.0 and float(up) == 2.0 ** int(e)
    assert pow2_rhs_scale(torch.zeros(4)) == (1.0, 1.0)


def test_float64_runs_and_matches_the_plain_loop():
    """cgx's TPU kernel refuses float64; the port's runs it, with the
    arithmetic of the plain float64 pipelined loop."""
    dia = lap2d_fd(16)
    b = source_term(256)
    op = cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=torch.float64, device="cpu")
    got = cgx_torch.dia_cg_solve_stream(op, b, tol=1e-10, device="cpu")
    plain = pipelined_cg_solve(op, b, tol=1e-10, device="cpu")
    assert bool(got.converged) and int(got.iterations) == int(plain.iterations)
    assert torch.equal(got.x, plain.x)
    with pytest.raises(TypeError, match="fp64"):
        cgx_stream(cgx.DiaOperator.from_host(dia), jnp.asarray(b))


def test_input_validation():
    dia = lap2d_reference(256)
    b = np.asarray(source_term(256), np.float32)
    _, op = _ops(dia)
    with pytest.raises(ValueError, match="multiple of 128"):
        cgx_torch.dia_cg_solve_stream(op, b, cols=100, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        cgx_torch.dia_cg_solve_stream_pcg(op, b, cols=100, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        cgx_torch.dia_cg_solve_stream(op, b, layout="planes", device="cpu")
    with pytest.raises(TypeError):
        cgx_torch.dia_cg_solve_stream(op, b.astype(np.float64), device="cpu")
    no_diag = cgx_torch.operator_from_numpy(np.ones((2, 16)), (-1, 1), dtype=torch.float32,
                                            device="cpu")
    with pytest.raises(ValueError, match="offset 0"):
        cgx_torch.dia_cg_solve_stream_pcg(no_diag, np.ones(16, np.float32), device="cpu")
    # float16 bands run under float32 vectors (tests/test_torch_f16_bands.py); under
    # float64 ones no narrower band is built, and the refusal names the pair
    op64 = cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=torch.float64,
                                         device="cpu")
    with pytest.raises(NotImplementedError, match="float16 under torch.float64"):
        cgx_torch.dia_cg_solve_stream(op64, b.astype(np.float64), bands_dtype=torch.float16,
                                      device="cpu")


def test_pad_stride():
    """pad_stride was a TPU lane-roll layout: False and "auto" run the flat
    layout, True the same where padding is exact (lap2d_fd), and True keeps
    cgx's refusal where the +-1 band couples across grid rows."""
    dia = lap2d_fd(64)
    b = np.asarray(source_term(4096), np.float32)
    _, op = _ops(dia)
    kw = dict(tol=1e-4 * float(np.linalg.norm(b)), rows=16, cols=128, device="cpu")
    runs = [cgx_torch.dia_cg_solve_stream(op, b, pad_stride=ps, **kw)
            for ps in (False, "auto", True)]
    assert all(torch.equal(r.x, runs[0].x) for r in runs[1:])
    quasi = lap2d_reference(2000)
    cop, qop = _ops(quasi)
    qb = np.asarray(source_term(2000), np.float32)
    for fn, cgx_fn in ((cgx_torch.dia_cg_solve_stream, cgx_stream),
                       (cgx_torch.dia_cg_solve_stream_pcg, cgx_stream_pcg)):
        with pytest.raises(ValueError, match="couples across"):
            fn(qop, qb, tol=0.0, maxiter=3, pad_stride=True, device="cpu", **GEOM)
        with pytest.raises(ValueError, match="couples across"):
            cgx_fn(cop, jnp.asarray(qb), tol=0.0, maxiter=3, pad_stride=True, interpret=True,
                   **GEOM)

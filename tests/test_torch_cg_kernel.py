"""cgx_torch's whole-solve kernel B5 (here through its plain version)
against cgx's dia_cg_solve_vmem in interpret mode, on the same numpy
inputs (mirrors tests/test_cg_kernel.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd, lap2d_reference, lap3d_fd, source_term
from cgx.ops.cg_kernel import dia_cg_solve_vmem as cgx_vmem
from cgx_torch import config
from cgx_torch.ops import cg_kernel
from cgx_torch.solver.precond import neumann_banded


def _op(dia, dtype=torch.float32):
    return cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=dtype, device="cpu")


def _vmem(dia, b, dtype=torch.float32, **kw):
    return cgx_torch.dia_cg_solve_vmem(_op(dia, dtype), torch.as_tensor(b, dtype=dtype),
                                       device="cpu", **kw)


@pytest.fixture(scope="module")
def ref700():
    """cgx's four (precond, layout) solves of lap2d_reference(700), once."""
    dia = lap2d_reference(700)
    b32 = np.asarray(source_term(700), np.float32)
    tol = 1e-3 * float(np.linalg.norm(b32.astype(np.float64)))
    op32 = cgx.DiaOperator.from_host(dia, dtype=jnp.float32)
    runs = {(pc, layout): cgx_vmem(op32, jnp.asarray(b32), tol=tol, chunk=32, interpret=True,
                                   precond=pc, layout=layout, cols=128)
            for pc in (False, True) for layout in ("1d", "2d")}
    return dia, b32, tol, runs


@pytest.mark.parametrize("layout", ["1d", "2d"])
@pytest.mark.parametrize("precond", [False, True])
def test_counts_and_x_match_cgx(ref700, precond, layout):
    dia, b32, tol, runs = ref700
    want = runs[(precond, layout)]
    got = _vmem(dia, b32, tol=tol, chunk=32, precond=precond, layout=layout, cols=128)
    assert bool(got.converged) and bool(want.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    assert got.iterations.dtype == torch.int32 and got.x.dtype == torch.float32
    wx = np.asarray(want.x, np.float64)
    np.testing.assert_allclose(got.x.numpy().astype(np.float64), wx, rtol=3e-3,
                               atol=1e-2 * np.abs(wx).max())


@pytest.mark.parametrize("layout", ["1d", "2d"])
@pytest.mark.parametrize("maxiter", [50, 64, 70, 200])
def test_maxiter_cap_exact(maxiter, layout):
    """The cap holds even mid-chunk (weak-scaling parity, cg.run:22-44)."""
    dia = lap2d_reference(512)
    res = _vmem(dia, source_term(512), tol=0.0, maxiter=maxiter, chunk=64, layout=layout,
                cols=128)
    assert int(res.iterations) == maxiter and not bool(res.converged)
    assert torch.isfinite(res.x).all()


@pytest.mark.parametrize("g", [6, 12])
def test_3d_stencil_offsets_larger_than_cols(g):
    """lap3d_fd's offsets +-g^2 exceed cols=128 at g = 12 (cgx's q > 1
    row shift); the flat kernel has no such case, the result must agree."""
    dia = lap3d_fd(g)
    n = dia.shape[0]
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    want = cgx_vmem(cgx.DiaOperator.from_host(dia, dtype=jnp.float32), jnp.asarray(b),
                    tol=1e-4, chunk=16, interpret=True, layout="2d", cols=128)
    got = _vmem(dia, b, tol=1e-4, chunk=16, layout="2d", cols=128)
    assert bool(got.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    x = got.x.numpy().astype(np.float64)
    assert np.linalg.norm(dia.to_dense() @ x - b) < 1e-3


@pytest.mark.parametrize("precond", [False, True])
def test_zero_rhs_is_preconverged(precond):
    before = dict(cg_kernel.dia_cg_chunk.launches)
    res = _vmem(lap2d_fd(8), np.zeros(64), precond=precond, layout="2d")
    assert bool(res.converged) and int(res.iterations) == 0
    assert torch.equal(res.x, torch.zeros(64)) and float(res.residual_norm) == 0.0
    assert cg_kernel.dia_cg_chunk.launches == before  # no chunk ran


def test_breakdown_on_indefinite_bands():
    diag = np.r_[np.ones(8), -np.ones(8)]
    bands = np.stack([np.full(16, 0.1), diag, np.full(16, 0.1)])
    b = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    want = cgx_vmem(cgx.DiaOperator(jnp.asarray(bands, jnp.float32), (-1, 0, 1)), jnp.asarray(b),
                    tol=0.0, maxiter=10, chunk=4, interpret=True)
    op = cgx_torch.operator_from_numpy(bands, (-1, 0, 1), dtype=torch.float32, device="cpu")
    got = cgx_torch.dia_cg_solve_vmem(op, torch.as_tensor(b), tol=0.0, maxiter=10, chunk=4,
                                      device="cpu")
    assert bool(want.breakdown) and bool(got.breakdown)
    assert int(got.iterations) == int(want.iterations) == 10


def test_precond_needs_offset_zero():
    op = cgx_torch.operator_from_numpy(np.ones((2, 16)), (-1, 1), dtype=torch.float32,
                                       device="cpu")
    with pytest.raises(ValueError, match="offset 0"):
        cgx_torch.dia_cg_solve_vmem(op, np.ones(16, np.float32), precond=True, device="cpu")


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="layout"):
        _vmem(lap2d_fd(4), np.ones(16), layout="3d")
    with pytest.raises(ValueError, match="layout"):
        cgx_torch.refine_fixed_sweeps(_op(lap2d_fd(4), torch.float64), np.ones(16), layout="3d",
                                      device="cpu")


def test_bands_dtype_raises_naming_a6():
    """float16 bands under float32 vectors raised naming ROADMAP A6 until
    their builds landed; now they run as cgx's bands_dtype=float16 does,
    interpreted (lap2d_fd(24) at 1e-4 ||b||: the same k, and on this
    f16-exact stencil x bitwise the bfloat16-band run's). A pair no route
    of solve asks for still raises, naming the pair (ROADMAP C)."""
    dia = lap2d_fd(24)
    b = np.asarray(source_term(576), np.float32)
    tol = 1e-4 * float(np.linalg.norm(b.astype(np.float64)))
    op32 = cgx.DiaOperator(jnp.asarray(np.asarray(dia.bands, np.float32)), tuple(dia.offsets))
    want = cgx_vmem(op32, jnp.asarray(b), tol=tol, chunk=32, interpret=True,
                    bands_dtype=jnp.float16, layout="2d", cols=128)
    got, bf16 = (_vmem(dia, b, tol=tol, chunk=32, bands_dtype=bd, layout="2d")
                 for bd in (torch.float16, torch.bfloat16))
    assert bool(got.converged) and bool(want.converged)
    assert int(got.iterations) == int(want.iterations) == int(bf16.iterations)
    assert torch.equal(got.x, bf16.x)
    with pytest.raises(NotImplementedError, match="bfloat16 under torch.float64"):
        _vmem(lap2d_fd(4), np.ones(16), torch.float64, bands_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float16 under torch.float64"):
        _vmem(lap2d_fd(4), np.ones(16), torch.float64, bands_dtype=torch.float16)


@pytest.mark.parametrize("precond", [False, True])
def test_bf16_bands_match_cgx(precond):
    """bands_dtype=bfloat16 against cgx's, interpreted: on lap2d_fd the
    stencil is bf16-exact, so the count is the float32-band count and x
    agrees to float32 rounding; on a perturbed operator the rounded bands
    are a nearby SPD matrix, and both solve that same one."""
    dia = lap2d_fd(24)
    b = np.asarray(source_term(576), np.float32)
    tol = 1e-4 * float(np.linalg.norm(b.astype(np.float64)))
    bands = np.asarray(dia.bands, np.float32).copy()
    for case in ("exact", "perturbed"):
        if case == "perturbed":
            bands[2] += np.float32(1e-3) * np.arange(576, dtype=np.float32) / 576
        op32 = cgx.DiaOperator(jnp.asarray(bands), tuple(dia.offsets))
        want = cgx_vmem(op32, jnp.asarray(b), tol=tol, chunk=32, interpret=True, precond=precond,
                        bands_dtype=jnp.bfloat16, layout="2d", cols=128)
        op = cgx_torch.operator_from_numpy(bands, dia.offsets, dtype=torch.float32, device="cpu")
        before = cg_kernel.dia_cg_chunk.launches["2d"]
        got = cgx_torch.dia_cg_solve_vmem(op, torch.as_tensor(b), tol=tol, chunk=32,
                                          precond=precond, bands_dtype=torch.bfloat16,
                                          layout="2d", device="cpu")
        assert cg_kernel.dia_cg_chunk.launches["2d"] > before
        assert bool(got.converged) and bool(want.converged)
        assert abs(int(got.iterations) - int(want.iterations)) <= 1
        wx = np.asarray(want.x, np.float64)
        np.testing.assert_allclose(got.x.numpy(), wx, rtol=3e-3, atol=1e-2 * np.abs(wx).max())
        if case == "exact":
            plain = _vmem(dia, b, tol=tol, chunk=32, precond=precond, layout="2d")
            assert int(got.iterations) == int(plain.iterations)
            assert torch.equal(got.x, plain.x)


def test_float64_golden_against_cgx():
    """lap2d_fd(100) in float64 at tol 1e-10 (cgx's kernel has no float64;
    its reference loop is the golden): k in the golden window, the
    reference's quality gate."""
    dia = lap2d_fd(100)
    b = source_term(10_000)
    want = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b), tol=1e-10)
    got = _vmem(dia, b, torch.float64, tol=1e-10, layout="2d")
    assert int(want.iterations) == 488
    assert bool(got.converged) and 485 <= int(got.iterations) <= 491
    assert np.linalg.norm(dia.mat_vec(got.x.numpy()) - b) / np.linalg.norm(b) < 1e-11


# --- the kernel's summation order, replayed in numpy ------------------

THREADS = 256  # kThreads of csrc/common.cuh


def _warp_sum(v):  # the shfl_down tree of common.cuh over the last axis of 32 lanes
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _block_sum(v):  # (..., 256) thread values -> block_sum's result in thread 0
    w = _warp_sum(v.reshape(v.shape[:-1] + (THREADS // 32, 32)))
    return _warp_sum(np.concatenate([w, np.zeros(w.shape[:-1] + (32 - THREADS // 32,))], -1))


def _thread_sums(prod, blocks, rows):
    """Each thread's sequential sum over rows lo + t, lo + t + 256, ... of
    its block (block b owns rows [b*rows, (b+1)*rows))."""
    per = -(-rows // THREADS) * THREADS
    padded = np.zeros(blocks * rows)
    padded[:prod.size] = prod
    chunks = np.zeros((blocks, per))
    chunks[:, :rows] = padded.reshape(blocks, rows)
    acc = np.zeros((blocks, THREADS))
    for j in range(per // THREADS):
        acc = acc + chunks[:, j * THREADS:(j + 1) * THREADS]
    return acc


def _kernel_dot(u, v, blocks):
    rows = -(-u.size // blocks)
    parts = _block_sum(_thread_sums(u * v, blocks, rows))
    return _block_sum(_thread_sums(parts, 1, blocks))[0]  # every block sums them in order


def _block_sum512(v):  # (..., 512) thread values -> block_sum<double, 512> in thread 0
    w = _warp_sum(v.reshape(v.shape[:-1] + (16, 32)))
    return _warp_sum(np.concatenate([w, np.zeros(w.shape[:-1] + (16,))], -1))


def _resident_dot(u, v, plan):
    """<u, v> as the resident design sums it (csrc/cg_kernel.cu
    dia_cg_resident_kernel): thread t of block b over its rows
    b rows + t + 512 j in order, the block's sum, then in every block
    (resident_total) lane l of one warp over partials l, l + 32, ... in
    order, and the warp's tree."""
    prod = np.zeros(plan.grid * plan.rows)
    prod[:u.size] = u * v
    per = plan.rows_per_thread * 512
    rows = np.zeros((plan.grid, per))
    rows[:, :plan.rows] = prod.reshape(plan.grid, plan.rows)
    acc = np.zeros((plan.grid, 512))
    for j in range(plan.rows_per_thread):
        acc = acc + rows[:, j * 512:(j + 1) * 512]
    parts = np.zeros(32 * -(-plan.grid // 32))
    parts[:plan.grid] = _block_sum512(acc)
    lanes = np.zeros(32)
    for c in range(parts.size // 32):
        lanes = lanes + parts[32 * c:32 * (c + 1)]
    return _warp_sum(lanes)


def _replay(dia, dot, rsold):
    """The float64 recurrence with the given dot; returns (k, x)."""
    n = dia.shape[0]
    b = source_term(n)
    x, r, p = np.zeros(n), b.copy(), b.copy()
    k = 0
    while k < n:
        ap = dia.mat_vec(p)
        conj = dot(p, ap)
        alpha = rsold / max(conj, rsold * 1e-14)
        x, r = x + alpha * p, r - alpha * ap
        rr = dot(r, r)
        if np.sqrt(rr) < 1e-10:
            break
        p, rsold, k = r + (rr / rsold) * p, rr, k + 1
    return k, x


@pytest.mark.parametrize("gen,arg,window", [(lap2d_fd, 100, (485, 491)),
                                            (lap2d_reference, 10_000, (604, 610))])
def test_kernel_order_replay_keeps_the_golden_counts(gen, arg, window):
    """The float64 recurrence with each design's dot order at N = 10,000
    converges inside the golden window: the global design's
    (ceil(N / 256) = 40 blocks of 250 rows, fewer than fit on an H100)
    and the resident design's (resident_plan: 132 blocks of 76 rows, 512
    threads). The count is bimodal in the dots' rounding (460 against 488
    on the three-kernel path, ROADMAP C)."""
    dia = gen(arg)
    n = dia.shape[0]
    blocks = -(-n // THREADS)
    b = source_term(n)
    plan = cg_kernel.resident_plan(n, tuple(dia.offsets), torch.float64, torch.float64, False,
                                   132)
    assert (plan.design, plan.grid, plan.rows) == ("resident", 132, 76)
    runs = [_replay(dia, lambda u, v: _kernel_dot(u, v, blocks), _kernel_dot(b, b, blocks)),
            _replay(dia, lambda u, v: _resident_dot(u, v, plan), float(np.sum(b * b)))]
    for k, x in runs:
        assert window[0] <= k <= window[1]
        assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


def test_resident_dot_order_sums_every_product_once():
    """On integers (exact in float64) the replayed order gives the plain
    sum, with one row a thread and with several."""
    for n in (10_000, 1_000_000):
        plan = cg_kernel.resident_plan(n, (-1, 0, 1), torch.float32, torch.float32, False, 132)
        u = np.arange(1, n + 1, dtype=np.float64)
        assert _resident_dot(u, np.ones(n), plan) == u.sum()


# --- the plain version's own contract ------------------------------------


@pytest.mark.parametrize("precond", [False, True])
def test_plain_chunk_is_cg_solve_with_fp64_dots(precond):
    """Dots and scalars in float64, alpha and beta rounded to float32
    where they scale vectors: the arithmetic of cg_solve(dot_precision=
    float64), bit for bit, so the kernel's count is the plain fp32 loop's."""
    dia = lap2d_fd(16)
    b = source_term(256)
    tol = 1e-5 * np.linalg.norm(b)
    op = _op(dia)
    bt = torch.as_tensor(b, dtype=torch.float32)
    pc = neumann_banded(op.bands, op.offsets, sweeps=2) if precond else None
    want = cgx_torch.cg_solve(op, bt, tol=tol, dot_precision=torch.float64, precond=pc,
                              device="cpu")
    got = cgx_torch.dia_cg_solve_vmem(op, bt, tol=tol, chunk=16, precond=precond, device="cpu")
    assert int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.rsold, want.rsold) and torch.equal(got.residual_norm,
                                                              want.residual_norm)


@pytest.mark.parametrize("maxiter", [None, 45])
def test_chunk_size_invariance(maxiter):
    """Frozen iterations: chunk 1 and chunk 64 give bitwise the same result."""
    dia = lap2d_fd(16)
    b = source_term(256)
    one, many = (_vmem(dia, b, tol=1e-3 * np.linalg.norm(b), maxiter=maxiter, chunk=c,
                       precond=True) for c in (1, 64))
    for field in ("x", "iterations", "residual_norm", "converged", "rsold", "breakdown"):
        assert torch.equal(getattr(one, field), getattr(many, field)), field


def test_chunk_wrapper_counts_by_layout_and_checks_operands():
    dia = lap2d_fd(4)
    bands = torch.as_tensor(dia.bands, dtype=torch.float32)
    p, x, r = (torch.ones(16) for _ in range(3))
    scal = torch.tensor([16.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    kw = dict(offsets=dia.offsets, tol=0.0, nearzero=1e-14, maxiter=3, chunk=8)
    before = dict(cg_kernel.dia_cg_chunk.launches)
    out = cg_kernel.dia_cg_chunk(bands, p, x, r, scal, layout="2d", **kw)
    assert out.dtype == torch.float64 and out.tolist()[1:] == [0.0, 3.0, 0.0]
    assert cg_kernel.dia_cg_chunk.launches == {**before, "2d": before["2d"] + 1}
    assert not torch.equal(x, torch.ones(16))  # advanced in place
    with pytest.raises(ValueError):  # scalars must be float64
        cg_kernel.dia_cg_chunk(bands, p, x, r, scal.float(), **kw)
    with pytest.raises(ValueError):
        cg_kernel.dia_cg_chunk(bands, p, x, r, scal, layout="3d", **kw)
    with pytest.raises(TypeError):  # vectors of another dtype than the bands
        cg_kernel.dia_cg_chunk(bands, p.double(), x, r, scal, **kw)


def test_resident_state_bytes_and_the_budget():
    """The state counts the bands, x, r, p, Ap (and c), and the float64
    partials and scalars; the budget, from the crossover against the
    streaming kernels, keeps N = 1,000,000 with the preconditioner on the
    resident route and sends N = 1,999,396 (without it too) to the stream."""
    s = cg_kernel.resident_state_bytes
    extra = (3 * 1024 + 8) * 8
    assert s(5, 1000, 4, 4) == 1000 * (20 + 16) + extra
    assert s(5, 1000, 4, 4, precond=True) - s(5, 1000, 4, 4) == 4000
    assert s(5, 1000, 8, 8) == 1000 * (40 + 32) + extra
    assert s(5, 1_000_000, 4, 4, precond=True) <= config.RESIDENT_BUDGET_BYTES
    assert config.RESIDENT_BUDGET_BYTES < s(5, 1_999_396, 4, 4)
    assert s(5, 10_240_000, 4, 4) > config.RESIDENT_BUDGET_BYTES  # the main path streams

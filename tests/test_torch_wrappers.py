"""cgx_torch's kernel wrappers: their CPU dispatch and input checks,
and, on a card only, each CUDA kernel against its plain version.

This file imports no JAX, so the CUDA cases run on a machine without
it: ``python -m pytest tests/test_torch_wrappers.py --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

import cgx_torch
from cgx_torch.config import NEARZERO
from cgx_torch.mats.generators import lap2d_fd, lap2d_reference, source_term
from cgx_torch.ops import axpy, cg_kernel, dia_spmv, matvec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_calls(n=600, dtype=torch.float64, device="cpu", seed=0):
    """One call of each wrapper and of its plain version, on seeded inputs."""
    dia = lap2d_reference(n)
    offs = tuple(dia.offsets)
    g = np.random.default_rng(seed)
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=device)
    x, p, r, ap = (torch.as_tensor(g.standard_normal(n), dtype=dtype, device=device)
                   for _ in range(4))
    alpha = torch.tensor(0.37, dtype=dtype, device=device)
    one = torch.tensor(1.0, dtype=dtype, device=device)
    return {
        "dia_matvec": (lambda: dia_spmv.dia_matvec(bands, x, offsets=offs),
                       lambda: dia_spmv.dia_matvec_ref(bands, x, offsets=offs)),
        "dia_matvec_dot": (lambda: dia_spmv.dia_matvec_dot(bands, x, offsets=offs),
                           lambda: dia_spmv.dia_matvec_dot_ref(bands, x, offsets=offs)),
        "fused_update_rs": (lambda: axpy.fused_update_rs(x, p, r, ap, alpha),
                            lambda: axpy.fused_update_rs_ref(x, p, r, ap, alpha)),
        "fused_axpby": (lambda: axpy.fused_axpby(p, r, alpha, one),
                        lambda: axpy.fused_axpby_ref(p, r, alpha, one)),
    }


WRAPPERS = {
    "dia_matvec": dia_spmv.dia_matvec,
    "dia_matvec_dot": dia_spmv.dia_matvec_dot,
    "fused_update_rs": axpy.fused_update_rs,
    "fused_axpby": axpy.fused_axpby,
}


def _as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_cpu_counts_and_runs_plain(name, monkeypatch):
    """On a CPU tensor a wrapper counts one launch and returns exactly
    its plain version's result, without building any kernel."""
    import cgx_torch._build as build

    def no_build():
        raise AssertionError("a CPU call must not build the CUDA kernels")

    monkeypatch.setattr(build, "load", no_build)
    kern, plain = _kernel_calls()[name]
    before = WRAPPERS[name].launches
    got = _as_tuple(kern())
    assert WRAPPERS[name].launches == before + 1
    for g, w in zip(got, _as_tuple(plain())):
        assert torch.equal(g, w)


def test_wrappers_reject_bad_operands():
    x = torch.zeros(8, dtype=torch.float64)
    bands = torch.zeros(3, 8, dtype=torch.float64)
    one = torch.ones((), dtype=torch.float64)
    with pytest.raises(TypeError):  # dtype the kernels do not take
        dia_spmv.dia_matvec(bands.half(), x.half(), offsets=(-1, 0, 1))
    with pytest.raises(ValueError):  # bands do not match the offsets
        dia_spmv.dia_matvec(bands, x, offsets=(0, 1))
    with pytest.raises(ValueError):  # more diagonals than the kernel holds
        dia_spmv.dia_matvec_dot(torch.zeros(17, 8, dtype=torch.float64), x,
                                offsets=tuple(range(17)))
    with pytest.raises(ValueError):  # lengths differ
        axpy.fused_axpby(x, torch.zeros(9, dtype=torch.float64), one, one)
    with pytest.raises(TypeError):  # mixed dtypes
        axpy.fused_update_rs(x, x, x, x.float(), one)
    with pytest.raises(TypeError):  # a host float where a device scalar belongs
        axpy.fused_axpby(x, x, 1.0, one)
    with pytest.raises(ValueError):  # strided vector
        axpy.fused_axpby(torch.zeros(16, dtype=torch.float64)[::2], x, one, one)
    with pytest.raises(ValueError):  # a device the kernels do not run on
        axpy.fused_axpby(x.to("meta"), x.to("meta"), one.to("meta"), one.to("meta"))


# --- on the card only --------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [600, 300_000])  # one block-row, and the grid-stride loop
def test_cuda_kernels_match_plain(cuda, dtype, n):
    """Built with -fmad=false, each kernel's vectors equal its plain
    version's bit for bit; the dots differ only in summation order."""
    for name, (kern, plain) in _kernel_calls(n, dtype, cuda).items():
        got, want = _as_tuple(kern()), _as_tuple(plain())
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dim() == 1:
                assert torch.equal(g, w), name
            else:
                tol = 1e-5 if dtype == torch.float32 else 1e-12
                assert abs(float(g) - float(w)) <= tol * float(w.abs()) + 1e-30, name


@pytest.mark.cuda
def test_cuda_dots_are_deterministic(cuda):
    calls = _kernel_calls(300_000, torch.float32, cuda)
    for name in ("dia_matvec_dot", "fused_update_rs"):
        first = _as_tuple(calls[name][0]())[-1]
        for _ in range(5):
            assert torch.equal(_as_tuple(calls[name][0]())[-1], first), name


@pytest.mark.cuda
def test_cuda_fast_loop_golden_and_repeatable(cuda):
    """The fp64 golden lap2d_fd(100) at tol 1e-10 through the kernels
    (k in [485, 491]), and two solves bitwise equal."""
    dia = lap2d_fd(100)
    b = source_term(dia.shape[0])
    op = cgx_torch.as_operator(dia, torch.float64, device=cuda)
    first = cgx_torch.dia_cg_solve_pallas(op, b, tol=1e-10, history=8, device=cuda)
    again = cgx_torch.dia_cg_solve_pallas(op, b, tol=1e-10, history=8, device=cuda)
    assert bool(first.converged) and 485 <= int(first.iterations) <= 491
    assert int(again.iterations) == int(first.iterations)
    assert torch.equal(first.x.view(torch.int64), again.x.view(torch.int64))
    x = first.x.cpu().numpy()
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


def _dense_case(shape, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    a = torch.as_tensor(g.standard_normal(shape), dtype=dtype, device=device)
    x = torch.as_tensor(g.standard_normal(shape[1]), dtype=dtype, device=device)
    return a, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,tiles", [((129, 257), (64, 128)), ((3000, 2999), (1024, 128)),
                                         ((777, 500), (64, 96)), ((40, 70), (1, 1))])
def test_cuda_dense_kernels_match_plain(cuda, dtype, shape, tiles):
    """The dense kernels against their plain versions on ragged shapes:
    the sums are grouped alike, so only the order inside a tile differs."""
    a, x = _dense_case(shape, dtype, cuda)
    br, bc = tiles
    y = matvec.dense_matvec(a, x, block_rows=br, block_cols=bc)
    y2, d = matvec.dense_matvec_dot(a, x, block_rows=br, block_cols=bc)
    want_y, want_d = matvec.dense_matvec_dot_ref(a, x, block_rows=br, block_cols=bc)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    scale = float(want_y.abs().max())
    assert float((y - want_y).abs().max()) <= rtol * scale
    assert torch.equal(y, y2)
    m = min(shape)
    dot_scale = float((x[:m] * want_y[:m]).abs().sum())
    assert abs(float(d) - float(want_d)) <= rtol * dot_scale


@pytest.mark.cuda
def test_cuda_dense_is_deterministic_and_full_float32(cuda):
    """Repeated dots are bitwise equal; and under a caller's TF32 setting
    both the kernel and its plain version stay at full float32 (TF32
    would be ~1e-3 off)."""
    a, x = _dense_case((2048, 2048), torch.float32, cuda)
    first = matvec.dense_matvec_dot(a, x, block_rows=256, block_cols=512)
    for _ in range(5):
        again = matvec.dense_matvec_dot(a, x, block_rows=256, block_cols=512)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    exact = (a.double() @ x.double())
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        for y in (matvec.dense_matvec(a, x), matvec.dense_matvec_ref(a, x)):
            assert float((y.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.cuda
def test_cuda_cli_reference_run_small(cuda, tmp_path, capsys):
    """The CUDA grammar through the dense kernel on a small .mtx: the
    same k as on the CPU, and the kernel launched every iteration."""
    from cgx_torch.cli import main as cli
    from cgx_torch.mats.generators import lap2d_fd_coo_lower

    mtx = tmp_path / "lap12.mtx"
    lap2d_fd_coo_lower(12).write(mtx)
    argv = [str(mtx), "1024", "16", "true", str(tmp_path / "o.txt"), "--tol", "1e-6"]
    before = matvec.dense_matvec.launches
    gpu = cli.run(argv)
    launched = matvec.dense_matvec.launches - before
    cpu = cli.run(argv + ["--device", "cpu"])
    assert gpu.result.x.is_cuda and int(gpu.result.iterations) == int(cpu.result.iterations)
    assert launched >= int(gpu.result.iterations) + 1
    # only the summation orders differ (fp64 dots and tiles)
    scale = float(cpu.result.x.abs().max())
    assert float((gpu.result.x.cpu() - cpu.result.x).abs().max()) <= 1e-8 * scale


@pytest.mark.cuda
def test_cuda_inputs_must_share_the_device(cuda):
    dia = lap2d_fd(8)
    op = cgx_torch.as_operator(dia, torch.float64, device=cuda)
    with pytest.raises(ValueError):
        cgx_torch.dia_cg_solve_pallas(op, torch.ones(64, dtype=torch.float64), device=cuda)
    with pytest.raises(ValueError):
        dia_spmv.dia_matvec(op.bands, torch.ones(64, dtype=torch.float64), offsets=op.offsets)


def _chunk_state(dia, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    n = dia.shape[0]
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=device)
    p, x, r = (torch.as_tensor(g.standard_normal(n), dtype=dtype, device=device) for _ in range(3))
    scal = torch.tensor([float((r.double() ** 2).sum()), 0.0, 0.0, 0.0], dtype=torch.float64,
                        device=device)
    return bands, [p, x, r, scal]


@pytest.mark.cuda
@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g", [30, 700])  # a grid of one block, and of many
def test_cuda_chunk_kernel_matches_plain(cuda, g, dtype, precond):
    """One iteration and a 64-iteration chunk of the whole-solve kernel
    against its plain version: vectors within 1e-6/1e-14 after one (the
    float64 dots run in another order) and 1e-4/1e-12 after 64."""
    dia = lap2d_fd(g)
    bands, state = _chunk_state(dia, dtype, cuda)
    for chunk, rtol in ((1, 1e-6 if dtype == torch.float32 else 1e-14),
                        (64, 1e-4 if dtype == torch.float32 else 1e-12)):
        got, ref = [t.clone() for t in state], [t.clone() for t in state]
        kw = dict(offsets=dia.offsets, tol=0.0, nearzero=1e-14, maxiter=10**6, chunk=chunk,
                  precond=precond)
        s_got = cg_kernel.dia_cg_chunk(bands, *got, **kw)
        s_ref = cg_kernel.dia_cg_chunk_ref(bands, *ref, **kw)
        torch.cuda.synchronize()
        for a, w in zip(got[:3], ref[:3]):
            assert float((a - w).abs().max()) <= rtol * float(w.abs().max())
        assert torch.equal(s_got[1:], s_ref[1:])
        assert abs(float(s_got[0] - s_ref[0])) <= rtol * abs(float(s_ref[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("dtype,bf16", [(torch.float32, False), (torch.float64, False),
                                        (torch.float32, True)])
@pytest.mark.parametrize("g", [30, 100, 700])  # halos within a block, across two, and wide
def test_cuda_chunk_designs_match_plain(cuda, g, dtype, bf16, precond):
    """Both designs of the whole-solve kernel (resident_plan's and the
    global one, forced) against the plain version, as above; the resident
    design is the one the plan picks at these sizes."""
    dia = lap2d_fd(g)
    bands, state = _chunk_state(dia, dtype, cuda)
    if bf16:
        bands = bands.to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    resident = cg_kernel.resident_plan(dia.shape[0], tuple(dia.offsets), dtype, bands.dtype,
                                       precond, sms)
    assert resident.design == "resident"
    for plan in (resident, cg_kernel.GLOBAL_PLAN):
        for chunk, rtol in ((1, 1e-6 if dtype == torch.float32 else 1e-14),
                            (64, 1e-4 if dtype == torch.float32 else 1e-12)):
            got, ref = [t.clone() for t in state], [t.clone() for t in state]
            kw = dict(offsets=dia.offsets, tol=0.0, nearzero=1e-14, maxiter=10**6, chunk=chunk,
                      precond=precond)
            s_got = cg_kernel.dia_cg_chunk(bands, *got, plan=plan, **kw)
            s_ref = cg_kernel.dia_cg_chunk_ref(bands, *ref, **kw)
            torch.cuda.synchronize()
            assert cg_kernel.dia_cg_chunk.plan == plan
            for a, w in zip(got[:3], ref[:3]):
                assert float((a - w).abs().max()) <= rtol * float(w.abs().max())
            assert torch.equal(s_got[1:], s_ref[1:])
            assert abs(float(s_got[0] - s_ref[0])) <= rtol * abs(float(s_ref[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("make", [lambda: lap2d_fd(300), lambda: lap2d_reference(1001)])
def test_cuda_b1_designs_bitwise(cuda, make, dtype):
    """B1 on B8's design and on the grid-stride one give bitwise B8's y;
    their dots agree to the data type's rounding."""
    dia = make()
    offs = tuple(dia.offsets)
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=cuda)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(dia.shape[0]), dtype=dtype,
                        device=cuda)
    want = dia_spmv.dia_matvec_stream(bands, x, offsets=offs)
    grid = dia_spmv.GRID_PLAN  # what matvec_plan picks at these sizes, below a tile an SM
    stream = dia_spmv.MatvecPlan("stream", dia_spmv.stream_plan(
        dia.shape[0], offs, dtype, torch.cuda.get_device_properties(0).multi_processor_count))
    ys = [dia_spmv.dia_matvec(bands, x, offsets=offs, plan=p) for p in (None, stream, grid)]
    (y1, d1), (y2, d2) = (dia_spmv.dia_matvec_dot(bands, x, offsets=offs, plan=p)
                          for p in (stream, grid))
    torch.cuda.synchronize()
    assert all(torch.equal(y, want) for y in (*ys, y1, y2))
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    assert abs(float(d1 - d2)) <= rtol * float((x * want).abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("precond", [False, True])
def test_cuda_resident_solves_repeat_bitwise(cuda, precond):
    """Two solves through the whole-solve kernel are bitwise equal, and the
    fp32 count is the plain fp32 loop's (fp64 dots, the kernel's arithmetic)."""
    from cgx_torch.solver.precond import neumann_banded

    dia = lap2d_fd(300)
    b = source_term(dia.shape[0])
    tol = 1e-5 * float(np.linalg.norm(b))
    op = cgx_torch.as_operator(dia, torch.float32, device=cuda)
    bt = torch.as_tensor(b, dtype=torch.float32, device=cuda)
    first, again = (cgx_torch.dia_cg_solve_vmem(op, bt, tol=tol, precond=precond, layout="2d",
                                                device=cuda) for _ in range(2))
    assert bool(first.converged) and int(again.iterations) == int(first.iterations)
    assert torch.equal(first.x.view(torch.int32), again.x.view(torch.int32))
    pc = neumann_banded(op.bands, op.offsets, sweeps=2) if precond else None
    plain = cgx_torch.cg_solve(op, bt, tol=tol, precond=pc, dot_precision=torch.float64,
                               device=cuda)
    assert abs(int(first.iterations) - int(plain.iterations)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("maxiter", [50, 64, 70, 200])
def test_cuda_resident_maxiter_mid_chunk(cuda, maxiter):
    dia = lap2d_reference(512)
    op = cgx_torch.as_operator(dia, torch.float32, device=cuda)
    b = torch.as_tensor(source_term(512), dtype=torch.float32, device=cuda)
    before = cg_kernel.dia_cg_chunk.launches["1d"]
    res = cgx_torch.dia_cg_solve_vmem(op, b, tol=0.0, maxiter=maxiter, chunk=64, device=cuda)
    assert int(res.iterations) == maxiter and not bool(res.converged)
    assert cg_kernel.dia_cg_chunk.launches["1d"] - before == -(-maxiter // 64)


@pytest.mark.cuda
def test_cuda_resident_fp64_golden(cuda):
    dia = lap2d_fd(100)
    b = source_term(dia.shape[0])
    op = cgx_torch.as_operator(dia, torch.float64, device=cuda)
    b_dev = torch.as_tensor(b, dtype=torch.float64, device=cuda)
    for plan in (None, cg_kernel.GLOBAL_PLAN):  # the resident design, then the global one
        res = cg_kernel._solve(op.bands, b_dev, offsets=tuple(op.offsets), tol=1e-10,
                               nearzero=NEARZERO, maxiter=dia.shape[0], chunk=64, precond=False,
                               layout="2d", plan=plan)
        assert cg_kernel.dia_cg_chunk.plan.design == ("global" if plan else "resident")
        assert bool(res.converged) and 485 <= int(res.iterations) <= 491
        x = res.x.cpu().numpy()
        assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


# --- the streaming kernels (B4, B7, B6) ----------------------------------


def _stream_case(g, dtype, device, case, seed=0):
    """Bands as the case streams them, and cgx's start state on
    lap2d_fd(g) from a seeded b, with a seeded nonzero x."""
    from cgx_torch.ops import cg_stream

    dia = lap2d_fd(g)
    offs = tuple(dia.offsets)
    rng = np.random.default_rng(seed)
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=device)
    b, x = (torch.as_tensor(rng.standard_normal(g * g), dtype=dtype, device=device)
            for _ in range(2))
    st = cg_stream.initial_state(bands, b, 0.0, offsets=offs, precond=case == "pcg",
                                 stacked=case == "stacked")
    st.x.copy_(x)
    return (bands.to(torch.bfloat16) if case == "bf16" else bands), offs, st


def _clone_state(st):
    from cgx_torch.ops import cg_stream

    if st.rws is not None:
        rws = st.rws.clone()
        pairs = (rws[:, 0], rws[:, 1], rws[:, 2])
    else:
        rws, pairs = None, tuple(t.clone() for t in (st.r, st.w, st.s))
    return cg_stream.StreamState(st.p.clone(), st.x.clone(),
                                 None if st.u is None else st.u.clone(), *pairs, rws,
                                 st.scal.clone())


STREAM_KW = dict(tol=0.0, nearzero=1e-14, maxiter=10**6)


def _plain_step(bands, st, offs, **kw):
    from cgx_torch.ops import cg_stream

    cg_stream._iteration_ref(bands, st.p, st.x, st.u, st.r, st.w, st.s, st.scal, offsets=offs,
                             **{**STREAM_KW, **kw})


@pytest.mark.parametrize("case", ["split", "stacked", "bf16", "pcg"])
def test_stream_wrappers_on_cpu_count_and_run_plain(case, monkeypatch):
    """On CPU tensors each streaming wrapper counts the launches it
    stands for, builds nothing and gives exactly its plain version's state."""
    import cgx_torch._build as build
    from cgx_torch.ops import cg_stream

    def no_build():
        raise AssertionError("a CPU call must not build the CUDA kernels")

    monkeypatch.setattr(build, "load", no_build)
    bands, offs, st = _stream_case(12, torch.float32, "cpu", case)
    want = _clone_state(st)
    site = {"split": cg_stream._stream_iteration, "stacked": cg_stream._stream_iteration_stacked,
            "bf16": cg_stream._stream_iteration, "pcg": cg_stream._stream_iteration_pcg}[case]
    before = site.launches
    cg_stream.step(bands, st, offsets=offs, **STREAM_KW)
    _plain_step(bands, want, offs)
    # the PCG counts its plan's launches: one on the wavefront (its rings fit at R = 12)
    per_call = cg_stream.pcg_plan(144, offs, torch.float32, 1).launches if case == "pcg" else 1
    assert site.launches == before + per_call == before + 1
    for a, w in zip(st, want):
        assert (a is None and w is None) or torch.equal(a, w)
    assert st.scal[cg_stream.K] == 1.0


def test_stream_wrappers_reject_bad_operands():
    from cgx_torch.ops import cg_stream

    bands, offs, st = _stream_case(6, torch.float64, "cpu", "split")
    with pytest.raises(ValueError):  # scalars must be float64
        cg_stream._stream_iteration(bands, st.p, st.x, st.r, st.w, st.s, st.scal.float(),
                                    offsets=offs, **STREAM_KW)
    with pytest.raises(ValueError):  # a pair is two rows
        cg_stream._stream_iteration(bands, st.p, st.x, st.r[0], st.w, st.s, st.scal,
                                    offsets=offs, **STREAM_KW)
    with pytest.raises(ValueError):  # bf16 bands under float64 vectors
        cg_stream._stream_iteration(bands.to(torch.bfloat16), st.p, st.x, st.r, st.w, st.s,
                                    st.scal, offsets=offs, **STREAM_KW)
    with pytest.raises(ValueError):  # the stack is (2, 3, N)
        cg_stream._stream_iteration_stacked(bands, st.p, st.x, st.r, st.scal, offsets=offs,
                                            **STREAM_KW)
    with pytest.raises(ValueError, match="offset 0"):
        cg_stream._stream_iteration_pcg(bands[[0, 1, 3, 4]], st.p, st.x, st.p.clone(), st.r,
                                        st.w, st.s, st.scal, offsets=(-6, -1, 1, 6), **STREAM_KW)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split", "stacked", "bf16", "pcg"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g", [30, 700])  # a grid of one block, and of many
def test_cuda_stream_kernels_match_plain(cuda, g, dtype, case):
    """One launch: vectors bitwise the plain version's (-fmad=false, the
    same scalars), the float64 dots within 1e-12 (another summation
    order). 32 launches: vectors within 1e-4/1e-12 of max|ref| (a dot's
    last bit can flip a float alpha), k, stop and breakdown equal."""
    from cgx_torch.ops import cg_stream

    if case == "bf16" and dtype == torch.float64:
        pytest.skip("bfloat16 bands go under float32 vectors only")
    bands, offs, st = _stream_case(g, dtype, cuda, case)
    for launches, rtol in ((1, 0.0), (32, 1e-4 if dtype == torch.float32 else 1e-12)):
        got, want = _clone_state(st), _clone_state(st)
        for _ in range(launches):
            cg_stream.step(bands, got, offsets=offs, **STREAM_KW)
            _plain_step(bands, want, offs)
        torch.cuda.synchronize()
        for a, w in zip(got[:6], want[:6]):
            if a is not None:
                assert float((a - w).abs().max()) <= rtol * float(w.abs().max()), case
        k = cg_stream.K
        assert torch.equal(got.scal[k:], want.scal[k:])
        dots = got.scal[:3] - want.scal[:3]
        assert float(dots.abs().max()) <= 1e-12 * float(want.scal[:3].abs().max()) or launches > 1


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wavefront", "three"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g", [30, 700])  # one slab shorter than 4R; many slabs
def test_cuda_pcg_designs_bitwise(cuda, g, dtype, design):
    """B6 in both designs from one seeded state: after a launch p, x, u,
    r', s' and w' are bitwise the plain version's, the float64 dots
    within 1e-12 (another summation order); the wavefront counts one
    launch, the three-launch design three. A frozen launch changes
    nothing."""
    from cgx_torch.ops import cg_stream
    from cgx_torch.ops._util import sms_of

    bands, offs, st = _stream_case(g, dtype, cuda, "pcg")
    n = g * g
    plan = (cg_stream.pcg_plan(n, offs, dtype, sms_of(cuda)) if design == "wavefront"
            else cg_stream.three_plan(n))
    assert plan.design == design
    got, want = _clone_state(st), _clone_state(st)
    before = cg_stream._stream_iteration_pcg.launches
    cg_stream.step(bands, got, offsets=offs, plan=plan, **STREAM_KW)
    _plain_step(bands, want, offs)
    torch.cuda.synchronize()
    assert cg_stream._stream_iteration_pcg.launches - before == plan.launches
    assert cg_stream._stream_iteration_pcg.design == design
    q = 1  # the halves the launch wrote
    for a, w in zip((got.p, got.x, got.u, got.r[q], got.s[q], got.w[q]),
                    (want.p, want.x, want.u, want.r[q], want.s[q], want.w[q])):
        assert torch.equal(a, w)
    assert torch.equal(got.scal[cg_stream.K:], want.scal[cg_stream.K:])
    assert float(((got.scal[:3] - want.scal[:3]).abs() / want.scal[:3].abs()).max()) <= 1e-12
    got.scal[cg_stream.STOP] = 1.0
    frozen = _clone_state(got)
    cg_stream.step(bands, got, offsets=offs, plan=plan, **STREAM_KW)
    torch.cuda.synchronize()
    for a, w in zip(got, frozen):
        assert (a is None and w is None) or torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wavefront", "grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("case", ["split", "stacked"])
@pytest.mark.parametrize("g", [30, 700])  # a grid of one block, and of many
def test_cuda_plain_stream_designs_bitwise(cuda, g, case, dtype, design):
    """B4 and B7 in both designs of stream_plan from one seeded state:
    after a launch p, x, r', s' and w' are bitwise the plain version's,
    the float64 dots within 1e-12 (another summation order); the launch
    counts one and records its design; a frozen launch changes nothing."""
    from cgx_torch.ops import cg_stream
    from cgx_torch.ops._util import sms_of

    bands, offs, st = _stream_case(g, dtype, cuda, case)
    n = g * g
    plan = (cg_stream.stream_plan(n, offs, dtype, sms_of(cuda)) if design == "wavefront"
            else cg_stream.grid_plan(n))
    assert plan.design == design
    site = cg_stream._stream_iteration_stacked if case == "stacked" else cg_stream._stream_iteration
    got, want = _clone_state(st), _clone_state(st)
    before = site.launches
    cg_stream.step(bands, got, offsets=offs, plan=plan, **STREAM_KW)
    _plain_step(bands, want, offs)
    torch.cuda.synchronize()
    assert site.launches - before == 1 and site.design == design
    q = 1  # the halves the launch wrote
    for a, w in zip((got.p, got.x, got.r[q], got.s[q], got.w[q]),
                    (want.p, want.x, want.r[q], want.s[q], want.w[q])):
        assert torch.equal(a, w)
    assert torch.equal(got.scal[cg_stream.K:], want.scal[cg_stream.K:])
    assert float(((got.scal[:3] - want.scal[:3]).abs() / want.scal[:3].abs()).max()) <= 1e-12
    got.scal[cg_stream.STOP] = 1.0
    frozen = _clone_state(got)
    cg_stream.step(bands, got, offsets=offs, plan=plan, **STREAM_KW)
    torch.cuda.synchronize()
    for a, w in zip(got, frozen):
        assert (a is None and w is None) or torch.equal(a, w)


@pytest.mark.cuda
def test_cuda_stream_frozen_launch_changes_nothing(cuda):
    from cgx_torch.ops import cg_stream

    bands, offs, st = _stream_case(64, torch.float32, cuda, "split")
    for scal_fix in ({cg_stream.STOP: 1.0}, {cg_stream.K: 7.0}):
        frozen = _clone_state(st)
        for i, v in scal_fix.items():
            frozen.scal[i] = v
        before = _clone_state(frozen)
        cg_stream.step(bands, frozen, offsets=offs, **{**STREAM_KW, "maxiter": 7})
        torch.cuda.synchronize()
        for a, w in zip(frozen, before):
            assert (a is None and w is None) or torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("precond", [False, True])
def test_cuda_stream_solves_repeat_bitwise(cuda, precond):
    """Two streaming solves are bitwise equal, split equals stacked, and
    the fp32 count is the plain pipelined loop's with float64 dots."""
    from cgx_torch.solver.pipelined import pipelined_cg_solve
    from cgx_torch.solver.precond import neumann_banded

    dia = lap2d_fd(300)
    b = source_term(dia.shape[0])
    tol = 1e-5 * float(np.linalg.norm(b))
    op = cgx_torch.as_operator(dia, torch.float32, device=cuda)
    bt = torch.as_tensor(b, dtype=torch.float32, device=cuda)
    if precond:
        runs = [cgx_torch.dia_cg_solve_stream_pcg(op, bt, tol=tol, device=cuda) for _ in range(2)]
    else:
        runs = [cgx_torch.dia_cg_solve_stream(op, bt, tol=tol, layout=layout, bands_dtype="auto",
                                              device=cuda)
                for layout in ("split", "split", "stacked")]
    first = runs[0]
    assert bool(first.converged)
    for again in runs[1:]:
        assert int(again.iterations) == int(first.iterations)
        assert torch.equal(first.x.view(torch.int32), again.x.view(torch.int32))
    pc = neumann_banded(op.bands, op.offsets, sweeps=2) if precond else None
    plain = pipelined_cg_solve(op, bt, tol=tol, precond=pc, dot_precision=torch.float64,
                               device=cuda)
    assert abs(int(first.iterations) - int(plain.iterations)) <= 1


@pytest.mark.cuda
def test_cuda_stream_fp64_golden(cuda):
    from cgx_torch.solver.pipelined import pipelined_cg_solve

    dia = lap2d_fd(100)
    b = source_term(dia.shape[0])
    op = cgx_torch.as_operator(dia, torch.float64, device=cuda)
    res = cgx_torch.dia_cg_solve_stream(op, b, tol=1e-10, device=cuda)
    plain = pipelined_cg_solve(op, b, tol=1e-10, device=cuda)
    assert bool(res.converged) and abs(int(res.iterations) - int(plain.iterations)) <= 2
    x = res.x.cpu().numpy()
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("precond", [False, True])
def test_cuda_chunk_kernel_bf16_bands_match_plain(cuda, precond):
    """B5 with bfloat16 bands: 64 iterations against the plain chunk on
    the same rounded bands."""
    dia = lap2d_fd(700)
    bands, state = _chunk_state(dia, torch.float32, cuda)
    bands = bands.to(torch.bfloat16)
    got, ref = [t.clone() for t in state], [t.clone() for t in state]
    kw = dict(offsets=dia.offsets, tol=0.0, nearzero=1e-14, maxiter=10**6, chunk=64,
              precond=precond)
    s_got = cg_kernel.dia_cg_chunk(bands, *got, **kw)
    s_ref = cg_kernel.dia_cg_chunk_ref(bands, *ref, **kw)
    torch.cuda.synchronize()
    for a, w in zip(got[:3], ref[:3]):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert torch.equal(s_got[1:], s_ref[1:])


SSTEP = dict(theta=4.0, delta=3.9)
NEWTON = (7.0, 0.5, 4.5, 2.0)


def _sstep_inputs(g, dtype, device, seed=0):
    dia = lap2d_fd(g)
    rng = np.random.default_rng(seed)
    p, r = (torch.as_tensor(rng.standard_normal(g * g), dtype=dtype, device=device)
            for _ in range(2))
    return dia, torch.as_tensor(dia.bands, dtype=dtype, device=device), p, r


@pytest.mark.cuda
@pytest.mark.parametrize("shifts", [(), NEWTON], ids=["chebyshev", "newton"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g", [33, 700])  # one tile, ragged; many tiles, many blocks
def test_cuda_powers_kernel_matches_plain(cuda, g, dtype, shifts):
    """B9's basis equals the plain one bit for bit (the same operations,
    -fmad=false)."""
    from cgx_torch.ops import dia_powers

    dia, bands, p, r = _sstep_inputs(g, dtype, cuda)
    kw = dict(offsets=dia.offsets, s=4, shifts=shifts, **SSTEP)
    got = dia_powers.dia_sstep_basis(bands, p, r, **kw)
    want = dia_powers.dia_sstep_basis_ref(bands, p, r, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("g", [33, 700])
def test_cuda_sstep_block_matches_plain(cuda, g, case):
    """One fused block from a seeded state: G within 1e-12 of sum|v_i v_j|,
    the replayed coefficients within 1e-13, the scalars' k, conv and brk
    equal; then x, r and p bitwise the plain recovery's from the same
    coefficients; the replay kernel alone within 1e-13 of its plain version."""
    from cgx_torch.ops import sstep_stream as ss

    dtype = torch.float64 if case == "f64" else torch.float32
    dia, bands, p, r = _sstep_inputs(g, dtype, cuda)
    kb = bands.to(torch.bfloat16) if case == "bf16" else bands
    kw = dict(offsets=dia.offsets, s=4, shifts=(), **SSTEP)
    base = ss.initial_state(bands, r, torch.zeros_like(r), 0.0, **kw)
    base.p[0].copy_(p)
    sk = dict(tol=0.0, nearzero=1e-14, maxiter=10**6)
    got, want = ([t.clone() for t in base] for _ in range(2))
    ss._sstep_gram(kb, got[1], got[2], got[3], got[4], **kw, **sk)
    ss._gram_ref(kb, want[1], want[2], want[3], want[4], **kw, **sk)
    torch.cuda.synchronize()
    m = 9
    v = ss.dia_sstep_basis_ref(kb, p, r, **kw).double()
    scale = (v.abs() @ v.abs().T).reshape(-1)
    gg = slice(ss.GRAM, ss.GRAM + m * m)
    assert float(((got[3][gg] - want[3][gg]).abs() / scale).max()) <= 1e-12
    coef = slice(ss.COEF, ss.COEF + 3 * m)
    assert float((got[3][coef] - want[3][coef]).abs().max()) <= 1e-13 * float(
        want[3][coef].abs().max())
    assert torch.equal(got[3][[ss.K, ss.CONV, ss.BRK, ss.LIVE]],
                       want[3][[ss.K, ss.CONV, ss.BRK, ss.LIVE]])
    want[3].copy_(got[3])  # the same coefficients on both sides
    ss._sstep_recover(kb, got[1], got[2], got[0], got[3], **kw)
    ss._recover_ref(kb, want[1], want[2], want[0], want[3], **kw)
    torch.cuda.synchronize()
    for a, w in zip(got[:4], want[:4]):
        assert torch.equal(a, w)
    st = want[3].clone()
    ss.sstep_replay(got[3], got[4], s=4, **sk)
    ss._replay_ref(st, want[4], s=4, **sk)
    torch.cuda.synchronize()
    assert float((got[3][coef] - st[coef]).abs().max()) <= 1e-13 * float(st[coef].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("g", [33, 700])
def test_cuda_gram_designs_agree(cuda, g, case):
    """The wavefront and the slab design of the Gram launch, on the same
    inputs: each within 1e-12 of the exact sums (relative to sum|v_i v_j|),
    the same k, conv and brk, and each bitwise repeatable."""
    from cgx_torch.ops import dia_powers as dp
    from cgx_torch.ops import sstep_stream as ss

    dtype = torch.float64 if case == "f64" else torch.float32
    dia, bands, p, r = _sstep_inputs(g, dtype, cuda)
    kb = bands.to(torch.bfloat16) if case == "bf16" else bands
    kw = dict(offsets=dia.offsets, s=4, shifts=(), **SSTEP)
    sk = dict(tol=0.0, nearzero=1e-14, maxiter=10**6)
    base = ss.initial_state(bands, r, torch.zeros_like(r), 0.0, **kw)
    base.p[0].copy_(p)
    n, m = g * g, 9
    work = ss.workspace(cuda, n, dia.offsets, 4, dtype)
    assert work.plan.design == "wavefront"  # a reach of g fits the rings
    slab = ss.workspace(cuda, n, dia.offsets, 4, dtype,
                        plan=dp.slab_plan(n, 4, dtype, work.plan.grid))
    v = ss.dia_sstep_basis_ref(kb, p, r, **kw).double()
    exact, scale = (v @ v.T).reshape(-1), (v.abs() @ v.abs().T).reshape(-1)
    gg, flags = slice(ss.GRAM, ss.GRAM + m * m), [ss.K, ss.CONV, ss.BRK, ss.LIVE]
    states = []
    for wk in (work, work, slab, slab):
        st = [t.clone() for t in base]
        ss._sstep_gram(kb, st[1], st[2], st[3], st[4], work=wk, **kw, **sk)
        assert ss._sstep_gram.design == wk.plan.design
        states.append(st[3])
    torch.cuda.synchronize()
    for st in states:
        assert float(((st[gg] - exact).abs() / scale).max()) <= 1e-12
        assert torch.equal(st[flags], states[0][flags])
    assert torch.equal(states[0], states[1]) and torch.equal(states[2], states[3])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("g", [33, 700])
def test_cuda_recover_and_powers_designs_agree(cuda, g, case):
    """The wavefront and the slab design of the recover launch and of B9,
    on the same inputs: x, r, p and the state bitwise the plain recover's,
    the basis bitwise the plain one, in both designs."""
    from cgx_torch.ops import dia_powers as dp
    from cgx_torch.ops import sstep_stream as ss

    dtype = torch.float64 if case == "f64" else torch.float32
    dia, bands, p, r = _sstep_inputs(g, dtype, cuda)
    kb = bands.to(torch.bfloat16) if case == "bf16" else bands
    kw = dict(offsets=dia.offsets, s=4, shifts=(), **SSTEP)
    sk = dict(tol=0.0, nearzero=1e-14, maxiter=10**6)
    base = ss.initial_state(bands, r, torch.zeros_like(r), 0.0, **kw)
    base.p[0].copy_(p)
    base.x.copy_(p)
    ss._gram_ref(kb, base.p, base.r, base.state, base.bmat, **kw, **sk)
    n = g * g
    work = ss.workspace(cuda, n, dia.offsets, 4, dtype)
    assert work.plan.design == "wavefront"
    slab_plan = dp.slab_plan(n, 4, dtype, work.plan.grid)
    slab = ss.workspace(cuda, n, dia.offsets, 4, dtype, plan=slab_plan)
    want = [t.clone() for t in base]
    ss._recover_ref(kb, want[1], want[2], want[0], want[3], **kw)
    for wk in (work, slab):
        got = [t.clone() for t in base]
        ss._sstep_recover(kb, got[1], got[2], got[0], got[3], work=wk, **kw)
        assert ss._sstep_recover.design == wk.plan.design
        torch.cuda.synchronize()
        assert all(torch.equal(a, w) for a, w in zip(got[:4], want[:4]))
    if case != "bf16":
        ref = dp.dia_sstep_basis_ref(bands, p, r, **kw)
        for plan in (None, slab_plan):
            got = dp.dia_sstep_basis_planes(bands, p, r, plan=plan, **kw)
            assert dp.dia_sstep_basis_planes.design == ("slab" if plan else "wavefront")
            assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_sstep_frozen_block_changes_nothing(cuda):
    from cgx_torch.ops import sstep_stream as ss

    dia, bands, p, r = _sstep_inputs(64, torch.float32, cuda)
    kw = dict(offsets=dia.offsets, s=4, **SSTEP)
    st = ss.initial_state(bands, r, torch.zeros_like(r), 0.0, **kw)
    for fix in ({ss.CONV: 1.0}, {ss.BRK: 1.0}, {ss.K: 7.0}):
        frozen = ss.BlockState(*(t.clone() for t in st))
        for i, v in fix.items():
            frozen.state[i] = v
        before = [t.clone() for t in frozen]
        ss.block(bands, frozen, tol=0.0, nearzero=1e-14, maxiter=7, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, w) for a, w in zip(frozen, before))


@pytest.mark.cuda
@pytest.mark.parametrize("powers", ["fused", "pallas"])
def test_cuda_sstep_solves_repeat_bitwise(cuda, powers):
    """Two s-step solves on the kernels are bitwise equal, and the count is
    within 2% of the plain loop with the kernels' float64 Gram."""
    from cgx_torch.solver.chebyshev import spectral_bounds
    from cgx_torch.solver.sstep import sstep_cg_solve

    dia = lap2d_fd(300)
    b = source_term(dia.shape[0])
    tol = 1e-5 * float(np.linalg.norm(b))
    op = cgx_torch.as_operator(dia, torch.float32, device=cuda)
    bt = torch.as_tensor(b, dtype=torch.float32, device=cuda)
    kw = dict(tol=tol, bounds=spectral_bounds(op, dia.shape[0]), device=cuda)
    runs = [sstep_cg_solve(op, bt, powers=powers, **kw) for _ in range(2)]
    assert bool(runs[0].converged)
    assert int(runs[0].iterations) == int(runs[1].iterations)
    assert torch.equal(runs[0].x.view(torch.int32), runs[1].x.view(torch.int32))
    plain = sstep_cg_solve(op, bt, powers="off", gram_precision=torch.float64, **kw)
    assert abs(int(runs[0].iterations) - int(plain.iterations)) <= 0.02 * int(plain.iterations) + 4


@pytest.mark.cuda
def test_cuda_sstep_fp64_golden(cuda):
    from cgx_torch.solver.sstep import sstep_cg_solve

    dia = lap2d_fd(100)
    b = source_term(dia.shape[0])
    op = cgx_torch.as_operator(dia, torch.float64, device=cuda)
    res = cgx_torch.dia_sstep_stream_solve(op, b, tol=1e-10, device=cuda)
    plain = sstep_cg_solve(op, b, tol=1e-10, gram_precision=torch.float64, device=cuda)
    assert bool(res.converged) and abs(int(res.iterations) - int(plain.iterations)) <= 4
    x = res.x.cpu().numpy()
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("make", [lambda: lap2d_fd(100), lambda: lap2d_reference(300_000),
                                  lambda: cgx_torch.lap3d_fd(30)],
                         ids=["fd100", "ref300k", "3d30"])
def test_cuda_stream_matvec_matches_plain_bitwise(cuda, dtype, make):
    """B8, both entry points: the products in offset order, rounded one by
    one (-fmad=false), are the plain version's bit for bit."""
    dia = make()
    offs = tuple(dia.offsets)
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=cuda)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(dia.shape[0]), dtype=dtype,
                        device=cuda)
    planes = dia_spmv.stream2d_band_planes(bands, rows=256, cols=512).contiguous()
    want = dia_spmv.dia_matvec_ref(bands, x, offsets=offs)
    flat = dia_spmv.dia_matvec_stream(bands, x, offsets=offs)
    plane = dia_spmv.dia_matvec_stream2d_planes(planes, x, offsets=offs)
    torch.cuda.synchronize()
    assert torch.equal(flat, want) and torch.equal(plane, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_stream_matvec_off_the_grid(cuda, dtype):
    """B8's scalar paths: the flat form with n % 4 != 0 (band rows off the
    16-byte grid, a scalar tail) and an x view off the 16-byte grid
    (copied value by value) are bitwise the plain version's."""
    dia = lap2d_fd(333)
    offs = tuple(dia.offsets)
    n = dia.shape[0]
    assert n % 4 == 1
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=cuda)
    xs = torch.as_tensor(np.random.default_rng(4).standard_normal(n + 1), dtype=dtype,
                         device=cuda)
    for x in (xs[:n], xs[1:]):
        want = dia_spmv.dia_matvec_ref(bands, x, offsets=offs)
        assert torch.equal(dia_spmv.dia_matvec_stream(bands, x, offsets=offs), want)
    assert dia_spmv.dia_matvec_stream.plan == dia_spmv.stream_plan(n, offs, dtype,
                                                                   dia_spmv.sms_of(cuda))


@pytest.mark.cuda
def test_cuda_sharded_stream2d_equals_xla(cuda):
    """One rank without a process group: the B8 local product with its
    patched edges gives the plain local path's solve bit for bit."""
    from cgx_torch.parallel import make_mesh, sharded_cg_solve

    dia = lap2d_fd(300)
    b = source_term(dia.shape[0]).astype(np.float32)
    mesh = make_mesh(device=cuda)
    kw = dict(mesh=mesh, tol=1e-5 * float(np.linalg.norm(b)), dot_precision=torch.float64)
    before = dia_spmv.dia_matvec_stream2d_planes.launches
    st = sharded_cg_solve(dia, b, local_kernel="stream2d", **kw)
    assert dia_spmv.dia_matvec_stream2d_planes.launches - before >= int(st.iterations) + 1
    xla = sharded_cg_solve(dia, b, local_kernel="xla", **kw)
    assert int(st.iterations) == int(xla.iterations)
    assert torch.equal(st.x.view(torch.int32), xla.x.view(torch.int32))

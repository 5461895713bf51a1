"""cgx_torch.solve against cgx.solve: routing, devices and what is not
ported yet."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx_torch import SolveConfig, config
from cgx_torch.ops import axpy, cg_kernel, cg_stream, dia_spmv

THREE_KERNEL = [dia_spmv.dia_matvec, dia_spmv.dia_matvec_dot, axpy.fused_update_rs,
                axpy.fused_axpby]


@pytest.fixture
def problem():
    return cgx_torch.lap2d_reference(256), cgx_torch.source_term(256)


def test_default_config(problem):
    dia, b = problem
    res = cgx_torch.solve(dia, b, device="cpu")
    want = cgx.solve(cgx.lap2d_reference(256), b)
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert int(res.iterations) == int(want.iterations)
    rel = np.linalg.norm(dia.to_dense() @ res.x.numpy() - b) / np.linalg.norm(b)
    assert rel < 1e-11


def test_pallas_route_matches_cgx_and_plain(problem):
    """fp32 use_pallas: within one iteration of cgx's own use_pallas
    solve (the whole-solve kernel, interpreted) and of the plain fp32
    solve (tests/test_api.py:34-42)."""
    dia, b = problem
    tol = 1e-4 * np.linalg.norm(b)
    cfg = SolveConfig(precision="fp32", tolerance=tol, use_pallas=True)
    res = cgx_torch.solve(dia, b, cfg, device="cpu")
    assert bool(res.converged) and res.x.dtype == torch.float32
    cgx_pallas = cgx.solve(cgx.lap2d_reference(256), b,
                           cgx.SolveConfig(precision="fp32", tolerance=tol, use_pallas=True))
    plain = cgx_torch.solve(dia, b, SolveConfig(precision="fp32", tolerance=tol), device="cpu")
    assert abs(int(res.iterations) - int(cgx_pallas.iterations)) <= 1
    assert abs(int(res.iterations) - int(plain.iterations)) <= 1


def _counts():
    return [w.launches for w in THREE_KERNEL], dict(cg_kernel.dia_cg_chunk.launches)


def test_pallas_route_goes_through_the_kernels(problem):
    """Within the resident budget a banded fp32 use_pallas solve runs the
    whole-solve kernel (layout 2d, a launch per 64 iterations) and none of
    the three-kernel loop's."""
    dia, b = problem
    cfg = SolveConfig(precision="fp32", tolerance=1e-4 * np.linalg.norm(b), use_pallas=True)
    loop, chunks = _counts()
    res = cgx_torch.solve(dia, b, cfg, device="cpu")
    assert _counts()[0] == loop
    assert cg_kernel.dia_cg_chunk.launches["2d"] - chunks["2d"] == -(-(int(res.iterations) + 1)
                                                                      // 64)
    assert cg_kernel.dia_cg_chunk.launches["1d"] == chunks["1d"]
    # fp64, x0 and dense operators keep to the reference loop
    before = _counts()
    cgx_torch.solve(dia, b, SolveConfig(use_pallas=True), device="cpu")
    cgx_torch.solve(dia, b, SolveConfig(precision="fp32", use_pallas=True,
                                        tolerance=cfg.tolerance), x0=np.zeros(256), device="cpu")
    cgx_torch.solve(dia.to_dense(), b, cfg, device="cpu")
    assert _counts() == before


def _stream_counts():
    return [f.launches for f in (cg_stream._stream_iteration, cg_stream._stream_iteration_stacked,
                                 cg_stream._stream_iteration_pcg)]


@pytest.mark.parametrize("precond", [None, "neumann"])
def test_pallas_route_above_the_budget(problem, monkeypatch, precond):
    """Above the resident budget large_banded decides, as in cgx
    api.py:365-391: "stream" runs B4 (no preconditioner) or B6
    ("neumann"), a launch an iteration and none of B5's or of the
    three-kernel loop's (frozen once converged, up to the next host
    read), within one iteration of cgx's streaming solve;
    "xla" runs the plain loop with the configured preconditioner, the k
    and x of cgx's "xla" route; any other value raises."""
    import cgx.solver.api as cgx_api

    dia, b = problem
    tol = 1e-4 * np.linalg.norm(b)
    monkeypatch.setattr(config, "RESIDENT_BUDGET_BYTES", 1000)
    monkeypatch.setattr(cgx_api, "VMEM_BUDGET_BYTES", 1000)
    kw = dict(precision="fp32", tolerance=tol, use_pallas=True, precond=precond)
    loop, chunks = _counts()
    stream = _stream_counts()
    res = cgx_torch.solve(dia, b, SolveConfig(**kw), device="cpu")
    moved = [c - c0 for c, c0 in zip(_stream_counts(), stream)]
    k = int(res.iterations)
    assert bool(res.converged) and _counts() == (loop, chunks)
    launched = -(-k // 32) * 32  # the host reads the stop flag once per 32 launches
    # the PCG: the launches of its plan's design a call (one on the wavefront, csrc/cg_stream.cu)
    per_call = cg_stream.pcg_plan(dia.shape[0], tuple(dia.offsets), torch.float32, 1).launches
    assert per_call == 1
    assert moved == ([0, 0, per_call * launched] if precond else [launched, 0, 0])
    want = cgx.solve(cgx.lap2d_reference(256), b, cgx.SolveConfig(**kw))
    assert abs(k - int(want.iterations)) <= 1

    got = cgx_torch.solve(dia, b, SolveConfig(large_banded="xla", **kw), device="cpu")
    want = cgx.solve(cgx.lap2d_reference(256), b, cgx.SolveConfig(large_banded="xla", **kw))
    assert _stream_counts() == [c + m for c, m in zip(stream, moved)]
    assert int(got.iterations) == int(want.iterations)
    wx = np.asarray(want.x, np.float64)
    np.testing.assert_allclose(got.x.numpy(), wx, rtol=1e-4, atol=1e-4 * np.abs(wx).max())
    with pytest.raises(ValueError, match="large_banded"):
        cgx_torch.solve(dia, b, SolveConfig(large_banded="dense", **kw), device="cpu")


def test_neumann_pallas_route_matches_cgx(problem):
    """use_pallas + neumann: the kernel's in-kernel PCG, within one
    iteration of cgx's (interpreted) and of the plain fp32 PCG solve."""
    dia, b = problem
    tol = 1e-4 * np.linalg.norm(b)
    kw = dict(precision="fp32", tolerance=tol, precond="neumann")
    before = cg_kernel.dia_cg_chunk.launches["2d"]
    res = cgx_torch.solve(dia, b, SolveConfig(use_pallas=True, **kw), device="cpu")
    assert cg_kernel.dia_cg_chunk.launches["2d"] > before and bool(res.converged)
    want = cgx.solve(cgx.lap2d_reference(256), b, cgx.SolveConfig(use_pallas=True, **kw))
    plain = cgx_torch.solve(dia, b, SolveConfig(**kw), device="cpu")
    assert abs(int(res.iterations) - int(want.iterations)) <= 1
    assert abs(int(res.iterations) - int(plain.iterations)) <= 1


@pytest.mark.parametrize("precond", ["jacobi", "neumann"])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_precond_without_pallas_matches_cgx(problem, precond, precision):
    dia, b = problem
    cfg = dict(precision=precision, tolerance=1e-6 * np.linalg.norm(b), precond=precond)
    want = cgx.solve(cgx.lap2d_reference(256), b, cgx.SolveConfig(**cfg))
    got = cgx_torch.solve(dia, b, SolveConfig(**cfg), device="cpu")
    assert bool(got.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    rtol = 1e-8 if precision == "fp64" else 1e-3
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(want.x)).max())


@pytest.mark.parametrize(
    "cfg,kwargs",
    [
        (SolveConfig(precision="bf16"), {}),
        # on the sharded route too, before any mesh is made (the sharded s-step,
        # MG, mixed and tw solves run since the single-RHS half of ROADMAP A14)
        (SolveConfig(precision="bf16"), {"n_devices": 4}),
    ],
    ids=["bf16", "bf16_n_devices"],
)
def test_unported_configs_raise(problem, cfg, kwargs):
    dia, b = problem
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgx_torch.solve(dia, b, cfg, device="cpu", **kwargs)


@pytest.mark.parametrize(
    "gen,cfg",
    [
        ("ref256", dict(precond="block_jacobi")),
        ("ref256", dict(precond="chebyshev")),
        ("fd64", dict(precond="mg")),
        ("fd64", dict(precond="mg", mg_smoother="gs")),
        ("fd64", dict(precond="mg", mg_cycle_precision="fp32")),
        ("fd64", dict(precond="mg", precision="fp32")),
        ("3d16", dict(precond="mg")),
        ("fd64", dict(precond="mg", method="pipelined")),
    ],
    ids=["block_jacobi", "chebyshev", "mg", "mg_gs", "mg_fp32_cycle", "mg_fp32", "mg_3d",
         "mg_pipelined"],
)
def test_precond_configs_match_cgx(gen, cfg):
    """solve(precond="block_jacobi"|"chebyshev"|"mg") on one device, as cgx
    builds them (api.py:39-79): k equal to cgx's (or within 1 where the fp32
    cycle or fp32 vectors round differently), and the true residual gate.
    MG on a 3-D operator finds its grid by infer_grid_ndim."""
    make = {"ref256": lambda m: m.lap2d_reference(256), "fd64": lambda m: m.lap2d_fd(64),
            "3d16": lambda m: m.lap3d_fd(16)}[gen]
    mat_c, mat_t = make(cgx), make(cgx_torch)
    b = cgx_torch.source_term(mat_t.shape[0])
    fp32 = cfg.get("precision") == "fp32"
    cfg = dict(cfg, tolerance=(1e-5 if fp32 else 1e-10) * np.linalg.norm(b))
    want = cgx.solve(mat_c, b, cgx.SolveConfig(**cfg))
    got = cgx_torch.solve(mat_t, b, SolveConfig(**cfg), device="cpu")
    assert bool(got.converged) and not bool(got.breakdown)
    exact = cfg.get("mg_cycle_precision") != "fp32" and not fp32
    assert abs(int(got.iterations) - int(want.iterations)) <= (0 if exact else 1)

    def rel(x):
        return np.linalg.norm(mat_t.mat_vec(np.asarray(x, np.float64)) - b) / np.linalg.norm(b)

    if fp32:  # fp32 vectors: the true residual within 2x of cgx's
        assert rel(got.x.numpy()) <= 2 * rel(want.x)
    else:
        assert rel(got.x.numpy()) < 1e-10


def test_mg_needs_a_banded_operator(problem):
    dia, b = problem
    with pytest.raises(ValueError, match="banded grid operator"):
        cgx_torch.solve(dia.to_dense(), b, SolveConfig(precond="mg"), device="cpu")


@pytest.mark.parametrize(
    "cfg",
    [dict(method="sstep", tolerance=1e-6), dict(precond="mg", tolerance=1e-8),
     dict(precision="mixed", tolerance=1e-11), dict(precision="tw", tolerance=1e-12)],
    ids=["sstep", "mg", "mixed", "tw"],
)
def test_mesh_runs_the_single_rhs_a14_paths(cfg):
    """solve(mesh=) on one rank runs the sharded s-step, MG-PCG, mixed
    refinement and tw sweeps (cgx api.py:210-561): cgx's k on make_mesh(1)
    (sweeps for mixed and tw) and the true residual of cgx's gate."""
    from cgx.parallel.mesh import make_mesh as cgx_mesh

    g = 32
    dia, dia_c = cgx_torch.lap2d_fd(g), cgx.lap2d_fd(g)
    b = cgx_torch.source_term(g * g)
    got = cgx_torch.solve(dia, b, SolveConfig(**cfg), mesh=cgx_torch.make_mesh(device="cpu"),
                          device="cpu")
    want = cgx.solve(dia_c, b, cgx.SolveConfig(**cfg), mesh=cgx_mesh(1))
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    rel = np.linalg.norm(dia.mat_vec(got.x.numpy()) - b) / np.linalg.norm(b)
    assert rel < (1e-11 if "precision" in cfg or "precond" in cfg else 1e-6)


@pytest.mark.parametrize("precision", ["fp64", "fp32"])
@pytest.mark.parametrize("method", ["reference", "pipelined"])
@pytest.mark.parametrize("precond", [None, "jacobi", "neumann", "block_jacobi", "chebyshev"])
def test_mesh_routes_to_the_sharded_solver(problem, precision, method, precond):
    """solve(mesh=) runs cgx_torch.parallel's sharded_cg_solve (cgx
    api.py:210-270) with the configuration's method, preconditioner and
    tolerance; on one rank it is the single-device loop bit for bit, and
    it matches cgx's solve on make_mesh(1)."""
    from cgx.parallel.mesh import make_mesh as cgx_mesh

    from cgx_torch.utils import collectives

    dia, b = problem
    cfg = SolveConfig(precision=precision, tolerance=1e-6 * np.linalg.norm(b), method=method,
                      precond=precond, history=8)
    with collectives.capture() as cap:
        got = cgx_torch.solve(dia, b, cfg, mesh=cgx_torch.make_mesh(device="cpu"), device="cpu")
    assert cap.programs, "the sharded solver did not run"
    single = cgx_torch.solve(dia, b, cfg, device="cpu")
    assert torch.equal(got.x, single.x) and int(got.iterations) == int(single.iterations)
    want = cgx.solve(cgx.lap2d_reference(256), b, cgx.SolveConfig(**{
        "precision": precision, "tolerance": cfg.tolerance, "method": method, "precond": precond}),
        mesh=cgx_mesh(1))
    assert abs(int(got.iterations) - int(want.iterations)) <= (0 if precision == "fp64" else 1)
    rtol = 1e-10 if precision == "fp64" else 1e-3
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(want.x)).max())


def test_mesh_passes_the_block_size(problem, monkeypatch):
    """solve(mesh=) hands cfg.precond_block_size to the sharded solver, as
    cgx does (api.py:247-266): a size that straddles raises its error."""
    dia, b = problem
    mesh = cgx_torch.make_mesh(device="cpu")
    cfg = SolveConfig(precond="block_jacobi", precond_block_size=16, tolerance=1e-6)
    got = cgx_torch.solve(dia, b, cfg, mesh=mesh, device="cpu")
    single = cgx_torch.solve(dia, b, cfg, device="cpu")
    assert torch.equal(got.x, single.x)
    with pytest.raises(ValueError, match="divide the shard size"):
        cgx_torch.solve(dia, b, SolveConfig(precond="block_jacobi", precond_block_size=24),
                        mesh=mesh, device="cpu")


def test_sharded_route_takes_x0_and_operators(problem):
    """x0 is passed as cgx passes it; a port operator is read back to
    the host; n_devices=1 stays on one device, as in cgx."""
    dia, b = problem
    mesh = cgx_torch.make_mesh(device="cpu")
    cfg = SolveConfig(tolerance=1e-6)
    first = cgx_torch.solve(dia, b, cfg, mesh=mesh, device="cpu")
    warm = cgx_torch.solve(dia, b, cfg, mesh=mesh, x0=first.x, device="cpu")
    assert int(warm.iterations) <= 1
    op = cgx_torch.as_operator(dia, device="cpu")
    again = cgx_torch.solve(op, b, cfg, mesh=mesh, device="cpu")
    assert torch.equal(again.x, first.x)
    assert torch.equal(cgx_torch.solve(dia, b, cfg, n_devices=1, device="cpu").x, first.x)


def test_unported_inputs_raise(problem):
    """A 2-D b on the sharded route, which raised here until the multi-RHS
    half of ROADMAP A14 landed, now solves under either multi_rhs as on
    one device (tests/test_torch_sharded_multi_rhs.py against cgx). The
    sparse containers, which raised here until ROADMAP A3 landed, now
    solve like cgx's; an object that is no matrix still raises."""
    dia, b = problem
    mesh = cgx_torch.make_mesh(device="cpu")
    bb = np.stack([b, -b], axis=1)
    for multi_rhs in ("block", "batched"):
        cfg = SolveConfig(multi_rhs=multi_rhs, tolerance=1e-8)
        got = cgx_torch.solve(dia, bb, cfg, mesh=mesh, device="cpu")
        want = cgx_torch.solve(dia, bb, cfg, device="cpu")
        assert bool(got.converged.all())
        assert torch.equal(got.iterations, want.iterations)
        np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                                   atol=1e-10 * float(want.x.abs().max()))
    with pytest.raises(TypeError):
        cgx_torch.solve(object(), b, device="cpu")
    coo = cgx_torch.mats.generators.lap2d_fd_coo_lower(4)
    want = cgx.solve(cgx.mats.generators.lap2d_fd_coo_lower(4), np.ones(16))
    for mat in (coo, cgx_torch.CSRMatrix.from_coo(coo), cgx_torch.ELLMatrix.from_coo(coo),
                coo.to_scipy()):
        got = cgx_torch.solve(mat, np.ones(16), device="cpu")
        assert int(got.iterations) == int(want.iterations)


def test_default_device_needs_cuda(problem):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    dia, b = problem
    for call in (lambda: cgx_torch.solve(dia, b),
                 lambda: cgx_torch.solve(dia, b, SolveConfig(precision="mixed")),
                 lambda: cgx_torch.cg_solve(torch.eye(4), np.ones(4)),
                 lambda: cgx_torch.dia_cg_solve_pallas(None, np.ones(4)),
                 lambda: cgx_torch.dia_cg_solve_vmem(None, np.ones(4)),
                 lambda: cgx_torch.refine_fixed_sweeps(None, np.ones(4)),
                 lambda: cgx_torch.iterative_refinement(None, np.ones(4)),
                 lambda: cgx_torch.pipelined_cg_solve(torch.eye(4), np.ones(4)),
                 lambda: cgx_torch.dia_cg_solve_stream(None, np.ones(4)),
                 lambda: cgx_torch.dia_cg_solve_stream_pcg(None, np.ones(4)),
                 lambda: cgx_torch.sstep_cg_solve(torch.eye(4), np.ones(4)),
                 lambda: cgx_torch.dia_sstep_stream_solve(None, np.ones(4)),
                 lambda: cgx_torch.operator_from_numpy(np.eye(4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_tensor_on_another_device_raises(problem):
    dia, b = problem
    op = cgx_torch.as_operator(dia, device="cpu")
    b_meta = torch.empty(256, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        cgx_torch.solve(op, b_meta, device="cpu")
    with pytest.raises(ValueError):
        cgx_torch.cg_solve(op, b_meta, device="cpu")
    with pytest.raises(ValueError):
        cgx_torch.dia_cg_solve_pallas(op, b_meta, device="cpu")
    with pytest.raises(ValueError):
        cgx_torch.solve(torch.eye(256, device="meta"), b, device="cpu")


@pytest.mark.parametrize("kind", ["dia", "dense"])
def test_operator_from_numpy_solves_the_same_system(kind):
    """A cgx operator's arrays become the port's operator; both solve the
    same system to the same answer."""
    dia = cgx.lap2d_fd(12)
    b = cgx.source_term(144)
    cgx_op = cgx.DiaOperator.from_host(dia) if kind == "dia" else cgx.DenseOperator.from_host(dia)
    want = cgx.cg_solve(cgx_op, jnp.asarray(b), tol=1e-8)
    if kind == "dia":
        op = cgx_torch.operator_from_numpy(np.asarray(cgx_op.bands), cgx_op.offsets, device="cpu")
        assert isinstance(op, cgx_torch.DiaOperator) and op.offsets == tuple(cgx_op.offsets)
    else:
        op = cgx_torch.operator_from_numpy(np.asarray(cgx_op.a), device="cpu")
        assert isinstance(op, cgx_torch.DenseOperator)
    assert op.dtype == torch.float64 and op.device.type == "cpu"
    got = cgx_torch.cg_solve(op, b, tol=1e-8, device="cpu")
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9)
    assert torch.equal(op.diagonal(), torch.full((144,), 4.0, dtype=torch.float64))


def test_operator_from_numpy_casts_to_the_requested_dtype():
    dia = cgx.lap2d_fd(4)
    op = cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=torch.float32, device="cpu")
    assert op.bands.dtype == torch.float32 and op.bands.is_contiguous()
    with pytest.raises(ValueError):
        cgx_torch.operator_from_numpy(dia.bands, dia.offsets[:3], device="cpu")


@pytest.mark.parametrize("method", ["gvpipe", "chebyshev"])
def test_single_device_methods_match_cgx(problem, method):
    """method="gvpipe" and "chebyshev" run on one device as cgx routes them
    (api.py:280-318): cgx's k, x within 1e-10 (they raised naming A11
    until it landed)."""
    dia, b = problem
    cfg = dict(method=method, tolerance=1e-8 * np.linalg.norm(b))
    want = cgx.solve(cgx.lap2d_reference(256), b, cgx.SolveConfig(**cfg))
    got = cgx_torch.solve(dia, b, SolveConfig(**cfg), device="cpu")
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(want.x)).max())


@pytest.mark.parametrize("method", ["gvpipe", "chebyshev"])
def test_mesh_runs_gvpipe_and_chebyshev(problem, method):
    """solve(mesh=) takes the two methods to the sharded solver, with
    gv_replace_every and check_every; on one rank it is the single-device
    loop bit for bit (the sharded gvpipe raised naming A11 until it
    landed)."""
    from cgx_torch.utils import collectives

    dia, b = problem
    cfg = SolveConfig(method=method, tolerance=1e-8 * np.linalg.norm(b), check_every=8,
                      gv_replace_every=10)
    with collectives.capture() as cap:
        got = cgx_torch.solve(dia, b, cfg, mesh=cgx_torch.make_mesh(device="cpu"), device="cpu")
    assert cap.programs
    single = cgx_torch.solve(dia, b, cfg, device="cpu")
    assert int(got.iterations) == int(single.iterations)
    assert torch.equal(got.x, single.x)

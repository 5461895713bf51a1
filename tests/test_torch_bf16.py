"""bfloat16 vectors (ROADMAP A6, first part) against cgx, on the CPU.

``precision="bf16"`` keeps the vectors in bfloat16 with float64 dots
(cgx api.py:35, :193, :206-208) on every single-device route: the plain
loops, every preconditioner, and the kernel routes, whose plain versions
run here (B5 within the resident budget, B4/B7 and B6 above it, B3 for
the CLI's dense ``true`` run). On the mesh a bf16 request solves b in
float32, as cgx's does (api.py:233-234, :248, :935). The inputs are
cgx's own bf16 test's (tests/test_api.py:72-77): ``lap2d_fd(48)`` with
``source_term`` at 5e-2 ||b||.

bf16 has no true-residual gate: at this tolerance both packages end near
||Ax - b|| / ||b|| = 2.9 (the fp64 solution rounded to bfloat16 is
already at 0.52), so the gates are iteration counts and agreement with
cgx. The two packages round each bfloat16 operation alike on the plain
loops, so x agrees bit for bit there; the tolerances below cover the
kernel routes, where cgx's kernels keep float32 scalars and round their
dots' products to bfloat16 (the port keeps float64 scalars and exact
products, ROADMAP C).

The mesh and CLI cases run in gloo worlds spawned by the harness of
test_torch_sharded.py, so this module imports neither jax nor cgx at its
top: cgx is imported inside the functions that need it.
"""

import contextlib
import io
import os
import re
import tempfile

import numpy as np
import pytest
import torch

import cgx_torch
from cgx_torch import SolveConfig, config
from cgx_torch.mats.generators import lap2d_fd, lap2d_fd_coo_lower, source_term
from cgx_torch.ops import axpy, cg_kernel, cg_stream, dia_spmv
from cgx_torch.ops._util import BUILD_LAUNCHES, check_operands, vector_dtypes
from cgx_torch.parallel import make_mesh
from test_torch_sharded import run_world

GRID = 48  # cgx tests/test_api.py:72-77
DENSE_GRID = 24  # B3's dense runs: cgx's interpreted tiles are slow at N = 2304
MAXITER = 2000
XTOL = 2e-2  # x against cgx's, relative to ||x||, where both take the same k
STEP = re.compile(r"\[STEP (\d+)\] residual = ([0-9.e+-]+)")


def _problem(grid: int = GRID):
    b = source_term(grid * grid)
    return lap2d_fd(grid), b, 5e-2 * float(np.linalg.norm(b))


def _cgx():
    import cgx

    dia = cgx.lap2d_fd(GRID)
    return cgx, dia


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to("cpu", torch.float64).numpy()
    return np.asarray(np.asarray(x).astype(np.float32), np.float64)


# The probe's table: each route through cgx.solve and cgx_torch.solve. Where
# cgx's k is pinned, the port's equals it, converged alike, x within XTOL.
ROUTES = {
    "reference": {},
    "pipelined": dict(method="pipelined"),
    "gvpipe": dict(method="gvpipe"),  # breaks down at k = 11 in both
    "gvpipe_mg": dict(method="gvpipe", precond="mg"),
    "jacobi": dict(precond="jacobi"),
    "block_jacobi": dict(precond="block_jacobi"),
    "neumann": dict(precond="neumann"),
    "mg": dict(precond="mg"),
    # the Chebyshev iteration's scalars in bfloat16, as cgx's: k = 2000, not converged
    "chebyshev": dict(method="chebyshev"),
    "precond_chebyshev": dict(precond="chebyshev"),
    "pallas": dict(use_pallas=True),  # B5's plain version within the budget
    "pallas_neumann": dict(use_pallas=True, precond="neumann"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_match_cgx(route):
    cgx, dia_c = _cgx()
    dia, b, tol = _problem()
    kw = dict(precision="bf16", tolerance=tol, maxiter=MAXITER, **ROUTES[route])
    want = cgx.solve(dia_c, b, cgx.SolveConfig(**kw))
    got = cgx_torch.solve(dia, b, SolveConfig(**kw), device="cpu")
    assert got.x.dtype == torch.bfloat16
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    assert _rel(_np(got.x), _np(want.x)) <= XTOL


def test_chebyshev_scalars_round_to_bfloat16():
    """The repair: Chebyshev's host scalars in the vectors' dtype. cgx ends
    at the cap unconverged (k = 2000); float32 scalars, as before, took
    96 and converged. fp32 and fp64 keep their counts
    (test_torch_chebyshev_solve.py)."""
    dia, b, tol = _problem()
    got = cgx_torch.solve(dia, b, SolveConfig(precision="bf16", tolerance=tol, maxiter=MAXITER,
                                              method="chebyshev"), device="cpu")
    assert int(got.iterations) == MAXITER and not bool(got.converged)


def _budget0(monkeypatch):
    import cgx.solver.api as capi

    monkeypatch.setattr(config, "RESIDENT_BUDGET_BYTES", 0)
    monkeypatch.setattr(capi, "VMEM_BUDGET_BYTES", 0)


# The kernel routes' plain versions against cgx's interpreted kernels. cgx's
# kernels keep float32 scalars (and B4/B6's on the host between launches) and
# round each dot's products to bfloat16; the port's plain versions keep
# float64 scalars and exact products, the arithmetic of its plain loops with
# float64 dots. So k is held within WINDOW of cgx's, and to the port's own
# plain loop's exactly.
WINDOW = 0.1
KERNELS = ["b5_1d", "b5_1d_pcg", "b4", "b7", "b6", "b3"]


def _kernel_runs(case: str):
    """(cgx's result, the port's, the port's plain loop's k) of a kernel route."""
    cgx, dia_c = _cgx()
    import jax.numpy as jnp
    from cgx.ops import cg_kernel as ck
    from cgx.ops import cg_stream as cs
    from cgx.solver.operators import PallasDenseOperator as CgxDense

    from cgx_torch.solver.operators import DenseOperator, PallasDenseOperator

    dia, b, tol = _problem()
    op_c = cgx.as_operator(dia_c, dtype=jnp.bfloat16)
    op = cgx_torch.as_operator(dia, torch.bfloat16, device="cpu")
    b_c, b_t = jnp.asarray(b, jnp.bfloat16), torch.tensor(b, dtype=torch.bfloat16)
    kw = dict(tol=tol, maxiter=MAXITER)
    plain = dict(dot_precision=torch.float64, device="cpu", **kw)
    if case.startswith("b5"):
        pc = case.endswith("pcg")
        want = ck.dia_cg_solve_vmem(op_c, b_c, interpret=True, layout="1d", precond=pc, **kw)
        got = cg_kernel.dia_cg_solve_vmem(op, b_t, layout="1d", precond=pc, device="cpu", **kw)
        pcf = cgx_torch.neumann_banded(op.bands, op.offsets, sweeps=2) if pc else None
        ref = cgx_torch.cg_solve(op, b_t, precond=pcf, **plain)
    elif case in ("b4", "b7"):
        layout = "stacked" if case == "b7" else "split"
        want = cs.dia_cg_solve_stream(op_c, b_c, interpret=True, layout=layout, **kw)
        got = cg_stream.dia_cg_solve_stream(op, b_t, layout=layout, device="cpu", **kw)
        ref = cgx_torch.pipelined_cg_solve(op, b_t, **plain)
    elif case == "b6":
        want = cs.dia_cg_solve_stream_pcg(op_c, b_c, interpret=True, **kw)
        got = cg_stream.dia_cg_solve_stream_pcg(op, b_t, device="cpu", **kw)
        ref = cgx_torch.pipelined_cg_solve(
            op, b_t, precond=cgx_torch.neumann_banded(op.bands, op.offsets, sweeps=2), **plain)
    else:  # b3: the CLI's dense "1024 16" tiles, reference CG with float32 dots
        dia, b, tol = _problem(DENSE_GRID)
        b_c, b_t = jnp.asarray(b, jnp.bfloat16), torch.tensor(b, dtype=torch.bfloat16)
        kw = dict(tol=tol, maxiter=MAXITER)
        a = dia.to_dense()
        want = cgx.cg_solve(CgxDense(jnp.asarray(a, jnp.bfloat16), 1024, 128), b_c,
                            dot_precision=jnp.float32, **kw)
        a_t = torch.tensor(a, dtype=torch.bfloat16)
        got = cgx_torch.cg_solve(PallasDenseOperator(a_t, 1024, 128), b_t,
                                 dot_precision=torch.float32, device="cpu", **kw)
        ref = cgx_torch.cg_solve(DenseOperator(a_t), b_t, dot_precision=torch.float32,
                                 device="cpu", **kw)
    return want, got, int(ref.iterations)


@pytest.mark.parametrize("case", KERNELS)
def test_kernel_plain_versions_against_cgx_kernels(case):
    want, got, k_plain = _kernel_runs(case)
    k, k_cgx = int(got.iterations), int(want.iterations)
    assert got.x.dtype == torch.bfloat16
    assert bool(got.converged) and bool(want.converged)
    assert k == k_plain
    assert abs(k - k_cgx) <= WINDOW * k_cgx
    # both stop at 5% of ||b||: x agrees to that tolerance's reach
    assert _rel(_np(got.x), _np(want.x)) <= 0.1


def test_stream_routes_through_solve(monkeypatch):
    """Above the budget solve takes B4 (bf16 bands are the vectors' own)
    and, with Neumann, B6, as cgx's solve takes its streaming kernels."""
    _budget0(monkeypatch)
    dia, b, tol = _problem()
    for precond, site in ((None, cg_stream._stream_iteration),
                          ("neumann", cg_stream._stream_iteration_pcg)):
        build = site.__name__.removeprefix("_") + "_bf16"
        before = BUILD_LAUNCHES[build]
        got = cgx_torch.solve(dia, b, SolveConfig(precision="bf16", tolerance=tol,
                                                  maxiter=MAXITER, use_pallas=True,
                                                  precond=precond), device="cpu")
        assert bool(got.converged) and got.x.dtype == torch.bfloat16
        assert BUILD_LAUNCHES[build] - before >= int(got.iterations)
        assert site.bands_dtype == torch.bfloat16


@pytest.mark.parametrize("powers", ["off", "pallas"])
def test_sstep_refuses_bfloat16_as_cgx(powers):
    """cgx's s-step loop does not carry bfloat16 vectors (its while_loop
    carry changes dtype): TypeError in both packages."""
    cgx, dia_c = _cgx()
    dia, b, tol = _problem()
    kw = dict(precision="bf16", tolerance=tol, method="sstep", sstep_powers=powers)
    with pytest.raises(TypeError):
        cgx.solve(dia_c, b, cgx.SolveConfig(**kw))
    with pytest.raises(TypeError, match="bfloat16"):
        cgx_torch.solve(dia, b, SolveConfig(**kw), device="cpu")


def test_fused_sstep_raises_naming_a6():
    """The fused s-step on bfloat16 vectors raised naming ROADMAP A6 until
    kernels B10 had their bfloat16 builds; now solve runs it on them (their
    plain versions here), one Gram and one recover launch a block, each
    counted by its _bf16 build, x bit for bit the fused block's own solve
    on the same Lanczos bounds. Its parity with cgx's interpreted route:
    tests/test_torch_bf16_sstep.py."""
    from cgx_torch.ops import sstep_stream
    from cgx_torch.solver.chebyshev import spectral_bounds

    dia, b, tol = _problem()
    before = {k: BUILD_LAUNCHES[k] for k in ("sstep_gram_bf16", "sstep_recover_bf16")}
    got = cgx_torch.solve(dia, b, SolveConfig(precision="bf16", tolerance=tol, method="sstep",
                                              sstep_powers="fused"), device="cpu")
    blocks = {k: BUILD_LAUNCHES[k] - v for k, v in before.items()}
    assert bool(got.converged) and not bool(got.breakdown) and got.x.dtype == torch.bfloat16
    assert blocks["sstep_gram_bf16"] == blocks["sstep_recover_bf16"] >= int(got.iterations) / 4
    op = cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=torch.bfloat16,
                                       device="cpu")
    direct = sstep_stream.dia_sstep_stream_solve(
        op, torch.as_tensor(b).to(torch.bfloat16), bounds=spectral_bounds(op, b.shape[0]),
        tol=tol, maxiter=MAXITER, device="cpu")
    assert int(direct.iterations) == int(got.iterations) and torch.equal(direct.x, got.x)


def test_multi_rhs_refusal_unchanged():
    cgx, dia_c = _cgx()
    dia, b, tol = _problem()
    big = np.stack([b, 2 * b], axis=1)
    msg = "multi-RHS solves support fp64/fp32, not 'bf16'"
    for multi in ("block", "batched"):
        with pytest.raises(ValueError, match=msg):
            cgx.solve(dia_c, big, cgx.SolveConfig(precision="bf16", multi_rhs=multi))
        with pytest.raises(ValueError, match=msg):
            cgx_torch.solve(dia, big, SolveConfig(precision="bf16", multi_rhs=multi),
                            device="cpu")


def test_solve_sequence_one_device_matches_cgx():
    cgx, dia_c = _cgx()
    dia, b, tol = _problem()
    bs = [b, np.roll(b, GRID)]
    kw = dict(precision="bf16", tolerance=tol, maxiter=MAXITER)
    want = cgx.solve_sequence(dia_c, bs, cgx.SolveConfig(**kw), k=4)
    got = cgx_torch.solve_sequence(dia, bs, SolveConfig(**kw), k=4, device="cpu")
    assert [int(r.iterations) for r in got] == [int(r.iterations) for r in want]
    for g, w in zip(got, want):
        assert g.x.dtype == torch.bfloat16
        assert _rel(_np(g.x), _np(w.x)) <= XTOL


def test_gates_give_bfloat16_to_the_kernels_with_a_build_only():
    """check_operands refuses bfloat16 for a wrapper whose C entries have no
    _bf16 build (B2, B8 outside dia_matvec, B1's dot); the bf16 builds'
    wrappers take it."""
    x = torch.ones(64, dtype=torch.bfloat16)
    bands = torch.ones((3, 64), dtype=torch.bfloat16)
    offsets = (-1, 0, 1)
    assert torch.bfloat16 in vector_dtypes("cgx_dia_matvec", "cgx_dia_matvec_stream")
    assert torch.bfloat16 not in vector_dtypes("cgx_fused_axpby")
    assert torch.bfloat16 not in vector_dtypes("cgx_dia_matvec", "cgx_dia_matvec_dot")
    with pytest.raises(TypeError, match="bfloat16"):
        check_operands("fused_axpby", {"a": x}, dtypes=vector_dtypes("cgx_fused_axpby"))
    with pytest.raises(TypeError, match="bfloat16"):
        axpy.fused_axpby(x, x, x[0], x[0])
    with pytest.raises(TypeError, match="bfloat16"):
        dia_spmv.dia_matvec_stream(bands, x, offsets=offsets, block=128)
    with pytest.raises(TypeError, match="bfloat16"):
        dia_spmv.dia_matvec_dot(bands, x, offsets=offsets)
    y = dia_spmv.dia_matvec(bands, x, offsets=offsets)
    assert y.dtype == torch.bfloat16 and torch.equal(
        y, dia_spmv.dia_matvec_ref(bands, x, offsets=offsets))


# ---------------------------------------------------------------------------
# The mesh and the CLI's --devices: gloo worlds of two ranks
# ---------------------------------------------------------------------------


def _mesh_solve(precision: str):
    dia, b, tol = _problem()
    return cgx_torch.solve(dia, b, SolveConfig(precision=precision, tolerance=tol,
                                               maxiter=MAXITER), mesh=make_mesh(device="cpu"),
                           device="cpu")


def _mesh_sequence(precision: str):
    dia, b, tol = _problem()
    return cgx_torch.solve_sequence(dia, [b, np.roll(b, GRID)],
                                    SolveConfig(precision=precision, tolerance=tol,
                                                maxiter=MAXITER),
                                    k=4, mesh=make_mesh(device="cpu"), device="cpu")


def case_mesh():
    """bf16 and fp32 requests on the mesh: (dtype, k, x) of each."""
    out = {}
    for precision in ("bf16", "fp32"):
        res = _mesh_solve(precision)
        seq = _mesh_sequence(precision)
        out[precision] = {"dtype": str(res.x.dtype), "k": int(res.iterations),
                          "x": res.x.numpy(),
                          "seq": [(str(r.x.dtype), int(r.iterations), r.x.numpy()) for r in seq]}
    return out


def case_cli_devices():
    """The CLI's --devices 2 with --precision bf16: (stderr, stdout)."""
    path = os.path.join(tempfile.mkdtemp(), "o.txt")
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        from cgx_torch.cli import main as ctcli

        rc = ctcli.main(["256", path, "--format", "dia", "--precision", "bf16", "--tol", "1e-2",
                         "--devices", "2", "--device", "cpu"])
    return rc, err.getvalue(), out.getvalue()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_world(str(tmp_path_factory.mktemp("bf16")), 2, __name__,
                     ["case_mesh", "case_cli_devices"])


def test_mesh_runs_bf16_requests_in_float32(two_ranks):
    """cgx's cast (api.py:233-234, :248, :935): a float32 x, bitwise the
    fp32 request's, on every rank, for solve and solve_sequence."""
    for rank in two_ranks:
        got, fp32 = rank["case_mesh"]["bf16"], rank["case_mesh"]["fp32"]
        assert got["dtype"] == fp32["dtype"] == "torch.float32"
        assert got["k"] == fp32["k"]
        assert np.array_equal(got["x"], fp32["x"])
        assert len(got["seq"]) == 2
        for (dt, k, x), (_, k32, x32) in zip(got["seq"], fp32["seq"]):
            assert dt == "torch.float32" and k == k32 and np.array_equal(x, x32)


def test_mesh_matches_one_device_fp32(two_ranks):
    """The mesh's bf16 request is the fp32 solve: k as one device's fp32."""
    dia, b, tol = _problem()
    one = cgx_torch.solve(dia, b, SolveConfig(precision="fp32", tolerance=tol, maxiter=MAXITER),
                          device="cpu")
    assert abs(two_ranks[0]["case_mesh"]["bf16"]["k"] - int(one.iterations)) <= 1


def test_cli_devices_warns_and_runs_fp32(two_ranks):
    rc, err, out = two_ranks[0]["case_cli_devices"]
    assert rc == 0
    assert "warning: sharded mode runs bf16 requests in fp32" in err
    assert STEP.search(out)


@pytest.mark.parametrize("grammar", ["mpi", "cuda_true"])
def test_cli_bf16_matches_cgx(grammar, tmp_path):
    """--precision bf16 in both grammars: the MPI one on cgx's dense
    lap2d_reference(48) (the plain loop), the CUDA one with `true` on
    lap2d_fd(24) (B3's plain version, 1024 x 128 tiles), at 5e-2 ||b||.
    The port's dots are float32 (cgx's CLI from a shell, x64 off); cgx's
    CLI here runs under the tests' x64, with float64 dots, so k is held
    within WINDOW."""
    from cgx.cli import main as climod

    from cgx_torch.cli import main as ctcli

    if grammar == "mpi":
        argv, n = ["48"], GRID
    else:
        mtx = tmp_path / "lap.mtx"
        lap2d_fd_coo_lower(DENSE_GRID).write(mtx)
        argv, n = [str(mtx), "1024", "16", "true"], DENSE_GRID * DENSE_GRID
    tol = 5e-2 * float(np.linalg.norm(source_term(n)))
    opts = ["--precision", "bf16", "--tol", repr(tol)]
    outs = {}
    for name, main in (("cgx", climod.main), ("port", ctcli.main)):
        csv = tmp_path / f"{name}.txt"
        buf = io.StringIO()
        extra = ["--device", "cpu"] if name == "port" else []
        with contextlib.redirect_stdout(buf):
            rc = main(argv + [str(csv)] + opts + extra)
        assert rc == 0
        m = STEP.search(buf.getvalue())
        assert m, buf.getvalue()
        outs[name] = (int(m.group(1)), csv.read_text().strip().split(","))
    (k_c, row_c), (k_p, row_p) = outs["cgx"], outs["port"]
    assert abs(k_p - k_c) <= max(2, WINDOW * k_c)
    assert row_p[:2] == row_c[:2] and float(row_p[2]) > 0
    if grammar == "cuda_true":
        assert BUILD_LAUNCHES["dense_matvec_bf16"] > 0

"""cgx_torch.solve against cgx.solve: routing, devices and what is not
ported yet."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx_torch import SolveConfig
from cgx_torch.ops import axpy, dia_spmv


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


def test_pallas_route_goes_through_the_kernels(problem):
    dia, b = problem
    wrappers = [dia_spmv.dia_matvec, dia_spmv.dia_matvec_dot, axpy.fused_update_rs,
                axpy.fused_axpby]
    cfg = SolveConfig(precision="fp32", tolerance=1e-4 * np.linalg.norm(b), use_pallas=True)
    before = [w.launches for w in wrappers]
    res = cgx_torch.solve(dia, b, cfg, device="cpu")
    moved = [w.launches - c for w, c in zip(wrappers, before)]
    assert moved[0] == 1 and min(moved[1:]) >= int(res.iterations) + 1
    # fp64, x0 and dense operators keep to the reference loop
    before = [w.launches for w in wrappers]
    cgx_torch.solve(dia, b, SolveConfig(use_pallas=True), device="cpu")
    cgx_torch.solve(dia, b, SolveConfig(precision="fp32", use_pallas=True,
                                        tolerance=cfg.tolerance), x0=np.zeros(256), device="cpu")
    cgx_torch.solve(dia.to_dense(), b, cfg, device="cpu")
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize(
    "cfg,kwargs",
    [
        (SolveConfig(precision="bf16"), {}),
        (SolveConfig(precision="mixed"), {}),
        (SolveConfig(precision="tw"), {}),
        (SolveConfig(method="pipelined"), {}),
        (SolveConfig(precond="jacobi"), {}),
        (SolveConfig(precision="fp32", use_pallas=True, precond="neumann"), {}),
        (SolveConfig(), {"n_devices": 4}),
        (SolveConfig(), {"mesh": object()}),
        (SolveConfig(), {"method": "sstep"}),
    ],
    ids=["bf16", "mixed", "tw", "pipelined", "jacobi", "neumann-pallas", "n_devices", "mesh",
         "sstep"],
)
def test_unported_configs_raise(problem, cfg, kwargs):
    dia, b = problem
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgx_torch.solve(dia, b, cfg, device="cpu", **kwargs)


def test_unported_inputs_raise(problem):
    dia, b = problem
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgx_torch.solve(dia, np.stack([b, b], axis=1), device="cpu")
    coo = cgx_torch.mats.generators.lap2d_fd_coo_lower(4)
    for mat in (coo, cgx_torch.CSRMatrix.from_coo(coo), cgx_torch.ELLMatrix.from_coo(coo)):
        with pytest.raises(NotImplementedError, match="ROADMAP A3"):
            cgx_torch.solve(mat, np.ones(16), device="cpu")


def test_default_device_needs_cuda(problem):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    dia, b = problem
    for call in (lambda: cgx_torch.solve(dia, b),
                 lambda: cgx_torch.cg_solve(torch.eye(4), np.ones(4)),
                 lambda: cgx_torch.dia_cg_solve_pallas(None, np.ones(4)),
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

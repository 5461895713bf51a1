"""GridDiaOperator of the port (cgx_torch.solver.operators) against cgx's
(cgx/solver/operators.py:342-431; tests/test_kernels.py:198-251): the
per-axis-shift mat-vec bit for bit the flat one, cg_solve on grid-shaped
vectors on cgx's trajectory, cgx's refusal, the refinement keeping the
class, and solve's routes those of cgx's solve."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx.solver.api as cgx_api
from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
from cgx.solver.operators import GridDiaOperator as CgxGrid
import cgx_torch
import cgx_torch.solver.api as port_api
from cgx_torch.mats.generators import lap2d_fd, lap2d_reference, lap3d_fd, source_term
from cgx_torch.solver import refine as port_refine
from cgx_torch.solver.multigrid import _galerkin_bilinear
from cgx_torch.solver.operators import DiaOperator, GridDiaOperator, as_operator

CASES = {
    "lap2d_fd(32)": lambda: lap2d_fd(32),
    "lap3d_fd(8)": lambda: lap3d_fd(8),
    "galerkin(lap2d_fd(32))": lambda: _galerkin_bilinear(lap2d_fd(32), 32, 2),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_matvec_bitwise_flat(case, dtype):
    dia = CASES[case]()
    flat = as_operator(dia, dtype, device="cpu")
    grid = GridDiaOperator.from_host(dia, dtype, device="cpu")
    assert isinstance(grid, DiaOperator) and grid.bands.dtype == dtype
    assert grid.ndim == (3 if case.startswith("lap3d") else 2)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(dia.shape[0]), dtype=dtype)
    assert torch.equal(grid.matvec(x), flat.matvec(x))
    shape = (grid.g,) * grid.ndim
    assert torch.equal(grid.matvec_grid(x.reshape(shape)).reshape(-1), flat.matvec(x))


@pytest.mark.parametrize("case", list(CASES))
def test_decode_equals_cgx(case):
    dia = CASES[case]()
    ours = GridDiaOperator.from_host(dia, device="cpu")
    theirs = CgxGrid.from_host(dia)
    assert (ours.g, ours.ndim, ours.deltas, ours.offsets) == (
        theirs.g, theirs.ndim, theirs.deltas, tuple(theirs.offsets))
    x = np.random.default_rng(1).standard_normal(dia.shape[0])
    np.testing.assert_array_equal(ours.matvec(torch.as_tensor(x)).numpy(),
                                  np.asarray(theirs.matvec(jnp.asarray(x))))


def test_refuses_a_wrapping_stencil():
    dia = lap2d_reference(256)
    with pytest.raises(ValueError) as ours:
        GridDiaOperator.from_host(dia, device="cpu")
    with pytest.raises(ValueError) as theirs:
        CgxGrid.from_host(cgx.lap2d_reference(256))
    assert str(ours.value) == str(theirs.value) and "wrap" in str(ours.value)
    assert type(as_operator(dia, device="cpu")) is DiaOperator
    assert type(as_operator(lap2d_fd(32), device="cpu")) is DiaOperator  # still flat
    with pytest.raises(ValueError, match="do not decode"):
        GridDiaOperator.from_host(cgx_torch.DIAMatrix((30, 30), (0, 1), np.ones((2, 30))),
                                  device="cpu")


@pytest.mark.parametrize("problem,tol", [("lap2d_fd(32)", 1e-6), ("lap3d_fd(10)", 1e-8),
                                         ("lap2d_fd(48)", 1e-10)])
def test_cg_solve_equals_cgx(problem, tol):
    """Grid-shaped vectors through the loop, as cgx's: equal k, x within
    1e-13 of cgx's GridDiaOperator run (lap2d_fd(32) at 1e-6 is the pinned
    golden 119)."""
    make = {"lap2d_fd(32)": lambda m: m.lap2d_fd(32), "lap3d_fd(10)": lambda m: m.lap3d_fd(10),
            "lap2d_fd(48)": lambda m: m.lap2d_fd(48)}[problem]
    dia = make(cgx_torch)
    b = source_term(dia.shape[0])
    seen = []
    op = GridDiaOperator.from_host(dia, device="cpu")
    real = op.matvec_grid
    op = dataclasses.replace(op)
    object.__setattr__(op, "matvec_grid", lambda v: (seen.append(tuple(v.shape)), real(v))[1])
    ours = cgx_torch.cg_solve(op, b, tol=tol, history=8, device="cpu")
    theirs = cgx.cg_solve(CgxGrid.from_host(make(cgx)), jnp.asarray(b), tol=tol, history=8)
    assert seen and all(s == (op.g,) * op.ndim for s in seen)
    assert int(ours.iterations) == int(theirs.iterations)
    if problem == "lap2d_fd(32)":
        assert int(ours.iterations) == 119
    assert ours.x.shape == (dia.shape[0],)
    x_ref = np.asarray(theirs.x)
    assert np.max(np.abs(ours.x.numpy() - x_ref)) <= 1e-13 * np.max(np.abs(x_ref))
    np.testing.assert_allclose(ours.history.numpy(), np.asarray(theirs.history), rtol=1e-12)


@pytest.mark.parametrize("precond", [None, "identity"])
def test_grid_loop_only_without_preconditioner(precond):
    """Without a preconditioner the loop calls the grid mat-vec on (g, g)
    vectors and never the flat entry; with one it runs the flat loop
    through ``matvec``, as cgx's does."""
    dia = lap2d_fd(16)
    op = dataclasses.replace(GridDiaOperator.from_host(dia, device="cpu"))
    flat_calls = []
    real = op.matvec
    op.matvec = lambda v: (flat_calls.append(tuple(v.shape)), real(v))[1]
    pc = None if precond is None else (lambda r: r)
    res = cgx_torch.cg_solve(op, source_term(256), tol=1e-8, precond=pc, device="cpu")
    assert bool(res.converged) and res.x.shape == (256,)
    if precond is None:
        assert flat_calls == []
    else:
        assert flat_calls and set(flat_calls) == {(256,)}


def test_refinement_keeps_the_class(monkeypatch):
    """iterative_refinement lowers a GridDiaOperator's bands and keeps its
    class (cgx refine.py:83-86); its sweeps are cgx's, the float32 inner
    counts within a tenth (their dots' summation order, at float32's
    floor)."""
    dia = lap2d_fd(32)
    b = source_term(1024)
    inner = []
    real = port_refine.cg_solve
    monkeypatch.setattr(port_refine, "cg_solve",
                        lambda op, *a, **k: (inner.append(op), real(op, *a, **k))[1])
    ours = port_refine.iterative_refinement(GridDiaOperator.from_host(dia, device="cpu"), b,
                                            rtol=1e-11, device="cpu")
    assert inner and all(type(op) is GridDiaOperator and op.bands.dtype == torch.float32
                         and (op.g, op.ndim) == (32, 2) for op in inner)
    from cgx.solver.refine import iterative_refinement as cgx_refinement

    theirs = cgx_refinement(CgxGrid.from_host(cgx_lap2d_fd(32)), jnp.asarray(b), rtol=1e-11)
    assert ours.outer_iterations == theirs.outer_iterations
    got, want = ours.inner_iterations.numpy(), np.asarray(theirs.inner_iterations)
    assert np.all(np.abs(got - want) <= 0.1 * want), (got, want)
    assert bool(ours.converged) and bool(theirs.converged)
    x = ours.x.numpy()
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


class _Route(Exception):
    pass


def _spy(name):
    def spy(op, *args, **kwargs):
        raise _Route(name, type(op).__name__)
    return spy


CONFIGS = {
    "fp64": dict(),
    "fp32": dict(precision="fp32"),
    "fp64_pipelined": dict(method="pipelined"),
    "fp64_jacobi": dict(precond="jacobi"),
    "fp32_pallas": dict(precision="fp32", use_pallas=True),
    "fp32_pallas_neumann": dict(precision="fp32", use_pallas=True, precond="neumann"),
}
PORT_ROUTES = ("cg_solve", "pipelined_cg_solve", "dia_cg_solve_vmem", "dia_cg_solve_stream",
               "dia_cg_solve_stream_pcg", "gv_cg_solve")


def _port_route(cfg, monkeypatch):
    for name in PORT_ROUTES:
        monkeypatch.setattr(port_api, name, _spy(name))
    op = GridDiaOperator.from_host(lap2d_fd(32), device="cpu")
    with pytest.raises(_Route) as r:
        cgx_torch.solve(op, source_term(1024), cgx_torch.SolveConfig(**cfg), device="cpu")
    return r.value.args


def _cgx_route(cfg, monkeypatch):
    import cgx.ops.cg_kernel as cgx_ck
    import cgx.ops.cg_stream as cgx_cs
    import cgx.solver.pipelined as cgx_pp

    monkeypatch.setattr(cgx_api, "cg_solve", _spy("cg_solve"))
    monkeypatch.setattr(cgx_pp, "pipelined_cg_solve", _spy("pipelined_cg_solve"))
    monkeypatch.setattr(cgx_ck, "dia_cg_solve_vmem", _spy("dia_cg_solve_vmem"))
    monkeypatch.setattr(cgx_cs, "dia_cg_solve_stream", _spy("dia_cg_solve_stream"))
    monkeypatch.setattr(cgx_cs, "dia_cg_solve_stream_pcg", _spy("dia_cg_solve_stream_pcg"))
    op = CgxGrid.from_host(cgx_lap2d_fd(32))
    with pytest.raises(_Route) as r:
        cgx.solve(op, source_term(1024), cgx.SolveConfig(**cfg))
    return r.value.args


@pytest.mark.parametrize("config", list(CONFIGS))
def test_solve_routes_as_cgx(config, monkeypatch):
    ours = _port_route(CONFIGS[config], monkeypatch)
    theirs = _cgx_route(CONFIGS[config], monkeypatch)
    assert ours == theirs
    assert ours[1] == "GridDiaOperator"

"""cgx_torch's mixed-precision refinement (fp32 inner solves, fp64
sweeps) against cgx's, with x64 on and cgx's kernel in interpret mode."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd, source_term
from cgx.solver.refine import iterative_refinement as cgx_iterative
from cgx.solver.refine import refine_fixed_sweeps as cgx_fixed
from cgx_torch import SolveConfig, config
from cgx_torch.ops import cg_kernel, cg_stream
from cgx_torch.ops._util import BF16_BANDS_SUFFIX, BUILD_LAUNCHES

G = 24
N = G * G


@pytest.fixture(scope="module")
def problem():
    dia = lap2d_fd(G)
    b = source_term(N)
    return dia, b, cgx.DiaOperator.from_host(dia), cgx_torch.as_operator(cgx_torch.lap2d_fd(G),
                                                                          device="cpu")


def _true_rel(dia, x, b):
    return np.linalg.norm(dia.mat_vec(np.asarray(x, np.float64)) - b) / np.linalg.norm(b)


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_refine_fixed_sweeps_matches_cgx(problem, layout):
    dia, b, cgx_op, op = problem
    want = cgx_fixed(cgx_op, jnp.asarray(b), sweeps=4, chunk=128, interpret=True, layout=layout,
                     cols=128)
    before = cg_kernel.dia_cg_chunk.launches[layout]
    got = cgx_torch.refine_fixed_sweeps(op, b, sweeps=4, chunk=128, layout=layout, cols=128,
                                        device="cpu")
    assert cg_kernel.dia_cg_chunk.launches[layout] > before  # the inner solves ran B5
    assert bool(got.converged) and 1 <= got.outer_iterations <= 4
    assert _true_rel(dia, got.x.numpy(), b) < 1e-11
    assert got.x.dtype == torch.float64 and got.inner_iterations.shape == (got.outer_iterations,)
    _close(got.x, want.x)


def test_iterative_refinement_matches_cgx(problem):
    dia, b, cgx_op, op = problem
    want = cgx_iterative(cgx_op, jnp.asarray(b), tol=0.0, rtol=1e-11)
    got = cgx_torch.iterative_refinement(op, b, tol=0.0, rtol=1e-11, device="cpu")
    assert bool(got.converged) and got.outer_iterations <= 4
    assert got.outer_iterations == want.outer_iterations
    assert np.abs(got.inner_iterations.numpy() - np.asarray(want.inner_iterations)).max() <= 1
    assert _true_rel(dia, got.x.numpy(), b) < 1e-11
    _close(got.x, want.x)


def test_iterative_refinement_dense_and_other_inners(problem):
    """A dense fp64 operator refines through a dense fp32 inner; any other
    operator through a low-precision view of itself (cgx refine.py:81-95)."""
    dia, b, _, op = problem
    dense = cgx_torch.DenseOperator(torch.as_tensor(dia.to_dense()))
    other = types.SimpleNamespace(matvec=op.matvec)
    for a in (dense, other):
        res = cgx_torch.iterative_refinement(a, b, tol=0.0, rtol=1e-11, device="cpu")
        assert bool(res.converged) and _true_rel(dia, res.x.numpy(), b) < 1e-11


@pytest.mark.parametrize("inner", ["resident", "bf16_bands", "stream_pcg"])
def test_iterative_refinement_pallas_routes_by_budget(problem, monkeypatch, inner):
    """use_pallas routes the inner solve by the budget as cgx does
    (refine.py:142-156): B5 with its Neumann preconditioner while the
    fp32 state fits, B5 with bfloat16 bands while that fits, then the
    streaming Neumann-PCG kernel B6. Each inner runs, and the solve
    reaches cgx's relative residual within one sweep of cgx's count."""
    import cgx.config as cgx_config

    dia, b, cgx_op, op = problem
    fp32 = cg_kernel.resident_state_bytes(5, N, 4, 4, precond=True)
    bf16 = cg_kernel.resident_state_bytes(5, N, 2, 4, precond=True)
    budget = {"resident": fp32, "bf16_bands": bf16, "stream_pcg": bf16 - 1}[inner]
    monkeypatch.setattr(config, "RESIDENT_BUDGET_BYTES", budget)
    def counts():
        chunk = cg_kernel.dia_cg_chunk
        return (chunk.launches["2d"], BUILD_LAUNCHES["dia_cg_vmem2d" + BF16_BANDS_SUFFIX],
                cg_stream._stream_iteration_pcg.launches)

    before = counts()
    res = cgx_torch.iterative_refinement(op, b, tol=0.0, rtol=1e-11, use_pallas=True,
                                         device="cpu")
    ran = [a > b_ for a, b_ in zip(counts(), before)]
    assert ran == {"resident": [True, False, False], "bf16_bands": [True, True, False],
                   "stream_pcg": [False, False, True]}[inner]
    assert bool(res.converged) and _true_rel(dia, res.x.numpy(), b) < 1e-11
    # cgx's own route to the same inner: its budget set just as far
    if inner != "resident":
        from cgx.ops.cg_kernel import vmem2d_scoped_bytes

        cgx_bf16 = vmem2d_scoped_bytes(5, N, 2, 4, precond=True)
        monkeypatch.setattr(cgx_config, "VMEM_BUDGET_BYTES",
                            cgx_bf16 if inner == "bf16_bands" else cgx_bf16 - 1)
    want = cgx_iterative(cgx_op, jnp.asarray(b), tol=0.0, rtol=1e-11, use_pallas=True,
                         interpret=True)
    assert bool(want.converged)
    assert abs(res.outer_iterations - want.outer_iterations) <= 1


def test_solve_mixed_matches_cgx(problem):
    dia, b, _, _ = problem
    cfg = dict(precision="mixed", tolerance=1e-11)
    want = cgx.solve(dia, b, cgx.SolveConfig(**cfg))
    before = cg_kernel.dia_cg_chunk.launches["2d"]
    got = cgx_torch.solve(cgx_torch.lap2d_fd(G), b, SolveConfig(**cfg), device="cpu")
    assert cg_kernel.dia_cg_chunk.launches["2d"] > before  # refine_fixed_sweeps, layout 2d
    assert bool(got.converged) and 1 <= int(got.iterations) <= 4
    assert got.iterations.dtype == torch.int32 and got.x.dtype == torch.float64
    assert _true_rel(dia, got.x.numpy(), b) < 1e-11
    assert float(got.rsold) == pytest.approx(float(got.residual_norm) ** 2)
    _close(got.x, want.x)


def test_solve_mixed_above_the_budget_refines_with_the_plain_inner(problem, monkeypatch):
    """Above the budget mixed runs iterative_refinement; on the CPU its
    inner is the plain fp32 loop, as cgx's is there."""
    dia, b, _, _ = problem
    monkeypatch.setattr(config, "RESIDENT_BUDGET_BYTES", 0)
    before = dict(cg_kernel.dia_cg_chunk.launches)
    got = cgx_torch.solve(cgx_torch.lap2d_fd(G), b, SolveConfig(precision="mixed",
                                                                tolerance=1e-11), device="cpu")
    assert cg_kernel.dia_cg_chunk.launches == before
    assert bool(got.converged) and _true_rel(dia, got.x.numpy(), b) < 1e-11


@pytest.mark.parametrize("kind", ["precond", "dense", "x0"])
def test_solve_mixed_rejects_what_cgx_rejects(problem, kind):
    dia, b, _, _ = problem
    cfg, port_cfg = cgx.SolveConfig(precision="mixed"), SolveConfig(precision="mixed")
    cgx_mat, port_mat, kw, port_kw = dia, cgx_torch.lap2d_fd(G), {}, {}
    if kind == "precond":
        cfg = cgx.SolveConfig(precision="mixed", precond="jacobi")
        port_cfg = SolveConfig(precision="mixed", precond="jacobi")
    elif kind == "dense":
        cgx_mat, port_mat = cgx.DenseMatrix(dia.to_dense()), cgx_torch.DenseMatrix(dia.to_dense())
    else:
        kw = port_kw = {"x0": np.zeros(N)}
    with pytest.raises(Exception) as want:
        cgx.solve(cgx_mat, b, cfg, **kw)
    with pytest.raises(want.type):
        cgx_torch.solve(port_mat, b, port_cfg, device="cpu", **port_kw)

"""The port's sharded triple-word refinement (cgx_torch.parallel.tw_sharded)
against cgx's (cgx/parallel/tw_sharded.py) and the port's single-device
refine_pcg_sweeps_tw, on the CPU: gloo worlds of 2 and 4 ranks (the
harness of test_torch_sharded.py, one spawn a world), cgx on make_mesh(P).
The pins are cgx's tests/test_tw_sharded.py:50-200: inner_dot="gathered"
bitwise the single-device solve; "psum" with cgx's sweeps and gate; the
MG-PCG inner; the halo triple-word product bitwise the single-device one;
the off-grid split bands; solve(precision="tw", mesh=).

No jax or cgx import at the top: the spawned ranks import this module.
"""

import functools

import numpy as np
import pytest
import torch

import cgx_torch
from cgx_torch.config import SolveConfig
from cgx_torch.mats.containers import DIAMatrix
from cgx_torch.mats.generators import lap2d_fd_coo_lower, poisson2d_var, source_term
from cgx_torch.ops import tw32
from cgx_torch.parallel import make_mesh
from cgx_torch.parallel.tw_sharded import _tw_halo_matvec, sharded_tw_solve
from cgx_torch.solver.operators import DiaOperator
from cgx_torch.solver.refine import refine_pcg_sweeps_tw
from cgx_torch.utils import collectives
from test_torch_sharded import run_world

WORLDS = [2, 4]
G = 32


def problem():
    mat = DIAMatrix.from_coo(lap2d_fd_coo_lower(G))
    return mat, np.random.default_rng(0).standard_normal(G * G)


def offgrid():
    cells = 8
    board = np.where((np.indices((cells, cells)).sum(axis=0) % 2).astype(bool), 8.0, 1.0)
    mat = poisson2d_var(G, np.kron(board, np.ones((G // cells, G // cells))))
    return mat, np.asarray(source_term(G * G), np.float64)


def _np(res):
    return {"k": res.outer_iterations, "words": [w.numpy() for w in res.x_words],
            "res": res.residual_norm.numpy(), "converged": bool(res.converged),
            "inner": int(res.inner_iterations[0])}


def case_results():
    mesh = make_mesh(device="cpu")
    mat, b = problem()
    out = {
        "gathered": _np(sharded_tw_solve(mat, b, mesh=mesh, rtol=1e-12, inner_maxiter=200,
                                         precond=None, inner_dot="gathered")),
        "psum": _np(sharded_tw_solve(mat, b, mesh=mesh, rtol=1e-12, inner_maxiter=200,
                                     precond=None)),
        "mg": _np(sharded_tw_solve(mat, b, mesh=mesh, rtol=1e-12, inner_maxiter=80,
                                   precond="mg")),
        "offgrid": _np(sharded_tw_solve(*offgrid(), mesh=mesh, rtol=1e-12, inner_maxiter=2000,
                                        precond=None)),
    }
    res = cgx_torch.solve(mat, b, SolveConfig(precision="tw", precond="mg", tolerance=1e-12),
                          mesh=mesh, device="cpu")
    out["api"] = {"k": int(res.iterations), "x": res.x.numpy(), "converged": bool(res.converged)}
    # the halo product on the rank's rows, gathered
    n_loc, lo = G * G // mesh.size, mesh.rank * G * G // mesh.size
    x64 = torch.tensor(np.random.default_rng(1).standard_normal(G * G))
    words = tw32.tw_from_f64(x64[lo: lo + n_loc])
    bands = torch.tensor(mat.bands[:, lo: lo + n_loc], dtype=torch.float32)
    y = _tw_halo_matvec(bands, tuple(mat.offsets), words, mesh)
    out["halo_matvec"] = [collectives.all_gather(w, mesh).numpy() for w in y]
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"tw{world}")), world, __name__,
                          ["case_results"])
        for other in ranks[1:]:  # every rank returns the whole solution
            for name in ("gathered", "psum", "mg"):
                for w_other, w0 in zip(other["case_results"][name]["words"],
                                       ranks[0]["case_results"][name]["words"]):
                    np.testing.assert_array_equal(w_other, w0)
        return ranks[0]["case_results"]

    return run


@functools.lru_cache(maxsize=None)
def single(name: str):
    """The port's single-device refine_pcg_sweeps_tw (plain fp32 CG inner)."""
    mat, b = problem() if name == "lap" else offgrid()
    op64 = DiaOperator(torch.tensor(mat.bands, dtype=torch.float64), tuple(mat.offsets))
    res = refine_pcg_sweeps_tw(op64, torch.tensor(b), precond=None, rtol=1e-12,
                               inner_maxiter=200 if name == "lap" else 2000, device="cpu")
    return _np(res)


@functools.lru_cache(maxsize=None)
def cgx_tw(p: int, precond):
    from cgx.mats.containers import DIAMatrix as CgxDia
    from cgx.mats.generators import lap2d_fd_coo_lower as cgx_coo
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.tw_sharded import sharded_tw_solve as cgx_solve

    _mat, b = problem()
    res = cgx_solve(CgxDia.from_coo(cgx_coo(G)), b, mesh=cgx_mesh(p), rtol=1e-12,
                    inner_maxiter=200 if precond is None else 80, precond=precond)
    return {"k": res.outer_iterations, "converged": bool(res.converged)}


def true_rel(mat, x, b):
    return np.linalg.norm(mat.mat_vec(np.asarray(x, np.float64)) - b) / np.linalg.norm(b)


def _x(words):
    return tw32.tw_to_f64(tuple(torch.tensor(w) for w in words)).numpy()


@pytest.mark.parametrize("world", WORLDS)
def test_gathered_is_bitwise_the_single_device_solve(port, world):
    """inner_dot="gathered": every reduction in the single-device order, so
    the sweeps, all three words and the residual norm are bitwise those of
    refine_pcg_sweeps_tw on one device."""
    got, want = port(world)["gathered"], single("lap")
    assert got["k"] == want["k"]
    for w_got, w_want in zip(got["words"], want["words"]):
        np.testing.assert_array_equal(w_got, w_want)
    np.testing.assert_array_equal(got["res"], want["res"])


@pytest.mark.parametrize("world", WORLDS)
def test_psum_inner_certifies_the_same_gate(port, world):
    """inner_dot="psum" (local dots, one all-reduce): cgx's sweeps, the
    single-device solution far below the fp64 floor, the 1e-12 gate."""
    got = port(world)["psum"]
    assert got["converged"] and got["k"] == cgx_tw(world, None)["k"] == single("lap")["k"]
    x, x_ref = _x(got["words"]), _x(single("lap")["words"])
    assert np.max(np.abs(x - x_ref)) <= 1e-13 * np.max(np.abs(x_ref))
    mat, b = problem()
    assert true_rel(mat, x, b) < 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_mg_inner(port, world):
    """The sharded MG-PCG inner: cgx's sweeps, the gate, and far fewer
    inner iterations than plain CG's."""
    got = port(world)["mg"]
    assert got["converged"] and got["k"] == cgx_tw(world, "mg")["k"]
    assert got["inner"] < 200
    mat, b = problem()
    assert true_rel(mat, _x(got["words"]), b) < 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_halo_matvec_is_bitwise_the_single_device_product(port, world):
    mat, _b = problem()
    x_tw = tw32.tw_from_f64(torch.tensor(np.random.default_rng(1).standard_normal(G * G)))
    want = tw32.banded_matvec_tw(torch.tensor(mat.bands, dtype=torch.float32),
                                 tuple(mat.offsets), x_tw)
    for got, w in zip(port(world)["halo_matvec"], want):
        np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_offgrid_split_bands(port, world):
    """poisson2d_var's bands do not round-trip float32: the outer carries
    their exact 3-word split, follows the single-device trajectory and
    certifies the true fp64 operator."""
    mat, b = offgrid()
    assert not tw32.bands_f32_exact(mat.bands)
    got, want = port(world)["offgrid"], single("offgrid")
    assert got["converged"] and got["k"] == want["k"]
    assert true_rel(mat, _x(got["words"]), b) < 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_solve_precision_tw_on_a_mesh(port, world):
    """solve(precision="tw", precond="mg", mesh=) runs the sharded sweeps."""
    got = port(world)["api"]
    assert got["converged"] and got["k"] == port(world)["mg"]["k"]
    mat, b = problem()
    assert true_rel(mat, got["x"], b) < 1e-12

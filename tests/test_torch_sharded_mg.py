"""The port's sharded MG-PCG (cgx_torch.parallel.mg_sharded) against cgx's
(cgx/parallel/mg_sharded.py) on the CPU: gloo worlds of 2 and 4 ranks (the
harness of test_torch_sharded.py, one spawn a world), cgx on make_mesh(P).
The pins are cgx's tests/test_mg_sharded.py:19-170 and :220-280 (the block
solves are the multi-RHS half of ROADMAP A14): k equal to cgx's, in fp64
and with the fp32 cycle, for both smoothers; a 3-D grid; a float32 b; the
geometry and cycle-precision errors; solve(precond="mg", mesh=).

No jax or cgx import at the top: the spawned ranks import this module.
"""

import functools

import numpy as np
import pytest
import torch

import cgx_torch
from cgx_torch.config import SolveConfig
from cgx_torch.mats.generators import lap2d_fd, lap3d_fd, source_term
from cgx_torch.parallel import make_mesh, sharded_mg_cg_solve
from cgx_torch.parallel.mg_sharded import _ShardedVCycle
from cgx_torch.solver.multigrid import MGPreconditioner
from test_torch_sharded import run_world

WORLDS = [2, 4]
G = 64
G3 = 24  # 24^3 rows: one sharded level on 2 and 4 ranks, then a 1,728-row tail
VARIANTS = [("richardson", "fp64"), ("richardson", "fp32"), ("gs", "fp64"), ("gs", "fp32")]


def _np(res):
    return {"k": int(res.iterations), "x": res.x.cpu().numpy(), "converged": bool(res.converged),
            "breakdown": bool(res.breakdown)}


def case_results():
    mesh = make_mesh(device="cpu")
    out = {f"{sm}_{cp}": _np(sharded_mg_cg_solve(lap2d_fd(G), source_term(G * G), mesh=mesh,
                                                 tol=1e-8, smoother=sm, cycle_precision=cp))
           for sm, cp in VARIANTS}
    out["3d"] = _np(sharded_mg_cg_solve(lap3d_fd(G3), source_term(G3 ** 3), mesh=mesh, ndim=3,
                                        tol=1e-8))
    out["f32"] = _np(sharded_mg_cg_solve(lap2d_fd(G), source_term(G * G).astype(np.float32),
                                         mesh=mesh, tol=1e-5))
    out["api"] = _np(cgx_torch.solve(lap2d_fd(G), source_term(G * G),
                                     SolveConfig(precision="fp64", precond="mg", tolerance=1e-8,
                                                 mg_smoother="gs"), mesh=mesh, device="cpu"))
    # the bilinear pair on the rank's rows (gathered) against one device's
    rng = np.random.default_rng(3)
    f, e = rng.standard_normal(G * G), rng.standard_normal((G // 2) ** 2)
    vc = _ShardedVCycle(mesh, (G,), [(torch.ones((1, G * G // mesh.size), dtype=torch.float64),
                                      (0,), 1.0)], torch.eye(1, dtype=torch.float64), pre=1,
                        post=1, overcorrection=1.0, transfer="bilinear", ndim=2,
                        smoother="richardson", smooth=None, mixed=False)
    n_loc, nc_loc = G * G // mesh.size, (G // 2) ** 2 // mesh.size
    r = vc._restrict_bilinear(torch.tensor(f[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]), 0)
    p = vc._prolong_bilinear(torch.tensor(e[mesh.rank * nc_loc:(mesh.rank + 1) * nc_loc]), 0)
    from cgx_torch.utils import collectives

    out["restrict"] = collectives.all_gather(r, mesh).numpy()
    out["prolong"] = collectives.all_gather(p, mesh).numpy()
    errors = {}
    for name, call in {
        "geometry": lambda: sharded_mg_cg_solve(lap2d_fd(66), source_term(66 * 66), mesh=mesh)
        if mesh.size == 4 else sharded_mg_cg_solve(lap2d_fd(65), source_term(65 * 65),
                                                   mesh=mesh),
        "cycle": lambda: sharded_mg_cg_solve(lap2d_fd(G), source_term(G * G), mesh=mesh,
                                             cycle_precision="bf16"),
        "smoother": lambda: sharded_mg_cg_solve(lap2d_fd(G), source_term(G * G), mesh=mesh,
                                                smoother="sor"),
    }.items():
        try:
            call()
            errors[name] = None
        except ValueError as err:
            errors[name] = str(err)
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"mg{world}")), world, __name__,
                          ["case_results"])
        for other in ranks[1:]:  # every rank returns the whole x
            for name, res in other["case_results"].items():
                if isinstance(res, dict) and "x" in res:
                    np.testing.assert_array_equal(res["x"], ranks[0]["case_results"][name]["x"])
        return ranks[0]["case_results"]

    return run


@functools.lru_cache(maxsize=None)
def cgx_mg(p: int, name: str):
    from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
    from cgx.mats.generators import lap3d_fd as cgx_lap3d_fd
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.mg_sharded import sharded_mg_cg_solve as cgx_solve

    mesh = cgx_mesh(p)
    if name == "3d":
        res = cgx_solve(cgx_lap3d_fd(G3), source_term(G3 ** 3), mesh=mesh, ndim=3, tol=1e-8)
    elif name == "f32":
        res = cgx_solve(cgx_lap2d_fd(G), source_term(G * G).astype(np.float32), mesh=mesh,
                        tol=1e-5)
    else:
        sm, cp = name.split("_")
        res = cgx_solve(cgx_lap2d_fd(G), source_term(G * G), mesh=mesh, tol=1e-8, smoother=sm,
                        cycle_precision=cp)
    return {"k": int(res.iterations), "x": np.asarray(res.x)}


def true_rel(mat, x, b):
    return np.linalg.norm(mat.mat_vec(np.asarray(x, np.float64)) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", [f"{sm}_{cp}" for sm, cp in VARIANTS])
def test_mg_matches_cgx(port, world, variant):
    """cgx's k on make_mesh(P) for both smoothers, with the fp64 and the
    fp32 cycle; x within 1e-9 of cgx's; the true residual below 1e-9."""
    got, want = port(world)[variant], cgx_mg(world, variant)
    assert got["converged"] and not got["breakdown"]
    assert got["k"] == want["k"]
    assert np.max(np.abs(got["x"] - want["x"])) <= 1e-9 * np.max(np.abs(want["x"]))
    assert true_rel(lap2d_fd(G), got["x"], source_term(G * G)) < 1e-9


@pytest.mark.parametrize("world", WORLDS)
def test_mg_3d_matches_cgx(port, world):
    """A 3-D grid (trilinear transfers, a plane of halo a level)."""
    got, want = port(world)["3d"], cgx_mg(world, "3d")
    assert got["converged"] and got["k"] == want["k"]
    assert true_rel(lap3d_fd(G3), got["x"], source_term(G3 ** 3)) < 1e-9


@pytest.mark.parametrize("world", WORLDS)
def test_mg_float32_b(port, world):
    """A float32 b solves in float32 (a float32 hierarchy), in cgx's k."""
    got, want = port(world)["f32"], cgx_mg(world, "f32")
    assert got["x"].dtype == np.float32 and got["converged"]
    assert got["k"] == want["k"]
    b = source_term(G * G).astype(np.float32)
    assert true_rel(lap2d_fd(G), got["x"], b) < 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_solve_precond_mg_on_a_mesh(port, world):
    """solve(precond="mg", mesh=) runs sharded_mg_cg_solve with the
    configuration's smoother: cgx's gs count, and the same x."""
    got, direct = port(world)["api"], port(world)["gs_fp64"]
    assert got["converged"] and got["k"] == cgx_mg(world, "gs_fp64")["k"]
    np.testing.assert_array_equal(got["x"], direct["x"])


@pytest.mark.parametrize("world", WORLDS)
def test_bilinear_transfers_match_single_device(port, world):
    """The halo'd bilinear restrict and prolong on the ranks' rows equal
    one device's on the whole grid (tests/test_mg_sharded.py:61-99)."""
    rng = np.random.default_rng(3)
    f, e = rng.standard_normal(G * G), rng.standard_normal((G // 2) ** 2)
    want_r = MGPreconditioner._restrict_bilinear(torch.tensor(f), G).numpy()
    want_p = MGPreconditioner._prolong_bilinear(torch.tensor(e), G // 2).numpy()
    np.testing.assert_allclose(port(world)["restrict"], want_r, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(port(world)["prolong"], want_p, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,match", [("geometry", "divide"), ("cycle", "cycle_precision"),
                                        ("smoother", "unknown smoother")])
def test_mg_errors(port, world, name, match):
    msg = port(world)["errors"][name]
    assert msg is not None and match in msg

"""The port's 2-D (rows x rhs) batched CG (cgx_torch.parallel.batched2d)
against cgx's (cgx/parallel/batched2d.py) on the CPU: cgx's
tests/test_batched2d.py at its sizes, on meshes of (2 x 2) and (4 x 1)
ranks (one gloo world of 4, both meshes made in it; the harness of
test_torch_sharded.py) and (1 x 1) without a process group, cgx on
make_mesh2d of the same shape. The pins: each column's k equal to cgx's,
fp64 X within 1e-10 of cgx's relative to max |X|, every rank's result
bitwise equal to rank 0's; the frozen-column, budget and breakdown
semantics as cgx's tests state them. The collectives an iteration are
pinned in test_torch_collective_counts.py.

No jax or cgx import at the top: the spawned ranks import this module.
"""

import functools

import numpy as np
import pytest
import torch.distributed as dist

from cgx_torch.mats.containers import DIAMatrix
from cgx_torch.mats.generators import lap2d_reference, source_term
from cgx_torch.parallel import make_mesh2d, sharded_cg_solve_batched
from test_torch_sharded import assert_x, run_world

SHAPES = {"2x2": (2, 2), "4x1": (4, 1), "1x1": (1, 1)}


def _indefinite():
    bands = np.zeros((1, 512))
    bands[0, :256] = 1.0
    bands[0, 256:] = -1.0  # an indefinite diagonal matrix
    return DIAMatrix((512, 512), (0,), bands)


def problem(name: str):
    """(matrix, B (nrhs, n), options) of each of cgx's cases."""
    b512 = source_term(512)
    if name == "matches":
        return lap2d_reference(512), np.random.default_rng(0).standard_normal((6, 512)), {
            "tol": 1e-8}
    if name == "uneven":
        b0 = source_term(509)
        return lap2d_reference(509), np.stack([b0, 2.0 * b0, np.zeros_like(b0)]), {"tol": 1e-6}
    if name == "breakdown":
        return _indefinite(), np.ones((2, 512)), {"maxiter": 4}
    if name == "budget":
        return lap2d_reference(512), np.stack([b512, b512]), {
            "tol": 1e-12 * np.linalg.norm(b512), "maxiter": 30}
    if name == "wide":
        b0 = source_term(16)
        return lap2d_reference(16), np.stack([b0, -b0]), {"tol": 1e-6}
    if name == "jacobi":
        return lap2d_reference(256), np.stack([source_term(256)] * 3), {"tol": 1e-8,
                                                                         "precond": "jacobi"}
    if name == "gv_tol":
        return lap2d_reference(1024), np.stack([source_term(1024)]), {"tol": 1e-10,
                                                                       "method": "gvpipe"}
    if name.startswith("zero_"):
        b0 = source_term(256)
        return lap2d_reference(256), np.stack([b0, np.zeros_like(b0)]), {
            "tol": 1e-8, "method": name[len("zero_"):]}
    # "<method>" or "<method>_neumann" on four random columns (tests/test_batched2d.py:99-180)
    method, _, pc = name.partition("_")
    kw = {"tol": 1e-8, "method": method}
    if pc:
        kw["precond"] = "neumann"
    return lap2d_reference(512), np.random.default_rng(2).standard_normal((4, 512)), kw


NAMES = ["matches", "uneven", "breakdown", "budget", "wide", "jacobi", "gv_tol", "zero_pipelined",
         "zero_gvpipe", "reference", "reference_neumann", "pipelined", "pipelined_neumann",
         "gvpipe", "gvpipe_neumann"]
# compared with cgx's X and k (every method, both preconditioners, the
# padding); the others are held to cgx's tests' statements
AGAINST_CGX = ["matches", "uneven", "jacobi", "pipelined", "gvpipe_neumann"]


def _solve(shape, name):
    mat, bb, kw = problem(name)
    mesh = make_mesh2d(*shape, device="cpu")
    x, k, res, conv, brk = sharded_cg_solve_batched(mat, bb, mesh=mesh, **kw)
    return {"x": x.numpy(), "k": k.numpy(), "res": res.numpy(), "conv": conv.numpy(),
            "brk": brk.numpy()}


def case_results():
    world = dist.get_world_size() if dist.is_initialized() else 1
    shapes = ["2x2", "4x1"] if world == 4 else ["1x1"]
    return {shape: {name: _solve(SHAPES[shape], name) for name in NAMES} for shape in shapes}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"b2d{world}")), world, __name__,
                          ["case_results"])
        for other in ranks[1:]:  # every rank returns the whole X, bit for bit
            for shape, cases in other["case_results"].items():
                for name, rec in cases.items():
                    for key in rec:
                        np.testing.assert_array_equal(
                            rec[key], ranks[0]["case_results"][shape][name][key])
        return ranks[0]

    return run


def _port(port, shape):
    return port("none" if shape == "1x1" else 4)


@functools.lru_cache(maxsize=None)
def cgx_batched(shape: str, name: str):
    import cgx
    from cgx.mats.containers import DIAMatrix as CgxDia
    from cgx.parallel.batched2d import make_mesh2d as cgx_mesh2d
    from cgx.parallel.batched2d import sharded_cg_solve_batched as cgx_solve

    mat, bb, kw = problem(name)
    mat = CgxDia(mat.shape, tuple(mat.offsets), np.asarray(mat.bands))
    x, k, res, conv, brk = cgx_solve(mat, bb, mesh=cgx_mesh2d(*SHAPES[shape]), **kw)
    del cgx
    return {"x": np.asarray(x), "k": np.asarray(k), "conv": np.asarray(conv),
            "brk": np.asarray(brk)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", AGAINST_CGX)
def test_matches_cgx(port, shape, name):
    """Each column's k equal to cgx's on a mesh of the same shape, X within
    1e-10 of cgx's, every column converged without breakdown."""
    got = _port(port, shape)["case_results"][shape][name]
    want = cgx_batched(shape, name)
    assert got["conv"].all() and not got["brk"].any()
    np.testing.assert_array_equal(got["k"], want["k"])
    assert_x(got["x"], want["x"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_matches_single_device_batched(port, shape):
    """tests/test_batched2d.py:17: the per-column counts of the
    single-device batched solver."""
    import cgx_torch

    got = _port(port, shape)["case_results"][shape]["matches"]
    mat, bb, kw = problem("matches")
    ref = cgx_torch.cg_solve_batched(cgx_torch.as_operator(mat, device="cpu"), bb, device="cpu",
                                     **kw)
    np.testing.assert_array_equal(got["k"], ref.iterations.numpy())
    assert_x(got["x"], ref.x.numpy(), 1e-7)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_uneven_rhs_and_rows(port, shape):
    """n = 509 is prime and 3 columns do not divide 2 rhs groups: the zero
    column converges at k = 0 with x = 0 (tests/test_batched2d.py:31)."""
    got = _port(port, shape)["case_results"][shape]["uneven"]
    mat, bb, _ = problem("uneven")
    assert got["conv"].shape == (3,) and got["conv"].all()
    assert got["k"][2] == 0 and np.all(got["x"][2] == 0.0)
    a = mat.to_dense()
    assert all(np.linalg.norm(a @ got["x"][i] - bb[i]) < 1e-5 for i in range(2))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_breakdown_flag_and_budget(port, shape):
    """A non-SPD matrix surfaces every column's breakdown; a hopeless
    tolerance under a 30-iteration budget ends with k = 30 unconverged
    (tests/test_batched2d.py:51, :67)."""
    res = _port(port, shape)["case_results"][shape]
    assert res["breakdown"]["brk"].all()
    assert not res["budget"]["conv"].any()
    np.testing.assert_array_equal(res["budget"]["k"], [30, 30])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_wide_band_falls_back_to_allgather(port, shape):
    """Bandwidth 5 over 4-row shards ((4 x 1)) gathers instead of
    halo-exchanging (tests/test_batched2d.py:82)."""
    got = _port(port, shape)["case_results"][shape]["wide"]
    mat, bb, _ = problem("wide")
    assert got["conv"].all()
    a = mat.to_dense()
    assert all(np.linalg.norm(a @ got["x"][i] - bb[i]) < 1e-5 for i in range(2))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_preconditioners_and_methods(port, shape):
    """Neumann cuts each column's count below 0.7 of plain's; the
    pipelined and gvpipe methods within 1 and 2 of the reference's, X
    within 1e-6 (tests/test_batched2d.py:99-181); gvpipe reaches 1e-10
    absolute below 1e-12 relative (:184)."""
    res = _port(port, shape)["case_results"][shape]
    assert (res["reference_neumann"]["k"] < 0.7 * res["reference"]["k"]).all()
    for pc in ("", "_neumann"):
        ref = res["reference" + pc]
        for method, slack in (("pipelined", 1), ("gvpipe", 2)):
            got = res[method + pc]
            assert (np.abs(got["k"] - ref["k"]) <= slack).all()
            np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-6, atol=1e-6)
    mat, bb, _ = problem("gv_tol")
    x = res["gv_tol"]["x"][0]
    assert np.linalg.norm(mat.mat_vec(x) - bb[0]) / np.linalg.norm(bb[0]) < 1e-12


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("method", ["pipelined", "gvpipe"])
def test_zero_column_freezes(port, shape, method):
    got = _port(port, shape)["case_results"][shape][f"zero_{method}"]
    assert got["conv"].all() and got["k"][1] == 0 and np.all(got["x"][1] == 0.0)

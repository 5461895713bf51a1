"""The port's multi-RHS and recycling solves on a mesh (cgx_torch.parallel:
sharded_block_cg_solve, sharded_deflated_cg_solve,
sharded_block_deflated_cg_solve, sharded_cg_solve_harvest,
sharded_mg_block_cg_solve, solve_sequence and solve(mesh=) with a 2-D b)
against cgx's on the CPU.

The port runs gloo worlds of 2 and 4 ranks and, as world "none", this
process without a process group (the harness of test_torch_sharded.py:
one spawn a world, every case in it, one BLAS thread a rank); cgx runs
on make_mesh(P) of the conftest's 8 CPU devices, P the world's size. The
cases mirror cgx's tests/test_blockcg.py:152-269 and :368,
tests/test_deflated.py:107-165, :235-288 and :339, and
tests/test_mg_sharded.py:176-218, :238 and :281 at their sizes; one of
each kind runs against cgx (compiling cgx's programs is most of the
file's time), the others against cgx's tests' own gates. The pins: k
equal to cgx's (the deflated solves within 1, as cgx's own test allows
against one device), fp64 x within 1e-10 of cgx's relative to max |x|,
the harvested basis as a subspace (W W^T within 1e-5 of cgx's, the
single-device harvest's pin: the window's late rows follow the
trajectory's rounding), and every rank's result bitwise equal to rank
0's.

No jax or cgx import at the top: the spawned ranks import this module.
"""

import functools

import numpy as np
import pytest

import cgx_torch
from cgx_torch.config import SolveConfig
from cgx_torch.mats.containers import CSRMatrix
from cgx_torch.mats.generators import (
    lap2d_fd,
    lap2d_fd_coo_lower,
    lap2d_reference,
    poisson2d_var,
    source_term,
)
from cgx_torch.parallel import (
    make_mesh,
    sharded_block_cg_solve,
    sharded_block_deflated_cg_solve,
    sharded_cg_solve_harvest,
    sharded_deflated_cg_solve,
    sharded_mg_block_cg_solve,
)
from test_torch_sharded import assert_x, cgx_mesh_size, run_world

WORLDS = ["none", 2, 4]
N = 400  # cgx's problem fixture: lap2d_reference(400)
G_MG = 64
BLOCK_STRATEGIES = ("halo", "allgather")
BLOCK_PRECONDS = ("jacobi", "neumann", "chebyshev")


def _mesh():
    return make_mesh(device="cpu")


def _rec(res):
    """A result's fields on the host (block or single-RHS)."""
    out = {"k": int(res.iterations), "x": res.x.cpu().numpy(),
           "converged": res.converged.cpu().numpy(), "breakdown": bool(res.breakdown)}
    return out


# ---------------------------------------------------------------------------
# The inputs, the same on every rank and on cgx's side
# ---------------------------------------------------------------------------


def block_b(name: str) -> np.ndarray:
    b0 = source_term(N)
    if name == "random":
        return np.random.default_rng(2).standard_normal((N, 4))
    if name == "precond":
        return np.stack([b0, np.random.default_rng(3).standard_normal(N)], axis=1)
    if name == "duplicate":
        return np.stack([b0, b0], axis=1)
    if name == "deflated":
        return np.stack([b0, 0.5 * b0 + 1.0], axis=1)
    b509 = source_term(509)
    if name == "dense509":
        return np.stack([b509, -2.0 * b509], axis=1)
    return np.stack([b509, -b509], axis=1)  # "deflated509"


def var_problem():
    """cgx's deflated-PCG problem (tests/test_deflated.py:339): g = 24,
    two 1e-4 inclusions."""
    g = 24
    c = np.ones((g, g))
    c[4:10, 4:10] = 1e-4
    c[14:20, 14:20] = 1e-4
    return poisson2d_var(g, c), np.random.default_rng(2).standard_normal(g * g)


@functools.lru_cache(maxsize=None)
def var_basis() -> np.ndarray:
    """The deflated PCG's W: 16 Ritz vectors of a 256-step Lanczos pass on
    the host (the port's lanczos_ritz, cgx's code), given to both sides."""
    from cgx_torch.solver.deflated import lanczos_ritz

    return lanczos_ritz(var_problem()[0], 576, 16, m=256)


def mg_b(name: str) -> np.ndarray:
    n = G_MG * G_MG
    b0 = source_term(n)
    if name == "gs":
        return np.stack([b0, np.random.default_rng(0).standard_normal(n), b0], axis=1)
    if name == "fp32_cycle":
        return np.stack([b0, 0.3 * b0 + 2.0], axis=1)
    return np.random.default_rng(5).standard_normal((n, 2)).astype(np.float32)  # "f32"


MG_KW = {"gs": dict(smoother="gs"), "fp32_cycle": dict(cycle_precision="fp32"), "f32": {}}
MG_TOL = {"gs": 1e-10, "fp32_cycle": 1e-10, "f32": 1e-4}


def seq_bs():
    rng = np.random.default_rng(11)
    return [source_term(N)] + [rng.standard_normal(N) for _ in range(2)]


# ---------------------------------------------------------------------------
# The port's cases (every rank)
# ---------------------------------------------------------------------------


def case_block():
    mesh, dia = _mesh(), lap2d_reference(N)
    out = {}
    for strategy in BLOCK_STRATEGIES:
        out[strategy] = _rec(sharded_block_cg_solve(dia, block_b("random"), mesh=mesh,
                                                    strategy=strategy, tol=1e-8))
    out["oleary"] = _rec(sharded_block_cg_solve(dia, block_b("random"), mesh=mesh, tol=1e-8,
                                                method="oleary"))
    out["dense509"] = _rec(sharded_block_cg_solve(lap2d_reference(509).to_dense(),
                                                  block_b("dense509"), mesh=mesh, tol=1e-8))
    out["duplicate"] = _rec(sharded_block_cg_solve(dia, block_b("duplicate"), mesh=mesh,
                                                   tol=1e-10))
    for pc in BLOCK_PRECONDS:
        out[pc] = _rec(sharded_block_cg_solve(dia, block_b("precond"), mesh=mesh, tol=1e-10,
                                              precond=pc))
    out["base"] = _rec(sharded_block_cg_solve(dia, block_b("precond"), mesh=mesh, tol=1e-10))
    errors = {}
    for name, call in {
        "csr": lambda: sharded_block_cg_solve(CSRMatrix.from_coo(lap2d_fd_coo_lower(8)),
                                              np.ones((64, 2)), mesh=mesh),
        "oleary_precond": lambda: sharded_block_cg_solve(dia, block_b("random"), mesh=mesh,
                                                         method="oleary", precond="jacobi"),
        "one_d": lambda: sharded_block_cg_solve(dia, source_term(N), mesh=mesh),
    }.items():
        try:
            call()
            errors[name] = None
        except ValueError as err:
            errors[name] = str(err)
    out["errors"] = errors
    return out


def case_deflated():
    mesh, dia = _mesh(), lap2d_reference(N)
    out = {"k16": _rec(sharded_deflated_cg_solve(dia, source_term(N), k=16, mesh=mesh,
                                                 tol=1e-10)),
           "pad509": _rec(sharded_deflated_cg_solve(lap2d_reference(509), source_term(509), k=8,
                                                    mesh=mesh, tol=1e-10))}
    var, b = var_problem()
    out["pcg"] = _rec(sharded_deflated_cg_solve(var, b, w=var_basis(), mesh=mesh, tol=1e-8,
                                                maxiter=5 * b.shape[0], precond="jacobi"))
    out["block"] = _rec(sharded_block_deflated_cg_solve(dia, block_b("deflated"), k=16,
                                                        mesh=mesh, tol=1e-10))
    out["block509"] = _rec(sharded_block_deflated_cg_solve(
        lap2d_reference(509), block_b("deflated509"), k=8, mesh=mesh, tol=1e-10))
    try:
        sharded_deflated_cg_solve(lap2d_reference(64), source_term(64), w=np.ones(64), mesh=mesh)
        out["bad_w"] = None
    except ValueError as err:
        out["bad_w"] = str(err)
    return out


def case_harvest():
    mesh, dia = _mesh(), lap2d_reference(N)
    res, w = sharded_cg_solve_harvest(dia, source_term(N), k=16, mesh=mesh, tol=1e-10)
    short, none = sharded_cg_solve_harvest(dia, source_term(N), k=4, maxiter=1, mesh=mesh,
                                           strict=False)
    return {**_rec(res), "w": w, "short_k": int(short.iterations), "short_w": none}


def case_sequence():
    mesh, dia = _mesh(), lap2d_reference(N)
    seq = cgx_torch.solve_sequence(dia, seq_bs(), k=16, mesh=mesh, device="cpu")
    var, _ = var_problem()
    rng = np.random.default_rng(4)
    bs = [rng.standard_normal(576) for _ in range(3)]
    pcg = cgx_torch.solve_sequence(var, bs, SolveConfig(tolerance=1e-8, maxiter=5 * 576,
                                                        precond="jacobi"), k=16, window=256,
                                   mesh=mesh, device="cpu")
    failed = cgx_torch.solve_sequence(dia, [source_term(N)] * 2,
                                      SolveConfig(tolerance=1e-10), k=8, window=2, mesh=mesh,
                                      device="cpu")
    varying = cgx_torch.solve_sequence([dia, lap2d_reference(N)], seq_bs()[:2], k=16,
                                       warm_start=True, mesh=mesh, device="cpu")
    return {"plain": [_rec(r) for r in seq], "pcg": [_rec(r) for r in pcg],
            "failed": [_rec(r) for r in failed], "varying": [_rec(r) for r in varying]}


def case_mg_block():
    mesh, fd = _mesh(), lap2d_fd(G_MG)
    out = {name: _rec(sharded_mg_block_cg_solve(fd, mg_b(name), mesh=mesh, tol=MG_TOL[name],
                                                **MG_KW[name]))
           for name in MG_KW}
    try:
        sharded_mg_block_cg_solve(fd, source_term(G_MG * G_MG), mesh=mesh)
        out["one_d"] = None
    except ValueError as err:
        out["one_d"] = str(err)
    return out


def case_solve_mesh():
    """solve(mesh=) with a 2-D b: the block route (plain and MG, with a
    warm start) and the batched one, each against the entry point it
    dispatches to."""
    mesh, dia, fd = _mesh(), lap2d_reference(N), lap2d_fd(G_MG)
    bb = block_b("random")
    out = {"block": _rec(cgx_torch.solve(dia, bb, SolveConfig(tolerance=1e-8), mesh=mesh,
                                         device="cpu")),
           "block_direct": _rec(sharded_block_cg_solve(dia, bb, mesh=mesh, tol=1e-8))}
    cfg = SolveConfig(precond="mg", mg_smoother="gs", tolerance=1e-10)
    out["mg"] = _rec(cgx_torch.solve(fd, mg_b("gs"), cfg, mesh=mesh, device="cpu"))
    x0 = out["mg"]["x"] + 1e-3
    out["mg_warm"] = _rec(cgx_torch.solve(fd, mg_b("gs"), cfg, mesh=mesh, x0=x0, device="cpu"))
    batched = cgx_torch.solve(dia, bb, SolveConfig(multi_rhs="batched", tolerance=1e-8),
                              mesh=mesh, device="cpu")
    out["batched"] = {"k": batched.iterations.numpy(), "x": batched.x.numpy(),
                      "converged": batched.converged.numpy()}
    return out


CASES = [name for name in dir() if name.startswith("case_")]


def _xs(obj, path=()):
    """Every x in a case's result, by its path."""
    if isinstance(obj, dict):
        if "x" in obj:
            yield path, obj["x"]
        for key, val in obj.items():
            yield from _xs(val, path + (key,))
    elif isinstance(obj, list):
        for i, val in enumerate(obj):
            yield from _xs(val, path + (i,))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """world -> rank 0's {case: result}; every rank's x is checked bitwise
    equal to rank 0's."""

    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"mrhs{world}")), world, __name__, CASES)
        for other in ranks[1:]:
            for name in CASES:
                for (path, x), (path0, x0) in zip(_xs(other[name]), _xs(ranks[0][name])):
                    assert path == path0
                    np.testing.assert_array_equal(x, x0, err_msg=f"{name} {path}")
        return ranks[0]

    return run


# ---------------------------------------------------------------------------
# cgx's side (this process)
# ---------------------------------------------------------------------------


def _cgx_rec(res):
    return {"k": int(res.iterations), "x": np.asarray(res.x),
            "converged": np.asarray(res.converged), "breakdown": bool(res.breakdown)}


@functools.lru_cache(maxsize=None)
def cgx_case(p: int, name: str):
    import cgx
    from cgx.mats.generators import lap2d_fd as cgx_fd
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.mg_sharded import sharded_mg_block_cg_solve as cgx_mg_block
    from cgx.parallel.sharded_cg import (
        sharded_block_cg_solve as cgx_block,
        sharded_block_deflated_cg_solve as cgx_block_defl,
        sharded_cg_solve_harvest as cgx_harvest,
        sharded_deflated_cg_solve as cgx_defl,
    )

    mesh = cgx_mesh(p)
    dia = cgx.lap2d_reference(N)
    kind, _, arg = name.partition(":")
    if kind == "block":
        return _cgx_rec(cgx_block(dia, block_b("random"), mesh=mesh, strategy=arg, tol=1e-8))
    if kind == "oleary":
        return _cgx_rec(cgx_block(dia, block_b("random"), mesh=mesh, tol=1e-8, method="oleary"))
    if kind == "dense509":
        return _cgx_rec(cgx_block(cgx.lap2d_reference(509).to_dense(), block_b("dense509"),
                                  mesh=mesh, tol=1e-8))
    if kind == "precond":
        return _cgx_rec(cgx_block(dia, block_b("precond"), mesh=mesh, tol=1e-10,
                                  precond=arg or None))
    if kind == "deflated":
        return _cgx_rec(cgx_defl(dia, source_term(N), k=16, mesh=mesh, tol=1e-10))
    if kind == "deflated_pcg":
        from cgx.mats.generators import poisson2d_var as cgx_var

        c = np.ones((24, 24))
        c[4:10, 4:10] = 1e-4
        c[14:20, 14:20] = 1e-4
        b = var_problem()[1]
        return _cgx_rec(cgx_defl(cgx_var(24, c), b, w=var_basis(), mesh=mesh, tol=1e-8,
                                 maxiter=5 * b.shape[0], precond="jacobi"))
    if kind == "block_deflated":
        return _cgx_rec(cgx_block_defl(dia, block_b("deflated"), k=16, mesh=mesh, tol=1e-10))
    if kind == "harvest":
        res, w = cgx_harvest(dia, source_term(N), k=16, mesh=mesh, tol=1e-10)
        return {**_cgx_rec(res), "w": np.asarray(w)}
    if kind == "sequence":
        return [_cgx_rec(r) for r in cgx.solve_sequence(dia, seq_bs(), k=16, mesh=mesh)]
    if kind == "mg_block":
        return _cgx_rec(cgx_mg_block(cgx_fd(G_MG), mg_b(arg), mesh=mesh, tol=MG_TOL[arg],
                                     **MG_KW[arg]))
    raise KeyError(name)


def _same(got, want, k_slack: int = 0, tol: float = 1e-10):
    assert np.all(got["converged"]) and np.all(want["converged"])
    assert not got["breakdown"]
    assert abs(got["k"] - want["k"]) <= k_slack, (got["k"], want["k"])
    assert_x(got["x"], want["x"], tol)


def _true_rel(mat, x, b) -> np.ndarray:
    x, b = np.asarray(x, np.float64).reshape(b.shape[0], -1), b.reshape(b.shape[0], -1)
    r = np.stack([mat.mat_vec(x[:, j]) for j in range(x.shape[1])], axis=1) - b
    return np.linalg.norm(r, axis=0) / np.linalg.norm(b, axis=0)


# ---------------------------------------------------------------------------
# Block CG (tests/test_blockcg.py:152-269)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", BLOCK_STRATEGIES)
def test_block_matches_cgx(port, world, strategy):
    """The halo strategy against cgx's; the allgather strategy's shard
    products take the same terms in the same order, so its solve is the
    halo one's bit for bit."""
    case = port(world)["case_block"]
    if strategy == "halo":
        _same(case["halo"], cgx_case(cgx_mesh_size(world), "block:halo"))
    else:
        assert case["allgather"]["k"] == case["halo"]["k"]
        np.testing.assert_array_equal(case["allgather"]["x"], case["halo"]["x"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["oleary", "dense509", "duplicate"])
def test_block_variants_match_cgx(port, world, name):
    """O'Leary's recurrence and a dense operator with padded rows (509 is
    prime) against cgx's; duplicate columns through the breakdown-free
    rank reveal to the true tolerance (tests/test_blockcg.py:196)."""
    got = port(world)["case_block"][name]
    if name == "duplicate":
        assert np.all(got["converged"]) and not got["breakdown"]
        assert np.all(_true_rel(lap2d_reference(N), got["x"], block_b(name)) < 1e-11)
        return
    _same(got, cgx_case(cgx_mesh_size(world), name))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("precond", BLOCK_PRECONDS)
def test_block_preconditioned_matches_cgx(port, world, precond):
    """Jacobi (local), Neumann and Chebyshev (the block strategy mat-vec)
    to the true tolerance (tests/test_blockcg.py:268); Neumann against
    cgx's count and x, and strictly fewer iterations than none."""
    case = port(world)["case_block"]
    assert np.all(case[precond]["converged"]) and not case[precond]["breakdown"]
    assert np.all(_true_rel(lap2d_reference(N), case[precond]["x"], block_b("precond")) < 1e-11)
    if precond == "neumann":
        _same(case[precond], cgx_case(cgx_mesh_size(world), "precond:neumann"))
        assert case["neumann"]["k"] < case["base"]["k"]


@pytest.mark.parametrize("world", WORLDS)
def test_block_errors(port, world):
    errors = port(world)["case_block"]["errors"]
    assert "block CG supports" in errors["csr"]
    assert "precond requires" in errors["oleary_precond"]
    assert "must be (n, s)" in errors["one_d"]


# ---------------------------------------------------------------------------
# Deflated and block-deflated CG (tests/test_deflated.py:107-165, :339;
# tests/test_blockcg.py:368)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,want", [("k16", "deflated"), ("pad509", "deflated509"),
                                       ("pcg", "deflated_pcg"), ("block", "block_deflated")])
def test_deflated_matches_cgx(port, world, name, want):
    """k within 1 of cgx's (cgx's own slack against one device), x within
    1e-10; n = 509's padded rows stay exact: the true residual below 1e-12
    (tests/test_deflated.py:154)."""
    got = port(world)["case_deflated"][name]
    if name == "pad509":
        assert np.all(got["converged"]) and not got["breakdown"]
        assert _true_rel(lap2d_reference(509), got["x"], source_term(509))[0] < 1e-12
        return
    _same(got, cgx_case(cgx_mesh_size(world), want), k_slack=1)


@pytest.mark.parametrize("world", WORLDS)
def test_block_deflated_padding_and_bad_w(port, world):
    case = port(world)["case_deflated"]
    assert np.all(case["block509"]["converged"])
    assert np.all(_true_rel(lap2d_reference(509), case["block509"]["x"],
                            block_b("deflated509")) < 1e-10)
    assert "w must be" in case["bad_w"]


# ---------------------------------------------------------------------------
# The harvest and solve_sequence (tests/test_deflated.py:235-288)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_harvest_matches_cgx(port, world):
    """The solve as cgx's, and the harvested basis as a subspace: the Ritz
    vectors' signs and order may differ, their span may not."""
    got = port(world)["case_harvest"]
    want = cgx_case(cgx_mesh_size(world), "harvest")
    _same(got, want)
    w, wc = got["w"], want["w"]
    assert w.shape == wc.shape and 1 <= w.shape[1] <= 16
    np.testing.assert_allclose(w.T @ w, np.eye(w.shape[1]), atol=1e-10)
    # the window's late rows follow the trajectory's rounding, so the span
    # differs as the single-device harvest's does (test_torch_deflated.py:91)
    np.testing.assert_allclose(w @ w.T, wc @ wc.T, atol=1e-5)
    # a one-iteration cap leaves nothing to harvest: strict=False keeps the solve
    assert got["short_k"] == 1 and got["short_w"] is None


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_matches_cgx(port, world):
    """solve_sequence(mesh=): the harvesting first solve as cgx's, the
    deflated ones within 1; each below 1e-11, the recycled ones at most
    0.7 of plain CG's count (tests/test_deflated.py:262-288)."""
    got = port(world)["case_sequence"]["plain"]
    want = cgx_case(cgx_mesh_size(world), "sequence")
    dia = lap2d_reference(N)
    for i, (g, w, b) in enumerate(zip(got, want, seq_bs())):
        _same(g, w, k_slack=0 if i == 0 else 1)
        assert _true_rel(dia, g["x"], b)[0] < 1e-11
    plain1 = cgx_torch.cg_solve(cgx_torch.as_operator(dia, device="cpu"), seq_bs()[1],
                                tol=1e-10, device="cpu")
    assert all(g["k"] < 0.7 * int(plain1.iterations) for g in got[1:])


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_paths(port, world):
    """The deflated PCG sequence (tests/test_deflated.py:366), the failed
    harvest's plain remainder, and a varying A with warm starts."""
    case = port(world)["case_sequence"]
    var, _ = var_problem()
    rng = np.random.default_rng(4)
    bs = [rng.standard_normal(576) for _ in range(3)]
    for r, b in zip(case["pcg"], bs):
        assert np.all(r["converged"]) and _true_rel(var, r["x"], b)[0] < 1e-9
    assert case["pcg"][1]["k"] < 0.25 * case["pcg"][0]["k"]
    assert all(np.all(r["converged"]) for r in case["failed"])
    assert case["failed"][1]["k"] == case["failed"][0]["k"]
    assert all(np.all(r["converged"]) for r in case["varying"])
    assert _true_rel(lap2d_reference(N), case["varying"][1]["x"], seq_bs()[1])[0] < 1e-11


# ---------------------------------------------------------------------------
# Sharded block MG-PCG (tests/test_mg_sharded.py:176-218, :238, :281) and
# solve(mesh=) with a 2-D b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(MG_KW))
def test_mg_block_matches_cgx(port, world, name):
    """Gauss-Seidel with a duplicate column against cgx's k and x; it, the
    fp32 cycle in fp64 and a float32 b within cgx's residual gates."""
    got = port(world)["case_mg_block"][name]
    fd, b = lap2d_fd(G_MG), mg_b(name)
    assert np.all(got["converged"]) and not got["breakdown"]
    if name == "f32":  # tests/test_mg_sharded.py:281
        assert got["x"].dtype == np.float32 and np.all(_true_rel(fd, got["x"], b) < 1e-3)
        return
    assert got["k"] < 20 and np.all(_true_rel(fd, got["x"], b) < 1e-11)
    if name == "gs":
        _same(got, cgx_case(cgx_mesh_size(world), "mg_block:gs"))


@pytest.mark.parametrize("world", WORLDS)
def test_mg_block_rejects_1d(port, world):
    assert "must be" in port(world)["case_mg_block"]["one_d"]


@pytest.mark.parametrize("world", WORLDS)
def test_solve_mesh_2d_b(port, world):
    """solve(mesh=) with a 2-D b: "block" runs sharded_block_cg_solve (MG
    sharded_mg_block_cg_solve) bitwise, a warm start by the shift identity,
    "batched" the 2-D mesh's reference recurrence (each column's k that of
    the same column on one device, tests/test_batched2d.py:17)."""
    case = port(world)["case_solve_mesh"]
    np.testing.assert_array_equal(case["block"]["x"], case["block_direct"]["x"])
    np.testing.assert_array_equal(case["mg"]["x"], port(world)["case_mg_block"]["gs"]["x"])
    assert np.all(case["mg_warm"]["converged"]) and case["mg_warm"]["k"] <= case["mg"]["k"]
    assert np.all(_true_rel(lap2d_fd(G_MG), case["mg_warm"]["x"], mg_b("gs")) < 1e-11)
    single = cgx_torch.solve(lap2d_reference(N), block_b("random"),
                             SolveConfig(multi_rhs="batched", tolerance=1e-8), device="cpu")
    assert np.all(case["batched"]["converged"])
    np.testing.assert_array_equal(case["batched"]["k"], single.iterations.numpy())
    assert_x(case["batched"]["x"], single.x.numpy(), 1e-7)

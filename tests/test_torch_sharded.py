"""The port's sharded route (cgx_torch.parallel) against cgx's
(cgx.parallel.sharded_cg) on the CPU.

The port runs one process a rank: gloo worlds of 1, 2 and 4 ranks,
started with the spawn context and a FileStore under the test's
temporary directory, and, as world "none", this process alone without a
process group (identity collectives). cgx runs on make_mesh(P) of the
conftest's 8 CPU devices, in this process. Each world runs every case
in one spawn; the tests read its results. The pins mirror
tests/test_sharded.py: the same iteration counts, x within 1e-10.

This module imports neither jax nor cgx at its top: the spawned ranks
import it, and they import only torch and cgx_torch. cgx is imported
inside the functions that compute its reference values.
"""

import datetime
import functools
import importlib
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cgx_torch.mats.containers import CSRMatrix, ELLMatrix
from cgx_torch.mats.generators import lap2d_fd_coo_lower, lap2d_reference, source_term
from cgx_torch.parallel import make_mesh, make_sharded_solver, sharded_cg_solve
from cgx_torch.parallel import sharded_cg as sc
from cgx_torch.utils import collectives

WORLDS = ["none", 1, 2, 4]
XTOL = 1e-10  # x against cgx's, relative to max |x|
CHEB_BOUNDS = (0.0183775, 7.98163)  # lap2d_reference(512): its extreme eigenvalues, rounded


# ---------------------------------------------------------------------------
# The harness: one spawn a world, every case in it
# ---------------------------------------------------------------------------


def _rank_main(rank, world, store, out_dir, module, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mod = importlib.import_module(module)
        out = {name: getattr(mod, name)() for name in cases}
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def run_world(tmp_dir, world, module: str, cases) -> list:
    """Each case function of ``module`` (named in ``cases``) run once on
    every rank of a gloo world of ``world`` ranks, or in this process for
    ``world == "none"``; returns each rank's {case: result}."""
    if world == "none":
        mod = importlib.import_module(module)
        return [{name: getattr(mod, name)() for name in cases}]
    os.makedirs(tmp_dir, exist_ok=True)
    # one BLAS thread a rank: the ranks share the host's cores, and a NumPy
    # BLAS call that spins up every core in each rank at once runs many times
    # slower (the spawned ranks inherit this environment as they start)
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update(_ONE_THREAD)
    try:
        mp.start_processes(_rank_main, args=(world, os.path.join(tmp_dir, "store"), tmp_dir,
                                             module, list(cases)),
                           nprocs=world, join=True, start_method="spawn")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def cgx_mesh_size(world) -> int:
    return 1 if world == "none" else world


def _np(res):
    return {"k": int(res.iterations), "x": res.x.cpu().numpy(), "converged": bool(res.converged),
            "res": float(res.residual_norm), "history": res.history.cpu().numpy()}


def _mesh():
    return make_mesh(device="cpu")


# ---------------------------------------------------------------------------
# The port's cases (run on every rank)
# ---------------------------------------------------------------------------


def case_dia_halo():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(),
                                strategy="halo", tol=1e-6))


def case_dia_allgather():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(),
                                strategy="allgather", tol=1e-6))


def case_dense_allgather():
    return _np(sharded_cg_solve(lap2d_reference(256).to_dense(), source_term(256), mesh=_mesh(),
                                strategy="allgather", tol=1e-6))


def case_dense_reducescatter():
    return _np(sharded_cg_solve(lap2d_reference(256).to_dense(), source_term(256), mesh=_mesh(),
                                strategy="reducescatter", tol=1e-6))


def case_padding():
    return _np(sharded_cg_solve(lap2d_reference(509), source_term(509), mesh=_mesh(),
                                strategy="halo", tol=1e-6))


def case_full_convergence():
    return _np(sharded_cg_solve(lap2d_reference(1024), source_term(1024), mesh=_mesh()))


def case_jacobi():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-8,
                                jacobi=True))


def case_history():
    return _np(sharded_cg_solve(lap2d_reference(256), source_term(256), mesh=_mesh(), tol=1e-6,
                                history=64))


def case_subsets():
    """Meshes of the first 1, 2 and 4 ranks; every rank makes each
    (``dist.new_group`` is collective), its members solve."""
    out = {}
    for p in (1, 2, 4):
        if p > (dist.get_world_size() if dist.is_initialized() else 1):
            continue
        mesh = make_mesh(p, device="cpu")
        if mesh.is_member:
            out[p] = sharded_cg_solve(lap2d_reference(128), source_term(128), mesh=mesh,
                                      tol=1e-6).x.numpy()
    return out


def case_auto_fallback():
    mesh = _mesh()
    solver = make_sharded_solver(lap2d_reference(16), 16, mesh=mesh, tol=1e-6)
    return {**_np(solver.solve(source_term(16))), "strategy": solver.strategy,
            "n_loc": -(-16 // mesh.size)}


def case_stream2d():
    xla = sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(),
                           strategy="halo", tol=1e-6, local_kernel="xla")
    stream = sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(),
                              strategy="halo", tol=1e-6, local_kernel="stream2d")
    return {**_np(stream), "k_xla": int(xla.iterations),
            "bitwise_xla": bool(torch.equal(stream.x, xla.x))}


def case_resident():
    mesh = _mesh()
    dia, b1 = lap2d_reference(512), source_term(512)
    b2 = 0.5 * b1 + 1e-3
    solver = make_sharded_solver(dia, 512, dtype=b1.dtype, mesh=mesh, strategy="halo", tol=1e-6)
    r1, r2 = solver.solve(b1), solver(b2)
    ref1 = sharded_cg_solve(dia, b1, mesh=mesh, strategy="halo", tol=1e-6)
    ref2 = sharded_cg_solve(dia, b2, mesh=mesh, strategy="halo", tol=1e-6)
    warm = solver.solve(b1, x0=r1.x.numpy())
    loose = solver.solve(b1, tol=1e-2)
    return {"x1": r1.x.numpy(), "x2": r2.x.numpy(),
            "same1": bool(torch.equal(r1.x, ref1.x)), "same2": bool(torch.equal(r2.x, ref2.x)),
            "k1": int(r1.iterations), "k_warm": int(warm.iterations),
            "k_loose": int(loose.iterations)}


def case_pipelined():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-6,
                                method="pipelined"))


def case_neumann_reference():
    return _np(sharded_cg_solve(lap2d_reference(1024), source_term(1024), mesh=_mesh(),
                                tol=1e-8, precond="neumann"))


def case_neumann_pipelined():
    return _np(sharded_cg_solve(lap2d_reference(1024), source_term(1024), mesh=_mesh(),
                                tol=1e-8, method="pipelined", precond="neumann"))


def case_pipelined_jacobi():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-8,
                                method="pipelined", precond="jacobi"))


def case_ell():
    return _np(sharded_cg_solve(ELLMatrix.from_coo(lap2d_fd_coo_lower(20)), source_term(400),
                                mesh=_mesh(), tol=1e-6, precond="jacobi"))


def case_csr():
    return _np(sharded_cg_solve(CSRMatrix.from_coo(lap2d_fd_coo_lower(20)), source_term(400),
                                mesh=_mesh(), tol=1e-6))


def case_coo():
    return _np(sharded_cg_solve(lap2d_fd_coo_lower(13), source_term(169), mesh=_mesh(),
                                tol=1e-8))


def case_fp32():
    b = source_term(512).astype(np.float32)
    return _np(sharded_cg_solve(lap2d_reference(512), b, mesh=_mesh(),
                                tol=1e-5 * float(np.linalg.norm(b)), dot_precision=torch.float64))


def case_block_jacobi():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-8,
                                precond="block_jacobi"))


def case_block_jacobi_dense_pipelined():
    return _np(sharded_cg_solve(lap2d_reference(256).to_dense(), source_term(256), mesh=_mesh(),
                                tol=1e-8, method="pipelined", precond="block_jacobi",
                                precond_block_size=8))


def case_chebyshev_precond():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-8,
                                precond="chebyshev"))


def case_chebyshev_bounds_pipelined():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-8,
                                method="pipelined", precond="chebyshev", bounds=CHEB_BOUNDS))


def case_dense_ozaki():
    return _np(sharded_cg_solve(lap2d_reference(256).to_dense(), source_term(256), mesh=_mesh(),
                                tol=1e-6, dense_fp64="ozaki"))


def case_straddling_blocks():
    """Blocks of 24 rows straddle the shards of every world but one rank
    (512 / 24 is no integer): cgx's error."""
    try:
        sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(),
                         precond="block_jacobi", precond_block_size=24)
    except ValueError as e:
        return str(e)
    return None


def case_solve_n_devices():
    """solve(n_devices=P) over the whole world: the sharded route for P > 1
    (cgx api.py:210), one device for P = 1."""
    import cgx_torch

    world = dist.get_world_size() if dist.is_initialized() else 1
    with collectives.capture() as cap:
        res = cgx_torch.solve(lap2d_reference(512), source_term(512),
                              cgx_torch.SolveConfig(tolerance=1e-6), n_devices=world,
                              device="cpu")
    return {**_np(res), "sharded": bool(cap.programs)}


def case_gvpipe():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-8,
                                method="gvpipe"))


def case_gvpipe_jacobi():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-8,
                                method="gvpipe", precond="jacobi", gv_replace_every=10))


def case_chebyshev_method():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-6,
                                method="chebyshev", bounds=CHEB_BOUNDS, check_every=8))


def case_chebyshev_method_host_bounds():
    return _np(sharded_cg_solve(lap2d_reference(512), source_term(512), mesh=_mesh(), tol=1e-6,
                                method="chebyshev"))


def case_refine():
    return _np(sc.sharded_refine_fixed_sweeps(lap2d_reference(1024), source_term(1024),
                                              mesh=_mesh(), sweeps=4))


def case_refine_padding():
    return _np(sc.sharded_refine_fixed_sweeps(lap2d_reference(509), source_term(509),
                                              mesh=_mesh(), sweeps=5))


def case_solve_mixed():
    import cgx_torch

    return _np(cgx_torch.solve(lap2d_reference(1024), source_term(1024),
                               cgx_torch.SolveConfig(precision="mixed", tolerance=1e-11),
                               mesh=_mesh(), device="cpu"))


CASES = [name for name in dir() if name.startswith("case_")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """world -> rank 0's {case: result}; every rank's x is checked equal."""

    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"world{world}")), world, __name__, CASES)
        for other in ranks[1:]:
            for name, res in other.items():
                if isinstance(res, dict) and "x" in res:
                    np.testing.assert_array_equal(res["x"], ranks[0][name]["x"])
        return ranks[0]

    return run


# ---------------------------------------------------------------------------
# cgx's side (this process)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cgx_solve(p: int, problem: str, **kw):
    import cgx
    from cgx.mats.containers import CSRMatrix as CgxCsr
    from cgx.mats.containers import ELLMatrix as CgxEll
    from cgx.mats.generators import lap2d_fd_coo_lower as cgx_coo
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.sharded_cg import sharded_cg_solve as cgx_sharded

    kind, n = problem.split(":")
    n = int(n)
    mat = {"dia": lambda: cgx.lap2d_reference(n),
           "dense": lambda: cgx.lap2d_reference(n).to_dense(),
           "ell": lambda: CgxEll.from_coo(cgx_coo(n)),
           "csr": lambda: CgxCsr.from_coo(cgx_coo(n)),
           "coo": lambda: cgx_coo(n)}[kind]()
    size = mat.shape[0]
    b = source_term(size)
    if kw.pop("fp32", False):
        b = b.astype(np.float32)
        kw["tol"] = 1e-5 * float(np.linalg.norm(b))
    res = cgx_sharded(mat, b, mesh=cgx_mesh(p), **kw)
    return {"k": int(res.iterations), "x": np.asarray(res.x), "converged": bool(res.converged),
            "res": float(res.residual_norm), "history": np.asarray(res.history)}


def assert_x(got, want, tol=XTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _same_solve(got, want, tol=XTOL):
    assert got["converged"] and want["converged"]
    assert got["k"] == want["k"]
    assert_x(got["x"], want["x"], tol)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", ["halo", "allgather"])
def test_dia_matches_cgx(port, world, strategy):
    want = cgx_solve(cgx_mesh_size(world), "dia:512", strategy=strategy, tol=1e-6)
    _same_solve(port(world)[f"case_dia_{strategy}"], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", ["allgather", "reducescatter"])
def test_dense_matches_cgx(port, world, strategy):
    want = cgx_solve(cgx_mesh_size(world), "dense:256", strategy=strategy, tol=1e-6)
    _same_solve(port(world)[f"case_dense_{strategy}"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_padding_is_exact(port, world):
    """N = 509 is prime: every world pads; the padded rows change nothing."""
    got = port(world)["case_padding"]
    assert got["x"].shape == (509,)
    _same_solve(got, cgx_solve(cgx_mesh_size(world), "dia:509", strategy="halo", tol=1e-6))


@pytest.mark.parametrize("world", WORLDS)
def test_full_convergence_to_reference_tolerance(port, world):
    got = port(world)["case_full_convergence"]
    want = cgx_solve(cgx_mesh_size(world), "dia:1024")
    assert got["converged"] and abs(got["k"] - want["k"]) <= 2
    a = lap2d_reference(1024).to_dense()
    b = source_term(1024)
    assert np.linalg.norm(a @ got["x"] - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.parametrize("world", WORLDS)
def test_jacobi(port, world):
    _same_solve(port(world)["case_jacobi"],
                cgx_solve(cgx_mesh_size(world), "dia:512", tol=1e-8, jacobi=True))


@pytest.mark.parametrize("world", WORLDS)
def test_history_trace(port, world):
    got = port(world)["case_history"]
    want = cgx_solve(cgx_mesh_size(world), "dia:256", tol=1e-6, history=64)
    _same_solve(got, want)
    k = got["k"]
    assert np.isfinite(got["history"][: min(k + 1, 64)]).all()
    np.testing.assert_allclose(got["history"][:32], want["history"][:32], rtol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_subset_sizes(port, world):
    xs = port(world)["case_subsets"]
    assert set(xs) == {p for p in (1, 2, 4) if p <= cgx_mesh_size(world)}
    for p, x in xs.items():
        assert_x(x, cgx_solve(p, "dia:128", tol=1e-6)["x"])
        np.testing.assert_allclose(x, xs[1], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_auto_strategy_falls_back_when_halo_too_wide(port, world):
    """lap2d_reference(16): halo 5, wider than a 4-row shard of 4 ranks."""
    got = port(world)["case_auto_fallback"]
    assert got["strategy"] == ("allgather" if 5 > got["n_loc"] else "halo")
    _same_solve(got, cgx_solve(cgx_mesh_size(world), "dia:16", tol=1e-6))


@pytest.mark.parametrize("world", WORLDS)
def test_stream2d_local_kernel_equals_xla(port, world):
    """The B8 local product with its patched edge rows gives the "xla"
    path's x bit for bit, and cgx's k."""
    got = port(world)["case_stream2d"]
    assert got["bitwise_xla"] and got["k"] == got["k_xla"]
    _same_solve(got, cgx_solve(cgx_mesh_size(world), "dia:512", strategy="halo", tol=1e-6,
                               local_kernel="stream2d"))


@pytest.mark.parametrize("world", WORLDS)
def test_operator_resident_solver(port, world):
    got = port(world)["case_resident"]
    p = cgx_mesh_size(world)
    assert got["same1"] and got["same2"]
    assert_x(got["x1"], cgx_solve(p, "dia:512", strategy="halo", tol=1e-6)["x"])
    assert got["k_warm"] <= 1
    assert got["k_loose"] < got["k1"]


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_residual_is_global(port, world):
    got = port(world)["case_pipelined"]
    want = cgx_solve(cgx_mesh_size(world), "dia:512", tol=1e-6, method="pipelined")
    _same_solve(got, want)
    single = cgx_solve(1, "dia:512", tol=1e-6, method="pipelined")
    assert got["res"] == pytest.approx(single["res"], rel=1e-6)
    assert got["res"] == pytest.approx(want["res"], rel=1e-9)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", ["reference", "pipelined"])
def test_neumann(port, world, method):
    got = port(world)[f"case_neumann_{method}"]
    _same_solve(got, cgx_solve(cgx_mesh_size(world), "dia:1024", tol=1e-8, method=method,
                               precond="neumann"))


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_jacobi(port, world):
    got = port(world)["case_pipelined_jacobi"]
    _same_solve(got, cgx_solve(cgx_mesh_size(world), "dia:512", tol=1e-8, method="pipelined",
                               precond="jacobi"))
    a, b = lap2d_reference(512).to_dense(), source_term(512)
    assert np.linalg.norm(a @ got["x"] - b) / np.linalg.norm(b) < 1e-10


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fmt,problem,kw", [
    ("ell", "ell:20", {"tol": 1e-6, "precond": "jacobi"}),
    ("csr", "csr:20", {"tol": 1e-6}),
    ("coo", "coo:13", {"tol": 1e-8}),
])
def test_sparse_formats(port, world, fmt, problem, kw):
    _same_solve(port(world)[f"case_{fmt}"], cgx_solve(cgx_mesh_size(world), problem, **kw))


@pytest.mark.parametrize("world", WORLDS)
def test_fp32_with_fp64_dots(port, world):
    """A float32 b solves in float32, with float64 dots as solve() asks."""
    got = port(world)["case_fp32"]
    want = cgx_solve(cgx_mesh_size(world), "dia:512", fp32=True, dot_precision=np.float64)
    assert got["x"].dtype == np.float32 and got["converged"]
    assert abs(got["k"] - want["k"]) <= 1
    assert_x(got["x"], want["x"], 1e-4)


def _close_solve(got, want, dk: int = 1, tol: float = 1e-8):
    """Converged, k within ``dk`` of cgx's, x within ``tol`` of cgx's
    relative to max |x|: the batched block products and the polynomial's
    mat-vecs round in the library's order, not XLA's."""
    assert got["converged"] and want["converged"]
    assert abs(got["k"] - want["k"]) <= dk, (got["k"], want["k"])
    assert_x(got["x"], want["x"], tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,problem,kw", [
    ("block_jacobi", "dia:512", {"tol": 1e-8, "precond": "block_jacobi"}),
    ("block_jacobi_dense_pipelined", "dense:256",
     {"tol": 1e-8, "method": "pipelined", "precond": "block_jacobi", "precond_block_size": 8}),
    ("chebyshev_precond", "dia:512", {"tol": 1e-8, "precond": "chebyshev"}),
    ("chebyshev_bounds_pipelined", "dia:512",
     {"tol": 1e-8, "method": "pipelined", "precond": "chebyshev", "bounds": CHEB_BOUNDS}),
], ids=["block_jacobi", "block_jacobi_dense_pipelined", "chebyshev", "chebyshev_bounds"])
def test_sharded_preconditioners_match_cgx(port, world, case, problem, kw):
    """Block-Jacobi (the shard's blocks, one local batched product) and
    the degree-3 Chebyshev polynomial (on host_spectral_bounds, or given
    bounds) on every world: k within 1 of cgx's on make_mesh(P), x within
    1e-8, and the true residual below 1e-8."""
    got = port(world)[f"case_{case}"]
    _close_solve(got, cgx_solve(cgx_mesh_size(world), problem, **kw))
    kind, n = problem.split(":")
    a, b = lap2d_reference(int(n)).to_dense(), source_term(int(n))
    assert np.linalg.norm(a @ got["x"] - b) / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("world", WORLDS)
def test_dense_ozaki_matches_cgx(port, world):
    """dense_fp64="ozaki": the shards as int8 slices under allgather, k
    within 1 of cgx's Ozaki route and x within 1e-10 (the fp64 combine
    sums in the library's order)."""
    got = port(world)["case_dense_ozaki"]
    _close_solve(got, cgx_solve(cgx_mesh_size(world), "dense:256", tol=1e-6,
                                dense_fp64="ozaki"), tol=XTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_block_jacobi_straddling_blocks_raise(port, world):
    """A block size that does not divide the shard size raises cgx's
    ValueError; one that does (24 rows on N = 48, one rank) solves."""
    msg = port(world)["case_straddling_blocks"]
    assert msg is not None and "divide the shard size" in msg
    res = sharded_cg_solve(lap2d_reference(48), source_term(48), mesh=_mesh(), tol=1e-8,
                           precond="block_jacobi", precond_block_size=24)
    assert bool(res.converged)


@pytest.mark.parametrize("world", WORLDS)
def test_solve_n_devices_routes_to_the_sharded_solver(port, world):
    got = port(world)["case_solve_n_devices"]
    assert got["sharded"] == (cgx_mesh_size(world) > 1)
    _same_solve(got, cgx_solve(cgx_mesh_size(world), "dia:512", tol=1e-6))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,kw", [
    ("gvpipe", {"tol": 1e-8, "method": "gvpipe"}),
    ("gvpipe_jacobi", {"tol": 1e-8, "method": "gvpipe", "precond": "jacobi",
                       "gv_replace_every": 10}),
    ("chebyshev_method", {"tol": 1e-6, "method": "chebyshev", "bounds": CHEB_BOUNDS,
                          "check_every": 8}),
    ("chebyshev_method_host_bounds", {"tol": 1e-6, "method": "chebyshev"}),
], ids=["gvpipe", "gvpipe_jacobi", "chebyshev", "chebyshev_host_bounds"])
def test_gvpipe_and_chebyshev_match_cgx(port, world, case, kw):
    """The sharded gvpipe (on gv_cg_loop with the fused all-reduce) and the
    Chebyshev method (on given bounds or the host matrix's) on every world
    against cgx on make_mesh(P): the same k, x within 1e-10 (both raised
    naming A11 until it landed)."""
    got = port(world)[f"case_{case}"]
    _same_solve(got, cgx_solve(cgx_mesh_size(world), "dia:512", **kw))
    if kw["method"] == "chebyshev":
        assert got["k"] % kw.get("check_every", 32) == 0


@functools.lru_cache(maxsize=None)
def cgx_refine(p: int, n: int, sweeps: int):
    import cgx
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.sharded_cg import sharded_refine_fixed_sweeps as cgx_sharded_refine

    res = cgx_sharded_refine(cgx.lap2d_reference(n), source_term(n), mesh=cgx_mesh(p),
                             sweeps=sweeps)
    return {"k": int(res.iterations), "x": np.asarray(res.x), "res": float(res.residual_norm),
            "history": np.asarray(res.history), "converged": bool(res.converged)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,n,sweeps", [("refine", 1024, 4), ("refine_padding", 509, 5),
                                           ("solve_mixed", 1024, 4)],
                         ids=["refine", "padding", "solve_mixed"])
def test_refine_matches_cgx(port, world, case, n, sweeps):
    """Sharded mixed refinement (cgx tests/test_sharded.py:373-400): the
    sweeps within one of cgx's on make_mesh(P), equal where cgx's last
    residual is not within 2x of rtol ||b||; the true residual below
    rtol = 1e-11; the first sweep's inner count within 1 of cgx's, the
    later ones within a tenth (a later inner solves a residual at the fp32
    inner's rounding level, where its count follows the fp32 dots' summation
    order, torch's here and XLA's in cgx: 88 against 83 on lap2d_reference
    (1024)); the padded N = 509 exact; solve(precision="mixed", mesh=)
    routes here."""
    got, want = port(world)[f"case_{case}"], cgx_refine(cgx_mesh_size(world), n, sweeps)
    b = source_term(n)
    target = 1e-11 * np.linalg.norm(b)
    assert got["converged"] and want["converged"] and got["x"].shape == (n,)
    assert abs(got["k"] - want["k"]) <= 1
    if want["res"] < 0.5 * target:
        assert got["k"] == want["k"]
    a = lap2d_reference(n).to_dense()
    assert np.linalg.norm(a @ got["x"] - b) / np.linalg.norm(b) < 1e-11
    k = min(got["k"], want["k"])
    assert abs(got["history"][0] - want["history"][0]) <= 1
    assert np.all(np.abs(got["history"][:k] - want["history"][:k]) <= 0.1 * want["history"][:k])
    assert got["history"][0] > 0 and got["history"].shape == (sweeps,)


def test_chebyshev_method_rejects_bad_bounds():
    with pytest.raises(ValueError, match="invalid spectral bounds"):
        sharded_cg_solve(lap2d_reference(64), source_term(64), mesh=_mesh(), method="chebyshev",
                         bounds=(0.0, 8.0))


# ---------------------------------------------------------------------------
# In this process, without a process group
# ---------------------------------------------------------------------------


def test_local_kernel_auto_rule():
    """cgx's rule: "auto" is the B8 product only on an accelerator, for a
    4-byte shard of at least STREAM_LOCAL_MIN_ELEMS rows."""
    big = sc.STREAM_LOCAL_MIN_ELEMS
    assert sc._resolve_local_kernel("auto", 10_000_000, np.float32, "cpu") == "xla"
    assert sc._resolve_local_kernel("auto", big, torch.float32, "cuda") == "stream2d"
    assert sc._resolve_local_kernel("auto", big - 1, torch.float32, "cuda") == "xla"
    assert sc._resolve_local_kernel("auto", 10_000_000, torch.float64, "cuda") == "xla"
    assert sc._resolve_local_kernel("stream2d", 8, np.float64, "cpu") == "stream2d"
    with pytest.raises(ValueError, match="local_kernel"):
        sc._resolve_local_kernel("pallas", 8, np.float64, "cpu")


def test_mesh_without_a_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.is_member) == (1, 0, None, True)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        make_mesh(2, device="cpu")


def test_halo_wider_than_the_shard_raises():
    with pytest.raises(ValueError, match="exceeds shard size"):
        sc._DiaHalo(make_mesh(device="cpu"), torch.zeros(3, 4, dtype=torch.float64),
                    (-5, 0, 5), 4)


def test_dense_fp64_auto_is_emulated_on_the_cpu(monkeypatch):
    """"auto" is the fp64 product: on the CPU, as in cgx, and by design on
    CUDA too (the H100's fp64 is native; the rule reads no device). An
    unknown mode raises, and "ozaki" takes no reducescatter."""
    seen = []
    monkeypatch.setattr(sc, "_DenseOzakiAllGather", lambda *a, **k: seen.append(1))
    res = sharded_cg_solve(lap2d_reference(64).to_dense(), source_term(64),
                           mesh=make_mesh(device="cpu"), dense_fp64="auto", tol=1e-6)
    assert bool(res.converged) and not seen
    with pytest.raises(ValueError, match="unknown dense_fp64"):
        sharded_cg_solve(lap2d_reference(64).to_dense(), source_term(64),
                         mesh=make_mesh(device="cpu"), dense_fp64="fast")
    with pytest.raises(ValueError, match="allgather"):
        sharded_cg_solve(lap2d_reference(64).to_dense(), source_term(64),
                         mesh=make_mesh(device="cpu"), dense_fp64="ozaki",
                         strategy="reducescatter")


@pytest.mark.parametrize("name,item", [
    ("sharded_block_cg_solve", "A14"), ("sharded_deflated_cg_solve", "A14"),
    ("sharded_block_deflated_cg_solve", "A14"), ("sharded_cg_solve_harvest", "A14"),
    ("sharded_cg_solve_batched", "A14"),
])
def test_unported_sharded_solves_raise(name, item):
    """cgx's multi-RHS and recycling solves, which raised naming ROADMAP
    A14 until its multi-RHS half landed, now solve on a mesh of one rank
    without a process group (against cgx: tests/test_torch_sharded_multi_rhs.py
    and tests/test_torch_batched2d.py)."""
    import cgx_torch.parallel as par

    dia, b = lap2d_reference(64), source_term(64)
    kw = dict(tol=1e-8, device="cpu")
    if name == "sharded_cg_solve_batched":
        res = par.sharded_cg_solve_batched(dia, np.stack([b, -b]), **kw)
        assert bool(res[3].all()) and res[0].shape == (2, 64)
        return
    if name == "sharded_cg_solve_harvest":
        res, w = par.sharded_cg_solve_harvest(dia, b, k=4, **kw)
        assert w.shape[0] == 64
    else:
        rhs = np.stack([b, -b], axis=1) if "block" in name else b
        res = getattr(par, name)(dia, rhs, **({"k": 4} if "deflated" in name else {}), **kw)
    assert bool(res.converged.all())


def test_collectives_are_recorded_by_phase():
    with collectives.capture() as cap:
        res = sharded_cg_solve(lap2d_reference(64), source_term(64), mesh=make_mesh(device="cpu"),
                               strategy="halo", tol=1e-6)
    sig = cap.signature()
    assert sig["uniform"] and sig["iterations"] >= int(res.iterations)
    assert sig["output"] == [("all_gather", 1, 64)]
    assert collectives.iter_counts(sig) == {"ppermute": 2, "psum": 2}

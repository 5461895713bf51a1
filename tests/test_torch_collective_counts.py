"""The port's collectives an iteration against cgx's signatures
(tests/test_collective_counts.py), for every strategy and method ported.

cgx reads its signature from the traced program; the port records the
collectives that ran (cgx_torch.utils.collectives), each iteration's
list apart, on gloo worlds of 1 and 4 ranks and without a process group
(see test_torch_sharded.py for the harness). Entries are (op, fused
width, elements a launch), in program order, with cgx's names. The
reference's own pattern (cg.cc:106, 117, 135): two scalar all-reduces
and one gather of p an iteration.

No jax or cgx import at the top: the spawned ranks import this module.
"""

import functools

import numpy as np
import pytest

from cgx_torch.mats.generators import lap2d_fd, source_term
from cgx_torch.parallel import make_mesh, sharded_cg_solve
from cgx_torch.utils import collectives as C
from test_torch_sharded import cgx_mesh_size, run_world

G = 32  # 32 x 32 grid, N = 1024; the DIA halo is G
N = G * G
MAXITER = 8  # the signature is per iteration; a few suffice
WORLDS = ["none", 1, 4]
# name: (dense operator, sharded_cg_solve options)
SOLVES = {
    "reference_allgather": (True, {"strategy": "allgather"}),
    "reducescatter": (True, {"strategy": "reducescatter"}),
    "halo": (False, {"strategy": "halo"}),
    "halo_stream2d": (False, {"strategy": "halo", "local_kernel": "stream2d"}),
    "halo_jacobi": (False, {"strategy": "halo", "precond": "jacobi"}),
    "pipelined": (False, {"strategy": "halo", "method": "pipelined"}),
    "pipelined_jacobi": (False, {"strategy": "halo", "method": "pipelined", "precond": "jacobi"}),
    "pipelined_neumann": (False, {"strategy": "halo", "method": "pipelined",
                                  "precond": "neumann"}),
    "dia_allgather": (False, {"strategy": "allgather"}),
    "halo_block_jacobi": (False, {"strategy": "halo", "precond": "block_jacobi",
                                  "precond_block_size": 16}),
    "halo_chebyshev": (False, {"strategy": "halo", "precond": "chebyshev"}),
    "dense_ozaki": (True, {"strategy": "allgather", "dense_fp64": "ozaki"}),
}


def _signature(name):
    dense, kw = SOLVES[name]
    dia = lap2d_fd(G)
    with C.capture() as cap:
        sharded_cg_solve(dia.to_dense() if dense else dia, source_term(N),
                         mesh=make_mesh(device="cpu"), maxiter=MAXITER, **kw)
    return cap.signature()


def case_signatures():
    return {name: _signature(name) for name in SOLVES}


# the methods whose iterations differ by a cadence: cgx records the
# cadence's collectives under lax.cond ("[cond]"), the port those that ran
CADENCE = 4
BOUNDS = (0.0183, 7.99)  # lap2d_fd(32)'s spectrum, widened
COND_SOLVES = {
    "gvpipe": {"strategy": "halo", "method": "gvpipe", "gv_replace_every": CADENCE},
    "gvpipe_jacobi": {"strategy": "halo", "method": "gvpipe", "precond": "jacobi",
                      "gv_replace_every": CADENCE},
    "chebyshev_method": {"strategy": "halo", "method": "chebyshev", "bounds": BOUNDS,
                         "check_every": CADENCE},
}


def case_iteration_lists():
    """Every iteration's collectives, for the cadence methods."""
    out = {}
    for name, kw in COND_SOLVES.items():
        with C.capture() as cap:
            sharded_cg_solve(lap2d_fd(G), source_term(N), mesh=make_mesh(device="cpu"),
                             maxiter=MAXITER, tol=0.0, **kw)
        out[name] = [list(it) for it in cap.programs[-1].iters]
    return out


# the single-RHS half of ROADMAP A14: name -> (solve, its arguments)
G_FUSED = 128  # the fused route's shards must tile cgx's planes (tests/test_sstep_fused.py)
G_MG = 64
S = 4


def _a14_solves():
    from cgx_torch.mats.containers import DIAMatrix
    from cgx_torch.mats.generators import lap2d_fd_coo_lower
    from cgx_torch.parallel import sharded_mg_cg_solve, sharded_refine_fixed_sweeps
    from cgx_torch.parallel.tw_sharded import sharded_tw_solve

    mesh = make_mesh(device="cpu")
    sstep = dict(mesh=mesh, strategy="halo", method="sstep", sstep_s=S, maxiter=MAXITER)
    return {
        "sstep": lambda: sharded_cg_solve(lap2d_fd(G), source_term(N), **sstep),
        "sstep_deephalo": lambda: sharded_cg_solve(lap2d_fd(G), source_term(N),
                                                   sstep_powers="deephalo", **sstep),
        "sstep_fused": lambda: sharded_cg_solve(
            lap2d_fd(G_FUSED), np.ones(G_FUSED ** 2, np.float32), sstep_powers="fused",
            sstep_bands_dtype=None, **sstep),
        "refine": lambda: sharded_refine_fixed_sweeps(lap2d_fd(G), source_term(N), mesh=mesh),
        "mg": lambda: sharded_mg_cg_solve(lap2d_fd(G_MG), source_term(G_MG ** 2), mesh=mesh,
                                          tol=1e-8),
        "tw": lambda: sharded_tw_solve(
            DIAMatrix.from_coo(lap2d_fd_coo_lower(16)),
            np.random.default_rng(0).standard_normal(256), mesh=mesh, sweeps=4,
            inner_maxiter=8, precond=None),
    }


def case_a14_programs():
    """Each A14 solve's record: its set-up and every iteration's list (a
    block of the s-step, a sweep of the refinements, an iteration of MG)."""
    out = {}
    for name, solve in _a14_solves().items():
        with C.capture() as cap:
            solve()
        prog = cap.programs[-1]
        out[name] = {"setup": list(prog.setup), "iters": [list(it) for it in prog.iters]}
    return out


# the multi-RHS half of ROADMAP A14: name -> its solve
S_BLOCK = 3  # cgx's block signature test: (3s)^2 = 81 elements
K_DEFL = 8
G_MGB = 64


def _multi_rhs_inputs():
    rng = np.random.default_rng(0)
    w4 = np.linalg.qr(rng.standard_normal((N, 4)))[0]
    bb = rng.standard_normal((N, S_BLOCK))
    w8 = np.linalg.qr(np.random.default_rng(0).standard_normal((N, K_DEFL)))[0]
    bmg = np.random.default_rng(1).standard_normal((G_MGB ** 2, 2))
    bat = np.random.default_rng(0).standard_normal((4, N))
    return w4, bb, w8, bmg, bat


def _multi_rhs_solves():
    import torch.distributed as dist

    from cgx_torch.parallel import (
        make_mesh2d,
        sharded_block_cg_solve,
        sharded_block_deflated_cg_solve,
        sharded_cg_solve_batched,
        sharded_cg_solve_harvest,
        sharded_deflated_cg_solve,
        sharded_mg_block_cg_solve,
    )

    mesh = make_mesh(device="cpu")
    w4, bb, w8, bmg, bat = _multi_rhs_inputs()
    dia, b = lap2d_fd(G), source_term(N)
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = (2, 2) if world == 4 else (1, 1)
    out = {
        "block": lambda: sharded_block_cg_solve(dia, bb, mesh=mesh, maxiter=MAXITER),
        "deflated": lambda: sharded_deflated_cg_solve(dia, b, w=w4, mesh=mesh, maxiter=MAXITER),
        "deflated_plain8": lambda: sharded_deflated_cg_solve(dia, b, w=w8, mesh=mesh, tol=1e-8,
                                                             maxiter=MAXITER),
        "deflated_pcg": lambda: sharded_deflated_cg_solve(dia, b, w=w8, mesh=mesh, tol=1e-8,
                                                          precond="jacobi", maxiter=MAXITER),
        "block_deflated": lambda: sharded_block_deflated_cg_solve(dia, bb, w=w4, mesh=mesh,
                                                                  maxiter=MAXITER),
        "harvest": lambda: sharded_cg_solve_harvest(dia, b, k=8, mesh=mesh, strategy="halo",
                                                    tol=1e-10, maxiter=MAXITER, strict=False),
        "mg_block": lambda: sharded_mg_block_cg_solve(lap2d_fd(G_MGB), bmg, mesh=mesh, tol=1e-8,
                                                      maxiter=MAXITER),
    }
    for pc in ("jacobi", "neumann", "chebyshev"):
        out[f"block_{pc}"] = functools.partial(sharded_block_cg_solve, dia, bb, mesh=mesh,
                                               maxiter=MAXITER, precond=pc, bounds=BOUNDS)
    mesh2d = make_mesh2d(*shape, device="cpu")  # every rank makes it, and every time
    for method in ("pipelined", "gvpipe"):
        out[f"batched_{method}"] = functools.partial(
            sharded_cg_solve_batched, dia, bat, mesh=mesh2d, method=method, maxiter=MAXITER,
            tol=0.0, gv_replace_every=CADENCE)
    return out


def case_multi_rhs_programs():
    """Each multi-RHS solve's record: its set-up, every iteration's list
    and its output."""
    out = {}
    for name, solve in _multi_rhs_solves().items():
        with C.capture() as cap:
            solve()
        prog = cap.programs[-1]
        out[name] = {"setup": list(prog.setup), "iters": [list(it) for it in prog.iters],
                     "output": list(prog.output)}
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"world{world}")), world, __name__,
                          ["case_signatures", "case_iteration_lists", "case_a14_programs",
                           "case_multi_rhs_programs"])
        for other in ranks[1:]:  # a program-level signature: the same on every rank
            assert other == ranks[0]
        return {**ranks[0]["case_signatures"], **ranks[0]["case_iteration_lists"],
                **ranks[0]["case_a14_programs"],
                **{f"mrhs_{k}": v for k, v in ranks[0]["case_multi_rhs_programs"].items()}}

    return run


@functools.lru_cache(maxsize=None)
def cgx_signature(p: int, name: str):
    from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.sharded_cg import sharded_cg_solve as cgx_sharded
    from cgx.utils import collectives as cgx_c

    dense, kw = SOLVES[name]
    dia = cgx_lap2d_fd(G)
    with cgx_c.capture() as cap:
        cgx_sharded(np.asarray(dia.to_dense()) if dense else dia, source_term(N),
                    mesh=cgx_mesh(p), maxiter=MAXITER, **kw)
    return cap.signature()


def _iter(port, world, name):
    sig = port(world)[name]
    assert sig["uniform"] and sig["iterations"] >= MAXITER, sig
    return sig["iter"]


# cgx records the reference loop's <r, r> and <r, z> psums, which XLA's
# combiner launches as one, at the first one's place, before the
# preconditioner's halos; the port's one all-reduce runs once z is there
# (ROADMAP.md §C): the same collectives, in another order
AFTER_PRECOND = {"halo_chebyshev"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(SOLVES))
def test_iteration_signature_equals_cgx(port, world, name):
    want = cgx_signature(cgx_mesh_size(world), name)
    if name in AFTER_PRECOND:
        assert sorted(_iter(port, world, name)) == sorted(want["iter"])
    else:
        assert _iter(port, world, name) == want["iter"]


@pytest.mark.parametrize("world", WORLDS)
def test_reference_allgather_comm_parity(port, world):
    """One gather of the whole p (cg.cc:135) and two separate scalar
    all-reduces (cg.cc:106, 117); set-up: gather p0 and the rsold
    all-reduce (cg.cc:87-92); the result's gather apart."""
    sig = port(world)["reference_allgather"]
    assert _iter(port, world, "reference_allgather") == [
        ("all_gather", 1, N), ("psum", 1, 1), ("psum", 1, 1)]
    assert sig["setup"] == [("all_gather", 1, N), ("psum", 1, 1)]
    assert sig["setup"] == cgx_signature(cgx_mesh_size(world), "reference_allgather")["setup"]
    assert sig["output"] == [("all_gather", 1, N)]


@pytest.mark.parametrize("world", WORLDS)
def test_reducescatter_strategy(port, world):
    p = cgx_mesh_size(world)
    assert _iter(port, world, "reducescatter") == [
        ("reduce_scatter", 1, N // p), ("psum", 1, 1), ("psum", 1, 1)]


@pytest.mark.parametrize("world", WORLDS)
def test_halo_strategy_bandwidth_not_n(port, world):
    assert _iter(port, world, "halo") == [
        ("ppermute", 1, G), ("ppermute", 1, G), ("psum", 1, 1), ("psum", 1, 1)]


@pytest.mark.parametrize("world", WORLDS)
def test_halo_stream2d_same_signature(port, world):
    sig, sig_st = port(world)["halo"], port(world)["halo_stream2d"]
    assert sig_st["iter"] == sig["iter"] and sig_st["setup"] == sig["setup"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,width", [("pipelined", 2), ("pipelined_jacobi", 3),
                                        ("pipelined_neumann", 3)])
def test_pipelined_one_fused_psum(port, world, name, width):
    """Chronopoulos-Gear: ONE all-reduce an iteration carrying two dots,
    three with a preconditioner; Neumann adds its mat-vec's halo."""
    halo = [("ppermute", 1, G), ("ppermute", 1, G)]
    extra = halo if name == "pipelined_neumann" else []
    assert _iter(port, world, name) == [("psum", 1, width)] + extra + halo


@pytest.mark.parametrize("world", WORLDS)
def test_block_jacobi_same_signature_as_jacobi(port, world):
    """Block-Jacobi's apply is a shard-local batched product (no block
    straddles a shard), so its collectives are point Jacobi's, an
    iteration and at set-up (tests/test_collective_counts.py::
    test_block_jacobi_same_signature_as_jacobi)."""
    bj, pj = port(world)["halo_block_jacobi"], port(world)["halo_jacobi"]
    assert _iter(port, world, "halo_block_jacobi") == pj["iter"]
    assert bj["setup"] == pj["setup"]


@pytest.mark.parametrize("world", WORLDS)
def test_chebyshev_precond_adds_three_halo_matvecs(port, world):
    """The degree-3 polynomial costs three more strategy mat-vecs an
    iteration (their halos) and no reduction."""
    halo = [("ppermute", 1, G), ("ppermute", 1, G)]
    assert _iter(port, world, "halo_chebyshev") == halo + [("psum", 1, 1)] + halo * 3 + [
        ("psum", 2, 2)]


@pytest.mark.parametrize("world", WORLDS)
def test_dense_ozaki_same_signature_as_allgather(port, world):
    """The Ozaki shards gather p as the fp64 dense route does: one
    all_gather and two scalar psums an iteration."""
    assert _iter(port, world, "dense_ozaki") == _iter(port, world, "reference_allgather")


@functools.lru_cache(maxsize=None)
def cgx_cond_signature(p: int, name: str):
    from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.sharded_cg import sharded_cg_solve as cgx_sharded
    from cgx.utils import collectives as cgx_c

    with cgx_c.capture() as cap:
        cgx_sharded(cgx_lap2d_fd(G), source_term(N), mesh=cgx_mesh(p), maxiter=MAXITER,
                    **COND_SOLVES[name])
    return cap.signature()


def _split_cond(sig):
    """cgx's iteration list as (unconditional, under lax.cond), the
    latter with cgx's "[cond]" mark taken off."""
    uncond = [e for e in sig["iter"] if "[cond]" not in e[0]]
    cond = [(e[0].replace("[cond]", ""),) + tuple(e[1:]) for e in sig["iter"] if "[cond]" in e[0]]
    return uncond, cond


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["gvpipe", "gvpipe_jacobi"])
def test_gvpipe_one_fused_psum_and_cadence_replacement(port, world, name):
    """Ghysels-Vanroose: one fused all-reduce an iteration (of two dots,
    three with a preconditioner), its mat-vec's halos after it, as cgx's
    unconditional list; on the replacement cadence the four mat-vecs of
    the replacement (cgx's eight [cond] ppermutes) run before them."""
    uncond, cond = _split_cond(cgx_cond_signature(cgx_mesh_size(world), name))
    assert uncond[0] == ("psum", 1, 3 if name.endswith("jacobi") else 2)
    assert cond == [("ppermute", 1, G)] * 8
    iters = port(world)[name]
    assert len(iters) == MAXITER
    for i, got in enumerate(iters):
        assert got == (cond + uncond if i and i % CADENCE == 0 else uncond), (i, got)


@pytest.mark.parametrize("world", WORLDS)
def test_chebyshev_method_reduces_every_check_every(port, world):
    """The Chebyshev iteration: its mat-vec's halos only, and one
    all-reduce of one dot on every check_every-th iteration (cgx's psum
    under lax.cond)."""
    uncond, cond = _split_cond(cgx_cond_signature(cgx_mesh_size(world), "chebyshev_method"))
    assert uncond == [("ppermute", 1, G)] * 2 and cond == [("psum", 1, 1)]
    iters = port(world)["chebyshev_method"]
    assert len(iters) == MAXITER
    for i, got in enumerate(iters):
        assert got == (uncond + cond if (i + 1) % CADENCE == 0 else uncond), (i, got)


# ---------------------------------------------------------------------------
# The single-RHS half of ROADMAP A14: the sharded s-step, refinement, MG-PCG
# and triple-word sweeps against cgx's signatures
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cgx_a14_signature(p: int, name: str):
    from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.mg_sharded import sharded_mg_cg_solve as cgx_mg
    from cgx.parallel.sharded_cg import sharded_cg_solve as cgx_sharded
    from cgx.parallel.sharded_cg import sharded_refine_fixed_sweeps as cgx_refine

    mesh = cgx_mesh(p)
    sstep = dict(mesh=mesh, strategy="halo", method="sstep", sstep_s=S, maxiter=MAXITER)
    solves = {
        "sstep": lambda: cgx_sharded(cgx_lap2d_fd(G), source_term(N), **sstep),
        "sstep_deephalo": lambda: cgx_sharded(cgx_lap2d_fd(G), source_term(N),
                                              sstep_powers="deephalo", **sstep),
        "sstep_fused": lambda: cgx_sharded(cgx_lap2d_fd(G_FUSED),
                                           np.ones(G_FUSED ** 2, np.float32),
                                           sstep_powers="fused", sstep_bands_dtype=None, **sstep),
        "refine": lambda: cgx_refine(cgx_lap2d_fd(G), source_term(N), mesh=mesh),
        "mg": lambda: cgx_mg(cgx_lap2d_fd(G_MG), source_term(G_MG ** 2), mesh=mesh, tol=1e-8),
    }
    if name == "tw":  # cgx's tw solve is not recorded: its loop's jaxpr, as cgx's test reads it
        return _cgx_tw_signature(mesh)
    return _cgx_traced_signature(solves[name])


class _Traced(Exception):
    """Raised by the stand-in for cgx's run_recorded once it holds the program."""


def _cgx_traced_signature(solve):
    """cgx's collective signature of the program ``solve`` runs, as
    ``capture().signature()`` reads it (collective_signature of the
    recorded program and arguments), from the trace alone: cgx's
    run_recorded, which records the program and then runs it, is replaced
    by one that records it and stops, so that the interpret-mode kernels
    of the fused route are traced, not compiled and run."""
    import cgx.parallel.mg_sharded as cgx_mg
    import cgx.parallel.sharded_cg as cgx_sc
    from cgx.utils.collectives import collective_signature

    seen = []

    def record_only(fn, *args):
        seen.append((fn, args))
        raise _Traced

    import cgx.parallel.batched2d as cgx_b2d

    with pytest.MonkeyPatch.context() as mp:
        for mod in (cgx_sc, cgx_mg, cgx_b2d):
            mp.setattr(mod, "run_recorded", record_only)
        with pytest.raises(_Traced):
            solve()
    fn, args = seen[0]
    return collective_signature(fn, *args)


def _cgx_tw_signature(mesh):
    """cgx's tw loop traced on ``mesh`` (tests/test_tw_sharded.py:113-147):
    the plain halo CG inner, four sweeps of eight inner iterations."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cgx.mats.containers import DIAMatrix as CgxDia
    from cgx.mats.generators import lap2d_fd_coo_lower as cgx_coo
    from cgx.parallel.sharded_cg import _DiaHalo, _PsumDot
    from cgx.parallel.tw_sharded import _tw_sharded_loop
    from cgx.utils.collectives import collective_signature

    mat = CgxDia.from_coo(cgx_coo(16))
    p = mesh.devices.size
    offsets = tuple(int(o) for o in mat.offsets)
    bands32 = jnp.asarray(mat.bands, jnp.float32)
    loop = functools.partial(
        _tw_sharded_loop, offsets=offsets, sweeps=4, inner_tol=1e-6, inner_maxiter=8,
        matvec=_DiaHalo("rows", offsets, 256 // p, p), precond=None,
        dot=_PsumDot("rows", None), axis="rows", n_shards=p)
    fn = jax.shard_map(loop, mesh=mesh, in_specs=(P(None, "rows"), P(None, "rows"), P("rows"), P()),
                       out_specs=(P(None, "rows"), P(), P(), P(), P()), check_vma=False)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(256))
    return collective_signature(fn, bands32, bands32, b, jnp.asarray(1e-10))


def _uniform_iter(prog):
    first = prog["iters"][0]
    assert all(it == first for it in prog["iters"]), prog["iters"]
    return first


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["sstep", "sstep_deephalo"])
def test_sstep_block_signature_equals_cgx(port, world, name):
    """s-step: one (2s+1)^2 Gram all-reduce a block (tests/test_collective_
    counts.py:335); the basis from 2s-1 halo'd mat-vecs, or with
    "deephalo" from two exchanges of depth s h carrying p and r together
    (:452), its band halos once, at set-up."""
    prog = port(world)[name]
    want = cgx_a14_signature(cgx_mesh_size(world), name)
    assert _uniform_iter(prog) == want["iter"]
    assert [e for e in want["iter"] if e[0] == "psum"] == [("psum", 1, (2 * S + 1) ** 2)]
    assert sorted(prog["setup"]) == sorted(want["setup"])
    if name == "sstep_deephalo":
        assert want["iter"][:2] == [("ppermute", 1, 2 * S * G)] * 2


@pytest.mark.parametrize("world", WORLDS)
def test_sstep_fused_signature_equals_cgx(port, world):
    """The fused route a block: the two stacked exchanges of cgx's
    (tests/test_sstep_fused.py:200) and one all-reduce of the float64 Gram,
    (m, m) where cgx sums its (2, m, m) double-float32 pair (ROADMAP.md
    §C); at set-up the band and x0 edges (4 exchanges), the max of the
    prescale (recorded as pmax, which cgx's record omits) and ||r0||^2."""
    prog = port(world)["sstep_fused"]
    want = cgx_a14_signature(cgx_mesh_size(world), "sstep_fused")
    got = _uniform_iter(prog)
    m = 2 * S + 1
    assert [e for e in got if e[0] == "ppermute"] == [e for e in want["iter"]
                                                      if e[0] == "ppermute"]
    assert [e for e in got if e[0] != "ppermute"] == [("psum", 1, m * m)]
    assert [e for e in want["iter"] if e[0] != "ppermute"] == [("psum", 1, 2 * m * m)]
    assert sorted(e for e in prog["setup"] if e[0] == "ppermute") == sorted(
        e for e in want["setup"] if e[0] == "ppermute")
    assert [e for e in prog["setup"] if e[0] != "ppermute"] == [("pmax", 1, 1), ("psum", 1, 1)]


@pytest.mark.parametrize("world", WORLDS)
def test_refine_sweep_signature(port, world):
    """Mixed refinement (tests/test_collective_counts.py:395): every
    all-reduce is of one scalar, as cgx's; a sweep ends with the fp64
    mat-vec's halos and the one all-reduce of ||r||^2, and carries the
    fp32 inner's collectives, cgx's set of them."""
    prog = port(world)["refine"]
    want = cgx_a14_signature(cgx_mesh_size(world), "refine")
    assert all(e[2] == 1 for e in want["iter"] if e[0] == "psum")
    for sweep in prog["iters"]:
        assert all(e[2] == 1 for e in sweep if e[0] == "psum")
        assert sweep[-3:] == [("ppermute", 1, G), ("ppermute", 1, G), ("psum", 1, 1)]
        assert set(sweep) == set(want["iter"])


@pytest.mark.parametrize("world", WORLDS)
def test_mg_iteration_signature_equals_cgx(port, world):
    """MG-PCG (tests/test_collective_counts.py:406): the CG dots (the
    conjugacy dot, then <r, r> and <r, z> as one), the one tail gather, and
    cgx's count and volume of neighbour halos an iteration."""
    got = _uniform_iter(port(world)["mg"])
    want = cgx_a14_signature(cgx_mesh_size(world), "mg")["iter"]
    assert [e for e in got if e[0] == "psum"] == [("psum", 1, 1), ("psum", 2, 2)]
    for op in ("psum", "all_gather"):
        assert [e for e in got if e[0] == op] == [e for e in want if e[0] == op]
    halos = [e for e in got if e[0] == "ppermute"]
    want_halos = [e for e in want if e[0] == "ppermute"]
    assert len(halos) == len(want_halos) and sum(e[2] for e in halos) == sum(
        e[2] for e in want_halos)


@pytest.mark.parametrize("world", WORLDS)
def test_tw_sweep_signature(port, world):
    """Triple-word sweeps (tests/test_tw_sharded.py:113): a sweep's outer
    product exchanges the three words stacked (2 exchanges of 3h) and
    gathers the fp64 residual view once for the ordered norm; the inner
    adds its all-reduces and halos: cgx's kinds of collective."""
    prog = port(world)["tw"]
    want = cgx_a14_signature(cgx_mesh_size(world), "tw")
    h = 16
    for sweep in prog["iters"]:
        assert sweep[-3:] == [("ppermute", 1, 3 * h), ("ppermute", 1, 3 * h),
                              ("all_gather", 1, 256)]
        assert {e[0] for e in sweep} == {e[0] for e in want["iter"]} == {
            "ppermute", "psum", "all_gather"}


# ---------------------------------------------------------------------------
# The multi-RHS half of ROADMAP A14: the block, deflated, block-deflated and
# harvest solves, the 2-D batched mesh and block MG-PCG against cgx's traces
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cgx_multi_rhs_signature(p: int, name: str):
    from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
    from cgx.parallel.batched2d import make_mesh2d as cgx_mesh2d
    from cgx.parallel.batched2d import sharded_cg_solve_batched as cgx_batched
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.mg_sharded import sharded_mg_block_cg_solve as cgx_mg_block
    from cgx.parallel.sharded_cg import (
        sharded_block_cg_solve as cgx_block,
        sharded_block_deflated_cg_solve as cgx_block_defl,
        sharded_cg_solve_harvest as cgx_harvest,
        sharded_deflated_cg_solve as cgx_defl,
    )

    mesh = cgx_mesh(p)
    w4, bb, w8, bmg, bat = _multi_rhs_inputs()
    dia, b = cgx_lap2d_fd(G), source_term(N)
    solves = {
        "block": lambda: cgx_block(dia, bb, mesh=mesh, maxiter=MAXITER),
        "deflated": lambda: cgx_defl(dia, b, w=w4, mesh=mesh, maxiter=MAXITER),
        "deflated_plain8": lambda: cgx_defl(dia, b, w=w8, mesh=mesh, tol=1e-8, maxiter=MAXITER),
        "deflated_pcg": lambda: cgx_defl(dia, b, w=w8, mesh=mesh, tol=1e-8, precond="jacobi",
                                         maxiter=MAXITER),
        "block_deflated": lambda: cgx_block_defl(dia, bb, w=w4, mesh=mesh, maxiter=MAXITER),
        "harvest": lambda: cgx_harvest(dia, b, k=8, mesh=mesh, strategy="halo", tol=1e-10,
                                       maxiter=MAXITER, strict=False),
        "mg_block": lambda: cgx_mg_block(cgx_lap2d_fd(G_MGB), bmg, mesh=mesh, tol=1e-8,
                                         maxiter=MAXITER),
    }
    for pc in ("jacobi", "neumann", "chebyshev"):
        solves[f"block_{pc}"] = functools.partial(cgx_block, dia, bb, mesh=mesh,
                                                  maxiter=MAXITER, precond=pc, bounds=BOUNDS)
    shape = (2, 2) if p == 4 else (1, 1)
    for method in ("pipelined", "gvpipe"):
        solves[f"batched_{method}"] = functools.partial(
            cgx_batched, dia, bat, mesh=cgx_mesh2d(*shape), method=method, maxiter=MAXITER,
            tol=0.0, gv_replace_every=CADENCE)
    return _cgx_traced_signature(solves[name])


def _mrhs_iter(port, world, name):
    prog = port(world)[f"mrhs_{name}"]
    assert prog["iters"], name
    return _uniform_iter(prog)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["block", "block_jacobi", "block_neumann", "block_chebyshev",
                                  "deflated", "deflated_plain8", "deflated_pcg",
                                  "block_deflated"])
def test_multi_rhs_iteration_equals_cgx(port, world, name):
    """Block CG: the halo pair of G s elements for the whole block and ONE
    (3s)^2 Gram all-reduce (tests/test_collective_counts.py:357); a
    preconditioner adds its applies and the (3s, s) strip's one all-reduce.
    Deflated CG: the conjugacy dot, the fused (2k,) [W, AW]^T r and <r, r>
    (:371); deflated PCG the guard's (k,) and ONE launch of width 3 and
    k + 2 elements for <r, z>, <r, r> and (AW)^T z (:496). Block-deflated
    CG: three all-reduces (:384)."""
    got = _mrhs_iter(port, world, name)
    want = cgx_multi_rhs_signature(cgx_mesh_size(world), name)["iter"]
    assert got == want
    s, k = S_BLOCK, K_DEFL
    psums = [e for e in got if e[0] == "psum"]
    if name == "block":
        assert got == [("ppermute", 1, G * s)] * 2 + [("psum", 1, (3 * s) ** 2)]
    elif name.startswith("block_") and name != "block_deflated":
        assert psums == [("psum", 1, (3 * s) ** 2), ("psum", 1, 3 * s * s)]
    elif name == "deflated":
        assert psums == [("psum", 1, 1), ("psum", 1, 8), ("psum", 1, 1)]
    elif name == "deflated_plain8":
        assert psums == [("psum", 1, 1), ("psum", 1, 2 * k), ("psum", 1, 1)]
    elif name == "deflated_pcg":
        assert psums == [("psum", 1, 1), ("psum", 1, k), ("psum", 3, k + 2)]
    else:
        assert len(psums) == 3


@pytest.mark.parametrize("world", WORLDS)
def test_harvest_adds_zero_collectives(port, world):
    """The harvest's iteration is the plain reference solve's (the window
    is captured locally, tests/test_collective_counts.py:479); the window's
    one gather follows the gather of x, after the loop."""
    got = _mrhs_iter(port, world, "harvest")
    assert got == _iter(port, world, "halo")
    assert got == cgx_multi_rhs_signature(cgx_mesh_size(world), "harvest")["iter"]
    out = port(world)["mrhs_harvest"]["output"]
    assert [e[0] for e in out] == ["all_gather", "all_gather"] and out[0] == ("all_gather", 1, N)


@pytest.mark.parametrize("world", WORLDS)
def test_mg_block_iteration_equals_cgx(port, world):
    """Block MG-PCG: cgx vmaps its cycle over the columns, and its trace
    shows one batched message a halo and one tail gather for the whole
    block (not s chains); the port's cycle takes the block: the same
    collectives, count and volume, and the two Gram all-reduces."""
    got = _mrhs_iter(port, world, "mg_block")
    want = cgx_multi_rhs_signature(cgx_mesh_size(world), "mg_block")["iter"]
    s = 2
    assert [e for e in got if e[0] == "psum"] == [("psum", 1, (3 * s) ** 2),
                                                  ("psum", 1, 3 * s * s)]
    for op in ("psum", "all_gather"):
        assert [e for e in got if e[0] == op] == [e for e in want if e[0] == op]
    halos = [e for e in got if e[0] == "ppermute"]
    want_halos = [e for e in want if e[0] == "ppermute"]
    assert len(halos) == len(want_halos) and sum(e[2] for e in halos) == sum(
        e[2] for e in want_halos)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", ["pipelined", "gvpipe"])
def test_batched2d_signature_equals_cgx(port, world, method):
    """The 2-D mesh ((2 x 2) on four ranks, (1 x 1) else), each iteration:
    the vote over rhs, then pipelined's ONE all-reduce of every local
    column's two dots (tests/test_collective_counts.py:432); gvpipe's
    replacement vote too, and on the cadence the replacement's four
    mat-vecs (cgx's eight [cond] ppermutes) before the dots (:521). The
    loop's exit test, cgx's condition past its last body, is set-up."""
    iters = port(world)[f"mrhs_batched_{method}"]["iters"]
    uncond, cond = _split_cond(cgx_multi_rhs_signature(cgx_mesh_size(world),
                                                       f"batched_{method}"))
    r_loc = 4 // (2 if world == 4 else 1)
    assert [e for e in uncond if e[0] == "psum"][-1] == ("psum", 1, 2 * r_loc)
    assert len(iters) == 32  # MAXITER live, then frozen up to the host's first read
    for i, got in enumerate(iters):
        want = uncond[:2] + cond + uncond[2:] if cond and i and i % CADENCE == 0 else uncond
        assert got == want, (i, got, want)
    if method == "gvpipe":
        assert len(cond) == 8 and sorted(e[2] for e in uncond if e[0] == "psum") == [
            1, 1, 2 * r_loc]

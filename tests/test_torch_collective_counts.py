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


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"world{world}")), world, __name__,
                          ["case_signatures"])
        for other in ranks[1:]:  # a program-level signature: the same on every rank
            assert other == ranks[0]
        return ranks[0]["case_signatures"]

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


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(SOLVES))
def test_iteration_signature_equals_cgx(port, world, name):
    want = cgx_signature(cgx_mesh_size(world), name)
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

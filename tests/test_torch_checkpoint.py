"""Checkpoint and resume of the port (cgx_torch.utils.checkpoint) against
cgx's (cgx/utils/checkpoint.py; tests/test_utils.py:48-167).

Within the port an interrupted and resumed solve is the uninterrupted
one bit for bit; across the packages a checkpoint written by either is
resumed by the other on cgx's trajectory (equal k, x within 1e-13 in
fp64). The sharded entry runs on a two-rank gloo world (the harness of
test_torch_sharded.py), and in this process as a world of one rank, and
its checkpoints cross with the single-device solve both ways; its
collectives an iteration are cgx's, read from cgx's traced segment.

No jax or cgx import at the top: the spawned ranks import this module.
"""

import functools
import os
import shutil
import types

import numpy as np
import pytest
import torch

from cgx_torch.mats.generators import lap2d_fd, lap2d_reference, source_term
from cgx_torch.parallel import make_mesh
from cgx_torch.solver.operators import as_operator
from cgx_torch.utils import collectives as C
from cgx_torch.utils.checkpoint import (
    CGCheckpoint,
    cg_solve_resumable,
    segment_loop,
    sharded_cg_solve_resumable,
)
from test_torch_sharded import run_world

N = 256  # lap2d_reference(256), cgx's test size
TOL = 1e-8
XTOL = 1e-13  # x against cgx's, relative to max |x| (fp64)
SIG_ITERS = 8
CKPT_DIR = "CGX_TORCH_TEST_CHECKPOINT_DIR"  # where the spawned ranks find the test's files


def _op(n=N, dtype=torch.float64):
    return as_operator(lap2d_reference(n), dtype, device="cpu")


def _b(n=N, dtype=np.float64):
    return source_term(n).astype(dtype)


@functools.lru_cache(maxsize=None)
def _straight(tmp_root: str, dtype=torch.float64):
    """The uninterrupted port solve (one segment)."""
    return cg_solve_resumable(_op(dtype=dtype), _b(dtype=np.dtype(str(dtype)[6:])),
                              os.path.join(tmp_root, f"straight_{dtype}.npz"), tol=TOL,
                              segment=1000, device="cpu")


# ---------------------------------------------------------------------------
# Single device, within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("segments", [(40, 20, 50), (33, 7, 64), (64, 32, 31)])
def test_interrupted_resume_is_bitwise_uninterrupted(tmp_path, dtype, segments):
    """Stopped at k0 (segments of s1), resumed in segments of s2: the same
    k, x, r, p and rsold bit for bit, whatever the chunks of 32."""
    k0, s1, s2 = segments
    tol = TOL if dtype == torch.float64 else 1e-5
    op, b = _op(dtype=dtype), _b(dtype=np.dtype(str(dtype)[6:]))
    straight = cg_solve_resumable(op, b, tmp_path / "s.npz", tol=tol, segment=1000,
                                  device="cpu")
    path = tmp_path / "c.npz"
    first = cg_solve_resumable(op, b, path, tol=tol, maxiter=k0, segment=s1, device="cpu")
    assert int(first.iterations) == k0 and not bool(first.converged)
    ck = CGCheckpoint.load(path)
    assert ck.k == k0 and ck.x.dtype == np.dtype(str(dtype)[6:])
    resumed = cg_solve_resumable(op, b, path, tol=tol, segment=s2, device="cpu")
    assert bool(resumed.converged) and bool(straight.converged)
    assert int(resumed.iterations) == int(straight.iterations)
    assert torch.equal(resumed.x, straight.x)
    assert torch.equal(resumed.rsold, straight.rsold)
    end, full = CGCheckpoint.load(path), CGCheckpoint.load(tmp_path / "s.npz")
    for name in ("x", "r", "p"):
        np.testing.assert_array_equal(getattr(end, name), getattr(full, name))
    assert (end.rsold, end.k) == (full.rsold, full.k)


def test_segment_freezes_after_convergence():
    """A segment that converges inside a chunk of 32 keeps x, r, p and
    rsold from the converging iteration, and k counts the live ones:
    budget 100 and budget k + 1 give the same state bit for bit."""
    op, b = _op(), torch.as_tensor(_b())
    x = torch.zeros_like(b)
    r = b - op.matvec(x)
    rsold = torch.sum(r * r)
    args = (op, x, r, r, rsold, torch.tensor(TOL, dtype=torch.float64),
            torch.tensor(1e-14, dtype=torch.float64))
    long = segment_loop(*args, budget=1000)
    k = int(long[0])
    assert bool(long[6]) and 32 < k < 1000
    short = segment_loop(*args, budget=k + 1)
    assert bool(short[6]) and int(short[0]) == k
    for u, v in zip(long, short):
        assert torch.equal(u, v)


def test_atomic_save_load(tmp_path):
    ck = CGCheckpoint(x=np.arange(4.0), r=np.ones(4), p=np.zeros(4), rsold=2.5, k=7)
    path = tmp_path / "ck.npz"
    ck.save(path)
    back = CGCheckpoint.load(path)
    np.testing.assert_array_equal(back.x, ck.x)
    assert back.rsold == 2.5 and back.k == 7
    assert os.listdir(tmp_path) == ["ck.npz"]  # the temporary name is gone
    with np.load(path) as z:
        assert sorted(z.files) == ["k", "p", "r", "rsold", "x"]


def test_save_is_cgx_format_both_ways(tmp_path):
    """Each package loads the other's file, key for key and dtype for dtype."""
    from cgx.utils.checkpoint import CGCheckpoint as CgxCheckpoint

    x = np.linspace(0, 1, 5, dtype=np.float32)
    CGCheckpoint(x=x, r=2 * x, p=3 * x, rsold=0.125, k=9).save(tmp_path / "port.npz")
    CgxCheckpoint(x=x, r=2 * x, p=3 * x, rsold=0.125, k=9).save(tmp_path / "cgx.npz")
    for ours, theirs in ((CGCheckpoint.load(tmp_path / "cgx.npz"),
                          CgxCheckpoint.load(tmp_path / "cgx.npz")),
                         (CgxCheckpoint.load(tmp_path / "port.npz"),
                          CGCheckpoint.load(tmp_path / "port.npz"))):
        for name in ("x", "r", "p"):
            a, c = getattr(ours, name), getattr(theirs, name)
            assert a.dtype == c.dtype == np.float32
            np.testing.assert_array_equal(a, c)
        assert (ours.rsold, ours.k) == (theirs.rsold, theirs.k) == (0.125, 9)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cgx_straight(tmp_root: str):
    import jax.numpy as jnp

    import cgx
    from cgx.utils.checkpoint import cg_solve_resumable as cgx_resumable

    op = cgx.DiaOperator.from_host(cgx.lap2d_reference(N))
    res = cgx_resumable(op, jnp.asarray(_b()), os.path.join(tmp_root, "cgx_straight.npz"),
                        tol=TOL, segment=1000)
    return int(res.iterations), np.asarray(res.x)


def _cgx_resumable(path, **kw):
    import jax.numpy as jnp

    import cgx
    from cgx.utils.checkpoint import cg_solve_resumable as cgx_resumable

    op = cgx.DiaOperator.from_host(cgx.lap2d_reference(N))
    return cgx_resumable(op, jnp.asarray(_b()), path, tol=TOL, **kw)


def _close(x, ref, tol=XTOL) -> bool:
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref))) <= tol


def test_cgx_checkpoint_resumed_by_port(tmp_path):
    k_ref, x_ref = _cgx_straight(str(tmp_path.parent))
    path = tmp_path / "c.npz"
    first = _cgx_resumable(path, maxiter=40, segment=20)
    assert int(first.iterations) == 40
    res = cg_solve_resumable(_op(), _b(), path, tol=TOL, segment=50, device="cpu")
    assert bool(res.converged) and int(res.iterations) == k_ref
    assert _close(res.x, x_ref)


def test_port_checkpoint_resumed_by_cgx(tmp_path):
    k_ref, x_ref = _cgx_straight(str(tmp_path.parent))
    path = tmp_path / "c.npz"
    first = cg_solve_resumable(_op(), _b(), path, tol=TOL, maxiter=40, segment=20, device="cpu")
    assert int(first.iterations) == 40
    res = _cgx_resumable(path, segment=50)
    assert bool(res.converged) and int(res.iterations) == k_ref
    assert _close(res.x, x_ref)
    # and the port's own uninterrupted solve is on cgx's trajectory
    straight = _straight(str(tmp_path.parent))
    assert int(straight.iterations) == k_ref and _close(straight.x, x_ref)


def test_loaded_checkpoint_is_cast_to_b(tmp_path):
    """A float64 checkpoint resumes a float32 solve in float32, as cgx's."""
    path = tmp_path / "c.npz"
    cg_solve_resumable(_op(), _b(), path, tol=TOL, maxiter=10, segment=10, device="cpu")
    res = cg_solve_resumable(_op(dtype=torch.float32), _b(dtype=np.float32), path, tol=1e-2,
                             maxiter=12, device="cpu")
    assert res.x.dtype == torch.float32 and int(res.iterations) == 12
    assert CGCheckpoint.load(path).x.dtype == np.float32


# ---------------------------------------------------------------------------
# The sharded entry: one process a rank
# ---------------------------------------------------------------------------


def _dir() -> str:
    return os.environ[CKPT_DIR]


def _np(res):
    return {"k": int(res.iterations), "x": res.x.cpu().numpy(), "converged": bool(res.converged)}


def case_sharded():
    """Run on every rank: the sharded entry's checkpoints, stopped at 40
    and resumed, from and to the single-device files the test wrote."""
    d, mesh, dia, b = _dir(), make_mesh(device="cpu"), lap2d_reference(N), _b()
    out = {}
    # the single-device file stopped at 40, resumed on the mesh
    out["from_single"] = _np(sharded_cg_solve_resumable(
        dia, b, os.path.join(d, "single40.npz"), mesh=mesh, tol=TOL, segment=50))
    # stopped at 40 on the mesh, then resumed on it
    path = os.path.join(d, "sharded.npz")
    first = sharded_cg_solve_resumable(dia, b, path, mesh=mesh, tol=TOL, maxiter=40, segment=20)
    out["first_k"] = int(first.iterations)
    out["sharded"] = _np(sharded_cg_solve_resumable(dia, b, path, mesh=mesh, tol=TOL,
                                                    segment=50))
    # stopped at 40 on the mesh, left for the single-device solve
    sharded_cg_solve_resumable(dia, b, os.path.join(d, "sharded40.npz"), mesh=mesh, tol=TOL,
                               maxiter=40, segment=20)
    # a checkpoint of another N
    try:
        sharded_cg_solve_resumable(lap2d_reference(128), source_term(128),
                                   os.path.join(d, "sharded40.npz"), mesh=mesh, tol=TOL)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    # the collectives of a segment: its set-up, every iteration and its output
    with C.capture() as cap:
        sharded_cg_solve_resumable(lap2d_fd(32), source_term(1024),
                                   os.path.join(d, f"sig_{mesh.rank}.npz"), mesh=mesh,
                                   strategy="halo", maxiter=SIG_ITERS, segment=SIG_ITERS)
    prog = cap.programs[-1]
    out["signature"] = {"setup": list(prog.setup), "iters": [list(it) for it in prog.iters],
                        "output": list(prog.output), "start": list(cap.programs[0].setup)}
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(world):
        d = str(tmp_path_factory.mktemp(f"ckpt{world}"))
        cg_solve_resumable(_op(), _b(), os.path.join(d, "single40.npz"), tol=TOL, maxiter=40,
                           segment=20, device="cpu")
        saved = os.environ.get(CKPT_DIR)
        os.environ[CKPT_DIR] = d
        try:
            ranks = run_world(os.path.join(d, "world"), world, __name__, ["case_sharded"])
        finally:
            if saved is None:
                os.environ.pop(CKPT_DIR)
            else:
                os.environ[CKPT_DIR] = saved
        return d, [r["case_sharded"] for r in ranks]

    return run


@pytest.mark.parametrize("world", ["none", 2])
def test_sharded_resume_crosses_single_device(sharded, tmp_path, world):
    """Single-device stopped at 40 -> the mesh; the mesh stopped at 40 ->
    the mesh and -> one device: each reaches the uninterrupted k; on one
    rank bit for bit, on two within 1e-10 (its dots sum by shards)."""
    d, ranks = sharded(world)
    straight = _straight(str(tmp_path.parent))
    k, x = int(straight.iterations), straight.x.numpy()
    tol = 0.0 if world == "none" else 1e-10
    for rec in ranks:
        assert rec["first_k"] == 40
        for name in ("from_single", "sharded"):
            assert rec[name]["converged"] and rec[name]["k"] == k, (name, rec[name]["k"], k)
            assert _close(rec[name]["x"], x, tol), name
    np.testing.assert_array_equal(ranks[0]["sharded"]["x"], ranks[-1]["sharded"]["x"])
    path = tmp_path / "c.npz"
    shutil.copy(os.path.join(d, "sharded40.npz"), path)
    ck = CGCheckpoint.load(path)
    assert ck.k == 40 and ck.x.shape == (N,)
    res = cg_solve_resumable(_op(), _b(), path, tol=TOL, segment=50, device="cpu")
    assert bool(res.converged) and int(res.iterations) == k
    assert _close(res.x, x, tol)


@pytest.mark.parametrize("world", ["none", 2])
def test_sharded_checkpoint_for_another_n_raises(sharded, world):
    _d, ranks = sharded(world)
    for rec in ranks:
        assert rec["mismatch"] == f"checkpoint is for N={N}, problem has N=128"


def test_sharded_checkpoint_resumed_by_cgx(sharded, tmp_path):
    """The two-rank world's 40-iteration file, resumed by cgx on its mesh
    of 4 (cgx's own cross-mesh resume, tests/test_utils.py:101-128)."""
    from cgx.mats.generators import lap2d_reference as cgx_lap
    from cgx.utils.checkpoint import sharded_cg_solve_resumable as cgx_sharded

    d, _ranks = sharded(2)
    path = tmp_path / "c.npz"
    shutil.copy(os.path.join(d, "sharded40.npz"), path)
    k_ref, x_ref = _cgx_straight(str(tmp_path.parent))
    res = cgx_sharded(cgx_lap(N), _b(), path, n_devices=4, tol=TOL, segment=50)
    assert bool(res.converged) and int(res.iterations) == k_ref
    assert _close(res.x, x_ref, 1e-10)


class _Traced(Exception):
    """Raised by the stand-in for jax.jit once it holds cgx's segment."""


@functools.lru_cache(maxsize=None)
def _cgx_segment_signature(p: int, tmp_root: str):
    """cgx's collective signature of one segment of its sharded entry on
    a mesh of p, from the trace alone: the module's jax.jit is replaced by
    one that records the shard_map program and its arguments and stops."""
    import jax

    import cgx.utils.checkpoint as cgx_ck
    from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.utils.collectives import collective_signature

    seen = []

    def record_jit(fn):
        def call(*args):
            seen.append((fn, args))
            raise _Traced
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cgx_ck, "jax", types.SimpleNamespace(jit=record_jit,
                                                        shard_map=jax.shard_map))
        with pytest.raises(_Traced):
            cgx_ck.sharded_cg_solve_resumable(
                cgx_lap2d_fd(32), source_term(1024), os.path.join(tmp_root, f"cgx_sig{p}.npz"),
                mesh=cgx_mesh(p), strategy="halo", maxiter=SIG_ITERS, segment=SIG_ITERS)
    fn, args = seen[0]
    return collective_signature(fn, *args)


@pytest.mark.parametrize("world", ["none", 2])
def test_sharded_segment_collectives_equal_cgx(sharded, tmp_path, world):
    """Each iteration: the halo pair and two separate one-element
    all-reduces (cgx's _PsumDot), cgx's list; the start's one all-reduce
    of <b, b>; after a segment the gathers of x, r and p."""
    _d, ranks = sharded(world)
    sig = ranks[0]["signature"]
    want = _cgx_segment_signature(1 if world == "none" else world, str(tmp_path.parent))
    assert len(sig["iters"]) == SIG_ITERS
    assert all(it == want["iter"] for it in sig["iters"]), (sig["iters"][0], want["iter"])
    assert want["iter"] == [("ppermute", 1, 32), ("ppermute", 1, 32), ("psum", 1, 1),
                            ("psum", 1, 1)]
    assert sig["start"] == [("psum", 1, 1)]
    n_pad = 1024
    assert sig["output"] == [("all_gather", 1, n_pad)] * 3

"""The port's sharded s-step (cgx_torch.parallel.sharded_cg, method="sstep",
and cgx_torch.parallel.sstep_fused) against cgx's on the CPU.

The port runs on gloo worlds of 2 and 4 ranks (the harness of
test_torch_sharded.py, one spawn a world for every case), cgx on
make_mesh(P) of the conftest's CPU devices. The pins are cgx's
(tests/test_sstep.py:194-260, tests/test_sstep_fused.py:59-310):

- "off" and "deephalo" on lap2d_reference(2500) with eigvalsh bounds at
  1e-8 ||b|| (cgx's test asks 1e-4 for "rel 1e-8", but ||b|| is 8.7e5
  there, so 1e-4 is 1e-10 relative, on the rounding floor, where cgx's own
  k moves with the mesh: 197, 222, 222, 221 on 1, 2, 4, 8 devices): cgx's
  k and x within 1e-9; deephalo's k equal to off's; at tol 1e-10 a true
  residual below 1e-11; the Newton basis; the depth guard;
- "fused" on lap2d_fd(128) in float32 through the halo-mode plain
  versions of kernels B10: k equal to the port's deephalo, and k within
  s and x within 1e-3 of cgx's deephalo (and of cgx's fused at P = 4);
  the geometry against cgx's on a table; the refused
  builds; the "auto", "adaptive" and "off" fallbacks by monkeypatch;
- the halo window of B10's plain versions, in one process: the windowed
  Gram partials sum to the whole-vector Gram, the windowed recover's
  rows equal the whole-vector recover bit for bit.

No jax or cgx import at the top: the spawned ranks import this module.
"""

import functools

import numpy as np
import pytest
import torch

import cgx_torch
from cgx_torch.config import SolveConfig
from cgx_torch.mats.generators import lap2d_fd, lap2d_reference, source_term
from cgx_torch.ops import sstep_stream as ss
from cgx_torch.parallel import make_mesh, sharded_cg_solve
from cgx_torch.parallel import sharded_cg as sc
from cgx_torch.parallel.sstep_fused import fused_plane_geometry
from test_torch_sharded import run_world

WORLDS = [2, 4]
S = 4
N_REF = 2500  # lap2d_reference(2500): h = 51, depth s h = 204 <= n_loc = 625 at P = 4
G_FUSED = 128


REF_TOL = 1e-8 * float(np.linalg.norm(source_term(N_REF)))


# lap2d_reference(2500)'s extreme eigenvalues by a one-thread eigvalsh (a
# constant here: a dense eigvalsh on every rank of a spawned world takes tens
# of seconds; test_eig_bounds_are_the_spectrum's)
EIG_BOUNDS = (0.0039523932615491385, 7.996047606738463)
# the fused route's x against cgx's, relative to max |x|: float32 at the
# solve's own tolerance (1e-3), lap2d_fd(128)'s condition number being 6.6e3
FUSED_XTOL = 1e-3


def eig_bounds():
    return EIG_BOUNDS


def b32():
    return np.random.default_rng(11).standard_normal(G_FUSED * G_FUSED).astype(np.float32)


def _mesh():
    return make_mesh(device="cpu")


def _np(res):
    return {"k": int(res.iterations), "x": res.x.cpu().numpy(), "converged": bool(res.converged),
            "breakdown": bool(res.breakdown)}


def _ref(powers, tol, **kw):
    return _np(sharded_cg_solve(lap2d_reference(N_REF), source_term(N_REF), mesh=_mesh(),
                                method="sstep", sstep_powers=powers, tol=tol,
                                bounds=eig_bounds(), **kw))


def _fused(powers, **kw):
    return _np(sharded_cg_solve(lap2d_fd(G_FUSED), b32(), mesh=_mesh(), method="sstep",
                                sstep_s=S, sstep_powers=powers, tol=1e-3, **kw))


# ---------------------------------------------------------------------------
# The port's cases (run on every rank)
# ---------------------------------------------------------------------------


def case_results():
    out = {
        "off": _ref("off", REF_TOL),
        "deephalo": _ref("deephalo", REF_TOL),
        "deep_tight": _ref("deephalo", 1e-10),
        "newton": _np(sharded_cg_solve(lap2d_reference(N_REF), source_term(N_REF), mesh=_mesh(),
                                       method="sstep", sstep_basis="newton",
                                       sstep_powers="deephalo", tol=1e-10)),
        "fused": _fused("fused", sstep_bands_dtype=None),
        "fused_deephalo": _fused("deephalo"),
        # "auto" bands (bfloat16, exact for lap2d) through solve(mesh=)
        "api_fused": _np(cgx_torch.solve(
            lap2d_fd(G_FUSED), b32(), SolveConfig(method="sstep", sstep_s=S,
                                                  sstep_powers="fused", precision="fp32",
                                                  tolerance=1e-3),
            mesh=_mesh(), device="cpu")),
    }
    errors = {}
    for name, call in {
        # s h = 10 * 21 = 210 rows past a shard of 200 (P = 2) or 100 (P = 4)
        "depth": lambda: sharded_cg_solve(lap2d_reference(400), source_term(400), mesh=_mesh(),
                                          method="sstep", sstep_s=10, sstep_powers="deephalo"),
        # the bfloat16 margins do not fit a shard of 2048 (P = 2) or 1024 (P = 4) rows
        "untileable": lambda: sharded_cg_solve(
            lap2d_fd(64), np.ones(64 * 64, np.float32), mesh=_mesh(), method="sstep",
            sstep_s=S, sstep_powers="fused", sstep_bands_dtype=torch.bfloat16, tol=1e-3),
    }.items():
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(world):
        ranks = run_world(str(tmp_path_factory.mktemp(f"sstep{world}")), world, __name__,
                          ["case_results"])
        for other in ranks[1:]:  # every rank returns the whole x
            for name, res in other["case_results"].items():
                if isinstance(res, dict) and "x" in res:
                    np.testing.assert_array_equal(res["x"], ranks[0]["case_results"][name]["x"])
        return ranks[0]["case_results"]

    return run


# ---------------------------------------------------------------------------
# cgx's side (this process)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cgx_ref(p: int, powers: str, tol: float):
    import cgx
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.sharded_cg import sharded_cg_solve as cgx_sharded

    res = cgx_sharded(cgx.lap2d_reference(N_REF), source_term(N_REF), mesh=cgx_mesh(p),
                      method="sstep", sstep_powers=powers, tol=tol, bounds=eig_bounds())
    return {"k": int(res.iterations), "x": np.asarray(res.x)}


@functools.lru_cache(maxsize=None)
def cgx_fused(p: int, powers: str = "fused"):
    """cgx's fused route (or its deephalo) on the fused problem, float32."""
    from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
    from cgx.parallel.mesh import make_mesh as cgx_mesh
    from cgx.parallel.sharded_cg import sharded_cg_solve as cgx_sharded

    res = cgx_sharded(cgx_lap2d_fd(G_FUSED), b32(), mesh=cgx_mesh(p), method="sstep",
                      sstep_s=S, sstep_powers=powers, sstep_bands_dtype=None, tol=1e-3)
    return {"k": int(res.iterations), "x": np.asarray(res.x)}


def true_rel(mat, x, b):
    return np.linalg.norm(mat.mat_vec(np.asarray(x, np.float64)) - b) / np.linalg.norm(b)


def assert_x(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("powers", ["off", "deephalo"])
def test_sstep_matches_cgx(port, world, powers):
    """cgx's k on make_mesh(P), x within 1e-9 (tests/test_sstep.py:75-105,
    :200-230): the Gram is all-reduced once a block, the replay cgx's."""
    got, want = port(world)[powers], cgx_ref(world, powers, REF_TOL)
    assert got["converged"] and not got["breakdown"]
    assert got["k"] == want["k"]
    assert_x(got["x"], want["x"], 1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_deephalo_reproduces_per_matvec_halos(port, world):
    """One deep halo a block builds the per-mat-vec-halo basis bit for
    bit: the same k and x."""
    off, deep = port(world)["off"], port(world)["deephalo"]
    assert deep["k"] == off["k"]
    np.testing.assert_array_equal(deep["x"], off["x"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["deep_tight", "newton"])
def test_sstep_reference_quality(port, world, case):
    """At tol 1e-10 (Chebyshev on eigvalsh bounds, and the Newton basis on
    the host bounds) the true residual is below the reference's 1e-11."""
    got = port(world)[case]
    assert got["converged"]
    assert true_rel(lap2d_reference(N_REF), got["x"], source_term(N_REF)) < 1e-11


@pytest.mark.parametrize("world", WORLDS)
def test_deephalo_depth_guard(port, world):
    msg = port(world)["errors"]["depth"]
    assert msg is not None and "halo depth" in msg


@pytest.mark.parametrize("world", WORLDS)
def test_fused_matches_cgx_and_deephalo(port, world):
    """The fused route through the halo-mode plain versions of B10: k
    equal to the port's deephalo (same float32 recurrence, the Gram in
    float64 on both); k within s of cgx's deephalo on make_mesh(P) and x
    within FUSED_XTOL of its; at P = 4 the same against cgx's fused route
    (double-float32 Gram pairs; its interpret-mode run takes 18 s, so
    P = 2 holds to cgx's deephalo only, whose k cgx's own tests hold its
    fused route to, tests/test_sstep_fused.py); the quality gate of
    tests/test_sstep_fused.py."""
    res = port(world)
    got = res["fused"]
    assert got["converged"] and not got["breakdown"]
    assert got["x"].dtype == np.float32
    assert got["k"] == res["fused_deephalo"]["k"]
    for want in [cgx_fused(world, "deephalo")] + ([cgx_fused(world)] if world == 4 else []):
        assert abs(got["k"] - want["k"]) <= S
        assert_x(got["x"], want["x"], FUSED_XTOL)
    assert true_rel(lap2d_fd(G_FUSED), got["x"], b32()) < 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_fused_bf16_bands_auto_and_api(port, world):
    """"auto" streams bfloat16 bands (lap2d's are exact in it): the
    operator's values are unchanged, so k is the full-width route's, and
    solve(sstep_powers="fused", mesh=) routes to it."""
    res = port(world)
    assert res["api_fused"]["converged"] and res["api_fused"]["k"] == res["fused"]["k"]
    np.testing.assert_array_equal(res["api_fused"]["x"], res["fused"]["x"])


@pytest.mark.parametrize("world", WORLDS)
def test_fused_rejects_untileable_build(port, world):
    msg = port(world)["errors"]["untileable"]
    assert msg is not None and "fused" in msg and f"n_loc={64 * 64 // world}" in msg


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------


def test_eig_bounds_are_the_spectrum():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):  # one thread: the same sums on every host, and no contention
        w = np.linalg.eigvalsh(lap2d_reference(N_REF).to_dense())
    assert (float(w.min()), float(w.max())) == pytest.approx(EIG_BOUNDS, rel=1e-12)


GEOMETRY_CASES = [
    ((-G_FUSED, -1, 0, 1, G_FUSED), 4, 4096, "f32", None),
    ((-G_FUSED, -1, 0, 1, G_FUSED), 4, 4096, "f32", "bf16"),
    ((-G_FUSED, -1, 0, 1, G_FUSED), 4, 16384, "f32", None),
    ((-3200, -1, 0, 1, 3200), 4, 2_560_000, "f32", None),
    ((-3200, -1, 0, 1, 3200), 4, 2_560_000, "f32", "bf16"),
    ((-3200, -1, 0, 1, 3200), 4, 10_240_000, "f32", "bf16"),
    ((-64, -1, 0, 1, 64), 2, 2048, "f64", None),
    ((-4096, -64, -1, 0, 1, 64, 4096), 3, 65536, "f32", None),
]


@pytest.mark.parametrize("case", GEOMETRY_CASES, ids=range(len(GEOMETRY_CASES)))
def test_fused_plane_geometry_equals_cgx(case):
    import jax.numpy as jnp

    from cgx.parallel.sstep_fused import fused_plane_geometry as cgx_geometry

    offsets, s, n_loc, dt, bdt = case
    tdt = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
    jdt = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}
    try:
        want = cgx_geometry(offsets, s, n_loc, jdt[dt], None if bdt is None else jdt[bdt])
    except ValueError:
        with pytest.raises(ValueError, match="fused"):
            fused_plane_geometry(offsets, s, n_loc, tdt[dt], None if bdt is None else tdt[bdt])
        return
    assert fused_plane_geometry(offsets, s, n_loc, tdt[dt],
                                None if bdt is None else tdt[bdt]) == tuple(want)


def test_fused_geometry_raises_as_cgx():
    offs = (-G_FUSED, -1, 0, 1, G_FUSED)
    with pytest.raises(ValueError, match="fused"):
        fused_plane_geometry(offs, 4, 2048, torch.float32, torch.bfloat16)


@pytest.mark.parametrize("kw,match", [
    ({"sstep_powers": "fused", "sstep_replace_every": 1}, "residual-replacement"),
    ({"sstep_powers": "fused", "sstep_s": 9}, "sstep_s <= 8"),
    ({"sstep_powers": "pallas"}, "single-device mode"),
    ({"method": "reference", "sstep_bands_dtype": torch.bfloat16}, "sstep_bands_dtype"),
    ({"precond": "jacobi"}, "does not take a preconditioner"),
], ids=["replace_every", "s9", "pallas", "bands_dtype", "precond"])
def test_sstep_options_refused_as_cgx(kw, match):
    kw = {"method": "sstep", **kw}
    with pytest.raises(ValueError, match=match):
        sharded_cg_solve(lap2d_fd(G_FUSED), b32(), mesh=_mesh(), tol=1e-3, **kw)


def _forge(monkeypatch, when):
    """ShardedCGSolver.solve with a forged breakdown at k = 8 on the solves
    ``when(solver)`` picks (cgx's monkeypatch, tests/test_sstep_fused.py:242),
    frozen at the zero iterate, so that what follows has a solve to do."""
    real = sc.ShardedCGSolver.solve
    calls = []

    def fake(self, b, x0=None, **kw):
        res = real(self, b, x0=x0, **kw)
        calls.append((self.method, getattr(self._sstep, "s", None)))
        if when(self):
            return res._replace(x=torch.zeros_like(res.x), breakdown=torch.tensor(True),
                                converged=torch.tensor(False),
                                iterations=torch.tensor(8, dtype=torch.int32))
        return res

    monkeypatch.setattr(sc.ShardedCGSolver, "solve", fake)
    return calls


def test_fallback_auto_finishes_on_the_reference_recurrence(monkeypatch):
    calls = _forge(monkeypatch, lambda solver: len(calls) == 1)
    res = sharded_cg_solve(lap2d_fd(G_FUSED), b32(), mesh=_mesh(), method="sstep", sstep_s=S,
                           sstep_powers="fused", sstep_bands_dtype=None, tol=1e-3)
    assert [m for m, _ in calls] == ["sstep", "reference"]
    assert bool(res.converged) and int(res.iterations) > 8
    assert true_rel(lap2d_fd(G_FUSED), res.x.numpy(), b32()) < 1e-3


def test_fallback_off_returns_the_frozen_result(monkeypatch):
    calls = _forge(monkeypatch, lambda solver: True)
    res = sharded_cg_solve(lap2d_fd(G_FUSED), b32(), mesh=_mesh(), method="sstep", sstep_s=S,
                           sstep_fallback="off", tol=1e-3)
    assert len(calls) == 1 and bool(res.breakdown) and not bool(res.converged)


def test_fallback_adaptive_walks_the_s_ladder(monkeypatch):
    calls = _forge(monkeypatch, lambda solver: solver.method == "sstep")
    res = sharded_cg_solve(lap2d_fd(G_FUSED), b32(), mesh=_mesh(), method="sstep", sstep_s=S,
                           sstep_fallback="adaptive", tol=1e-3)
    assert calls == [("sstep", 4), ("sstep", 2), ("reference", None)]
    assert bool(res.converged) and int(res.iterations) > 16


def test_fallback_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown sstep_fallback"):
        sharded_cg_solve(lap2d_fd(16), source_term(256), mesh=_mesh(), method="sstep",
                         sstep_fallback="never")


def test_halo_window_gram_and_recover():
    """B10's plain versions in the halo mode: a seeded vector cut into 4
    shards, each extended by its neighbours' d rows (zeros past the ends);
    the windowed Gram partials sum to the whole-vector Gram within 1e-13
    and the windowed recover's rows equal the whole-vector recover bit for
    bit (x, r and p)."""
    g, s, parts = 64, 3, 4
    dia = lap2d_fd(g)
    n, offsets = g * g, tuple(dia.offsets)
    n_loc, d = n // parts, s * g
    rng = np.random.default_rng(5)
    bands = torch.tensor(dia.bands, dtype=torch.float64)
    vec = {k: torch.tensor(rng.standard_normal(n)) for k in ("p", "r", "x")}
    kw = dict(offsets=offsets, s=s, theta=4.0, delta=3.9, shifts=())
    ctl = dict(tol=0.0, nearzero=1e-14, maxiter=10**6)
    m = 2 * s + 1
    bmat = torch.zeros((m, m), dtype=torch.float64)

    def state_of():
        return torch.zeros(ss.STATE_LEN, dtype=torch.float64)

    def pair(v):
        return torch.stack([v, torch.zeros_like(v)])

    whole = state_of()
    ss._gram_ref(bands, pair(vec["p"]), pair(vec["r"]), whole, bmat, part=True, **kw, **ctl)
    g_whole = whole[ss.GRAM: ss.GRAM + m * m]
    coef = torch.tensor(rng.standard_normal(3 * m))
    whole[ss.COEF: ss.COEF + 3 * m] = coef
    wp, wr, wx = pair(vec["p"]), pair(vec["r"]), vec["x"].clone()
    ss._recover_ref(bands, wp, wr, wx, whole, **kw)

    def ext(v, lo, hi):
        out = torch.zeros(v.shape[:-1] + (hi - lo + 2 * d,), dtype=v.dtype)
        a, b_ = max(lo - d, 0), min(hi + d, n)
        out[..., a - (lo - d): b_ - (lo - d)] = v[..., a:b_]
        return out

    total = torch.zeros(m * m, dtype=torch.float64)
    for k in range(parts):
        lo, hi = k * n_loc, (k + 1) * n_loc
        st = state_of()
        p, r, x, bd = pair(ext(vec["p"], lo, hi)), pair(ext(vec["r"], lo, hi)), ext(
            vec["x"], lo, hi), ext(bands, lo, hi)
        ss._gram_ref(bd, p, r, st, bmat, window=(d, d + n_loc), part=True, **kw, **ctl)
        assert st[ss.LIVE] == 1.0 and st[ss.K] == 0.0  # no replay in the Gram-only launch
        total += st[ss.GRAM: ss.GRAM + m * m]
        st[ss.COEF: ss.COEF + 3 * m] = coef
        ss._recover_ref(bd, p, r, x, st, window=(d, d + n_loc), **kw)
        assert torch.equal(x[d: d + n_loc], wx[lo:hi])
        assert torch.equal(r[1, d: d + n_loc], wr[1, lo:hi])
        assert torch.equal(p[1, d: d + n_loc], wp[1, lo:hi])
        assert not r[1, :d].any() and not p[1, d + n_loc:].any()  # the halo rows stay
    assert torch.max(torch.abs(total - g_whole)) <= 1e-13 * torch.max(torch.abs(g_whole))


def test_replay_live_only_waits_for_a_live_gram():
    """sstep_replay(live_only=True) replays only after a Gram-only launch
    marked the block live; a stopped solve's Gram-only launch zeroes G."""
    s, m = 2, 5
    st = torch.zeros(ss.STATE_LEN, dtype=torch.float64)
    st[ss.GRAM: ss.GRAM + m * m] = torch.eye(m, dtype=torch.float64).reshape(-1)
    st[ss.RSNEW] = 1.0
    bmat = torch.eye(m, dtype=torch.float64)
    ss.sstep_replay(st, bmat, s=s, tol=0.0, nearzero=1e-14, maxiter=100, live_only=True)
    assert st[ss.K] == 0.0 and not st[ss.COEF: ss.COEF + 3 * m].any()
    st[ss.LIVE] = 1.0
    ss.sstep_replay(st, bmat, s=s, tol=0.0, nearzero=1e-14, maxiter=100, live_only=True)
    assert st[ss.K] == 2.0
    st[ss.CONV] = 1.0
    p = torch.zeros((2, 16), dtype=torch.float64)
    ss._gram_ref(torch.ones((1, 16), dtype=torch.float64), p, p.clone(), st, bmat, offsets=(0,),
                 s=s, theta=1.0, delta=0.5, shifts=(), tol=0.0, nearzero=1e-14, maxiter=100,
                 part=True)
    assert not st[ss.GRAM: ss.GRAM + m * m].any()

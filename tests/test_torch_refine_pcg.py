"""cgx_torch's refinement around a preconditioned inner (solver/refine.py:
refine_pcg_sweeps and its _dd and _tw variants) and solve(precision="tw")
against cgx's (cgx/solver/refine.py:319-767, cgx/solver/api.py:471-561),
on the CPU, on the same seeded numpy inputs.

Pins: converged, the sweeps within 1 of cgx's, and the true residual of
the returned solution below the gate by a host longdouble referee (x86
80-bit, as tests/test_tw32.py and tests/test_dd.py compute it); the
solver's own extended-precision residual within 20% of the referee. The
inners are fp32 MG-PCG on lap2d_fd(64) (cgx's and the port's host
Galerkin builds are bitwise equal), and a Jacobi fp32 inner on the
checkerboard poisson2d_var of tests/test_tw32.py:259-300.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
from cgx.mats import generators as cgx_gen
from cgx.solver import multigrid as cgx_mg
from cgx.solver import refine as cgx_refine
from cgx.solver.operators import DiaOperator as CgxDia

import cgx_torch
from cgx_torch import SolveConfig
from cgx_torch.mats.generators import lap2d_fd, poisson2d_var, source_term
from cgx_torch.solver import multigrid as tmg
from cgx_torch.solver import refine
from cgx_torch.solver.operators import DiaOperator

G = 64


def _ld_rel(dia, x_ld, b):
    """||b - A x|| / ||b|| in longdouble, x given in longdouble."""
    n = b.shape[0]
    bl = np.asarray(b, np.longdouble)
    ax = np.zeros(n, np.longdouble)
    bands = np.asarray(dia.bands, np.longdouble)
    for d, off in enumerate(dia.offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        ax[i0:i1] += bands[d, i0:i1] * x_ld[i0 + off: i1 + off]
    return float(np.sqrt(np.sum((bl - ax) ** 2)) / np.sqrt(np.sum(bl * bl)))


def _words_ld(words):
    return sum(np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w, np.longdouble)
               for w in words)


@pytest.fixture(scope="module")
def lap():
    """lap2d_fd(64), its source term, and both packages' fp32 MG
    preconditioners and fp64 operators."""
    dia = lap2d_fd(G)
    b = source_term(G * G)
    op_t = DiaOperator(torch.tensor(dia.bands), tuple(dia.offsets))
    op_c = CgxDia(jnp.asarray(dia.bands), tuple(dia.offsets))
    mg_t = tmg.mg_preconditioner(op_t, dtype=torch.float32)
    mg_c = cgx_mg.mg_preconditioner(op_c, dtype=jnp.float32)
    return dia, b, op_t, op_c, mg_t, mg_c


# bench.py's arguments, at rtol 1e-13 (tests/test_tw32.py's), and cgx's defaults
KW = dict(sweeps=12, rtol=1e-13, inner_tol=1e-6, inner_maxiter=60)


@pytest.mark.parametrize("variant", ["fp64", "dd", "tw"])
def test_pcg_sweeps_match_cgx(lap, variant):
    """The three outers around the fp32 MG inner: converged, sweeps within
    1 of cgx's, the inner total within 10% of cgx's, the true residual
    of the returned x (the pair or the triple, summed in longdouble)
    below rtol (fp64: below 1e-11, its own floor) and within 2x of cgx's,
    and the reported residual within 20% of the referee (dd, tw)."""
    dia, b, op_t, op_c, mg_t, mg_c = lap
    fn = {"fp64": "refine_pcg_sweeps", "dd": "refine_pcg_sweeps_dd",
          "tw": "refine_pcg_sweeps_tw"}[variant]
    kw = dict(KW, rtol=1e-11) if variant == "fp64" else KW
    got = getattr(refine, fn)(op_t, b, precond=mg_t.apply, device="cpu", **kw)
    want = getattr(cgx_refine, fn)(op_c, jnp.asarray(b), precond=mg_c.apply, **kw)
    assert bool(got.converged) and bool(want.converged)
    assert abs(got.outer_iterations - want.outer_iterations) <= 1
    assert got.inner_iterations.shape == (1,) and got.inner_iterations.dtype == torch.int32
    gi, wi = int(got.inner_iterations[0]), int(np.asarray(want.inner_iterations)[0])
    assert abs(gi - wi) <= max(1, 0.1 * wi)
    if variant == "fp64":
        x_g, x_w = np.asarray(got.x.numpy(), np.longdouble), np.asarray(want.x, np.longdouble)
    elif variant == "dd":
        x_g, x_w = _words_ld((got.x_hi, got.x_lo)), _words_ld((want.x_hi, want.x_lo))
        assert got.x is got.x_hi
    else:
        x_g, x_w = _words_ld(got.x_words), _words_ld(want.x_words)
        assert torch.equal(got.x, got.x_words[0].double() + got.x_words[1].double()
                           + got.x_words[2].double())
    rel_g, rel_w = _ld_rel(dia, x_g, b), _ld_rel(dia, x_w, b)
    assert rel_g < (1e-11 if variant == "fp64" else kw["rtol"])
    assert rel_g <= 2 * rel_w + 1e-16
    if variant != "fp64":
        own = float(got.residual_norm) / np.linalg.norm(b)
        assert abs(own - rel_g) <= 0.2 * max(own, rel_g) + 1e-16
        hist = got.residual_history.numpy()
        assert hist.shape == (kw["sweeps"],)
        assert np.sum(~np.isnan(hist)) == got.outer_iterations
        assert hist[got.outer_iterations - 1] == float(got.residual_norm)


def test_tw_below_the_fp64_floor_and_repeatable(lap):
    """The triple's true residual at rtol 1e-13 sits below what an fp64
    evaluation of b - A x can resolve here (its floor about 2e-14 at this
    size); two runs give the same words bitwise."""
    dia, b, op_t, _, mg_t, _ = lap
    r1 = refine.refine_pcg_sweeps_tw(op_t, b, precond=mg_t.apply, device="cpu", **KW)
    r2 = refine.refine_pcg_sweeps_tw(op_t, b, precond=mg_t.apply, device="cpu", **KW)
    assert all(torch.equal(u.view(torch.int32), v.view(torch.int32))
               for u, v in zip(r1.x_words, r2.x_words))
    assert _ld_rel(dia, _words_ld(r1.x_words), b) < 1e-13


def test_tw_checkerboard_jacobi_inner():
    """tests/test_tw32.py:259-300: poisson2d_var on an 8 x 8 checkerboard
    of coefficients 1 and 8 (bands not float32-exact: the outer takes the
    three-plane split), a Jacobi fp32 inner: converged, sweeps within 1
    of cgx's, the longdouble referee of the fp64 operator below 1e-10."""
    g, cells = 64, 8
    board = np.where((np.indices((cells, cells)).sum(axis=0) % 2).astype(bool), 8.0, 1.0)
    coeff = np.kron(board, np.ones((g // cells, g // cells)))
    dia = poisson2d_var(g, coeff)
    np.testing.assert_array_equal(dia.bands, cgx_gen.poisson2d_var(g, coeff).bands)
    b = source_term(g * g)
    d0 = list(dia.offsets).index(0)
    inv32 = 1.0 / np.asarray(dia.bands[d0])
    kw = dict(sweeps=24, rtol=3e-12, inner_tol=1e-6, inner_maxiter=4000)
    inv_t = torch.tensor(inv32, dtype=torch.float32)
    got = refine.refine_pcg_sweeps_tw(DiaOperator(torch.tensor(dia.bands), tuple(dia.offsets)),
                                      b, precond=lambda r: r * inv_t, device="cpu", **kw)
    inv_j = jnp.asarray(inv32, jnp.float32)
    want = cgx_refine.refine_pcg_sweeps_tw(CgxDia(jnp.asarray(dia.bands), tuple(dia.offsets)),
                                           jnp.asarray(b), precond=lambda r: r * inv_j, **kw)
    assert bool(got.converged)
    assert abs(got.outer_iterations - want.outer_iterations) <= 1
    assert _ld_rel(dia, _words_ld(got.x_words), b) < 1e-10


def test_inner_runs_fp32_dots(monkeypatch):
    """The inner solve takes dots in the inner dtype (cgx's dot_precision
    None), not solve()'s fp64 dots for fp32, and clamps alpha at 1e-14."""
    seen = []
    loop = refine.cg_loop

    def recorded(mv, b, x0, **kw):
        seen.append((b.dtype, kw["dots"]([(b, b)])[0].dtype, kw["nearzero"].dtype,
                     float(kw["nearzero"])))
        return loop(mv, b, x0, **kw)

    monkeypatch.setattr(refine, "cg_loop", recorded)
    dia = lap2d_fd(16)
    op = DiaOperator(torch.tensor(dia.bands), tuple(dia.offsets))
    refine.refine_pcg_sweeps(op, source_term(256), precond=None, sweeps=2, device="cpu")
    nz = float(np.float32(1e-14))
    assert seen and all(s == (torch.float32,) * 3 + (nz,) for s in seen)


@pytest.mark.parametrize("precond", [None, "mg"])
def test_solve_precision_tw_matches_cgx(precond):
    """solve(precision="tw") on lap2d_fd(64) (an fp32 MG inner either way:
    the operator decodes on a grid), rtol 1e-12: the sweeps within 1 of
    cgx.solve's, the tw residual below the gate, x the fp64 view."""
    dia = lap2d_fd(G)
    b = source_term(G * G)
    cfg = dict(precision="tw", tolerance=1e-12, precond=precond)
    got = cgx_torch.solve(dia, b, SolveConfig(**cfg), device="cpu")
    want = cgx.solve(cgx_gen.lap2d_fd(G), b, cgx.SolveConfig(**cfg))
    assert bool(got.converged) and got.x.dtype == torch.float64 and got.history.shape == (0,)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    assert float(got.residual_norm) / np.linalg.norm(b) < 1e-12
    assert _ld_rel(dia, np.asarray(got.x.numpy(), np.longdouble), b) < 1e-11


def test_solve_tw_falls_back_to_a_plain_inner_off_grid(monkeypatch):
    """A banded operator that is no grid (N = 1001 is neither a square nor
    a cube):
    precond=None runs the plain fp32 inner (cgx's fallback), with inner
    maxiter N; precond="mg" raises the multigrid's ValueError, as cgx's."""
    offsets = (-10, -1, 0, 1, 10)
    n = 1001
    bands = np.zeros((5, n))
    bands[2] = 4.0
    for d, off in ((0, -10), (1, -1), (3, 1), (4, 10)):
        i = np.arange(n)
        bands[d] = np.where((i + off >= 0) & (i + off < n), -1.0, 0.0)
    dia = cgx_torch.DIAMatrix((n, n), offsets, bands)
    b = source_term(n)
    calls = []
    sweeps = refine.refine_pcg_sweeps_tw

    def recorded(op64, b64, **kw):
        calls.append((kw["precond"], kw["inner_maxiter"]))
        return sweeps(op64, b64, **kw)

    monkeypatch.setattr(cgx_torch.solver.api, "refine_pcg_sweeps_tw", recorded)
    got = cgx_torch.solve(dia, b, SolveConfig(precision="tw", tolerance=1e-12), device="cpu")
    want = cgx.solve(cgx.DIAMatrix((n, n), offsets, bands), b,
                     cgx.SolveConfig(precision="tw", tolerance=1e-12))
    assert calls == [(None, n)]
    assert bool(got.converged) and abs(int(got.iterations) - int(want.iterations)) <= 1
    with pytest.raises(ValueError):
        cgx_torch.solve(dia, b, SolveConfig(precision="tw", precond="mg"), device="cpu")
    with pytest.raises(ValueError):
        cgx.solve(cgx.DIAMatrix((n, n), offsets, bands), b,
                  cgx.SolveConfig(precision="tw", precond="mg"))


@pytest.mark.parametrize("cfg,kwargs,exc", [
    (dict(), {"x0": np.zeros(256)}, ValueError),
    (dict(method="pipelined"), {}, ValueError),
    (dict(precond="jacobi"), {}, ValueError),
    (dict(), {"dense": True}, TypeError),
], ids=["x0", "method", "precond", "dense"])
def test_solve_tw_errors_as_cgx(cfg, kwargs, exc):
    """cgx's errors: an x0, a method other than the reference, a
    preconditioner other than None or "mg", a non-banded matrix."""
    kwargs = dict(kwargs)
    dia = lap2d_fd(16)
    mat_t, mat_c = dia, cgx_gen.lap2d_fd(16)
    if kwargs.pop("dense", False):
        mat_t, mat_c = dia.to_dense(), np.asarray(mat_c.to_dense())
    b = source_term(256)
    with pytest.raises(exc):
        cgx_torch.solve(mat_t, b, SolveConfig(precision="tw", **cfg), device="cpu", **kwargs)
    with pytest.raises(exc):
        cgx.solve(mat_c, b, cgx.SolveConfig(precision="tw", **cfg), **kwargs)

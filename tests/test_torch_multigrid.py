"""cgx_torch's multigrid preconditioner (solver/multigrid.py) and device
problem builders (mats/device.py) against cgx's on the same numpy
inputs, on the CPU (mirrors tests/test_multigrid.py and
tests/test_device_builders.py): the host Galerkin build bit for bit, the
device probe within 1e-12, one cycle within 1e-13 (fp64) or 1e-6 (fp32
cycle), MG-PCG iteration counts equal to cgx's or within 1."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver import multigrid as cmg
from cgx_torch.mats import device as tdev
from cgx_torch.mats import generators as tgen
from cgx_torch.solver import multigrid as tmg

GENS = {2: (cgx.lap2d_fd, tgen.lap2d_fd), 3: (cgx.lap3d_fd, tgen.lap3d_fd)}
TRANSFERS = ["bilinear", "aggregation"]


def _op(dia, dtype=torch.float64):
    return cgx_torch.operator_from_numpy(dia.bands, dia.offsets, dtype=dtype, device="cpu")


def _rel(dia, x, b):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b))


def _pair(g, ndim=2, **kw):
    """cgx's and the port's preconditioner on the same grid."""
    cgen, tg = GENS[ndim]
    return (cmg.mg_preconditioner(cgen(g), ndim=ndim, **kw),
            tmg.mg_preconditioner(tg(g), ndim=ndim, device="cpu", **kw))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _cgx_pcg(g, ndim, kw):
    """cgx's MG-PCG on lap(g) at tol 1e-10 ||b||: (k, x), computed once."""
    cgen = GENS[ndim][0]
    dia = cgen(g)
    b = cgx.source_term(dia.shape[0])
    kw = dict(kw)
    if "dtype" in kw:
        kw["dtype"] = jnp.float32
    mg = cmg.mg_preconditioner(dia, ndim=ndim, **kw)
    pc = mg.apply_mixed if "dtype" in kw else mg.apply
    res = cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(b),
                       tol=1e-10 * np.linalg.norm(b), precond=pc)
    assert bool(res.converged)
    return int(res.iterations), np.asarray(res.x)


def _port_pcg(g, ndim, **kw):
    dia = GENS[ndim][1](g)
    b = tgen.source_term(dia.shape[0])
    torch_kw = dict(kw)
    if "dtype" in torch_kw:
        torch_kw["dtype"] = torch.float32
    mg = tmg.mg_preconditioner(dia, ndim=ndim, device="cpu", **torch_kw)
    pc = mg.apply_mixed if "dtype" in kw else mg.apply
    res = cgx_torch.cg_solve(_op(dia), b, tol=1e-10 * np.linalg.norm(b), precond=pc,
                             device="cpu")
    return res, dia, b, mg


# --- the host Galerkin build ----------------------------------------------


@pytest.mark.parametrize("transfer", TRANSFERS)
@pytest.mark.parametrize("g,ndim", [(16, 2), (8, 3)])
def test_host_galerkin_bitwise(g, ndim, transfer):
    """Two levels of the NumPy build (the second on the widened stencil
    in 2-D): offsets and bands bit for bit cgx's."""
    cgen, tg = GENS[ndim]
    cfn = cmg._galerkin_bilinear if transfer == "bilinear" else cmg._galerkin_dia
    tfn = tmg._galerkin_bilinear if transfer == "bilinear" else tmg._galerkin_dia
    want, got = cfn(cgen(g), g, ndim), tfn(tg(g), g, ndim)
    assert got.offsets == want.offsets
    np.testing.assert_array_equal(got.bands, want.bands)
    if ndim == 2:
        want2, got2 = cfn(want, g // 2, ndim), tfn(got, g // 2, ndim)
        assert got2.offsets == want2.offsets
        np.testing.assert_array_equal(got2.bands, want2.bands)


@pytest.mark.parametrize("smoother", ["richardson", "gs"])
def test_host_hierarchy_bitwise(smoother):
    """MGPreconditioner's host build at g = 128 (three levels): grids, the
    coarse operators, the damping and the GS masks bit for bit cgx's."""
    mc, mt = _pair(128, galerkin_setup="host", smoother=smoother, min_coarse_grid=16)
    assert mt.grids == mc.grids == [128, 64, 32, 16]
    assert mt.galerkin_setup == "host"
    for oc, ot in zip(mc.coarse_ops, mt.coarse_ops):
        assert tuple(ot.offsets) == tuple(oc.offsets)
        np.testing.assert_array_equal(ot.bands.numpy(), np.asarray(oc.bands))
    assert float(mt.fine_damp) == float(mc.fine_damp)
    assert [float(d) for d in mt.coarse_damp] == [float(d) for d in mc.coarse_damp]
    np.testing.assert_array_equal(mt.coarsest_inv.numpy(), np.asarray(mc.coarsest_inv))
    if smoother == "gs":
        for cc, ct, dc, dt in zip(mc.colors, mt.colors, mc.dinv, mt.dinv):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cc))
            np.testing.assert_array_equal(dt.numpy(), np.asarray(dc))


def test_3d_transfers_and_galerkin():
    """Trilinear transfers against the explicit P (an adjoint pair), and
    the Galerkin triple product in 3-D (cgx's test, on the port)."""
    g, gc, nd = 8, 4, 3
    rng = np.random.default_rng(0)
    e = rng.standard_normal(gc**nd)
    f = rng.standard_normal(g**nd)
    pidx, pw = tmg._bilinear_p(g, nd)
    cidx, cw = cmg._bilinear_p(g, nd)
    np.testing.assert_array_equal(pidx, cidx)
    np.testing.assert_array_equal(pw, cw)
    p_mat = np.zeros((g**nd, gc**nd))
    for a in range(pw.shape[1]):
        np.add.at(p_mat, (np.arange(g**nd), pidx[:, a]), pw[:, a])
    pe = tmg.MGPreconditioner._prolong_bilinear(torch.tensor(e), gc, nd).numpy()
    rf = tmg.MGPreconditioner._restrict_bilinear(torch.tensor(f), g, nd).numpy()
    np.testing.assert_allclose(pe, p_mat @ e, rtol=1e-12)
    assert np.isclose(np.dot(p_mat @ e, f), np.dot(e, rf))
    dia3 = tgen.lap3d_fd(g)
    np.testing.assert_allclose(tmg._galerkin_bilinear(dia3, g, nd).to_dense(),
                               p_mat.T @ dia3.to_dense() @ p_mat, atol=1e-12)


@pytest.mark.parametrize("transfer", TRANSFERS)
@pytest.mark.parametrize("ndim", [2, 3])
def test_transfers_match_cgx(ndim, transfer):
    """Restriction and prolongation on seeded vectors, also batched (the
    probes' form), within 1e-15 of cgx's."""
    g = 8
    gc = g // 2
    rng = np.random.default_rng(1)
    f = rng.standard_normal((3, g**ndim))
    e = rng.standard_normal((3, gc**ndim))
    names = (("_restrict_bilinear", "_prolong_bilinear") if transfer == "bilinear"
             else ("_restrict", "_prolong"))
    for name, v, size in ((names[0], f, g), (names[1], e, gc)):
        cfn = getattr(cmg.MGPreconditioner, name)
        tfn = getattr(tmg.MGPreconditioner, name)
        batched = tfn(torch.tensor(v), size, ndim).numpy()
        for i in range(3):
            want = np.asarray(cfn(jnp.asarray(v[i]), size, ndim))
            np.testing.assert_allclose(tfn(torch.tensor(v[i]), size, ndim).numpy(), want,
                                       rtol=1e-15, atol=1e-15)
            np.testing.assert_array_equal(batched[i], tfn(torch.tensor(v[i]), size,
                                                          ndim).numpy())


# --- the device build by band probing ---------------------------------------


@pytest.mark.parametrize("transfer", TRANSFERS)
@pytest.mark.parametrize("g,ndim", [(16, 2), (8, 3)])
def test_galerkin_probe_matches_cgx_and_host(g, ndim, transfer):
    """galerkin_probe on CPU tensors: offsets equal cgx's probe and the
    host build, bands within 1e-12; in 2-D one more level on the widened
    stencil (candidate bound and alias merge)."""
    cgen, tg = GENS[ndim]
    mat = tg(g)
    host = tmg._galerkin_bilinear if transfer == "bilinear" else tmg._galerkin_dia
    levels = [(mat, g)]
    if ndim == 2:
        levels.append((host(mat, g, ndim), g // 2))
    for m, gg in levels:
        want_b, want_o = cmg.galerkin_probe(jnp.asarray(m.bands), m.offsets, gg, ndim, transfer)
        got_b, got_o = tmg.galerkin_probe(torch.tensor(m.bands), m.offsets, gg, ndim, transfer)
        h = host(m, gg, ndim)
        assert got_o == tuple(want_o) == h.offsets
        scale = np.abs(h.bands).max()
        assert _rel_err(got_b.numpy(), np.asarray(want_b)) <= 1e-12
        assert np.abs(got_b.numpy() - h.bands).max() <= 1e-12 * scale
        dev = (tmg._galerkin_bilinear_dev if transfer == "bilinear"
               else tmg._galerkin_dia_dev)(m, gg, ndim, device="cpu")
        assert dev.offsets == h.offsets
        np.testing.assert_array_equal(dev.bands, got_b.numpy())


def test_galerkin_probe_batched_matches_unbatched(monkeypatch):
    """Past PROBE_WORDS_BUDGET the probes run in batches (cgx's lax.map):
    bit for bit the unbatched probe, and within float32 rounding of the
    host build (cgx's test_galerkin_probe_chunked_matches_vmap)."""
    mat = tgen.lap2d_fd(24)
    host = tmg._galerkin_bilinear(mat, 24, 2)
    whole, offs = tmg.galerkin_probe(torch.tensor(mat.bands, dtype=torch.float32), mat.offsets,
                                     24, 2, "bilinear")
    monkeypatch.setattr(tmg, "PROBE_WORDS_BUDGET", 1024)  # batches of two probes
    batched, offs_b = tmg.galerkin_probe(torch.tensor(mat.bands, dtype=torch.float32),
                                         mat.offsets, 24, 2, "bilinear")
    assert offs == offs_b == host.offsets
    assert torch.equal(batched, whole)
    np.testing.assert_allclose(batched.numpy(), host.bands, rtol=2e-6, atol=2e-6)


def test_device_setup_end_to_end():
    """galerkin_setup="device" against "host": the same grids, coarse
    bands within 1e-12, and MG-PCG k within 1 (cgx's end-to-end test)."""
    dia = tgen.lap2d_fd(64)
    b = tgen.source_term(64 * 64)
    op = _op(dia)
    mh = tmg.mg_preconditioner(op, galerkin_setup="host")
    md = tmg.mg_preconditioner(op, galerkin_setup="device")
    assert mh.grids == md.grids and md.galerkin_setup == "device"
    for oh, od in zip(mh.coarse_ops + [None], md.coarse_ops + [None]):
        if oh is not None:
            assert oh.offsets == od.offsets
            assert _rel_err(od.bands, oh.bands) <= 1e-12
    rh = cgx_torch.cg_solve(op, b, tol=1e-10, precond=mh.apply, device="cpu")
    rd = cgx_torch.cg_solve(op, b, tol=1e-10, precond=md.apply, device="cpu")
    assert bool(rd.converged)
    assert abs(int(rh.iterations) - int(rd.iterations)) <= 1
    np.testing.assert_allclose(rd.x.numpy(), rh.x.numpy(), rtol=1e-8, atol=1e-8)


def test_auto_setup_is_host_on_the_cpu():
    """"auto" builds on the device only on CUDA (N >= 2^18); on the CPU it
    is the host build, as cgx's is on its CPU backend."""
    _, mt = _pair(32)
    assert mt.galerkin_setup == "host"


# --- one cycle ------------------------------------------------------------------


@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("smoother", ["richardson", "gs"])
@pytest.mark.parametrize("transfer", TRANSFERS)
@pytest.mark.parametrize("g,ndim", [(32, 2), (16, 3)])
def test_apply_matches_cgx(g, ndim, transfer, smoother, cycle):
    """One cycle on a seeded r (min_coarse_grid 8 in 2-D, so W differs
    from V): within 1e-13 of cgx's relative to max |z|."""
    kw = dict(transfer=transfer, smoother=smoother, cycle=cycle)
    if ndim == 2:
        kw["min_coarse_grid"] = 8
    mc, mt = _pair(g, ndim, **kw)
    assert mt.grids == mc.grids
    r = np.random.default_rng(2).standard_normal(g**ndim)
    got = mt.apply(torch.tensor(r)).numpy()
    assert _rel_err(got, mc.apply(jnp.asarray(r))) <= 1e-13


@pytest.mark.parametrize("smoother", ["richardson", "gs"])
def test_apply_mixed_matches_cgx(smoother):
    """An fp32 cycle inside fp64: the fine bands of the cycle's copy are
    fp32, the result comes back in fp64, within 1e-6 of cgx's."""
    mc = cmg.mg_preconditioner(cgx.lap2d_fd(64), smoother=smoother, dtype=jnp.float32)
    mt = tmg.mg_preconditioner(tgen.lap2d_fd(64), device="cpu", smoother=smoother,
                               dtype=torch.float32)
    assert mt.fine.dtype == torch.float32 and mt.dtype == torch.float32
    r = np.random.default_rng(3).standard_normal(64 * 64)
    got = mt.apply_mixed(torch.tensor(r))
    assert got.dtype == torch.float64
    assert _rel_err(got.numpy(), mc.apply_mixed(jnp.asarray(r))) <= 1e-6


@pytest.mark.parametrize("smoother", ["richardson", "gs"])
def test_cycle_is_spd(smoother):
    """The cycle is a symmetric positive definite operator (Galerkin
    levels, scalar damping or reversed colours, scaled transposes)."""
    g = 16
    mt = tmg.mg_preconditioner(tgen.lap2d_fd(g), min_coarse_grid=8, smoother=smoother,
                               device="cpu")
    m = torch.stack([mt.apply(e) for e in torch.eye(g * g, dtype=torch.float64)]).numpy().T
    assert np.abs(m - m.T).max() / np.abs(m).max() < 1e-12
    assert np.linalg.eigvalsh((m + m.T) / 2).min() > 0


def test_w_cycle_symmetric():
    """<M x, y> = <x, M y> for the W-cycle (cgx's test)."""
    mt = tmg.mg_preconditioner(tgen.lap2d_fd(64), cycle="w", min_coarse_grid=8, device="cpu")
    rs = np.random.default_rng(0)
    x, y = (torch.tensor(rs.standard_normal(64 * 64)) for _ in range(2))
    lhs = float(torch.dot(mt.apply(x), y))
    rhs = float(torch.dot(x, mt.apply(y)))
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), abs(rhs))


# --- MG-PCG against cgx ---------------------------------------------------------


PCG_CASES = [
    (64, 2, (("min_coarse_grid", 8),)),
    (64, 2, (("min_coarse_grid", 8), ("cycle", "w"))),
    (64, 2, (("min_coarse_grid", 8), ("smoother", "gs"))),
    (64, 2, (("min_coarse_grid", 8), ("smoother", "gs"), ("cycle", "w"))),
    (64, 2, (("transfer", "aggregation"),)),
    (64, 2, (("transfer", "aggregation"), ("smoother", "gs"))),
    (64, 2, (("dtype", "float32"),)),
    (64, 2, (("dtype", "float32"), ("smoother", "gs"))),
    (16, 3, ()),
    (16, 3, (("smoother", "gs"),)),
    (130, 2, ()),  # 130 -> 65: the coarsest level (4225 unknowns) takes the Chebyshev solve
]


@pytest.mark.parametrize("g,ndim,kw", PCG_CASES,
                         ids=["rich_v", "rich_w", "gs_v", "gs_w", "agg_rich", "agg_gs",
                              "mixed_rich", "mixed_gs", "3d_rich", "3d_gs", "cheb_coarsest"])
def test_mg_pcg_matches_cgx(g, ndim, kw):
    """k equal to cgx's or within 1, x within 1e-9 (fp64 cycle) of cgx's,
    and cgx's true-residual gate."""
    k_want, x_want = _cgx_pcg(g, ndim, kw)
    res, dia, b, mg = _port_pcg(g, ndim, **dict(kw))
    assert bool(res.converged) and not bool(res.breakdown)
    assert abs(int(res.iterations) - k_want) <= 1, (int(res.iterations), k_want)
    assert _rel(dia, res.x.numpy(), b) < 1e-10
    if "dtype" not in dict(kw) and int(res.iterations) == k_want:
        assert _rel_err(res.x.numpy(), x_want) <= 1e-9
    if g == 130:
        assert mg.coarsest_inv is None and mg.coarsest_cheb is not None
        assert mg.grids == [130, 65]


def test_chebyshev_coarsest_bounds_match_cgx():
    """The coarsest Chebyshev solve of lap2d_fd(130) runs on cgx's bounds
    (host_spectral_bounds, within 1e-12)."""
    mc, mt = _pair(130)
    r = np.random.default_rng(4).standard_normal(65 * 65)
    assert _rel_err(mt.coarsest_cheb(torch.tensor(r)).numpy(),
                    mc.coarsest_cheb(jnp.asarray(r))) <= 1e-12


def test_mg_slashes_iterations_and_scales():
    """An order of magnitude below plain CG, and k nearly flat in g
    (cgx's test, on the port, with cgx's k at each g)."""
    ks = {}
    for g in (32, 64, 128):
        dia = tgen.lap2d_fd(g)
        b = tgen.source_term(g * g)
        mg = tmg.mg_preconditioner(dia, min_coarse_grid=8, device="cpu")
        plain = cgx_torch.cg_solve(_op(dia), b, tol=1e-10, device="cpu")
        pcg = cgx_torch.cg_solve(_op(dia), b, tol=1e-10, precond=mg.apply, device="cpu")
        assert bool(pcg.converged)
        assert int(pcg.iterations) < 0.25 * int(plain.iterations), g
        assert _rel(dia, pcg.x.numpy(), b) < 1e-11
        ks[g] = int(pcg.iterations)
    assert ks[128] < 2 * ks[32]


def test_3d_grid_independence():
    ks = {}
    for g in (8, 16):
        dia = tgen.lap3d_fd(g)
        b = tgen.source_term(dia.shape[0])
        mg = tmg.mg_preconditioner(dia, ndim=3, device="cpu")
        res = cgx_torch.cg_solve(_op(dia), b, tol=1e-10, precond=mg.apply, device="cpu")
        assert bool(res.converged) and not bool(res.breakdown)
        assert _rel(dia, res.x.numpy(), b) < 1e-11
        ks[g] = int(res.iterations)
    assert ks[16] <= 1.5 * ks[8], ks


def test_w_at_least_as_strong_and_gs_beats_richardson():
    """On the port: the W-cycle needs no more iterations than the V-cycle,
    Gauss-Seidel fewer than Richardson (g = 128, cgx measured 13 -> 10 at
    g = 256)."""
    dia = tgen.lap2d_fd(128)
    b = tgen.source_term(128 * 128)
    k = {}
    for name, kw in (("v", {}), ("w", {"cycle": "w"}), ("gs", {"smoother": "gs"})):
        mg = tmg.mg_preconditioner(dia, min_coarse_grid=8, device="cpu", **kw)
        res = cgx_torch.cg_solve(_op(dia), b, tol=1e-10 * np.linalg.norm(b), precond=mg.apply,
                                 device="cpu")
        assert bool(res.converged)
        k[name] = int(res.iterations)
    assert k["w"] <= k["v"] and k["gs"] < k["v"], k


# --- arguments, grids and colours ----------------------------------------------


@pytest.mark.parametrize("kw,match", [
    ({"transfer": "cubic"}, "unknown transfer"),
    ({"smoother": "sor"}, "unknown smoother"),
    ({"cycle": "f"}, "unknown cycle"),
    ({"pre_smooth": 0}, "pre_smooth"),
    ({"galerkin_setup": "remote"}, "unknown galerkin_setup"),
    ({"g": 9}, "is not a 9"),
    ({"g": 8, "min_coarse_grid": 8}, "cannot be coarsened"),
], ids=["transfer", "smoother", "cycle", "pre_smooth", "galerkin_setup", "non_grid", "coarsen"])
def test_rejects_like_cgx(kw, match):
    kw = dict(kw)
    g = kw.pop("g", 8)
    fine_c, fine_t = cgx.DiaOperator.from_host(cgx.lap2d_fd(8)), _op(tgen.lap2d_fd(8))
    with pytest.raises(ValueError, match=match):
        cmg.MGPreconditioner(fine_c, g, **kw)
    with pytest.raises(ValueError, match=match):
        tmg.MGPreconditioner(fine_t, g, **kw)


def test_gs_needs_a_grid_stencil():
    """A level whose offsets do not decode on the grid (reach 3 along an
    axis) refuses GS, as cgx's does."""
    i = np.arange(64)
    bands = np.stack([np.where(i >= 24, -1.0, 0.0), np.full(64, 4.0),
                      np.where(i < 40, -1.0, 0.0)])
    fine_c = cgx.DiaOperator(jnp.asarray(bands), (-24, 0, 24))
    with pytest.raises(ValueError, match="grid-stencil"):
        cmg.MGPreconditioner(fine_c, 8, smoother="gs")
    with pytest.raises(ValueError, match="grid-stencil"):
        tmg.MGPreconditioner(cgx_torch.operator_from_numpy(bands, (-24, 0, 24), device="cpu"),
                             8, smoother="gs")


def test_inferred_grid():
    mt = tmg.mg_preconditioner(tgen.lap2d_fd(32), device="cpu")
    assert mt.g == 32 and mt.grids[0] == 32


@pytest.mark.parametrize("make", [lambda m: m.lap2d_fd(64), lambda m: m.lap3d_fd(16),
                                  lambda m: m.lap2d_reference(4096), lambda m: m.lap2d_fd(7),
                                  lambda m: m.lap3d_fd(5)],
                         ids=["fd64_ambiguous", "3d16", "reference4096", "fd7", "3d5"])
def test_infer_grid_ndim(make):
    want, got = make(cgx), make(tgen)
    assert tmg.infer_grid_ndim(got.shape[0], got.offsets) == cmg.infer_grid_ndim(
        want.shape[0], want.offsets)


@pytest.mark.parametrize("g,ndim,offsets", [
    (12, 2, (-12, -1, 0, 1, 12)),
    (6, 3, (-36, -6, -1, 0, 1, 6, 36)),
    (16, 2, tuple(a * 16 + b for a in range(-2, 3) for b in range(-2, 3))),  # 25 bands
    (8, 2, (-9, -8, -7, -1, 0, 1, 7, 8, 9)),  # 9 bands (aggregation)
])
def test_color_masks_cover_decouple_and_match_cgx(g, ndim, offsets):
    masks = tmg._color_masks(g, ndim, offsets)
    want = cmg._color_masks(g, ndim, offsets)
    assert len(masks) == len(want)
    for m, w in zip(masks, want):
        np.testing.assert_array_equal(m, w)
    np.testing.assert_array_equal(np.sum(masks, axis=0), np.ones(g**ndim))
    coords = tmg._decode_offsets(offsets, g, ndim)
    pos = np.stack(np.meshgrid(*(np.arange(g) for _ in range(ndim)), indexing="ij"),
                   -1).reshape(-1, ndim)
    for mask in masks:
        cells = pos[mask > 0]
        for c in coords:
            if any(c):  # no two cells of a colour one stencil offset apart
                moved = {tuple(p) for p in cells + np.array(c)}
                assert not moved & {tuple(p) for p in cells}


# --- device problem builders ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,g", [(2, 37), (3, 9)])
def test_device_bands_bitwise(ndim, g, dtype):
    """lap2d_operator and lap3d_operator: offsets and bands bit for bit the
    host generators' (and cgx's device builders')."""
    build = tdev.lap2d_operator if ndim == 2 else tdev.lap3d_operator
    op = build(g, dtype, device="cpu")
    host = GENS[ndim][1](g)
    assert op.bands.dtype == dtype and tuple(op.offsets) == tuple(host.offsets)
    np.testing.assert_array_equal(op.bands.numpy(), host.bands.astype(op.bands.numpy().dtype))
    from cgx.mats import device as cdev

    want = (cdev.lap2d_operator if ndim == 2 else cdev.lap3d_operator)(
        g, jnp.float64 if dtype == torch.float64 else jnp.float32)
    np.testing.assert_array_equal(op.bands.numpy(), np.asarray(want.bands))


def test_source_term_device_parity():
    """Within an ulp of the host source_term (cgx's contract) and of cgx's
    device builder."""
    from cgx.mats import device as cdev

    n = 10_000
    got = tdev.source_term_device(n, device="cpu").numpy()
    np.testing.assert_allclose(got, tgen.source_term(n), rtol=1e-14, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(cdev.source_term_device(n, jnp.float64)),
                               rtol=1e-14, atol=1e-9)
    assert tdev.source_term_device(n, torch.float32, device="cpu").dtype == torch.float32

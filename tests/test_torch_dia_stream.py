"""Kernel B8's plain versions (cgx_torch.ops.dia_spmv's streaming forms)
against cgx's Pallas kernels dia_matvec_stream and dia_matvec_stream2d in
interpret mode, on the cases of tests/test_kernels.py:84-153; the band
planes against cgx's bitwise; cgx's argument checks. The CUDA kernel
against its plain version is in test_torch_wrappers.py (on a card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx.ops.dia_spmv as cgx_dia
from cgx.mats import generators as cgx_gen
from cgx_torch.mats import generators as gen
from cgx_torch.ops import dia_spmv

RTOL = 1e-12  # fp64; both sum the products in offset order

STREAM_CASES = {  # test_kernels.py:74-82
    "ref500_b256": ("lap2d_reference", 500, 256),
    "ref1024_b256": ("lap2d_reference", 1024, 256),
    "ref200_b256": ("lap2d_reference", 200, 256),
    "fd20_b128": ("lap2d_fd", 20, 128),
    "3d7_b128": ("lap3d_fd", 7, 128),
}
STREAM2D_CASES = {  # test_kernels.py:101-110
    "ref500_8x128": ("lap2d_reference", 500, 8, 128),
    "fd33_4x128": ("lap2d_fd", 33, 4, 128),
    "3d7_2x128": ("lap3d_fd", 7, 2, 128),
    "fd40_4x256": ("lap2d_fd", 40, 4, 256),
    "fd90_8x512": ("lap2d_fd", 90, 8, 512),
}


def _problem(make, n):
    """The port's and cgx's matrix (equal bands, tests/test_torch_mats.py)
    and a seeded x."""
    dia = getattr(gen, make)(n)
    np.testing.assert_array_equal(dia.bands, getattr(cgx_gen, make)(n).bands)
    x = np.random.default_rng(42).standard_normal(dia.shape[0])
    return dia, x


def _assert_close(got, want, dia, x):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.max(np.abs(want)))
    np.testing.assert_allclose(got, dia.mat_vec(x), rtol=RTOL, atol=RTOL * np.max(np.abs(want)))


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_plain_matches_cgx(case):
    make, n, block = STREAM_CASES[case]
    dia, x = _problem(make, n)
    offs = tuple(dia.offsets)
    want = cgx_dia.dia_matvec_stream(jnp.asarray(dia.bands), jnp.asarray(x), offsets=offs,
                                     block=block, interpret=True)
    bands, xt = torch.as_tensor(dia.bands), torch.as_tensor(x)
    got = dia_spmv.dia_matvec_stream_ref(bands, xt, offsets=offs, block=block)
    _assert_close(got, want, dia, x)
    # the wrapper on a CPU tensor is the plain version, and counts
    before = dia_spmv.dia_matvec_stream.launches
    assert torch.equal(dia_spmv.dia_matvec_stream(bands, xt, offsets=offs, block=block), got)
    assert dia_spmv.dia_matvec_stream.launches == before + 1


@pytest.mark.parametrize("case", STREAM2D_CASES)
def test_stream2d_plain_matches_cgx(case):
    make, n, rows, cols = STREAM2D_CASES[case]
    dia, x = _problem(make, n)
    offs = tuple(dia.offsets)
    want = cgx_dia.dia_matvec_stream2d(jnp.asarray(dia.bands), jnp.asarray(x), offsets=offs,
                                       rows=rows, cols=cols, interpret=True)
    bands, xt = torch.as_tensor(dia.bands), torch.as_tensor(x)
    planes = dia_spmv.stream2d_band_planes(bands, rows=rows, cols=cols).contiguous()
    got = dia_spmv.dia_matvec_stream2d_planes_ref(planes, xt, offsets=offs, rows=rows, cols=cols)
    _assert_close(got, want, dia, x)
    before = dia_spmv.dia_matvec_stream2d_planes.launches
    conv = dia_spmv.dia_matvec_stream2d(bands, xt, offsets=offs, rows=rows, cols=cols)
    assert torch.equal(conv, got)
    assert dia_spmv.dia_matvec_stream2d_planes.launches == before + 1
    # the plain form of the flat bands is the same product, bit for bit
    assert torch.equal(dia_spmv.dia_matvec_ref(bands, xt, offsets=offs), got)


@pytest.mark.parametrize("case", STREAM2D_CASES)
def test_band_planes_equal_cgx(case):
    make, n, rows, cols = STREAM2D_CASES[case]
    dia, _ = _problem(make, n)
    want = np.asarray(cgx_dia.stream2d_band_planes(dia.bands, rows=rows, cols=cols))
    host = dia_spmv.stream2d_band_planes(dia.bands, rows=rows, cols=cols)
    dev = dia_spmv.stream2d_band_planes(torch.as_tensor(dia.bands), rows=rows, cols=cols)
    assert isinstance(host, np.ndarray) and host.shape == want.shape
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev.numpy(), want)
    # the flat band values are the planes' first n entries a band
    np.testing.assert_array_equal(host.reshape(len(dia.offsets), -1)[:, : dia.shape[0]],
                                  dia.bands)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stream_fp32_and_fp64_equal_the_resident_plain(dtype):
    """test_kernels.py:141-150: streaming and resident products agree bit for bit."""
    dia, x = _problem("lap2d_fd", 40)
    bands = torch.as_tensor(dia.bands.astype(dtype))
    xt = torch.as_tensor(x.astype(dtype))
    offs = tuple(dia.offsets)
    a = dia_spmv.dia_matvec(bands, xt, offsets=offs)
    b = dia_spmv.dia_matvec_stream(bands, xt, offsets=offs, block=256)
    c = dia_spmv.dia_matvec_stream2d(bands, xt, offsets=offs, rows=4, cols=128)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_argument_checks():
    """cgx's: block and cols multiples of 128 (dia_spmv.py:180, :276),
    the planes' shape against rows and cols (:340-345); and the operands'."""
    dia, x = _problem("lap2d_fd", 20)
    offs = tuple(dia.offsets)
    bands, xt = torch.as_tensor(dia.bands), torch.as_tensor(x)
    planes = dia_spmv.stream2d_band_planes(bands, rows=4, cols=128).contiguous()
    with pytest.raises(ValueError, match="multiple of 128"):
        dia_spmv.dia_matvec_stream(bands, xt, offsets=offs, block=100)
    with pytest.raises(ValueError, match="multiple of 128"):
        dia_spmv.dia_matvec_stream_ref(bands, xt, offsets=offs, block=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        dia_spmv.dia_matvec_stream2d(bands, xt, offsets=offs, rows=4, cols=96)
    with pytest.raises(ValueError, match="do not match"):
        dia_spmv.dia_matvec_stream2d_planes(planes, xt, offsets=offs, rows=4, cols=256)
    with pytest.raises(ValueError, match="do not match"):
        dia_spmv.dia_matvec_stream2d_planes(planes, xt, offsets=offs, rows=3, cols=128)
    with pytest.raises(ValueError, match="fewer than"):
        dia_spmv.dia_matvec_stream2d_planes(planes[:, :2].contiguous(), xt, offsets=offs,
                                            rows=2, cols=128)
    with pytest.raises(ValueError, match="offsets"):
        dia_spmv.dia_matvec_stream2d_planes(planes, xt, offsets=offs[:-1], rows=4, cols=128)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv.dia_matvec_stream2d_planes(planes.transpose(1, 2).contiguous().transpose(1, 2),
                                            xt, offsets=offs, rows=4, cols=128)
    with pytest.raises(ValueError, match="3-D"):
        dia_spmv.dia_matvec_stream2d_planes(bands, xt, offsets=offs, rows=4, cols=128)
    with pytest.raises(ValueError, match="differ"):
        dia_spmv.dia_matvec_stream2d_planes(planes.float(), xt, offsets=offs, rows=4, cols=128)
    with pytest.raises(ValueError, match="offsets"):
        dia_spmv.dia_matvec_stream(bands, xt, offsets=offs[:-1])
    with pytest.raises(TypeError):
        dia_spmv.dia_matvec_stream(bands.half(), xt.half(), offsets=offs)


# --- B8's schedule (csrc/dia_stream.cu), walked in torch --------------------


def stream_walk(plan, bands, x, offsets, *, rings=None):
    """``plan``'s persistent grid in torch: each block walks its run of
    tiles; x enters each cluster's ring (row modulo Q, the first four
    slots mirrored past the end) once, in runs of rows on the 16-byte
    grid (zeros outside [0, n)): the first tile's window, then each next
    tile's rows while the current tile reads; each thread's four rows
    read their taps as four consecutive slots. Fails on a read of a slot
    holding another row, and on a slot written while the tile that reads
    it runs. Returns y."""
    n, ndiag = x.shape[0], len(offsets)
    tile, threads = plan.tile, plan.threads
    qs = [c[2] for c in plan.clusters] if rings is None else rings
    flat = bands.reshape(ndiag, -1)
    y = torch.full((n,), float("nan"), dtype=x.dtype)
    ntiles = -(-n // tile)
    lane = torch.arange(4)
    tid = torch.arange(threads)
    for b in range(plan.grid):
        k0, k1 = b * plan.tiles_per_block, min(ntiles, (b + 1) * plan.tiles_per_block)
        if k0 >= k1:
            continue
        val = [torch.full((q + 4,), float("nan"), dtype=x.dtype) for q in qs]
        tag = [torch.full((q + 4,), -(2 ** 62), dtype=torch.int64) for q in qs]
        read = [torch.zeros(q + 4, dtype=torch.bool) for q in qs]

        def stage(c, j0, j1):
            assert j0 % 4 == 0 and j1 % 4 == 0
            rows = torch.arange(j0, j1)
            xs = torch.zeros(rows.numel(), dtype=x.dtype)
            ok = (rows >= 0) & (rows < n)
            xs[ok] = x[rows[ok]]
            slots = rows % qs[c]
            mirror = slots < 4
            for sl, keep in ((slots, slice(None)), (slots[mirror] + qs[c], mirror)):
                assert not read[c][sl].any(), "a slot is rewritten while its tile reads it"
                val[c][sl] = xs[keep]
                tag[c][sl] = rows[keep]

        def window(c, t):
            lo, hi = plan.clusters[c][:2]
            return (t + lo) // 4 * 4, -(-(t + tile + hi) // 4) * 4

        for c in range(len(qs)):
            stage(c, *window(c, k0 * tile))
        for k in range(k0, k1):
            t = k * tile
            for r in read:
                r.zero_()
            i = t + 4 * tid[:, None] + lane  # (threads, 4) rows
            acc = torch.zeros(i.shape, dtype=x.dtype)
            reads = []
            for d, off in enumerate(offsets):
                c = plan.diag_cluster[d]
                q = qs[c]
                s = (t + off) % q + 4 * tid
                s = torch.where(s >= q, s - q, s)[:, None] + lane
                assert torch.equal(tag[c][s], i + off), "a row was overwritten before its read"
                reads.append((c, s))
                band = torch.zeros(i.shape, dtype=x.dtype)
                ok = i < n
                band[ok] = flat[d, i[ok]]
                acc = acc + band * val[c][s]
            for c, s in reads:
                read[c][s.reshape(-1)] = True
            if k + 1 < k1:  # issued while the tile's products run
                for c in range(len(qs)):
                    j0 = window(c, t)[1]
                    stage(c, j0, j0 + tile)
            ok = i < n
            y[i[ok]] = acc[ok]
    return y


WALK_CASES = {  # (problem, planes (rows, cols) or None for the flat form)
    "planes_fd90": ("lap2d_fd", 90, (8, 512)),
    "planes_3d12": ("lap3d_fd", 12, (2, 512)),
    "flat_fd33": ("lap2d_fd", 33, None),  # n = 1089: n % 4 == 1, band rows off the 16-byte grid
    "flat_ref1001": ("lap2d_reference", 1001, None),  # n % 4 == 1, offsets +-1 and +-32
}


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_stream_walk_bitwise(case, dtype, sms):
    """The walk of B8's plan is bitwise the plain version, for the planes
    form and for the flat form with n % 4 != 0 (the scalar tail; copies
    of the last chunk zero-filled past n); with one SM (4 or 2 blocks,
    long runs of tiles) and 132."""
    make, g, planes = WALK_CASES[case]
    dia, x = _problem(make, g)
    offs = tuple(dia.offsets)
    bands = torch.as_tensor(dia.bands, dtype=dtype)
    xt = torch.as_tensor(x, dtype=dtype)
    if planes is not None:
        bands = dia_spmv.stream2d_band_planes(bands, rows=planes[0], cols=planes[1]).contiguous()
    n = xt.shape[0]
    plan = dia_spmv.stream_plan(n, offs, dtype, sms)
    want = dia_spmv.dia_matvec_stream_ref(bands.reshape(len(offs), -1)[:, :n].contiguous(), xt,
                                          offsets=offs)
    assert torch.equal(stream_walk(plan, bands, xt, offs), want)


def test_stream_walk_ring_short_fails():
    """A ring a tile shorter than the window and the next tile's rows
    loses rows the tile still reads."""
    dia, x = _problem("lap2d_fd", 90)
    offs = tuple(dia.offsets)
    xt = torch.as_tensor(x, dtype=torch.float32)
    bands = torch.as_tensor(dia.bands, dtype=torch.float32)
    plan = dia_spmv.stream_plan(xt.shape[0], offs, torch.float32, 1)
    q = plan.clusters[0][2]
    with pytest.raises(AssertionError, match="overwritten|rewritten"):
        stream_walk(plan, bands, xt, offs, rings=[q - plan.tile])


def test_stream_plan_at_main_shape():
    """lap2d_fd(3200): one cluster over the span 6400, a ring of 8,456
    values (2 tiles of 1024 rows, the span, 8 for the 16-byte grid) and
    its 4-value mirror; float32 4 blocks an SM, 19 tiles a block, float64
    2 and 38; the plan array of make_stream_plan. Offsets too far apart
    for one ring split at their widest gaps."""
    offs = (-3200, -1, 0, 1, 3200)
    for dtype, grid, per, shared in ((torch.float32, 527, 19, 33_840),
                                     (torch.float64, 264, 38, 67_680)):
        plan = dia_spmv.stream_plan(10_240_000, offs, dtype, 132)
        assert (plan.threads, plan.tile, plan.grid, plan.tiles_per_block) == (256, 1024, grid, per)
        assert plan.clusters == ((-3200, 3200, 8456, 0),) and plan.shared == shared
        assert plan.grid * plan.tiles_per_block * plan.tile >= 10_240_000
        arg, n_arg = plan.as_arg()
        assert list(arg) == [256, per, shared, 1, 5, -3200, 3200, 8456, 0, 0, 0, 0, 0, 0]
    far = dia_spmv.stream_plan(10**7, (-5_000_000, -1, 0, 1, 5_000_000), torch.float64, 132)
    assert [c[:2] for c in far.clusters] == [(-5_000_000, -5_000_000), (-1, 1),
                                            (5_000_000, 5_000_000)]
    assert far.diag_cluster == (0, 1, 1, 1, 2)


# --- B1 on B8's design: the plan and the dot's order ---------------------------


def test_b1_plan_takes_b8_at_the_solvers_shapes():
    """dia_matvec and dia_matvec_dot run B8's kernel on stream_plan
    wherever x's rings fit and n gives every SM a 1024-row tile (the main
    size, the resident size, a 7-point stencil of 157 tiles), else the
    grid-stride kernels (the three-kernel loop's fp64 goldens, 10 tiles;
    a 7-point stencil of 108); GRID_PLAN forces the grid-stride kernels;
    on the CPU a plan changes nothing."""
    for n, offs, dtype, design in (
            (10_000, (-100, -1, 0, 1, 100), torch.float64, "grid"),
            (135_167, (-367, -1, 0, 1, 367), torch.float32, "grid"),
            (135_168, (-367, -1, 0, 1, 367), torch.float32, "stream"),
            (1_000_000, (-1000, -1, 0, 1, 1000), torch.float32, "stream"),
            (10_240_000, (-3200, -1, 0, 1, 3200), torch.float32, "stream"),
            (110_592, (-2304, -48, -1, 0, 1, 48, 2304), torch.float32, "grid"),
            (157_464, (-2916, -54, -1, 0, 1, 54, 2916), torch.float64, "stream")):
        plan = dia_spmv.matvec_plan(n, offs, dtype, 132)
        assert plan == (dia_spmv.GRID_PLAN if design == "grid" else dia_spmv.MatvecPlan(
            "stream", dia_spmv.stream_plan(n, offs, dtype, 132)))
    assert dia_spmv.GRID_PLAN.design == "grid" and dia_spmv.GRID_PLAN.stream is None
    dia, x = _problem("lap2d_fd", 20)
    offs, bands, xt = tuple(dia.offsets), torch.as_tensor(dia.bands), torch.as_tensor(x)
    want = dia_spmv.dia_matvec_dot_ref(bands, xt, offsets=offs)
    for plan in (None, dia_spmv.GRID_PLAN):
        assert torch.equal(dia_spmv.dia_matvec(bands, xt, offsets=offs, plan=plan), want[0])
        y, d = dia_spmv.dia_matvec_dot(bands, xt, offsets=offs, plan=plan)
        assert torch.equal(y, want[0]) and torch.equal(d, want[1])


def _tree32(v):  # (..., 32) -> warp_sum's shuffle tree (common.cuh)
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _any_block_sum(v):
    """(..., threads) -> csrc/dia_stream.cu any_block_sum (and common.cuh
    block_sum at 256 threads): a tree a warp, then the warps' sums, padded
    to 32, in a tree."""
    w = _tree32(v.reshape(v.shape[:-1] + (v.shape[-1] // 32, 32)))
    pad = np.zeros(w.shape[:-1] + (32 - w.shape[-1],), dtype=v.dtype)
    return _tree32(np.concatenate([w, pad], -1))


def _last_block(parts, threads):
    """The last block's sum of the partials in index order: thread j adds
    partials j, j + threads, ..., then the block sum."""
    cols = -(-parts.size // threads)
    m = np.zeros(cols * threads, dtype=parts.dtype)
    m[:parts.size] = parts
    acc = np.zeros(threads, dtype=parts.dtype)
    for c in range(cols):
        acc = acc + m[c * threads:(c + 1) * threads]
    return _any_block_sum(acc)


def b8_dot(plan, prods):
    """<x, y> as dia_matvec_dot on B8's plan sums x[i] y[i]: a thread
    over its four rows, tile after tile of its block, in the data type;
    a block sum; the partials in index order in the last block."""
    tile, threads, per = plan.tile, plan.threads, plan.tiles_per_block
    m = np.zeros(plan.grid * per * tile, dtype=prods.dtype)
    m[:prods.size] = prods
    m = m.reshape(plan.grid, per, threads, 4)
    acc = np.zeros((plan.grid, threads), dtype=prods.dtype)
    for k in range(per):
        for e in range(4):
            acc = acc + m[:, k, :, e]
    return _last_block(_any_block_sum(acc), threads)


def grid_stride_dot(prods, threads=256, max_blocks=1024):
    """<r, r> as fused_update_rs sums it (csrc/axpy.cu, common.cuh): a
    grid-stride loop over grid_for(n) blocks, a block sum, the partials
    in index order in the last block."""
    grid = max(1, min(max_blocks, -(-prods.size // threads)))
    stride = grid * threads
    m = np.zeros(-(-prods.size // stride) * stride, dtype=prods.dtype)
    m[:prods.size] = prods
    acc = np.zeros(stride, dtype=prods.dtype)
    for c in range(m.size // stride):
        acc = acc + m[c * stride:(c + 1) * stride]
    return _last_block(_any_block_sum(acc.reshape(grid, threads)), threads)


def _three_kernel_replay(dia, conj_dot):
    """(k, x) of the float64 three-kernel loop at tol 1e-10 with <p, Ap>
    summed by ``conj_dot`` and <r, r> in fused_update_rs's order (the
    start <r, r>, torch.sum on the card, is numpy's pairwise sum here)."""
    n = dia.shape[0]
    b = gen.source_term(n)
    x, r, p = np.zeros(n), b.copy(), b.copy()
    rsold = float(np.sum(r * r))
    k = 0
    while k < n:
        ap = dia.mat_vec(p)
        conj = conj_dot(p * ap)
        alpha = rsold / max(conj, rsold * 1e-14)
        x, r = x + alpha * p, r - alpha * ap
        rr = grid_stride_dot(r * r)
        if np.sqrt(rr) < 1e-10:
            break
        p, rsold, k = (rr / rsold) * p + r, rr, k + 1
    return k, x, b


@pytest.mark.parametrize("make,g,window", [("lap2d_fd", 100, (485, 491)),
                                           ("lap2d_reference", 10_000, (604, 610))])
def test_b1_dot_order_replay_keeps_the_golden_counts(make, g, window):
    """The float64 three-kernel loop with <p, Ap> in dia_matvec_dot's
    order on B8's plan (10 blocks of one 1024-row tile at N = 10,000,
    as a caller forcing that design runs it) and <r, r> in
    fused_update_rs's converges inside the golden window with the
    reference's quality."""
    dia = getattr(gen, make)(g)
    plan = dia_spmv.stream_plan(dia.shape[0], tuple(dia.offsets), torch.float64, 132)
    assert (plan.grid, plan.tiles_per_block) == (10, 1)
    k, x, b = _three_kernel_replay(dia, lambda prods: b8_dot(plan, prods))
    assert window[0] <= k <= window[1]
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.parametrize("make,g,window", [("lap2d_fd", 100, (485, 491)),
                                           ("lap2d_reference", 10_000, (604, 610))])
def test_b1_grid_dot_order_replay_keeps_the_golden_counts(make, g, window):
    """The same with <p, Ap> in the grid-stride dia_matvec_dot's order
    (csrc/dia_spmv.cu: grid_for(n) blocks, a block sum, the last block's
    ticket), the design matvec_plan picks at N = 10,000."""
    dia = getattr(gen, make)(g)
    assert dia_spmv.matvec_plan(dia.shape[0], tuple(dia.offsets), torch.float64,
                                132) == dia_spmv.GRID_PLAN
    k, x, b = _three_kernel_replay(dia, grid_stride_dot)
    assert window[0] <= k <= window[1]
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


def test_b8_dot_order_sums_every_product_once():
    """The replayed orders sum each product once: on integers (exact in
    float64) they give the plain sum, at a ragged n and with blocks of
    several tiles."""
    prods = np.arange(1, 50_001, dtype=np.float64)
    for sms in (1, 132):
        plan = dia_spmv.stream_plan(prods.size, (-7, 0, 7), torch.float64, sms)
        assert b8_dot(plan, prods) == prods.sum()
    assert grid_stride_dot(prods) == prods.sum()

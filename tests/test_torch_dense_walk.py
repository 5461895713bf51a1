"""The dense kernels' summation grouping (csrc/matvec.cu), walked in torch.

Two walks written apart: :func:`persistent_walk`, the lane model of
``dense_matvec`` (the columns each of a warp's lanes sums, in order, and
the tree over the lanes), and :func:`kernel_walk`, a line-by-line
transcription of ``dense_matvec_persistent_kernel<T, ALIGNED, DOT>``
(spans of eight tiles on a warp or, for bfloat16 tiles of 16 or 8
vectors, on a half or a quarter of one, ``vdot``, ``peeled_part``,
``transpose_sum8``'s shuffles, the running sums, the products written
where y is, and the last block's ``warp_sum`` per row tile). bfloat16
inputs are summed in float (a product of two bfloat16 values is exact
there) and y rounds to bfloat16 once. ``tests/test_torch_matvec.py``
holds the two against each other on the CPU; the CUDA cases here hold
the card's kernels bitwise to :func:`kernel_walk`.

This file imports no JAX, so the CUDA cases run on a machine without
it: ``python -m pytest tests/test_torch_dense_walk.py --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

from cgx_torch.mats.generators import lap2d_fd, lap2d_reference
from cgx_torch.ops import matvec

H100_SMS = 132
LANES = torch.arange(32)
# (shape or problem, block_rows x block_cols): rows and tiles off the 16-byte grid,
# one-column tiles, and the CLI's odd N
CASES = ["129x257 64x128", "777x500 64x96", "40x70 1x1", "lap2d_reference(1001) 100x37"]
# bfloat16: tiles of 128 and 64 columns (16 and 8 vectors: spans on a half and a
# quarter warp, the CLI's 1024 x 128 among them), of 256 (a whole warp), and
# the peeled path off the 16-byte grid
BF16_CASES = ["lap2d_fd(24) 64x128", "lap2d_fd(24) 100x64", "lap2d_fd(24) 64x256",
              "256x384 64x128", "200x320 32x64", "lap2d_fd(23) 64x37"]
GENERATORS = {"lap2d_fd": lap2d_fd, "lap2d_reference": lap2d_reference}


def case_inputs(case: str, dtype, device="cpu"):
    """(a, x, block_rows, block_cols) of a CASES entry, seeded."""
    shape, tiles = case.split()
    br, bc = (int(v) for v in tiles.split("x"))
    if shape.startswith("lap2d"):
        name, arg = shape.rstrip(")").split("(")
        a = torch.as_tensor(GENERATORS[name](int(arg)).to_dense(), dtype=dtype)
    else:
        n_rows, n_cols = (int(v) for v in shape.split("x"))
        a = torch.as_tensor(np.random.default_rng(0).standard_normal((n_rows, n_cols)),
                            dtype=dtype)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(a.shape[1]), dtype=dtype)
    return a.to(device), x.to(device), br, bc


# --- the lane model ----------------------------------------------------------


def lane_cols(c0: int, c1: int, mis: int, vn: int, lanes: int = 32):
    """The columns of tile [c0, c1) each of a span's ``lanes`` lanes sums,
    in its order (csrc/matvec.cu peeled_part; the aligned path is mis =
    0): a scalar head up to the 16-byte grid, 16-byte vectors v = lane,
    lane + lanes, ..., a scalar tail."""
    head = min((vn - mis) % vn, c1 - c0)
    nvec = (c1 - c0 - head) // vn
    cb = c0 + head + nvec * vn
    out = []
    for lane in range(lanes):
        cols = [c0 + lane] if lane < head else []
        for v in range(lane, nvec, lanes):
            cols.extend(range(c0 + head + v * vn, c0 + head + (v + 1) * vn))
        out.append(cols + ([cb + lane] if lane < c1 - cb else []))
    return out


def tree32(v):  # (..., L) lanes, L a power of 2 -> the halving tree over them, L/2 first
    o = v.shape[-1] // 2
    while o >= 1:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def acc_of(dtype):
    """The dtype the kernels sum in (csrc/bf16.cuh Acc): float for bfloat16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def persistent_walk(a, x, block_cols, plan):
    """y as dense_matvec groups it on ``plan``: each lane's products of a
    tile in its order, the tree over the span's lanes, the tile sums in
    order; bfloat16 in float, y rounded once."""
    n_rows, n_cols = a.shape
    item = a.element_size()
    vn = 16 // item
    acc = acc_of(a.dtype)
    a_ext = torch.cat([a.to(acc), torch.zeros(n_rows, 1, dtype=acc)], 1)
    x_ext = torch.cat([x.to(acc), torch.zeros(1, dtype=acc)])
    rows = torch.arange(n_rows)
    y = torch.zeros(n_rows, dtype=acc)
    for c0 in range(0, n_cols, block_cols):
        c1 = min(c0 + block_cols, n_cols)
        tsum = torch.empty(n_rows, dtype=acc)
        for mis in range(vn):  # rows by where their tile starts against the 16-byte grid
            sel = rows[((rows * n_cols + c0) * item % 16) // item == mis] if not plan.aligned \
                else (rows if mis == 0 else rows[:0])
            if sel.numel() == 0:
                continue
            lanes = lane_cols(c0, c1, mis if not plan.aligned else 0, vn, plan.lanes)
            width = max(len(c) for c in lanes)
            idx = torch.tensor([c + [n_cols] * (width - len(c)) for c in lanes])  # (L, width)
            prods = a_ext[sel][:, idx] * x_ext[idx]  # (rows, L, width)
            part = torch.zeros(sel.numel(), plan.lanes, dtype=acc)
            for j in range(width):
                part = part + prods[:, :, j]
            tsum[sel] = tree32(part)
        y = y + tsum
    return y.to(a.dtype)


def row_walk(a, x, block_cols):
    """y as the one-warp-a-row dot kernel grouped it (one warp a row, lanes
    strided by 32 values along each tile): the grouping that differed."""
    n_rows, n_cols = a.shape
    y = torch.zeros(n_rows, dtype=a.dtype)
    for c0 in range(0, n_cols, block_cols):
        c1 = min(c0 + block_cols, n_cols)
        part = torch.zeros(n_rows, 32, dtype=a.dtype)
        for j in range(c0, c1, 32):
            seg = a[:, j:min(j + 32, c1)] * x[j:min(j + 32, c1)]
            part[:, :seg.shape[1]] = part[:, :seg.shape[1]] + seg
        y = y + tree32(part)
    return y


# --- the kernel, line by line ------------------------------------------------


def shfl_xor(v, mask: int):  # (..., L): lane l reads lane l ^ mask (mask < L: its group)
    return v[..., torch.arange(v.shape[-1]) ^ mask]


def shfl_down(v, delta: int):  # (..., 32): lane l reads lane l + delta, or its own
    src = LANES + delta
    return v[..., torch.where(src < 32, src, LANES)]


def transpose_sum8(v):
    """csrc/matvec.cu transpose_sum8<SUB> on (..., SUB, 8) values of one
    span's SUB lanes (32, 16 or 8): each lane's result, (..., SUB)."""
    sub = v.shape[-2]
    lanes = torch.arange(sub)
    h4, h3, h2 = (lanes & sub // 2) != 0, (lanes & sub // 4) != 0, (lanes & sub // 8) != 0
    a = []
    for i in range(4):
        send = torch.where(h4, v[..., i], v[..., i + 4])
        keep = torch.where(h4, v[..., i + 4], v[..., i])
        a.append(keep + shfl_xor(send, sub // 2))
    b = []
    for i in range(2):
        send = torch.where(h3, a[i], a[i + 2])
        keep = torch.where(h3, a[i + 2], a[i])
        b.append(keep + shfl_xor(send, sub // 4))
    send = torch.where(h2, b[0], b[1])
    keep = torch.where(h2, b[1], b[0])
    c = keep + shfl_xor(send, sub // 8)
    o = sub // 16
    while o >= 1:
        c = c + shfl_xor(c, o)
        o //= 2
    return c


def warp_sum(v):  # csrc/common.cuh warp_sum on (..., 32): lane 0's value
    for o in (16, 8, 4, 2, 1):
        v = v + shfl_down(v, o)
    return v[..., 0]


def mine(sub: int):
    """The tile whose sum each of a span's SUB lanes holds after transpose_sum8."""
    lanes = torch.arange(sub)
    return ((lanes & sub // 2) != 0) * 4 + ((lanes & sub // 4) != 0) * 2 + ((lanes & sub // 8) != 0)


MINE = mine(32)  # the tile a lane's sum is


def _vdot(p, a, xv):  # p + a . x, element by element in order: (..., VN) values
    for e in range(a.shape[-1]):
        p = p + a[..., e] * xv[..., e]
    return p


def _aligned_parts(a, x, rows, k0, tiles, span, block_cols, vn, last, sub=32):
    """The aligned path's lane partials of one span on its SUB lanes,
    (rows, SUB, 8): rounds j of a 16-byte vector v = lane + SUB j a lane
    and tile, in order."""
    full = block_cols // vn
    part = torch.zeros(rows.numel(), sub, 8, dtype=a.dtype)
    for j in range(-(-full // sub)):
        v = torch.arange(sub) + sub * j
        for g in range(8):
            t = span + g
            nv = full if t < tiles - 1 else (last if t == tiles - 1 else 0)
            live = v < nv
            if not bool(live.any()):
                continue
            cols = k0 + t * block_cols + v[live, None] * vn + torch.arange(vn)  # (lanes, vn)
            got = _vdot(part[:, live, g], a[rows][:, cols], x[cols])
            part[:, live, g] = got
    return part


def _peeled_part(a, x, rows, c0, c1, vn):
    """csrc/matvec.cu peeled_part for rows whose tile starts alike against
    the 16-byte grid: (rows, 32)."""
    item = 16 // vn  # the data type's bytes (a and x may come widened)
    n_cols = a.shape[1]
    mis = int(((rows[0] * n_cols + c0) * item % 16) // item)
    head = min(vn - mis if mis else 0, c1 - c0)
    nvec = (c1 - c0 - head) // vn
    cb = c0 + head + nvec * vn
    p = torch.zeros(rows.numel(), 32, dtype=a.dtype)
    ar = a[rows]
    for lane in range(32):
        if lane < head:
            p[:, lane] = p[:, lane] + ar[:, c0 + lane] * x[c0 + lane]
        for v in range(lane, nvec, 32):
            cols = c0 + head + v * vn + torch.arange(vn)
            p[:, lane] = _vdot(p[:, lane], ar[:, cols], x[cols])
        if lane < c1 - cb:
            p[:, lane] = p[:, lane] + ar[:, cb + lane] * x[cb + lane]
    return p


def kernel_walk(a, x, block_rows, block_cols, plan):
    """(y, dot) as dense_matvec_persistent_kernel<T, plan.aligned, true,
    plan.lanes> forms them on ``plan``: every block's rows by chunks of
    plan.chunk_cols, spans of eight tiles on plan.lanes lanes (a warp, or
    its half or quarter: the spans of one warp never mix) whose lane
    partials transpose_sum8 sums (lanes with lane % (SUB / 8) == 0 write
    tile span + mine), one thread a row adding a chunk's tile sums to its
    running sum; where y is written, prods = x * y (0 past n_cols; for
    bfloat16 the product rounds and is widened); then the last block: per
    row tile a warp, lanes strided by 32 from 0 and warp_sum, the tile sums
    in order. bfloat16 is summed in float and y rounds once."""
    n_rows, n_cols = a.shape
    item = a.element_size()
    vn = 16 // item
    acc_t = acc_of(a.dtype)
    a_in, x_in = a, x
    a, x = a.to(acc_t), x.to(acc_t)  # exact: bfloat16 widens to float
    sub = plan.lanes
    writers = torch.arange(sub) % max(1, sub // 8) == 0
    y = torch.zeros(n_rows, dtype=a_in.dtype)
    prods = torch.zeros(n_rows, dtype=acc_t)
    for blk in range(plan.grid):
        r0 = blk * plan.rows_per_cta
        if r0 >= n_rows:
            continue
        rows_all = torch.arange(r0, min(r0 + plan.rows_per_cta, n_rows))
        run = torch.zeros(rows_all.numel(), dtype=a.dtype)
        for k0 in range(0, n_cols, plan.chunk_cols):
            k1 = min(k0 + plan.chunk_cols, n_cols)
            tiles = -(-(k1 - k0) // block_cols)
            tsum = torch.zeros(rows_all.numel(), tiles, dtype=a.dtype)
            last = (k1 - (k0 + (tiles - 1) * block_cols)) // vn
            for span in range(0, tiles, 8):
                if plan.aligned:
                    parts = [(torch.arange(rows_all.numel()),
                              _aligned_parts(a, x, rows_all, k0, tiles, span, block_cols, vn,
                                             last, sub))]
                else:  # rows grouped by where their tile starts against the grid
                    parts = []
                    mis = ((rows_all * n_cols + k0) * item % 16) // item
                    for m in range(vn):
                        sel = torch.nonzero(mis == m).flatten()
                        if sel.numel() == 0:
                            continue
                        part = torch.zeros(sel.numel(), 32, 8, dtype=a.dtype)
                        for g in range(8):
                            c0 = k0 + (span + g) * block_cols
                            if span + g < tiles:
                                part[:, :, g] = _peeled_part(a, x, rows_all[sel], c0,
                                                             min(c0 + block_cols, k1), vn)
                        parts.append((sel, part))
                for sel, part in parts:
                    sums = transpose_sum8(part)  # (rows, SUB)
                    for lane in torch.nonzero(writers).flatten().tolist():
                        t = span + int(mine(part.shape[-2])[lane])
                        if t < tiles:
                            tsum[sel, t] = sums[:, lane]
            acc = torch.zeros_like(run) if k0 == 0 else run
            for t in range(tiles):
                acc = acc + tsum[:, t]
            run = acc
        y[rows_all] = run.to(a_in.dtype)
        in_x = rows_all < n_cols
        xy = x_in[rows_all[in_x]] * run[in_x].to(a_in.dtype)  # in the data type
        prods[rows_all[in_x]] = xy.to(acc_t)
    dot = torch.zeros((), dtype=acc_t)
    for t in range(-(-n_rows // block_rows)):
        r1 = min((t + 1) * block_rows, n_rows)
        seg = prods[t * block_rows:r1]
        s = torch.zeros(32, dtype=acc_t)
        for i in range(0, seg.numel(), 32):
            chunk = seg[i:i + 32]
            s[:chunk.numel()] = s[:chunk.numel()] + chunk
        dot = dot + warp_sum(s)
    return y, dot


# --- the primitives, against their trees ---------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transpose_sum8_is_a_tree_a_tile(dtype):
    """Lane l of transpose_sum8 holds tile MINE[l]'s sum over the 32
    lanes, by the halving tree (16 first), in every lane that holds it."""
    v = torch.as_tensor(np.random.default_rng(2).standard_normal((64, 32, 8)), dtype=dtype)
    got = transpose_sum8(v)
    for lane in range(32):
        assert torch.equal(got[:, lane], tree32(v[:, :, int(MINE[lane])]))


@pytest.mark.parametrize("sub", [16, 8])
def test_transpose_sum8_sub_warps_are_trees(sub):
    """transpose_sum8<SUB> on a half or a quarter warp: lane l holds tile
    mine(SUB)[l]'s sum over the SUB lanes of its span, by the halving tree
    (SUB/2 first), in every lane that holds it; on 32 lanes it is the
    warp's."""
    v = torch.as_tensor(np.random.default_rng(4).standard_normal((64, sub, 8)),
                        dtype=torch.float32)
    got, tiles = transpose_sum8(v), mine(sub)
    for lane in range(sub):
        assert torch.equal(got[:, lane], tree32(v[:, :, int(tiles[lane])]))
    assert torch.equal(mine(32), MINE)
    assert sorted(tiles[torch.arange(sub) % (sub // 8) == 0].tolist()) == list(range(8))


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_walk_is_the_plain_y(case):
    """bfloat16 on dense_plan's plan (spans on 16 or 8 lanes for tiles of
    128 or 64 columns): the line-by-line walk's y is bitwise the lane
    model's, and on the lap2d matrices (whose row sums are exact in float)
    bitwise dense_matvec_ref's; its dot is the plain version's within
    float32 sums in another order."""
    a, x, br, bc = case_inputs(case, torch.bfloat16)
    plan = matvec.dense_plan(a.shape[0], a.shape[1], bc, torch.bfloat16, H100_SMS)
    assert plan.lanes == matvec.span_lanes(bc, torch.bfloat16) if plan.aligned else 32
    y, d = kernel_walk(a, x, br, bc, plan)
    assert y.dtype == torch.bfloat16 and d.dtype == torch.float32
    assert torch.equal(y, persistent_walk(a, x, bc, plan))
    want_y, want_d = matvec.dense_matvec_dot_ref(a, x, block_rows=br, block_cols=bc)
    if case.startswith("lap2d"):
        assert torch.equal(y, want_y)
    else:
        assert float((y.float() - want_y.float()).abs().max()) <= \
            2 ** -7 * float(want_y.float().abs().max())
    m = min(a.shape)
    scale = float((x[:m].float() * y[:m].float()).abs().sum())
    assert abs(float(d) - float(want_d)) <= 1e-5 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warp_sum_is_the_tree(dtype):
    v = torch.as_tensor(np.random.default_rng(3).standard_normal((64, 32)), dtype=dtype)
    assert torch.equal(warp_sum(v), tree32(v))


# --- the card's kernels, bitwise the walk -------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CASES)
def test_cuda_dense_kernels_are_the_walk(cuda, case, dtype):
    """dense_matvec's y and dense_matvec_dot's y and dot are bitwise
    kernel_walk's on the plan the card ran."""
    a, x, br, bc = case_inputs(case, dtype, cuda)
    y1 = matvec.dense_matvec(a, x, block_rows=br, block_cols=bc)
    y2, d = matvec.dense_matvec_dot(a, x, block_rows=br, block_cols=bc)
    plan = matvec.dense_matvec.plan
    assert matvec.dense_matvec_dot.plan == plan
    want_y, want_d = kernel_walk(a.cpu(), x.cpu(), br, bc, plan)
    assert torch.equal(y1.cpu(), want_y) and torch.equal(y2.cpu(), want_y)
    assert torch.equal(d.cpu(), want_d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_CASES)
def test_cuda_bf16_dense_kernels_are_the_walk(cuda, case):
    """The bfloat16 builds on the plan the card ran (spans on 16 or 8
    lanes where the tiles have 16 or 8 vectors): dense_matvec's y and
    dense_matvec_dot's y and dot bitwise kernel_walk's; with the spans
    forced onto whole warps (the design before) y is the same on the lap2d
    matrices."""
    a, x, br, bc = case_inputs(case, torch.bfloat16, cuda)
    y1 = matvec.dense_matvec(a, x, block_rows=br, block_cols=bc)
    y2, d = matvec.dense_matvec_dot(a, x, block_rows=br, block_cols=bc)
    plan = matvec.dense_matvec.plan
    assert matvec.dense_matvec_dot.plan == plan
    want_y, want_d = kernel_walk(a.cpu(), x.cpu(), br, bc, plan)
    assert torch.equal(y1.cpu(), want_y) and torch.equal(y2.cpu(), want_y)
    assert torch.equal(d.cpu(), want_d)
    if case.startswith("lap2d"):
        y32 = matvec.dense_matvec(a, x, block_rows=br, block_cols=bc,
                                  plan=plan._replace(lanes=32))
        assert torch.equal(y32.cpu(), want_y)

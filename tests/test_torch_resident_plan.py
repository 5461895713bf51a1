"""The resident design of the whole-solve kernel (cgx_torch/csrc/cg_kernel.cu
dia_cg_resident_kernel, site B5), on the CPU: resident_plan's choice of
design and bytes at the main shapes, and a pure-torch walk of the plan
that runs the kernel's schedule (each block on its rows, x, r and Ap of
its own; p, and c with the preconditioner, over its rows and halo; the
halo formed from the published pairs of the iteration before, by parity;
p applied at the start of the next iteration or at the launch's end)
against the plain version bitwise, through frozen iterations and chunks
that end mid-way. The walk marks every published value it did not write
as NaN and fails on a halo read of one. The card runs the same schedule
(test_torch_wrappers.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import cgx
from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
from cgx.mats.generators import source_term
from cgx.ops.cg_kernel import dia_cg_solve_vmem as cgx_vmem
from cgx_torch.mats.generators import lap2d_fd, lap2d_reference, lap3d_fd
from cgx_torch.ops import cg_kernel as ck
from cgx_torch.ops.cg_kernel import _dot, dia_cg_chunk_ref

H100_SMS = 132
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


@pytest.mark.parametrize(
    "n,reach,dtype,bands_dtype,precond,want",
    [  # lap2d_fd(1000): 7,576 rows a block, 16 a thread, bands on chip in each float32 case
     (1_000_000, 1000, F32, F32, False, ("resident", 132, 7576, 16, True, 189_824)),
     (1_000_000, 1000, F32, F32, True, ("resident", 132, 7576, 16, True, 228_128)),
     (1_000_000, 1000, F32, BF16, True, ("resident", 132, 7576, 16, True, 152_368)),
     (1_000_000, 1000, F32, BF16, False, ("resident", 132, 7576, 16, True, 114_064)),
     # float64 vectors would need 16 rows a thread: the global design
     (1_000_000, 1000, F64, F64, False, ("global", 0, 0, 0, False, 0)),
     # the fp64 goldens: 76 rows a block, the reach 100 spans two blocks
     (10_000, 100, F64, F64, False, ("resident", 132, 76, 4, True, 5_248)),
     (10_000, 100, F64, F64, True, ("resident", 132, 76, 4, True, 7_456)),
     # the crossover's sizes
     (250_000, 500, F32, F32, True, ("resident", 132, 1894, 4, True, 61_040)),
     (1_999_396, 1414, F32, F32, False, ("global", 0, 0, 0, False, 0)),
     (4_000_000, 2000, F32, F32, True, ("global", 0, 0, 0, False, 0))],
)
def test_resident_plan_at_main_shapes(n, reach, dtype, bands_dtype, precond, want):
    offsets = (-reach, -1, 0, 1, reach)
    plan = ck.resident_plan(n, offsets, dtype, bands_dtype, precond, H100_SMS)
    got = (plan.design, plan.grid, plan.rows, plan.rows_per_thread, plan.bands_shared,
           plan.shared)
    assert got == want
    if plan.design == "resident":
        item, band_item = dtype.itemsize, bands_dtype.itemsize
        assert (plan.left, plan.right) == (reach, reach)
        assert plan.grid * plan.rows >= n > (plan.grid - 1) * plan.rows
        assert plan.rows_per_thread * ck.RES_THREADS >= plan.rows
        vectors = (plan.rows + 2 * reach) * item * (2 if precond else 1)
        assert plan.shared == vectors + -(-5 * plan.rows * band_item // 16) * 16
        assert plan.shared + ck.RES_STATIC <= ck.SHARED_OPTIN
        arg, arg_len = plan.as_arg()
        assert list(arg) == [512, plan.rows, plan.rows_per_thread, reach, reach, 1, plan.shared]


def test_resident_plan_streams_bands_where_only_the_vectors_fit():
    """Bands that outgrow shared memory beside p and c stay in device
    memory (read through L2); vectors that do not fit either take the
    global design."""
    offsets = tuple(range(-7, 8))  # 15 diagonals
    plan = ck.resident_plan(1_000_000, offsets, F32, F32, True, H100_SMS)
    assert plan.design == "resident" and not plan.bands_shared
    assert plan.shared == (7576 + 14) * 4 * 2
    wide = (-20_000, 0, 20_000)  # p and c over the halo: 190 KB, and the bands do not fit
    assert not ck.resident_plan(1_000_000, wide, F32, F32, False, H100_SMS).bands_shared
    assert ck.resident_plan(1_000_000, wide, F32, F32, True, H100_SMS).design == "global"


def resident_walk(plan, bands, p, x, r, scal, *, offsets, tol, nearzero, maxiter, chunk,
                  precond=False):
    """One launch of the resident design on ``plan`` in torch: advances p,
    x and r in place and returns the new scalars. The dots are the plain
    version's (the walk is of the vectors' schedule; the dots' grouping
    is replayed in test_torch_cg_kernel.py)."""
    n, dt = x.shape[0], x.dtype
    offs = tuple(int(o) for o in offsets)
    bw = bands.to(dt)
    invd = 1.0 / bw[offs.index(0)] if precond else None
    left, right = plan.left, plan.right
    span = plan.rows + left + right
    blocks = [(b * plan.rows, min(n, (b + 1) * plan.rows)) for b in range(plan.grid)]
    assert all(lo < hi for lo, hi in blocks) and blocks[-1][1] == n
    assert -min(offs) <= left and max(offs) <= right
    nan = float("nan")
    pub = {name: [torch.full((n,), nan, dtype=dt) for _ in range(2)] for name in "psc"}

    def publish(name, q, lo, hi, vals):
        i = torch.arange(lo, hi)
        keep = (i >= hi - left) | (i < lo + right)
        pub[name][q][i[keep]] = vals[keep]

    def halo(name, q, ext, lo, hi, form):
        """Rows [elo, lo) and [hi, ehi) of ext from the published pairs."""
        for a0, a1 in ((max(0, lo - left), lo), (hi, min(n, hi + right))):
            vals = [pub[nm][q][a0:a1] for nm in name]
            assert not any(torch.isnan(v).any() for v in vals), "a halo row was not published"
            ext[a0 - (lo - left):a1 - (lo - left)] = form(*vals)

    def product(ext, lo, hi):  # rows [lo, hi) of A v, v over the block's rows and halo
        i = torch.arange(lo, hi)
        acc = torch.zeros(hi - lo, dtype=dt)
        for d, off in enumerate(offs):
            j = i + off
            ok = (j >= 0) & (j < n)
            v = ext[(j - (lo - left)).clamp(0, span - 1)]
            assert not torch.isnan(v[ok]).any()
            acc = acc + bw[d, lo:hi] * torch.where(ok, v, torch.zeros((), dtype=dt))
        return acc

    def own(ext, lo, hi):
        return ext[left:left + hi - lo]

    xs = [x[lo:hi].clone() for lo, hi in blocks]
    rs = [r[lo:hi].clone() for lo, hi in blocks]
    ws = [None] * len(blocks)
    psh = [None] * len(blocks)
    rsold, conv, k, brk = scal.clone().unbind()
    tol_t, maxiter_t = (torch.tensor(v, dtype=F64) for v in (tol, maxiter))
    one = torch.tensor(1.0, dtype=F64)
    nearzero_t = torch.tensor(nearzero, dtype=dt)
    beta, ran, pending = None, False, False
    for it in range(chunk):
        if not bool((conv == 0) & (k < maxiter_t)):
            break
        q = it & 1
        # (A) p on each block's rows and halo, published; Ap
        for b, (lo, hi) in enumerate(blocks):
            ext = torch.full((span,), nan, dtype=dt)
            if it == 0:
                a0, a1 = max(0, lo - left), min(n, hi + right)
                ext[a0 - (lo - left):a1 - (lo - left)] = p[a0:a1]
            else:
                src = ws[b] if precond else rs[b]
                ext[left:left + hi - lo] = src + beta * own(psh[b], lo, hi)
                halo("sp", q ^ 1, ext, lo, hi, lambda s, pv: s + beta * pv)
            psh[b] = ext
        for b, (lo, hi) in enumerate(blocks):
            publish("p", q, lo, hi, own(psh[b], lo, hi))
        aps = [product(psh[b], lo, hi) for b, (lo, hi) in enumerate(blocks)]
        pv = torch.cat([own(psh[b], lo, hi) for b, (lo, hi) in enumerate(blocks)])
        conj = _dot(pv, torch.cat(aps))
        brk = torch.where(conj <= 0, one, brk)
        # (B) alpha, x, r; publish r, or c
        alpha = (rsold / torch.maximum(conj, rsold * nearzero_t)).to(dt)
        for b, (lo, hi) in enumerate(blocks):
            xs[b] = xs[b] + alpha * own(psh[b], lo, hi)
            rs[b] = rs[b] - alpha * aps[b]
        rv = torch.cat(rs)
        rr = _dot(rv, rv)
        if precond:  # (Z) c's halo from this iteration's pair, z; publish z
            cs = []
            for b, (lo, hi) in enumerate(blocks):
                c = invd[lo:hi] * rs[b]
                publish("c", q, lo, hi, c)
                cs.append(c)
            for b, (lo, hi) in enumerate(blocks):
                ext = torch.full((span,), nan, dtype=dt)
                ext[left:left + hi - lo] = cs[b]
                halo("c", q, ext, lo, hi, lambda cv: cv)
                ws[b] = 2.0 * cs[b] - invd[lo:hi] * product(ext, lo, hi)
                publish("s", q, lo, hi, ws[b])
            rsnew = _dot(rv, torch.cat(ws))
        else:
            for b, (lo, hi) in enumerate(blocks):
                publish("s", q, lo, hi, rs[b])
            rsnew = rr
        ran = True
        if bool(torch.sqrt(rr) < tol_t):
            conv, pending = one, False
        else:
            beta, pending = (rsnew / rsold).to(dt), True
            rsold, k = rsnew, k + one
    for b, (lo, hi) in enumerate(blocks):
        if ran:
            pb = own(psh[b], lo, hi)
            p[lo:hi] = ((ws[b] if precond else rs[b]) + beta * pb) if pending else pb
        x[lo:hi] = xs[b]
        r[lo:hi] = rs[b]
    return torch.stack([rsold, conv, k, brk])


def _state(dia, dtype, seed=0):
    n = dia.shape[0]
    g = np.random.default_rng(seed)
    p, x, r = (torch.as_tensor(g.standard_normal(n), dtype=dtype) for _ in range(3))
    scal = torch.tensor([float(torch.sum(r.double() ** 2)), 0.0, 0.0, 0.0], dtype=F64)
    return [p, x, r, scal]


WALK_CASES = {  # problem, sms: a halo within a neighbour, and one that spans several blocks
    "fd12_sms5": (lambda: lap2d_fd(12), 5),
    "fd12_sms40": (lambda: lap2d_fd(12), 40),  # 4 rows a block, reach 12
    "ref300_sms132": (lambda: lap2d_reference(300), 132),
    "3d5_sms7": (lambda: lap3d_fd(5), 7),  # 7 diagonals, reach 25
}


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("dtype,bf16", [(F32, False), (F64, False), (F32, True)])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_resident_walk_bitwise(case, dtype, bf16, precond):
    """Launches of chunk 1, 5 and 64 in turn, from a seeded state, with
    tol 0: p, x, r and the scalars bitwise the plain version's."""
    make, sms = WALK_CASES[case]
    dia = make()
    n = dia.shape[0]
    bands = torch.as_tensor(dia.bands, dtype=dtype)
    if bf16:
        bands = bands.to(BF16)
    plan = ck.resident_plan(n, tuple(dia.offsets), dtype, bands.dtype, precond, sms)
    assert plan.design == "resident"
    walk, ref = _state(dia, dtype), _state(dia, dtype)
    kw = dict(offsets=dia.offsets, tol=0.0, nearzero=1e-14, maxiter=10**9, precond=precond)
    for chunk in (1, 5, 64):
        walk[3] = resident_walk(plan, bands, *walk, chunk=chunk, **kw)
        ref[3] = dia_cg_chunk_ref(bands, *ref, chunk=chunk, **kw)
        for got, want in zip(walk, ref):
            assert torch.equal(got, want)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("maxiter", [None, 37])
def test_resident_walk_frozen_iterations(precond, maxiter):
    """A whole solve by chunks of 16 through the walk stops where the
    plain version does, converging or at maxiter in the middle of a
    chunk: the frozen iterations leave p, x, r and k alone."""
    dia = lap2d_fd(12)
    n = dia.shape[0]
    b = torch.as_tensor(source_term(n), dtype=F32)
    tol = 0.0 if maxiter else 1e-4 * float(torch.linalg.norm(b.double()))
    bands = torch.as_tensor(dia.bands, dtype=F32)
    plan = ck.resident_plan(n, tuple(dia.offsets), F32, F32, precond, 9)
    runs = []
    for fn in (lambda *a, **k: resident_walk(plan, *a, **k), dia_cg_chunk_ref):
        if precond:
            invd = 1.0 / bands[2]
            c0 = invd * b
            p = 2.0 * c0 - invd * ck.dia_matvec_ref(bands, c0, offsets=dia.offsets)
        else:
            p = b.clone()
        state = [p, torch.zeros(n), b.clone(),
                 torch.tensor([float(_dot(b, p)), 0.0, 0.0, 0.0], dtype=F64)]
        for _ in range(40):
            state[3] = fn(bands, *state, offsets=dia.offsets, tol=tol, nearzero=1e-14,
                          maxiter=n if maxiter is None else maxiter, chunk=16, precond=precond)
        runs.append(state)
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    k = int(runs[0][3][2])
    assert (k == maxiter) if maxiter else (0 < k < 16 * 40 and runs[0][3][1] == 1.0)
    assert k % 16 != 0, k  # the chunk that ends the solve ends mid-way


def test_resident_walk_catches_a_missing_halo():
    """A plan whose halo misses the reach reads rows no one published."""
    dia = lap2d_fd(12)
    plan = ck.resident_plan(144, tuple(dia.offsets), F32, F32, False, 12)
    short = plan._replace(left=plan.left - 1, right=plan.right - 1)
    state = _state(dia, F32)
    with pytest.raises(AssertionError):
        resident_walk(short, torch.as_tensor(dia.bands, dtype=F32), *state,
                      offsets=dia.offsets, tol=0.0, nearzero=1e-14, maxiter=100, chunk=3)


def test_resident_walk_solve_matches_cgx():
    """A whole solve driven by the walk, chunk 32, against cgx's
    dia_cg_solve_vmem in interpret mode on lap2d_fd(24): the count
    within 1 and x to float32 rounding."""
    import jax.numpy as jnp

    g = 24
    dia = lap2d_fd(g)
    n = dia.shape[0]
    b = np.asarray(source_term(n), np.float32)
    tol = 1e-4 * float(np.linalg.norm(b.astype(np.float64)))
    want = cgx_vmem(cgx.DiaOperator.from_host(cgx_lap2d_fd(g), dtype=jnp.float32),
                    jnp.asarray(b), tol=tol, chunk=32, interpret=True)
    bands = torch.as_tensor(dia.bands, dtype=F32)
    plan = ck.resident_plan(n, tuple(dia.offsets), F32, F32, False, H100_SMS)
    bt = torch.as_tensor(b)
    state = [bt.clone(), torch.zeros(n), bt.clone(),
             torch.tensor([float(_dot(bt, bt)), 0.0, 0.0, 0.0], dtype=F64)]
    while state[3][1] == 0 and state[3][2] < n:
        state[3] = resident_walk(plan, bands, *state, offsets=dia.offsets, tol=tol,
                                 nearzero=1e-14, maxiter=n, chunk=32)
    assert abs(int(state[3][2]) - int(want.iterations)) <= 1
    wx = np.asarray(want.x, np.float64)
    np.testing.assert_allclose(state[1].numpy(), wx, rtol=3e-3, atol=1e-2 * np.abs(wx).max())

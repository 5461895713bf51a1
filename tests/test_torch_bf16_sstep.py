"""The fused s-step block on bfloat16 vectors (ROADMAP A6) against cgx,
on the CPU.

Kernels B9 and B10 run here as their plain versions, which their
bfloat16 builds equal bit for bit on the card (``chip_smoke.py``'s
``bf16_sstep_kernels`` and ``bf16_sstep``); cgx's kernels run in
interpret mode. The inputs are seeded NumPy vectors or cgx's own
generators.

Where the two packages differ by design (ROADMAP C): cgx sums the Gram's
products (exact in float32) in float32 within a block and double-float32
across blocks, and replays in float32 with compensated quadratic forms;
the port sums in float64 and replays in float64. So G is held to
GRAM_RTOL of sum |v_i v_j| and the coefficients to COEF_RTOL. Given the
same coefficients, the recover's r and p are bitwise cgx's, and x is
within X_ROUNDINGS half-ulps of its scale: cgx adds x's 2s+1 terms one
by one, the port the whole increment once (cgx's loop does so).
"""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.mats.generators import lap2d_fd as cgx_lap2d_fd
from cgx.ops.dia_powers import _powers_geometry
from cgx.ops.dia_powers import dia_sstep_basis_planes as cgx_basis_planes
from cgx.ops.dia_powers import sstep_powers_band_planes as cgx_band_planes
from cgx.ops.sstep_stream import _sstep_gram as cgx_gram
from cgx.ops.sstep_stream import _sstep_recover as cgx_recover
from cgx.solver.sstep import _basis_matrix as cgx_bmat
from cgx.solver.sstep import replay_block as cgx_replay
from cgx.solver.sstep import sstep_cg_solve as cgx_sstep
from cgx_torch import SolveConfig
from cgx_torch.mats.containers import COOMatrix, DIAMatrix
from cgx_torch.mats.generators import lap2d_fd, lap2d_fd_coo_lower, source_term
from cgx_torch.ops import dia_powers
from cgx_torch.ops import sstep_stream as ss
from cgx_torch.ops._util import BUILD_LAUNCHES
from cgx_torch.solver.sstep import sstep_cg_solve

S = 4
THETA, DELTA = 4.0, 3.9
NEWTON = (3.0, 5.0, 3.5, 4.5)
BF16 = torch.bfloat16
GRAM_RTOL = 4e-6  # cgx's float32 sums against float64 ones, relative to sum |v_i v_j|
COEF_RTOL = 1e-5  # cgx's float32 replay against the float64 one, relative to max |coef|
X_ROUNDINGS = 2 * (2 * S + 1) + 1  # half-ulps of |x0| + sum |c_i V_i| between the two x's
TOL_REL = 5e-2  # cgx's own bf16 test's tolerance (tests/test_api.py:72-77)
STEP = re.compile(r"\[STEP (\d+)\] residual = ([0-9.e+-]+)")


def _seeded(n: int, count: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(count)]


def _bf16(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32)).to(BF16)


def _from_cgx(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a.astype(jnp.float32))).to(BF16)


@pytest.mark.parametrize("shifts", [(), NEWTON], ids=["chebyshev", "newton"])
def test_basis_matches_cgx(shifts):
    """B9's bfloat16 plain version against cgx's dia_sstep_basis_planes,
    interpreted, on lap2d_fd(16), s = 4: bit for bit (both round each
    operation to bfloat16 in the same order); the wrapper counts the
    launch by its _bf16 build."""
    dia = cgx_lap2d_fd(16)
    n, offsets = dia.shape[0], tuple(dia.offsets)
    p, r = _seeded(n, 2)
    kw = dict(offsets=offsets, s=S, theta=THETA, delta=DELTA, shifts=shifts, rows=16, cols=128)
    want = cgx_basis_planes(cgx_band_planes(jnp.asarray(dia.bands, jnp.bfloat16), offsets=offsets,
                                            s=S, rows=16, cols=128),
                            jnp.asarray(p, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16),
                            interpret=True, **kw)
    before = BUILD_LAUNCHES["dia_sstep_basis_planes_bf16"]
    got = dia_powers.dia_sstep_basis_planes(
        dia_powers.sstep_powers_band_planes(_bf16(dia.bands), offsets=offsets, s=S, rows=16,
                                            cols=128), _bf16(p), _bf16(r), **kw)
    assert got.dtype == BF16 and got.shape == (2 * S + 1, n)
    assert torch.equal(got, _from_cgx(want))
    assert BUILD_LAUNCHES["dia_sstep_basis_planes_bf16"] == before + 1


def test_block_matches_cgx():
    """One B10 block on bfloat16 vectors from seeded p, r and x on
    lap2d_fd(32), against cgx's _sstep_gram, replay_block and
    _sstep_recover, interpreted: G within GRAM_RTOL, the replay's flags
    equal and its coefficients within COEF_RTOL; the recover from the
    port's coefficients (rounded to bfloat16, as both round them): r and
    p bit for bit, x within X_ROUNDINGS half-ulps of |x0| + sum |c_i V_i|."""
    dia = cgx_lap2d_fd(32)
    n, offsets, m = dia.shape[0], tuple(dia.offsets), 2 * S + 1
    p, r, x = _seeded(n, 3)
    rows, cols = 32, 128  # cgx's recover needs rows >= its halo (pm = 32 here)
    n_p, _, _, _, pm, _ = _powers_geometry(offsets, S, rows, cols, jnp.bfloat16, n)
    kw = dict(offsets=offsets, s=S, theta=THETA, delta=DELTA, shifts=(), rows=rows, cols=cols,
              interpret=True)
    bpl = cgx_band_planes(jnp.asarray(dia.bands, jnp.bfloat16), offsets=offsets, s=S, rows=rows,
                          cols=cols, align_dtype=jnp.bfloat16)

    def plane(v):
        return jnp.pad(jnp.asarray(v, jnp.bfloat16), (pm * cols, pm * cols + n_p - n)).reshape(
            -1, cols)

    g2 = cgx_gram(bpl, plane(p), plane(r), **kw)
    bands = _bf16(dia.bands)
    st = ss.initial_state(bands, _bf16(r), torch.zeros(n, dtype=BF16), 0.0, offsets=offsets,
                          s=S, theta=THETA, delta=DELTA)
    st.p[0].copy_(_bf16(p))
    st.x.copy_(_bf16(x))
    x0 = st.x.clone()
    ss._sstep_gram(bands, st.p, st.r, st.state, st.bmat, offsets=offsets, s=S, theta=THETA,
                   delta=DELTA, tol=0.0, nearzero=1e-14, maxiter=10**6)
    g = st.state[ss.GRAM:ss.GRAM + m * m].view(m, m)
    v = ss.dia_sstep_basis_ref(bands, _bf16(p), _bf16(r), offsets=offsets, s=S, theta=THETA,
                               delta=DELTA).double()
    scale = v.abs() @ v.abs().T
    assert float(((g - torch.as_tensor(np.asarray(g2[0] + g2[1], np.float64))).abs()
                  / scale).max()) <= GRAM_RTOL
    rs0 = jnp.float32(float(torch.sum(_bf16(r).double() ** 2)))
    xc, d, c, k, _, _, conv, brk = cgx_replay(
        jnp.asarray(g2[0] + g2[1]), jnp.asarray(cgx_bmat(S, THETA, DELTA, np.float64, ()),
                                                jnp.float32),
        S, jnp.asarray(0, jnp.int32), rs0, jnp.asarray(False), jnp.asarray(False),
        tol=jnp.float32(0.0), nearzero=jnp.float32(1e-14), maxiter=10**6)
    coef = st.state[ss.COEF:ss.COEF + 3 * m].view(3, m)
    want = torch.as_tensor(np.asarray(jnp.stack([xc, d, c]), np.float64))
    assert float((coef - want).abs().max() / coef.abs().max()) <= COEF_RTOL
    assert [st.state[ss.K].item(), st.state[ss.CONV].item(), st.state[ss.BRK].item()] == [
        int(k), float(bool(conv)), float(bool(brk))]
    coef16 = coef.to(BF16)
    x_out, r_out, p_out = cgx_recover(
        bpl, plane(p), plane(r), jnp.pad(jnp.asarray(x, jnp.bfloat16), (0, n_p - n)).reshape(
            -1, cols), jnp.asarray(coef16.float().numpy(), jnp.bfloat16), **kw)
    ss._sstep_recover(bands, st.p, st.r, st.x, st.state, offsets=offsets, s=S, theta=THETA,
                      delta=DELTA)
    inner = slice(pm * cols, pm * cols + n)
    assert torch.equal(st.r[1], _from_cgx(r_out).reshape(-1)[inner])
    assert torch.equal(st.p[1], _from_cgx(p_out).reshape(-1)[inner])
    terms = x0.double().abs() + (coef16[0].double().abs()[:, None] * v.abs()).sum(0)
    diff = (st.x.double() - _from_cgx(x_out).reshape(-1)[:n].double()).abs()
    assert bool((diff <= X_ROUNDINGS * 2.0 ** -8 * terms).all())


@pytest.fixture(scope="module")
def fused32():
    """lap2d_fd(32) with source_term at 5e-2 ||b||, and cgx's fused
    bfloat16 solve of it, interpreted (about 20 s), once."""
    b = source_term(1024)
    tol = TOL_REL * float(np.linalg.norm(b))
    cfg = dict(precision="bf16", method="sstep", sstep_powers="fused", tolerance=tol)
    want = cgx.solve(cgx_lap2d_fd(32), b, cgx.SolveConfig(**cfg))
    return b, cfg, want


def _true_rel(dia, x, b) -> float:
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b))


def test_solve_matches_cgx(fused32):
    """solve(precision="bf16", method="sstep", sstep_powers="fused") on
    lap2d_fd(32) against cgx's interpreted route: both converge without a
    breakdown (cgx in 36 iterations), the port within s of cgx's k (its
    float64 Gram and replay, ROADMAP C), both true residuals at
    bfloat16's level and within 2x of each other; every block on the
    _bf16 builds of both launches."""
    b, cfg, want = fused32
    dia = lap2d_fd(32)
    before = {k: BUILD_LAUNCHES[k] for k in ("sstep_gram_bf16", "sstep_recover_bf16")}
    got = cgx_torch.solve(dia, b, SolveConfig(**cfg), device="cpu")
    blocks = {k: BUILD_LAUNCHES[k] - v for k, v in before.items()}
    assert bool(want.converged) and not bool(want.breakdown) and int(want.iterations) == 36
    assert bool(got.converged) and not bool(got.breakdown) and got.x.dtype == BF16
    assert abs(int(got.iterations) - int(want.iterations)) <= S
    assert blocks["sstep_gram_bf16"] == blocks["sstep_recover_bf16"] >= int(got.iterations) / S
    rel_got = _true_rel(dia, got.x.double().numpy(), b)
    rel_want = _true_rel(dia, np.asarray(want.x.astype(jnp.float32)), b)
    assert max(rel_got, rel_want) <= 2 * min(rel_got, rel_want) and rel_got < 1.0


@pytest.mark.parametrize("fallback", ["off", "auto", "adaptive"])
def test_breakdown_fallback_flags_match_cgx(fallback):
    """A replay breakdown on bfloat16 vectors and what follows it, against
    cgx's: on -lap2d_fd(16) (negative definite, so the first <p, A p> of
    every route is negative) the fused block breaks down at k = 0 in
    both; "auto" then finishes on the streaming kernel B4 (its bfloat16
    build), "adaptive" first on s = 2 and then on B4, and each breaks down
    as cgx's does: the same k, converged and breakdown flags."""
    dia = cgx_lap2d_fd(16)
    n = dia.shape[0]
    bands = -np.asarray(dia.bands, np.float32)
    b = source_term(n)
    tol = TOL_REL * float(np.linalg.norm(b))
    kw = dict(s=S, tol=tol, maxiter=n, bounds=(0.5, 8.0), powers="fused", fallback=fallback)
    want = cgx_sstep(cgx.DiaOperator(jnp.asarray(bands, jnp.bfloat16), tuple(dia.offsets)),
                     jnp.asarray(b, jnp.bfloat16), **kw)
    op = cgx_torch.operator_from_numpy(bands, dia.offsets, dtype=BF16, device="cpu")
    before = BUILD_LAUNCHES["stream_iteration_bf16"]
    got = sstep_cg_solve(op, _bf16(b), device="cpu", **kw)
    assert [int(got.iterations), bool(got.converged), bool(got.breakdown)] == [
        int(want.iterations), bool(want.converged), bool(want.breakdown)]
    assert bool(got.breakdown) and got.x.dtype == BF16
    assert (BUILD_LAUNCHES["stream_iteration_bf16"] > before) == (fallback != "off")


def test_cli_runs_the_fused_route(fused32, tmp_path):
    """The CLI's --precision bf16 --method sstep --sstep-powers fused
    --sstep-replace-every 0, CUDA grammar on lap2d_fd(32)'s .mtx with
    --format dia, runs B10's bfloat16 builds; its [STEP k] line is
    solve's on the same configuration (within s of cgx's solve, above).
    cgx's CLI offers no "fused" choice (argparse exits with 2); the
    port's takes it (ROADMAP C)."""
    from cgx.cli import main as climod

    from cgx_torch.cli import main as ctcli

    b, cfg, _ = fused32
    mtx = tmp_path / "lap.mtx"
    lap2d_fd_coo_lower(32).write(mtx)
    opts = ["--format", "dia", "--precision", "bf16", "--method", "sstep", "--sstep-powers",
            "fused", "--sstep-replace-every", "0", "--tol", repr(cfg["tolerance"])]
    argv = [str(mtx), "1024", "16", "false"]
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(io.StringIO()):
        climod.main([*argv, str(tmp_path / "cgx.txt"), *opts])
    assert exc.value.code == 2
    before = BUILD_LAUNCHES["sstep_gram_bf16"]
    buf = io.StringIO()
    csv = tmp_path / "port.txt"
    with contextlib.redirect_stdout(buf):
        rc = ctcli.main([*argv, str(csv), *opts, "--device", "cpu"])
    assert rc == 0
    m = STEP.search(buf.getvalue())
    assert m, buf.getvalue()
    want = cgx_torch.solve(DIAMatrix.from_coo(COOMatrix.read(mtx)), b,
                           SolveConfig(sstep_replace_every=0, **cfg), device="cpu")
    assert bool(want.converged) and int(m.group(1)) == int(want.iterations)
    assert BUILD_LAUNCHES["sstep_gram_bf16"] > before
    assert csv.read_text().strip().split(",")[:2] == ["1024", "16"]

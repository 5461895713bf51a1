"""cgx_torch.solver.autodiff against jax.grad of cgx's differentiable
solves on the CPU (x64): torch.autograd gradients of b and of the
operator's values for Dense, DIA, ELL and CSR, and of the block solve,
within 1e-10; a central finite difference of the DIA bands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx_torch
from cgx.solver.autodiff import block_cg_solve_differentiable as cgx_block_diff
from cgx.solver.autodiff import cg_solve_differentiable as cgx_diff
from cgx_torch.solver.autodiff import block_cg_solve_differentiable, cg_solve_differentiable

G = 8
N = G * G
ARGS = (1e-13, None, 1e-14)  # tol, maxiter, nearzero


def _host(fmt):
    coo_c = cgx.mats.generators.lap2d_fd_coo_lower(G)
    coo_t = cgx_torch.mats.generators.lap2d_fd_coo_lower(G)
    return {"dense": (coo_c.to_dense(), coo_t.to_dense()),
            "dia": (cgx.lap2d_fd(G), cgx_torch.lap2d_fd(G)),
            "ell": (cgx.ELLMatrix.from_coo(coo_c), cgx_torch.ELLMatrix.from_coo(coo_t)),
            "csr": (cgx.CSRMatrix.from_coo(coo_c), cgx_torch.CSRMatrix.from_coo(coo_t))}[fmt]


def _field(op):
    for name in ("a", "bands", "values"):
        if hasattr(op, name):
            return name
    raise AssertionError(type(op))


@pytest.mark.parametrize("fmt", ["dense", "dia", "ell", "csr"])
def test_gradients_match_jax(fmt):
    hc, ht = _host(fmt)
    opc = cgx.as_operator(hc)
    opt = cgx_torch.as_operator(ht, device="cpu")
    name = _field(opt)
    rng = np.random.default_rng(1)
    b, w = rng.standard_normal(N), rng.standard_normal(N)

    def loss(vals, bb):
        op = opc._replace(**{name: vals}) if hasattr(opc, "_replace") else type(opc)(
            **{**vars(opc), name: vals})
        return jnp.dot(jnp.asarray(w), cgx_diff(op, bb, *ARGS))

    g_vals, g_b = jax.grad(loss, argnums=(0, 1))(getattr(opc, name), jnp.asarray(b))
    vals = getattr(opt, name).clone().requires_grad_(True)
    bt = torch.tensor(b, requires_grad=True)
    import dataclasses

    x = cg_solve_differentiable(dataclasses.replace(opt, **{name: vals}), bt, *ARGS,
                                device="cpu")
    (torch.tensor(w) @ x).backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(g_b), rtol=0, atol=1e-10)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(g_vals), rtol=0, atol=1e-10)


def test_db_is_one_more_solve():
    """dL/db of L = <w, x> is A^-1 w: one more CG solve."""
    opt = cgx_torch.as_operator(cgx_torch.lap2d_fd(G), device="cpu")
    w = torch.tensor(np.random.default_rng(2).standard_normal(N))
    b = torch.tensor(cgx_torch.source_term(N), requires_grad=True)
    (w @ cg_solve_differentiable(opt, b, *ARGS, device="cpu")).backward()
    y = cgx_torch.cg_solve(opt, w, tol=1e-13, device="cpu").x
    assert torch.max(torch.abs(b.grad - y)) <= 1e-10 * torch.max(torch.abs(y))


def test_dia_bands_central_difference():
    """The DIA band gradient against a central finite difference of the
    loss, entry by entry on a few entries (the pad + off shift)."""
    opt = cgx_torch.as_operator(cgx_torch.lap2d_fd(G), device="cpu")
    b = torch.tensor(cgx_torch.source_term(N))
    w = torch.tensor(np.random.default_rng(3).standard_normal(N))
    bands = opt.bands.clone().requires_grad_(True)
    off = tuple(opt.offsets)

    def loss(bd):
        return float(w @ cg_solve_differentiable(cgx_torch.DiaOperator(bd, off), b, *ARGS,
                                                 device="cpu"))

    (w @ cg_solve_differentiable(cgx_torch.DiaOperator(bands, off), b, *ARGS,
                                 device="cpu")).backward()
    h = 1e-5
    for d, i in [(0, 20), (1, 9), (2, 33), (3, 40), (4, 17)]:
        if bands[d, i] == 0:
            continue
        up, dn = opt.bands.clone(), opt.bands.clone()
        up[d, i] += h
        dn[d, i] -= h
        fd = (loss(up) - loss(dn)) / (2 * h)
        assert abs(float(bands.grad[d, i]) - fd) <= 1e-6 * max(1.0, abs(fd))


@pytest.mark.parametrize("fmt", ["dense", "dia"])
def test_block_gradients_match_jax(fmt):
    hc, ht = _host(fmt)
    opc = cgx.as_operator(hc)
    opt = cgx_torch.as_operator(ht, device="cpu")
    name = _field(opt)
    rng = np.random.default_rng(4)
    bb, ww = rng.standard_normal((N, 4)), rng.standard_normal((N, 4))

    def loss(vals, b):
        op = type(opc)(**{**vars(opc), name: vals})
        return jnp.sum(jnp.asarray(ww) * cgx_block_diff(op, b, 1e-12, None))

    g_vals, g_b = jax.grad(loss, argnums=(0, 1))(getattr(opc, name), jnp.asarray(bb))
    import dataclasses

    vals = getattr(opt, name).clone().requires_grad_(True)
    bt = torch.tensor(bb, requires_grad=True)
    x = block_cg_solve_differentiable(dataclasses.replace(opt, **{name: vals}), bt, 1e-12, None,
                                      device="cpu")
    (torch.tensor(ww) * x).sum().backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(g_b), rtol=0, atol=1e-10)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(g_vals), rtol=0, atol=1e-10)


def test_errors():
    ell = cgx_torch.as_operator(_host("ell")[1], device="cpu")
    with pytest.raises(TypeError, match="no block cotangent rule"):
        block_cg_solve_differentiable(ell, torch.ones((N, 2), dtype=torch.float64),
                                      device="cpu")
    with pytest.raises(TypeError, match="no cotangent rule"):
        cg_solve_differentiable(lambda v: v, torch.ones(N, dtype=torch.float64), device="cpu")

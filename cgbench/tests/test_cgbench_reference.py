"""The plain reference: its problem against a NumPy build of the stencil,
its CG against a dense NumPy solve at lap2d_fd(32), and its imports."""

import ast
import math

import numpy as np
import pytest
import torch

from cgbench import spec
from cgbench.reference import cg as ref_cg
from cgbench.reference import lap2d_5pt

G = 32
CFG = {"grid": G}


def dense_lap2d(g: int) -> np.ndarray:
    n = g * g
    a = np.zeros((n, n))
    for i in range(n):
        r, c = divmod(i, g)
        a[i, i] = 4.0
        for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if 0 <= rr < g and 0 <= cc < g:
                a[i, rr * g + cc] = -1.0
    return a


def as_dense(bands: torch.Tensor, offsets) -> np.ndarray:
    n = bands.shape[1]
    a = np.zeros((n, n))
    for d, o in enumerate(offsets):
        for i in range(max(0, -o), min(n, n - o)):
            a[i, i + o] = float(bands[d, i])
    return a


def test_bands_are_the_stencil():
    bands = lap2d_5pt.bands(CFG, torch.float64, "cpu")
    np.testing.assert_array_equal(as_dense(bands, lap2d_5pt.offsets(CFG)), dense_lap2d(G))


def test_source_term():
    n = G * G
    i = np.arange(n, dtype=np.float64)
    want = -2.0 * i * np.pi ** 2 * np.sin(10.0 * np.pi * i / n) ** 2
    np.testing.assert_allclose(lap2d_5pt.source(CFG, "cpu").numpy(), want, rtol=1e-13, atol=1e-9)


@pytest.mark.parametrize("precond", [None, "neumann"])
def test_cg_against_a_dense_solve(precond):
    a = dense_lap2d(G)
    b = lap2d_5pt.source(CFG, "cpu")
    want = np.linalg.solve(a, b.numpy())
    tol = 1e-12 * float(torch.linalg.vector_norm(b))
    sol = ref_cg.cg(lap2d_5pt.bands(CFG, torch.float64, "cpu"), lap2d_5pt.offsets(CFG), b, tol,
                    G * G, precond=precond)
    assert sol.converged and 0 < sol.k < G * G
    np.testing.assert_allclose(sol.x.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_k_counts_the_iterations_that_did_not_converge():
    # a diagonal system converges in its first iteration, which k does not count
    bands = torch.zeros((3, 8), dtype=torch.float64)
    bands[1] = 2.0
    sol = ref_cg.cg(bands, (-1, 0, 1), torch.ones(8, dtype=torch.float64), 1e-12, 8)
    assert sol.converged and sol.k == 0
    torch.testing.assert_close(sol.x, torch.full((8,), 0.5, dtype=torch.float64))


def test_true_residual_and_bf16_vectors():
    bands = lap2d_5pt.bands(CFG, torch.float64, "cpu")
    off = lap2d_5pt.offsets(CFG)
    b = lap2d_5pt.source(CFG, "cpu")
    tol = 1e-5 * float(torch.linalg.vector_norm(b))
    sol = ref_cg.cg(bands, off, b, tol, G * G)
    assert ref_cg.true_residual(bands, off, sol.x, b) < 1e-5
    assert math.isinf(ref_cg.true_residual(bands, off, torch.full_like(b, math.nan), b))
    low = ref_cg.cg(bands.bfloat16(), off, b.bfloat16(), tol, 2 * sol.k + 64)
    assert low.x.dtype == torch.bfloat16
    assert float(torch.linalg.vector_norm(low.x.double() - sol.x) /
                 torch.linalg.vector_norm(sol.x)) > 1e-3


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("cgx_torch", "cgx", "jax", "jaxlib", "flax"), \
                    f"{path.name} imports {name}"

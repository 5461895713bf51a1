"""Problem generators (reference L4 setup functions).

Reproduces the reference's synthetic problems exactly:

- :func:`lap2d_reference` — the quasi-5-point Laplacian of
  ``CGSolver::generate_lap2d_matrix`` (cg.cc:159-188): diagonal 4,
  -1 at offsets +-1 and +-(1+inc) with ``inc = floor(sqrt(size))``,
  including the asymmetric-looking-but-symmetric fill guards
  ``i > inc`` and ``i < size-1-inc`` (see SURVEY §3.4 — bit-for-bit
  iteration parity requires this exact stencil).
- :func:`lap2d_fd` — the true 5-point finite-difference Laplacian on an
  ``n x n`` grid with Dirichlet boundaries: this is the matrix stored in
  the reference's test file ``lap2D_5pt_n100.mtx`` (diag 4, -1 at
  distance 1 — except across grid-row boundaries — and distance n).
- :func:`lap3d_fd` — 7-point 3-D Laplacian (BASELINE.json config 5).
- :func:`source_term` — ``b[i] = -2 i pi^2 sin^2(10 pi i h)``
  (cg.cc:229-232 / cg.cu:334-338).

All generators return banded :class:`~cgx_torch.mats.containers.DIAMatrix`
structures (the natural sparse product); dense/ELL/CSR views derive
from them. A NumPy copy of ``cgx/mats/generators.py``.
"""

from __future__ import annotations

import math

import numpy as np

from cgx_torch.mats.containers import COOMatrix, DIAMatrix


def lap2d_reference(size: int) -> DIAMatrix:
    """The reference's generated matrix (cg.cc:159-188), in DIA form.

    Offsets: 0 (value 4), +-1, +-(1+inc) with inc = floor(sqrt(size)).
    Guards: row i has A[i, i-1-inc] only when i > inc (cg.cc:181) and
    A[i, i+1+inc] only when i < size-1-inc (cg.cc:185); the +-1
    neighbours exist except at the ends. Note the lower guard is
    ``i > inc`` — i.e. row inc+1's entry at column 0 is *dropped* —
    which pairs exactly with the upper guard, so the matrix is
    symmetric (property-tested in tests/test_generators.py).
    """
    inc = int(math.floor(math.sqrt(size)))
    n = size
    w = 1 + inc
    offsets = (-w, -1, 0, 1, w)
    bands = np.zeros((5, n), dtype=np.float64)
    i = np.arange(n)
    bands[0] = np.where(i > inc, -1.0, 0.0)          # A[i, i-1-inc]
    bands[1] = np.where(i > 0, -1.0, 0.0)            # A[i, i-1]
    bands[2] = 4.0                                   # A[i, i]
    bands[3] = np.where(i < n - 1, -1.0, 0.0)        # A[i, i+1]
    bands[4] = np.where(i < n - 1 - inc, -1.0, 0.0)  # A[i, i+1+inc]
    return DIAMatrix((n, n), offsets, bands)


def lap2d_fd(n_grid: int) -> DIAMatrix:
    """True 5-point FD Laplacian on an n_grid x n_grid grid (Dirichlet).

    This reconstructs the matrix of the reference's checked-in test file
    ``lap2D_5pt_n100.mtx`` (N = n_grid^2, diag 4, -1 at distance 1
    except across grid-row boundaries, -1 at distance n_grid)."""
    n = n_grid * n_grid
    offsets = (-n_grid, -1, 0, 1, n_grid)
    bands = np.zeros((5, n), dtype=np.float64)
    i = np.arange(n)
    col = i % n_grid
    bands[0] = np.where(i >= n_grid, -1.0, 0.0)       # A[i, i-n_grid]
    bands[1] = np.where(col > 0, -1.0, 0.0)           # A[i, i-1] within grid row
    bands[2] = 4.0
    bands[3] = np.where(col < n_grid - 1, -1.0, 0.0)  # A[i, i+1] within grid row
    bands[4] = np.where(i < n - n_grid, -1.0, 0.0)    # A[i, i+n_grid]
    return DIAMatrix((n, n), offsets, bands)


def lap2d_aniso(n_grid: int, eps: float = 1.0) -> DIAMatrix:
    """Anisotropic 5-point Laplacian ``-u_xx - eps * u_yy`` on an
    n_grid x n_grid grid (Dirichlet): diag ``2 + 2*eps``, -1 along x
    (the contiguous index direction), ``-eps`` along y.

    ``eps=1`` reproduces :func:`lap2d_fd` exactly. ``eps << 1`` is the
    classic strong-x-coupling test problem: pointwise smoothers and
    point-Jacobi see an effectively 1-D stiff operator per grid line
    and stall, while LINE relaxation along x — block-Jacobi with
    ``block_size = n_grid`` (cgx.solver.precond.block_jacobi), whose
    blocks are exactly the per-line tridiagonal systems — captures the
    dominant coupling directly. Extends the reference's problem family
    (cg.cc:159-188 generates only the isotropic stencil).
    """
    g = int(n_grid)
    e = float(eps)
    if e <= 0:
        raise ValueError(f"eps must be positive for SPD; got {eps}")
    n = g * g
    offsets = (-g, -1, 0, 1, g)
    bands = np.zeros((5, n), dtype=np.float64)
    i = np.arange(n)
    col = i % g
    bands[0] = np.where(i >= g, -e, 0.0)
    bands[1] = np.where(col > 0, -1.0, 0.0)
    bands[2] = 2.0 + 2.0 * e
    bands[3] = np.where(col < g - 1, -1.0, 0.0)
    bands[4] = np.where(i < n - g, -e, 0.0)
    return DIAMatrix((n, n), offsets, bands)


def lap3d_fd(n_grid: int) -> DIAMatrix:
    """7-point FD Laplacian on an n_grid^3 grid (Dirichlet): diag 6,
    -1 at distances 1 (within x-lines), n_grid (within xy-planes), and
    n_grid^2 (BASELINE.json config 5)."""
    n = n_grid ** 3
    ng2 = n_grid * n_grid
    offsets = (-ng2, -n_grid, -1, 0, 1, n_grid, ng2)
    bands = np.zeros((7, n), dtype=np.float64)
    i = np.arange(n)
    x = i % n_grid
    y = (i // n_grid) % n_grid
    bands[0] = np.where(i >= ng2, -1.0, 0.0)
    bands[1] = np.where(y > 0, -1.0, 0.0)
    bands[2] = np.where(x > 0, -1.0, 0.0)
    bands[3] = 6.0
    bands[4] = np.where(x < n_grid - 1, -1.0, 0.0)
    bands[5] = np.where(y < n_grid - 1, -1.0, 0.0)
    bands[6] = np.where(i < n - ng2, -1.0, 0.0)
    return DIAMatrix((n, n), offsets, bands)


def source_term(n: int, h: float | None = None) -> np.ndarray:
    """Reference source term b[i] = -2 i pi^2 sin^2(10 pi i h) with
    h = 1/n by default (cg_main.cc:45-46 -> cg.cc:218-234)."""
    if h is None:
        h = 1.0 / n
    i = np.arange(n, dtype=np.float64)
    s = np.sin(10.0 * np.pi * i * h)
    return -2.0 * i * np.pi * np.pi * s * s


def lap2d_fd_coo_lower(n_grid: int) -> COOMatrix:
    """Lower-triangle COO of :func:`lap2d_fd` in the on-disk convention of
    lap2D_5pt_n100.mtx (symmetric storage). Used by the mtx writer path
    and round-trip tests."""
    dia = lap2d_fd(n_grid)
    dense_offsets = [(d, off) for d, off in enumerate(dia.offsets) if off <= 0]
    n = dia.shape[0]
    rows_l, cols_l, vals_l = [], [], []
    for d, off in dense_offsets:
        lo = max(0, -off)
        r = np.arange(lo, n)
        keep = dia.bands[d, r] != 0.0
        rows_l.append(r[keep])
        cols_l.append(r[keep] + off)
        vals_l.append(dia.bands[d, r[keep]])
    rows = np.concatenate(rows_l).astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    vals = np.concatenate(vals_l)
    order = np.lexsort((cols, rows))
    return COOMatrix((n, n), rows[order], cols[order], vals[order], symmetric=True)


def poisson2d_var(n_grid: int, coeff: np.ndarray) -> DIAMatrix:
    """Variable-coefficient 2-D Poisson ``-div(c grad u)`` on an
    n_grid x n_grid interior grid (Dirichlet), 5-point flux stencil
    with HARMONIC-mean face coefficients — symmetric positive definite
    for any positive node field ``coeff`` (n_grid, n_grid).

    ``coeff=1`` reproduces :func:`lap2d_fd` exactly (tested). The
    interesting regime is HIGH CONTRAST (jumping coefficients — e.g. a
    high-permeability inclusion): the contrast plants isolated small
    eigenvalues, the structure where deflation / recycling
    (cgx.solver.deflated, cgx.solve_sequence) earns its keep and where
    the constant-coefficient generators can't exercise it. Extends the
    reference's problem family (cg.cc:159-188 generates only the
    constant-coefficient quasi-Laplacian).
    """
    g = int(n_grid)
    c = np.asarray(coeff, np.float64)
    if c.shape != (g, g):
        raise ValueError(f"coeff must be ({g}, {g}); got {c.shape}")
    if not np.all(c > 0):
        raise ValueError("coeff must be positive for SPD")

    def hmean(a, b):
        return 2.0 * a * b / (a + b)

    # face coefficients; boundary faces use the node's own c (Dirichlet)
    cw = np.empty_like(c)
    cw[:, 1:] = hmean(c[:, 1:], c[:, :-1])
    cw[:, 0] = c[:, 0]
    ce = np.empty_like(c)
    ce[:, :-1] = hmean(c[:, :-1], c[:, 1:])
    ce[:, -1] = c[:, -1]
    cs = np.empty_like(c)
    cs[1:, :] = hmean(c[1:, :], c[:-1, :])
    cs[0, :] = c[0, :]
    cn = np.empty_like(c)
    cn[:-1, :] = hmean(c[:-1, :], c[1:, :])
    cn[-1, :] = c[-1, :]

    n = g * g
    offsets = (-g, -1, 0, 1, g)
    bands = np.zeros((5, n), dtype=np.float64)
    i = np.arange(n)
    col = i % g
    row = i // g
    bands[0] = np.where(row > 0, -cs.ravel(), 0.0)       # A[i, i-g]
    bands[1] = np.where(col > 0, -cw.ravel(), 0.0)       # A[i, i-1]
    bands[2] = (cw + ce + cs + cn).ravel()
    bands[3] = np.where(col < g - 1, -ce.ravel(), 0.0)   # A[i, i+1]
    bands[4] = np.where(row < g - 1, -cn.ravel(), 0.0)   # A[i, i+g]
    return DIAMatrix((n, n), offsets, bands)


def poisson3d_var(n_grid: int, coeff: np.ndarray) -> DIAMatrix:
    """Variable-coefficient 3-D Poisson ``-div(c grad u)`` on an
    n_grid^3 interior grid (Dirichlet), 7-point flux stencil with
    harmonic-mean face coefficients — the 3-D sibling of
    :func:`poisson2d_var`. ``coeff=1`` reproduces :func:`lap3d_fd`
    exactly (tested); SPD for any positive node field (g, g, g).
    """
    g = int(n_grid)
    c = np.asarray(coeff, np.float64)
    if c.shape != (g, g, g):
        raise ValueError(f"coeff must be ({g}, {g}, {g}); got {c.shape}")
    if not np.all(c > 0):
        raise ValueError("coeff must be positive for SPD")

    def hmean(a, b):
        return 2.0 * a * b / (a + b)

    def faces(axis):
        """(lo, hi) face-coefficient fields along one axis; boundary
        faces use the node's own c (Dirichlet)."""
        lo = np.empty_like(c)
        hi = np.empty_like(c)
        sl_in = [slice(None)] * 3
        sl_prev = [slice(None)] * 3
        sl_in[axis] = slice(1, None)
        sl_prev[axis] = slice(None, -1)
        h = hmean(c[tuple(sl_in)], c[tuple(sl_prev)])
        lo[tuple(sl_in)] = h
        hi[tuple(sl_prev)] = h
        sl0 = [slice(None)] * 3
        sl0[axis] = 0
        lo[tuple(sl0)] = c[tuple(sl0)]
        sl1 = [slice(None)] * 3
        sl1[axis] = g - 1
        hi[tuple(sl1)] = c[tuple(sl1)]
        return lo, hi

    # index i = z*g*g + y*g + x: axis 0 = z (offset g^2), 1 = y
    # (offset g), 2 = x (offset 1)
    cz_lo, cz_hi = faces(0)
    cy_lo, cy_hi = faces(1)
    cx_lo, cx_hi = faces(2)

    n = g ** 3
    g2 = g * g
    offsets = (-g2, -g, -1, 0, 1, g, g2)
    bands = np.zeros((7, n), dtype=np.float64)
    i = np.arange(n)
    x = i % g
    y = (i // g) % g
    z = i // g2
    bands[0] = np.where(z > 0, -cz_lo.ravel(), 0.0)
    bands[1] = np.where(y > 0, -cy_lo.ravel(), 0.0)
    bands[2] = np.where(x > 0, -cx_lo.ravel(), 0.0)
    bands[3] = (cx_lo + cx_hi + cy_lo + cy_hi + cz_lo + cz_hi).ravel()
    bands[4] = np.where(x < g - 1, -cx_hi.ravel(), 0.0)
    bands[5] = np.where(y < g - 1, -cy_hi.ravel(), 0.0)
    bands[6] = np.where(z < g - 1, -cz_hi.ravel(), 0.0)
    return DIAMatrix((n, n), offsets, bands)

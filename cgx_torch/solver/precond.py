"""Preconditioners (counterpart of ``cgx/solver/precond.py``), in plain
torch as cgx leaves them to XLA.

Each constructor returns ``apply(r) -> z = M^-1 r`` for
:func:`cgx_torch.cg_solve`'s ``precond``:

- :func:`jacobi`: ``r / diag(A)``;
- :func:`neumann_banded`: the truncated Neumann series over banded
  mat-vecs;
- :func:`chebyshev_banded` and :func:`chebyshev_poly`: ``degree`` steps
  of the Chebyshev iteration from zero on spectral bounds, over the
  banded product or any mat-vec;
- :func:`block_jacobi`: the inverses of the diagonal blocks, found on
  the host in float64 (:func:`diag_blocks`, :func:`invert_spd_blocks`,
  NumPy copies of cgx's) and applied as one batched product.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from cgx_torch.ops._util import f32_exact, resolve_device
from cgx_torch.ops.dia_spmv import dia_matvec_ref


def jacobi(diag: torch.Tensor, eps: float = 0.0) -> Callable:
    """Jacobi (diagonal) preconditioner: ``z = r / diag(A)``; entries with
    ``|d| <= eps`` are left unscaled."""
    inv = 1.0 / torch.where(diag.abs() > eps, diag, torch.ones_like(diag))

    def apply(r: torch.Tensor) -> torch.Tensor:
        return inv * r

    return apply


def chebyshev_banded(bands: torch.Tensor, offsets: Sequence[int], lmin: float, lmax: float,
                     degree: int = 4) -> Callable:
    """Degree-``degree`` Chebyshev polynomial preconditioner of a banded
    matrix: ``degree`` steps of the Chebyshev iteration on ``A z = r``
    from ``z = 0`` on ``[lmin, lmax]``. A linear, symmetric map, positive
    definite when the bounds hold the spectrum, so CG-safe; the apply is
    banded mat-vecs and no reductions."""
    offsets = tuple(int(o) for o in offsets)
    return chebyshev_poly(lambda v: dia_matvec_ref(bands, v, offsets=offsets), lmin, lmax,
                          degree)


def chebyshev_poly(matvec: Callable, lmin: float, lmax: float, degree: int = 3) -> Callable:
    """:func:`chebyshev_banded`'s recurrence over any ``x -> A x``: the
    apply costs ``degree`` mat-vecs and no reductions. At low degree it
    may not cut CG's count on Laplacian-like spectra (cgx's docstring
    measures 108 -> 123 at degree 3 on lap2d_reference(400))."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta

    def apply(r: torch.Tensor) -> torch.Tensor:
        # bfloat16 vectors take each host scalar rounded to bfloat16 first, as
        # cgx's weakly typed Python scalars are; float32 and float64 as before
        s = (lambda v: torch.tensor(v, dtype=r.dtype, device=r.device)) \
            if r.dtype == torch.bfloat16 else (lambda v: v)
        z = torch.zeros_like(r)
        res = r
        p = res / s(theta)
        rho_old = 1.0 / sigma1
        for _ in range(degree):
            z = z + p
            res = res - matvec(p)
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            p = s(rho * rho_old) * p + s(2.0 * rho / delta) * res
            rho_old = rho
        return z

    return apply


def neumann_banded(bands: torch.Tensor, offsets: Sequence[int], omega: float = 1.0,
                   sweeps: int = 1) -> Callable:
    """Truncated-Neumann polynomial preconditioner for banded matrices:
    ``z = sum_{k<sweeps} (I - omega D^-1 A)^k (omega D^-1 r)``.
    ``sweeps=1`` is scaled Jacobi; ``sweeps=2`` is ``2 D^-1 r - D^-1 A
    D^-1 r``, the whole-solve kernel's in-kernel preconditioner."""
    offsets = tuple(int(o) for o in offsets)
    inv_d = omega / bands[offsets.index(0)]

    def apply(r: torch.Tensor) -> torch.Tensor:
        c = inv_d * r
        z = c
        for _ in range(sweeps - 1):
            z = c + z - inv_d * dia_matvec_ref(bands, z, offsets=offsets)
        return z

    return apply


def _np64(a) -> np.ndarray:
    """A float64 NumPy copy of host data or of a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def diag_blocks(mat, block_size: int, n_rows: int | None = None) -> np.ndarray:
    """The block diagonal of ``mat`` as a ``(nb, m, m)`` float64 NumPy
    batch (m = ``block_size``), on the host (cgx's ``diag_blocks``).

    Takes banded matrices and operators (``A[i, i+off] = bands[d, i]``),
    dense containers and operators, 2-D arrays and tensors, and anything
    with ``to_dense``. Rows past the matrix (``n_rows`` rounds n up for a
    padded layout) are identity, so padded blocks stay SPD."""
    m = int(block_size)
    if m < 1:
        raise ValueError(f"block_size must be >= 1; got {block_size}")
    bands = getattr(mat, "bands", None)
    if bands is not None:
        offsets = tuple(mat.offsets)
        bands = _np64(bands)
        n = bands.shape[1]
        n_p = n if n_rows is None else int(n_rows)
        if n_p < n:
            raise ValueError(f"n_rows {n_p} < matrix size {n}")
        nb = -(-n_p // m)
        n_pad = nb * m
        blocks = np.zeros((nb, m, m), dtype=np.float64)
        rows_pad = np.zeros((len(offsets), n_pad), dtype=np.float64)
        rows_pad[:, :n] = bands
        i_global = np.arange(n_pad).reshape(nb, m)
        for d, off in enumerate(offsets):
            if abs(off) >= m:
                continue  # couples distinct blocks only: truncated
            r = np.arange(max(0, -off), min(m, m - off))
            c = r + off
            vals = rows_pad[d].reshape(nb, m)[:, r]
            # entries whose column falls outside the matrix are zero
            col_g = i_global[:, r] + off
            vals = np.where(col_g < n, vals, 0.0)
            blocks[:, r, c] = vals
    else:
        a = getattr(mat, "a", mat)
        if hasattr(a, "to_dense"):
            a = a.to_dense()
        a = _np64(a)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"need a square matrix; got shape {a.shape}")
        n = a.shape[0]
        n_p = n if n_rows is None else int(n_rows)
        nb = -(-n_p // m)
        n_pad = nb * m
        blocks = np.zeros((nb, m, m), dtype=np.float64)
        for b in range(nb):
            lo = b * m
            hi = min(lo + m, n)
            if hi > lo:
                blocks[b, : hi - lo, : hi - lo] = a[lo:hi, lo:hi]
    pad_rows = np.arange(n_pad) >= n
    if pad_rows.any():
        rr = np.arange(n_pad)[pad_rows]
        blocks[rr // m, rr % m, rr % m] = 1.0
    return blocks


def invert_spd_blocks(blocks) -> np.ndarray:
    """Batched SPD inverse on the host in float64: Cholesky checks each
    block, the inverse is symmetrised. A non-SPD block raises
    ``ValueError``: block-Jacobi is CG-safe only when every diagonal block
    is SPD."""
    blocks = np.asarray(blocks, dtype=np.float64)
    try:
        np.linalg.cholesky(blocks)
    except np.linalg.LinAlgError as e:
        raise ValueError("block-Jacobi needs SPD diagonal blocks (is A SPD?)") from e
    inv = np.linalg.inv(blocks)
    return (inv + np.swapaxes(inv, -1, -2)) / 2.0


def _device_of(mat):
    for name in ("bands", "a"):
        t = getattr(mat, name, None)
        if isinstance(t, torch.Tensor):
            return t.device
    return mat.device if isinstance(mat, torch.Tensor) else None


def block_jacobi(mat, block_size: int, dtype=None, *, device=None) -> Callable:
    """Block-Jacobi preconditioner: ``z = diag_blocks(A, m)^-1 r``.

    The blocks are inverted once on the host (float64, Cholesky-checked)
    and kept on the device in ``dtype`` (float64 by default); the apply is
    one batched ``(nb, m, m) @ (nb, m)`` product at full float32
    (:func:`cgx_torch.ops._util.f32_exact`). ``device`` defaults to the
    operator's, and to ``"cuda"`` for a host container. ``m = 1`` is
    :func:`jacobi`; ``m = n`` a direct solve."""
    dev = resolve_device(device if device is not None else (_device_of(mat) or "cuda"))
    inv = torch.tensor(invert_spd_blocks(diag_blocks(mat, block_size)),
                       dtype=dtype or torch.float64, device=dev)
    nb, m, _ = inv.shape
    n_pad = nb * m

    def apply(r: torch.Tensor) -> torch.Tensor:
        n = r.shape[0]
        rp = torch.nn.functional.pad(r, (0, n_pad - n)) if n_pad != n else r
        with f32_exact():
            z = torch.matmul(inv.to(rp.dtype), rp.reshape(nb, m, 1))
        return z.reshape(n_pad)[:n]

    return apply

"""Device-side problem builders (counterpart of ``cgx/mats/device.py``).

The host generators (:mod:`cgx_torch.mats.generators`) build bands in
NumPy and copy them to the device. At N = 10,240,000 in fp64 that is
400 MB of formulaic constants through the host; the builders here write
the same arrays on the device from an index vector.

Parity: the band values are exact (4 or 6, -1 and 0 in any binary float
format), so ``lap2d_operator(g).bands`` equals ``lap2d_fd(g).bands`` bit
for bit. The source term follows cgx's device formula (``b[i] = -2 i
pi^2 sin^2(10 pi i / n)`` in float64, cast at the end), within an ulp of
the host ``source_term``: the device's ``sin`` may round differently
from libm's, so a run solves and checks against the same device-built b.
"""

from __future__ import annotations

import math

import torch

from cgx_torch.ops._util import resolve_device
from cgx_torch.solver.operators import DiaOperator


def _lap2d_bands(g: int, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    n = g * g
    i = torch.arange(n, device=dev)
    col = i % g
    neg = torch.full((n,), -1.0, dtype=dtype, device=dev)
    zero = torch.zeros((n,), dtype=dtype, device=dev)
    return torch.stack([
        torch.where(i >= g, neg, zero),  # A[i, i-g]
        torch.where(col > 0, neg, zero),  # A[i, i-1] within a grid row
        torch.full((n,), 4.0, dtype=dtype, device=dev),  # the diagonal
        torch.where(col < g - 1, neg, zero),  # A[i, i+1] within a grid row
        torch.where(i < n - g, neg, zero),  # A[i, i+g]
    ])


def lap2d_fd_op(g: int, dtype=torch.float64, *, device="cuda"):
    """``(bands, offsets)`` of :func:`cgx_torch.mats.generators.lap2d_fd`
    (the matrix of lap2D_5pt_n100.mtx at g = 100), built on ``device``."""
    g = int(g)
    return _lap2d_bands(g, dtype, resolve_device(device)), (-g, -1, 0, 1, g)


def _lap3d_bands(g: int, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    n = g * g * g
    g2 = g * g
    i = torch.arange(n, device=dev)
    x = i % g
    y = (i // g) % g
    neg = torch.full((n,), -1.0, dtype=dtype, device=dev)
    zero = torch.zeros((n,), dtype=dtype, device=dev)
    return torch.stack([
        torch.where(i >= g2, neg, zero),
        torch.where(y > 0, neg, zero),
        torch.where(x > 0, neg, zero),
        torch.full((n,), 6.0, dtype=dtype, device=dev),
        torch.where(x < g - 1, neg, zero),
        torch.where(y < g - 1, neg, zero),
        torch.where(i < n - g2, neg, zero),
    ])


def lap3d_fd_op(g: int, dtype=torch.float64, *, device="cuda"):
    """``(bands, offsets)`` of :func:`cgx_torch.mats.generators.lap3d_fd`,
    built on ``device``."""
    g = int(g)
    return _lap3d_bands(g, dtype, resolve_device(device)), (-g * g, -g, -1, 0, 1, g, g * g)


def lap2d_operator(g: int, dtype=torch.float64, *, device="cuda") -> DiaOperator:
    return DiaOperator(*lap2d_fd_op(g, dtype, device=device))


def lap3d_operator(g: int, dtype=torch.float64, *, device="cuda") -> DiaOperator:
    return DiaOperator(*lap3d_fd_op(g, dtype, device=device))


def source_term_device(n: int, dtype=torch.float64, *, device="cuda") -> torch.Tensor:
    """The reference source term (cg.cc:218-234), h = 1/n, built on
    ``device`` in float64 and cast to ``dtype`` at the end (i spans 1e7,
    so the sine's argument needs float64)."""
    n = int(n)
    i = torch.arange(n, dtype=torch.float64, device=resolve_device(device))
    s = torch.sin(10.0 * math.pi * i / n)
    return (-2.0 * i * math.pi * math.pi * s * s).to(dtype)

"""The 2-D 5-point finite-difference Laplacian with Dirichlet boundary, in
plain PyTorch: the stencil of the upstream solver's ``lap2D_5pt_n100.mtx``
at any grid, and its source term (``cg.cc:218-234``).

Row ``i`` of the ``g x g`` grid's matrix holds 4 on the diagonal and -1 at
``i - g``, ``i - 1``, ``i + 1`` and ``i + g`` where that neighbour lies on
the grid (``i +- 1`` only within a grid row). Stored as bands:
``bands[d, i] = A[i, i + offsets[d]]``.
"""

from __future__ import annotations

import math

import torch


def offsets(cfg: dict) -> tuple:
    g = int(cfg["grid"])
    return (-g, -1, 0, 1, g)


def size(cfg: dict) -> int:
    return int(cfg["grid"]) ** 2


def bands(cfg: dict, dtype: torch.dtype, device) -> torch.Tensor:
    """The ``(5, g*g)`` bands in ``dtype`` on ``device``."""
    g = int(cfg["grid"])
    n = g * g
    i = torch.arange(n, device=device)
    col = i % g
    out = torch.zeros((5, n), dtype=dtype, device=device)
    out[0].masked_fill_(i >= g, -1.0)
    out[1].masked_fill_(col > 0, -1.0)
    out[2].fill_(4.0)
    out[3].masked_fill_(col < g - 1, -1.0)
    out[4].masked_fill_(i < n - g, -1.0)
    return out


def source(cfg: dict, device) -> torch.Tensor:
    """``b[i] = -2 i pi^2 sin^2(10 pi i h)`` with ``h = 1/N``, in float64."""
    n = size(cfg)
    i = torch.arange(n, dtype=torch.float64, device=device)
    s = torch.sin(10.0 * math.pi * i / n)
    return -2.0 * math.pi * math.pi * i * s * s

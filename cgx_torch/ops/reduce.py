"""Scalar reductions (counterpart of ``cgx/ops/reduce.py``).

cgx routes every dot through element-wise multiply + sum because the
TPU's long fp64 ``jnp.dot`` loses digits; the port keeps the same form,
so that the accumulation dtype is explicit.
"""

from __future__ import annotations

import torch


def vdot(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """<a, b> as a 0-d tensor on the inputs' device.

    When ``precision`` is a dtype, products are accumulated in it (the
    mixed-precision mode: fp32 vectors, fp64 accumulation).
    """
    if precision is not None:
        a = a.to(precision)
        b = b.to(precision)
    return torch.sum(a * b)


def norm2(a: torch.Tensor, precision=None) -> torch.Tensor:
    """||a||_2."""
    return torch.sqrt(vdot(a, a, precision=precision))

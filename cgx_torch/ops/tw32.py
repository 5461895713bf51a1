"""float32 error-free transforms (counterpart of the first two functions
of ``cgx/ops/tw32.py``).

``two_sum32`` and ``two_prod32`` split a float32 sum or product into its
rounded value and the exact rounding error, from float32 operations
alone (Knuth's two-sum; Dekker's product with the 4097 splitter, exact
without FMA). They serve the compensated quadratic forms of the s-step
replay in cgx's arithmetic (:func:`cgx_torch.solver.sstep._qf_comp`).
The rest of cgx's triple-word module is not ported yet (ROADMAP A12).

Each operation is its own PyTorch operation, so nothing contracts a
multiply and an add into an FMA: the transforms stay exact on the CPU
and on the card alike.
"""

from __future__ import annotations

import torch

_SPLIT32 = 4097.0  # 2**12 + 1, Dekker's splitter for binary32


def two_sum32(a: torch.Tensor, b: torch.Tensor):
    """``a + b = s + e`` exactly (Knuth; round-to-nearest float32)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def two_prod32(a: torch.Tensor, b: torch.Tensor):
    """``a * b = p + e`` exactly (Dekker's split)."""
    p = a * b
    ta = _SPLIT32 * a
    a_hi = ta - (ta - a)
    a_lo = a - a_hi
    tb = _SPLIT32 * b
    b_hi = tb - (tb - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e

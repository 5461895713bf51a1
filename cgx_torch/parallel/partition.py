"""Row-block partitioning (counterpart of ``cgx/parallel/partition.py``;
the reference's ``partition_matrix``, cg.cc:236-268).

The reference gives every rank ``N // p`` rows and the *last* rank the
remainder (cg.cc:265-266). The sharded solver wants equal blocks, so it
pads N up to a multiple of the mesh size with zero rows and columns:
padded residual entries stay exactly zero and add nothing to any
reduction. Both views live here. NumPy only; the port keeps its own copy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def partition(n: int, psize: int) -> Tuple[List[int], List[int]]:
    """Reference-parity partition: (start_rows, num_rows) per rank
    (cg.cc:236-268, the last rank taking the remainder)."""
    if psize <= 0:
        raise ValueError("psize must be positive")
    if psize == 1:
        return [0], [n]
    n_loc = n // psize
    start_rows = [prank * n_loc for prank in range(psize)]
    num_rows = [n_loc] * (psize - 1) + [n - n_loc * (psize - 1)]
    return start_rows, num_rows


def padded_size(n: int, psize: int, multiple: int = 1) -> int:
    """Smallest N' >= n divisible by psize (and by ``multiple``)."""
    q = psize * multiple // np.gcd(psize, multiple) if multiple > 1 else psize
    return int(-(-n // q) * q)


def pad_vector(v: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad,) + v.shape[1:], dtype=v.dtype)
    out[: v.shape[0]] = v
    return out


def pad_dense(a: np.ndarray, n_pad: int) -> np.ndarray:
    m, n = a.shape
    out = np.zeros((n_pad, n_pad), dtype=a.dtype)
    out[:m, :n] = a
    return out


def pad_bands(bands: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad DIA bands with zero columns (padded rows have no entries)."""
    d, n = bands.shape
    out = np.zeros((d, n_pad), dtype=bands.dtype)
    out[:, :n] = bands
    return out

"""Structured solve records and the reference's CSV writers (counterpart
of ``cgx/utils/records.py``, whose host code this copies: the port
imports nothing of cgx).

The reference appends bare CSV rows (``N,psize,seconds`` MPI
cg_main.cc:57-64; ``NUM_THREADS,BLOCK_WIDTH,seconds`` CUDA
cg_main.cc:56-60) and prints one convergence line. :class:`SolveRecord`
holds the whole result (iterations, residuals, timing, flops and bytes
estimates, configuration); its writers keep the reference's CSV schemas
byte for byte, so the same analysis reads either.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _host(v) -> np.ndarray:
    """A tensor (possibly on the card) or array as a float64 array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, np.float64)


def _item(v):
    """A 0-d tensor (possibly on the card), array or number as a Python scalar."""
    return v.item() if hasattr(v, "item") else v


@dataclasses.dataclass
class SolveRecord:
    n: int
    iterations: int
    converged: bool
    residual_norm: float
    true_relative_residual: Optional[float] = None
    elapsed_s: float = 0.0
    psize: int = 1
    method: str = "reference"
    strategy: str = "single"
    fmt: str = "dia"
    precision: str = "fp64"
    breakdown: bool = False
    flops_per_iter: Optional[float] = None
    bytes_per_iter: Optional[float] = None
    phase_times: Optional[Dict[str, float]] = None
    history: Optional[Sequence[float]] = None

    @classmethod
    def from_result(cls, res, n: int, elapsed_s: float, **kw) -> "SolveRecord":
        """From a port result (its fields tensors, on the card or the
        CPU): the scalars read with ``.item()``, the history moved to the
        host with only its finite entries kept."""
        hist = _host(res.history)
        return cls(
            n=n,
            iterations=int(_item(res.iterations)),
            converged=bool(_item(res.converged)),
            residual_norm=float(_item(res.residual_norm)),
            elapsed_s=elapsed_s,
            breakdown=bool(_item(res.breakdown)) if hasattr(res, "breakdown") else False,
            history=[float(h) for h in hist[np.isfinite(hist)]] or None,
            **kw,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    # --- the reference's CSV schemas ------------------------------------

    def append_mpi_row(self, path) -> None:
        """``N,psize,seconds`` (strong/weak_scaling.txt schema)."""
        with open(path, "a") as f:
            f.write(f"{self.n},{self.psize},{self.elapsed_s}\n")

    def append_cuda_row(self, path, num_threads: int, block_width: int) -> None:
        """``threads,block_width,seconds`` (CUDA_*.txt schema)."""
        with open(path, "a") as f:
            f.write(f"{num_threads},{block_width},{self.elapsed_s}\n")

    def debug_line(self) -> str:
        """The reference's convergence summary line (cg.cc:152-153)."""
        rel = (
            f"{self.true_relative_residual:e}"
            if self.true_relative_residual is not None
            else "nan"
        )
        return (
            f"\t[STEP {self.iterations}] residual = {self.residual_norm:e}, "
            f"||Ax - b||/||b|| = {rel}"
        )

"""The comparison that decides ``correct``.

The judged solves are a uniform sample of the window's, drawn from the
seed as the window runs (a reservoir: each answer kept is copied to the
host, asynchronously). After the window, each judged solve's right-hand
side is made again (``traffic``) and solved by the plain float64
reference (``reference/cg.py``) on bands it builds itself
(``reference/<problem>.py``), with the same absolute tolerance. Compared,
each against the cell's limit:

- ``x_gap``: the largest ``||x - x_ref|| / ||x_ref||`` over the judged
  solves (infinite for a non-finite ``x``);
- ``k_gap``: the largest ``|k - k_ref| / k_ref``;
- ``residual_over_tol``: the largest residual that the program reports at
  its stop (``CGResult.residual_norm``) over the tolerance the harness
  gave it: a solve that stops short of its tolerance reads above 1. The
  true residual ``||b - A x||`` of a float32 answer cannot stand in for
  it at the cells' sizes: the answer's own rounding puts it above
  ``||b||`` (``calibrate``'s ``residual``, PERF.md);
- ``unconverged``: the solves of the window whose result says it did not
  converge (limit 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cgbench import spec, traffic
from cgbench.reference import cg as ref_cg


class Reservoir:
    """``size`` answers of a stream of solves, each solve equally likely
    to be kept, whatever the window's length (Algorithm R), the draws
    from the seed."""

    def __init__(self, seed: int, size: int, n: int = 0, dtype=None, pin: bool = False):
        self.rng = np.random.default_rng(traffic.stream_seed(seed, 1))
        self.size = size
        self.bufs = [torch.empty(n, dtype=dtype, pin_memory=pin) for _ in range(size)] if n else []
        self.meta = [None] * size

    def slot(self, j: int):
        """Where solve ``j`` (offered in order) is kept, or None: one draw
        from the seed a solve past the first ``size``."""
        slot = j if j < self.size else int(self.rng.integers(0, j + 1))
        return slot if slot < self.size else None

    def offer(self, j: int, x: torch.Tensor, k: int, residual) -> None:
        """Keep solve ``j``'s answer, if drawn; ``residual`` (a tensor) is read
        only then, once the solve has ended."""
        slot = self.slot(j)
        if slot is not None:
            self.bufs[slot].copy_(x, non_blocking=True)
            self.meta[slot] = (j, k, float(residual))

    def kept(self) -> dict:
        """``{j: (x, k, residual)}``; call after the device has finished the
        copies."""
        return {m[0]: (buf, *m[1:]) for buf, m in zip(self.bufs, self.meta) if m is not None}


def gap(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    d = torch.linalg.vector_norm(x.to(torch.float64) - x_ref)
    v = float(d / torch.linalg.vector_norm(x_ref))
    return v if math.isfinite(v) else math.inf


def judged(seed: int, size: int, solves: int) -> list:
    """The indices that a run of ``solves`` solves judges, by its seed."""
    res = Reservoir(seed, size)
    kept = [None] * size
    for j in range(solves):
        slot = res.slot(j)
        if slot is not None:
            kept[slot] = j
    return sorted(j for j in kept if j is not None)


def compare(cell: spec.Cell, rhs, kept: dict, device) -> dict:
    """``{"x_gap": ..., "k_gap": ..., "residual_over_tol": ...}`` over
    ``kept``, ``{j: (x, k, residual)}``."""
    problem = spec.load_module("reference", cell.config["problem"])
    bands = problem.bands(cell.config, torch.float64, device)
    offsets = problem.offsets(cell.config)
    n = problem.size(cell.config)
    precond = cell.mix["solve"].get("precond")
    x_gap = k_gap = over = 0.0
    for j, (x, k, residual) in sorted(kept.items()):
        b, tol = rhs.make(j)
        sol = ref_cg.cg(bands, offsets, b.to(torch.float64), tol, n, precond=precond)
        x_gap = max(x_gap, gap(x.to(device), sol.x))
        k_gap = max(k_gap, abs(k - sol.k) / max(sol.k, 1))
        over = max(over, residual / tol if math.isfinite(residual) else math.inf)
    return {"x_gap": x_gap, "k_gap": k_gap, "residual_over_tol": over}


def checks(values: dict, limits: dict) -> dict:
    """Each compared number beside its limit, in the limits' order."""
    return {name: {"value": values[name], "limit": limit} for name, limit in limits.items()}


def passed(table: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in table.values())  # NaN fails

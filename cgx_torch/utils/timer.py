"""Phase timers and the profiler hook (counterpart of ``cgx/utils/timer.py``).

The reference times exactly one wall-clock span (around solve(),
cg_main.cc:53-55) and relied on offline gprof for the "mat-vec
dominates" conclusion (figures/gprof.png). Here:

- :class:`PhaseTimer`: named wall-clock phases that synchronise the
  CUDA device of each tensor handed to a phase before it stops (cgx's
  ``block_until_ready`` on the values), so that the card's work counts
  in the phase that launched it;
- :func:`trace`: a ``torch.profiler`` trace of the CPU and, where there
  is a card, of CUDA, written as a Chrome-trace ``.json`` file (no
  TensorBoard needed; open it in ``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def _synchronize(tensors) -> None:
    """Wait for the CUDA device of each tensor; tensors on the CPU are ready."""
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating named phase timer.

    >>> t = PhaseTimer()
    >>> with t.phase("setup"):
    ...     ...
    >>> with t.phase("solve", x):   # waits for x's device before stopping
    ...     ...
    >>> t.report()   # {'setup': ..., 'solve': ...}
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, *sync_values):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and sync_values:
                _synchronize(sync_values)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:>20s}: {t:9.4f} s  ({100*t/total:5.1f}%)  x{self.counts[name]}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block inside; a no-op when
    ``log_dir`` is None. CPU activity is recorded, and CUDA activity when
    a card is there; on exit the card is synchronised and the trace is
    written into ``log_dir`` as ``trace_<pid>_<ns>.json`` (Chrome
    format)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

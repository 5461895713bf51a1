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
  TensorBoard needed; open it in ``chrome://tracing`` or Perfetto), with
  the window's solve records beside it;
- solve records: while a ``torch.profiler`` collects in the process, each
  call of :func:`cgx_torch.solve` keeps a record of its spans and
  counters (:func:`solve_records`); with no profiler, nothing is kept and
  each site below costs one test.

Spans are ranges of the profiler's RecordFunction, as
``torch.profiler.record_function`` opens them, so they sit in the Kineto
trace on the clock of the card's records; each is also kept, with its
``perf_counter_ns`` start and end and its parent, in the solve's record:

- ``cgx_torch.solve``: one call of ``solve``; the record names its route
  (``resident``, ``stream``, ``stream_pcg``, or another route's name);
- ``cgx_torch.prepare``: from ``solve``'s entry to the host loop's first
  enqueue (the routing, ``as_vector``, band copies and checks,
  ``pow2_rhs_scale``, the start state, the first read). On a route whose
  loop carries no spans it ends where ``solve`` hands over, and the
  route's own work is the solve span's;
- ``cgx_torch.loop``: the host loop (``cg_kernel._solve``'s chunks,
  ``cg_stream._run``'s), from its first enqueue;
- ``cgx_torch.enqueue``: the host work that puts one chunk on the card
  (one ``dia_cg_chunk`` with its scratch; up to ``_CHUNK`` launches of a
  streaming site);
- ``cgx_torch.read``: one blocking read of the packed scalars.

Counters, on the three routes whose loops carry spans (None elsewhere):

- ``launches``: the kernel launches made inside enqueue spans (the change
  of the enqueued wrapper's ``.launches``);
- ``host_reads``: every blocking device-to-host read on the solve's
  path: each ``read`` span, and in ``prepare`` the streaming route's
  ``bool(torch.equal(...))`` of ``_resolve_bands_dtype`` (1) and the
  ``float()`` of ``pow2_rhs_scale``'s pair (2);
- ``allocs`` and ``device_mallocs`` (every route, on CUDA; None on the
  CPU): the change of ``torch.cuda.memory_stats()``'s
  ``allocation.all.allocated`` and ``num_device_alloc`` across the solve
  span, read at its two ends.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

# a range of the profiler's RecordFunction; torch's fast form (for compiled code) opens
# one in about a tenth of record_function's time, which a resident solve's ~76 spans feel
_range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)


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


SOLVE = "cgx_torch.solve"
PREPARE = "cgx_torch.prepare"
LOOP = "cgx_torch.loop"
ENQUEUE = "cgx_torch.enqueue"
READ = "cgx_torch.read"
KEPT = 4096  # records of the last solves kept (a 40 s window of 31 ms solves makes ~1,300)

_records: collections.deque = collections.deque(maxlen=KEPT)
_ids = itertools.count(1)
_NULL = contextlib.nullcontext()


class _Local(threading.local):
    solve = None  # the _Solve being recorded on this thread, None while nothing is


_local = _Local()


class _Span:
    __slots__ = ("solve", "name")

    def __init__(self, solve: "_Solve", name: str):
        self.solve, self.name = solve, name

    def __enter__(self):
        self.solve.begin(self.name)

    def __exit__(self, *exc):
        self.solve.end()


class _Enqueue(_Span):
    """The enqueue span of ``site``'s launches; adds the change of the
    site's ``.launches`` (an int, or a dict of ints) to the counter."""

    __slots__ = ("site", "before")

    def __init__(self, solve: "_Solve", site):
        super().__init__(solve, ENQUEUE)
        self.site = site

    def __enter__(self):
        super().__enter__()
        self.before = _launches(self.site)

    def __exit__(self, *exc):
        self.solve.counters["launches"] += _launches(self.site) - self.before
        super().__exit__(*exc)


def _launches(site) -> int:
    n = site.launches
    return sum(n.values()) if isinstance(n, dict) else n


def _memory(device):
    """``(allocation.all.allocated, num_device_alloc)`` of ``device``'s
    caching allocator, or None off CUDA (the nested form of
    ``torch.cuda.memory_stats``, which skips its flattening)."""
    if device is None:
        return None
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return stats["allocation"]["all"]["allocated"], stats["num_device_alloc"]


class _Solve:
    """The record of one call of ``solve`` while it is being made."""

    def __init__(self, b, device):
        cuda = str(device).startswith("cuda") and torch.cuda.is_available()
        self.device = torch.device(device) if cuda else None
        self.id = next(_ids)
        shape = np.shape(b)
        self.n = int(shape[0]) if shape else None
        self.route = None
        self.spans: List[dict] = []
        self.open: List[tuple] = []  # (index in spans, range) of the open spans
        self.counters = {"launches": 0, "host_reads": 0, "allocs": None, "device_mallocs": None}

    def begin(self, name: str) -> None:
        fn = _range(name)
        fn.__enter__()
        self.spans.append({"name": name, "solve": self.id, "start_ns": time.perf_counter_ns(),
                           "end_ns": None, "parent": self.open[-1][0] if self.open else None})
        self.open.append((len(self.spans) - 1, fn))

    def end(self) -> None:
        i, fn = self.open.pop()
        self.spans[i]["end_ns"] = time.perf_counter_ns()
        fn.__exit__(None, None, None)

    def end_prepare(self) -> None:
        if self.open and self.spans[self.open[-1][0]]["name"] == PREPARE:
            self.end()

    def __enter__(self):
        _local.solve = self
        self.begin(SOLVE)
        self.memory = _memory(self.device)
        self.begin(PREPARE)
        return self

    def __exit__(self, *exc):
        while len(self.open) > 1:
            self.end()
        if self.memory is not None:
            after = _memory(self.device)
            self.counters["allocs"] = after[0] - self.memory[0]
            self.counters["device_mallocs"] = after[1] - self.memory[1]
        self.end()
        if _local.solve is None:  # handed over to a route whose loop carries no spans
            self.counters["launches"] = self.counters["host_reads"] = None
        _local.solve = None
        _records.append({"id": self.id, "route": self.route, "n": self.n, "spans": self.spans,
                         "counters": self.counters})


def recording(b, device):
    """The context of one call of ``solve`` on ``b``: a new solve record
    while a ``torch.profiler`` collects in the process and no solve is
    being recorded on this thread, else a no-op. The answer holds for the
    whole solve."""
    if _local.solve is not None or not torch.autograd._profiler_enabled():
        return _NULL
    return _Solve(b, device)


def route(name: str, *, spans: bool = False) -> None:
    """Name the recorded solve's route. ``spans``: the route's host loop
    carries spans and counters, and ``prepare`` stays open until its first
    enqueue; on any other route ``prepare`` ends here and nothing below
    the solve span is recorded."""
    rec = _local.solve
    if rec is None:
        return
    rec.route = name
    if not spans:
        rec.end_prepare()
        _local.solve = None


def loop():
    """The host loop's span; ends ``prepare``."""
    rec = _local.solve
    if rec is None:
        return _NULL
    rec.end_prepare()
    return _Span(rec, LOOP)


def enqueue(site):
    """The span of one chunk's launches of the kernel wrapper ``site``."""
    rec = _local.solve
    return _NULL if rec is None else _Enqueue(rec, site)


def read():
    """The span of one blocking read of the packed scalars (a host read)."""
    rec = _local.solve
    if rec is None:
        return _NULL
    rec.counters["host_reads"] += 1
    return _Span(rec, READ)


def host_reads(k: int = 1) -> None:
    """Count ``k`` blocking reads outside a ``read`` span (prepare's)."""
    rec = _local.solve
    if rec is not None:
        rec.counters["host_reads"] += k


def solve_records() -> List[dict]:
    """The records of the last :data:`KEPT` recorded solves, oldest
    first: ``id``, ``route``, ``n``, ``spans`` (each ``name``, ``solve``
    (the id), ``start_ns``, ``end_ns``, ``parent``: the index of the
    enclosing span in ``spans``, None for the solve span) and
    ``counters``."""
    return list(_records)


def clear_solve_records() -> None:
    _records.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block inside; a no-op when
    ``log_dir`` is None. CPU activity is recorded, and CUDA activity when
    a card is there; on exit the card is synchronised and the trace is
    written into ``log_dir`` as ``trace_<pid>_<ns>.json`` (Chrome
    format), and where the block called ``solve``, the records of those
    solves (:func:`solve_records`) as ``solves_<pid>_<ns>.json``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    last = _records[-1]["id"] if _records else 0
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    tag = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{tag}.json"))
    solves = [r for r in _records if r["id"] > last]
    if solves:
        with open(os.path.join(log_dir, f"solves_{tag}.json"), "w") as f:
            json.dump({"trace": f"trace_{tag}.json", "solves": solves}, f)

"""Reduce a ``torch.profiler`` window to what the per-layer readers need.

The harness marks each solve with a ``cgbench.solve`` span and each
right-hand side with ``cgbench.rhs`` (``record_function``). The traced
window runs from the first solve's start to the last one's end. From the
raw Kineto records (``prof.events()`` would first build a Python object
for every host event):

- ``busy_s``: the union of the device's operations in the window;
- ``solve_device_s``: the summed device time of the operations that start
  inside a solve span;
- ``device_ops``: device seconds by operation name, the ten largest;
- ``idle_gaps``: the window's idle device time by what the host was doing
  (the outermost and innermost host event on the harness's thread at each
  gap's middle), the ten largest.
"""

from __future__ import annotations

import bisect
import collections

SOLVE = "cgbench.solve"
RHS = "cgbench.rhs"
TOP = 10


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _labels(host: list, points: list) -> list:
    """For each time in ``points`` (sorted), ``outer > inner``: the
    outermost and innermost of the nested ``host`` events ``(start, end,
    name)`` that hold it."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    stack, out, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if not stack:
            out.append("host outside the harness's spans")
        elif len(stack) == 1:
            out.append(stack[0][2])
        else:
            out.append(f"{stack[0][2]} > {stack[-1][2]}")
    return out


def reduce(prof):
    """The window's summary, or None where the trace holds no solve span."""
    from torch.autograd import DeviceType

    device, host, spans, thread = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_hidden_event() and not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
            if e.name() == SOLVE:
                spans.append((e.start_ns(), e.end_ns()))
                thread = e.start_thread_id()
    if not spans:
        return None
    spans.sort()
    w0, w1 = spans[0][0], spans[-1][1]
    starts = [s for s, _ in spans]

    in_window = [(max(s, w0), min(e, w1), name) for s, e, name in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in in_window])
    by_name = collections.Counter()
    solve_ns = 0
    for s, e, name in device:
        by_name[name] += (min(e, w1) - max(s, w0)) if e > w0 and s < w1 else 0
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < spans[i][1]:
            solve_ns += e - s

    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    labels = _labels([h[:3] for h in host if h[3] == thread], [m for m, _ in mids])
    idle = collections.Counter()
    count = collections.Counter()
    for label, (_, length) in zip(labels, mids):
        idle[label] += length
        count[label] += 1
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "solve_device_s": solve_ns / 1e9,
        "device_events": len(in_window),
        "device_ops": [[name, ns / 1e9] for name, ns in by_name.most_common(TOP) if ns > 0],
        "idle_gaps": [[f"{label} ({count[label]} gaps)", ns / 1e9]
                      for label, ns in idle.most_common(TOP)],
    }

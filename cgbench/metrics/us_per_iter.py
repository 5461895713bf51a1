"""Microseconds of the window an iteration: the window's seconds over the
iterations the solves report."""


def read(rec):
    iters = sum(s["k"] for s in rec["solves"])
    return rec["window_s"] / iters * 1e6 if iters else None

"""Milliseconds a solve spends before its host loop's first enqueue: the
mean over the window's solves of their ``cgx_torch.prepare`` spans
(``cgx_torch.utils.timer.solve_records``, kept while the profiler of a
traced run collects). None where the program keeps no such records."""


def _window(rec):
    """The records of the window's solves: the last ``len(rec["solves"])``,
    or None where there are fewer."""
    try:
        from cgx_torch.utils.timer import solve_records
    except ImportError:
        return None
    records, n = solve_records(), len(rec["solves"])
    return records[-n:] if n and len(records) >= n else None


def read(rec):
    records = _window(rec)
    if records is None:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for r in records for s in r["spans"]
             if s["name"] == "cgx_torch.prepare")
    return ns / 1e6 / len(records)

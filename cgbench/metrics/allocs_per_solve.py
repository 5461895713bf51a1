"""Allocations a solve asks of the card's caching allocator: the mean of
the window's ``allocs`` counters, the change of ``torch.cuda.memory_stats``'s
``allocation.all.allocated`` across each solve
(``cgx_torch.utils.timer.solve_records``, kept while the profiler of a
traced run collects). None where the program keeps no such records or
the solves ran off CUDA."""


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
    if records is None or any(r["counters"]["allocs"] is None for r in records):
        return None
    return sum(r["counters"]["allocs"] for r in records) / len(records)

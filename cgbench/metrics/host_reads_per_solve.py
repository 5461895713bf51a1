"""Blocking device-to-host reads a solve makes: the mean of the window's
``host_reads`` counters (``cgx_torch.utils.timer.solve_records``, kept
while the profiler of a traced run collects). None where the program
keeps no such records."""


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
    if records is None or any(r["counters"]["host_reads"] is None for r in records):
        return None
    return sum(r["counters"]["host_reads"] for r in records) / len(records)

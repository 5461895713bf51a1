"""Host microseconds a kernel launch costs: the window's ``cgx_torch.enqueue``
spans (the host work that puts a chunk on the card) over the launches
made inside them (``cgx_torch.utils.timer.solve_records``, kept while the
profiler of a traced run collects). None where the program keeps no such
records or counted no launch."""


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
    if records is None or any(r["counters"]["launches"] is None for r in records):
        return None
    launches = sum(r["counters"]["launches"] for r in records)
    ns = sum(s["end_ns"] - s["start_ns"] for r in records for s in r["spans"]
             if s["name"] == "cgx_torch.enqueue")
    return ns / 1e3 / launches if launches else None

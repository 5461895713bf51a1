"""The least time a count of work needs on a card, from ``peaks.json``.

A count is ``{"bytes": b, "ops": {dtype name: operations}}`` (``work/``).
Its least time is the larger of the bytes at the card's HBM rate and the
operations, each dtype at its own peak rate.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def card(name: str):
    """The entry of the table whose ``match`` is in ``name``; None for a
    card the table lacks."""
    return next((e for e in json.loads(PEAKS.read_text())["cards"] if e["match"] in name), None)


def least_seconds(count: dict, peaks: dict) -> tuple:
    """``(seconds, "bytes" or "operations")``."""
    t_bytes = count["bytes"] / peaks["hbm_bytes_per_s"]
    t_ops = sum(ops / peaks["flops_per_s"][dt] for dt, ops in count["ops"].items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

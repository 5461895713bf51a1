"""The 95th percentile (nearest rank) of every solve's time in the window,
from its call until its result is on the host."""

import math


def read(rec):
    times = sorted(s["seconds"] for s in rec["solves"])
    return times[math.ceil(0.95 * len(times)) - 1] if times else None

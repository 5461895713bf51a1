"""Per-row interleaved-control gating of a measurement sweep
(counterpart of ``cgx/bench/tenancy.py``; the port keeps its own copy of
this host logic, which imports nothing of cgx).

A card shared with other work (another process on the host, a neighbour
on the machine, clocks that drop under a lower power limit) can slow any
wall-clock measurement for a while. A check before and after a whole
sweep (brackets) does not catch a slow spell that starts and ends
between them: both brackets come out clean while the rows between them
are not.

The remedy is adjacency: run a known-good control kernel on the card
immediately before AND after every measured row, and accept the row only
when both controls sit within a small deviation of the control's
calibrated value. A slow spell short enough to miss both adjacent
controls yet long enough to spoil the row between them has to switch on
and off within the row's own wall time.

Host-level orchestration only: the measure and control callables own
all the work on the card, so the logic is unit-testable with fake
callables and a virtual sleep.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence


def calibrate_control(
    control: Callable[[], float],
    *,
    runs: int = 3,
    rel_spread_gate: float = 0.05,
    max_rounds: int = 4,
    sleep_s: float = 10.0,
    sleep: Callable[[float], None] = time.sleep,
) -> Optional[float]:
    """Establish the control kernel's calm-window value.

    Runs the control ``runs`` times; accepts the MEDIAN iff the
    relative spread (max-min)/median is within ``rel_spread_gate``.
    A noisy calibration round is discarded wholesale and re-tried
    after ``sleep_s`` (up to ``max_rounds`` rounds) — calibrating
    against a poisoned window would gate every later row against
    garbage. Returns None if no calm window appears.
    """
    for _ in range(max_rounds):
        vals = sorted(control() for _ in range(runs))
        med = vals[len(vals) // 2]
        if med > 0 and (vals[-1] - vals[0]) / med <= rel_spread_gate:
            return med
        sleep(sleep_s)
    return None


def measure_with_control(
    measure: Callable[[], Dict],
    control: Callable[[], float],
    expected_control: float,
    *,
    deviation: float = 0.05,
    retries: int = 3,
    sleep_s: float = 10.0,
    sleep: Callable[[float], None] = time.sleep,
) -> Dict:
    """control -> measure -> control, accepted iff BOTH adjacent
    controls are within ``deviation`` (relative) of
    ``expected_control``.

    Returns the ``measure()`` row dict augmented with:
      control_pre / control_post: the adjacent control values
      control_dev: max relative deviation of the two controls
      row_trusted: the adjacency verdict
      attempts: how many tries it took
    On a failed attempt the row is RE-MEASURED after ``sleep_s`` (the
    burst has to pass), up to ``retries`` attempts; the last attempt
    is returned (flagged untrusted) so the caller can record the
    refusal without ever averaging a poisoned row into a table.
    """
    if expected_control <= 0:
        raise ValueError("expected_control must be positive")
    last: Dict = {}
    for attempt in range(1, retries + 1):
        pre = control()
        row = dict(measure())
        post = control()
        dev = max(
            abs(pre - expected_control), abs(post - expected_control)
        ) / expected_control
        row["control_pre"] = pre
        row["control_post"] = post
        row["control_dev"] = dev
        row["attempts"] = attempt
        row["row_trusted"] = dev <= deviation
        last = row
        if row["row_trusted"]:
            return row
        sleep(sleep_s)
    return last


def gated_sweep(
    rows: Sequence,
    measure_row: Callable[[object], Dict],
    control: Callable[[], float],
    *,
    deviation: float = 0.05,
    retries: int = 3,
    recalibrate_every: int = 0,
    sleep_s: float = 10.0,
    sleep: Callable[[float], None] = time.sleep,
    on_row: Optional[Callable[[Dict], None]] = None,
) -> List[Dict]:
    """Run a whole sweep under per-row control gating.

    Calibrates the control once up front (None -> every row is
    emitted untrusted with ``calibration_failed``), then measures each
    item via :func:`measure_with_control`. ``recalibrate_every`` > 0
    re-derives the expected control every that-many rows — thermal or
    clock-state drift over a long sweep must move the GATE, not fail
    every late row. ``on_row`` is a progress callback (stderr logging
    in scripts).
    """
    out: List[Dict] = []
    expected = calibrate_control(
        control, rel_spread_gate=deviation, sleep_s=sleep_s, sleep=sleep
    )
    for i, item in enumerate(rows):
        if expected is None or (
            recalibrate_every and i and i % recalibrate_every == 0
        ):
            # also RE-TRY a failed calibration before each row — a
            # tenancy storm at sweep start must not condemn the whole
            # sweep if it passes mid-way
            nxt = calibrate_control(
                control, rel_spread_gate=deviation, sleep_s=sleep_s,
                sleep=sleep,
            )
            expected = nxt if nxt is not None else expected
        if expected is None:
            row = dict(measure_row(item))
            row["row_trusted"] = False
            row["calibration_failed"] = True
        else:
            row = measure_with_control(
                lambda it=item: measure_row(it),
                control,
                expected,
                deviation=deviation,
                retries=retries,
                sleep_s=sleep_s,
                sleep=sleep,
            )
            row["expected_control"] = expected
        out.append(row)
        if on_row is not None:
            on_row(row)
    return out

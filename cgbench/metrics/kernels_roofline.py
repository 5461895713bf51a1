"""The least time the window's solves need on the card (``work/``, the
cell's method and problem, over ``peaks.json``), as a share of the device
time of the operations inside the traced solves."""

from cgbench.roofline import least_seconds


def read(rec):
    tr = rec["trace"]
    if not tr or not rec["peaks"] or tr["solve_device_s"] <= 0:
        return None
    return 100.0 * least_seconds(rec["work"], rec["peaks"])[0] / tr["solve_device_s"]

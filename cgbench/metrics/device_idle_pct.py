"""The share of the traced window in which the card ran no operation."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["device_events"] == 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

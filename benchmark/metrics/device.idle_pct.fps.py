"""The share of the traced window in which no operation ran on the device."""

UNIT = "%"
MOVES = "fps"
TRACE = True


def read(rec):
    t = rec.trace
    return None if t is None or t["window_s"] <= 0 else 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""The share of the profiled window (first to last device event after
the window's mark) in which no kernel, copy or fill ran on the card: one
minus the union of the device events over the window."""

LAYER = "device: one H100"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    traced = record.get("traced") or {}
    if not traced.get("window_s"):
        return None
    return 100.0 * (1.0 - traced["busy_s"] / traced["window_s"])

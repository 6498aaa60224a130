"""The optimizer family's share of its roofline: the ideal time of Adam's 22
bytes a parameter (``portbench/work.py``) over the device time, a step, of
the kernels the profiled steps ran in the program's ``optimizer`` range."""

from portbench import work

LAYER = "optimizer kernel: adam.cu"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    traced = record.get("traced") or {}
    ms = traced.get("family_ms", {}).get("optimizer", 0.0)
    if ms <= 0:
        return None
    return 100.0 * work.optimizer_ideal_s(record["model"]) * 1e3 / ms

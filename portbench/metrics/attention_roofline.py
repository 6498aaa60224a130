"""The attention family's share of its roofline: the ideal time of causal
attention's two forward and four backward products (``portbench/work.py``)
over the device time, a step, of the kernels the profiled steps ran in the
program's ``attention`` range."""

from portbench import work

LAYER = "attention kernels: flash_attn.cu, math_attention"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    traced = record.get("traced") or {}
    ms = traced.get("family_ms", {}).get("attention", 0.0)
    if ms <= 0:
        return None
    return 100.0 * work.attention_ideal_s(record["model"], record["mbs"], record["seq"]) \
        * 1e3 / ms

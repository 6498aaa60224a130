"""The gemm family's share of its roofline: the ideal time of the linear
layers' forward, dgrad and wgrad products (``portbench/work.py``) over the
device time, a step, of the kernels the profiled steps ran in the
program's ``gemm`` range (int8: with its quantize and dequantize kernels)."""

from portbench import work

LAYER = "linear layers: torchref _linear, quantized.py, moe_model products"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    traced = record.get("traced") or {}
    ms = traced.get("family_ms", {}).get("gemm", 0.0)
    if ms <= 0:
        return None
    tokens = record["mbs"] * record["seq"]
    return 100.0 * work.gemm_ideal_s(record["model"], tokens, record["linear"]) * 1e3 / ms

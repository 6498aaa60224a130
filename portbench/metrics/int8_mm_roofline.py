"""The int8 products' share of their roofline: the ideal time of the
linear layers' forward, dgrad and wgrad products at the int8 peak
(``portbench/work.py``) over the device time, a step, of the kernels the
profiled steps ran in the program's ``int8_mm`` spans (``torch._int_mm``
alone, without the quantization around it; ``portbench/spans.py``)."""

from portbench import spans, work

LAYER = "linear layers: torchref _linear, quantized.py, moe_model products"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    ms = ((spans.read(record) or {}).get("region_ms") or {}).get("int8_mm", 0.0)
    if ms <= 0:
        return None
    tokens = record["mbs"] * record["seq"]
    return 100.0 * work.gemm_ideal_s(record["model"], tokens, "int8") * 1e3 / ms

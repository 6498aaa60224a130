"""The sigmoid route's share of its roofline: the router's three float32
products (forward, dgrad, wgrad) at the CUDA cores' 67 TFLOP/s and the
route and index kernels' bytes at 3.35 TB/s in every expert layer (the
kind's ``route_ideal_s``) over the device time, a step, of the kernels the
profiled steps ran in the program's ``route`` spans (with the casts of
the router's operands to float32; ``portbench/mla_spans.py``)."""

from portbench import manifest, mla_spans

LAYER = "MoE route and index: moe_route.cu"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    ms = mla_spans.region_ms(record, "route")
    if ms <= 0:
        return None
    m = record["model"]
    ideal_s = manifest.load_kind(m.kind).route_ideal_s(m, record["mbs"] * record["seq"])
    return 100.0 * ideal_s * 1e3 / ms

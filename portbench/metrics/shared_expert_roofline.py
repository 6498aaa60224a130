"""The shared experts' share of their roofline: the ideal time of the
``shared_up`` and ``shared_down`` products' forward, dgrad and wgrad in
every expert layer (the kind's ``shared_expert_shapes``,
``portbench/work.py``'s ideal) over the device time, a step, of the
kernels the profiled steps ran in the program's ``shared_expert`` spans
(``portbench/mla_spans.py``)."""

from portbench import manifest, mla_spans, work

LAYER = "linear layers: torchref _linear, quantized.py, moe_model products"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    ms = mla_spans.region_ms(record, "shared_expert")
    if ms <= 0:
        return None
    m = record["model"]
    kind = manifest.load_kind(m.kind)
    tokens = record["mbs"] * record["seq"]
    ideal_s = (m.layers - m.own.first_dense) * sum(
        work.product_ideal_s(tokens * per_token, k, n, record["linear"], weights)
        for _name, per_token, k, n, weights in kind.shared_expert_shapes(m))
    return 100.0 * ideal_s * 1e3 / ms

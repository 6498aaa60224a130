"""Latent attention's projections' share of their roofline: the ideal time
of the ``q``, ``kv_a`` and ``kv_b`` products' forward, dgrad and wgrad in
every layer (``q_proj``, ``kv_a_proj_with_mqa``, ``kv_b_proj``; the kind's
``mla_proj_shapes``, ``portbench/work.py``'s ideal) over the device time,
a step, of the kernels the profiled steps ran in the program's
``mla_proj`` spans (``portbench/mla_spans.py``)."""

from portbench import manifest, mla_spans, work

LAYER = "linear layers: torchref _linear, quantized.py, moe_model products"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    ms = mla_spans.region_ms(record, "mla_proj")
    if ms <= 0:
        return None
    m = record["model"]
    tokens = record["mbs"] * record["seq"]
    ideal_s = m.layers * sum(
        work.product_ideal_s(tokens * per_token, k, n, record["linear"], weights)
        for _name, per_token, k, n, weights in manifest.load_kind(m.kind).mla_proj_shapes(m))
    return 100.0 * ideal_s * 1e3 / ms

"""The MoE experts' products' share of their roofline: the ideal time of
the ``expert_up`` and ``expert_down`` products' forward, dgrad and wgrad
over the routed assignments (tokens x top-k; ``portbench/work.py``), not
the capacity buffer's padded rows, over the device time, a step, of the
kernels the profiled steps ran in the program's ``expert_gemm`` spans
(``portbench/spans.py``)."""

from portbench import spans, work

LAYER = "linear layers: torchref _linear, quantized.py, moe_model products"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    ms = ((spans.read(record) or {}).get("region_ms") or {}).get("expert_gemm", 0.0)
    if ms <= 0:
        return None
    tokens = record["mbs"] * record["seq"]
    ideal_s = sum(work.product_ideal_s(tokens * per_token, k, n, record["linear"], weights)
                  for name, per_token, k, n, weights in work.linear_shapes(record["model"])
                  if name in ("expert_up", "expert_down"))
    return 100.0 * ideal_s * 1e3 / ms

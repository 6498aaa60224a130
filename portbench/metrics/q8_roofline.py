"""The int8 products' quantization and dequantization against their
roofline: the bytes they need at the HBM bandwidth (:func:`q8_bytes`)
over the device time, a step, of the kernels the profiled steps ran in
the program's ``q8`` spans (amax, quantize and dequantize kernels;
``portbench/spans.py``)."""

from portbench import spans, work

LAYER = "linear layers: torchref _linear, quantized.py, moe_model products"
UNIT = "%"
MOVES = "tokens_per_s"


def q8_bytes(m, tokens: int) -> float:
    """The bytes a step's int8 products need quantized and dequantized.
    For a product of R rows, inner k and outer n: x [R, k], w [k, n] and
    the output's gradient g [R, n] each read once in bf16 and written in
    int8 once for each of the two orders its products take it in (4 B an
    element), and each int32 product, y [R, n], dx [R, k] and dw [k, n],
    read once and written once in bf16 (6 B): 10 (R k + k n + R n)."""
    total = 0
    for _name, per_token, k, n, weights in work.linear_shapes(m):
        rows = tokens * per_token
        total += 10 * (rows * k + weights * k * n + rows * n)
    return float(total)


def read(record):
    ms = ((spans.read(record) or {}).get("region_ms") or {}).get("q8", 0.0)
    if ms <= 0:
        return None
    ideal_s = q8_bytes(record["model"], record["mbs"] * record["seq"]) / work.HBM_BYTES_PER_S
    return 100.0 * ideal_s * 1e3 / ms

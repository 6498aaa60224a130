"""The work one training step needs, counted from the configuration's
shapes, and the ideal time of that work on one H100. A metric reader
counts the work it holds a time against with these functions, from the
run's shapes in the record it is given.

Ideal time of a part: the larger of its operations over the peak of the
type it runs in and its bytes over the HBM bandwidth (NVIDIA's H100 SXM
data sheet, dense rates, at the full 700 W). A share is an ideal time
over a measured one, so no share of this kind can pass 100% while the
measured time covers the work counted.

What is counted is what the step needs, not what an implementation does:
the causal half of attention and no recompute; the MoE experts' products
over the routed assignments (tokens x top-k), not the padded capacity
buffer; Adam's bytes at one read of the parameter, gradient and both
moments and one write of the parameter and both moments. The shapes come
from the model's kind (``portbench/kinds/<kind>.py``): its linear layers,
attention's operations and elements, its parameters.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.manifest import load_kind
from portbench.weights import Model

#: published peaks of one NVIDIA H100 SXM (dense, no sparsity)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
BF16, FP32 = 2, 4


def linear_shapes(m: Model) -> List[Tuple[str, int, int, int, int]]:
    """(name, rows a token, k, n, weights) of every linear layer of one
    step: ``rows a token`` rows of its product per token (the MoE experts':
    top-k, the routed assignments over all experts), ``weights`` [k, n]
    matrices read (the experts'). The MoE router's product runs in the
    route's range, not among these."""
    return load_kind(m.kind).linear_shapes(m)


def product_ideal_s(rows: int, k: int, n: int, linear: str, weights: int = 1) -> float:
    """Ideal seconds of one linear layer's three products (forward, dgrad,
    wgrad) at ``rows`` rows: 2 rows k n operations each at the linear
    type's peak, or, if longer, its bf16 operands read once and its bf16
    output written once (the same three tensors in each product: x [rows,
    k], ``weights`` [k, n], y [rows, n] or their gradients)."""
    ops = 2.0 * rows * k * n
    bytes_ = BF16 * (rows * k + weights * k * n + rows * n)
    return 3 * max(ops / PEAK_OPS[linear], bytes_ / HBM_BYTES_PER_S)


def gemm_ideal_s(m: Model, tokens: int, linear: str) -> float:
    """The linear layers' ideal seconds a step (every product's forward,
    dgrad and wgrad)."""
    return sum(product_ideal_s(tokens * per_token, k, n, linear, weights)
               for _name, per_token, k, n, weights in linear_shapes(m))


def attention_ops(m: Model, mbs: int, seq: int) -> float:
    """Causal attention's operations a step, as the kind counts them."""
    return load_kind(m.kind).attention_ops(m, mbs, seq)


def attention_ideal_s(m: Model, mbs: int, seq: int) -> float:
    """Attention's ideal seconds a step: its operations at the bf16 peak,
    or the elements it reads and writes (the kind's count) once each in
    bf16, whichever is longer."""
    bytes_ = BF16 * load_kind(m.kind).attention_elements(m, mbs * seq)
    return max(attention_ops(m, mbs, seq) / PEAK_OPS["bf16"], bytes_ / HBM_BYTES_PER_S)


def gqa_shapes(m: Model) -> List[Tuple[str, int, int, int, int]]:
    """The linear layers of one GQA attention block, as :func:`linear_shapes`
    gives them."""
    h, d = m.hidden, m.head_dim
    return [("qkv", 1, h, (m.heads + 2 * m.kv_heads) * d, 1), ("out", 1, m.heads * d, h, 1)]


def gqa_attention_ops(m: Model, mbs: int, seq: int) -> float:
    """Causal GQA attention's operations a step: the forward's two products
    and the backward's four over the causal half, 6 b s^2 heads d a layer."""
    return 6.0 * mbs * seq * seq * m.heads * m.head_dim * m.layers


def gqa_attention_elements(m: Model, tokens: int) -> int:
    """The elements GQA attention reads and writes a step: q, k, v and o
    and their gradients once each."""
    q_elems = tokens * m.heads * m.head_dim
    kv_elems = tokens * m.kv_heads * m.head_dim
    # forward: q, k, v read, o written; backward: q, k, v, o, do read and
    # dq, dk, dv written
    elems = (q_elems + 2 * kv_elems + q_elems) + (3 * q_elems + 2 * kv_elems) \
        + (q_elems + 2 * kv_elems)
    return elems * m.layers


def param_count(m: Model) -> int:
    return load_kind(m.kind).param_count(m)


def touched_params(m: Model) -> Dict[str, int]:
    """The parameters one token touches, by the type their products run
    in (``linear``, ``other``): the embedding lookup left out, only the
    experts a token is routed to counted."""
    return load_kind(m.kind).touched_params(m)


def model_ideal_s(m: Model, mbs: int, seq: int, linear: str) -> float:
    """Ideal seconds of one step's model FLOPs: 6 x the parameters a
    token touches x tokens, the linear layers' at their type's peak and
    the rest at bf16's, plus causal attention's at bf16's."""
    tokens = mbs * seq
    touched = touched_params(m)
    return (6.0 * touched["linear"] * tokens / PEAK_OPS[linear]
            + 6.0 * touched["other"] * tokens / PEAK_OPS["bf16"]
            + attention_ops(m, mbs, seq) / PEAK_OPS["bf16"])


def optimizer_bytes(m: Model) -> float:
    """Adam's bytes a step with bf16 parameters and gradients and float32
    moments: read p, g, mu, nu and write p, mu, nu, 22 B a parameter."""
    return param_count(m) * (BF16 + BF16 + 2 * FP32 + BF16 + 2 * FP32)


def optimizer_ideal_s(m: Model) -> float:
    return optimizer_bytes(m) / HBM_BYTES_PER_S

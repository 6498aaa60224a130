"""The dense decoder (``"model": "dense"``): Llama's block, GQA attention
with split-half RoPE and a SwiGLU MLP, an RMS norm before each, an untied
LM head.

The port runs it as ``torchref.model.make_train_step(LlamaConfig(...))``,
with flash attention and int8 linear layers as the cell asks. The
reference's MLP is ``down(silu(gate) * val)`` with ``[gate | val] = up(y)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from portbench import program, reference, work
from portbench.reference import linear, rms_norm, swiglu
from portbench.weights import Model


def sizes(cfg: Dict) -> Model:
    return Model.common(cfg)


def leaf_specs(m: Model) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """The program's layout; the scales its initialiser's, 1 / sqrt(fan in)
    (0.02 for the embedding)."""
    h, d = m.hidden, m.head_dim
    qkv = (h, (m.heads + 2 * m.kv_heads) * d)
    specs = [(("embedding",), (m.vocab, h), 0.02)]
    for i in range(m.layers):
        specs += [
            (("layers", i, "input_norm"), (h,), 0.0),
            (("layers", i, "qkv"), qkv, h ** -0.5),
            (("layers", i, "out"), (m.heads * d, h), (m.heads * d) ** -0.5),
            (("layers", i, "pre_mlp_norm"), (h,), 0.0),
            (("layers", i, "up"), (h, 2 * m.ffn), h ** -0.5),
            (("layers", i, "down"), (m.ffn, h), m.ffn ** -0.5),
        ]
    return specs + [(("final_norm",), (h,), 0.0), (("lm_head",), (h, m.vocab), h ** -0.5)]


def build(m: Model, cell: Dict, opt: Dict):
    from simumax_tpu_torch.torchref.model import LlamaConfig, make_train_step

    cfg = program.port_config(
        LlamaConfig, cell, vocab_size=m.vocab, hidden_size=m.hidden, head_num=m.heads,
        kv_head_num=m.kv_heads, head_size=m.head_dim, intermediate_size=m.ffn,
        layer_num=m.layers, rope_theta=m.rope_theta, dtype=torch.bfloat16)
    return make_train_step(cfg, lr=opt["lr"])


def block(x: torch.Tensor, p: Dict, m: Model, levels: Optional[int]) -> torch.Tensor:
    x = reference.self_attention(x, p, m, levels)
    y = rms_norm(x, p["pre_mlp_norm"], m.eps)
    return x + linear(swiglu(linear(y, p["up"], levels)), p["down"], levels)


def loss(params: Dict, ids: torch.Tensor, targets: torch.Tensor, m: Model,
         levels: Optional[int], router_levels: Optional[int] = None) -> torch.Tensor:
    return reference.decoder_loss(params, ids, targets, m, levels, block)


def linear_shapes(m: Model) -> List[Tuple[str, int, int, int, int]]:
    h = m.hidden
    out = []
    for _ in range(m.layers):
        out += work.gqa_shapes(m)
        out.append(("up", 1, h, 2 * m.ffn, 1))
        out.append(("down", 1, m.ffn, h, 1))
    out.append(("lm_head", 1, h, m.vocab, 1))
    return out


attention_ops = work.gqa_attention_ops
attention_elements = work.gqa_attention_elements


def param_count(m: Model) -> int:
    h, d = m.hidden, m.head_dim
    attn = h * (m.heads + 2 * m.kv_heads) * d + m.heads * d * h + 2 * h
    mlp = 3 * h * m.ffn
    return m.layers * (attn + mlp) + 2 * m.vocab * h + h


def touched_params(m: Model) -> Dict[str, int]:
    h, d = m.hidden, m.head_dim
    linear_ = m.layers * (h * (m.heads + 2 * m.kv_heads) * d + m.heads * d * h)
    linear_ += m.layers * 3 * h * m.ffn
    other = m.layers * 2 * h + h  # the norms' weights
    return {"linear": linear_ + h * m.vocab, "other": other}

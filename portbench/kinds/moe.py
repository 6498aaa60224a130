"""The sparse-expert decoder (``"model": "moe"``): Mixtral's block, GQA
attention with split-half RoPE and a routed MLP of ``experts`` SwiGLU
experts, ``topk`` a token, dispatched into a buffer of fixed capacity.

The port runs it as ``torchref.moe_model.make_train_step(MoeConfig(...))``;
``MoeConfig`` declares no flash or int8 switch, so its cells run math
attention and bf16 linear layers. The reference's MLP: gate logits, a
float32 softmax, the top-k experts, weights renormalised as
``v / (sum v + 1e-9)``, each expert's assignments in token-major order kept
up to ``int(cf * T * k / e)`` and the rest dropped, each kept assignment
through its expert's SwiGLU MLP and added to its token weighted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench import program, reference, work
from portbench.reference import linear, rms_norm, swiglu
from portbench.weights import Model

#: the route's renormalisation term
RENORM_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Own:
    """The sizes only this kind has."""

    experts: int
    topk: int
    capacity_factor: float


def sizes(cfg: Dict) -> Model:
    return Model.common(cfg, Own(experts=int(cfg["num_local_experts"]),
                                 topk=int(cfg["num_experts_per_tok"]),
                                 capacity_factor=float(cfg["capacity_factor"])))


def leaf_specs(m: Model) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """The program's layout; every scale its initialiser's 0.02."""
    h, d, e = m.hidden, m.head_dim, m.own.experts
    qkv = (h, (m.heads + 2 * m.kv_heads) * d)
    specs = [(("embedding",), (m.vocab, h), 0.02)]
    for i in range(m.layers):
        specs += [
            (("layers", i, "input_norm"), (h,), 0.0),
            (("layers", i, "qkv"), qkv, 0.02),
            (("layers", i, "out"), (m.heads * d, h), 0.02),
            (("layers", i, "pre_mlp_norm"), (h,), 0.0),
            (("layers", i, "gate"), (h, e), 0.02),
            (("layers", i, "moe_up"), (e, h, 2 * m.ffn), 0.02),
            (("layers", i, "moe_down"), (e, m.ffn, h), 0.02),
        ]
    return specs + [(("final_norm",), (h,), 0.0), (("lm_head",), (h, m.vocab), 0.02)]


def build(m: Model, cell: Dict, opt: Dict):
    from simumax_tpu_torch.torchref.moe_model import MoeConfig, make_train_step

    cfg = program.port_config(
        MoeConfig, cell, vocab_size=m.vocab, hidden_size=m.hidden, head_num=m.heads,
        kv_head_num=m.kv_heads, head_size=m.head_dim, layer_num=m.layers,
        expert_num=m.own.experts, topk=m.own.topk, moe_ffn=m.ffn,
        capacity_factor=m.own.capacity_factor, rope_theta=m.rope_theta, dtype=torch.bfloat16)
    return make_train_step(cfg, lr=opt["lr"])


def moe_mlp(y: torch.Tensor, p: Dict, m: Model, levels: Optional[int],
            router_levels: Optional[int]) -> torch.Tensor:
    b, s, h = y.shape
    T, k, e = b * s, m.own.topk, m.own.experts
    y2 = y.reshape(T, h)
    probs = torch.softmax(linear(y2, p["gate"], router_levels), dim=-1)
    topv, topi = probs.topk(k, dim=-1)
    w = (topv / (topv.sum(-1, keepdim=True) + RENORM_EPS)).reshape(T * k)
    expert = topi.reshape(T * k)  # assignment a = token * k + j
    onehot = F.one_hot(expert, e)
    rank = (onehot.cumsum(0) * onehot).sum(-1) - 1  # its place in its expert's run
    keep = rank < int(m.own.capacity_factor * T * k / e)
    out = torch.zeros_like(y2)
    for x in range(e):
        a = torch.nonzero((expert == x) & keep).squeeze(1)
        tok = a // k
        down = linear(swiglu(linear(y2[tok], p["moe_up"][x], levels)), p["moe_down"][x], levels)
        out = out.index_add(0, tok, down * w[a, None])
    return out.reshape(b, s, h)


def block(x: torch.Tensor, p: Dict, m: Model, levels: Optional[int],
          router_levels: Optional[int]) -> torch.Tensor:
    x = reference.self_attention(x, p, m, levels)
    y = rms_norm(x, p["pre_mlp_norm"], m.eps)
    return x + moe_mlp(y, p, m, levels, router_levels)


def loss(params: Dict, ids: torch.Tensor, targets: torch.Tensor, m: Model,
         levels: Optional[int], router_levels: Optional[int] = None) -> torch.Tensor:
    return reference.decoder_loss(params, ids, targets, m, levels, block, router_levels)


def linear_shapes(m: Model) -> List[Tuple[str, int, int, int, int]]:
    """The experts' products over the routed assignments (top-k rows a
    token, all ``experts`` matrices read); the router's product runs in the
    route's range, not among these."""
    h, k, e = m.hidden, m.own.topk, m.own.experts
    out = []
    for _ in range(m.layers):
        out += work.gqa_shapes(m)
        out.append(("expert_up", k, h, 2 * m.ffn, e))
        out.append(("expert_down", k, m.ffn, h, e))
    out.append(("lm_head", 1, h, m.vocab, 1))
    return out


attention_ops = work.gqa_attention_ops
attention_elements = work.gqa_attention_elements


def param_count(m: Model) -> int:
    h, d, e = m.hidden, m.head_dim, m.own.experts
    attn = h * (m.heads + 2 * m.kv_heads) * d + m.heads * d * h + 2 * h
    mlp = h * e + e * 3 * h * m.ffn
    return m.layers * (attn + mlp) + 2 * m.vocab * h + h


def touched_params(m: Model) -> Dict[str, int]:
    h, d = m.hidden, m.head_dim
    linear_ = m.layers * (h * (m.heads + 2 * m.kv_heads) * d + m.heads * d * h)
    linear_ += m.layers * m.own.topk * 3 * h * m.ffn  # the top-k experts alone
    other = m.layers * 2 * h + h  # the norms' weights
    other += m.layers * h * m.own.experts  # the router's product stays bf16
    return {"linear": linear_ + h * m.vocab, "other": other}

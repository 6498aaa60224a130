"""Latent attention with sigmoid-routed experts (``"model": "mla_moe"``):
DeepSeek-V3's block (Moonlight-16B-A3B), on one chip's share of its expert
layers.

The port runs it as
``torchref.mla_moe_model.make_train_step(MlaMoeConfig(...))`` with flash
attention as the cell asks (``MlaMoeConfig`` declares no int8 switch).

The configuration's ``n_routed_experts`` counts the experts held here, the
``experts_held`` = [first, count] of the layer's ``published``
``n_routed_experts``, over which the router keeps its width. The plain
reference, in float32 from ``reference.py``'s pieces:

* MLA: ``q = q_proj(y)`` (heads of nope + rope); ``[c | k_pe] =
  kv_a_proj_with_mqa(y)``; ``[k_nope | v] = kv_b_proj(rms_norm(c))`` a head;
  split-half RoPE of q's rope columns and of the one shared k_pe; causal
  attention of ``[q_nope | q_pe]`` against ``[k_nope | k_pe]`` at scale 1 /
  sqrt(nope + rope), over v; ``o_proj``;
* a dense first layer: ``down(silu(gate) * val)``, ``[gate | val] =
  up(y)``;
* an expert layer: s = sigmoid(router(y)) over every expert; the top-k by s
  + the layer's correction bias; w = the chosen s over (their sum + 1e-20),
  times ``routed_scaling_factor``; each expert's assignments in token-major
  order kept up to the uncut layer's ``int(cf * T * k / n_routed)``; the
  held experts' kept assignments through their SwiGLU MLPs, added to their
  tokens weighted; the shared experts' SwiGLU MLP on every token; the
  output ``x + attn``, then ``+ shared + routed``.

The correction bias is fixed, made from the configuration's
``correction_bias_seed`` and ``correction_bias_std`` as the port makes it
(a CPU generator's standard normal [expert layers, n_routed] in float32,
times the std), and gets no gradient on either side.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import program, reference, work
from portbench.reference import linear, rms_norm, swiglu
from portbench.weights import Model

#: the sigmoid route's normalisation term
SIGMOID_EPS = 1e-20
#: the float32 products' peak on the CUDA cores (H100 SXM data sheet)
FP32_OPS = 67e12


@dataclasses.dataclass(frozen=True)
class Own:
    """The sizes only this kind has."""

    nope: int  # qk_nope_head_dim
    rope: int  # qk_rope_head_dim
    v_head: int
    kv_lora_rank: int
    experts: int  # the router's width: the layer's routed experts, all chips
    held: Tuple[int, int]  # (first, count): the experts held here
    topk: int
    shared: int  # n_shared_experts
    first_dense: int  # first_k_dense_replace
    dense_ffn: int
    scale: float  # routed_scaling_factor
    capacity_factor: float
    bias_std: float
    bias_seed: int


def sizes(cfg: Dict) -> Model:
    nope, rope = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
    first, count = (int(x) for x in cfg["experts_held"])
    if count != int(cfg["n_routed_experts"]):
        raise ValueError(f"experts_held {cfg['experts_held']} does not hold the "
                         f"n_routed_experts {cfg['n_routed_experts']} held here")
    own = Own(nope=nope, rope=rope, v_head=int(cfg["v_head_dim"]),
              kv_lora_rank=int(cfg["kv_lora_rank"]),
              experts=int(cfg["published"]["n_routed_experts"]), held=(first, count),
              topk=int(cfg["num_experts_per_tok"]), shared=int(cfg["n_shared_experts"]),
              first_dense=int(cfg["first_k_dense_replace"]),
              dense_ffn=int(cfg["intermediate_size"]),
              scale=float(cfg["routed_scaling_factor"]),
              capacity_factor=float(cfg["capacity_factor"]),
              bias_std=float(cfg["correction_bias_std"]),
              bias_seed=int(cfg["correction_bias_seed"]))
    heads = int(cfg["num_attention_heads"])
    return Model(kind=cfg["model"], vocab=int(cfg["vocab_size"]), hidden=int(cfg["hidden_size"]),
                 heads=heads, kv_heads=heads, head_dim=nope + rope,
                 layers=int(cfg["num_hidden_layers"]), ffn=int(cfg["moe_intermediate_size"]),
                 rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]), own=own)


def _layer_shapes(m: Model, dense: bool) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan in) of a layer's weights in the program's layout
    (``MlaMoeConfig``'s ``layer_shapes``); fan in 0 for a norm's weight."""
    o, h, heads = m.own, m.hidden, m.heads
    r = o.kv_lora_rank
    out = [("input_layernorm", (h,), 0), ("q_proj", (h, heads * m.head_dim), h),
           ("kv_a_proj_with_mqa", (h, r + o.rope), h), ("kv_a_layernorm", (r,), 0),
           ("kv_b_proj", (r, heads * (o.nope + o.v_head)), r),
           ("o_proj", (heads * o.v_head, h), heads * o.v_head),
           ("post_attention_layernorm", (h,), 0)]
    if dense:
        return out + [("up", (h, 2 * o.dense_ffn), h), ("down", (o.dense_ffn, h), o.dense_ffn)]
    held, f, shared = o.held[1], m.ffn, o.shared * m.ffn
    return out + [("router", (h, o.experts), h), ("experts_up", (held, h, 2 * f), h),
                  ("experts_down", (held, f, h), f), ("shared_up", (h, 2 * shared), h),
                  ("shared_down", (shared, h), shared)]


def leaf_specs(m: Model) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """The program's layout; the scales 1 / sqrt(fan in) (0.02 for the
    embedding)."""
    specs = [(("embedding",), (m.vocab, m.hidden), 0.02)]
    for i in range(m.layers):
        specs += [(("layers", i, name), shape, fan_in ** -0.5 if fan_in else 0.0)
                  for name, shape, fan_in in _layer_shapes(m, i < m.own.first_dense)]
    return specs + [(("final_norm",), (m.hidden,), 0.0),
                    (("lm_head",), (m.hidden, m.vocab), m.hidden ** -0.5)]


def port_fields(m: Model) -> Dict:
    """``MlaMoeConfig``'s fields for model ``m`` (all but ``dtype`` and
    ``use_flash_attn``)."""
    o = m.own
    return dict(vocab_size=m.vocab, hidden_size=m.hidden, num_attention_heads=m.heads,
                qk_nope_head_dim=o.nope, qk_rope_head_dim=o.rope, v_head_dim=o.v_head,
                kv_lora_rank=o.kv_lora_rank, num_hidden_layers=m.layers,
                first_k_dense_replace=o.first_dense, intermediate_size=o.dense_ffn,
                moe_intermediate_size=m.ffn, n_routed_experts=o.experts, experts_held=o.held,
                num_experts_per_tok=o.topk, n_shared_experts=o.shared,
                routed_scaling_factor=o.scale, rope_theta=m.rope_theta,
                capacity_factor=o.capacity_factor, correction_bias_std=o.bias_std,
                correction_bias_seed=o.bias_seed)


def build(m: Model, cell: Dict, opt: Dict):
    from simumax_tpu_torch.torchref.mla_moe_model import MlaMoeConfig, make_train_step

    cfg = program.port_config(MlaMoeConfig, cell, dtype=torch.bfloat16, **port_fields(m))
    return make_train_step(cfg, lr=opt["lr"])


def correction_bias(m: Model) -> torch.Tensor:
    """The expert layers' correction biases [layers - first_dense, experts]
    float32 on the CPU, made as the port makes them."""
    o = m.own
    gen = torch.Generator().manual_seed(o.bias_seed)
    shape = (m.layers - o.first_dense, o.experts)
    return torch.randn(shape, generator=gen, dtype=torch.float32) * o.bias_std


def mla(x: torch.Tensor, p: Dict, m: Model, levels: Optional[int]) -> torch.Tensor:
    """The residual stream after a block's latent attention."""
    o = m.own
    b, s, _ = x.shape
    heads, nope, rope, r = m.heads, o.nope, o.rope, o.kv_lora_rank
    y = rms_norm(x, p["input_layernorm"], m.eps)
    q = linear(y, p["q_proj"], levels).reshape(b, s, heads, nope + rope)
    ckv = linear(y, p["kv_a_proj_with_mqa"], levels)
    kv = linear(rms_norm(ckv[..., :r], p["kv_a_layernorm"], m.eps), p["kv_b_proj"], levels)
    kv = kv.reshape(b, s, heads, nope + o.v_head)
    q_pe = reference.rope(q[..., nope:], m.rope_theta)
    k_pe = reference.rope(ckv[..., r:].reshape(b, s, 1, rope), m.rope_theta)
    q = torch.cat([q[..., :nope], q_pe], -1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, s, heads, rope)], -1)
    return x + linear(reference.attention(q, k, kv[..., nope:]), p["o_proj"], levels)


def routing(logits: torch.Tensor, m: Model, bias: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The route of the router's logits [T, experts]: (each assignment a =
    token * k + j's expert, its weight, whether it is kept), [T * k] each."""
    o = m.own
    T, k, e = logits.shape[0], o.topk, o.experts
    scores = torch.sigmoid(logits)
    topi = (scores.detach() + bias).topk(k, dim=-1).indices
    topv = scores.gather(-1, topi)
    w = (topv / (topv.sum(-1, keepdim=True) + SIGMOID_EPS) * o.scale).reshape(T * k)
    expert = topi.reshape(T * k)
    onehot = F.one_hot(expert, e)
    rank = (onehot.cumsum(0) * onehot).sum(-1) - 1  # its place in its expert's run
    return expert, w, rank < int(o.capacity_factor * T * k / e)


def routed(y: torch.Tensor, p: Dict, m: Model, levels: Optional[int],
           router_levels: Optional[int], bias: torch.Tensor) -> torch.Tensor:
    """The held experts' part of the routed MLP of y [b, s, h]."""
    o = m.own
    b, s, h = y.shape
    T, k = b * s, o.topk
    y2 = y.reshape(T, h)
    expert, w, keep = routing(linear(y2, p["router"], router_levels), m, bias)
    first, count = o.held
    out = torch.zeros_like(y2)
    for x in range(first, first + count):
        a = torch.nonzero((expert == x) & keep).squeeze(1)
        if a.numel() == 0:  # an expert no token chose adds nothing
            continue
        tok = a // k
        up = linear(y2[tok], p["experts_up"][x - first], levels)
        down = linear(swiglu(up), p["experts_down"][x - first], levels)
        out = out.index_add(0, tok, down * w[a, None])
    return out.reshape(b, s, h)


def block(x: torch.Tensor, p: Dict, m: Model, levels: Optional[int],
          router_levels: Optional[int], bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A layer: latent attention, then the dense MLP (``bias`` None) or the
    shared and the held routed experts."""
    x = mla(x, p, m, levels)
    y = rms_norm(x, p["post_attention_layernorm"], m.eps)
    if bias is None:
        return x + linear(swiglu(linear(y, p["up"], levels)), p["down"], levels)
    shared = linear(swiglu(linear(y, p["shared_up"], levels)), p["shared_down"], levels)
    return x + shared + routed(y, p, m, levels, router_levels, bias)


def loss(params: Dict, ids: torch.Tensor, targets: torch.Tensor, m: Model,
         levels: Optional[int], router_levels: Optional[int] = None) -> torch.Tensor:
    """The mean next-token cross-entropy, each layer recomputed for its
    backward."""
    bias = correction_bias(m).to(ids.device)
    x = params["embedding"][ids]
    for i, p in enumerate(params["layers"]):
        layer_bias = None if i < m.own.first_dense else bias[i - m.own.first_dense]
        x = checkpoint(block, x, p, m, levels, router_levels, layer_bias, use_reentrant=False)
    logits = linear(rms_norm(x, params["final_norm"], m.eps), params["lm_head"], levels)
    return F.cross_entropy(logits.reshape(-1, m.vocab), targets.reshape(-1))


def mla_proj_shapes(m: Model) -> List[Tuple[str, int, int, int, int]]:
    """The latent path's products of one layer (``mla_proj`` span), as
    ``linear_shapes`` gives them."""
    o, h, heads = m.own, m.hidden, m.heads
    return [("q", 1, h, heads * m.head_dim, 1), ("kv_a", 1, h, o.kv_lora_rank + o.rope, 1),
            ("kv_b", 1, o.kv_lora_rank, heads * (o.nope + o.v_head), 1)]


def shared_expert_shapes(m: Model) -> List[Tuple[str, int, int, int, int]]:
    """The shared experts' products of one expert layer (``shared_expert``
    span)."""
    shared = m.own.shared * m.ffn
    return [("shared_up", 1, m.hidden, 2 * shared, 1), ("shared_down", 1, shared, m.hidden, 1)]


def linear_shapes(m: Model) -> List[Tuple[str, int, int, int, int]]:
    """Every layer's attention products (``out``: ``o_proj``), the dense
    layer's MLP, each expert layer's shared experts and the held experts'
    products over their share of the routed assignments (top-k x count /
    experts rows a token, ``count`` matrices read), and the LM head; the
    router's float32 product runs in the route's range, not among these."""
    o, h = m.own, m.hidden
    held = o.held[1]
    out = []
    for i in range(m.layers):
        out += mla_proj_shapes(m) + [("out", 1, m.heads * o.v_head, h, 1)]
        if i < o.first_dense:
            out += [("dense_up", 1, h, 2 * o.dense_ffn, 1), ("dense_down", 1, o.dense_ffn, h, 1)]
            continue
        share = o.topk * held / o.experts
        out += shared_expert_shapes(m)
        out += [("expert_up", share, h, 2 * m.ffn, held), ("expert_down", share, m.ffn, h, held)]
    out.append(("lm_head", 1, h, m.vocab, 1))
    return out


def attention_ops(m: Model, mbs: int, seq: int) -> float:
    """Causal attention's operations a step: the forward's two products
    (q k^T over the q head, p v over the v head) and the backward's four
    (dp over v, dv over v, dq and dk over q) on the causal half, b s^2
    heads (3 d_q + 3 d_v) a layer."""
    return float(mbs * seq * seq * m.heads * m.layers * (3 * m.head_dim + 3 * m.own.v_head))


def attention_elements(m: Model, tokens: int) -> int:
    """The elements attention reads and writes a step: q, k (d_q wide), v,
    o (d_v wide) and their gradients once each."""
    dq, dv = m.heads * m.head_dim, m.heads * m.own.v_head
    # forward: q, k, v read, o written; backward: q, k, v, o, do read and
    # dq, dk, dv written
    elems = (2 * dq + 2 * dv) + (2 * dq + 3 * dv) + (2 * dq + dv)
    return elems * tokens * m.layers


def param_count(m: Model) -> int:
    return sum(math.prod(shape) for _path, shape, _scale in leaf_specs(m))


def touched_params(m: Model) -> Dict[str, int]:
    """A token's linear parameters: every layer's attention, the dense
    MLP, the shared experts, the held experts at a token's share of them
    (top-k x count / experts), the LM head; ``other``: the norms' weights
    and the router's float32 product."""
    o, h = m.own, m.hidden
    moe_layers = m.layers - o.first_dense
    attn = sum(k * n for _name, _per, k, n, _w in mla_proj_shapes(m)) + m.heads * o.v_head * h
    shared = sum(k * n for _name, _per, k, n, _w in shared_expert_shapes(m))
    routed_ = o.topk * o.held[1] * 3 * h * m.ffn / o.experts
    linear_ = m.layers * attn + o.first_dense * 3 * h * o.dense_ffn
    linear_ += moe_layers * (shared + routed_) + h * m.vocab
    other = m.layers * (2 * h + o.kv_lora_rank) + h + moe_layers * h * o.experts
    return {"linear": linear_, "other": other}


def route_ideal_s(m: Model, tokens: int) -> float:
    """Ideal seconds a step of the ``route`` span: the router's three
    float32 products (forward, dgrad, wgrad) at the CUDA cores' peak, and
    the route and index kernels' bytes at HBM's rate: the forward reads the
    logits and the bias and writes topw, topi and the scores; the backward
    reads d_topw, the scores and topi and writes d_logits; the index reads
    the keys and writes order, inv and the held experts' ids (float32
    values, int64 indices)."""
    o = m.own
    e, k = o.experts, o.topk
    ops = 3 * 2.0 * tokens * m.hidden * e
    fwd = 4 * (tokens * e + e) + tokens * k * (4 + 8) + 4 * tokens * e
    bwd = tokens * k * 4 + 4 * tokens * e + 8 * tokens * k + 4 * tokens * e
    index = 8 * tokens * k * 4
    moe_layers = m.layers - o.first_dense
    return moe_layers * (ops / FP32_OPS + (fwd + bwd + index) / work.HBM_BYTES_PER_S)

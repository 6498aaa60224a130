"""Single-device latent-attention MoE model: DeepSeek-V3's block as
Moonlight-16B-A3B publishes it, on one chip's share of its expert layers.

The layer equations are those of DeepSeek-V3's modelling code
(``modeling_deepseek.py``, ``q_lora_rank`` None, no rope scaling):

* **Latent attention (MLA).** ``q = q_proj(y)``, H heads of ``nope + rope``
  (128 + 64); ``kv_a_proj_with_mqa(y)`` gives the ``kv_lora_rank`` latent c
  (512) and one rotary key of ``rope`` shared by every head;
  ``kv_b_proj(rms_norm(c, kv_a_layernorm))`` gives each head's 128-wide
  unrotated key and its ``v_head_dim`` value (128). Split-half RoPE on the
  64 rotary columns of q and of the shared key (a loader of published
  weights would permute those columns of ``q_proj`` and
  ``kv_a_proj_with_mqa``: DeepSeek's code de-interleaves them first);
  causal attention over 192-wide q and k heads and 128-wide v heads at
  scale 1 / sqrt(192), on the CUDA flash kernels' (192, 128) pair (their
  plain versions on the CPU); ``o_proj``.
* **Expert layers** after the ``first_k_dense_replace`` dense layers (a
  SwiGLU MLP of ``intermediate_size``): the router's logits in float32
  (its weight cast up), scored by a sigmoid; the top ``num_experts_per_tok``
  by score + the per-expert correction bias (``noaux_tc``, one group: the
  group step is the identity), weighted by their unbiased scores normalised
  to sum 1 (``+ 1e-20``) and scaled by ``routed_scaling_factor`` (the route
  kernels' sigmoid mode, ``kernels.moe_route``); ``n_shared_experts``
  shared experts as one SwiGLU MLP of ``n_shared_experts *
  moe_intermediate_size``, which every token takes; the block's output
  ``x + attn``, then ``+ shared(y) + routed(y)``.
* **One chip's share.** The layer holds experts ``experts_held`` = (first,
  count) of ``n_routed_experts``, as one chip of ``n_routed_experts /
  count``-way expert parallelism does: the route covers every expert, the
  capacity is the uncut layer's ``int(cf * T * k / n_routed_experts)``, and
  only the assignments to the held experts are dispatched and combined
  (``kernels.moe_index(..., held=...)``); what the other experts would add
  is left out and nothing stands in for the other chips.

The correction bias is a buffer, not a parameter: DeepSeek-V3 moves it by a
sign step outside the gradient. Here it is fixed, made from
``correction_bias_seed`` (``correction_bias_std`` times a standard normal
a layer and expert, on the CPU generator), and receives no gradient. The
rms norms take the kernels' eps, 1e-5 (Moonlight's ``rms_norm_eps``).
Every kernel is the port's (``torchref/kernels.py``): the norms, RoPE,
flash attention, SwiGLU's step mode, the route, index, dispatch and
combine, and Adam (``make_fused_adam``); the products are cuBLAS's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from simumax_tpu_torch.torchref.kernels import (
    attention,
    moe_combine,
    moe_index,
    moe_permute,
    moe_route,
    rope,
    swiglu_step,
)
from simumax_tpu_torch.torchref.model import (
    _norm,
    _norm_residual,
    make_fused_adam,
    op_family,
    param_leaves,
    resolve_device,
)
from simumax_tpu_torch.torchref.spans import span


@dataclasses.dataclass(frozen=True)
class MlaMoeConfig:
    """Sizes by their published names (DeepSeek-V3's ``config.json``
    keys); the defaults are Moonlight-16B-A3B's with every expert held."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_attention_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    #: (first, count): the routed experts this layer holds
    experts_held: Tuple[int, int] = (0, 64)
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    capacity_factor: float = 2.0
    correction_bias_std: float = 0.0
    correction_bias_seed: int = 0
    dtype: Any = torch.bfloat16
    #: the flash kernels are the only attention: math attention's float32
    #: scores take 4.3 GB a layer at Moonlight's 8192 context
    use_flash_attn: bool = True

    def __post_init__(self):
        if not self.use_flash_attn:
            raise ValueError("MlaMoeConfig: latent attention runs on the flash kernels only "
                             "(use_flash_attn=True)")

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


def correction_bias(cfg: MlaMoeConfig) -> torch.Tensor:
    """The expert layers' correction biases, float32 [moe_layers,
    n_routed_experts] on the CPU: ``correction_bias_std`` times a standard
    normal from a CPU generator seeded with ``correction_bias_seed``."""
    gen = torch.Generator().manual_seed(cfg.correction_bias_seed)
    shape = (cfg.moe_layers, cfg.n_routed_experts)
    return torch.randn(shape, generator=gen, dtype=torch.float32) * cfg.correction_bias_std


def layer_shapes(cfg: MlaMoeConfig, dense: bool) -> Dict[str, Tuple[int, ...]]:
    """Each weight of a layer by name: its attention's, and a dense
    layer's MLP or an expert layer's router, held experts and shared
    experts."""
    h, heads, r = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank
    shapes = {
        "input_layernorm": (h,),
        "q_proj": (h, heads * cfg.q_head_dim),
        "kv_a_proj_with_mqa": (h, r + cfg.qk_rope_head_dim),
        "kv_a_layernorm": (r,),
        "kv_b_proj": (r, heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "o_proj": (heads * cfg.v_head_dim, h),
        "post_attention_layernorm": (h,),
    }
    if dense:
        shapes["up"] = (h, 2 * cfg.intermediate_size)
        shapes["down"] = (cfg.intermediate_size, h)
    else:
        held, f = cfg.experts_held[1], cfg.moe_intermediate_size
        shared = cfg.n_shared_experts * f
        shapes.update({"router": (h, cfg.n_routed_experts), "experts_up": (held, h, 2 * f),
                       "experts_down": (held, f, h), "shared_up": (h, 2 * shared),
                       "shared_down": (shared, h)})
    return shapes


def init_params(cfg: MlaMoeConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    every weight at scale 0.02, the norms' weights ones."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(shape):
        if len(shape) == 1:
            return torch.ones(shape, device=dev, dtype=cfg.dtype)
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * 0.02
        return x.to(cfg.dtype)

    h, v = cfg.hidden_size, cfg.vocab_size
    params = {"embedding": make((v, h)), "final_norm": make((h,)), "lm_head": make((h, v)),
              "layers": [{name: make(shape) for name, shape in
                          layer_shapes(cfg, i < cfg.first_k_dense_replace).items()}
                         for i in range(cfg.num_hidden_layers)]}
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def _capacity(cfg: MlaMoeConfig, tokens: int) -> int:
    """The uncut layer's capacity of an expert."""
    return int(cfg.capacity_factor * tokens * cfg.num_experts_per_tok / cfg.n_routed_experts)


def _attention(x, p, cfg: MlaMoeConfig):
    """(the residual stream, the attention's output projection) of x."""
    heads, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    r = cfg.kv_lora_rank
    res, y = _norm_residual(x, p["input_layernorm"])
    b, s, _ = y.shape
    with op_family("gemm"), span("mla_proj"):
        q = (y @ p["q_proj"]).view(b, s, heads, dn + dr)
        ckv = y @ p["kv_a_proj_with_mqa"]
    latent = _norm(ckv[..., :r].contiguous(), p["kv_a_layernorm"])
    with op_family("gemm"), span("mla_proj"):
        kv = (latent @ p["kv_b_proj"]).view(b, s, heads, dn + dv)
    # the rotary columns, rotated where they lie; one rotary key for all heads
    q_pe = rope(q[..., dn:], cfg.rope_theta)
    k_pe = rope(ckv[..., r:].unsqueeze(2), cfg.rope_theta)
    q = torch.cat([q[..., :dn], q_pe], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, s, heads, dr)], -1)
    v = kv[..., dn:]
    with op_family("attention"):
        o = attention(q, k, v, causal=True, use_flash=True)
    with op_family("gemm"):
        return res, o.reshape(b, s, heads * dv) @ p["o_proj"]


def _shared(y, p):
    with op_family("gemm"), span("shared_expert"):
        up = y @ p["shared_up"]
    act = swiglu_step(up)
    with op_family("gemm"), span("shared_expert"):
        return act @ p["shared_down"]


def _routed(y, p, cfg: MlaMoeConfig, bias):
    """The held experts' part of the routed MLP: the sigmoid route over
    every expert, the held experts' assignments dispatched into [count,
    cap, h], the experts as one batched matmul a projection, the weighted
    combine."""
    b, s, h = y.shape
    T, k, e = b * s, cfg.num_experts_per_tok, cfg.n_routed_experts
    y2 = y.reshape(T, h)
    with op_family("moe_dispatch"), span("route"):
        logits = y2.float() @ p["router"].float()
        topw, topi = moe_route(logits, k, bias, cfg.routed_scaling_factor)
        idx = moe_index(topi.reshape(T * k), e, _capacity(cfg, T), k, cfg.experts_held)
    w = topw.reshape(T * k).to(y.dtype)
    with op_family("moe_dispatch"):
        xin = moe_permute(y2, None, idx)
    with op_family("gemm"), span("expert_gemm"):
        up = torch.bmm(xin, p["experts_up"])
    act = swiglu_step(up)
    with op_family("gemm"), span("expert_gemm"):
        down = torch.bmm(act, p["experts_down"])
    with op_family("moe_dispatch"):
        return moe_combine(down, w, idx).reshape(b, s, h)


def _block(x, p, cfg: MlaMoeConfig, bias):
    res, a = _attention(x, p, cfg)
    # the residual add, written by the post-attention norm's kernel
    res, y = _norm_residual(res, p["post_attention_layernorm"], a)
    if bias is None:  # a dense layer
        with op_family("gemm"):
            up = y @ p["up"]
        act = swiglu_step(up)
        with op_family("gemm"):
            return res + act @ p["down"]
    return res + _shared(y, p) + _routed(y, p, cfg, bias)


def forward(params, ids, cfg: MlaMoeConfig, bias: torch.Tensor):
    """ids [b, s] int64 -> logits [b, s, vocab] in ``cfg.dtype``; ``bias``
    the expert layers' correction biases [moe_layers, n_routed_experts]
    float32 on the ids' device."""
    x = params["embedding"][ids]
    for i, p in enumerate(params["layers"]):
        dense = i < cfg.first_k_dense_replace
        x = _block(x, p, cfg, None if dense else bias[i - cfg.first_k_dense_replace])
    y = _norm(x, params["final_norm"])
    with op_family("gemm"):
        return y @ params["lm_head"]


def loss_fn(params, batch, cfg: MlaMoeConfig, bias: torch.Tensor):
    ids, targets = batch
    logits = forward(params, ids, cfg, bias)
    with op_family("cross_entropy"):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, targets[..., None].long()).mean()


def make_train_step(cfg: MlaMoeConfig, lr: float = 1e-4):
    """(init_opt, train_step): the dense reference's fused functional
    Adam (``torchref.model.make_fused_adam``) on this model's loss; the
    correction biases are copied to the batch's device once and kept."""
    biases: Dict[torch.device, torch.Tensor] = {}

    def loss(params, batch):
        dev = batch[0].device
        if dev not in biases:
            biases[dev] = correction_bias(cfg).to(dev)
        return loss_fn(params, batch, cfg, biases[dev])

    return make_fused_adam(loss, lr)

"""The plain reference: the cells' training step written again in plain PyTorch.

It follows the program's first steps from the same weights (made again
from the seed by :mod:`portbench.weights`) on the same batches, in float32
with TF32 off, and gives what the comparison reads: each step's loss, each
leaf's first gradient norm and each leaf's change after the steps. It
imports nothing of the program and takes nothing the program made.

What it computes: the kind's loss (``portbench/kinds/<kind>.py``), built
from the pieces here:

* the embedding lookup; RMS norms ``x * rsqrt(mean(x^2) + eps) * w``;
  split-half RoPE by ``pos * theta^(-2i/d)``; causal softmax attention
  scaled by ``1 / sqrt(d)``, kv head ``n // (heads / kv_heads)`` read by
  query head n; ``silu(gate) * val`` over ``[gate | val]``;
* the LM head and the mean next-token cross-entropy;
* Adam as the configuration states it: float32 moments, bias-corrected,
  the update computed in float32 and the parameter rounded to bfloat16
  after every step (the served type keeps no float32 master copy).

``levels`` selects the linear layers' arithmetic (every product but an MoE
router's): None for float32, 127 for the int8 rule (per-tensor
symmetric, scale ``(amax + 1e-6) / 127``, rounded half to even and
clipped; every product quantizes both operands in the forward, the dgrad
and the wgrad), 7 for the same rule at int4. ``router_levels`` selects
a router's product alike, for the kinds that have one.

Each block is recomputed for its backward (``torch.utils.checkpoint``),
so the reference fits on the card beside nothing but itself.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.manifest import load_kind
from portbench.weights import Model, Path, change_norms, get_path, leaf_stream, set_path

#: query heads of one attention chunk (the chunks bound the scores' memory)
HEAD_CHUNK = 8


def quantize(t: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization of a 2-D float32 tensor: (the
    integer values as float32, the scale)."""
    scale = (t.abs().max() + 1e-6) / levels
    return torch.clamp(torch.round(t / scale), -levels, levels), scale


class QuantMatmul(torch.autograd.Function):
    """x [n, k] @ w [k, m] with both operands quantized in every product of
    the forward and the backward; the integer products summed in float32."""

    @staticmethod
    def forward(ctx, x, w, levels):
        ctx.save_for_backward(x, w)
        ctx.levels = levels
        qx, sx = quantize(x, levels)
        qw, sw = quantize(w, levels)
        return (qx @ qw) * (sx * sw)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        qg, sg = quantize(g, ctx.levels)
        qw, sw = quantize(w, ctx.levels)
        qx, sx = quantize(x, ctx.levels)
        return (qg @ qw.t()) * (sg * sw), (qx.t() @ qg) * (sx * sg), None


def linear(x: torch.Tensor, w: torch.Tensor, levels: Optional[int]) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = x2 @ w if levels is None else QuantMatmul.apply(x2, w, levels)
    return y.reshape(*lead, w.shape[-1])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation of x [b, s, n, d]; the angles in float64."""
    s, d = x.shape[1], x.shape[3]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs[None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention: q [b, s, n, d], k [b, s, kv, d] and v [b, s, kv,
    dv] -> [b, s, n dv]."""
    b, s, n, d = q.shape
    group = n // k.shape[2]
    k = k.repeat_interleave(group, dim=2).transpose(1, 2)
    v = v.repeat_interleave(group, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    outs = []
    for c in range(0, n, HEAD_CHUNK):
        scores = (q[:, c:c + HEAD_CHUNK] @ k[:, c:c + HEAD_CHUNK].transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
        outs.append(probs @ v[:, c:c + HEAD_CHUNK])
    return torch.cat(outs, 1).transpose(1, 2).reshape(b, s, n * v.shape[-1])


def swiglu(up: torch.Tensor) -> torch.Tensor:
    f = up.shape[-1] // 2
    return F.silu(up[..., :f]) * up[..., f:]


def self_attention(x: torch.Tensor, p: Dict, m: Model, levels: Optional[int]) -> torch.Tensor:
    """The residual stream after a block's attention: ``x`` plus the out
    projection of causal GQA attention over the RoPE'd q and k of
    ``qkv(rms_norm(x))``."""
    b, s, _ = x.shape
    d, n, kv = m.head_dim, m.heads, m.kv_heads
    y = rms_norm(x, p["input_norm"], m.eps)
    q, kk, v = torch.split(linear(y, p["qkv"], levels), [n * d, kv * d, kv * d], dim=-1)
    q = rope(q.reshape(b, s, n, d), m.rope_theta)
    kk = rope(kk.reshape(b, s, kv, d), m.rope_theta)
    return x + linear(attention(q, kk, v.reshape(b, s, kv, d)), p["out"], levels)


def decoder_loss(params: Dict, ids: torch.Tensor, targets: torch.Tensor, m: Model,
                 levels: Optional[int], block: Callable, *block_args) -> torch.Tensor:
    """The mean next-token cross-entropy of a decoder: the embedding, each
    layer's ``block(x, p, m, levels, *block_args)`` recomputed for its
    backward, the final norm and the LM head."""
    x = params["embedding"][ids]
    for p in params["layers"]:
        x = checkpoint(block, x, p, m, levels, *block_args, use_reentrant=False)
    logits = linear(rms_norm(x, params["final_norm"], m.eps), params["lm_head"], levels)
    return F.cross_entropy(logits.reshape(-1, m.vocab), targets.reshape(-1))


@torch.no_grad()
def adam(leaves: List[torch.Tensor], grads: Sequence[torch.Tensor], mu: List[torch.Tensor],
         nu: List[torch.Tensor], step: int, opt: Dict) -> None:
    """One Adam step in place; each parameter rounded to bfloat16."""
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    for p, g, mm, vv in zip(leaves, grads, mu, nu):
        mm.mul_(b1).add_(g, alpha=1.0 - b1)
        vv.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (mm / bc1).mul_(lr).div_((vv / bc2).sqrt_().add_(eps))
        p.copy_((p - upd).to(torch.bfloat16))


def follow(m: Model, opt: Dict, seed: int, batches, steps: int = 3,
           levels: Optional[int] = None, device="cuda",
           router_levels: Optional[int] = None) -> Dict:
    """The reference's own run of ``steps`` training steps from the
    seed's weights on ``batches`` [(ids, targets)]: {"loss": [each
    step's loss], "grad1": {path: norm of the first step's gradient},
    "change": {path: norm of the change after the steps}}."""
    loss_fn = load_kind(m.kind).loss
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params: Dict = {}
        order: List[Path] = []
        for path, t in leaf_stream(m, seed, device):
            set_path(params, path, t.float().requires_grad_(True))
            order.append(path)
        leaves = [get_path(params, path) for path in order]
        mu = [torch.zeros_like(p) for p in leaves]
        nu = [torch.zeros_like(p) for p in leaves]
        losses, grad1 = [], {}
        for i in range(steps):
            ids, targets = batches[i]
            loss = loss_fn(params, ids, targets, m, levels, router_levels)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            if i == 0:
                grad1 = {path: float(torch.linalg.vector_norm(g))
                         for path, g in zip(order, grads)}
            adam(leaves, grads, mu, nu, i + 1, opt)
            del grads, loss
        del mu, nu
        change = change_norms(m, seed, params, device)
        return {"loss": losses, "grad1": grad1, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

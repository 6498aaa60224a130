"""The plain reference: the cells' training step written again in plain PyTorch.

It follows the program's first steps from the same weights (made again
from the seed by :mod:`portbench.weights`) on the same batches, in float32
with TF32 off, and gives what the comparison reads: each step's loss, each
leaf's first gradient norm and each leaf's change after the steps. It
imports nothing of the program and takes nothing the program made.

What it computes, for both models:

* the embedding lookup; RMS norms ``x * rsqrt(mean(x^2) + eps) * w``;
  split-half RoPE by ``pos * theta^(-2i/d)``; causal softmax attention
  scaled by ``1 / sqrt(d)``, kv head ``n // (heads / kv_heads)`` read by
  query head n;
* the dense MLP ``down(silu(gate) * val)`` with ``[gate | val] = up(y)``;
  the MoE MLP: gate logits, a float32 softmax, the top-k experts,
  weights renormalised as ``v / (sum v + 1e-9)``, each expert's
  assignments in token-major order kept up to ``int(cf * T * k / e)``
  and the rest dropped, each kept assignment through its expert's
  SwiGLU MLP and added to its token weighted;
* the LM head and the mean next-token cross-entropy;
* Adam as the configuration states it: float32 moments, bias-corrected,
  the update computed in float32 and the parameter rounded to bfloat16
  after every step (the served type keeps no float32 master copy).

``levels`` selects the linear layers' arithmetic (every product but the
MoE router's): None for float32, 127 for the int8 rule (per-tensor
symmetric, scale ``(amax + 1e-6) / 127``, rounded half to even and
clipped; every product quantizes both operands in the forward, the dgrad
and the wgrad), 7 for the same rule at int4. ``router_levels`` selects
the MoE router's product alike: float32 in the reference itself, the int8
rule in the MoE cell's control, which computes every product of the step
one precision below the configuration's bf16.

Each block is recomputed for its backward (``torch.utils.checkpoint``),
so the reference fits on the card beside nothing but itself.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.weights import Model, Path, change_norms, get_path, leaf_stream, set_path

#: query heads of one attention chunk (the chunks bound the scores' memory)
HEAD_CHUNK = 8
#: the MoE route's renormalisation term
RENORM_EPS = 1e-9


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
    """Causal attention: q [b, s, n, d], k and v [b, s, kv, d] -> [b, s, n d]."""
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
    return torch.cat(outs, 1).transpose(1, 2).reshape(b, s, n * d)


def swiglu(up: torch.Tensor) -> torch.Tensor:
    f = up.shape[-1] // 2
    return F.silu(up[..., :f]) * up[..., f:]


def moe_mlp(y: torch.Tensor, p: Dict, m: Model, levels: Optional[int],
            router_levels: Optional[int]) -> torch.Tensor:
    b, s, h = y.shape
    T, k, e = b * s, m.topk, m.experts
    y2 = y.reshape(T, h)
    probs = torch.softmax(linear(y2, p["gate"], router_levels), dim=-1)
    topv, topi = probs.topk(k, dim=-1)
    w = (topv / (topv.sum(-1, keepdim=True) + RENORM_EPS)).reshape(T * k)
    expert = topi.reshape(T * k)  # assignment a = token * k + j
    onehot = F.one_hot(expert, e)
    rank = (onehot.cumsum(0) * onehot).sum(-1) - 1  # its place in its expert's run
    keep = rank < int(m.capacity_factor * T * k / e)
    out = torch.zeros_like(y2)
    for x in range(e):
        a = torch.nonzero((expert == x) & keep).squeeze(1)
        tok = a // k
        down = linear(swiglu(linear(y2[tok], p["moe_up"][x], levels)), p["moe_down"][x], levels)
        out = out.index_add(0, tok, down * w[a, None])
    return out.reshape(b, s, h)


def block(x: torch.Tensor, p: Dict, m: Model, levels: Optional[int],
          router_levels: Optional[int]) -> torch.Tensor:
    b, s, _ = x.shape
    d, n, kv = m.head_dim, m.heads, m.kv_heads
    y = rms_norm(x, p["input_norm"], m.eps)
    q, kk, v = torch.split(linear(y, p["qkv"], levels), [n * d, kv * d, kv * d], dim=-1)
    q = rope(q.reshape(b, s, n, d), m.rope_theta)
    kk = rope(kk.reshape(b, s, kv, d), m.rope_theta)
    x = x + linear(attention(q, kk, v.reshape(b, s, kv, d)), p["out"], levels)
    y = rms_norm(x, p["pre_mlp_norm"], m.eps)
    if m.kind == "moe":
        return x + moe_mlp(y, p, m, levels, router_levels)
    return x + linear(swiglu(linear(y, p["up"], levels)), p["down"], levels)


def loss_fn(params: Dict, ids: torch.Tensor, targets: torch.Tensor, m: Model,
            levels: Optional[int], router_levels: Optional[int] = None) -> torch.Tensor:
    x = params["embedding"][ids]
    for p in params["layers"]:
        x = checkpoint(block, x, p, m, levels, router_levels, use_reentrant=False)
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

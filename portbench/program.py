"""The system under test: the port's training step, built from a cell.

The harness reaches the port through its step factories and config
classes alone: ``torchref.model.make_train_step(LlamaConfig(...))`` for a
dense configuration and ``torchref.moe_model.make_train_step(MoeConfig(...))``
for an MoE one. Each returns ``(init_opt, train_step)``; ``train_step(params,
opt_state, (ids, targets))`` runs the forward, the backward and the Adam
update in place and returns ``(params, opt_state, loss)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from portbench.weights import Model


def build(m: Model, cell: Dict, opt: Dict) -> Tuple[Callable, Callable]:
    """(init_opt, train_step) of the port for model ``m`` under ``cell``
    (its ``linear``: bf16 or int8; its ``attention``: flash or math)."""
    if cell["linear"] not in ("bf16", "int8") or cell["attention"] not in ("flash", "math"):
        raise ValueError(f"cell: unknown linear {cell['linear']!r} or attention "
                         f"{cell['attention']!r}")
    if m.kind == "dense":
        from simumax_tpu_torch.torchref.model import LlamaConfig, make_train_step

        cfg = LlamaConfig(
            vocab_size=m.vocab, hidden_size=m.hidden, head_num=m.heads, kv_head_num=m.kv_heads,
            head_size=m.head_dim, intermediate_size=m.ffn, layer_num=m.layers,
            rope_theta=m.rope_theta, dtype=torch.bfloat16,
            use_flash_attn=cell["attention"] == "flash", use_int8=cell["linear"] == "int8")
        return make_train_step(cfg, lr=opt["lr"])
    if cell["attention"] != "math" or cell["linear"] != "bf16":
        raise ValueError("the MoE step runs bf16 linear layers and math attention only")
    from simumax_tpu_torch.torchref.moe_model import MoeConfig, make_train_step

    cfg = MoeConfig(
        vocab_size=m.vocab, hidden_size=m.hidden, head_num=m.heads, kv_head_num=m.kv_heads,
        head_size=m.head_dim, layer_num=m.layers, expert_num=m.experts, topk=m.topk,
        moe_ffn=m.ffn, capacity_factor=m.capacity_factor, rope_theta=m.rope_theta,
        dtype=torch.bfloat16)
    return make_train_step(cfg, lr=opt["lr"])

"""The reference models of the bench rows and their training steps.

Shared by the self-calibration loop (``bench``), the memory validation
(``calibration.validate``) and ``chip_smoke.py``: the row's model config
(``bench-llama-0p5b`` or ``bench_moe_0p4b``) and a call that takes one
fwd+bwd+Adam step of its reference model on the card.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from simumax_tpu_torch.core.config import ModelConfig, get_model_config
from simumax_tpu_torch.torchref import model as dense_model
from simumax_tpu_torch.torchref import moe_model
from simumax_tpu_torch.torchref.model import resolve_device


def build_bench_model() -> ModelConfig:
    mc = get_model_config("bench-llama-0p5b")
    mc.maybe_pad_vocab_size(1)
    return mc


def build_moe_model() -> ModelConfig:
    """``bench_moe_0p4b``, as ``tools/accuracy_table.py:36-55`` builds it."""
    mc = ModelConfig(
        model_name="bench_moe_0p4b",
        model_type="moe",
        hidden_size=1024,
        head_num=8,
        kv_head_num=8,
        head_size=128,
        intermediate_size=1792,
        moe_ffn_hidden_size=1792,
        expert_num=8,
        topk=2,
        dense_layers=0,
        layer_num=4,
        vocab_size=32000,
        use_swiglu=True,
    )
    mc.maybe_pad_vocab_size(1)
    return mc


def build_model(kind: str) -> ModelConfig:
    return build_moe_model() if kind == "moe" else build_bench_model()


def make_row_step(kind: str, mc, seq_len: int, batch_size: int, layers: int,
                  remat: bool = False, seed: int = 0, device="cuda") -> Callable:
    """A row's training step on ``device``: a call that takes one
    fwd+bwd+Adam step of the row's reference model (random weights and
    token ids from ``seed``) and returns its loss. The token ids and
    targets are static device tensors, the parameters, moments and step
    count are updated in place, and the loss is written into the same
    float32 scalar tensor at every call, so nothing moves between calls
    through Python and a CUDA graph can capture the call."""
    dev = resolve_device(device)
    if kind == "moe":
        cfg = moe_model.MoeConfig.from_model_config(mc, layer_num=layers)
        params = moe_model.init_params(cfg, seed=seed, device=dev)
        init_opt, train_step = moe_model.make_train_step(cfg)
    else:
        cfg = dense_model.LlamaConfig.from_model_config(
            mc, layer_num=layers, use_flash_attn=kind == "flash", use_int8=kind == "int8")
        params = dense_model.init_params(cfg, seed=seed, device=dev)
        init_opt, train_step = dense_model.make_train_step(cfg, remat=remat)
    opt_state = init_opt(params)
    rs = np.random.RandomState(seed)
    ids = torch.tensor(rs.randint(0, cfg.vocab_size, (batch_size, seq_len)),
                       dtype=torch.long, device=dev)
    loss_out = torch.zeros((), dtype=torch.float32, device=dev)

    def step():
        _params, _opt, loss = train_step(params, opt_state, (ids, ids))
        return loss_out.copy_(loss)

    return step

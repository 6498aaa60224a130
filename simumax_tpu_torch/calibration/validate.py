"""Memory validation: the predicted peak against one measured step.

Port of the part of the JAX package's ``calibration/validate.py`` that
one card can check, :func:`validate_memory`. The reference compares the
analytical peak with XLA's compiled buffer assignment
(``memory_analysis().peak_memory_in_bytes``); the port runs one step of
the matching reference model (``torchref.rows.make_row_step``: the Llama with
math or flash attention, int8 linear layers or full-block recompute, or
the MoE model) on the card and reads the caching allocator's peak,
``torch.cuda.max_memory_allocated``, over that step. The step is run
eagerly, where the bench loop times replays of a captured CUDA graph: a
graph keeps its intermediates in a private memory pool sized at capture,
which is not the eager allocator's peak. The HLO helpers of
the reference (collective bytes, replica groups) wait for a multi-card
path (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import torch

from simumax_tpu_torch.torchref.model import resolve_device
from simumax_tpu_torch.torchref.rows import make_row_step


def reference_kind(perf) -> str:
    """The reference model that runs ``perf``'s single-card step, as a
    bench row kind (``torchref.rows``): "moe", "int8", "flash" or "dense"."""
    st = perf.strategy
    if st.world_size != 1:
        raise ValueError(f"memory validation compares one card, not world size "
                         f"{st.world_size}")
    if st.enable_recompute and st.recompute_granularity != "full_block":
        raise ValueError(f"the reference models recompute full blocks only, not "
                         f"{st.recompute_granularity!r}")
    if perf.model_config.model_type == "moe":
        return "moe"
    if st.fp8:
        return "int8"
    return "flash" if st.sdp_backend == "cuda" else "dense"


def validate_memory(perf, device="cuda") -> Dict[str, float]:
    """Compare ``perf``'s predicted peak (a single-card strategy, after
    ``run_estimate``) with one step of the matching reference model on
    the card, from random weights. Returns the JAX function's keys where
    they have a meaning: ``argument_size_in_bytes`` (params, Adam
    moments and token ids before the step), ``temp_size_in_bytes`` (the
    peak above them), ``peak_memory_in_bytes`` (the step's
    ``max_memory_allocated``, counted from the allocator's state before
    the model was built), ``predicted_peak_bytes`` and ``ratio``
    (predicted / measured). The update is in place, so there is no
    separate output size."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"memory validation measures on the CUDA card, not on {dev}")
    kind = reference_kind(perf)
    st, mc = perf.strategy, perf.model_config
    torch.cuda.synchronize(dev)
    floor = torch.cuda.memory_allocated(dev)
    step = make_row_step(kind, mc, st.seq_len, st.micro_batch_size, mc.layer_num,
                         st.enable_recompute, device=dev)
    torch.cuda.synchronize(dev)
    args = torch.cuda.memory_allocated(dev) - floor
    torch.cuda.reset_peak_memory_stats(dev)
    loss = step()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - floor
    if not torch.isfinite(loss):
        raise RuntimeError(f"memory validation step gave a non-finite loss ({float(loss)})")
    del step, loss
    torch.cuda.empty_cache()
    predicted = perf.analysis_mem()["max_peak_bytes"]
    return {
        "argument_size_in_bytes": float(args),
        "temp_size_in_bytes": float(peak - args),
        "peak_memory_in_bytes": float(peak),
        "predicted_peak_bytes": predicted,
        "ratio": predicted / peak,
    }

"""Self-calibration loop on one CUDA card: prediction accuracy of the
analytical simulator against a measured PyTorch Llama training step.

Port of the JAX package's ``bench.py`` (the loop at its lines 67-219),
widened to two rows of ``tools/accuracy_table.py``. For each row:

1. measure a real fwd+bwd+Adam step of the reference Llama
   (``torchref/model.py``) on the card, by CUDA events;
2. predict the same step with ``PerfLLM`` on the card's system config;
3. calibrate exactly the GEMM, attention and Adam-update keys the
   estimate missed, on the same card;
4. predict again and report the error against the measured step.

Rows: "llama-0.5B bf16" (eager math attention, ``sdp_backend="torch"``)
and "llama-0.5B flash" (the CUDA flash kernels, ``sdp_backend="cuda"``),
both at the full width and depth of ``configs/models/bench-llama-0p5b``
(6 layers, seq 2048, micro-batch 1).

The measured peak memory is ``torch.cuda.max_memory_allocated``: the
bytes of live tensors at their peak, as the caching allocator counts
them (not the allocator's reserved pool).

Run: ``python -m simumax_tpu_torch.bench``. It needs a CUDA card and
raises without one.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from simumax_tpu_torch.calibration import calibrate_for_perf
from simumax_tpu_torch.calibration.timing import time_stateful
from simumax_tpu_torch.core.config import (
    StrategyConfig,
    get_model_config,
    list_configs,
)
from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.perf import PerfLLM
from simumax_tpu_torch.torchref.kernels import launch_counts
from simumax_tpu_torch.torchref.model import (
    LlamaConfig,
    init_params,
    make_train_step,
    resolve_device,
)

#: (row label, flash attention through the CUDA kernels)
ROWS: List[Tuple[str, bool]] = [
    ("llama-0.5B bf16", False),
    ("llama-0.5B flash", True),
]

#: the bench's sequence length, as in the JAX package's bench
SEQ_LEN = 2048

#: card-name fragment -> system config; the first match wins
_SYSTEMS = [("H100 PCIe", "h100_pcie"), ("H100 NVL", "h100_nvl"), ("H100", "h100_sxm")]


def detect_system(device="cuda") -> Tuple[str, str]:
    """(system config name, card name) of the card. Raises on a card
    with no system config: there is no silent default."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev)
    known = list_configs()["system"]
    for fragment, name in _SYSTEMS:
        if fragment in kind:
            if name not in known:
                raise ConfigError(
                    f"card {kind!r} maps to system config {name!r}, which "
                    f"does not exist; add its datasheet JSON under "
                    f"simumax_tpu_torch/configs/system/"
                )
            return name, kind
    raise ConfigError(f"no system config for card {kind!r} (known: {_SYSTEMS})")


def build_bench_model():
    mc = get_model_config("bench-llama-0p5b")
    mc.maybe_pad_vocab_size(1)
    return mc


def measure_step(mc, batch_size: int = 1, seq_len: int = SEQ_LEN, iters: int = 8,
                 warmup: int = 2, use_flash: bool = False, seed: int = 0,
                 device="cuda") -> Tuple[float, Dict]:
    """Seconds per training step on the card, and stats: the peak of
    ``torch.cuda.max_memory_allocated``, the steps run, the launches of
    each CUDA kernel during them, and the first and last loss."""
    dev = resolve_device(device)
    cfg = LlamaConfig.from_model_config(mc, use_flash_attn=use_flash)
    params = init_params(cfg, seed=seed, device=dev)
    init_opt, train_step = make_train_step(cfg)
    state = [params, init_opt(params)]
    rs = np.random.RandomState(seed)
    ids = torch.tensor(rs.randint(0, cfg.vocab_size, (batch_size, seq_len)),
                       dtype=torch.long, device=dev)
    batch = (ids, ids)
    losses = []

    def run():
        p, o, loss = train_step(state[0], state[1], batch)
        state[0], state[1] = p, o
        losses.append(loss)
        return loss

    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t = time_stateful(run, warmup=warmup, iters=iters)
    after = launch_counts()
    stats = {
        "measured_peak_bytes": torch.cuda.max_memory_allocated(dev),
        "steps": warmup + iters,
        "launches": {k: after[k] - before[k] for k in after},
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
    }
    del state, params
    torch.cuda.empty_cache()
    return t, stats


def predict_step(mc, system_name: str, batch_size: int = 1,
                 seq_len: int = SEQ_LEN, flash: bool = False) -> PerfLLM:
    st = StrategyConfig(
        world_size=1, tp_size=1, pp_size=1, seq_len=seq_len,
        micro_batch_size=batch_size, micro_batch_num=1, zero_state=0,
        # eager math attention materializes the fp32 scores/probs; the
        # CUDA flash kernels keep them on chip
        use_flash_sdp=flash, use_math_sdp=not flash,
        sdp_backend="cuda" if flash else "torch",
        # autograd of bf16 params yields bf16 grads (cast to fp32 only
        # inside the Adam update): no fp32 main grads
        use_fp32_accum_grad=False,
        optimizer_style="functional",
    )
    st.__post_init__()
    perf = PerfLLM().configure(st, mc, system_name)
    perf.run_estimate()
    return perf


def run_row(label: str, flash: bool, max_keys: int = 24, device="cuda") -> Dict:
    system_name, kind = detect_system(device)
    mc = build_bench_model()
    measured_s, stats = measure_step(mc, use_flash=flash, device=device)
    perf = predict_step(mc, system_name, flash=flash)
    pred_uncal = perf.analysis_cost()["iter_time"]
    calibrated = calibrate_for_perf(perf, max_keys=max_keys, device=device)
    perf.run_estimate()  # resets the cached cost/mem results
    cost = perf.analysis_cost()
    pred_cal = cost["iter_time"]
    mem = perf.analysis_mem()
    return {
        "label": label,
        "device_kind": kind,
        "system_config": system_name,
        "layers": mc.layer_num,
        "seq": SEQ_LEN,
        "measured_ms": measured_s * 1e3,
        "predicted_uncalibrated_ms": pred_uncal * 1e3,
        "predicted_ms": pred_cal * 1e3,
        "error_pct": abs(pred_cal - measured_s) / measured_s * 100.0,
        "uncalibrated_error_pct": abs(pred_uncal - measured_s) / measured_s * 100.0,
        "predicted_breakdown_ms": {
            k: v * 1e3 for k, v in cost["time_breakdown"].items()
        },
        "calibrated_keys": sum(len(v) for v in calibrated.values()),
        "calibrated": calibrated,
        "measured_peak_gib": stats["measured_peak_bytes"] / 2**30,
        "predicted_peak_gib": mem["max_peak_gib"],
        "steps": stats["steps"],
        "launches": stats["launches"],
        "loss_first": stats["loss_first"],
        "loss_last": stats["loss_last"],
    }


def main(device="cuda") -> List[Dict]:
    results = []
    for label, flash in ROWS:
        row = run_row(label, flash, device=device)
        results.append(row)
        print(
            f"{label}: measured {row['measured_ms']:.3f} ms, uncalibrated "
            f"{row['predicted_uncalibrated_ms']:.3f} ms "
            f"({row['uncalibrated_error_pct']:.2f}%), calibrated "
            f"{row['predicted_ms']:.3f} ms ({row['error_pct']:.2f}%), "
            f"{row['calibrated_keys']} keys calibrated; peak "
            f"{row['measured_peak_gib']:.3f} GiB measured vs "
            f"{row['predicted_peak_gib']:.3f} GiB predicted "
            f"[{row['device_kind']}, {row['system_config']}]",
            flush=True,
        )
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()

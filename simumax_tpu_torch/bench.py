"""Self-calibration loop on one CUDA card: prediction accuracy of the
analytical simulator against measured PyTorch training steps.

Port of the JAX package's ``bench.py`` (the loop at its lines 67-219),
widened to the seven rows of ``tools/accuracy_table.py``. For each row:

1. measure a real fwd+bwd+Adam step of the row's reference model on the
   card, by CUDA events: the Llama of ``torchref/model.py`` (eager math
   attention, the CUDA flash kernels, int8 linear layers, or full-block
   recompute) or the MoE model of ``torchref/moe_model.py``;
2. predict the same step with ``PerfLLM`` on the card's system config
   (:func:`detect_system`: ``h100_sxm_calibrated``, the tables measured
   on the card, where it exists);
3. calibrate exactly the GEMM, int8-GEMM, grouped-GEMM, attention and
   Adam-update keys the estimate missed, on the same card;
4. predict again and report the error against the measured step; where
   the detected config is the calibrated one, do 2-4 on the datasheet
   config (``h100_sxm``, efficiency priors) too.

Rows (:data:`ROWS`): the dense rows run ``configs/models/bench-llama-0p5b``
at its full width and depth (6 layers), the MoE row ``bench_moe_0p4b``
(:func:`build_moe_model`, 4 layers). "llama-0.5B flash" is the JAX
table's "flash(pallas)" row: the CUDA flash kernels
(``sdp_backend="cuda"``); every other row takes eager math attention
(``sdp_backend="torch"``).

The measured peak memory is ``torch.cuda.max_memory_allocated``: the
bytes of live tensors at their peak, as the caching allocator counts
them (not the allocator's reserved pool).

Run: ``python -m simumax_tpu_torch.bench``. It needs a CUDA card and
raises without one.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import torch

from simumax_tpu_torch.calibration import calibrate_for_perf
from simumax_tpu_torch.calibration.timing import time_stateful
from simumax_tpu_torch.core.config import StrategyConfig, list_configs
from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.perf import PerfLLM
from simumax_tpu_torch.torchref.kernels import launch_counts
from simumax_tpu_torch.torchref.model import resolve_device
from simumax_tpu_torch.torchref.rows import (  # noqa: F401  (build_*: public)
    build_bench_model,
    build_model,
    build_moe_model,
    make_row_step,
)

#: (label, kind, seq, mbs, layers, remat), as ``tools/accuracy_table.py``;
#: kind is "dense" (math attention), "flash" (the CUDA flash kernels),
#: "int8" (int8 linear layers) or "moe" (the MoE reference model)
ROWS: List[Tuple[str, str, int, int, int, bool]] = [
    ("llama-0.5B bf16", "dense", 2048, 1, 6, False),
    ("llama-0.5B seq4096", "dense", 4096, 1, 6, False),
    ("llama-0.5B remat", "dense", 2048, 1, 6, True),
    ("llama-0.5B mbs2", "dense", 1024, 2, 6, False),
    ("llama-0.5B flash", "flash", 2048, 1, 6, False),
    ("llama-0.5B int8", "int8", 2048, 1, 6, False),
    ("moe-8e-top2 bf16", "moe", 2048, 1, 4, False),
]

#: card-name fragment -> system config; the first match wins
_SYSTEMS = [("H100 PCIe", "h100_pcie"), ("H100 NVL", "h100_nvl"), ("H100", "h100_sxm")]


def base_system(device="cuda") -> Tuple[str, str]:
    """(datasheet system config name, card name) of the card. Raises on
    a card with no system config: there is no silent default."""
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


def detect_system(device="cuda") -> Tuple[str, str]:
    """(system config name, card name) of the card: the measured tables
    ``<base>_calibrated`` (written on the card by
    ``python -m simumax_tpu_torch.tools.build_system_config``) where they
    exist, else the datasheet config of :func:`base_system`."""
    base, kind = base_system(device)
    if f"{base}_calibrated" in list_configs()["system"]:
        return f"{base}_calibrated", kind
    return base, kind


def measure_step(mc, kind: str = "dense", seq_len: int = 2048, batch_size: int = 1,
                 layers: int = 0, remat: bool = False, iters: int = 8, warmup: int = 2,
                 seed: int = 0, device="cuda") -> Tuple[float, Dict]:
    """Seconds per training step of a row on the card, and stats: the
    peak of ``torch.cuda.max_memory_allocated``, the steps run, the
    launches of each CUDA kernel during them, and the first and last
    loss. ``layers`` 0 takes the model's own depth."""
    dev = resolve_device(device)
    step = make_row_step(kind, mc, seq_len, batch_size, layers or mc.layer_num, remat,
                         seed, dev)
    losses = []

    def run():
        losses.append(step())
        return losses[-1]

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
    del step
    torch.cuda.empty_cache()
    return t, stats


def row_strategy(kind: str = "dense", seq_len: int = 2048, batch_size: int = 1,
                 remat: bool = False) -> StrategyConfig:
    """A row's single-card strategy, set as ``tools/accuracy_table.py``'s
    ``predict`` sets it, with the attention backend mapped xla -> torch
    and pallas -> cuda."""
    flash = kind == "flash"
    st = StrategyConfig(
        world_size=1, tp_size=1, pp_size=1, seq_len=seq_len,
        micro_batch_size=batch_size, micro_batch_num=1, zero_state=0,
        # eager math attention materializes the fp32 scores/probs; the
        # CUDA flash kernels keep them on chip
        use_flash_sdp=flash, use_math_sdp=not flash,
        sdp_backend="cuda" if flash else "torch",
        fp8=kind == "int8", quant_dtype="int8",
        # autograd of bf16 params yields bf16 grads (cast to fp32 only
        # inside the Adam update): no fp32 main grads
        use_fp32_accum_grad=False,
        optimizer_style="functional",
        enable_recompute=remat, recompute_granularity="full_block",
        moe_capacity_factor=2.0,
    )
    st.__post_init__()
    return st


def predict_step(mc, system_name: str, kind: str = "dense", seq_len: int = 2048,
                 batch_size: int = 1, layers: int = 0, remat: bool = False) -> PerfLLM:
    """The row's step as ``PerfLLM`` predicts it (:func:`row_strategy`).
    ``layers`` 0 keeps the model's own depth; otherwise it is written
    into ``mc``, as the JAX table does."""
    if layers:
        mc.layer_num = layers
    perf = PerfLLM().configure(row_strategy(kind, seq_len, batch_size, remat), mc,
                               system_name)
    perf.run_estimate()
    return perf


def predict_with_loop(mc, system_name: str, kind: str, seq: int, mbs: int, layers: int,
                      remat: bool, measured_s: float, max_keys: int = 24,
                      device="cuda") -> Dict:
    """The row's prediction on ``system_name`` before and after the
    miss-driven loop calibrates the keys its estimate missed, and their
    errors against ``measured_s``; ``perf`` is the calibrated estimate."""
    perf = predict_step(mc, system_name, kind, seq, mbs, layers, remat)
    pred_uncal = perf.analysis_cost()["iter_time"]
    calibrated = calibrate_for_perf(perf, max_keys=max_keys, device=device)
    perf.run_estimate()  # resets the cached cost/mem results
    pred_cal = perf.analysis_cost()["iter_time"]
    return {
        "perf": perf,
        "system_config": system_name,
        "predicted_uncalibrated_ms": pred_uncal * 1e3,
        "predicted_ms": pred_cal * 1e3,
        "error_pct": abs(pred_cal - measured_s) / measured_s * 100.0,
        "uncalibrated_error_pct": abs(pred_uncal - measured_s) / measured_s * 100.0,
        "calibrated_keys": sum(len(v) for v in calibrated.values()),
        "calibrated": calibrated,
    }


def run_row(label: str, kind: str, seq: int, mbs: int, layers: int, remat: bool,
            max_keys: int = 24, device="cuda") -> Dict:
    """One row: the measured step, and its prediction with the loop on
    the detected system config (``row`` keys) and, where that is the
    calibrated config, on the datasheet config too (``base``)."""
    system_name, card = detect_system(device)
    base_name, _card = base_system(device)
    mc = build_model(kind)
    measured_s, stats = measure_step(mc, kind, seq, mbs, layers, remat, device=device)
    pred = predict_with_loop(mc, system_name, kind, seq, mbs, layers, remat, measured_s,
                             max_keys, device)
    perf = pred.pop("perf")
    cost = perf.analysis_cost()
    mem = perf.analysis_mem()
    row = {
        "label": label,
        "kind": kind,
        "device_kind": card,
        "layers": mc.layer_num,
        "seq": seq,
        "mbs": mbs,
        "remat": remat,
        "measured_ms": measured_s * 1e3,
        **pred,
        "predicted_breakdown_ms": {
            k: v * 1e3 for k, v in cost["time_breakdown"].items()
        },
        "measured_peak_gib": stats["measured_peak_bytes"] / 2**30,
        "predicted_peak_gib": mem["max_peak_gib"],
        "steps": stats["steps"],
        "launches": stats["launches"],
        "loss_first": stats["loss_first"],
        "loss_last": stats["loss_last"],
    }
    if base_name != system_name:
        base = predict_with_loop(mc, base_name, kind, seq, mbs, layers, remat, measured_s,
                                 max_keys, device)
        del base["perf"]
        row["base"] = base
    return row


def main(device="cuda") -> List[Dict]:
    results = []
    for spec in ROWS:
        label = spec[0]
        row = run_row(*spec, device=device)
        results.append(row)
        for pred in [row] + ([row["base"]] if "base" in row else []):
            print(
                f"{label} [{pred['system_config']}]: measured {row['measured_ms']:.3f} ms, "
                f"before the loop {pred['predicted_uncalibrated_ms']:.3f} ms "
                f"({pred['uncalibrated_error_pct']:.2f}%), after "
                f"{pred['predicted_ms']:.3f} ms ({pred['error_pct']:.2f}%), "
                f"{pred['calibrated_keys']} keys calibrated by the loop",
                flush=True,
            )
        print(
            f"{label}: peak {row['measured_peak_gib']:.3f} GiB measured vs "
            f"{row['predicted_peak_gib']:.3f} GiB predicted [{row['device_kind']}]",
            flush=True,
        )
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()

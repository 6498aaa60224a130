"""Peak-memory validation table: predicted against one measured step.

Port of the JAX package's ``tools/validate_memory_table.py``. For the
same single-card configs of ``bench-llama-0p5b`` (seq x layers x batch
x remat), compare ``PerfLLM.analysis_mem()`` with the peak of one step
of the port's reference Llama on the card
(``calibration.validate.validate_memory``: ``torch.cuda.max_memory_allocated``,
where the reference read XLA's compiled buffer assignment). The
prediction is the reference tool's: fp32 main gradients, math attention,
the functional optimizer, on the card's system config. Beside each
prediction stand the buckets of its peak-memory waterfall
(``PerfLLM.memory_ledger``: params, grads, optimizer states, activation
cache, recompute working set, workspace, comm buffers), and beside the
measured peak its split into what the step starts with (params, Adam
moments and token ids) and what it adds. The table reports the gap; it
changes nothing in the memory model.

Usage: ``python -m simumax_tpu_torch.tools.validate_memory_table``
(needs the card). Prints the table and writes it to
``build/memory_validation.md``.
"""

from __future__ import annotations

import os
from typing import Dict, List

from simumax_tpu_torch.bench import detect_system
from simumax_tpu_torch.calibration.validate import validate_memory
from simumax_tpu_torch.core.config import StrategyConfig, get_model_config
from simumax_tpu_torch.observe.memledger import MEM_WATERFALL_ORDER, build_memory_waterfall
from simumax_tpu_torch.perf import PerfLLM

CASES = [
    # (seq_len, layer_num, mbs, remat)
    (2048, 6, 1, False),
    (2048, 6, 1, True),
    (4096, 6, 1, False),
    (4096, 6, 1, True),
    (1024, 6, 2, False),
    (2048, 3, 1, False),
    (4096, 3, 2, False),
    (8192, 3, 1, True),
]
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "memory_validation.md")


def predict(seq: int, layers: int, mbs: int, remat: bool, system_name: str) -> PerfLLM:
    """The estimate of one case, set as the reference tool's ``predict``."""
    mc = get_model_config("bench-llama-0p5b")
    mc.layer_num = layers
    st = StrategyConfig(
        world_size=1, tp_size=1, pp_size=1, seq_len=seq,
        micro_batch_size=mbs, micro_batch_num=1, zero_state=0,
        use_flash_sdp=False, use_math_sdp=True,
        use_fp32_accum_grad=True,
        optimizer_style="functional",
        enable_recompute=remat, recompute_granularity="full_block",
    )
    st.__post_init__()
    p = PerfLLM().configure(st, mc, system_name)
    p.run_estimate()
    return p


def run(cases=CASES, device="cuda") -> List[Dict]:
    """One row per case: its measured and predicted peak and the gap."""
    system_name, kind = detect_system(device)
    rows = []
    for seq, layers, mbs, remat in cases:
        perf = predict(seq, layers, mbs, remat, system_name)
        rec = validate_memory(perf, device=device)
        meas, pred = rec["peak_memory_in_bytes"], rec["predicted_peak_bytes"]
        waterfall = build_memory_waterfall(perf)
        rows.append({
            "seq": seq, "layers": layers, "mbs": mbs, "remat": remat,
            "measured_gib": meas / 2**30, "predicted_gib": pred / 2**30,
            "argument_gib": rec["argument_size_in_bytes"] / 2**30,
            "error_pct": (pred - meas) / meas * 100.0,
            "waterfall_gib": {k: v / 2**30 for k, v in waterfall["buckets"].items()},
            "system_config": system_name, "device_kind": kind,
        })
        print(f"seq={seq} L={layers} mbs={mbs} remat={remat}: measured "
              f"{meas / 2**30:.3f} GiB (params, moments and ids "
              f"{rec['argument_size_in_bytes'] / 2**30:.3f}), predicted "
              f"{pred / 2**30:.3f} GiB ({rows[-1]['error_pct']:+.1f}%)", flush=True)
    return rows


def write_table(rows: List[Dict], path: str = OUT) -> str:
    worst = max(abs(r["error_pct"]) for r in rows)
    lines = [
        "# Peak-memory validation (one card, the reference Llama family)",
        "",
        f"Device: {rows[0]['device_kind']}; system config {rows[0]['system_config']}; "
        "measured: `torch.cuda.max_memory_allocated` over one step.",
        "",
        "Measured: the peak, what the step starts with (params, Adam moments, ids) and "
        "what it adds. Predicted: the peak and its waterfall buckets (GiB; buckets "
        "that are 0 in every row are left out).",
        "",
    ]
    buckets = [b for b in MEM_WATERFALL_ORDER
               if any(r["waterfall_gib"][b] for r in rows)]
    lines += [
        "| seq | layers | mbs | remat | measured GiB | start | added | predicted GiB | "
        + " | ".join(buckets) + " | err % |",
        "|" + "---|" * (9 + len(buckets)),
    ]
    for r in rows:
        lines.append(
            f"| {r['seq']} | {r['layers']} | {r['mbs']} | {r['remat']} "
            f"| {r['measured_gib']:.3f} | {r['argument_gib']:.3f} "
            f"| {r['measured_gib'] - r['argument_gib']:.3f} | {r['predicted_gib']:.3f} | "
            + " | ".join(f"{r['waterfall_gib'][b]:.3f}" for b in buckets)
            + f" | {r['error_pct']:+.1f} |"
        )
    lines += ["", f"Worst-case |error|: {worst:.1f}%", ""]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def main(device="cuda") -> List[Dict]:
    rows = run(device=device)
    print(f"wrote {write_table(rows)} (worst |err| "
          f"{max(abs(r['error_pct']) for r in rows):.1f}%)")
    return rows


if __name__ == "__main__":
    main()

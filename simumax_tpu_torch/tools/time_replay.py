"""The levelled replay kernel against another build of the one-warp
replay entry point, on the same calls.

The workload is ``chip_smoke.py``'s fault phase: the JAX package's worked
v5p-256 example (Llama3-8B, ``tp4_pp4_dp16_mbs1`` on ``tpu_v5p_256``), 8
seeded scenarios over 50 steps, analysed with ``replay_backend="cuda"``,
every family group of misses recorded. Then, for every recorded call and
at the largest family, the levelled kernel (``csrc/replay.cu``,
``kernels.replay_levels`` over the family's memoised tables) and the
baseline library's ``replay_solve`` (the one-warp-a-scenario entry point
over a :class:`~simumax_tpu_torch.simulator.batched_replay.ReplayBatch`:
``n_ops, k, words, g, c, w, e, batch``, then the batch's fifteen tensors,
the value scratch, the output and the stream) are timed in turns (new,
baseline, baseline, new; device ms between CUDA events, each the median
of 5 calls after a warm-up, each queued behind a spin kernel so that the
host's wrapper is not timed), and their makespans must be equal bit for
bit. Last, each family under one healthy scenario (no fault: the
plainest arithmetic an op has), the levelled kernel alone: its floor a
level.

Usage (needs the card; build the baseline first, for example the
parent commit's kernel)::

    git show <commit>:simumax_tpu_torch/csrc/replay.cu > build/replay_base.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o build/replay_base.so build/replay_base.cu
    python -m simumax_tpu_torch.tools.time_replay --baseline build/replay_base.so

Prints one JSON object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import time

import torch

from simumax_tpu_torch.simulator import batched_replay as br
from simumax_tpu_torch.simulator import faults as F
from simumax_tpu_torch.torchref import kernels as K

CONFIG = ("tp4_pp4_dp16_mbs1", "llama3-8b", "tpu_v5p_256")
ANALYSIS = dict(n_scenarios=8, seed=0, horizon_steps=50)
INTERVAL = 25
SPIN_CYCLES = 2 * 10 ** 6
_P, _I = ctypes.c_void_p, ctypes.c_int


def record_calls():
    """[(program, [fault model])] of every call the example's cuda
    analysis makes, and its wall seconds."""
    from simumax_tpu_torch import PerfLLM

    perf = PerfLLM().configure(*CONFIG)
    perf.run_estimate()
    calls = []
    orig = br.solve_batch

    def solve_batch(prog, models, device="cuda"):
        calls.append((prog, list(models)))
        return orig(prog, models, device=device)

    br.solve_batch = solve_batch
    try:
        t0 = time.perf_counter()
        perf.analyze_faults(spec=F.CheckpointSpec(interval_steps=INTERVAL),
                            options=F.ReplayOptions(replay_backend="cuda"), **ANALYSIS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        br.solve_batch = orig
    return calls, wall


def baseline(path: str):
    """The baseline library's ``replay_solve`` as a function of a
    :class:`ReplayBatch` on the card."""
    lib = ctypes.CDLL(path)
    fn = lib.replay_solve
    fn.argtypes = [_I] * 8 + [_P] * 18
    fn.restype = ctypes.c_int

    def solve(rb):
        tensors = [rb.kind, rb.rank, rb.dur, rb.aux, rb.mask, rb.refs, rb.win_s, rb.win_e,
                   rb.win_m, rb.edges, rb.has_slow, rb.link_s, rb.link_e, rb.link_m,
                   rb.app_bits]
        fits = (2 * rb.n_classes + rb.n_chains + rb.n_ops + 1) * 8 <= 232448
        scratch = None if fits else torch.empty((rb.batch, rb.n_ops + 1),
                                                dtype=torch.float64, device="cuda")
        out = torch.empty(rb.batch, dtype=torch.float64, device="cuda")
        rc = fn(rb.n_ops, rb.n_classes, rb.mask.shape[1], rb.refs.shape[1], rb.n_chains,
                rb.win_s.shape[2], rb.link_s.shape[1], rb.batch,
                *(t.data_ptr() for t in tensors),
                0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"baseline replay_solve returned cudaError {rc}")
        return out

    return solve


def device_ms(fn, reps: int = 5) -> float:
    """Median device ms of ``fn`` between two CUDA events, each sample
    queued behind a spin kernel (about 1 ms), so the events time the
    kernel and not the host's wrapper, after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="shared library with replay_solve")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_replay: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    old = baseline(args.baseline)
    K.build()  # the kernels and the card's context are set-up, not the analysis
    torch.zeros(1, device="cuda")
    calls, wall = record_calls()
    rows = []
    for prog, models in calls:
        tables = br.replay_tables(prog, "cuda")
        scen = br.pack_scenarios(tables, models, pin=True).to("cuda")
        rb = br.pack_batch(prog, models, "cuda")
        new_out, old_out = K.replay_levels(tables, scen), old(rb)
        if not torch.equal(new_out, old_out):
            raise AssertionError(f"L {prog.n_ops}, B {len(models)}: {new_out.tolist()} against "
                                 f"the baseline's {old_out.tolist()}")
        turns = [device_ms(lambda: K.replay_levels(tables, scen)), device_ms(lambda: old(rb)),
                 device_ms(lambda: old(rb)), device_ms(lambda: K.replay_levels(tables, scen))]
        rows.append({"n_ops": prog.n_ops, "n_classes": prog.n_classes, "batch": len(models),
                     "levels": tables.n_levels, "new_ms": (turns[0] + turns[3]) / 2,
                     "baseline_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns})
    big = max(rows, key=lambda r: (r["n_ops"], r["batch"]))
    # each family under one healthy scenario: no slowdown, no link window,
    # so an op is its plainest arithmetic and a level costs its floor
    healthy = {}
    for prog, _models in calls:
        if prog.n_ops in healthy:
            continue
        tables = br.replay_tables(prog, "cuda")
        scen = br.pack_scenarios(tables, [F.StepFaultModel(F.FaultScenario([]),
                                                           rank_map=prog.reps)],
                                 pin=True).to("cuda")
        ms = device_ms(lambda: K.replay_levels(tables, scen))
        healthy[prog.n_ops] = {"n_classes": prog.n_classes, "levels": tables.n_levels,
                               "ms": ms, "us_a_level": ms / tables.n_levels * 1e3}
    result = {
        "card": card.strip(), "config": list(CONFIG), "analysis_cuda_s": wall,
        "calls": len(rows),
        "new_ms_total": sum(r["new_ms"] for r in rows),
        "baseline_ms_total": sum(r["baseline_ms"] for r in rows),
        "largest": {**big, "speedup": big["baseline_ms"] / big["new_ms"],
                    "new_us_a_level": big["new_ms"] / big["levels"] * 1e3},
        "healthy_b1": healthy,
        "per_call": rows,
    }
    print(json.dumps({k: v for k, v in result.items() if k != "per_call"}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

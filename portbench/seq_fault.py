"""A partial-batch fault that bites where a batch holds one sequence.

``faults.half_batch`` leaves out half of a batch's rows, so at ``mbs`` 1
it keeps the whole batch and reads as a sound run. ``half_seq`` leaves out
half of each row's tokens instead: the step sees the first half of every
sequence (its ids and their targets), its loss the mean over those. It
wraps the program's ``train_step`` as the faults of ``faults.py`` do;
nothing in a benchmark run uses it.

    python3 portbench/seq_fault.py --workload <cell> --seeds 1,2,3

On the card at the cell's own size, as ``readings.py`` reads the others:
for each seed the reference follows the compared steps once, then the
program (sound) and the program under ``half_seq`` are compared with it.
Each comparison is one JSON line on standard output; the last line sums
them up: the largest sound reading of each number and the smallest
reading of the fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import compare, manifest, readings, reference, run, weights  # noqa: E402
from portbench.weights import Model  # noqa: E402


def half_seq(step: Callable) -> Callable:
    def faulty(params, opt_state, batch):
        ids, targets = batch
        half = max(1, ids.shape[1] // 2)
        return step(params, opt_state, (ids[:, :half].contiguous(),
                                        targets[:, :half].contiguous()))

    return faulty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for var, rel in run.CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, rel)
    if not torch.cuda.is_available():
        print("seq_fault: needs a CUDA card", file=sys.stderr)
        return 2
    spec = manifest.load(args.workload)
    cell, opt = spec.cell, spec.config["optimizer"]
    m = Model.from_config(spec.config)
    found = {"sound": [], "half_seq": []}
    for seed in [int(x) for x in args.seeds.split(",") if x]:
        batches = weights.make_batches(seed, int(cell["batches"]), int(cell["mbs"]),
                                       int(cell["seq"]), m.vocab, "cuda")[:run.COMPARED_STEPS]
        t = time.perf_counter()
        ref = reference.follow(m, opt, seed, batches, run.COMPARED_STEPS,
                               run.LEVELS[cell["linear"]], "cuda")
        readings._free("cuda")
        ref_s = time.perf_counter() - t
        for kind, wrap in (("sound", None), ("half_seq", half_seq)):
            side = readings.program_readings(m, cell, opt, seed, batches, "cuda", wrap)
            nums = compare.numbers(side, ref)
            found[kind].append(nums)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": {k: v["value"] for k, v in nums.items()},
                              "leaves": {k: v["leaf"] for k, v in nums.items()},
                              "loss": side["loss"], "ref_loss": ref["loss"],
                              "ref_s": round(ref_s, 3)}), flush=True)
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
               "power": run.card_readout()}
    for kind, rows in found.items():
        pick = max if kind == "sound" else min
        summary[kind] = {n: pick(r[n]["value"] for r in rows) for n in compare.NUMBERS}
        summary[kind]["seeds"] = len(rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

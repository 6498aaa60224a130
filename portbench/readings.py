"""The readings a cell's limits are set from, on the card at the cell's
own size: the program's sound runs, the control's and the planted faults',
each compared with the plain reference over the compared steps.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--unchanged-seeds 1,2,3]

One process runs them all (no timed window: training's readings need
none). For each seed the reference follows the compared steps once; then,
as the seed is listed, the program (sound), the cell's control (its
``control``: the program with another ``linear``, or the reference in the
program's place at ``levels``, its MoE router at ``router_levels``), the
program with half of each batch left out (``faults.half_batch``) and the
program whose step returns its state unchanged (``faults.unchanged``) are
compared with it. Each comparison is one JSON line on standard output;
the last line sums them up: the largest sound reading of each number and
the smallest reading of the control and of the fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import compare, faults, manifest, reference, run, weights  # noqa: E402
from portbench.weights import Model  # noqa: E402


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def program_readings(m, cell, opt, seed, batches, device, wrap_step=None):
    step, params, opt_state, readings = run.setup_program(m, cell, opt, seed, device, batches,
                                                          wrap_step)
    del step, params, opt_state
    _free(device)
    return readings


def control_readings(m, cell, opt, seed, batches, device):
    """The cell's control: the program with another ``linear``, or the
    reference in the program's place at the control's ``levels``."""
    control = cell["control"]
    if control["kind"] == "program":
        return program_readings(m, dict(cell, linear=control["linear"]), opt, seed, batches,
                                device)
    return reference.follow(m, opt, seed, batches, run.COMPARED_STEPS, control["levels"],
                            device, control.get("router_levels"))


#: what stands in the program's place, by kind of reading
KINDS = ("sound", "control", "half_batch", "unchanged")


def compare_seed(spec: manifest.Spec, seed: int, kinds, device="cuda") -> Dict[str, Dict]:
    """{kind: (:func:`compare.numbers`, the side's readings, the
    reference's readings, the reference's seconds)} for one seed, the
    reference followed once."""
    cell, opt = spec.cell, spec.config["optimizer"]
    m = Model.from_config(spec.config)
    # the run's own pool (its first batches are the compared steps')
    batches = weights.make_batches(seed, int(cell["batches"]), int(cell["mbs"]),
                                   int(cell["seq"]), m.vocab, device)[:run.COMPARED_STEPS]
    t = time.perf_counter()
    ref = reference.follow(m, opt, seed, batches, run.COMPARED_STEPS,
                           run.LEVELS[cell["linear"]], device)
    _free(device)
    ref_s = time.perf_counter() - t
    out = {}
    for kind in kinds:
        if kind == "sound":
            side = program_readings(m, cell, opt, seed, batches, device)
        elif kind == "control":
            side = control_readings(m, cell, opt, seed, batches, device)
        else:
            side = program_readings(m, cell, opt, seed, batches, device, faults.FAULTS[kind])
        out[kind] = (compare.numbers(side, ref), side, ref, ref_s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--unchanged-seeds", default="")
    ap.add_argument("--leaves-out", default="",
                    help="a file for every comparison's per-leaf norms, one JSON line each")
    args = ap.parse_args(argv)
    for var, rel in run.CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, rel)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    spec = manifest.load(args.workload)
    lists = {kind: [int(x) for x in text.split(",") if x]
             for kind, text in zip(KINDS, (args.seeds, args.control_seeds, args.fault_seeds,
                                           args.unchanged_seeds))}
    found = {kind: [] for kind in KINDS}
    if args.leaves_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.leaves_out)), exist_ok=True)
    for seed in sorted(set(x for xs in lists.values() for x in xs)):
        kinds = [kind for kind in KINDS if seed in lists[kind]]
        for kind, (nums, side, ref, ref_s) in compare_seed(spec, seed, kinds).items():
            found[kind].append(nums)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": {k: v["value"] for k, v in nums.items()},
                              "leaves": {k: v["leaf"] for k, v in nums.items()},
                              "loss": side["loss"], "ref_loss": ref["loss"],
                              "ref_s": round(ref_s, 3)}), flush=True)
            if args.leaves_out:
                with open(args.leaves_out, "a") as f:
                    f.write(json.dumps({"seed": seed, "kind": kind, **{
                        f"{side_name}_{what}": {".".join(map(str, k)): v
                                                for k, v in readings[what].items()}
                        for side_name, readings in (("side", side), ("ref", ref))
                        for what in ("grad1", "change")}}) + "\n")
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
               "power": run.card_readout()}
    for kind, rows in found.items():
        if rows:
            pick = max if kind == "sound" else min
            summary[kind] = {n: pick(r[n]["value"] for r in rows) for n in compare.NUMBERS}
            summary[kind]["seeds"] = len(rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

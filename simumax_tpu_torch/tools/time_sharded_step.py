"""The dp x tp step on DTensor at a 1 x 1 mesh against the single-device
step, for this tree and another commit's, in turns on one card.

Each tree's own code runs in a child process of its own (the tree's
package on ``PYTHONPATH``, its kernels built from its own sources into
its own ``build/kernels/``): the bf16 row's model (``bench-llama-0p5b``,
6 layers, seq 2048, mbs 1, weights from seed 0) in bf16 and with
``use_int8``, ``STEPS`` eager steps of the single-device step and of the
DTensor step on a 1 x 1 mesh (NCCL, SP, FSDP) from the same parameters:
each step between CUDA events, and the host's time to issue it (the
call's return, before the card finishes); the medians after the first
two steps, and the first three losses. A tree whose DTensor step refuses
``use_int8`` reports its message.

The trees run in turns: baseline, this tree, this tree, baseline.

Usage. Write the baseline's package where git is (the card's machine
has no repository), then run on the card::

    python -m simumax_tpu_torch.tools.time_sharded_step --extract 34e5fa7
    python -m simumax_tpu_torch.tools.time_sharded_step --baseline build/baseline/34e5fa7-tree

Without ``--baseline`` it runs this tree alone, twice. Prints one line a
turn and one JSON object, also written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from simumax_tpu_torch.tools.attribute_dispatch import ROOT, extract

#: eager steps of each step; the medians skip the first two
STEPS = 12
SEQ = 2048


def _time(torch, step):
    times, issue, losses = [], [], []
    for _ in range(STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        issue.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    return {"median_ms": sorted(times[2:])[(STEPS - 2) // 2],
            "issue_ms": sorted(issue[2:])[(STEPS - 2) // 2], "losses": losses[:3]}


def child() -> dict:
    """Both steps, bf16 and int8, with the package on ``sys.path``."""
    import numpy as np
    import torch

    from simumax_tpu_torch.torchref import model as M
    from simumax_tpu_torch.torchref import parallel as P
    from simumax_tpu_torch.torchref.rows import build_bench_model

    out = {"package": os.path.dirname(os.path.dirname(os.path.abspath(M.__file__)))}
    for variant in ("bf16", "int8"):
        cfg = M.LlamaConfig.from_model_config(build_bench_model(), layer_num=6,
                                              use_int8=variant == "int8")
        params0 = M.init_params(cfg, seed=0)
        ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, SEQ))
        params = M._map_tree(lambda t: t.detach().clone().requires_grad_(True), params0)
        init_opt, step = M.make_train_step(cfg)
        opt, batch = init_opt(params), (torch.tensor(ids, device="cuda"),) * 2
        out[f"{variant}_single"] = _time(torch, lambda: step(params, opt, batch)[2])
        del params, opt
        with P.process_group("cuda"):
            mesh = M.make_mesh(1, tp=1)
            try:
                placed = M.place_params(params0, mesh, M.param_shardings(cfg, mesh, fsdp=True))
                init_opt, sstep = M.make_train_step(cfg, mesh=mesh, sp=True)
                sopt, sbatch = init_opt(placed), M.shard_batch((ids, ids), mesh)
                out[f"{variant}_sharded"] = _time(torch, lambda: sstep(placed, sopt, sbatch)[2])
                del placed, sopt
            except ValueError as exc:
                out[f"{variant}_sharded"] = str(exc)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extract", metavar="COMMIT",
                    help="write COMMIT's package into build/baseline/COMMIT-tree and stop")
    ap.add_argument("--baseline", help="a tree holding the baseline's simumax_tpu_torch/")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.extract:
        print(extract(args.extract))
        return {}
    if args.child:
        print(json.dumps(child()), flush=True)
        return {}
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_sharded_step: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    here = ("this tree", ROOT)
    trees = [here, here] if not args.baseline else [
        ("baseline", args.baseline), here, here, ("baseline", args.baseline)]
    turns = []
    for i, (tree, root) in enumerate(trees):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                              cwd=os.path.abspath(root), env=env, check=True,
                              capture_output=True, text=True)
        rec = json.loads(done.stdout.strip().splitlines()[-1])
        rec.update(turn=i, tree=tree)
        turns.append(rec)
        parts = []
        for key in ("bf16_single", "bf16_sharded", "int8_single", "int8_sharded"):
            r = rec[key]
            parts.append(f"{key} {r['median_ms']:.3f} ms (issue {r['issue_ms']:.3f}; losses "
                         f"{[f'{x:.6f}' for x in r['losses']]})" if isinstance(r, dict)
                         else f"{key}: {r}")
        print(f"turn {i} [{tree}, {rec['package']}]: " + "; ".join(parts), flush=True)
    result = {"card": card.strip(), "turns": turns}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

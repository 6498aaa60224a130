"""The dp x tp step on DTensor at a 1 x 1 mesh against the single-device
step, or the manual pp+tp+sp+dp+ep step of ``chip_smoke.py``'s phase 10b,
for this tree and another commit's, in turns on one card.

Each tree's own code runs in a child process of its own (the tree's
package on ``PYTHONPATH``, its kernels built from its own sources into
its own ``build/kernels/``). Each step runs eagerly between CUDA events,
with the host's time to issue it (the call's return, before the card
finishes); each reports the medians after the first two steps, and the
first three losses.

``--step sharded`` (the default): the bf16 row's model
(``bench-llama-0p5b``, 6 layers, seq 2048, mbs 1, weights from seed 0) in
bf16 and with ``use_int8``, ``STEPS["sharded"]`` steps of the
single-device step and of the DTensor step on a 1 x 1 mesh (NCCL, SP,
FSDP) from the same parameters. A tree whose DTensor step refuses
``use_int8`` reports its message.

``--step manual``: the step at phase 10b's widths
(``chip_smoke.STEP_WIDTHS`` of this tool's tree: ``bench_moe_0p4b``'s
hidden 1024, 8 heads of 128, 8 experts top-2, ffn 1792, vocab 32000; 4
layers in one stage, one MoE layer in two; seq ``STEP_SEQ``, batch 1,
bf16, world 1, weights from seed 0), in the psum and the a2a dispatch,
``STEPS["manual"]`` steps each. Then one more step under
``torch.profiler``, its window opened and closed as ``tools/attribute_step``
opens them, with the tree's ``_rms`` inside a ``norm`` range (the norm of
a tree that runs it as an eager chain is then attributed as the kernels'
is). This process reads every trace with this tree's ``attribute_step``
(kernel -> launching host call -> op family; a backward kernel takes its
forward op's range), so both trees are read by the same rules: each
step's device events (kernels, copies and fills), the norm family's
device ms and launches, and the ms of all of them.

The trees run in turns: baseline, this tree, this tree, baseline.

Usage. Write the baseline's package where git is (the card's machine
has no repository), then run on the card::

    python -m simumax_tpu_torch.tools.time_sharded_step --extract 34e5fa7
    python -m simumax_tpu_torch.tools.time_sharded_step --baseline build/baseline/34e5fa7-tree
    python -m simumax_tpu_torch.tools.time_sharded_step --step manual \\
        --baseline build/baseline/35c6504-tree

Without ``--baseline`` it runs this tree alone, twice. Prints one line a
turn and one JSON object, also written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

from simumax_tpu_torch.tools.attribute_dispatch import ROOT, extract

#: eager steps of each step; the medians skip the first two (the manual
#: step is host-bound and spreads by milliseconds from step to step)
STEPS = {"sharded": 12, "manual": 22}
SEQ = 2048
DISPATCHES = ("psum", "a2a")
#: the records of a turn, by step
KEYS = {"sharded": ("bf16_single", "bf16_sharded", "int8_single", "int8_sharded"),
        "manual": DISPATCHES}
TRACE_DIR = os.path.join(ROOT, "build", "attribution")


def _time(torch, step, steps: int) -> dict:
    times, issue, losses = [], [], []
    for _ in range(steps):
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
    mid = (steps - 2) // 2
    return {"median_ms": sorted(times[2:])[mid], "issue_ms": sorted(issue[2:])[mid],
            "losses": losses[:3]}


def child_sharded() -> dict:
    """Both steps, bf16 and int8, with the package on ``sys.path``."""
    import numpy as np
    import torch

    from simumax_tpu_torch.torchref import model as M
    from simumax_tpu_torch.torchref import parallel as P
    from simumax_tpu_torch.torchref.rows import build_bench_model

    out = {"package": os.path.dirname(os.path.dirname(os.path.abspath(M.__file__)))}
    steps = STEPS["sharded"]
    for variant in ("bf16", "int8"):
        cfg = M.LlamaConfig.from_model_config(build_bench_model(), layer_num=6,
                                              use_int8=variant == "int8")
        params0 = M.init_params(cfg, seed=0)
        ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, SEQ))
        params = M._map_tree(lambda t: t.detach().clone().requires_grad_(True), params0)
        init_opt, step = M.make_train_step(cfg)
        opt, batch = init_opt(params), (torch.tensor(ids, device="cuda"),) * 2
        out[f"{variant}_single"] = _time(torch, lambda: step(params, opt, batch)[2], steps)
        del params, opt
        with P.process_group("cuda"):
            mesh = M.make_mesh(1, tp=1)
            try:
                placed = M.place_params(params0, mesh, M.param_shardings(cfg, mesh, fsdp=True))
                init_opt, sstep = M.make_train_step(cfg, mesh=mesh, sp=True)
                sopt, sbatch = init_opt(placed), M.shard_batch((ids, ids), mesh)
                out[f"{variant}_sharded"] = _time(
                    torch, lambda: sstep(placed, sopt, sbatch)[2], steps)
                del placed, sopt
            except ValueError as exc:
                out[f"{variant}_sharded"] = str(exc)
        torch.cuda.empty_cache()
    return out


def _own(name: str, *path: str):
    """The module at ``path`` under this tool's tree's root, loaded from its
    file, whatever package is on ``sys.path``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _chip_smoke():
    """``chip_smoke.py`` of this tool's tree (the baseline's package has
    none of its own), for phase 10b's widths."""
    return _own("chip_smoke", "chip_smoke.py")


def child_manual(tag: str) -> dict:
    """Both dispatches' steps, with the package on ``sys.path``; each
    profiled step's trace written under :data:`TRACE_DIR` as
    ``<tag>_<dispatch>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simumax_tpu_torch.tools import attribute_step as A
    from simumax_tpu_torch.torchref import kernels as K
    from simumax_tpu_torch.torchref import parallel as P

    cs = _chip_smoke()
    # this tree's spans (they import nothing of the port; a baseline may have none)
    spans = _own("simumax_tpu_torch_spans", "simumax_tpu_torch", "torchref", "spans.py")
    K.build()
    rms = P._rms

    def marked(*args, **kwargs):
        with spans.op_family("norm"):
            return rms(*args, **kwargs)

    P._rms = marked
    out = {"package": os.path.dirname(os.path.dirname(os.path.abspath(P.__file__)))}
    os.makedirs(TRACE_DIR, exist_ok=True)
    for dispatch in DISPATCHES:
        cfg = P.PPConfig(**cs.STEP_WIDTHS, dtype=torch.bfloat16, ep_dispatch=dispatch)
        with P.process_group("cuda"):
            mesh = P.make_pp_mesh(1, pp=1, tp=1, ep=1, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(0)
            params, specs = P.init_pp_params(cfg, mesh, gen)
            step = P.make_pp_train_step(cfg, mesh, lr=1e-3)(specs)
            ids = torch.randint(0, cfg.vocab_size, (1, cs.STEP_SEQ), generator=gen,
                                device="cuda")
            state = {"params": params}
            del params

            def one():
                state["params"], loss = step(state["params"], ids, ids)
                return loss

            out[dispatch] = _time(torch, one, STEPS["manual"])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                A.open_window()
                one()
                A.close_window()
            out[dispatch]["trace"] = os.path.join(TRACE_DIR, f"{tag}_{dispatch}.json")
            prof.export_chrome_trace(out[dispatch]["trace"])
            del state, step
            torch.cuda.empty_cache()
    return out


def read_trace(path: str) -> dict:
    """One profiled step's device events by this tree's rules: their
    number and ms, and the norm family's."""
    from simumax_tpu_torch.tools import attribute_step as A

    with open(path) as f:
        trace = json.load(f)
    events = A.after_mark(trace["traceEvents"] if isinstance(trace, dict) else trace)
    kernels, untied = A.eager_kernel_families(events)
    norm = [(name, ms) for name, ms, family in kernels if family == "norm"]
    return {"device_events": len(kernels), "device_ms": sum(ms for _n, ms, _f in kernels),
            "norm_ms": sum(ms for _n, ms in norm), "norm_launches": len(norm),
            "untied": untied}


def _describe(key: str, r) -> str:
    if not isinstance(r, dict):
        return f"{key}: {r}"
    traced = (f"; {r['device_events']} device events, {r['device_ms']:.3f} ms; norm family "
              f"{r['norm_launches']} launches, {r['norm_ms']:.4f} ms" if "trace" in r else "")
    return (f"{key} {r['median_ms']:.3f} ms (issue {r['issue_ms']:.3f}{traced}; losses "
            f"{[f'{x:.6f}' for x in r['losses']]})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", choices=sorted(STEPS), default="sharded",
                    help="the DTensor and single-device steps, or phase 10b's manual step")
    ap.add_argument("--extract", metavar="COMMIT",
                    help="write COMMIT's package into build/baseline/COMMIT-tree and stop")
    ap.add_argument("--baseline", help="a tree holding the baseline's simumax_tpu_torch/")
    ap.add_argument("--child", metavar="TAG", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.extract:
        print(extract(args.extract))
        return {}
    if args.child:
        rec = child_manual(args.child) if args.step == "manual" else child_sharded()
        print(json.dumps(rec), flush=True)
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
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--step", args.step,
                               "--child", f"turn{i}"], cwd=os.path.abspath(root), env=env,
                              check=True, capture_output=True, text=True)
        rec = json.loads(done.stdout.strip().splitlines()[-1])
        rec.update(turn=i, tree=tree)
        for key in KEYS[args.step]:
            if isinstance(rec[key], dict) and "trace" in rec[key]:
                rec[key].update(read_trace(rec[key]["trace"]))
        turns.append(rec)
        print(f"turn {i} [{tree}, {rec['package']}]: "
              + "; ".join(_describe(key, rec[key]) for key in KEYS[args.step]), flush=True)
    result = {"card": card.strip(), "step": args.step, "turns": turns}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

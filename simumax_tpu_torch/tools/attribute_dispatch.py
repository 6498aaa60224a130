"""The MoE row's dispatch family by kernel name, for this tree and another
commit's, in turns on one card.

The MoE row of ``bench.ROWS`` (``bench_moe_0p4b``, seq 2048, mbs 1, 4
layers, bf16) is run by each tree's own code in a child process of its
own (the tree's package on ``PYTHONPATH``, its kernels built from its own
sources into its own ``build/kernels/``): the graph step as the bench
loop measures it (:func:`calibration.timing.time_captured_step`, 2
warm-up steps and the mean of 8 replays), then one eager step and
:data:`attribute_step.REPLAY_WINDOWS` graph replays under
``torch.profiler``, each window opened with the marked lead of
``attribute_step.open_window``. The child writes its traces and the
step's time; this process attributes every trace with this tree's
``attribute_step`` (kernel -> launching host call -> op family; a replayed
kernel takes the family of the eager kernel at its position), so both
trees are read by the same rules. Each turn reports the graph step, the
replay's kernel ms by family and the ``MoE dispatch`` family's kernels by
name: their ms in the fullest replay and, where the replay's kernels do
not match the eager step's one for one (the positions apart are
reported), the eager step's own kernel ms, each kernel tied to its
launch, with its launches.

The trees run in turns: baseline, this tree, this tree, baseline (so a
drift of the card over the call shows as the spread of each side).

Usage. Write the baseline's package where git is (the card's machine
has no repository), then run on the card::

    python -m simumax_tpu_torch.tools.attribute_dispatch --extract efaba53
    python -m simumax_tpu_torch.tools.attribute_dispatch \\
        --baseline build/baseline/efaba53-tree --out build/attribution/dispatch.json

Without ``--baseline`` it runs this tree alone, twice. Prints a table and
one JSON object, also written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

#: the MoE row of ``bench.ROWS``: (kind, seq, mbs, layers, remat)
ROW = ("moe", 2048, 1, 4, False)
FAMILY = "MoE dispatch"
#: the dispatch family's kernels listed by name in each turn's table
TOP = 16
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def extract(commit: str) -> str:
    """Write ``commit``'s ``simumax_tpu_torch/`` into
    ``build/baseline/<commit>-tree`` (needs git and the repository);
    returns the directory."""
    out = os.path.join(ROOT, "build", "baseline", f"{commit}-tree")
    os.makedirs(out, exist_ok=True)
    archive = subprocess.run(["git", "archive", commit, "simumax_tpu_torch"], cwd=ROOT,
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", out], input=archive, check=True)
    return out


def capture(out_dir: str) -> None:
    """In a child process, with the tree under test first on the path:
    time the MoE row's graph step and write the profiled eager step's
    and replays' traces, and ``step.json``, into ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simumax_tpu_torch import bench
    from simumax_tpu_torch.calibration.timing import capture_step, time_captured_step
    from simumax_tpu_torch.tools import attribute_step as A
    from simumax_tpu_torch.torchref.rows import make_row_step

    kind, seq, mbs, layers, remat = ROW
    mc = bench.build_model(kind)
    os.makedirs(out_dir, exist_ok=True)
    step = make_row_step(kind, mc, seq, mbs, layers, remat)
    seconds, losses = time_captured_step(step)
    del step
    torch.cuda.empty_cache()
    step = make_row_step(kind, mc, seq, mbs, layers, remat)
    graph, _out, _warm, _captured = capture_step(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        A.open_window()
        step()
        A.close_window()
    prof.export_chrome_trace(os.path.join(out_dir, "eager.json"))
    graph.replay()
    torch.cuda.synchronize()
    for i in range(A.REPLAY_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            A.open_window()
            graph.replay()
            A.close_window()
        prof.export_chrome_trace(os.path.join(out_dir, f"replay{i}.json"))
    with open(os.path.join(out_dir, "step.json"), "w") as f:
        json.dump({"graph_step_ms": seconds * 1e3, "losses": losses.tolist(),
                   "package": os.path.dirname(bench.__file__)}, f)


def _events(path: str):
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def attribute(out_dir: str) -> dict:
    """One turn's record from the traces a child wrote, read with this
    tree's rules."""
    from simumax_tpu_torch.tools import attribute_step as A

    with open(os.path.join(out_dir, "step.json")) as f:
        rec = json.load(f)
    eager, untied = A.eager_kernel_families(A.after_mark(_events(
        os.path.join(out_dir, "eager.json"))))
    windows = [A.after_mark(_events(os.path.join(out_dir, f"replay{i}.json")))
               for i in range(A.REPLAY_WINDOWS)]
    replay = max(windows, key=lambda ev: len(A.device_events(ev)))
    kernels, matched = A.replay_kernels(eager, replay)
    launches, eager_ms = defaultdict(int), defaultdict(float)
    for name, ms, family in eager:
        if family == FAMILY:
            launches[name] += 1
            eager_ms[name] += ms
    names = [k["name"] for k in A.device_events(replay)]
    tail = [name for name, _ms, _f in eager[len(eager) - len(names):]]
    apart = [(i, a, b) for i, (a, b) in enumerate(zip(names, tail)) if a != b]
    rec.update(
        families_ms={f: sum(v.values(), 0.0) for f, v in kernels.items()},
        dispatch=sorted(({"kernel": name, "ms": ms, "launches": launches.get(name, 0)}
                         for name, ms in kernels[FAMILY].items()), key=lambda r: -r["ms"]),
        eager_dispatch=sorted(({"kernel": name, "ms": ms, "launches": launches[name]}
                               for name, ms in eager_ms.items()), key=lambda r: -r["ms"]),
        matched=matched, untied=untied, kernels=len(eager),
        replay_windows=[len(A.device_events(ev)) for ev in windows],
        positions_apart=len(apart),
        first_apart=[{"position": i, "replay": a[:160], "eager": b[:160]}
                     for i, a, b in apart[:4]])
    return rec


def run(trees, out_root: str) -> list:
    """The turns over ``trees`` (labels and roots), each in a child
    process; their records."""
    turns = []
    for i, (label, root) in enumerate(trees):
        out_dir = os.path.join(out_root, f"turn{i}_{label}")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--capture", out_dir],
                       cwd=os.path.abspath(root), env=env, check=True)
        rec = attribute(out_dir)
        rec.update(turn=i, tree=label)
        turns.append(rec)
        print(f"turn {i} [{label}, {rec['package']}]: graph step {rec['graph_step_ms']:.4f} ms; "
              f"{FAMILY} {rec['families_ms'][FAMILY]:.4f} ms of the replay's "
              f"{sum(rec['families_ms'].values()):.4f} ms of kernels ({rec['kernels']} kernels, "
              f"{'matched' if rec['matched'] else 'NOT matched'}, windows "
              f"{rec['replay_windows']})", flush=True)
        for r in rec["dispatch"][:TOP]:
            print(f"    {r['ms']:9.4f} ms {r['launches']:4d}x  {r['kernel'][:120]}", flush=True)
        eager_total = sum(r["ms"] for r in rec["eager_dispatch"])
        print(f"  the eager step's {FAMILY} kernels, {eager_total:.4f} ms (the replay's names "
              f"apart at {rec['positions_apart']} positions: {rec['first_apart'][:2]})",
              flush=True)
        for r in rec["eager_dispatch"][:TOP]:
            print(f"    {r['ms']:9.4f} ms {r['launches']:4d}x  {r['kernel'][:120]}", flush=True)
    return turns


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extract", metavar="COMMIT",
                    help="write COMMIT's package into build/baseline/COMMIT-tree and stop")
    ap.add_argument("--baseline", help="a tree holding the baseline's simumax_tpu_torch/")
    ap.add_argument("--capture", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.extract:
        print(extract(args.extract))
        return {}
    if args.capture:
        capture(args.capture)
        return {}
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attribute_dispatch: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    here = ("this tree", ROOT)
    trees = [here, here] if not args.baseline else [
        ("baseline", args.baseline), here, here, ("baseline", args.baseline)]
    turns = run(trees, os.path.join(ROOT, "build", "attribution", "dispatch"))
    result = {"card": card.strip(), "row": ROW, "turns": turns}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

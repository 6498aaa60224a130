"""Bench rows' op families by kernel name, for this tree and another
commit's, in turns on one card.

Each row of ``bench.ROWS`` asked for (``--rows``: labels, or ``all``; by
default the MoE row, ``bench_moe_0p4b``, seq 2048, mbs 1, 4 layers, bf16)
is run by each tree's own code in a child process of its own (the tree's
package on ``PYTHONPATH``, its kernels built from its own sources into
its own ``build/kernels/``): the graph step as the bench loop measures it
(:func:`calibration.timing.time_captured_step`, 2 warm-up steps and the
mean of 8 replays, and their losses), the peak of
``torch.cuda.max_memory_allocated`` over three eager steps of a fresh
copy, then one eager step and :data:`attribute_step.REPLAY_WINDOWS`
graph replays under ``torch.profiler``, each window opened with the
marked lead of ``attribute_step.open_window``. The child writes its
traces and the step's numbers; this process attributes every trace with
this tree's ``attribute_step`` (kernel -> launching host call -> op
family; a replayed kernel takes the family of the eager kernel at its
position), so both trees are read by the same rules. Each turn reports,
for each row, the graph step, the replay's kernel ms by family and its
kernel count, and the kernels of each family asked for (``--families``;
by default ``MoE dispatch``) by name: their ms in the fullest replay
and, where the replay's kernels do not match the eager step's one for
one (the positions apart are reported), the eager step's own kernel ms,
each kernel tied to its launch, with its launches.

The trees run in turns: baseline, this tree, this tree, baseline (so a
drift of the card over the call shows as the spread of each side).

Usage. Write the baseline's package where git is (the card's machine
has no repository), then run on the card::

    python -m simumax_tpu_torch.tools.attribute_dispatch --extract efaba53
    python -m simumax_tpu_torch.tools.attribute_dispatch \\
        --baseline build/baseline/efaba53-tree --out build/attribution/dispatch.json
    python -m simumax_tpu_torch.tools.attribute_dispatch --rows all \\
        --families elementwise,norm --baseline build/baseline/52bb278-tree

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

#: the row run when none is asked for
DEFAULT_ROW = "moe-8e-top2 bf16"
#: the family listed by name when none is asked for
DEFAULT_FAMILY = "MoE dispatch"
#: a family's kernels listed by name in each turn's table
TOP = 16
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def extract(commit: str) -> str:
    """Write ``commit``'s ``simumax_tpu_torch/`` and the repository's
    ``configs/`` (the model JSONs the dense rows read) into
    ``build/baseline/<commit>-tree`` (needs git and the repository);
    returns the directory."""
    out = os.path.join(ROOT, "build", "baseline", f"{commit}-tree")
    os.makedirs(out, exist_ok=True)
    archive = subprocess.run(["git", "archive", commit, "simumax_tpu_torch", "configs"],
                             cwd=ROOT, capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", out], input=archive, check=True)
    return out


def _slug(label: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in label)


def _rows(labels):
    """The ``bench.ROWS`` entries of ``labels`` (``["all"]``: every row)."""
    from simumax_tpu_torch import bench

    if labels == ["all"]:
        return list(bench.ROWS)
    by_label = {row[0]: row for row in bench.ROWS}
    unknown = [label for label in labels if label not in by_label]
    if unknown:
        raise SystemExit(f"attribute_dispatch: no bench row {unknown} (rows: {list(by_label)})")
    return [by_label[label] for label in labels]


def capture(out_dir: str, labels) -> None:
    """In a child process, with the tree under test first on the path: for
    each row, time its graph step, read its eager peak and write the
    profiled eager step's and replays' traces, and ``step.json``, into
    ``out_dir/<row>``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simumax_tpu_torch import bench
    from simumax_tpu_torch.calibration.timing import capture_step, time_captured_step
    from simumax_tpu_torch.tools import attribute_step as A
    from simumax_tpu_torch.torchref.rows import make_row_step

    for label, kind, seq, mbs, layers, remat in _rows(labels):
        row_dir = os.path.join(out_dir, _slug(label))
        os.makedirs(row_dir, exist_ok=True)
        mc = bench.build_model(kind)
        step = make_row_step(kind, mc, seq, mbs, layers, remat)
        seconds, losses = time_captured_step(step)
        del step
        torch.cuda.empty_cache()
        step = make_row_step(kind, mc, seq, mbs, layers, remat)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del step
        torch.cuda.empty_cache()
        step = make_row_step(kind, mc, seq, mbs, layers, remat)
        graph, _out, _warm, _captured = capture_step(step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            A.open_window()
            step()
            A.close_window()
        prof.export_chrome_trace(os.path.join(row_dir, "eager.json"))
        graph.replay()
        torch.cuda.synchronize()
        for i in range(A.REPLAY_WINDOWS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                A.open_window()
                graph.replay()
                A.close_window()
            prof.export_chrome_trace(os.path.join(row_dir, f"replay{i}.json"))
        with open(os.path.join(row_dir, "step.json"), "w") as f:
            json.dump({"row": label, "graph_step_ms": seconds * 1e3, "losses": losses.tolist(),
                       "eager_peak_bytes": peak, "package": os.path.dirname(bench.__file__)}, f)
        del graph, step
        torch.cuda.empty_cache()


def _events(path: str):
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def attribute(row_dir: str, families) -> dict:
    """One row's record of a turn from the traces a child wrote, read
    with this tree's rules."""
    from simumax_tpu_torch.tools import attribute_step as A

    with open(os.path.join(row_dir, "step.json")) as f:
        rec = json.load(f)
    eager, untied = A.eager_kernel_families(A.after_mark(_events(
        os.path.join(row_dir, "eager.json"))))
    windows = [A.after_mark(_events(os.path.join(row_dir, f"replay{i}.json")))
               for i in range(A.REPLAY_WINDOWS)]
    replay = max(windows, key=lambda ev: len(A.device_events(ev)))
    kernels, matched = A.replay_kernels(eager, replay)
    names = [k["name"] for k in A.device_events(replay)]
    tail = [name for name, _ms, _f in eager[len(eager) - len(names):]]
    apart = [(i, a, b) for i, (a, b) in enumerate(zip(names, tail)) if a != b]
    rec.update(
        families_ms={f: sum(v.values(), 0.0) for f, v in kernels.items()},
        matched=matched, untied=untied, kernels=len(eager), replay_kernels=len(names),
        replay_windows=[len(A.device_events(ev)) for ev in windows],
        positions_apart=len(apart),
        first_apart=[{"position": i, "replay": a[:160], "eager": b[:160]}
                     for i, a, b in apart[:4]],
        by_name={})
    for family in families:
        launches, eager_ms = defaultdict(int), defaultdict(float)
        for name, ms, fam in eager:
            if fam == family:
                launches[name] += 1
                eager_ms[name] += ms
        rec["by_name"][family] = {
            "replay": sorted(({"kernel": name, "ms": ms, "launches": launches.get(name, 0)}
                              for name, ms in kernels[family].items()), key=lambda r: -r["ms"]),
            "eager": sorted(({"kernel": name, "ms": ms, "launches": launches[name]}
                             for name, ms in eager_ms.items()), key=lambda r: -r["ms"])}
    return rec


def run(trees, labels, families, out_root: str) -> list:
    """The turns over ``trees`` (labels and roots), each in a child
    process; their records, one for each row of a turn."""
    turns = []
    for i, (tree, root) in enumerate(trees):
        out_dir = os.path.join(out_root, f"turn{i}_{_slug(tree)}")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--capture", out_dir,
                        "--rows", ",".join(labels)], cwd=os.path.abspath(root), env=env,
                       check=True)
        for label, *_spec in _rows(labels):
            rec = attribute(os.path.join(out_dir, _slug(label)), families)
            rec.update(turn=i, tree=tree)
            turns.append(rec)
            print(f"turn {i} [{tree}, {rec['package']}] {label}: graph step "
                  f"{rec['graph_step_ms']:.4f} ms; the replay's {rec['replay_kernels']} kernels "
                  f"{sum(rec['families_ms'].values()):.4f} ms ({rec['kernels']} eager, "
                  f"{'matched' if rec['matched'] else 'NOT matched'}, windows "
                  f"{rec['replay_windows']}); eager peak {rec['eager_peak_bytes'] / 2 ** 30:.4f} "
                  f"GiB; by family " + ", ".join(f"{f} {ms:.4f}"
                                                 for f, ms in rec["families_ms"].items()),
                  flush=True)
            for family, lists in rec["by_name"].items():
                total = sum(r["ms"] for r in lists["replay"])
                print(f"  {family}, {total:.4f} ms in the replay (names apart at "
                      f"{rec['positions_apart']} positions: {rec['first_apart'][:2]})",
                      flush=True)
                for r in lists["replay"][:TOP]:
                    print(f"    {r['ms']:9.4f} ms {r['launches']:4d}x  {r['kernel'][:120]}",
                          flush=True)
    return turns


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extract", metavar="COMMIT",
                    help="write COMMIT's package into build/baseline/COMMIT-tree and stop")
    ap.add_argument("--baseline", help="a tree holding the baseline's simumax_tpu_torch/")
    ap.add_argument("--rows", default=DEFAULT_ROW,
                    help="bench rows by label, comma-separated, or 'all'")
    ap.add_argument("--families", default=DEFAULT_FAMILY,
                    help="op families listed by kernel name, comma-separated")
    ap.add_argument("--capture", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    labels = args.rows.split(",")
    if args.extract:
        print(extract(args.extract))
        return {}
    if args.capture:
        capture(args.capture, labels)
        return {}
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attribute_dispatch: needs a CUDA card")
    families = args.families.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    here = ("this tree", ROOT)
    trees = [here, here] if not args.baseline else [
        ("baseline", args.baseline), here, here, ("baseline", args.baseline)]
    turns = run(trees, [spec[0] for spec in _rows(labels)], families,
                os.path.join(ROOT, "build", "attribution", "dispatch"))
    result = {"card": card.strip(), "rows": labels, "families": families, "turns": turns}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

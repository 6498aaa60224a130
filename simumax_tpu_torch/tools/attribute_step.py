"""Where a bench row's step goes, by op family: the analytical ledger's
prediction beside the card's kernels.

The predicted side is ``PerfLLM.ledger()``: its op spans summed by their
category into :data:`FAMILIES` (``gemm`` -> GEMM, ``attention``,
``norm``, ``loss`` -> cross-entropy, ``router`` and ``moe_dispatch`` ->
MoE dispatch, every other category -> elementwise), the functional
optimizer's time from ``analysis_cost`` and, for a recompute row, the
recompute time on a line of its own (the ledger does not split it by
family).

The measured side is ``torch.profiler`` on the card. The reference
models mark their op families with profiler ranges
(``torchref.model.op_family``); one eager step is profiled with its host
ops, and each kernel is given the family of the innermost range around
the host call that launched it. A backward kernel runs under autograd's
``evaluate_function`` of its node, outside any range: it takes the range
of the forward op that created the node, found by the node's sequence
number. What runs in no range is elementwise work. Then the step is
captured in a CUDA graph (``calibration.timing.capture_step``) and a few
replays are profiled, of which the one with the most device events is
kept (a profiler window can drop launches): a replay launches the eager
step's kernels in the same order, so each replayed kernel takes the
family of the eager kernel at its position (or, should the two lists differ, the families of the
eager kernels of its name, in their proportions). The graph replay's
kernel ms by family is what stands beside the prediction.

Run on the card: ``python -m simumax_tpu_torch.tools.attribute_step``
(each row of ``bench.ROWS`` on the detected system config, without the
loop's keys). ``chip_smoke.py`` runs :func:`profile_row` and
:func:`ledger_families` on the estimate the loop calibrated.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from simumax_tpu_torch.torchref.model import OP_FAMILIES

#: the families both sides are summed into
FAMILIES = ("GEMM", "attention", "norm", "elementwise", "cross-entropy", "optimizer",
            "MoE dispatch")
_RANGE_FAMILY = dict(zip(OP_FAMILIES, ("GEMM", "attention", "norm", "cross-entropy",
                                       "optimizer", "MoE dispatch")))
_LEDGER_FAMILY = {"gemm": "GEMM", "attention": "attention", "norm": "norm",
                  "loss": "cross-entropy", "router": "MoE dispatch",
                  "moe_dispatch": "MoE dispatch"}
#: the trace's device events: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_BACKWARD = "autograd::engine::evaluate_function: "
#: profiled graph replays of a row, of which the one with the most
#: device events is used
REPLAY_WINDOWS = 3
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "attribution")


def ledger_families(perf) -> Dict[str, float]:
    """Predicted ms of one step by family (:data:`FAMILIES`), plus
    ``recompute`` (not split by family). They sum to the iteration time
    of a single-card estimate."""
    cost = perf.analysis_cost()
    breakdown = cost["time_breakdown"]
    mbc = perf.strategy.micro_batch_num
    out = dict.fromkeys(FAMILIES, 0.0)
    for span in perf.ledger().op_spans:
        out[_LEDGER_FAMILY.get(span.category, "elementwise")] += span.time * mbc * 1e3
    out["optimizer"] += breakdown["optimizer"] * 1e3
    out["recompute"] = breakdown["recompute_per_microbatch"] * mbc * 1e3
    return out


def _is_forward_op(e) -> bool:
    """An op that records an autograd node (it has a sequence number) and
    is not part of a backward node."""
    name = e["name"]
    return (e.get("cat") == "cpu_op" and "Sequence number" in e.get("args", {})
            and not name.startswith("autograd::") and "Backward" not in name)


def _innermost(stack) -> tuple:
    """("range", name), ("backward", sequence number, forward thread id)
    or ("none",): the innermost family range or autograd node around the
    top of ``stack`` (host events, outermost first). A forward op inside
    a backward node (a block recomputed for its backward) belongs to its
    own range or to none, not to the node that asked for the recompute."""
    in_forward = False
    for e in reversed(stack):
        if e.get("cat") == "user_annotation" and e["name"] in _RANGE_FAMILY:
            return ("range", e["name"])
        if e["name"].startswith(_BACKWARD):
            if in_forward:
                return ("none",)
            args = e.get("args", {})
            return ("backward", args.get("Sequence number"), args.get("Fwd thread id"))
        in_forward = in_forward or _is_forward_op(e)
    return ("none",)


def host_families(events: List[dict], queries: List[Tuple[int, float]]) -> List[str]:
    """The family of each host call (tid, ts) of one profiler trace (its
    Chrome-trace events), for example a kernel launch. Host events nest on
    a thread, so one sweep over each thread's events in time order keeps
    the stack of open events; a call's family is that of the innermost
    range around it, or, under a backward node, that of the forward op
    with the node's sequence number."""
    by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"):
            by_tid[e["tid"]].append(e)
    wanted = defaultdict(set)
    for tid, ts in queries:
        wanted[tid].add(ts)
    found: Dict[Tuple[int, float], tuple] = {}
    forward: Dict[Tuple[int, int], str] = {}  # (tid, sequence number) -> range
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        items = [(e["ts"], 0, e) for e in evs] + [(ts, 1, None) for ts in wanted[tid]]
        items.sort(key=lambda it: (it[0], it[1]))
        stack: List[dict] = []
        for ts, is_query, e in items:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < ts:
                stack.pop()
            if is_query:
                found[(tid, ts)] = _innermost(stack)
                continue
            if _is_forward_op(e):
                where = _innermost(stack)
                forward.setdefault((tid, e["args"]["Sequence number"]),
                                   where[1] if where[0] == "range" else None)
            stack.append(e)
    # a backward node names its forward op by (sequence number, the
    # forward thread's profiler id); learn which trace thread each
    # profiler id is from the nodes whose number only one thread has
    tids_of = defaultdict(list)
    for t, seq in forward:
        tids_of[seq].append(t)
    votes = defaultdict(lambda: defaultdict(int))
    for kind, *rest in found.values():
        if kind == "backward" and len(tids_of[rest[0]]) == 1:
            votes[rest[1]][tids_of[rest[0]][0]] += 1
    thread_of = {fwd: max(v, key=v.get) for fwd, v in votes.items()}
    out = []
    for tid, ts in queries:
        kind, *rest = found[(tid, ts)]
        region = None
        if kind == "range":
            region = rest[0]
        elif kind == "backward":
            seq, fwd = rest
            key = (thread_of.get(fwd), seq)
            if key not in forward and len(tids_of[seq]) == 1:
                key = (tids_of[seq][0], seq)
            region = forward.get(key)
        out.append(_RANGE_FAMILY.get(region, "elementwise"))
    return out


def _by_name(name: str) -> str:
    """The family of one of the port's own kernels, from its name, for a
    launch the trace does not tie to a host call."""
    if "flash_" in name:
        return "attention"
    if "q8_" in name:
        return "GEMM"
    return "elementwise"


def device_events(events: List[dict]) -> List[dict]:
    """The trace's kernels, copies and fills in the order they ran."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                  key=lambda e: e["ts"])


def eager_kernel_families(events: List[dict]) -> Tuple[List[Tuple[str, float, str]], int]:
    """[(name, device ms, family)] of an eager step's device events in
    the order they ran, and how many of them the trace did not tie to
    the host call that launched them (those are named by
    :func:`_by_name`). A device event is tied to its launch through the
    CUDA runtime (or driver) call of the same correlation id."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = device_events(events)
    queries, untied = [], 0
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        queries.append((launch["tid"], launch["ts"]) if launch else None)
        untied += launch is None
    families = host_families(events, [q for q in queries if q is not None])
    it = iter(families)
    out = [(k["name"], k.get("dur", 0.0) / 1e3, next(it) if q else _by_name(k["name"]))
           for k, q in zip(kernels, queries)]
    return out, untied


def replay_families(eager: List[Tuple[str, float, str]], events: List[dict]
                    ) -> Tuple[Dict[str, float], bool]:
    """Device ms by family of a profiled graph replay, each replayed
    kernel taking the family of the eager kernel at its position (the
    replay's list may lack the first kernels of the eager step's, which
    a profiler window can miss: then it is matched to the end of it); and
    whether the replay's names were the eager step's, so matched. Where
    they differ otherwise, a kernel's ms is split over the families of
    the eager kernels of its name, in proportion to how many of them each
    family has."""
    replay = device_events(events)
    out = dict.fromkeys(FAMILIES, 0.0)
    names = [k["name"] for k in replay]
    tail = eager[len(eager) - len(replay):] if len(replay) <= len(eager) else []
    if names == [name for name, _ms, _f in tail]:
        for k, (_name, _ms, family) in zip(replay, tail):
            out[family] += k.get("dur", 0.0) / 1e3
        return out, True
    counts = defaultdict(lambda: defaultdict(int))
    for name, _ms, family in eager:
        counts[name][family] += 1
    for k in replay:
        shares = counts.get(k["name"]) or {_by_name(k["name"]): 1}
        total = sum(shares.values())
        for family, n in shares.items():
            out[family] += k.get("dur", 0.0) / 1e3 * n / total
    return out, False


def _trace(prof, name: str) -> List[dict]:
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def profile_row(kind: str, mc, seq: int, mbs: int, layers: int, remat: bool,
                label: str = "row", device="cuda") -> Dict:
    """One eager step and :data:`REPLAY_WINDOWS` graph replays of a row's
    step under ``torch.profiler`` on the card (the traces go to
    ``build/attribution/``). Returns the fullest replay's kernel ms by
    family (``graph_ms``), each replay window's device events
    (``replay_windows``), the eager
    step's (``eager_ms``), their kernel counts, whether the replay's
    kernels matched the eager step's one for one, and how many eager
    kernels the trace did not tie to a host call."""
    from torch.profiler import ProfilerActivity, profile

    from simumax_tpu_torch.calibration.timing import capture_step
    from simumax_tpu_torch.torchref.rows import make_row_step

    def prime():
        # a fresh profiler window may miss the first launches it sees
        torch.zeros(1, device=device)
        torch.cuda.synchronize()

    step = make_row_step(kind, mc, seq, mbs, layers, remat, device=device)
    graph, _out, _warm, _captured = capture_step(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime()
        step()
        torch.cuda.synchronize()
    slug = "".join(c if c.isalnum() else "_" for c in label)
    eager, untied = eager_kernel_families(_trace(prof, f"{slug}_eager"))
    graph.replay()
    torch.cuda.synchronize()
    # a window can drop launches anywhere in the replay (one q8_amax of
    # 2260 once, 20 of 1624 another time), so the fullest of a few is kept
    windows = []
    for i in range(REPLAY_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prime()
            graph.replay()
            torch.cuda.synchronize()
        events = _trace(prof, f"{slug}_graph{i}")
        windows.append((len(device_events(events)), events))
    replay_events = max(windows, key=lambda w: w[0])[1]
    graph_ms, matched = replay_families(eager, replay_events)
    eager_ms = dict.fromkeys(FAMILIES, 0.0)
    for _name, ms, family in eager:
        eager_ms[family] += ms
    own_ms = defaultdict(float)  # the port's CUDA kernels in the replay, by function
    own_n = defaultdict(int)
    for k in device_events(replay_events):
        own = re.search(r"\w*(?:flash_|q8_|swiglu_)\w*", k["name"])
        if own:
            own_ms[own.group(0)] += k.get("dur", 0.0) / 1e3
            own_n[own.group(0)] += 1
    del graph, step
    torch.cuda.empty_cache()
    return {"graph_ms": graph_ms, "eager_ms": eager_ms, "kernels": len(eager),
            "graph_kernels": len(device_events(replay_events)), "matched": matched,
            "untied": untied, "own_kernels_ms": dict(own_ms), "own_kernels": dict(own_n),
            "replay_windows": [n for n, _events in windows]}


def format_table(label: str, predicted: Dict[str, float], measured: Dict) -> List[str]:
    """Lines of one row's table: predicted and graph-replay ms by family."""
    lines = [f"{label}: family, predicted ms (ledger), kernel ms of one graph replay "
             f"({measured['graph_kernels']} kernels, the fullest of windows of "
             f"{measured['replay_windows']}; "
             f"{'matched' if measured['matched'] else 'NOT matched'} one for one with the eager "
             f"step's {measured['kernels']}, {measured['untied']} tied by name)"]
    for family in FAMILIES:
        lines.append(f"  {family:<14} {predicted[family]:10.3f} "
                     f"{measured['graph_ms'][family]:10.3f}")
    lines.append(f"  {'recompute':<14} {predicted['recompute']:10.3f} {'(in families)':>10}")
    lines.append(f"  {'total':<14} {sum(predicted.values()):10.3f} "
                 f"{sum(measured['graph_ms'].values()):10.3f}")
    if measured["own_kernels_ms"]:
        lines.append("  of which the port's CUDA kernels: " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in sorted(measured["own_kernels_ms"].items())))
    return lines


def main(device="cuda") -> List[Dict]:
    from simumax_tpu_torch import bench

    system_name, card = bench.detect_system(device)
    rows = []
    for label, kind, seq, mbs, layers, remat in bench.ROWS:
        mc = bench.build_model(kind)
        perf = bench.predict_step(mc, system_name, kind, seq, mbs, layers, remat)
        predicted = ledger_families(perf)
        measured = profile_row(kind, mc, seq, mbs, layers, remat, label, device)
        for line in format_table(f"{label} [{system_name}, {card}]", predicted, measured):
            print(line, flush=True)
        rows.append({"label": label, "predicted_ms": predicted, **measured})
    return rows


if __name__ == "__main__":
    main()

"""Reading a profiled window of training steps: device time by op family,
the device's busy union, its idle gaps, and its busiest operations.

The attribution of kernels to families is a frozen copy of the method of
the port's ``tools/attribute_step.py``. The program marks its op families
with ``torch.profiler`` ranges (:data:`SPANS`); each device event is tied
to the host call that launched it by its correlation id, and takes the
family of the innermost range around that call. A backward kernel runs
under autograd's ``evaluate_function`` of its node, outside any range: it
takes the range of the forward op that created the node, found by the
node's sequence number. What runs in no range is elementwise work. A
profiler window can drop the launches it sees first, so each window opens
with :data:`LEAD_LAUNCHES` launches for it to drop and a pause, then a spin
kernel that marks where the profiled work starts (:func:`open_window`);
only the device events after the mark are read (:func:`after_mark`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

#: the program's op-family range names; work under none is "elementwise"
SPANS = ("gemm", "attention", "norm", "cross_entropy", "optimizer", "moe_dispatch")
ELEMENTWISE = "elementwise"
#: the trace's device events: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_BACKWARD = "autograd::engine::evaluate_function: "
#: launches that open each profiler window, for it to drop
LEAD_LAUNCHES = 64
#: host seconds a window waits after its lead launches and before it closes
WINDOW_PAD_S = 0.05
#: the spin kernel (``torch.cuda._sleep``) that marks the end of the lead
MARK = "spin_kernel"


def open_window(device="cuda") -> None:
    """The lead of a profiler window: :data:`LEAD_LAUNCHES` one-element
    fills, a wait for them and a pause, then the mark, a spin kernel of a
    thousand cycles."""
    for _ in range(LEAD_LAUNCHES):
        torch.zeros(1, device=device)
    torch.cuda.synchronize()
    time.sleep(WINDOW_PAD_S)
    torch.cuda._sleep(1000)


def close_window() -> None:
    torch.cuda.synchronize()
    time.sleep(WINDOW_PAD_S)


def device_events(events: List[dict]) -> List[dict]:
    """The trace's kernels, copies and fills in the order they ran."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                  key=lambda e: e["ts"])


def after_mark(events: List[dict]) -> List[dict]:
    """The trace's events without its device events up to and including
    the last mark; without any device event if the window dropped its mark."""
    marks = [e["ts"] for e in device_events(events) if MARK in e["name"]]
    end = marks[-1] if marks else float("inf")
    return [e for e in events
            if not (e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and e["ts"] <= end)]


def _is_forward_op(e) -> bool:
    name = e["name"]
    return (e.get("cat") == "cpu_op" and "Sequence number" in e.get("args", {})
            and not name.startswith("autograd::") and "Backward" not in name)


def _innermost(stack) -> tuple:
    """("range", name), ("backward", sequence number, forward thread id)
    or ("none",) around the top of ``stack`` (host events, outermost
    first)."""
    in_forward = False
    for e in reversed(stack):
        if e.get("cat") == "user_annotation" and e["name"] in SPANS:
            return ("range", e["name"])
        if e["name"].startswith(_BACKWARD):
            if in_forward:
                return ("none",)
            args = e.get("args", {})
            return ("backward", args.get("Sequence number"), args.get("Fwd thread id"))
        in_forward = in_forward or _is_forward_op(e)
    return ("none",)


def host_families(events: List[dict], queries: List[Tuple[int, float]]) -> List[str]:
    """The family of each host call (tid, ts) of one trace: the innermost
    range around it or, under a backward node, the range of the forward op
    with the node's sequence number."""
    by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"):
            by_tid[e["tid"]].append(e)
    wanted = defaultdict(set)
    for tid, ts in queries:
        wanted[tid].add(ts)
    found: Dict[Tuple[int, float], tuple] = {}
    forward: Dict[Tuple[int, int], str] = {}
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
        out.append(region if region in SPANS else ELEMENTWISE)
    return out


def _by_name(name: str) -> str:
    """The family of one of the port's own kernels from its name, for a
    launch the trace does not tie to a host call."""
    for part, family in (("flash_", "attention"), ("q8_", "gemm"), ("rms_norm_", "norm"),
                         ("moe_permute_", "moe_dispatch"), ("moe_combine_", "moe_dispatch"),
                         ("moe_route_", "moe_dispatch"), ("moe_index", "moe_dispatch"),
                         ("adam_", "optimizer")):
        if part in name:
            return family
    return ELEMENTWISE


def kernel_families(events: List[dict]) -> Tuple[List[Tuple[dict, str]], int]:
    """[(device event, family)] in the order they ran, and how many events
    the trace did not tie to a launching host call (named by :func:`_by_name`)."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = device_events(events)
    queries, untied = [], 0
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        queries.append((launch["tid"], launch["ts"]) if launch else None)
        untied += launch is None
    families = iter(host_families(events, [q for q in queries if q is not None]))
    return [(k, next(families) if q else _by_name(k["name"]))
            for k, q in zip(kernels, queries)], untied


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def host_op_at(events: List[dict], ts: float) -> str:
    """The innermost host op or range running at ``ts`` on the thread
    that issues the most device work; "idle host" where none is."""
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")]
    if not launches:
        return "idle host"
    counts = defaultdict(int)
    for e in launches:
        counts[e["tid"]] += 1
    tid = max(counts, key=counts.get)
    best = None
    for e in events:
        if (e.get("ph") == "X" and e.get("tid") == tid
                and e.get("cat") in ("cpu_op", "user_annotation")
                and e["ts"] <= ts < e["ts"] + e.get("dur", 0)):
            if best is None or e.get("dur", 0) < best.get("dur", 0):
                best = e
    return best["name"] if best else "idle host"


def read_window(events: List[dict], steps: int, top: int = 10) -> Dict:
    """What the per-layer readers take from one profiled window of
    ``steps`` steps (the events after the mark): device ms a step by
    family, the busy union and the window in seconds, the busiest device
    operations and the longest idle gaps (each named by the host op then
    running), and how many device events were not tied to a launch."""
    events = after_mark(events)
    tagged, untied = kernel_families(events)
    if not tagged:
        return {}
    family_ms = defaultdict(float)
    by_name = defaultdict(float)
    spans = []
    for e, family in tagged:
        dur = e.get("dur", 0.0)
        family_ms[family] += dur / 1e3 / steps
        by_name[e["name"]] += dur / 1e6
        spans.append((e["ts"], e["ts"] + dur))
    busy = union(spans)
    start, end = busy[0][0], busy[-1][1]
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:]) if b1[0] > b0[1]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "family_ms": dict(family_ms),
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (end - start) / 1e6,
        "device_ops": sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top],
        "idle_gaps": [[host_op_at(events, a), (b - a) / 1e6] for a, b in gaps[:top]],
        "device_events": len(tagged),
        "untied": untied,
    }

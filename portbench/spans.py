"""Reading the port's spans from a traced run's exported trace: device time
a step by the innermost of the op families and the spans nested inside
``gemm``, device time a step by the step's phase, and the host's time to
issue a step.

The program marks its work with ``torch.profiler`` ranges
(``simumax_tpu_torch/torchref/spans.py``): the six op families that
:mod:`portbench.trace` reads (:data:`trace.SPANS`); inside ``gemm``,
``int8_mm`` around each ``torch._int_mm``, ``q8`` around each
quantization and dequantization and ``expert_gemm`` around each MoE expert
product (:data:`GEMM_PARTS`); and ``step``, ``forward`` and ``backward``
in the training step (:data:`PHASES`).

A device event takes the innermost of :data:`REGIONS` around the host
call that launched it, by :mod:`portbench.trace`'s method written with the
names as a parameter (:func:`host_regions`): the range stack on the
launching thread, or, for a backward node's kernel outside any range, the
range of the forward op with the node's sequence number. It takes a phase
by its launch's time: inside a ``forward`` or a ``backward`` span, on
whichever thread it was launched (autograd's device thread launches the
backward's kernels while ``torch.autograd.grad`` waits in ``backward``).
Only device events after the window's mark are read
(:func:`trace.after_mark`).

The run's record carries no trace path: :func:`trace_path` names the cell
by the file under ``portbench/cells/`` whose contents are the record's
cell, and finds ``build/portbench_traces/<cell>.json``, which the traced
run wrote (for a cell no file holds, the newest trace there). The reading
checks itself against the run's own family reading
(``record["traced"]["family_ms"]``): each family, the spans inside
``gemm`` folded back into it, within :data:`TOLERANCE`, or nothing is read.
"""

from __future__ import annotations

import bisect
import functools
import json
import math
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench import trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
TRACE_DIR = os.path.join(os.path.dirname(BENCH_DIR), "build", "portbench_traces")
#: the spans nested inside the ``gemm`` family
GEMM_PARTS = ("int8_mm", "q8", "expert_gemm")
#: what a device event is attributed to: the families and the spans in ``gemm``
REGIONS = trace.SPANS + GEMM_PARTS
#: the step's span and the phases inside it that device events are split by
STEP = "step"
PHASES = ("forward", "backward")
#: how far a family's device ms may lie from the run's own reading
TOLERANCE = 1e-3


def _innermost(stack, names) -> tuple:
    """:func:`trace._innermost` over the ranges ``names``."""
    in_forward = False
    for e in reversed(stack):
        if e.get("cat") == "user_annotation" and e["name"] in names:
            return ("range", e["name"])
        if e["name"].startswith(trace._BACKWARD):
            if in_forward:
                return ("none",)
            args = e.get("args", {})
            return ("backward", args.get("Sequence number"), args.get("Fwd thread id"))
        in_forward = in_forward or trace._is_forward_op(e)
    return ("none",)


def host_regions(events: List[dict], queries: List[Tuple[int, float]],
                 names=REGIONS) -> List[str]:
    """The region of each host call (tid, ts) of one trace among the
    ranges ``names``: :func:`trace.host_families` with the names as a
    parameter."""
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
                found[(tid, ts)] = _innermost(stack, names)
                continue
            if trace._is_forward_op(e):
                where = _innermost(stack, names)
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
        out.append(region if region in names else trace.ELEMENTWISE)
    return out


def _by_name(name: str) -> str:
    """The region of one of the port's kernels the trace does not tie to a
    launch, from its name (:func:`trace._by_name`, the q8 kernels in ``q8``)."""
    return "q8" if "q8_" in name else trace._by_name(name)


def _spans_named(events: List[dict], name: str) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"] == name]


def read_events(events: List[dict]) -> Optional[Dict]:
    """What the span readers take from one profiled window (the whole
    trace; only device events after its mark count): the steps (``step``
    spans), device ms a step by region and by phase, and the mean host ms
    of a ``step`` span. None where the window holds no ``step`` span or no
    device event after its mark."""
    steps = _spans_named(events, STEP)
    events = trace.after_mark(events)
    kernels = trace.device_events(events)
    if not steps or not kernels:
        return None
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    tied = [launches.get(k.get("args", {}).get("correlation")) for k in kernels]
    regions = iter(host_regions(events, [(e["tid"], e["ts"]) for e in tied if e is not None]))
    phases = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                    for name in PHASES for e in _spans_named(events, name))
    starts = [p[0] for p in phases]
    n = len(steps)
    region_ms: Dict[str, float] = defaultdict(float)
    phase_ms: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
    for k, launch in zip(kernels, tied):
        ms = k.get("dur", 0.0) / 1e3 / n
        region_ms[next(regions) if launch is not None else _by_name(k["name"])] += ms
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch["ts"]) - 1
        if i >= 0 and launch["ts"] <= phases[i][1]:
            phase_ms[phases[i][2]] += ms
    return {"steps": n, "region_ms": dict(region_ms), "phase_ms": phase_ms,
            "step_host_ms": sum(e.get("dur", 0.0) for e in steps) / 1e3 / n}


def matches(got: Dict, family_ms: Dict[str, float], tolerance: float = TOLERANCE) -> bool:
    """Whether ``got``'s device ms, the spans inside ``gemm`` folded back
    into it, equal ``family_ms`` (:func:`trace.read_window`'s) family by
    family and in total, each within ``tolerance`` of its size."""
    folded: Dict[str, float] = defaultdict(float)
    for region, ms in got["region_ms"].items():
        folded["gemm" if region in GEMM_PARTS else region] += ms
    pairs = [(folded.get(f, 0.0), family_ms.get(f, 0.0)) for f in set(folded) | set(family_ms)]
    pairs.append((sum(folded.values()), sum(family_ms.values())))
    return all(math.isclose(a, b, rel_tol=tolerance, abs_tol=1e-9) for a, b in pairs)


def trace_path(cell: Dict, bench_dir: str = BENCH_DIR, trace_dir: str = TRACE_DIR
               ) -> Optional[str]:
    """The exported trace of the cell whose file under ``cells/`` holds
    ``cell``. For a cell no file holds (one built in code, as the tests'
    tiny cells are), the newest trace in ``trace_dir``, which :func:`read`
    takes only if it reads what the run read. None where two files hold
    the cell or no trace is found."""
    cells_dir = os.path.join(bench_dir, "cells")
    found = []
    for name in sorted(os.listdir(cells_dir)):
        if name.endswith(".json"):
            with open(os.path.join(cells_dir, name)) as f:
                if json.load(f) == cell:
                    found.append(name[:-len(".json")])
    if len(found) > 1:
        return None
    if found:
        path = os.path.join(trace_dir, f"{found[0]}.json")
        return path if os.path.exists(path) else None
    traces = [os.path.join(trace_dir, name) for name in os.listdir(trace_dir)
              if name.endswith(".json")] if os.path.isdir(trace_dir) else []
    return max(traces, key=os.path.getmtime, default=None)


@functools.lru_cache(maxsize=1)
def _read_file(path: str, _mtime_ns: int, _size: int) -> Optional[Dict]:
    """:func:`read_events` of one trace file, parsed once for as long as it
    is unchanged (its time and size are part of the key)."""
    with open(path) as f:
        events = json.load(f)
    return read_events(events["traceEvents"] if isinstance(events, dict) else events)


def read(record: Dict, bench_dir: str = BENCH_DIR, trace_dir: str = TRACE_DIR
         ) -> Optional[Dict]:
    """:func:`read_events` of the traced run's trace, if it reads what the
    run's own family reading does (:func:`matches`); None otherwise, and
    for a run with no trace (any run on the CPU)."""
    family_ms = (record.get("traced") or {}).get("family_ms")
    if not family_ms:
        return None
    path = trace_path(record["cell"], bench_dir, trace_dir)
    if path is None:
        return None
    st = os.stat(path)
    got = _read_file(path, st.st_mtime_ns, st.st_size)
    if got is None or not matches(got, family_ms):
        return None
    return got

"""Chrome/Perfetto trace export (L6).

Reference: ``simumax/core/generate_tracing.py`` + ``trace_export.py``.
The reference writes text log lines and re-parses them by regex; here
the engine produces structured :class:`TraceEvent` records directly, so
export is a straight conversion — pid = simulated rank (PP stage),
ordered tid lanes (comp / comm / pp_fwd / pp_bwd), flow arrows linking
p2p send -> recv-wait pairs, and per-rank memory counter tracks.

Two writers share the conversion helpers:

* :func:`to_chrome_trace` / :func:`write_chrome_trace` — batch: convert
  a retained event list in one pass (small runs, post-hoc tooling).
* :class:`StreamingTraceWriter` — incremental: plugs into the engine as
  its ``event_sink`` and flushes JSON to disk as events are emitted, so
  peak RSS no longer scales with total event count (the pod-size
  world-rank contract). Flow arrows are paired on the fly: a p2p send
  parks a tiny stub until (unless) its recv-wait streams past.

Copy of the JAX package's ``simulator/trace.py`` with its import paths
changed.
"""

from __future__ import annotations

import json
from typing import List, Optional

from simumax_tpu_torch.simulator.engine import TraceEvent
from simumax_tpu_torch.simulator.memory import SimuMemoryTracker

_LANE_ORDER = {"comp": 0, "comm": 1, "pp_fwd": 2, "pp_bwd": 3, "wait": 4}

_COLORS = {
    "compute": "good",
    "comm": "thread_state_runnable",
    "p2p": "thread_state_iowait",
    "wait": "terrible",
}


def _meta_dicts(rank: int) -> List[dict]:
    """Process/thread naming metadata for one simulated rank."""
    out = [
        {
            "ph": "M", "pid": rank, "name": "process_name",
            "args": {"name": f"stage{rank}"},
        }
    ]
    for lane, idx in _LANE_ORDER.items():
        out.append(
            {
                "ph": "M", "pid": rank, "tid": idx,
                "name": "thread_name", "args": {"name": lane},
            }
        )
    return out


def _event_tid(e: TraceEvent) -> int:
    lane = e.lane if e.kind != "wait" else "wait"
    return _LANE_ORDER.get(lane, 5)


def _x_dict(e: TraceEvent) -> dict:
    return {
        "ph": "X",
        "pid": e.rank,
        "tid": _event_tid(e),
        "name": e.name,
        "ts": e.start * 1e6,
        "dur": max(e.end - e.start, 0.0) * 1e6,
        "cname": _COLORS.get(e.kind),
        "args": {"kind": e.kind},
    }


def _flow_start_dict(flow_id: int, pid: int, tid: int, ts_us: float) -> dict:
    return {
        "ph": "s", "pid": pid, "tid": tid, "id": flow_id,
        "name": "p2p", "ts": ts_us, "cat": "p2p",
    }


def _flow_end_dict(e: TraceEvent) -> dict:
    return {
        "ph": "f", "pid": e.rank, "tid": _event_tid(e), "id": e.flow_id,
        "name": "p2p", "ts": e.end * 1e6, "cat": "p2p",
        "bp": "e",
    }


def _counter_dicts(tr: SimuMemoryTracker,
                   max_counter_samples: int) -> List[dict]:
    samples = tr.timeline
    if not samples:
        return []  # nothing tracked for this rank: no counter lane
    stride = max(1, len(samples) // max_counter_samples)
    kept = list(samples[::stride])
    # never drop the peak or the final sample when downsampling: the
    # stride cut keeps the first of every stride window, so both the
    # peak and the step-end tail sample can otherwise vanish
    peak_sample = max(samples, key=lambda s: s.bytes)
    for extra in (peak_sample, samples[-1]):
        if extra not in kept:
            kept.append(extra)
    kept.sort(key=lambda s: s.t)
    return [
        {
            "ph": "C",
            "pid": tr.rank,
            "name": "hbm_bytes",
            "ts": s.t * 1e6,
            "args": {"allocated": s.bytes},
        }
        for s in kept
    ]


def to_chrome_trace(
    events: List[TraceEvent],
    trackers: Optional[List[SimuMemoryTracker]] = None,
    max_counter_samples: int = 4000,
    annotations: Optional[dict] = None,
) -> dict:
    """``annotations`` maps ``(rank, per-rank emission index) ->
    (slack_seconds, on_critical_path)`` (the critical-path post-pass,
    ``observe/critpath.py``): matching X events gain ``slack_us`` /
    ``on_critical_path`` args. The events list is in engine emission
    order, so the per-rank index is reconstructed while converting."""
    out = []
    # a flow arrow needs both ends: a send whose recv never waited (data
    # already arrived -> no wait event) must not emit a dangling `s`
    # (Perfetto drops or mis-renders unpaired arrows)
    send_ids = {e.flow_id for e in events
                if e.kind == "p2p" and e.flow_id is not None}
    wait_ids = {e.flow_id for e in events
                if e.kind == "wait" and e.flow_id is not None}
    paired_flows = send_ids & wait_ids
    ranks = {e.rank for e in events}
    ranks.update(tr.rank for tr in trackers or [] if tr.timeline)
    for rank in sorted(ranks):
        out.extend(_meta_dicts(rank))
    emit_idx: dict = {}
    for e in events:
        d = _x_dict(e)
        if annotations is not None:
            idx = emit_idx.get(e.rank, 0)
            emit_idx[e.rank] = idx + 1
            ann = annotations.get((e.rank, idx))
            if ann is not None:
                slack, on_path = ann
                d["args"]["on_critical_path"] = bool(on_path)
                if slack == float("inf"):
                    d["args"]["slack_us"] = None
                else:
                    d["args"]["slack_us"] = round(slack * 1e6, 3)
        out.append(d)
        if e.flow_id in paired_flows and e.kind == "p2p":
            out.append(
                _flow_start_dict(e.flow_id, e.rank, _event_tid(e),
                                 e.start * 1e6)
            )
        if e.flow_id in paired_flows and e.kind == "wait":
            out.append(_flow_end_dict(e))
    for tr in trackers or []:
        out.extend(_counter_dicts(tr, max_counter_samples))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events, trackers=None, annotations=None):
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events, trackers,
                                  annotations=annotations), f)
    return path


class StreamingTraceWriter:
    """Incremental Chrome-trace writer, used as the engine's
    ``event_sink``: events are serialized and flushed to ``path`` as
    they are emitted instead of being retained in memory.

    Matches :func:`to_chrome_trace` output semantics: rank metadata is
    emitted lazily on a rank's first event, and flow arrows are emitted
    only for *paired* send/wait flows — a send's arrow stub (a 4-tuple,
    not the JSON dict) is parked until its recv-wait streams past; the
    engine serves every matching recv after its send, so the wait always
    arrives later in emission order. Call :meth:`close` (optionally with
    memory trackers for counter tracks) to finalize the JSON; the writer
    is also a context manager."""

    def __init__(self, path: str, flush_every: int = 5000,
                 max_counter_samples: int = 4000):
        self.path = path
        self.num_events = 0
        self._flush_every = flush_every
        self._max_counter_samples = max_counter_samples
        self._f = open(path, "w")
        self._f.write('{"traceEvents": [')
        self._first = True
        self._buf: List[str] = []
        self._ranks_seen = set()
        #: flow_id -> (pid, tid, ts_us) send stub awaiting its wait
        self._open_flows = {}
        self._closed = False

    def __call__(self, e: TraceEvent):
        self.num_events += 1
        if e.rank not in self._ranks_seen:
            self._ranks_seen.add(e.rank)
            for d in _meta_dicts(e.rank):
                self._push(d)
        self._push(_x_dict(e))
        if e.flow_id is not None:
            if e.kind == "p2p":
                self._open_flows[e.flow_id] = (
                    e.rank, _event_tid(e), e.start * 1e6
                )
            elif e.kind == "wait":
                stub = self._open_flows.pop(e.flow_id, None)
                if stub is not None:
                    self._push(_flow_start_dict(e.flow_id, *stub))
                    self._push(_flow_end_dict(e))

    def _push(self, d: dict):
        self._buf.append(json.dumps(d))
        if len(self._buf) >= self._flush_every:
            self._drain()

    def _drain(self):
        if not self._buf:
            return
        chunk = ", ".join(self._buf)
        self._f.write(chunk if self._first else ", " + chunk)
        self._first = False
        self._buf.clear()

    def close(self, trackers: Optional[List[SimuMemoryTracker]] = None):
        if self._closed:
            return self.path
        for tr in trackers or []:
            if not tr.timeline:
                continue
            if tr.rank not in self._ranks_seen:
                self._ranks_seen.add(tr.rank)
                for d in _meta_dicts(tr.rank):
                    self._push(d)
            for d in _counter_dicts(tr, self._max_counter_samples):
                self._push(d)
        self._drain()
        self._f.write('], "displayTimeUnit": "ms"}')
        self._f.close()
        self._closed = True
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

"""Chrome/Perfetto trace export for the *analytical* path.

``simulate()`` already exports its discrete-event timeline via
``simulator/trace.py``; this module lays out the analytical estimate's
schedule replay (``PerfLLM.calculate_1f1b_bubble`` /
``calculate_interleaved_schedule`` — the exact intervals the headline
time was derived from) in the same Chrome-trace conventions, so a
``perf`` run is inspectable in the same UI as a ``simulate()`` run:

* pid = pipeline stage, tid lanes ``comp`` / ``comm`` (reusing
  ``simulator.trace.to_chrome_trace`` — the batch writer built on the
  same ``_meta_dicts`` / ``_x_dict`` / ``_counter_dicts`` helpers as
  the engine's streaming ``StreamingTraceWriter`` sink, so both UIs
  stay byte-compatible — for metadata, lane order, colors and
  ``displayTimeUnit``);
* per-microbatch F/B slices on the comp lane, the exposed DP grad
  reduce-scatter / optimizer / param all-gather tail after each stage's
  last backward;
* an ``hbm_bytes`` counter track reconstructed from the schedule
  (model bytes + one activation cache per in-flight microbatch), the
  analytical analog of ``analysis_mem``'s live-microbatch accounting.

Times are pre-straggler seconds (the schedule's own clock); the
straggler inflation is a scalar on top and is recorded in the result.

Copy of the JAX package's ``observe/trace.py`` with its import paths
changed and the trace's ``otherData.source`` naming this package.
"""

from __future__ import annotations

from typing import List, Tuple

from simumax_tpu_torch.simulator.engine import TraceEvent
from simumax_tpu_torch.simulator.memory import MemSample, SimuMemoryTracker
from simumax_tpu_torch.simulator.trace import to_chrome_trace


def analytical_trace_events(perf) -> Tuple[List[TraceEvent], List[SimuMemoryTracker]]:
    """Build TraceEvents + per-stage memory counter tracks from the last
    ``analysis_cost()`` schedule replay. The counter tracks ARE the
    memory ledger's analytical timeline trackers
    (``observe/memledger.py::analytical_memory_trackers`` — one replay,
    two consumers), extended with a flat ``step_end`` sample covering
    the exposed optimizer tail this trace additionally lays out."""
    from simumax_tpu_torch.observe.memledger import analytical_memory_trackers

    perf.analysis_cost()  # ensures the replay ran (cached)
    st = perf.strategy
    pp, vp = st.pp_size, st.vp_size
    events: List[TraceEvent] = []
    trackers = analytical_memory_trackers(perf, record_events=False)
    by_stage: List[List[tuple]] = [[] for _ in range(pp)]
    for ev in perf._schedule_events:
        by_stage[ev[0]].append(ev)
    for s in range(pp):
        for (_, kind, c, mb, start, end) in sorted(
            by_stage[s], key=lambda e: e[4]
        ):
            name = f"{'fwd' if kind == 'F' else 'bwd'} mb{mb}"
            if vp > 1:
                name += f" chunk{c}"
            events.append(TraceEvent(
                rank=s, lane="comp", name=name, start=start, end=end,
                kind="compute",
            ))
        # exposed step tail: grad reduce-scatter -> optimizer -> param
        # gather (the analytical max-path components, laid out serially
        # the way analysis_cost charges them)
        t = max((e[5] for e in by_stage[s]), default=0.0)
        dp = perf._compute_dp_time(s)
        optim = perf._compute_optim_time(s)
        for name, dur, lane, kind in (
            ("grad_reduce_scatter", dp["exposed_rs"], "comm", "comm"),
            ("optimizer", optim, "comp", "compute"),
            ("param_all_gather", dp["exposed_ag"], "comm", "comm"),
        ):
            if dur <= 0:
                continue
            events.append(TraceEvent(
                rank=s, lane=lane, name=name, start=t, end=t + dur,
                kind=kind,
            ))
            t += dur
        trackers[s].timeline.append(
            MemSample(t, trackers[s].static_bytes, "step_end")
        )
    return events, trackers


def analytical_chrome_trace(perf) -> dict:
    events, trackers = analytical_trace_events(perf)
    trace = to_chrome_trace(events, trackers)
    trace["otherData"] = {
        "source": "simumax_tpu_torch analytical estimate",
        "straggle_ratio": perf.analysis_cost()["straggle_ratio"],
        "time_base": "pre-straggler schedule seconds (exported as us)",
    }
    return trace


def write_analytical_trace(perf, path: str) -> str:
    import json

    with open(path, "w", encoding="utf-8") as f:
        json.dump(analytical_chrome_trace(perf), f)
    return path

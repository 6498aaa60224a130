"""simulate() entry point (L5 top).

Reference: ``simumax/core/simu_runner.py:22-94`` (``run_simulation``:
one simulated rank per PP stage, memory tracker wiring, trace +
memory-artifact export).

Pod-scale additions on top of the reference shape:

* ``world_ranks=True`` simulates every global rank; with
  ``reduce="auto"`` (default) the world is first partitioned into
  rank-symmetry classes (:mod:`simumax_tpu_torch.simulator.reduce`) and one
  representative per class is simulated — bit-identical results at a
  fraction of the work, falling back to exact full-world simulation
  wherever a ``perturbation`` entry breaks the symmetry.
* ``stream_trace=True`` (with ``save_path``) streams Chrome-trace
  events to disk while the engine runs instead of retaining them, so
  peak RSS is bounded regardless of event count.

Copy of the JAX package's ``simulator/runner.py`` with its import paths
changed.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from simumax_tpu_torch.simulator.engine import SimuEngine
from simumax_tpu_torch.simulator.memory import SimuMemoryTracker
from simumax_tpu_torch.simulator.schedule import StageProcess
from simumax_tpu_torch.simulator.trace import StreamingTraceWriter, write_chrome_trace


def _diag(perf):
    diag = getattr(perf, "diagnostics", None)
    if diag is None:
        from simumax_tpu_torch.core.records import Diagnostics

        diag = Diagnostics.active()
    return diag


def _world_memberships(st) -> dict:
    """Rendezvous-group membership per parallel dim, computed once for
    the whole world (the per-rank ``group_of`` fallback inside
    ``StageProcess`` is O(world) per rank — quadratic at pod scale)."""
    from simumax_tpu_torch.parallel.mesh import rank_coords, rank_groups

    memberships = {}
    for dim in ("tp", "cp", "ep", "etp"):
        if getattr(st, f"{dim}_size") > 1:
            by_rank = {}
            for g in rank_groups(st, dim):
                for r in g:
                    by_rank[r] = g
            memberships[dim] = by_rank
    buckets: dict = {}
    if st.dp_size * st.cp_size > 1:
        for r in range(st.world_size):
            c = rank_coords(r, st)
            buckets.setdefault((c["tp"], c["pp"]), []).append(r)
        by_rank = {}
        for g in buckets.values():
            g = sorted(g)
            for r in g:
                by_rank[r] = g
        memberships["dp_cp"] = by_rank
    if st.edp_size > 1:
        by_rank = {}
        for g in rank_groups(st, "edp"):
            for r in g:
                by_rank[r] = g
        memberships["edp"] = by_rank
    return memberships


def build_reduced_engine(perf, plan, granularity: str,
                         fault_model=None, engine_kw: Optional[dict] = None,
                         wrap_proc=None, drop_events: bool = False):
    """Engine + one ``StageProcess`` coroutine per symmetry class of
    ``plan`` — the world-rank construction shared by
    :func:`run_simulation` and the incremental fault-replay engine
    (``simulator/faults.py``), so the two can never drift.

    ``wrap_proc(engine_rank, gen) -> proc`` wraps each coroutine (the
    replay engine passes a ``RecordingProc`` to capture request
    streams); ``drop_events=True`` keeps event counters without
    constructing trace records (replays need only makespan + deaths).
    """
    k = plan.n_classes
    engine = SimuEngine(k, fault_model=fault_model,
                        drop_events=drop_events, **(engine_kw or {}))
    barrier = list(range(k))
    for i in range(k):
        groups = {
            d: g for d, g in plan.groups[i].items()
            if d in ("tp", "cp", "ep", "etp")
        }
        buckets = {
            d: g for d, g in plan.groups[i].items()
            if d in ("dp_cp", "edp")
        }
        proc = StageProcess(
            perf, plan.stages[i], tracker=None,
            granularity=granularity,
            rank=i, perturb=plan.perturbs[i],
            groups=groups, bucket_groups=buckets,
            neighbor_map=plan.neighbor_maps[i] or None,
            barrier_group=barrier,
        ).process()
        if wrap_proc is not None:
            proc = wrap_proc(i, proc)
        engine.add_rank(i, proc)
    return engine


def run_simulation(
    perf,
    save_path: Optional[str] = None,
    granularity: str = "leaf",
    track_memory: Optional[bool] = None,
    world_ranks: bool = False,
    perturbation: Optional[dict] = None,
    reduce="auto",
    stream_trace: bool = False,
    faults=None,
    critical_path: bool = False,
    progress_every: int = 200_000,
    event_delays: Optional[dict] = None,
) -> dict:
    """Discrete-event replay of one training iteration. ``perf`` must
    have completed ``run_estimate()``.

    ``world_ranks=True`` simulates every global rank (instead of one
    representative per pipeline stage): intra-stage collectives become
    true rendezvous among each rank's tp/cp/ep groups and the optimizer
    syncs over real dp groups — enabling per-rank straggler injection
    via ``perturbation`` ({rank: compute-time multiplier}). The
    reference only approximates stragglers with a closed-form inflation
    (perf_llm.py:255-291); here the slowdown propagates through the
    actual collective dependency graph.

    ``reduce`` controls world-rank symmetry reduction: ``"auto"``
    (default) simulates one rank per symmetry class when that is
    cheaper, ``True`` forces the reduced path, ``False`` forces exact
    full-world simulation. Reduced results are expanded back to
    full-world shape (``per_rank_end_ms``, event counts) and carry a
    ``reduction`` summary block.

    Memory tracking is a per-representative-stage feature and is
    disabled in world mode (result carries no 'memory' key); passing
    ``track_memory=True`` together with ``world_ranks=True`` records a
    Diagnostics warning instead of silently ignoring the request.

    ``stream_trace=True`` with ``save_path`` writes ``trace.json``
    incrementally while the engine runs (bounded peak RSS); without
    ``save_path`` it is ignored with a Diagnostics warning.

    ``faults`` injects a :class:`~simumax_tpu_torch.simulator.faults.
    FaultScenario` (or a path to its JSON): timed rank slowdowns,
    preemptions, link degradation, and rank deaths, consulted by the
    engine at event-service time (``docs/faults.md``). Requires
    ``world_ranks=True`` when non-empty; an empty scenario is
    bit-identical to no scenario at all. The result then carries a
    structured ``"faults"`` outcome block — a rank death degrades
    gracefully (partners resolve via the fault model) instead of
    deadlocking.

    ``critical_path=True`` records the event-dependency skeleton during
    the run and attaches a ``"critical_path"`` report
    (``observe/critpath.py``): per-event slack, the cross-rank critical
    path, a simulated waterfall whose buckets sum to ``end_time``
    within 1e-6, sim-vs-analytical ``divergence``, and per-rank /
    per-link slack-headroom summaries. Recording is observational —
    on vs off makespans are bit-identical. With ``save_path`` the
    report lands in ``critpath.json`` and (batch-trace mode) the Chrome
    trace gains ``on_critical_path`` / ``slack_us`` args; under
    ``stream_trace`` only the bounded skeleton is retained, so the
    streamed trace is not annotated (the report still is).

    ``progress_every`` drives the progress heartbeat every N served
    engine events: the ``des_events_served`` / ``des_blocked_ranks`` /
    ``des_clock_seconds`` registry gauges (``observe/telemetry.py`` —
    scrapeable from ``GET /metrics`` while the run is in flight) are
    always updated, and a debug-level Reporter line (events/s, virtual
    clock, blocked-rank count) is additionally emitted at ``--log-level
    debug``; 0 disables both. Default stdout is byte-identical (debug
    lines are suppressed at the default log level; gauges are
    observe-only). The gauges are process-wide and unlabelled —
    deliberately, so a long-lived server never accumulates per-run
    label cardinality — which makes them last-writer-wins: concurrent
    ``/v1/simulate`` runs interleave their heartbeats, so treat them
    as "a simulation is alive and progressing", not as a per-run
    series (per-run numbers live in the request's span tree).

    ``event_delays`` ({(engine rank, per-rank emit index): extra
    seconds}) perturbs single events at service time — the
    slack-correctness test hook."""
    from simumax_tpu_torch.core.errors import ConfigError

    if not perf.chunks:
        raise ConfigError(
            "simulate() needs a completed estimate: call run_estimate() "
            "first", phase="simulate",
        )
    st = perf.strategy
    pp = st.pp_size
    perturbation = perturbation or {}
    diag = _diag(perf)
    if isinstance(faults, str):
        from simumax_tpu_torch.simulator.faults import FaultScenario

        faults = FaultScenario.from_json(faults)
    if faults is not None:
        faults.validate(st.world_size)
        if faults.empty:
            # the empty scenario must be bit-identical to a run with no
            # scenario at all: drop it before it can touch anything
            faults = None
        elif not world_ranks:
            raise ConfigError(
                "fault scenarios need world_ranks=True: rank-scoped "
                "faults are meaningless when one simulated rank stands "
                "for a whole pipeline stage",
                phase="simulate", world_size=st.world_size,
            )
    if world_ranks and track_memory:
        # memory tracking is per-representative-stage; world mode is for
        # timing/straggler analysis (satellite of ISSUE 4: surface the
        # silent downgrade)
        if diag is not None:
            diag.warn(
                "simulate",
                "track_memory=True is ignored with world_ranks=True: "
                "memory tracking is per-representative-stage; run "
                "simulate() without world_ranks for memory analysis",
                world_size=st.world_size,
            )
    do_memory = bool(track_memory is None or track_memory) and not world_ranks
    sink = None
    if stream_trace:
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            sink = StreamingTraceWriter(os.path.join(save_path, "trace.json"))
        elif diag is not None:
            diag.warn(
                "simulate",
                "stream_trace=True needs save_path to stream to; ignored",
            )

    rec = None
    if critical_path:
        from simumax_tpu_torch.observe.critpath import DependencySkeleton

        rec = DependencySkeleton()
    progress = None
    if progress_every:
        from simumax_tpu_torch.observe.report import LEVELS, get_reporter
        from simumax_tpu_torch.observe.telemetry import get_registry

        _rep = get_reporter()
        # registry gauges are updated at every heartbeat regardless of
        # log level (a long pod-scale run stays observable from
        # ``GET /metrics`` while it runs); the debug *line* is still
        # emitted only when the reporter would show it
        _emit_lines = _rep.threshold <= LEVELS["debug"]
        _reg = get_registry()
        _g_events = _reg.gauge("des_events_served")
        _g_blocked = _reg.gauge("des_blocked_ranks")
        _g_clock = _reg.gauge("des_clock_seconds")

        def progress(served, events, clock_s, blocked_ranks,
                     elapsed_s):
            _g_events.set(events)
            _g_blocked.set(blocked_ranks)
            _g_clock.set(clock_s)
            if not _emit_lines:
                return
            # rate in emitted trace events/s — the same unit as
            # num_events and bench_simulate's events/s metric (a
            # served request emits 0-2 trace events)
            rate = events / elapsed_s if elapsed_s else 0.0
            _rep.debug(
                f"[simulate] {events} events emitted "
                f"({rate:,.0f} ev/s), clock "
                f"{clock_s * 1e3:.1f} ms, {blocked_ranks} ranks "
                f"blocked",
                event="sim_progress", served=served, events=events,
                clock_ms=clock_s * 1e3,
                blocked_ranks=blocked_ranks, events_per_sec=rate,
            )

    engine_kw = dict(
        dep_recorder=rec,
        event_delays=event_delays,
        progress=progress,
        progress_every=progress_every,
    )
    plan = None
    trackers = []
    fault_model = None
    if world_ranks:
        n = st.world_size
        bad = [r for r in perturbation if not 0 <= r < n]
        if bad:
            # a typed error, not an assert: rank validation must
            # survive `python -O`, and the CLI turns ConfigError into
            # an actionable one-liner
            raise ConfigError(
                f"perturbation for nonexistent ranks {bad} "
                f"(world {n})",
                phase="simulate", world_size=n, bad_ranks=bad,
            )
        if reduce:
            from simumax_tpu_torch.simulator.reduce import build_reduction

            plan = build_reduction(
                st, perturbation,
                signatures=faults.rank_signatures() if faults else None,
            )
            if reduce == "auto" and plan.n_classes >= n:
                plan = None  # no symmetry to exploit: exact path
        if faults is not None:
            from simumax_tpu_torch.simulator.faults import StepFaultModel

            fault_model = StepFaultModel(
                faults, rank_map=plan.reps if plan is not None else None
            )
        if plan is not None:
            engine = build_reduced_engine(
                perf, plan, granularity, fault_model=fault_model,
                engine_kw=dict(event_sink=sink, **engine_kw),
            )
        else:
            from simumax_tpu_torch.parallel.mesh import rank_coords

            memberships = _world_memberships(st)
            engine = SimuEngine(n, event_sink=sink,
                                fault_model=fault_model, **engine_kw)
            for r in range(n):
                stage = rank_coords(r, st)["pp"]
                proc = StageProcess(
                    perf, stage, tracker=None, granularity=granularity,
                    rank=r, perturb=perturbation.get(r, 1.0),
                    groups={
                        d: m[r] for d, m in memberships.items()
                        if d in ("tp", "cp", "ep", "etp") and r in m
                    },
                    bucket_groups={
                        d: m[r] for d, m in memberships.items()
                        if d in ("dp_cp", "edp") and r in m
                    },
                )
                engine.add_rank(r, proc.process())
    else:
        engine = SimuEngine(pp, event_sink=sink, **engine_kw)
        for s in range(pp):
            static = sum(
                c.param_info.total_bytes for c in perf.stage_chunks(s)
            )
            tracker = (
                SimuMemoryTracker(s, static_bytes=static,
                                  record_events=save_path is not None)
                if do_memory
                else None
            )
            trackers.append(tracker)
            proc = StageProcess(
                perf, s, tracker=tracker, granularity=granularity
            )
            engine.add_rank(s, proc.process())
    try:
        end_time = engine.run()
    except BaseException:
        if sink is not None:
            # finalize what streamed so far: a valid (partial) trace is
            # exactly what's needed to debug the deadlocked schedule
            sink.close(trackers if do_memory else None)
        raise
    # machine-variance inflation, same as the analytical path
    # (perf-vs-simulator agreement must survive the straggler model)
    ratio = perf.straggler_ratio()
    raw_end = end_time
    end_time *= ratio

    if plan is not None:
        per_rank_ms = [
            engine.clock[plan.class_of[r]] * 1e3
            for r in range(plan.world_size)
        ]
        num_events = sum(
            w * c for w, c in zip(plan.weights, engine.events_by_rank)
        )
        num_comm = sum(
            w * c for w, c in zip(plan.weights, engine.comm_events_by_rank)
        )
    else:
        per_rank_ms = [t * 1e3 for t in engine.clock]
        num_events = engine.num_events
        num_comm = sum(engine.comm_events_by_rank)

    result = {
        "end_time": end_time,
        "end_time_ms": end_time * 1e3,
        "straggle_ratio": ratio,
        "per_rank_end_ms": per_rank_ms,
        "num_events": num_events,
        "num_comm_events": num_comm,
    }
    if fault_model is not None:
        from simumax_tpu_torch.simulator.faults import FaultOutcome

        deaths = []
        for (r, t) in engine.deaths:
            # a dead class rep stands for every member (a death that
            # leaves ranks symmetric — e.g. whole-world kill — keeps
            # them in one class); sort so reduced == exact regardless
            # of engine kill order. Times carry the same straggler
            # inflation as end_time so the result dict has one wall
            # time base.
            members = plan.classes[r] if plan is not None else [r]
            deaths.extend(
                {"rank": g, "time_ms": t * ratio * 1e3} for g in members
            )
        deaths.sort(key=lambda d: (d["time_ms"], d["rank"]))
        result["faults"] = FaultOutcome(
            applied_events=len(faults.events),
            completed=not deaths,
            deaths=deaths,
        ).to_dict()
    if plan is not None:
        result["reduction"] = {
            "world_size": plan.world_size,
            "n_classes": plan.n_classes,
            "engine_events": engine.num_events,
            "max_class_size": max(plan.weights),
        }
    annotations = None
    if rec is not None:
        from simumax_tpu_torch.observe.critpath import analyze, diverge

        if plan is not None:
            rank_map = plan.reps
            weights = plan.weights
            stages = plan.stages

            def stage_of(r):
                return stages[r]
        elif world_ranks:
            from simumax_tpu_torch.parallel.mesh import rank_coords

            world_stages = [
                rank_coords(r, st)["pp"] for r in range(st.world_size)
            ]
            rank_map = weights = None

            def stage_of(r):
                return world_stages[r]
        else:
            rank_map = weights = None

            def stage_of(r):
                return r  # merged mode: one engine rank per pp stage
        report, annotations = analyze(
            rec, raw_end, straggle_ratio=ratio, rank_map=rank_map,
            weights=weights, stage_of=stage_of,
            # share the analytical anchor stage so the two waterfalls'
            # compute-vs-bubble split diverges only on model drift
            ref_stage=perf.analysis_cost()["binding_stage_rs"],
            meta={
                "model": perf.model_config.model_name,
                "system": perf.system.sys_name,
                "world_size": st.world_size,
                "mode": ("reduced" if plan is not None
                         else "world" if world_ranks else "merged"),
                "granularity": granularity,
                "faulted": fault_model is not None,
            },
        )
        # top=32 matches the slack-sample depth so the CLI's --top can
        # go deeper than diverge()'s display default without the saved
        # report silently capping the op table
        report["divergence"] = diverge(perf, report, top=32)
        result["critical_path"] = report
    if do_memory:
        result["memory"] = [t.summary() for t in trackers]
        for t in trackers:
            leftover = t.outstanding_tokens()
            assert not leftover, (
                f"stage {t.rank}: unfreed activation tokens {leftover}"
            )
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        trace_path = os.path.join(save_path, "trace.json")
        if sink is not None:
            # streamed events already left the process: the trace stays
            # un-annotated (the critpath report still lands below —
            # only the bounded skeleton was retained)
            sink.close(trackers if do_memory else None)
        else:
            write_chrome_trace(
                trace_path, engine.events, trackers if do_memory else None,
                annotations=annotations,
            )
        result["trace_path"] = trace_path
        if rec is not None:
            from simumax_tpu_torch.observe.critpath import save_report

            result["critical_path_path"] = save_report(
                result["critical_path"],
                os.path.join(save_path, "critpath.json"),
            )
        if do_memory:
            snaps = [t.snapshot() for t in trackers]
            with open(
                os.path.join(save_path, "simu_memory_snapshot.json"), "w"
            ) as f:
                json.dump(snaps, f)
            # torch memory-viz parity artifact (pytorch.org/memory_viz):
            # rank 0's per-op alloc/free trace (reference
            # simu_memory.py:212-556 pickle analog)
            from simumax_tpu_torch.simulator.memory import export_memory_viz

            result["memory_viz_path"] = export_memory_viz(
                trackers[0],
                os.path.join(save_path, "memory_viz_snapshot.pickle"),
            )
            try:
                from simumax_tpu_torch.simulator.plot import plot_memory_timeline

                result["memory_plot"] = plot_memory_timeline(
                    snaps,
                    os.path.join(save_path, "memory_timeline.png"),
                    hbm_gib=perf.system.accelerator.mem_gbs,
                )
            except ImportError:
                pass
    if save_path:
        with open(os.path.join(save_path, "simu_result.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def analyze_stragglers(
    perf,
    slow_ranks: dict,
    granularity: str = "chunk",
    reduce="auto",
) -> dict:
    """Quantify the iteration-time impact of per-rank slowdowns
    ({rank: multiplier}) by replaying the schedule with every global
    rank simulated. Returns baseline/perturbed times, the realized
    inflation, and the reference-style closed-form ratio for
    comparison. Symmetry reduction (``reduce``) applies to both runs —
    the perturbed run automatically shatters only the classes the
    stragglers touch."""
    base = run_simulation(
        perf, None, granularity=granularity, world_ranks=True, reduce=reduce
    )
    slow = run_simulation(
        perf, None, granularity=granularity, world_ranks=True,
        perturbation=slow_ranks, reduce=reduce,
    )
    return {
        "baseline_ms": base["end_time_ms"],
        "perturbed_ms": slow["end_time_ms"],
        "inflation": slow["end_time"] / base["end_time"],
        #: naive serial expectation: the worst single multiplier (what
        #: you'd get if the slow rank gated everything); the simulated
        #: inflation shows how much the schedule actually absorbs
        "worst_multiplier": max(slow_ranks.values(), default=1.0),
        "slow_ranks": slow_ranks,
    }

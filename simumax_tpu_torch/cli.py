"""Command-line surface (L8).

Reference user surfaces: 18 example scripts + the Streamlit app
(``app/streamlit_app.py``). The CLI covers the same workflows
non-interactively::

    python -m simumax_tpu_torch list
    python -m simumax_tpu_torch perf --model llama3-8b \
        --strategy tp1_pp2_dp4_mbs1 --system tpu_v5e_256 \
        [--simulate DIR [--world-ranks] [--reduce auto|on|off] \
         [--stream-trace]]
    python -m simumax_tpu_torch search --model llama3-8b --system tpu_v5p_256 \
        --world 64 --gbs 128 --tp 1,2,4,8 --pp 1,2,4 [--csv sweep.csv]
    python -m simumax_tpu_torch calibrate --model ... --strategy ... \
        --system ... --save my_system.json      # needs the CUDA card
    python -m simumax_tpu_torch straggler --model ... --strategy ... \
        --system ... --ranks 0:1.2,5:1.5        # per-rank slowdowns

Resilience surface (see ``docs/diagnostics.md``): ``perf`` / ``search``
/ ``calibrate`` accept ``--diagnostics PATH`` (write the JSON report)
and ``--strict`` (exit 3 on any warning / efficiency miss / quarantined
failure); ``search`` additionally takes ``--journal`` / ``--resume``
(JSONL sweep checkpointing), ``--candidate-timeout``, ``--jobs N``
(process-pool cell evaluation, default ``os.cpu_count()``) and
``--no-prune`` (see ``docs/search.md``). Config-family errors exit 2
with a one-line message instead of a traceback.

Fault/goodput surface (see ``docs/faults.md``): ``perf --simulate``
takes ``--faults SCENARIO.json`` (timed rank slowdowns, preemptions,
link degradation, rank deaths injected into the simulated step);
``faults`` predicts the goodput waterfall of a scenario over its job
horizon (``--scenario``) or Monte-Carlos the failure space for the
optimal checkpoint interval (``--monte-carlo N --seed S``);
``fleet`` walks a multi-job arrival trace over a shared pod fleet
(docs/fleet.md) for fleet-wide goodput, per-job SLO attainment, and
the scheduler-decision timeline. ``SimulationError`` escaping any
command exits 3 with a one-line message (the full engine dump goes to
``--diagnostics``).

Observability surface (see ``docs/observability.md``): ``explain``
renders the MFU-loss waterfall + top-N op table from the
cost-attribution ledger (``--json`` saves the full ledger, ``--csv``
the op table, ``--trace`` a Chrome trace of the analytical schedule);
``explain --memory`` renders the peak-HBM waterfall + per-tensor
holder table from the memory ledger, with OOM forensics (top holders +
what-if probes naming the cheapest fitting change) for non-fitting
configs, ``--crosscheck`` for the analytical-vs-DES per-stage peak
comparison, and ``--mem-artifacts DIR`` for the analytical memory
timeline in the simulator's artifact formats; ``critical-path`` runs
the discrete-event simulator with the event-dependency skeleton
recorded and reports per-event slack, the simulated critical-path
waterfall (buckets sum to the DES makespan), sim-vs-analytical
divergence and per-rank/per-link slack headroom (``perf --simulate
--critical-path`` attaches the same report to a perf run); ``diff``
compares two saved ledgers (``--memory`` for memory ledgers,
``--critical-path`` for critical-path reports). Every subcommand
accepts ``--log-level`` and ``--log-json`` (structured JSONL lines
with a run_id instead of the human format).

Service surface (see ``docs/service.md``): ``perf`` / ``explain`` /
``search`` route through the ``Planner`` facade and its persistent
content-addressed result cache by default (``--cache-dir`` /
``--no-cache``; output is bit-identical either way, sweeps re-evaluate
only cells missing from the store); ``serve`` runs the long-lived
JSON-over-HTTP planning server sharing the same cache; ``cache``
inspects/maintains it (``stats`` / ``ls`` / ``verify`` / ``clear``).

Copy of the JAX package's ``cli.py`` with its import paths changed, the
program named ``simumax_tpu_torch`` where a line names it (``prog``,
the ``list`` hint, the ``explain`` calibration hint, help text), and
these differences; every other output line, exit code and option is
the JAX CLI's:

* ``--device {cuda,cpu}`` (default ``cuda``) on every subcommand whose
  work can reach the card: ``perf``, ``explain``, ``search``,
  ``calibrate``, ``faults``, ``fleet`` and ``serve``. It goes to every
  port API that takes ``device``: the ``Planner``, the strategy search
  and ``save_batched_profiles``, ``ReplayOptions`` of the fault replay
  and the fleet walk, ``calibrate_system`` and
  ``calibrate_bandwidth_classes``, ``WorkerPool`` and ``make_server``.
  Under ``cuda`` the replay and fold kernels run on the card and
  ``calibrate`` measures there; ``cpu`` runs the kernels' plain
  versions (and the calibration's measurements refuse it).
* Without a card, ``--device cuda`` stops before any work with the
  port's own error (:class:`~simumax_tpu_torch.core.errors.
  CardRequiredError`) as one ``error:`` line and exit code
  :data:`EXIT_DEVICE`; so does a card-only step asked to run on the
  CPU. Nothing carries on on the CPU. The check counts cards with
  :func:`_device_count`, which reads NVML and leaves CUDA
  uninitialised, so the workers and nodes forked after it can still use
  the card.
* ``calibrate --collectives`` counts devices with :func:`_device_count`
  (``torch.cuda.device_count()`` under ``cuda``, 1 under ``cpu``) in
  place of ``jax.devices()``, and with two or more runs
  ``collective_bench.sweep_axis`` on that many ranks started by
  ``torchref.parallel.spawn`` (NCCL with a card a rank, gloo on the
  CPU) in place of a ``make_mesh`` axis; rank 0's fit is written back.
* ``search --jobs`` defaults to ``os.cpu_count()`` as in the JAX CLI,
  except under ``--engine batched --device cuda``, where it defaults to
  1: there the fold kernel is the sweep's parallelism, every pool worker
  would build a CUDA context of its own on the one card, and once the
  parent's context is live (the guided screen folds in the parent) the
  workers are spawned, each importing torch anew. A sweep's rows do not
  depend on ``--jobs``.

The ``docs/`` this module names are the JAX package's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

#: exit codes: 2 = bad config / usage, 3 = --strict violation or a
#: simulation-invariant failure (SimulationError family — the schedule
#: replay itself is wedged, not the user's configuration)
EXIT_CONFIG = 2
EXIT_STRICT = 3
EXIT_SIMULATION = 3
#: the card a command was to run on is missing (or a card-only step was
#: asked to run on the CPU)
EXIT_DEVICE = 1


def _ints(s: str):
    return tuple(int(x) for x in s.split(","))


def _device_count(device: str) -> int:
    """Devices a command on ``device`` can use: the CUDA cards
    (``torch.cuda.device_count()``, read through NVML, so CUDA stays
    uninitialised and a later fork can still use the card), or 1 for
    the CPU."""
    if device == "cpu":
        return 1
    import torch

    return torch.cuda.device_count()


def _require_device(args):
    """Stop a ``--device cuda`` command before any work when this
    machine has no card, with the port's own error."""
    device = getattr(args, "device", None)
    if device == "cuda" and _device_count(device) < 1:
        from simumax_tpu_torch.torchref.model import resolve_device

        resolve_device(device)


def _log():
    from simumax_tpu_torch.observe.report import get_reporter

    return get_reporter()


def _emit_diagnostics(diag, args):
    """Emit the diagnostics report — also on the failure path (a run
    that aborted is exactly the run the report must explain).

    Writes the JSON to ``--diagnostics PATH`` when given (a compact
    summary goes to stdout), otherwise prints the full report as one
    ``[diagnostics]``-prefixed JSON line."""
    if not diag.run_id:
        # commands that never compute a content identity (perf,
        # calibrate, dualpp, straggler) still get one joinable id:
        # adopt the process reporter's, so --log-json lines and this
        # report cross-reference by run_id like explain/search do
        diag.adopt_run_id(_log().run_id)
    path = getattr(args, "diagnostics", None)
    if path:
        diag.write(path)
        _log().info(f"[diagnostics] {diag.summary_line()} -> {path}",
                    event="diagnostics", path=path)
    else:
        _log().info("[diagnostics] "
                    + json.dumps(diag.to_dict(), separators=(",", ":")),
                    event="diagnostics")


def _check_strict(diag, args):
    if getattr(args, "strict", False):
        violations = diag.violations()
        if violations:
            print(
                "error: strict mode: " + ", ".join(violations),
                file=sys.stderr,
            )
            sys.exit(EXIT_STRICT)


@contextlib.contextmanager
def _diagnosed(diag, args):
    """Run a command body with the report guaranteed on exit: a fatal
    ``SimuMaxError`` is recorded as the report's final error, the report
    is emitted in a ``finally`` (so aborts still produce it — a failed
    emit must not mask the real failure), then ``--strict`` is enforced
    only when the body itself succeeded — a failing body already
    carries its own exit code."""
    from simumax_tpu_torch.core.errors import SimuMaxError

    try:
        yield
    except SimuMaxError as exc:
        diag.record_exception(exc, category="fatal")
        raise
    finally:
        try:
            _emit_diagnostics(diag, args)
        except OSError as exc:
            print(f"warning: could not write diagnostics report: {exc}",
                  file=sys.stderr)
    _check_strict(diag, args)


@contextlib.contextmanager
def _traced(args, name):
    """Run a command body under a root telemetry trace when
    ``--trace-requests PATH`` was given: span recording is armed, the
    body's spans (planner store lookups, single-flight waits,
    evaluations, sweep cells, DES replays) nest under one root span,
    and on exit the span tree is dumped to ``PATH`` (JSON) plus a
    Chrome-trace rendering at ``PATH.chrome.json`` for the trace
    viewer. Without the flag this is a no-op — no ids, no records."""
    path = getattr(args, "trace_requests", None)
    if not path:
        yield
        return
    from simumax_tpu_torch.observe.telemetry import (
        get_tracer,
        span_tree,
        write_chrome_trace,
    )

    tracer = get_tracer()
    was_enabled = tracer.enabled
    tracer.configure(enabled=True)
    trace_id = None
    try:
        with tracer.trace(name) as trace_id:
            yield
    finally:
        # dump inside the finally: a command that raises mid-run is
        # exactly the one whose span tree is wanted, and the drain
        # must happen regardless or the recorded spans leak into the
        # next _traced command in this process
        tracer.configure(enabled=was_enabled)
        spans = tracer.drain()
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump({"trace_id": trace_id, "command": name,
                           "spans": span_tree(spans)}, f, indent=1,
                          default=str)
            chrome = path + ".chrome.json"
            write_chrome_trace(spans, chrome)
        except OSError as exc:  # never mask the command's own error
            _log().warning(
                f"[trace] could not write {path}: {exc}",
                event="trace_requests_error", path=path,
            )
        else:
            _log().info(
                f"[trace] {len(spans)} spans (trace {trace_id}) -> "
                f"{path} (+ {chrome})",
                event="trace_requests", spans=len(spans),
                trace_id=trace_id, path=path,
            )


def cmd_list(args):
    from simumax_tpu_torch.core.config import list_configs

    log = _log()
    for kind, names in list_configs().items():
        log.info(f"{kind}:", event="config_kind", kind=kind)
        for n in names:
            log.info(f"  {n}", event="config_name", kind=kind, name=n)


def _load_scenario(args, world_ranks):
    """Load ``--faults`` (when given) and apply the world-ranks
    implication: rank-scoped faults need every rank simulated. Returns
    ``(scenario, world_ranks)`` — shared by ``perf --simulate`` and
    ``critical-path`` so the implication rule cannot diverge."""
    if not args.faults:
        return None, world_ranks
    from simumax_tpu_torch.simulator.faults import FaultScenario

    scenario = FaultScenario.from_json(args.faults)
    if not scenario.empty and not world_ranks:
        world_ranks = True
        _log().info(
            "[faults] scenario implies --world-ranks",
            event="faults_world_ranks",
        )
    return scenario, world_ranks


def _cache_enabled(args) -> bool:
    """Whether this invocation uses the persistent planner cache:
    default on, killed by ``--no-cache`` or ``SIMUMAX_TPU_NO_CACHE``."""
    return not (
        getattr(args, "no_cache", False)
        or os.environ.get("SIMUMAX_TPU_NO_CACHE")
    )


def _make_planner(args):
    from simumax_tpu_torch.service.planner import Planner

    return Planner(cache_dir=getattr(args, "cache_dir", None),
                   device=args.device)


def cmd_perf(args):
    with _traced(args, "perf"):
        return _cmd_perf(args)


def _cmd_perf(args):
    # artifact-producing runs (--save/--simulate/--graph) need the
    # built PerfLLM; everything else is a pure function of the configs
    # and routes through the planner so one-shot CLI calls populate
    # (and hit) the same persistent cache the server reads
    if _cache_enabled(args) and not (
        args.save or args.simulate or args.graph
    ):
        return _cmd_perf_planner(args)
    from simumax_tpu_torch import PerfLLM

    perf = PerfLLM()
    perf.diagnostics.strict = args.strict
    with _diagnosed(perf.diagnostics, args):
        perf.configure(args.strategy, args.model, args.system)
        perf.run_estimate(capture_graph=args.graph)
        perf.analysis(save_path=args.save)
        if args.simulate:
            scenario, world_ranks = _load_scenario(
                args, args.world_ranks
            )
            with perf.diagnostics.capture(category="simulate"):
                result = perf.simulate(
                    args.simulate,
                    world_ranks=world_ranks,
                    reduce={"auto": "auto", "on": True,
                            "off": False}[args.reduce],
                    stream_trace=args.stream_trace,
                    faults=scenario,
                    critical_path=args.critical_path,
                )
            outcome = result.get("faults")
            if outcome:
                deaths = ", ".join(
                    f"rank {d['rank']} @ {d['time_ms']:.1f} ms"
                    for d in outcome["deaths"]
                ) or "none"
                _log().info(
                    f"faults: {outcome['applied_events']} events, "
                    f"completed={outcome['completed']}, deaths: {deaths}",
                    event="fault_outcome",
                    completed=outcome["completed"],
                    deaths=len(outcome["deaths"]),
                )
            reduction = result.get("reduction")
            extra = (
                f" ({reduction['n_classes']} symmetry classes for "
                f"{reduction['world_size']} ranks)" if reduction else ""
            )
            _log().info(
                f"simulated: {result['end_time_ms']:.2f} ms, "
                f"{result['num_events']} events{extra}, "
                f"trace at {result.get('trace_path')}",
                event="simulate", end_time_ms=result["end_time_ms"],
                num_events=result["num_events"],
                trace_path=result.get("trace_path"),
            )
            report = result.get("critical_path")
            if report:
                from simumax_tpu_torch.observe.critpath import waterfall_lines

                for line in waterfall_lines(report):
                    _log().info(line, event="critpath_waterfall")
                if result.get("critical_path_path"):
                    _log().info(
                        f"critical-path report -> "
                        f"{result['critical_path_path']}",
                        event="critpath_report",
                        path=result["critical_path_path"],
                    )


def _cmd_perf_planner(args):
    """`perf` through the Planner facade: content-addressed persistent
    caching with byte-identical output (``docs/service.md``)."""
    from simumax_tpu_torch.core.records import Diagnostics
    from simumax_tpu_torch.perf import print_summary
    from simumax_tpu_torch.service.planner import replay_coverage

    diag = Diagnostics(strict=args.strict)
    with _diagnosed(diag, args):
        planner = _make_planner(args)
        with diag.activate():
            payload, meta = planner.estimate(
                args.model, args.strategy, args.system, with_meta=True
            )
        # cached payloads carry the estimate's efficiency coverage, so
        # --strict and the diagnostics report behave identically
        # whether the answer was computed or served
        replay_coverage(diag, payload.get("efficiency_hits") or {},
                        payload.get("efficiency_misses") or {})
        _log().debug(
            f"[cache] estimate {meta['cache']} "
            f"(key {meta['key'][:16]}…)",
            event="cache_lookup", cache=meta["cache"], key=meta["key"],
        )
        print_summary(payload)


def cmd_search(args):
    from simumax_tpu_torch.core.records import Diagnostics

    diag = Diagnostics(strict=args.strict)
    with _traced(args, "search"), _diagnosed(diag, args):
        _run_search(args, diag)


def _run_search(args, diag):
    from simumax_tpu_torch.core.config import (
        get_model_config,
        get_strategy_config,
        get_system_config,
    )
    from simumax_tpu_torch.search import search_best_parallel_strategy

    with diag.capture(category="config"):
        model = get_model_config(args.model)
        system = get_system_config(args.system)
        base = get_strategy_config(args.base_strategy)
    if args.world:
        base.world_size = args.world
    if args.seq_len:
        base.seq_len = args.seq_len
    zero_list = _ints(args.zero)
    bad = [z for z in zero_list if z not in (0, 1, 2, 3)]
    if bad:
        raise SystemExit(
            f"invalid --zero levels {bad}: expected a comma list of "
            "0-3 (e.g. --zero 1,3)"
        )
    # --resume without an explicit --journal extends the same journal,
    # so repeated interrupted runs keep one continuous checkpoint
    journal_path = args.journal or args.resume
    if args.jobs is not None and args.jobs < 1:
        raise SystemExit(
            f"invalid --jobs {args.jobs}: expected a positive worker "
            f"count (1 = serial; omit for os.cpu_count())"
        )
    if args.jobs:
        jobs = args.jobs
    elif args.engine == "batched" and args.device == "cuda":
        # the folds run on the one card: no pool (module docstring)
        jobs = 1
    else:
        jobs = os.cpu_count() or 1
    # persistent per-cell cache: overlapping grids (across runs,
    # processes, and the serve server) only evaluate the delta cells
    store = None
    profiles_key = None
    if _cache_enabled(args):
        from simumax_tpu_torch.service.store import ContentStore

        store = ContentStore(getattr(args, "cache_dir", None))
        if args.engine == "batched":
            from simumax_tpu_torch.service.planner import (
                batched_profiles_key,
                load_batched_profiles,
            )

            # key pinned pre-sweep: evaluations mutate the model
            profiles_key = batched_profiles_key(model, system)
            n = load_batched_profiles(store, model, system,
                                      key=profiles_key)
            if n:
                _log().debug(
                    f"[cache] seeded {n} block-kind profiles",
                    event="cache_profiles", profiles=n,
                )
    with diag.capture(category="search"):
        rows = search_best_parallel_strategy(
            base, model, system, args.gbs,
            tp_list=_ints(args.tp), pp_list=_ints(args.pp),
            ep_list=_ints(args.ep), cp_list=_ints(args.cp),
            zero_list=zero_list,
            topk=args.topk, csv_path=args.csv, verbose=args.verbose,
            project_dualpp=args.dualpp,
            candidate_timeout=args.candidate_timeout,
            journal_path=journal_path,
            resume=args.resume,
            diagnostics=diag,
            jobs=jobs,
            prune=not args.no_prune,
            simulate=args.simulate_check,
            engine=args.engine,
            verify_topk=args.verify_topk,
            store=store,
            search_mode="guided" if args.guided else "grid",
            device=args.device,
        )
    if store is not None and args.engine == "batched":
        from simumax_tpu_torch.service.planner import save_batched_profiles

        save_batched_profiles(store, model, system, key=profiles_key,
                              device=args.device)
    counters = diag.counters
    if counters.get("sweep_cells_cached"):
        _log().info(
            f"[sweep] served {int(counters['sweep_cells_cached'])}/"
            f"{int(counters['sweep_cells_total'])} cells from the "
            f"planner cache (status=cached rows in the CSV; --no-cache "
            f"to re-evaluate)",
            event="sweep_cached",
            cached=int(counters["sweep_cells_cached"]),
            total=int(counters["sweep_cells_total"]),
        )
    if counters.get("sweep_cells_pruned"):
        _log().info(
            f"[sweep] pruned {int(counters['sweep_cells_pruned'])}/"
            f"{int(counters['sweep_cells_total'])} cells before "
            f"evaluation (status=pruned rows in the CSV; --no-prune to "
            f"evaluate everything)",
            event="sweep_pruned",
            pruned=int(counters["sweep_cells_pruned"]),
            total=int(counters["sweep_cells_total"]),
        )
    for r in rows:
        dual = ""
        if r.get("dualpp_mfu") is not None:
            fits = "fits" if r["dualpp_fits"] else "OOM"
            dual = f"  [DualPipe: {r['dualpp_mfu']*100:.2f}% {fits}]"
        _log().info(
            f"tp{r['tp']} cp{r['cp']} ep{r['ep']} pp{r['pp']} dp{r['dp']} "
            f"z{r['zero']} mbs{r['mbs']} mbc{r['mbc']} {r['recompute']}: "
            f"MFU {r['mfu']*100:.2f}%  iter {r['iter_ms']:.0f} ms  "
            f"peak {r['peak_gib']:.1f} GiB"
            + (f"  [DCN: {r['dcn_dims']}]" if r.get("dcn_dims") else "")
            + dual,
            event="search_row", mfu=r["mfu"], iter_ms=r["iter_ms"],
            attribution=r.get("attribution"),
        )


def cmd_calibrate(args):
    from simumax_tpu_torch import PerfLLM

    perf = PerfLLM()
    perf.diagnostics.strict = args.strict
    with _diagnosed(perf.diagnostics, args):
        _run_calibrate(args, perf)


def _run_calibrate(args, perf):
    from simumax_tpu_torch.calibration import calibrate_system

    perf.configure(args.strategy, args.model, args.system)
    perf.run_estimate()
    if args.bandwidth:
        from simumax_tpu_torch.calibration.autocal import calibrate_bandwidth_classes

        calibrate_bandwidth_classes(
            perf.system, verbose=True,
            vocab=perf.model_config.padded_vocab_size,
            device=args.device,
        )
    if args.collectives:
        from simumax_tpu_torch.calibration.collective_bench import (
            sweep_axis,
            update_system_from_sweep,
        )
        from simumax_tpu_torch.torchref.parallel import spawn

        n = _device_count(args.device)
        if n < 2:
            _log().info("[cal] collectives: need >1 device, skipping",
                        event="calibrate")
        else:
            # every rank returns the same fit (a sample is the slowest
            # rank's); rank 0's is written back
            sweep = spawn(n, args.device, sweep_axis, None)[0]
            update_system_from_sweep(perf.system, n, sweep)
            for op, fit in sweep.items():
                _log().info(
                    f"[cal] {op}: {fit['fitted_bw_gbps']:.1f} GB/s, "
                    f"{fit['fitted_latency_us']:.1f} us",
                    event="calibrate_collective", op=op,
                )
    measured = calibrate_system(
        perf, save_path=args.save, max_keys=args.max_keys, verbose=True,
        diagnostics=perf.diagnostics, device=args.device,
    )
    n = sum(len(v) for v in measured.values())
    _log().info(f"calibrated {n} shape keys"
                + (f"; wrote {args.save}" if args.save else ""),
                event="calibrate_done", keys=n, save=args.save)
    perf.analysis()


def cmd_explain(args):
    # the memory/trace/crosscheck surfaces need the built PerfLLM; the
    # step-time ledger is a pure function of the configs and rides the
    # persistent planner cache
    if _cache_enabled(args) and not (
        args.memory or args.trace or args.crosscheck
        or args.mem_artifacts
    ):
        return _cmd_explain_planner(args)
    from simumax_tpu_torch import PerfLLM

    perf = PerfLLM()
    perf.diagnostics.strict = args.strict
    with _diagnosed(perf.diagnostics, args):
        _run_explain(args, perf)


def _cmd_explain_planner(args):
    """`explain` through the Planner facade: the cached payload carries
    the full ledger dict plus the aggregated op rows, rendered by the
    same functions the live Ledger uses."""
    import csv as _csv

    from simumax_tpu_torch.core.records import Diagnostics
    from simumax_tpu_torch.observe.ledger import (
        top_op_lines_from_rows,
        waterfall_lines_from_dict,
    )
    from simumax_tpu_torch.service.planner import replay_coverage

    diag = Diagnostics(strict=args.strict)
    with _diagnosed(diag, args):
        planner = _make_planner(args)
        with diag.activate():
            payload, meta = planner.explain(
                args.model, args.strategy, args.system, with_meta=True
            )
        led = payload["ledger"]
        replay_coverage(diag, led["efficiency"].get("hits") or {},
                        led["efficiency"].get("misses") or {})
        log = _log()
        log.debug(
            f"[cache] explain {meta['cache']} "
            f"(key {meta['key'][:16]}…)",
            event="cache_lookup", cache=meta["cache"], key=meta["key"],
        )
        for line in waterfall_lines_from_dict(led):
            log.info(line, event="waterfall")
        for line in top_op_lines_from_rows(payload["op_rows"], args.top):
            log.info(line, event="top_ops")
        miss = led["efficiency"]["miss_count"]
        if miss:
            log.info(
                f"[calibration] {miss} efficiency-table misses "
                f"contribute to these rows (MISS); `simumax_tpu_torch "
                f"calibrate` refines them",
                event="explain_misses", misses=miss,
            )
        if args.json:
            with open(args.json, "w", encoding="utf-8") as f:
                json.dump(led, f, indent=1)
            log.info(f"ledger -> {args.json}", event="explain_ledger",
                     path=args.json, run_id=led["meta"]["run_id"])
        if args.csv:
            rows = payload["op_rows"]
            fields = [
                "path", "category", "module_type", "stage", "chunk",
                "fwd_time", "bwd_time", "net_exposed_time",
                "net_hidden_time", "time", "share", "flops",
                "bytes_accessed", "efficiency", "calibrated", "regime",
                "recompute",
            ]
            with open(args.csv, "w", newline="") as f:
                w = _csv.DictWriter(f, fieldnames=fields,
                                    extrasaction="ignore")
                w.writeheader()
                w.writerows(rows)
            log.info(f"op table -> {args.csv}", event="explain_csv",
                     path=args.csv, rows=len(rows))


def _run_explain(args, perf):
    import csv as _csv

    from simumax_tpu_torch.observe.trace import write_analytical_trace

    log = _log()
    if (args.crosscheck or args.mem_artifacts) and not args.memory:
        # silently ignoring these would let the user believe the
        # cross-check ran clean when it never ran at all
        raise SystemExit(
            "error: --crosscheck/--mem-artifacts require --memory "
            "(they explain the peak-HBM prediction, not the step time)"
        )
    perf.configure(args.strategy, args.model, args.system)
    perf.run_estimate()
    if args.memory:
        return _run_explain_memory(args, perf)
    led = perf.ledger()
    for line in led.waterfall_lines():
        log.info(line, event="waterfall")
    for line in led.top_op_lines(args.top):
        log.info(line, event="top_ops")
    miss = led.efficiency["miss_count"]
    if miss:
        log.info(
            f"[calibration] {miss} efficiency-table misses contribute to "
            f"these rows (MISS); `simumax_tpu_torch calibrate` refines them",
            event="explain_misses", misses=miss,
        )
    if args.json:
        led.save(args.json)
        log.info(f"ledger -> {args.json}", event="explain_ledger",
                 path=args.json, run_id=led.meta["run_id"])
    if args.csv:
        rows = led.op_rows()
        fields = [
            "path", "category", "module_type", "stage", "chunk",
            "fwd_time", "bwd_time", "net_exposed_time", "net_hidden_time",
            "time", "share", "flops", "bytes_accessed", "efficiency",
            "calibrated", "regime", "recompute",
        ]
        with open(args.csv, "w", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
        log.info(f"op table -> {args.csv}", event="explain_csv",
                 path=args.csv, rows=len(rows))
    if args.trace:
        write_analytical_trace(perf, args.trace)
        log.info(
            f"analytical Chrome trace -> {args.trace} "
            f"(load in chrome://tracing or ui.perfetto.dev)",
            event="explain_trace", path=args.trace,
        )


def _run_explain_memory(args, perf):
    """`explain --memory`: peak-HBM waterfall + top holders from the
    per-tensor memory ledger, OOM forensics (incl. the what-if probe
    table) for non-fitting configs, and the analytical memory-timeline
    artifacts."""
    import csv as _csv

    from simumax_tpu_torch.observe.memledger import (
        export_analytical_memory,
        oom_forensic_lines,
        oom_forensics,
    )

    log = _log()
    # the timeline snapshots only ship inside the --json artifact; skip
    # building them otherwise
    led = perf.memory_ledger(timeline=bool(args.json))
    for line in led.waterfall_lines():
        log.info(line, event="mem_waterfall")
    if led.headline["fits"]:
        for line in led.top_holder_lines(args.top):
            log.info(line, event="mem_top_holders")
    else:
        # the forensics block prints the same binding-stage top holders
        # — one list, not two copies of it
        report = oom_forensics(perf, top=args.top, probes=True,
                               spans=led.spans)
        for line in oom_forensic_lines(report):
            log.info(line, event="mem_forensics")
    if args.crosscheck:
        res = perf.memory_crosscheck()
        for r in res["stages"]:
            log.info(
                f"  stage {r['stage']}: analytical "
                f"{r['analytical_peak_gib']:.2f} GiB vs DES "
                f"{r['des_peak_gib']:.2f} GiB "
                f"(ratio {r['des_vs_analytical']:.4f})",
                event="mem_crosscheck", stage=r["stage"],
                ratio=r["des_vs_analytical"],
            )
    if args.json:
        led.save(args.json)
        log.info(f"memory ledger -> {args.json}",
                 event="explain_mem_ledger", path=args.json,
                 run_id=led.meta["run_id"])
    if args.csv:
        rows = led.span_rows()
        fields = [
            "path", "bucket", "kinds", "category", "module_type",
            "stage", "chunk", "bytes", "share", "count", "shape",
            "dtype", "sharding",
        ]
        with open(args.csv, "w", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
        log.info(f"holder table -> {args.csv}", event="explain_mem_csv",
                 path=args.csv, rows=len(rows))
    if args.mem_artifacts:
        paths = export_analytical_memory(perf, args.mem_artifacts)
        log.info(
            f"analytical memory timeline -> {paths['snapshot']}, "
            f"memory-viz pickle -> {paths['memory_viz']} "
            f"(load at pytorch.org/memory_viz), counter trace -> "
            f"{paths['counters']}",
            event="explain_mem_artifacts", **paths,
        )
    if args.trace:
        from simumax_tpu_torch.observe.trace import write_analytical_trace

        write_analytical_trace(perf, args.trace)
        log.info(
            f"analytical Chrome trace -> {args.trace} "
            f"(hbm_bytes counter tracks included)",
            event="explain_trace", path=args.trace,
        )


def cmd_diff(args):
    from simumax_tpu_torch.observe.critpath import (
        diff_critpath,
        format_critpath_diff_lines,
        load_report,
    )
    from simumax_tpu_torch.observe.ledger import (
        Ledger,
        diff_ledgers,
        format_diff_lines,
    )
    from simumax_tpu_torch.observe.memledger import (
        MemoryLedger,
        diff_memory_ledgers,
        format_memory_diff_lines,
    )

    if sum(map(bool, (args.memory, args.critical_path,
                      args.fleet))) > 1:
        raise SystemExit(
            "error: --memory, --critical-path and --fleet are "
            "exclusive (pick the ledger family the inputs belong to)"
        )

    def load_fleet_report(path):
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    # fleet reports are self-describing (schema simumax-fleet-v1):
    # auto-detect when no family flag narrows the choice
    fleet = args.fleet
    if not (args.memory or args.critical_path or fleet):
        try:
            fleet = all(
                isinstance(r, dict)
                and r.get("schema") == "simumax-fleet-v1"
                for r in (load_fleet_report(args.ledger_a),
                          load_fleet_report(args.ledger_b))
            )
        except (OSError, ValueError, json.JSONDecodeError):
            fleet = False
    if fleet:
        loader = load_fleet_report
    elif args.critical_path:
        loader = load_report
    elif args.memory:
        loader = MemoryLedger.load
    else:
        loader = Ledger.load
    try:
        a = loader(args.ledger_a)
        b = loader(args.ledger_b)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        raise SystemExit(f"error: {exc}")
    if fleet:
        from simumax_tpu_torch.core.errors import ConfigError
        from simumax_tpu_torch.observe.fleetledger import (
            diff_fleet_reports,
            format_fleet_diff_lines,
        )

        try:
            d = diff_fleet_reports(a, b, top=args.top)
        except ConfigError as exc:
            raise SystemExit(f"error: {exc}")
        lines = format_fleet_diff_lines(d, top=args.top)
    elif args.critical_path:
        d = diff_critpath(a, b, top=args.top)
        lines = format_critpath_diff_lines(d, top=args.top)
    elif args.memory:
        d = diff_memory_ledgers(a, b, top=args.top)
        lines = format_memory_diff_lines(d, top=args.top)
    else:
        d = diff_ledgers(a, b, top=args.top)
        lines = format_diff_lines(d, top=args.top)
    log = _log()
    for line in lines:
        log.info(line, event="diff")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(d, f, indent=1)
        log.info(f"diff report -> {args.json}", event="diff_report",
                 path=args.json)


def cmd_faults(args):
    from simumax_tpu_torch import PerfLLM

    perf = PerfLLM()
    perf.diagnostics.strict = args.strict
    with _diagnosed(perf.diagnostics, args):
        _run_faults(args, perf)


def _run_faults(args, perf):
    from simumax_tpu_torch.observe.ledger import (
        goodput_attribution_line,
        goodput_waterfall_lines,
    )
    from simumax_tpu_torch.simulator.faults import (
        CheckpointSpec,
        FaultScenario,
        ReplayOptions,
    )

    log = _log()
    options = ReplayOptions(device=args.device)
    perf.configure(args.strategy, args.model, args.system)
    perf.run_estimate()

    def build_spec(scenario=None):
        """Scenario checkpoint block as the base, explicit CLI flags
        on top (flags always win); None when neither says anything."""
        base = CheckpointSpec.from_overrides(
            scenario.checkpoint if scenario is not None else None
        )
        flags = {}
        if args.ckpt_interval:
            flags["interval_steps"] = args.ckpt_interval
        if args.restart_overhead is not None:
            flags["restart_overhead_s"] = args.restart_overhead
        if not flags and (scenario is None or not scenario.checkpoint):
            return None
        return CheckpointSpec.from_overrides(flags, base)
    if args.jobs is not None and args.jobs < 1:
        raise SystemExit(
            f"invalid --jobs {args.jobs}: expected a positive worker "
            f"count"
        )
    if args.monte_carlo:
        with perf.diagnostics.capture(category="faults"):
            res = perf.analyze_faults(
                n_scenarios=args.monte_carlo, seed=args.seed,
                horizon_steps=args.horizon or 50, spec=build_spec(),
                granularity=args.granularity,
                jobs=args.jobs or 0, incremental=not args.exact,
                options=options,
            )
        g = res["goodput"]
        log.info(
            f"goodput over {res['n_scenarios']} scenarios "
            f"(seed {res['seed']}, horizon {res['horizon_steps']} "
            f"steps): mean {g['mean']*100:.2f}%  "
            f"p10 {g['p10']*100:.2f}%  p50 {g['p50']*100:.2f}%  "
            f"p90 {g['p90']*100:.2f}%",
            event="faults_mc", mean_goodput=g["mean"],
        )
        for k in sorted(res["goodput_by_interval"]):
            v = res["goodput_by_interval"][k]
            log.info(
                f"  checkpoint every {k:4d} steps: mean goodput "
                f"{v*100:.2f}%",
                event="faults_interval", interval=k, goodput=v,
            )
        log.info(
            f"optimal checkpoint interval: {res['best_interval_steps']} "
            f"steps (Young-Daly closed form: "
            f"{res['young_daly_interval_steps']})",
            event="faults_optimal",
            best_interval=res["best_interval_steps"],
        )
        if args.json:
            with open(args.json, "w", encoding="utf-8") as f:
                json.dump(res, f, indent=1)
            log.info(f"analysis -> {args.json}", event="faults_json",
                     path=args.json)
        return
    if not args.scenario:
        raise SystemExit(
            "error: faults needs --scenario SCENARIO.json or "
            "--monte-carlo N"
        )
    scenario = FaultScenario.from_json(args.scenario)
    if args.horizon:
        scenario.horizon_steps = args.horizon
    with perf.diagnostics.capture(category="faults"):
        report = perf.predict_goodput(
            scenario, spec=build_spec(scenario),
            granularity=args.granularity,
            incremental=not args.exact, options=options,
        )
    for line in goodput_waterfall_lines(report):
        log.info(line, event="goodput_waterfall")
    log.info(goodput_attribution_line(report), event="goodput_line",
             goodput=report.goodput)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report.to_dict(), f, indent=1)
        log.info(f"goodput report -> {args.json}", event="faults_json",
                 path=args.json)


def cmd_fleet(args):
    """Multi-job fleet walk (docs/fleet.md): fleet goodput, per-job
    SLO attainment, scheduler-decision timeline — plus the causal
    goodput ledger / SLO counterfactuals / fleet Chrome trace under
    ``--explain`` / ``--chrome-trace`` (docs/fleet.md "Explaining a
    fleet run")."""
    from simumax_tpu_torch.fleet.report import fleet_report_lines

    log = _log()
    explain = bool(args.explain or args.chrome_trace)
    if args.naive or not _cache_enabled(args):
        # the naive baseline (and cache-off runs) walk directly; the
        # default path routes through the planner so repeated
        # capacity-planning queries hit the persistent store
        from simumax_tpu_torch.fleet.sim import simulate_fleet
        from simumax_tpu_torch.simulator.faults import ReplayOptions

        report = simulate_fleet(
            args.trace, jobs=args.jobs or 0, elastic=args.elastic,
            naive=args.naive, explain=explain,
            options=ReplayOptions(device=args.device),
        )
    else:
        planner = _make_planner(args)
        report, meta = planner.fleet(
            args.trace, jobs=args.jobs or 0, elastic=args.elastic,
            explain=explain, with_meta=True,
        )
        log.info(
            f"[cache {meta['cache']}] {meta['key'][:16]}",
            event="fleet_cache", cache=meta["cache"],
            key=meta["key"],
        )
    for line in fleet_report_lines(report, top_decisions=args.top):
        log.info(line, event="fleet")
    if explain:
        from simumax_tpu_torch.observe.fleetledger import fleet_explain_lines

        for line in fleet_explain_lines(report):
            log.info(line, event="fleet_explain")
    if args.chrome_trace:
        from simumax_tpu_torch.observe.fleetledger import write_fleet_trace

        write_fleet_trace(report, args.chrome_trace)
        log.info(
            f"fleet Chrome trace -> {args.chrome_trace} (pods as "
            f"pids, job lanes, causal flow arrows, goodput/"
            f"utilization counters)",
            event="fleet_trace", path=args.chrome_trace,
        )
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
        log.info(f"fleet report -> {args.json}", event="fleet_json",
                 path=args.json)


def cmd_critpath(args):
    from simumax_tpu_torch import PerfLLM

    perf = PerfLLM()
    perf.diagnostics.strict = args.strict
    with _diagnosed(perf.diagnostics, args):
        _run_critpath(args, perf)


def _run_critpath(args, perf):
    from simumax_tpu_torch.observe.critpath import (
        divergence_lines,
        headroom_lines,
        save_report,
        waterfall_lines,
    )

    log = _log()
    perf.configure(args.strategy, args.model, args.system)
    perf.run_estimate()
    scenario, world_ranks = _load_scenario(args, args.world_ranks)
    with perf.diagnostics.capture(category="simulate"):
        result = perf.simulate(
            args.save,
            granularity=args.granularity,
            world_ranks=world_ranks,
            reduce={"auto": "auto", "on": True, "off": False}[args.reduce],
            faults=scenario,
            critical_path=True,
            track_memory=False,
        )
    report = result["critical_path"]
    for line in waterfall_lines(report):
        log.info(line, event="critpath_waterfall")
    sl = report["slack"]
    log.info(
        f"slack: {sl['zero_slack_events']}/{sl['events']} events at zero "
        f"slack, p50 {sl['p50_us']:.1f} us, p90 {sl['p90_us']:.1f} us",
        event="critpath_slack", **sl,
    )
    for line in headroom_lines(report, top=args.top):
        log.info(line, event="critpath_headroom")
    div = report.get("divergence")
    if div:
        for line in divergence_lines(div, top=args.top):
            log.info(line, event="critpath_divergence")
    if args.save:
        log.info(
            f"artifacts: annotated trace -> {result.get('trace_path')}, "
            f"report -> {result.get('critical_path_path')}",
            event="critpath_artifacts",
            trace_path=result.get("trace_path"),
            report_path=result.get("critical_path_path"),
        )
    if args.json:
        save_report(report, args.json)
        log.info(f"critical-path report -> {args.json}",
                 event="critpath_report", path=args.json)


def cmd_dualpp(args):
    from simumax_tpu_torch import PerfLLM

    perf = PerfLLM().configure(args.strategy, args.model, args.system)
    if perf.strategy.pp_size % 2 or perf.strategy.pp_size < 2:
        raise SystemExit(
            f"DualPipe requires an even pp >= 2 "
            f"(strategy has pp={perf.strategy.pp_size})"
        )
    if perf.strategy.vp_size != 1:
        raise SystemExit(
            "DualPipe and VPP interleaving are exclusive "
            f"(strategy has interleaving_size={perf.strategy.vp_size})"
        )
    perf.run_estimate()
    res = perf.analysis_dualpp(save_path=args.plot)
    log = _log()
    log.info(
        f"1F1B baseline  {res['baseline_iter_time'] * 1e3:9.1f} ms  "
        f"peak {res['baseline_peak_gib']:.1f} GiB",
        event="dualpp_baseline",
    )
    log.info(
        f"DualPipe       {res['dualpp_iter_time'] * 1e3:9.1f} ms  "
        f"peak {res['max_peak_gib']:.1f} GiB  "
        f"(speedup {res['speedup']:.3f}x, projected MFU "
        f"{res['projected_mfu'] * 100:.2f}%)",
        event="dualpp_projection", speedup=res["speedup"],
    )
    for r in res["ranks"]:
        log.info(
            f"  rank {r['rank']}: stages {r['stages']}  "
            f"bubble {r['bubble'] * 1e3:7.1f} ms  "
            f"peak {r['peak_gib']:.1f} GiB",
            event="dualpp_rank", rank=r["rank"],
        )
    if args.plot:
        log.info(f"F&B cell timeline -> {args.plot}", event="dualpp_plot")


def cmd_straggler(args):
    from simumax_tpu_torch import PerfLLM
    from simumax_tpu_torch.simulator.runner import analyze_stragglers

    perf = PerfLLM().configure(args.strategy, args.model, args.system)
    slow = {}
    for spec in args.ranks.split(","):
        try:
            r, f = spec.split(":")
            slow[int(r)] = float(f)
        except ValueError:
            raise SystemExit(
                f"bad --ranks entry {spec!r}: expected rank:multiplier "
                "(e.g. 0:1.2,5:1.5)"
            )
    world = perf.strategy.world_size
    bad = [r for r in slow if not 0 <= r < world]
    if bad:
        raise SystemExit(
            f"ranks {bad} out of range for world_size {world}"
        )
    perf.run_estimate()
    res = analyze_stragglers(perf, slow)
    _log().info(
        f"baseline {res['baseline_ms']:.1f} ms -> perturbed "
        f"{res['perturbed_ms']:.1f} ms  (inflation {res['inflation']:.3f}, "
        f"worst injected multiplier {res['worst_multiplier']:.2f})",
        event="straggler", inflation=res["inflation"],
    )


def cmd_serve(args):
    from simumax_tpu_torch.service.planner import Planner
    from simumax_tpu_torch.service.server import (
        AdmissionController,
        make_server,
        serve_forever,
    )

    max_bytes = (
        args.cache_max_mb * 1024 * 1024 if args.cache_max_mb else None
    )
    trace_log = None
    if args.trace_requests:
        # per-request span trees: one JSON line per served request,
        # appended for the server's lifetime
        from simumax_tpu_torch.observe.telemetry import get_tracer

        os.makedirs(args.trace_requests, exist_ok=True)
        trace_log = os.path.join(args.trace_requests, "requests.jsonl")
        get_tracer().configure(enabled=True)
    enabled = _cache_enabled(args)
    node_id = ring_spec = None
    if args.ring or args.join:
        from simumax_tpu_torch.core.errors import ConfigError
        from simumax_tpu_torch.service.ring import (
            format_ring_spec,
            parse_ring_spec,
        )

        if not (args.ring and args.join):
            raise ConfigError("--ring and --join go together: the "
                              "spec names the fleet, --join picks "
                              "which member this process is")
        members = parse_ring_spec(args.ring)
        if args.join not in members:
            raise ConfigError(
                f"--join {args.join!r} is not a member of "
                f"--ring {args.ring!r}")
        node_id = args.join
        ring_spec = format_ring_spec(members)
        # bind where the ring says this member lives
        args.host, args.port = members[node_id]
    elif args.nodes and args.nodes > 1:
        from simumax_tpu_torch.core.errors import ConfigError
        from simumax_tpu_torch.search.executor import _mp_context
        from simumax_tpu_torch.service.ring import format_ring_spec

        if not args.port:
            raise ConfigError("--nodes needs a concrete --port base "
                              "(ports are consecutive from it), not "
                              "an ephemeral 0")
        members = {f"n{i}": (args.host, args.port + i)
                   for i in range(args.nodes)}
        node_id, ring_spec = "n0", format_ring_spec(members)
        # fork the sibling nodes; each re-enters this command as an
        # explicit --ring/--join member. Not daemonic (a pooled node
        # forks its own workers, and daemons may not have children) —
        # atexit reaps the fleet when this (n0) process exits.
        import atexit

        ctx = _mp_context()
        siblings = []
        for i in range(1, args.nodes):
            child = argparse.Namespace(**vars(args))
            child.nodes = 0
            child.ring = ring_spec
            child.join = f"n{i}"
            p = ctx.Process(target=cmd_serve, args=(child,),
                            daemon=False, name=f"planner-node-n{i}")
            p.start()
            siblings.append(p)

        def _reap():
            for p in siblings:
                p.terminate()
            for p in siblings:
                p.join(5)

        atexit.register(_reap)
    if node_id is not None and enabled:
        # one store shard per fleet member: each node is the single
        # writer of its own root (peers replicate read-only)
        from simumax_tpu_torch.service.store import default_cache_dir

        args.cache_dir = os.path.join(
            args.cache_dir or default_cache_dir(), f"fleet-{node_id}")
    pool = None
    if args.workers:
        from simumax_tpu_torch.service.pool import WorkerPool

        pool = WorkerPool(
            cache_dir=args.cache_dir, enabled=enabled,
            workers=args.workers, max_bytes=max_bytes,
            request_timeout=args.request_timeout or None,
            trace=bool(args.trace_requests),
            fleet_spec=(node_id, ring_spec)
            if node_id is not None else None,
            device=args.device,
        )
        # the in-process planner still serves streaming sweeps and
        # /stats; it shares the pool's single-writer store (same
        # process), so parent and workers see one cache
        planner = Planner(store=pool.store, enabled=enabled,
                          device=args.device)
    else:
        planner = Planner(
            cache_dir=args.cache_dir, enabled=enabled,
            max_bytes=max_bytes, device=args.device,
        )
    warmer = None
    if args.warm:
        from simumax_tpu_torch.service.warmer import (
            Warmer,
            pool_runner,
            warm_cells,
        )

        runner = (
            pool_runner(pool, max_cells=args.warm_cells)
            if pool is not None else
            lambda spec: warm_cells(planner, spec,
                                    max_cells=args.warm_cells)
        )
        warmer = Warmer(
            runner, store=pool.store if pool is not None
            else planner.store,
            max_jobs=args.warm, max_cells=args.warm_cells,
        )
    admission = AdmissionController(args.admission, pool=pool) \
        if args.admission else None
    srv = make_server(planner, args.host, args.port,
                      trace_log=trace_log, pool=pool,
                      admission=admission, warmer=warmer,
                      device=args.device)
    if node_id is not None:
        from simumax_tpu_torch.service.node import attach_fleet

        attach_fleet(srv, node_id, ring_spec,
                     replicate_s=args.replicate_s,
                     probe_s=args.probe_s,
                     probe_seed=args.probe_seed)
    host, port = srv.server_address[:2]
    cache_desc = (
        planner.store.root if planner.enabled else "disabled"
    )
    mode_desc = (
        f"pool of {pool.workers} workers" if pool else "threaded"
    )
    _log().info(
        f"[serve] planning service on http://{host}:{port} "
        f"({mode_desc}; cache: {cache_desc}) — GET /healthz /stats "
        f"/metrics, POST /v1/estimate /v1/explain /v1/search "
        f"/v1/faults /v1/simulate /v1/fleet"
        + (f"; admission backlog {args.admission}" if admission
           else "")
        + (f"; warm queue {args.warm}" if warmer else "")
        + (f"; fleet node {node_id} of ring {ring_spec}"
           if node_id is not None else "")
        + (f"; request traces -> {trace_log}" if trace_log else ""),
        event="serve_start", host=host, port=port, cache=cache_desc,
        workers=args.workers, admission=args.admission,
        warm=args.warm, node=node_id or "",
    )
    serve_forever(srv)


def cmd_cache(args):
    from simumax_tpu_torch.service.store import ContentStore

    store = ContentStore(args.cache_dir)
    log = _log()
    report = None
    if args.action == "stats":
        report = store.stats()
        log.info(f"cache root: {report['root']}", event="cache_root",
                 root=report["root"])
        for ns in sorted(report["namespaces"]):
            d = report["namespaces"][ns]
            log.info(
                f"  {ns:<10} {d['entries']:6d} entries  "
                f"{d['bytes'] / 2**20:8.2f} MiB",
                event="cache_ns", namespace=ns, **d,
            )
        log.info(
            f"  total: {report['total_bytes'] / 2**20:.2f} MiB of "
            f"{report['max_bytes'] / 2**20:.0f} MiB budget",
            event="cache_total", total_bytes=report["total_bytes"],
        )
        c = report["counters"]
        log.info(
            f"  session counters: {c['hits']} hits, {c['misses']} "
            f"misses, {c['puts']} puts, {c['evictions']} evictions, "
            f"{c['corrupt_dropped']} corrupt dropped",
            event="cache_counters", **c,
        )
        if report.get("quarantine_entries"):
            log.info(
                f"  quarantined: {report['quarantine_entries']} "
                f"entries under .quarantine/ (inspect, then clear "
                f"the directory to reclaim the bytes)",
                event="cache_quarantine",
                entries=report["quarantine_entries"],
            )
    elif args.action == "ls":
        entries = store.entries(args.namespace)
        report = {"entries": entries}
        for e in entries:
            log.info(
                f"  {e['namespace']:<10} {e['key'][:16]}…  "
                f"{e['bytes']:10d} B  {e['fmt']:<6} "
                f"v{e['code_version']}",
                event="cache_entry", **e,
            )
        log.info(f"{len(entries)} entries", event="cache_ls_total",
                 count=len(entries))
    elif args.action == "verify":
        report = store.verify(args.namespace, drop=args.drop)
        for c in report["corrupt"]:
            log.error(f"  corrupt: {c['path']} ({c['error']})",
                      event="cache_corrupt", **c)
        log.info(
            f"verified {report['checked']} entries: {report['ok']} ok, "
            f"{len(report['corrupt'])} corrupt"
            + (" (quarantined under .quarantine/)"
               if args.drop and report["corrupt"] else ""),
            event="cache_verify", checked=report["checked"],
            ok=report["ok"], corrupt=len(report["corrupt"]),
        )
    elif args.action == "clear":
        removed = store.clear(args.namespace)
        report = {"removed": removed, "namespace": args.namespace}
        log.info(
            f"cleared {removed} entries"
            + (f" from namespace {args.namespace!r}"
               if args.namespace else ""),
            event="cache_clear", removed=removed,
        )
    if args.json and report is not None:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
        log.info(f"report -> {args.json}", event="cache_report",
                 path=args.json)
    if args.action == "verify" and report["corrupt"]:
        sys.exit(1)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="simumax_tpu_torch",
        description="analytical simulator for LLM training (the "
                    "PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def _add_log_args(parser):
        parser.add_argument(
            "--log-level", default="info",
            choices=("debug", "info", "warning", "error"),
            help="minimum level for report lines (default: info). "
                 "Results are emitted at info, so warning/error "
                 "suppress the normal output too — useful only for "
                 "fully quiet automation that reads --json/--csv/"
                 "--diagnostics artifacts instead of stdout",
        )
        parser.add_argument(
            "--log-json", action="store_true",
            help="emit structured JSONL report lines (ts/level/run_id/"
                 "msg + fields) instead of the human format",
        )

    def _add_cache_args(parser):
        parser.add_argument(
            "--cache-dir", metavar="DIR",
            help="persistent content-addressed result cache root "
                 "(default: SIMUMAX_TPU_CACHE_DIR or "
                 "~/.cache/simumax-tpu; see docs/service.md)",
        )
        parser.add_argument(
            "--no-cache", action="store_true",
            help="evaluate directly, without reading or writing the "
                 "persistent cache (results are bit-identical either "
                 "way; SIMUMAX_TPU_NO_CACHE=1 is the env equivalent)",
        )

    def _add_device_args(parser):
        parser.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="where the command's kernels run: the CUDA card "
                 "(default; fails without one) or, with cpu, their "
                 "plain PyTorch versions",
        )

    pl = sub.add_parser("list", help="list available configs")
    _add_log_args(pl)
    pl.set_defaults(fn=cmd_list)

    def _add_diag_args(parser):
        parser.add_argument(
            "--diagnostics", metavar="PATH",
            help="write the diagnostics JSON report here "
                 "(default: printed as one [diagnostics] line)",
        )
        parser.add_argument(
            "--strict", action="store_true",
            help="exit 3 on any warning / efficiency-table miss / "
                 "quarantined failure",
        )

    def _add_trace_args(parser, serve: bool = False):
        if serve:
            parser.add_argument(
                "--trace-requests", metavar="DIR",
                help="record telemetry spans for every served request "
                     "and append each request's span tree as one JSON "
                     "line to DIR/requests.jsonl (trace ids match the "
                     "X-SimuMax-Trace response headers)",
            )
        else:
            parser.add_argument(
                "--trace-requests", metavar="PATH",
                help="record telemetry spans (store lookups, "
                     "single-flight waits, evaluations, sweep cells, "
                     "DES replays) for this run and dump the span "
                     "tree to PATH plus a Chrome trace to "
                     "PATH.chrome.json",
            )

    pp = sub.add_parser("perf", help="estimate one configuration")
    pp.add_argument("--model", required=True)
    pp.add_argument("--strategy", required=True)
    pp.add_argument("--system", required=True)
    pp.add_argument("--save", help="directory for result JSONs")
    pp.add_argument("--simulate", help="run the event simulator; dir for trace")
    pp.add_argument(
        "--world-ranks", action="store_true",
        help="simulate every global rank (true rendezvous per tp/cp/ep/"
             "dp group) instead of one representative per pp stage",
    )
    pp.add_argument(
        "--reduce", choices=("auto", "on", "off"), default="auto",
        help="world-rank symmetry reduction: simulate one rank per "
             "equivalence class and expand (default auto)",
    )
    pp.add_argument(
        "--stream-trace", action="store_true",
        help="write trace.json incrementally while simulating (peak RSS "
             "stays bounded at pod-size world-rank runs)",
    )
    pp.add_argument(
        "--faults", metavar="SCENARIO.json",
        help="inject a fault scenario (docs/faults.md schema) into the "
             "simulated step: rank slowdowns, preemptions, link "
             "degradation, rank deaths; implies --world-ranks",
    )
    pp.add_argument(
        "--critical-path", action="store_true",
        help="with --simulate: record the event-dependency skeleton and "
             "report per-event slack + the simulated critical-path "
             "waterfall (critpath.json artifact, trace events gain "
             "on_critical_path/slack_us args)",
    )
    pp.add_argument("--graph", action="store_true", help="capture op graph")
    _add_diag_args(pp)
    _add_log_args(pp)
    _add_cache_args(pp)
    _add_trace_args(pp)
    _add_device_args(pp)
    pp.set_defaults(fn=cmd_perf)

    pe = sub.add_parser(
        "explain",
        help="MFU-loss waterfall + top-N op attribution for one config "
             "(--memory: peak-HBM waterfall + per-tensor holders + OOM "
             "forensics)",
    )
    pe.add_argument("--model", required=True)
    pe.add_argument("--strategy", required=True)
    pe.add_argument("--system", required=True)
    pe.add_argument("--top", type=int, default=10,
                    help="rows in the top-op / top-holder table "
                         "(default 10)")
    pe.add_argument(
        "--memory", action="store_true",
        help="explain the peak-HBM prediction instead of the step time: "
             "per-tensor memory ledger, peak-memory waterfall, and (for "
             "non-fitting configs) OOM forensics with what-if probes",
    )
    pe.add_argument(
        "--crosscheck", action="store_true",
        help="with --memory: also run the discrete-event simulator with "
             "memory tracking and report per-stage analytical-vs-DES "
             "peak ratios",
    )
    pe.add_argument(
        "--mem-artifacts", metavar="DIR",
        help="with --memory: write the analytical memory timeline in "
             "the simulator's artifact formats (JSON snapshot, torch "
             "memory-viz pickle, Chrome counter trace)",
    )
    pe.add_argument("--json", metavar="PATH",
                    help="save the full attribution ledger JSON "
                         "(the input format of `simumax_tpu_torch diff`; with "
                         "--memory, the memory-ledger JSON)")
    pe.add_argument("--csv", metavar="PATH",
                    help="save the per-op attribution table as CSV "
                         "(with --memory, the per-tensor holder table)")
    pe.add_argument("--trace", metavar="PATH",
                    help="save a Chrome/Perfetto trace of the analytical "
                         "schedule (same UI as simulate() traces)")
    _add_diag_args(pe)
    _add_log_args(pe)
    _add_cache_args(pe)
    _add_device_args(pe)
    pe.set_defaults(fn=cmd_explain)

    pdf = sub.add_parser(
        "diff",
        help="compare two saved attribution ledgers (explain --json), "
             "two memory ledgers with --memory, or two fleet reports "
             "with --fleet (auto-detected)",
    )
    pdf.add_argument("ledger_a", help="baseline ledger JSON")
    pdf.add_argument("ledger_b", help="comparison ledger JSON")
    pdf.add_argument("--top", type=int, default=20,
                     help="max per-op deltas to report (default 20)")
    pdf.add_argument(
        "--memory", action="store_true",
        help="the inputs are memory ledgers (explain --memory --json): "
             "diff peak-HBM buckets and per-tensor holders",
    )
    pdf.add_argument(
        "--critical-path", action="store_true",
        help="the inputs are critical-path reports (critical-path "
             "--json): diff DES makespans, simulated-waterfall buckets "
             "and slack headroom across two runs/scenarios",
    )
    pdf.add_argument(
        "--fleet", action="store_true",
        help="the inputs are fleet reports (fleet --json): diff "
             "fleet goodput / utilization / makespan / SLO "
             "attainment, per-job goodput movers, and — when both "
             "carry an --explain ledger — the attribution buckets "
             "(auto-detected from the schema when omitted)",
    )
    pdf.add_argument("--json", metavar="PATH",
                     help="also save the structured diff report")
    _add_log_args(pdf)
    pdf.set_defaults(fn=cmd_diff)

    pcp = sub.add_parser(
        "critical-path",
        help="discrete-event critical path: per-event slack, the "
             "simulated waterfall (sums to the DES makespan), "
             "sim-vs-analytical divergence, slack-headroom summaries",
    )
    pcp.add_argument("--model", required=True)
    pcp.add_argument("--strategy", required=True)
    pcp.add_argument("--system", required=True)
    pcp.add_argument(
        "--world-ranks", action="store_true",
        help="simulate every global rank (true rendezvous) instead of "
             "one representative per pp stage",
    )
    pcp.add_argument(
        "--reduce", choices=("auto", "on", "off"), default="auto",
        help="world-rank symmetry reduction (default auto); the "
             "reduced path expands bit-identically",
    )
    pcp.add_argument(
        "--granularity", choices=("leaf", "chunk"), default="leaf",
        help="replay granularity: leaf (default) resolves per-op "
             "events; chunk is faster but folds recompute into compute",
    )
    pcp.add_argument(
        "--faults", metavar="SCENARIO.json",
        help="analyze the critical path under a fault scenario "
             "(docs/faults.md); implies --world-ranks",
    )
    pcp.add_argument("--top", type=int, default=5,
                     help="rows in the headroom / divergence tables "
                          "(default 5)")
    pcp.add_argument("--save", metavar="DIR",
                     help="artifact directory: annotated Chrome trace "
                          "+ critpath.json")
    pcp.add_argument("--json", metavar="PATH",
                     help="save the critical-path report JSON (the "
                          "input format of `diff --critical-path`)")
    _add_diag_args(pcp)
    _add_log_args(pcp)
    pcp.set_defaults(fn=cmd_critpath)

    ps = sub.add_parser("search", help="sweep parallel strategies")
    ps.add_argument("--model", required=True)
    ps.add_argument("--system", required=True)
    ps.add_argument("--base-strategy", default="tp1_pp1_dp8_mbs1")
    ps.add_argument("--world", type=int, default=0)
    ps.add_argument("--seq-len", type=int, default=0)
    ps.add_argument("--gbs", type=int, required=True)
    ps.add_argument("--tp", default="1,2,4,8")
    ps.add_argument("--pp", default="1,2,4")
    ps.add_argument("--ep", default="1")
    ps.add_argument("--cp", default="1")
    ps.add_argument("--zero", default="1", help="zero_state levels, e.g. 1,3")
    ps.add_argument("--topk", type=int, default=5)
    ps.add_argument("--csv")
    ps.add_argument("--verbose", action="store_true")
    ps.add_argument("--dualpp", action="store_true",
                    help="add a DualPipe projection column (even-pp rows)")
    ps.add_argument(
        "--journal", metavar="PATH",
        help="checkpoint every evaluated candidate to this JSONL journal",
    )
    ps.add_argument(
        "--resume", metavar="PATH",
        help="replay a sweep journal: journaled candidates are not "
             "re-evaluated (also extends the journal unless --journal "
             "points elsewhere)",
    )
    ps.add_argument(
        "--candidate-timeout", type=float, default=None, metavar="SECONDS",
        help="per-candidate deadline; slower candidates are quarantined "
             "as status=error rows instead of stalling the sweep",
    )
    ps.add_argument(
        "--jobs", type=int, default=None, metavar="N",
        help="evaluate sweep cells across N worker processes "
             "(default: os.cpu_count(); 1 = serial)",
    )
    ps.add_argument(
        "--no-prune", action="store_true",
        help="disable the closed-form memory prune and the recording "
             "of status=pruned CSV rows; structurally impossible "
             "layouts (divisibility) are still skipped, silently, as "
             "the sweep always has",
    )
    ps.add_argument(
        "--engine", choices=("scalar", "batched"), default="scalar",
        help="candidate scoring engine: 'scalar' walks a PerfLLM per "
             "candidate; 'batched' scores whole candidate batches with "
             "the vectorized cost kernel and re-verifies the top-k "
             "rows with the scalar oracle (see docs/search.md)",
    )
    ps.add_argument(
        "--verify-topk", type=int, default=None, metavar="K",
        help="with --engine batched: how many ranked rows to re-verify "
             "with the scalar oracle (default: --topk)",
    )
    ps.add_argument(
        "--guided", action="store_true",
        help="Pareto-guided search: screen every cell with one cheap "
             "batched-kernel score, fully evaluate only the "
             "(iter_time, peak_mem, comm_fraction) frontier and its "
             "local neighborhoods, refining around the top-k — "
             "skipped cells appear as status=screened CSV rows "
             "(see docs/search.md)",
    )
    ps.add_argument(
        "--simulate-check", action="store_true",
        help="cross-check every fitting candidate with the discrete-"
             "event simulator (sim_ms CSV column); cells whose replay "
             "raises SimulationError are quarantined as status=error "
             "rows like candidate timeouts",
    )
    _add_diag_args(ps)
    _add_log_args(ps)
    _add_cache_args(ps)
    _add_trace_args(ps)
    _add_device_args(ps)
    ps.set_defaults(fn=cmd_search)

    pc = sub.add_parser(
        "calibrate", help="self-calibrate on the local CUDA card "
                          "(miss-driven)"
    )
    pc.add_argument("--model", required=True)
    pc.add_argument("--strategy", required=True)
    pc.add_argument("--system", required=True)
    pc.add_argument("--save", help="write calibrated system config JSON")
    pc.add_argument("--max-keys", type=int, default=64)
    pc.add_argument("--bandwidth", action="store_true",
                    help="also calibrate HBM bandwidth classes")
    pc.add_argument("--collectives", action="store_true",
                    help="also sweep+fit collectives (needs >1 device)")
    _add_diag_args(pc)
    _add_log_args(pc)
    _add_device_args(pc)
    pc.set_defaults(fn=cmd_calibrate)

    pf = sub.add_parser(
        "faults",
        help="goodput prediction under a fault scenario, or seeded "
             "Monte-Carlo over sampled scenarios (docs/faults.md)",
    )
    pf.add_argument("--model", required=True)
    pf.add_argument("--strategy", required=True)
    pf.add_argument("--system", required=True)
    pf.add_argument("--scenario", metavar="SCENARIO.json",
                    help="fault-scenario JSON to predict goodput for")
    pf.add_argument("--monte-carlo", type=int, default=0, metavar="N",
                    help="sample N random scenarios instead of loading "
                         "one (seeded, deterministic)")
    pf.add_argument("--seed", type=int, default=0,
                    help="Monte-Carlo RNG seed (default 0)")
    pf.add_argument("--horizon", type=int, default=0, metavar="STEPS",
                    help="job horizon in steps (default: the scenario's "
                         "horizon_steps; 50 for --monte-carlo)")
    pf.add_argument("--ckpt-interval", type=int, default=0,
                    metavar="STEPS",
                    help="checkpoint every K steps (default: scenario "
                         "override or 50)")
    pf.add_argument("--restart-overhead", type=float, default=None,
                    metavar="SECONDS",
                    help="restart overhead per failure (default 120)")
    pf.add_argument("--granularity", choices=("chunk", "leaf"),
                    default="chunk",
                    help="step-replay granularity: 'leaf' resolves "
                         "intra-stage (tp/cp/ep) collectives so "
                         "link_degradation on those dims takes effect; "
                         "'chunk' (default) is faster and models "
                         "pp/dp_cp/edp faults exactly")
    pf.add_argument("--jobs", type=int, default=None, metavar="N",
                    help="process-parallel Monte-Carlo: fan scenarios "
                         "across N worker processes (serial == "
                         "parallel bit-for-bit; default serial)")
    pf.add_argument("--exact", action="store_true",
                    help="disable the incremental replay engine (slack "
                         "short-circuit, canonicalized step cache, "
                         "healthy-prefix fork) and run the exact "
                         "step-by-step replay — the bit-identity "
                         "reference; ~10x+ slower")
    pf.add_argument("--json", metavar="PATH",
                    help="save the full goodput report / analysis JSON")
    _add_diag_args(pf)
    _add_log_args(pf)
    _add_device_args(pf)
    pf.set_defaults(fn=cmd_faults)

    pfl = sub.add_parser(
        "fleet",
        help="multi-job fleet simulation over a job-arrival trace: "
             "fleet-wide goodput, per-job SLO attainment, and the "
             "scheduler-decision timeline (docs/fleet.md)",
    )
    pfl.add_argument(
        "--trace", required=True, metavar="TRACE.json",
        help="fleet trace (simumax-fleet-trace-v1: pods + "
             "maintenance/spot/degradation windows + templates + "
             "job arrivals)",
    )
    pfl.add_argument(
        "--elastic", action="store_true", default=None,
        help="force elastic dp-reshape on rank death (overrides the "
             "trace's scheduler.elastic)",
    )
    pfl.add_argument(
        "--no-elastic", dest="elastic", action="store_false",
        help="force rollback-restart accounting (overrides the "
             "trace's scheduler.elastic)",
    )
    pfl.add_argument(
        "--jobs", type=int, default=0, metavar="N",
        help="fan job costings across N worker processes (serial == "
             "parallel bit-for-bit; default serial)",
    )
    pfl.add_argument(
        "--naive", action="store_true",
        help="cost every job with a fresh replay context (the "
             "per-job predict_goodput loop bench_fleet.py gates "
             "against) instead of the shared per-template context",
    )
    pfl.add_argument("--top", type=int, default=12, metavar="N",
                     help="decision-timeline lines to print "
                          "(default 12)")
    pfl.add_argument(
        "--explain", action="store_true",
        help="attach the causal goodput ledger + SLO counterfactual "
             "probes (observe/fleetledger.py) and print the "
             "chip-second waterfall, top loss causes, per-pod "
             "utilization, and probe table; the base report stays "
             "byte-identical",
    )
    pfl.add_argument(
        "--chrome-trace", metavar="PATH",
        help="write the fleet timeline as a Chrome trace (pods as "
             "pids, job lanes with run/suspend/checkpoint/rollback/"
             "reshape spans, causal flow arrows, goodput/utilization "
             "counters; implies --explain)",
    )
    pfl.add_argument("--json", metavar="PATH",
                     help="save the full fleet report JSON")
    pfl.add_argument("--cache-dir", metavar="DIR",
                     help="planner cache directory override")
    pfl.add_argument("--no-cache", action="store_true",
                     help="bypass the planner cache")
    _add_log_args(pfl)
    _add_device_args(pfl)
    pfl.set_defaults(fn=cmd_fleet)

    pd = sub.add_parser(
        "dualpp",
        help="DualPipe bidirectional-schedule projection (even pp)",
    )
    pd.add_argument("--model", required=True)
    pd.add_argument("--strategy", required=True)
    pd.add_argument("--system", required=True)
    pd.add_argument("--plot", help="PNG path for the F&B cell timeline")
    _add_log_args(pd)
    pd.set_defaults(fn=cmd_dualpp)

    pst = sub.add_parser(
        "straggler",
        help="world-rank simulation with per-rank slowdown injection",
    )
    pst.add_argument("--model", required=True)
    pst.add_argument("--strategy", required=True)
    pst.add_argument("--system", required=True)
    pst.add_argument(
        "--ranks", required=True,
        help="rank:multiplier list, e.g. 0:1.2,5:1.5",
    )
    _add_log_args(pst)
    pst.set_defaults(fn=cmd_straggler)

    psv = sub.add_parser(
        "serve",
        help="long-running JSON-over-HTTP planning server backed by "
             "the persistent content-addressed cache "
             "(docs/service.md): concurrent estimate/explain/search/"
             "faults/simulate/fleet queries, single-flight dedup, "
             "NDJSON sweep streaming, /healthz + /stats",
    )
    psv.add_argument("--host", default="127.0.0.1",
                     help="bind address (default 127.0.0.1)")
    psv.add_argument("--port", type=int, default=8642,
                     help="bind port (default 8642; 0 = ephemeral)")
    psv.add_argument(
        "--cache-max-mb", type=int, default=0, metavar="MB",
        help="store size budget in MiB (default: the store's 512 MiB "
             "default; LRU-evicted beyond it)",
    )
    psv.add_argument(
        "--workers", type=int, default=0, metavar="N",
        help="serve through a pool of N planner worker processes "
             "(read-only store replicas + a single parent-side "
             "writer, request coalescing, response memory cache, "
             "worker respawn/retry — docs/service.md 'Production "
             "deployment'). Default 0: the in-process threaded "
             "server",
    )
    psv.add_argument(
        "--warm", type=int, default=0, metavar="JOBS",
        help="speculatively precompute the neighbor sweep cells of "
             "each served search (one index step per swept axis) in a "
             "background warmer with a JOBS-deep bounded queue. "
             "Default 0: off",
    )
    psv.add_argument(
        "--warm-cells", type=int, default=64, metavar="N",
        help="max neighbor cells one warm job may evaluate "
             "(default 64)",
    )
    psv.add_argument(
        "--admission", type=int, default=0, metavar="BACKLOG",
        help="admission control: shed requests with 429 + Retry-After "
             "once the queued+in-flight backlog reaches BACKLOG "
             "(scaled per X-SimuMax-Priority class: low sheds at "
             "0.5x, high at 1.5x). Default 0: admit everything",
    )
    psv.add_argument(
        "--request-timeout", type=float, default=0, metavar="SEC",
        help="pooled mode: per-request SIGALRM deadline on the worker "
             "(plus the 5x+30s hard kill backstop). Default 0: no "
             "deadline",
    )
    psv.add_argument(
        "--nodes", type=int, default=0, metavar="N",
        help="fleet convenience mode: fork N-1 sibling nodes on "
             "consecutive ports from --port (this process serves "
             "node n0) joined in one consistent-hash ring — sharded "
             "store, affinity routing, fleet-wide cell coalescing "
             "(docs/service.md 'Planner fleet'). Default 0: single "
             "node",
    )
    psv.add_argument(
        "--ring", metavar="SPEC",
        help="explicit fleet membership 'id=host:port,id=host:port,"
             "...' — start every member with the same SPEC; requires "
             "--join",
    )
    psv.add_argument(
        "--join", metavar="ID",
        help="this process's node id within --ring (bind host/port "
             "come from the matching SPEC entry)",
    )
    psv.add_argument(
        "--replicate-s", type=float, default=0, metavar="SEC",
        help="fleet mode: pull read-only replicas of peer-owned "
             "store entries every SEC seconds (default 0: replicate "
             "only on POST /ring/replicate)",
    )
    psv.add_argument(
        "--probe-s", type=float, default=0, metavar="SEC",
        help="fleet mode: heartbeat every peer over /ring/ping about "
             "every SEC seconds (seeded jitter); consecutive misses "
             "mark a peer suspect then down, removing it from the "
             "live ring until it answers again (docs/service.md "
             "'Failure semantics'). Default 0: no failure detection",
    )
    psv.add_argument(
        "--probe-seed", type=int, default=0, metavar="N",
        help="seed of the failure detector's jittered probe "
             "schedule (same seed = same relative probe times; "
             "default 0)",
    )
    _add_cache_args(psv)
    _add_log_args(psv)
    _add_trace_args(psv, serve=True)
    _add_device_args(psv)
    psv.set_defaults(fn=cmd_serve)

    pca = sub.add_parser(
        "cache",
        help="inspect/maintain the persistent planner cache: stats / "
             "ls / verify (re-hash payloads, exit 1 on corruption) / "
             "clear [--namespace]",
    )
    pca.add_argument("action",
                     choices=("stats", "ls", "verify", "clear"))
    pca.add_argument(
        "--namespace", metavar="NS",
        help="restrict ls/verify/clear to one namespace "
             "(estimate, explain, sweep, profiles, des)",
    )
    pca.add_argument(
        "--drop", action="store_true",
        help="with verify: also remove the corrupt entries",
    )
    pca.add_argument("--json", metavar="PATH",
                     help="also save the structured report")
    pca.add_argument(
        "--cache-dir", metavar="DIR",
        help="cache root (default: SIMUMAX_TPU_CACHE_DIR or "
             "~/.cache/simumax-tpu)",
    )
    _add_log_args(pca)
    pca.set_defaults(fn=cmd_cache)

    args = p.parse_args(argv)
    # the process-wide reporter carries the CLI's log surface; default
    # settings keep the human output byte-identical to the bare prints
    # it replaced
    from simumax_tpu_torch.observe.report import configure_reporter

    configure_reporter(
        level=getattr(args, "log_level", "info"),
        json_lines=getattr(args, "log_json", False),
        run_id="",
    )
    # One-line actionable messages instead of tracebacks for the whole
    # anticipated-failure taxonomy (core/errors.py). Unanticipated bugs
    # still traceback — that is the right behavior for them.
    from simumax_tpu_torch.core.errors import (
        CardRequiredError,
        ConfigError,
        SimulationError,
        SimuMaxError,
        UnknownConfigError,
    )

    try:
        _require_device(args)
        return args.fn(args)
    except CardRequiredError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(EXIT_DEVICE)
    except UnknownConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        print("hint: `python -m simumax_tpu_torch list` shows every config",
              file=sys.stderr)
        sys.exit(EXIT_CONFIG)
    except ConfigError as e:
        print(f"error: invalid configuration — {e}", file=sys.stderr)
        sys.exit(EXIT_CONFIG)
    except SimulationError as e:
        # same one-line treatment as the ConfigError family: a
        # DeadlockError's multi-line state dump belongs in the
        # diagnostics report, not on stderr
        first = (str(e) or type(e).__name__).splitlines()[0]
        print(f"error: simulation failed — {type(e).__name__}: {first}",
              file=sys.stderr)
        print("hint: rerun with --diagnostics PATH for the full "
              "engine state dump", file=sys.stderr)
        sys.exit(EXIT_SIMULATION)
    except SimuMaxError as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    sys.exit(main())

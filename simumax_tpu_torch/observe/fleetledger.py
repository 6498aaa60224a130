"""Fleet goodput forensics (the JAX package's docs/fleet.md
"Explaining a fleet run").

Three surfaces over a finished :class:`~simumax_tpu_torch.fleet.sim.
FleetSimulator` walk, in the established ledger discipline
(cost ledger / memory ledger / critical-path blame):
collect-on == collect-off bit-identical, and every decomposition sums
to its total within 1e-6 by construction.

* **Causal goodput ledger** (:func:`build_fleet_ledger`) — re-drives
  each completed job's goodput walk through the *shared* per-template
  :class:`~simumax_tpu_torch.simulator.faults.ReplayContext` with the walk
  observer attached (``simulator/faults.py`` / the elastic twin), so
  every perturbed step is answered from the cache the fleet walk
  already filled and the re-drive is near-free. The observer stream
  (steps, checkpoint writes, restarts, reshapes) is folded into
  per-job buckets — ``useful_train``, the ``fault_stall`` split by
  causing-event class (maintenance / degradation / suspension),
  checkpoint write, restore read, restart overhead, restart replay,
  reshape — and every bucket-second is attributed to the causing
  trace event (``maint:{wi}`` / ``link:{wi}`` / ``spot:{ri}`` /
  ``preempt:{job}`` / ``policy:checkpoint``), the causality ids the
  fleet walk records on its timeline and decisions. Roll-ups:
  chip-second-weighted fleet waterfall (the cost ledger's ``{order, buckets,
  total}`` shape), per-template loss profile, per-pod utilization.
* **SLO counterfactual probes** (:func:`slo_counterfactuals`) — the
  ``memledger.whatif_probes`` pattern at fleet scale: each missed-SLO
  or starved job gets cheap counterfactuals (checkpoint interval =
  Young-Daly optimal, placement excluding degraded pods, on-demand
  instead of spot, a priority bump, elastic off) re-costed through
  the same shared context; the first SLO-recovering probe in fixed
  cheapness order is flagged ``cheapest_fix``.
* **Fleet Chrome trace** (:func:`fleet_chrome_trace`) — pods as
  pids, jobs as lanes with run / checkpoint / rollback / reshape /
  suspended spans, pod-level window lanes (maintenance, degradation,
  reclaims), flow arrows from causing event to affected job span,
  counter tracks for per-pod used chips and the running fleet
  goodput — same viewer as the pipeline traces, validated by the
  ``test_trace_validity.py`` machinery.

Everything is assembled into the report's ``explain`` key by
:func:`build_fleet_explain`; the base ``simumax-fleet-v1`` payload
stays byte-identical to an explain-off run (CI's bit-identity gate).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from simumax_tpu_torch.core.errors import ConfigError

#: fleet-ledger buckets in presentation order: the goodput buckets
#: with ``fault_stall`` split by causing-event class. They sum to the
#: job's wall time within 1e-6 (same constructive accounting as
#: ``GoodputBuckets``, re-derived from the walk observer stream).
FLEET_LEDGER_ORDER = (
    "useful_train",
    "stall_maintenance",
    "stall_degradation",
    "stall_suspension",
    "stall_other",
    "checkpoint_write",
    "restore_read",
    "restart_overhead",
    "restart_replay",
    "reshape",
)

#: probe cheapness order: a config knob beats a placement change
#: beats a procurement/priority change beats a scheduling-policy flip
_PROBE_ORDER = (
    "checkpoint=young-daly",
    "placement=clean-pods",
    "spot=on-demand",
    "priority=bump",
    "elastic=off",
)

_CKPT_CAUSE = "policy:checkpoint"
_UNATTRIBUTED = "unattributed"


def _stall_bucket(cause: str) -> str:
    """Causing-event id -> stall bucket class."""
    if cause.startswith("maint:"):
        return "stall_maintenance"
    if cause.startswith("link:"):
        return "stall_degradation"
    if cause.startswith(("preempt:", "spot:")) or cause == "sched":
        return "stall_suspension"
    return "stall_other"


# --------------------------------------------------------------------------
# Per-job attribution: fold the walk-observer stream into causes
# --------------------------------------------------------------------------


class _JobAttribution:
    """State machine mirroring the goodput walk's commit/rollback
    accounting, fed by the walk observer. ``pending`` holds committed
    but uncheckpointed step rows exactly like the walk's
    ``uncommitted`` list: a checkpoint finalizes them into
    useful/stall, a restart converts them into ``restart_replay``
    attributed to the killing event."""

    def __init__(self, windows: List[tuple], deaths: List[tuple],
                 reshape_causes: List[str]):
        #: (t0_s, t1_s, weight_rate, cause) stall-bearing windows
        self.windows = windows
        #: (t_s, cause) rank-death events
        self.deaths = deaths
        self.reshape_causes = reshape_causes
        self.buckets = {k: 0.0 for k in FLEET_LEDGER_ORDER}
        #: cause -> bucket -> seconds
        self.causes: Dict[str, Dict[str, float]] = {}
        #: (healthy_s, stall_s, {(cause, bucket): s}) rows since the
        #: last successful checkpoint
        self.pending: List[tuple] = []
        self.spans: List[dict] = []
        self._run_start: Optional[float] = None
        self._n_reshapes = 0
        self.wall_end = 0.0

    def _charge(self, cause: str, bucket: str, seconds: float):
        if seconds == 0.0:
            return
        self.buckets[bucket] += seconds
        per = self.causes.setdefault(cause, {})
        per[bucket] = per.get(bucket, 0.0) + seconds

    def _split_stall(self, t0: float, t1: float,
                     stall: float) -> Dict[Tuple[str, str], float]:
        """Attribute a step's stall across the scenario windows
        overlapping ``[t0, t1)``, weighted by overlap x stall rate
        (1.0 for a freeze, ``multiplier - 1`` for a degradation).
        No overlapping window -> the unattributed stall bucket."""
        if stall <= 0.0:
            return {}
        weights: Dict[Tuple[str, str], float] = {}
        total = 0.0
        for (w0, w1, rate, cause) in self.windows:
            ov = min(t1, w1) - max(t0, w0)
            if ov <= 0.0 or rate <= 0.0:
                continue
            key = (cause, _stall_bucket(cause))
            weights[key] = weights.get(key, 0.0) + ov * rate
            total += ov * rate
        if total <= 0.0:
            return {(_UNATTRIBUTED, "stall_other"): stall}
        return {k: stall * w / total for k, w in weights.items()}

    def _death_cause(self, abort_s: float) -> str:
        if not self.deaths:
            return _UNATTRIBUTED
        t, cause = min(self.deaths,
                       key=lambda d: (abs(d[0] - abort_s), d[0]))
        return cause

    def _close_run(self, end_s: float):
        if self._run_start is not None and end_s > self._run_start:
            self.spans.append({"name": "run", "t0_s": self._run_start,
                               "dur_s": end_s - self._run_start})
        self._run_start = None

    def _commit_pending(self):
        for (h, stall, attr) in self.pending:
            self.buckets["useful_train"] += h
            for (cause, bucket), s in attr.items():
                self._charge(cause, bucket, s)
            # useful time has no causing event; count it explicitly
            # so per-cause totals + useful sum back to wall
            per = self.causes.setdefault("useful", {})
            per["useful_train"] = per.get("useful_train", 0.0) + h
        self.pending = []

    def feed(self, rec: tuple):
        kind = rec[0]
        if kind == "step":
            _, wall, h, dur = rec
            if self._run_start is None:
                self._run_start = wall
            attr = self._split_stall(wall, wall + dur, dur - h)
            self.pending.append((h, dur - h, attr))
            self.wall_end = wall + dur
        elif kind == "checkpoint":
            _, wall, write_s = rec
            self._commit_pending()
            self._charge(_CKPT_CAUSE, "checkpoint_write", write_s)
            self._close_run(wall)
            self.spans.append({"name": "checkpoint", "t0_s": wall,
                               "dur_s": write_s,
                               "cause": _CKPT_CAUSE})
            self.wall_end = wall + write_s
        elif kind == "restart":
            _, abort, extra, overhead, read_s = rec
            cause = self._death_cause(abort)
            for (h, stall, _attr) in self.pending:
                self._charge(cause, "restart_replay", h + stall)
            self.pending = []
            self._charge(cause, "restart_replay", extra)
            self._charge(cause, "restart_overhead", overhead)
            self._charge(cause, "restore_read", read_s)
            self._close_run(abort)
            self.spans.append({"name": "rollback", "t0_s": abort,
                               "dur_s": overhead + read_s,
                               "cause": cause})
            self.wall_end = abort + overhead + read_s
        elif kind == "reshape":
            _, wall, partial, cost, level = rec
            cause = (self.reshape_causes[self._n_reshapes]
                     if self._n_reshapes < len(self.reshape_causes)
                     else _UNATTRIBUTED)
            self._n_reshapes += 1
            self._charge(cause, "reshape", partial + cost)
            self._close_run(wall)
            self.spans.append({"name": "reshape", "t0_s": wall,
                               "dur_s": partial + cost,
                               "cause": cause, "level": level})
            self.wall_end = wall + partial + cost

    def finish(self, wall_s: float):
        self._commit_pending()
        self._close_run(wall_s)
        self.wall_end = wall_s


def _job_windows_and_deaths(scenario, causes: List[str]):
    """Scenario events + causality ids -> the attribution inputs:
    stall-bearing windows (freezes at rate 1, degradations at rate
    ``multiplier - 1``) and rank-death instants, in job-relative
    seconds."""
    windows: List[tuple] = []
    deaths: List[tuple] = []
    for ev, cause in zip(scenario.events, causes):
        t0 = ev.start_ms * 1e-3
        if ev.kind == "rank_death":
            deaths.append((t0, cause))
            continue
        t1 = t0 + (ev.duration_ms or 0.0) * 1e-3
        rate = 1.0
        if ev.kind == "link_degradation":
            rate = max(0.0, (ev.multiplier or 1.0) - 1.0)
        elif ev.kind == "slowdown":
            rate = max(0.0, (ev.multiplier or 1.0) - 1.0)
        windows.append((t0, t1, rate, cause))
    return windows, deaths


def attribute_job(sim, job) -> Optional[Dict[str, Any]]:
    """One completed job's causal ledger record: re-drive its goodput
    walk through the shared template context with the observer
    attached and fold the stream. Returns ``None`` for jobs without a
    report (starved/suspended at trace end — nothing to decompose)."""
    if job.report is None:
        return None
    from simumax_tpu_torch.fleet.sim import elastic_goodput_walk
    from simumax_tpu_torch.simulator.faults import predict_goodput

    rt = sim._runtimes[job.spec.template]
    scenario, causes = sim._materialize(job, with_causes=True)
    windows, deaths = _job_windows_and_deaths(scenario, causes)
    attr = _JobAttribution(windows, deaths,
                           list(job.reshape_causes))
    if job.reshapes:
        levels = sim._job_levels(job, rt)
        report = elastic_goodput_walk(
            rt.ctx, scenario, rt.ctx.resolve_spec(scenario),
            list(job.reshapes), levels, observer=attr.feed,
        )
    else:
        report = predict_goodput(
            rt.perf, scenario, granularity=rt.granularity,
            _ctx=rt.ctx, observer=attr.feed,
        )
    attr.finish(report.wall_time_s)
    # suspension freezes (scheduler wait after a preemption/reclaim
    # kill) become explicit job-lane spans; maintenance/degradation
    # windows already render on the pod lane
    for (w0, w1, _rate, cause) in windows:
        if _stall_bucket(cause) == "stall_suspension":
            attr.spans.append({"name": "suspended", "t0_s": w0,
                               "dur_s": w1 - w0, "cause": cause})
    start = job.start_s or 0.0
    cause_rows = sorted(
        (
            {"cause": c, "total_s": round(sum(b.values()), 9),
             "buckets": {k: round(v, 9) for k, v in sorted(b.items())}}
            for c, b in attr.causes.items()
        ),
        key=lambda r: (-r["total_s"], r["cause"]),
    )
    rec = {
        "name": job.spec.name,
        "template": job.spec.template,
        "state": job.state,
        "chips": rt.world_size,
        "start_s": start,
        "wall_time_s": report.wall_time_s,
        "queue_wait_s": job.queue_wait_s,
        "goodput": report.goodput,
        "buckets": {k: round(attr.buckets[k], 9)
                    for k in FLEET_LEDGER_ORDER},
        "causes": cause_rows,
        "spans": [
            dict(s, t0_s=round(s["t0_s"] + start, 9),
                 dur_s=round(s["dur_s"], 9))
            for s in attr.spans
        ],
    }
    if job.spec.slo_goodput is not None:
        rec["slo_goodput"] = job.spec.slo_goodput
        rec["slo_attained"] = (job.state == "done"
                               and report.goodput
                               >= job.spec.slo_goodput)
    return rec


# --------------------------------------------------------------------------
# Causality-id resolution (id -> the causing trace event)
# --------------------------------------------------------------------------


def resolve_causes(sim) -> Dict[str, Dict[str, Any]]:
    """Every causality id the walk can mint, resolved to the fleet
    trace event it names — the ledger's foreign keys. The golden test
    asserts every id the ledger used resolves here."""
    out: Dict[str, Dict[str, Any]] = {
        _CKPT_CAUSE: {"kind": "checkpoint_policy"},
        _UNATTRIBUTED: {"kind": "unattributed"},
        "useful": {"kind": "useful_train"},
        "sched": {"kind": "scheduler"},
    }
    for wi, w in enumerate(sim.fleet.maintenance):
        out[f"maint:{wi}"] = {
            "kind": "maintenance", "pod": w.pod,
            "start_s": w.start_s, "end_s": w.end_s,
        }
    for wi, w in enumerate(sim.fleet.link_degradations):
        out[f"link:{wi}"] = {
            "kind": "link_degradation", "pod": w.pod, "dim": w.dim,
            "multiplier": w.multiplier,
            "start_s": w.start_s, "end_s": w.end_s,
        }
    for ri, rec in enumerate(sim.fleet.materialize_spot()):
        out[f"spot:{ri}"] = {
            "kind": "spot_reclaim", "pod": rec.pod,
            "start_s": rec.start_s, "chips": rec.chips,
        }
    for job in sim._jobs:
        out[f"preempt:{job.spec.name}"] = {
            "kind": "priority_preemption", "by": job.spec.name,
            "priority": job.spec.priority,
        }
    return out


# --------------------------------------------------------------------------
# Per-pod utilization from the walk's occupancy deltas
# --------------------------------------------------------------------------


def _pod_utilization(sim, makespan: float) -> Dict[str, Any]:
    """Integrate the walk's chip-occupancy deltas per pod over
    ``[0, makespan]``: used and capacity chip-seconds, the
    utilization ratio, and the (t, used_chips) step samples the
    Chrome counter tracks render."""
    out: Dict[str, Any] = {}
    horizon = max(makespan, 0.0)
    for p in sim._pods:
        deltas = sorted(
            (e for e in sim.occupancy if e["pod"] == p.name),
            key=lambda e: e["t"],
        )
        used = 0
        cap = p.chips
        t_prev = 0.0
        used_s = cap_s = 0.0
        samples: List[List[float]] = [[0.0, 0]]
        for e in deltas:
            t = min(max(e["t"], 0.0), horizon)
            used_s += used * (t - t_prev)
            cap_s += cap * (t - t_prev)
            t_prev = t
            used += e.get("used", 0)
            cap += e.get("cap", 0)
            if samples[-1][0] == t:
                samples[-1][1] = used
            else:
                samples.append([round(t, 6), used])
        used_s += used * (horizon - t_prev)
        cap_s += cap * (horizon - t_prev)
        if samples[-1][0] != horizon:
            samples.append([round(horizon, 6), used])
        out[p.name] = {
            "capacity_chips": p.chips,
            "used_chip_s": round(used_s, 6),
            "capacity_chip_s": round(cap_s, 6),
            "utilization": (used_s / cap_s) if cap_s else 0.0,
            "samples": samples,
        }
    return out


# --------------------------------------------------------------------------
# SLO counterfactual probes
# --------------------------------------------------------------------------


def _recost(rt, scenario, spec, reshapes, levels):
    from simumax_tpu_torch.fleet.sim import elastic_goodput_walk
    from simumax_tpu_torch.simulator.faults import predict_goodput

    if reshapes:
        return elastic_goodput_walk(rt.ctx, scenario, spec,
                                    reshapes, levels)
    return predict_goodput(rt.perf, scenario, spec=spec,
                           granularity=rt.granularity, _ctx=rt.ctx)


def _drop_events(scenario, causes, keep):
    """A scenario with only the (event, cause) pairs ``keep`` admits;
    the surviving causes ride along."""
    from simumax_tpu_torch.simulator.faults import FaultScenario

    kept = [(e, c) for e, c in zip(scenario.events, causes)
            if keep(e, c)]
    return FaultScenario(
        events=[e for e, _c in kept],
        horizon_steps=scenario.horizon_steps,
        checkpoint=scenario.checkpoint,
    ), [c for _e, c in kept]


def _probe_bound(rec: Dict[str, Any], change: str) -> Optional[float]:
    """Upper bound on the goodput a probe can reach: useful time is
    invariant under every intervention, and an intervention can at
    best delete the wall-seconds the ledger attributes to what it
    changes. ``None`` = no usable bound (always re-cost)."""
    if rec is None:
        return None
    removable = 0.0
    if change == "checkpoint=young-daly":
        removable = (rec["buckets"]["checkpoint_write"]
                     + rec["buckets"]["restart_replay"])
    elif change == "placement=clean-pods":
        removable = sum(r["total_s"] for r in rec["causes"]
                        if r["cause"].startswith("link:"))
    elif change == "spot=on-demand":
        removable = sum(r["total_s"] for r in rec["causes"]
                        if r["cause"].startswith("spot:"))
    elif change == "priority=bump":
        removable = sum(r["total_s"] for r in rec["causes"]
                        if r["cause"].startswith("preempt:"))
    else:
        return None
    useful = rec["buckets"]["useful_train"]
    denom = rec["wall_time_s"] - removable
    return (useful / denom) if denom > 0 else 1.0


def slo_counterfactuals(sim, jobs=None,
                        attribution: Optional[Dict[str, dict]] = None
                        ) -> List[Dict[str, Any]]:
    """The what-if probe table for SLO-missing jobs: re-cost cheap
    counterfactual policy changes through the shared per-template
    replay context (cache-hot, so each probe is near-free) and flag
    the first probe in cheapness order that recovers the SLO as
    ``cheapest_fix``. Starved jobs (never completed) get a probe row
    naming the admission-side fix instead of a re-cost.

    ``attribution`` (``{job_name: per-job ledger record}``, supplied
    by :func:`build_fleet_explain`) enables bound pruning: a probe
    whose :func:`_probe_bound` upper bound is already below the SLO
    is reported with ``goodput_bound`` instead of paying a re-cost —
    the bound is exact ("useful time is invariant; at best the probe
    deletes its own attributed seconds"), so pruned probes are
    provably non-recovering.

    Probe failures from genuinely infeasible counterfactuals
    (``SimuMaxError`` family, ``ValueError``) become rows with an
    ``error`` field; ``AssertionError`` stays loud (estimator-bug
    policy, same as ``memledger.whatif_probes``)."""
    from simumax_tpu_torch.core.errors import SimuMaxError
    from simumax_tpu_torch.observe.telemetry import get_registry
    from simumax_tpu_torch.simulator.faults import FaultEvent, FaultScenario

    reg = get_registry()
    probes: List[Dict[str, Any]] = []
    for job in (jobs if jobs is not None else sim._jobs):
        slo = job.spec.slo_goodput
        if slo is None:
            continue
        if (job.state == "done" and job.report is not None
                and job.report["goodput"] >= slo):
            continue
        if job.report is None or job.state != "done":
            probes.append({
                "job": job.spec.name, "slo": slo,
                "change": "priority=bump", "recovers": None,
                "error": f"starved (state={job.state}): never "
                         "completed, nothing to re-cost — admission "
                         "or priority is the lever",
            })
            reg.counter("fleet_probes_total", outcome="starved").inc()
            continue
        rt = sim._runtimes[job.spec.template]
        scenario, causes = sim._materialize(job, with_causes=True)
        reshapes = list(job.reshapes)
        levels = sim._job_levels(job, rt)
        spec = rt.ctx.resolve_spec(scenario)
        base_goodput = job.report["goodput"]
        h = job.report["healthy_step_s"]
        ckpt = job.report["checkpoint"]
        candidates: List[tuple] = []
        # 1. checkpoint interval = Young-Daly optimal from the job's
        #    OBSERVED failure rate (the fault model's closed form; zero observed
        #    restarts means MTBF -> inf, i.e. no mid-run writes)
        n_restarts = job.report["n_restarts"]
        if h > 0:
            if n_restarts > 0:
                mtbf = job.report["wall_time_s"] / n_restarts
                yd = max(1, int(round(
                    math.sqrt(2.0 * ckpt["write_s"] * mtbf) / h)))
            else:
                yd = scenario.horizon_steps
            if yd != spec.interval_steps:
                import dataclasses as _dc

                spec_yd = _dc.replace(spec, interval_steps=yd)
                candidates.append((
                    "checkpoint=young-daly",
                    f"interval {spec.interval_steps} -> {yd} steps",
                    scenario, causes, spec_yd, reshapes, levels,
                ))
        # 2. placement excluding degraded pods: the job's
        #    link-degradation windows vanish
        if any(e.kind == "link_degradation" for e in scenario.events):
            sc2, c2 = _drop_events(
                scenario, causes,
                lambda e, c: e.kind != "link_degradation")
            candidates.append((
                "placement=clean-pods",
                "drop all link-degradation windows",
                sc2, c2, spec, reshapes, levels,
            ))
        # 3. on-demand instead of spot: every spot-reclaim
        #    consequence (kills, freezes, reshapes) vanishes
        spot_reshapes = any(c.startswith("spot:")
                            for c in job.reshape_causes)
        if (any(c.startswith("spot:") for c in causes)
                or spot_reshapes):
            sc3, c3 = _drop_events(
                scenario, causes,
                lambda e, c: not c.startswith("spot:"))
            rs3 = [] if spot_reshapes else reshapes
            lv3 = {} if spot_reshapes else levels
            candidates.append((
                "spot=on-demand",
                "drop all spot-reclaim consequences",
                sc3, c3, spec, rs3, lv3,
            ))
        # 4. priority bump: preemption kills + suspension waits by
        #    higher-priority arrivals vanish
        if any(c.startswith("preempt:") for c in causes):
            sc4, c4 = _drop_events(
                scenario, causes,
                lambda e, c: not c.startswith("preempt:"))
            candidates.append((
                "priority=bump",
                "drop all priority-preemption consequences",
                sc4, c4, spec, reshapes, levels,
            ))
        # 5. elastic off: each reshape becomes a rank death at the
        #    same instant and the job walks the rollback-restart
        #    path (documented approximation: the dead rank is the
        #    base-world rank 0 of the dropped replica set)
        if reshapes:
            ev5 = list(scenario.events) + [
                FaultEvent("rank_death", start_ms=t_r * 1e3, rank=0)
                for (t_r, _reps) in reshapes
            ]
            order = sorted(range(len(ev5)),
                           key=lambda i: ev5[i].start_ms)
            sc5 = FaultScenario(
                events=[ev5[i] for i in order],
                horizon_steps=scenario.horizon_steps,
                checkpoint=scenario.checkpoint,
            )
            candidates.append((
                "elastic=off",
                "rollback-restart instead of dp shrink",
                sc5, None, spec, [], {},
            ))
        candidates.sort(key=lambda c: _PROBE_ORDER.index(c[0]))
        rec = (attribution or {}).get(job.spec.name)
        for (change, detail, sc, _c, sp, rs, lv) in candidates:
            row: Dict[str, Any] = {
                "job": job.spec.name, "slo": slo, "change": change,
                "detail": detail,
                "baseline_goodput": base_goodput,
            }
            bound = _probe_bound(rec, change)
            if bound is not None and bound < slo:
                row["goodput_bound"] = bound
                row["recovers"] = False
                reg.counter("fleet_probes_total",
                            outcome="no").inc()
                probes.append(row)
                continue
            try:
                rep = _recost(rt, sc, sp, rs, lv)
                row["goodput"] = rep.goodput
                row["recovers"] = rep.goodput >= slo
                reg.counter(
                    "fleet_probes_total",
                    outcome="recovers" if row["recovers"] else "no",
                ).inc()
            except (SimuMaxError, ValueError) as exc:
                row["recovers"] = False
                row["error"] = f"{type(exc).__name__}: {exc}"
                reg.counter("fleet_probes_total",
                            outcome="error").inc()
            probes.append(row)
            if row["recovers"]:
                # candidates run cheapest-first, so the first
                # recovering probe IS the answer; pricier
                # interventions are moot and never re-costed
                row["cheapest_fix"] = True
                break
    return probes


# --------------------------------------------------------------------------
# The explain payload
# --------------------------------------------------------------------------


def build_fleet_ledger(sim) -> Dict[str, Any]:
    """The causal goodput ledger of a finished fleet walk: per-job
    attribution records plus chip-second-weighted fleet roll-ups
    (waterfall, per-template loss profile, per-pod utilization,
    per-cause totals)."""
    from simumax_tpu_torch.observe.telemetry import get_registry

    reg = get_registry()
    per_job: List[Dict[str, Any]] = []
    fleet_buckets = {k: 0.0 for k in FLEET_LEDGER_ORDER}
    fleet_causes: Dict[str, Dict[str, float]] = {}
    per_template: Dict[str, Dict[str, Any]] = {}
    total_chip_s = 0.0
    makespan = 0.0
    for job in sim._jobs:
        rec = attribute_job(sim, job)
        if rec is None:
            rt = sim._runtimes.get(job.spec.template)
            per_job.append({
                "name": job.spec.name,
                "template": job.spec.template,
                "state": job.state,
                "chips": rt.world_size if rt else 0,
                "wall_time_s": 0.0,
                "queue_wait_s": job.queue_wait_s,
                "buckets": {k: 0.0 for k in FLEET_LEDGER_ORDER},
                "causes": [], "spans": [],
            })
            continue
        per_job.append(rec)
        reg.counter("fleet_explain_jobs_total").inc()
        if job.state != "done":
            continue
        chips = rec["chips"]
        makespan = max(makespan,
                       rec["start_s"] + rec["wall_time_s"])
        total_chip_s += rec["wall_time_s"] * chips
        tpl = per_template.setdefault(rec["template"], {
            "jobs": 0, "chip_s": 0.0,
            "buckets": {k: 0.0 for k in FLEET_LEDGER_ORDER},
        })
        tpl["jobs"] += 1
        tpl["chip_s"] += rec["wall_time_s"] * chips
        for k, v in rec["buckets"].items():
            fleet_buckets[k] += v * chips
            tpl["buckets"][k] += v * chips
        for row in rec["causes"]:
            per = fleet_causes.setdefault(row["cause"], {})
            for k, v in row["buckets"].items():
                per[k] = per.get(k, 0.0) + v * chips
    events = resolve_causes(sim)
    cause_rows = sorted(
        (
            {
                "cause": c,
                "event": events.get(c, {"kind": "unknown"}),
                "chip_s": round(sum(b.values()), 6),
                "buckets": {k: round(v, 6)
                            for k, v in sorted(b.items())},
            }
            for c, b in fleet_causes.items()
        ),
        key=lambda r: (-r["chip_s"], r["cause"]),
    )
    for tpl in per_template.values():
        tpl["chip_s"] = round(tpl["chip_s"], 6)
        tpl["buckets"] = {k: round(v, 6)
                          for k, v in tpl["buckets"].items()}
    return {
        # the cost ledger's waterfall shape, chip-second weighted
        "order": list(FLEET_LEDGER_ORDER),
        "buckets": {k: round(fleet_buckets[k], 6)
                    for k in FLEET_LEDGER_ORDER},
        "total_chip_s": round(total_chip_s, 6),
        "makespan_s": makespan,
        "per_job": per_job,
        "per_template": dict(sorted(per_template.items())),
        "per_pod": _pod_utilization(sim, makespan),
        "causes": cause_rows,
    }


def build_fleet_explain(sim) -> Dict[str, Any]:
    """The report's ``explain`` payload: ledger + probe table + the
    causality-id resolution table. Computed strictly AFTER the walk
    from state the walk records unconditionally, so the base payload
    cannot depend on whether explain ran."""
    if sim.report is None:
        raise ConfigError(
            "build_fleet_explain needs a finished walk: call run() "
            "first", phase="fleet",
        )
    ledger = build_fleet_ledger(sim)
    attribution = {r["name"]: r for r in ledger["per_job"]
                   if r.get("wall_time_s")}
    return {
        "schema": "simumax-fleet-explain-v1",
        "ledger": ledger,
        "probes": slo_counterfactuals(sim, attribution=attribution),
        "events": resolve_causes(sim),
    }


# --------------------------------------------------------------------------
# Rendering
# --------------------------------------------------------------------------


def fleet_waterfall_lines(ledger: Dict[str, Any]) -> List[str]:
    """Chip-second-weighted fleet waterfall (the cost ledger's rendering
    idiom over ``FLEET_LEDGER_ORDER``)."""
    total = ledger["total_chip_s"] or 1.0
    width = max(len(k) for k in ledger["order"])
    lines = [
        f"== fleet goodput waterfall: {total:.0f} chip-seconds over "
        f"{sum(1 for j in ledger['per_job'] if j['state'] == 'done')}"
        f" completed jobs =="
    ]
    for key in ledger["order"]:
        v = ledger["buckets"][key]
        pct = round(100.0 * v / total, 2) + 0.0
        lines.append(
            f"  {key:<{width}}  {v:14.1f} chip-s  {pct:6.2f}%"
        )
    lines.append(
        f"  {'= occupied':<{width}}  {total:14.1f} chip-s  100.00%"
    )
    return lines


def _describe_event(ev: Dict[str, Any]) -> str:
    kind = ev.get("kind", "unknown")
    if kind == "maintenance":
        return (f"maintenance {ev['pod']} "
                f"[{ev['start_s']:.0f}, {ev['end_s']:.0f})s")
    if kind == "link_degradation":
        return (f"degradation {ev['pod']} {ev['dim']} "
                f"x{ev['multiplier']:.2f} "
                f"[{ev['start_s']:.0f}, {ev['end_s']:.0f})s")
    if kind == "spot_reclaim":
        return (f"reclaim {ev['pod']} -{ev['chips']} chips "
                f"@{ev['start_s']:.0f}s")
    if kind == "priority_preemption":
        return f"preemption by {ev['by']}"
    if kind == "checkpoint_policy":
        return "checkpoint policy (periodic writes)"
    return kind


def fleet_explain_lines(report: Dict[str, Any],
                        top_causes: int = 8,
                        top_probes: int = 12) -> List[str]:
    """Human rendering of the explain payload: the chip-second
    waterfall, the top causes table, per-pod utilization, and the
    SLO counterfactual probe table."""
    explain = report.get("explain")
    if not explain:
        raise ConfigError(
            "report has no 'explain' payload (run the fleet walk "
            "with explain=True / --explain)", phase="fleet",
        )
    ledger = explain["ledger"]
    lines = fleet_waterfall_lines(ledger)
    loss = [r for r in ledger["causes"] if r["cause"] != "useful"]
    if loss:
        lines.append(f"  -- top loss causes ({len(loss)} events) --")
        for r in loss[:top_causes]:
            worst = max(r["buckets"], key=lambda k: r["buckets"][k])
            lines.append(
                f"  {r['chip_s']:12.1f} chip-s  {r['cause']:<16} "
                f"{_describe_event(r['event'])} (mostly {worst})"
            )
    lines.append("  -- per-pod utilization --")
    for pod, u in ledger["per_pod"].items():
        lines.append(
            f"  {pod}: {100.0 * u['utilization']:6.2f}% of "
            f"{u['capacity_chip_s']:.0f} chip-s"
        )
    probes = explain["probes"]
    if probes:
        lines.append(
            "  -- SLO counterfactual probes (shared-context "
            "re-costs) --"
        )
        for p in probes[:top_probes]:
            if "error" in p:
                lines.append(
                    f"    {p['job']}: {p['change']:<22} "
                    f"{p['error']}"
                )
                continue
            if "goodput_bound" in p:
                lines.append(
                    f"    {p['job']}: {p['change']:<22} pruned — "
                    f"upper bound {100.0 * p['goodput_bound']:.2f}% "
                    f"< SLO {100.0 * p['slo']:.0f}% (cannot recover)"
                )
                continue
            star = ("  <- cheapest SLO fix"
                    if p.get("cheapest_fix") else "")
            verdict = "recovers" if p["recovers"] else "still miss"
            lines.append(
                f"    {p['job']}: {p['change']:<22} goodput "
                f"{100.0 * p['baseline_goodput']:.2f}% -> "
                f"{100.0 * p['goodput']:.2f}% vs SLO "
                f"{100.0 * p['slo']:.0f}% ({verdict}){star}"
            )
        if len(probes) > top_probes:
            lines.append(f"    ... {len(probes) - top_probes} more")
    return lines


# --------------------------------------------------------------------------
# Fleet report diffing
# --------------------------------------------------------------------------


def diff_fleet_reports(a: Dict[str, Any], b: Dict[str, Any],
                       top: int = 10) -> Dict[str, Any]:
    """Structured diff of two ``simumax-fleet-v1`` reports (A -> B):
    headline deltas, per-job goodput movers, and — when both carry an
    explain payload — the fleet-bucket chip-second deltas."""
    for name, r in (("A", a), ("B", b)):
        if r.get("schema") != "simumax-fleet-v1":
            raise ConfigError(
                f"diff input {name} is not a simumax-fleet-v1 "
                f"report (schema={r.get('schema')!r})", phase="fleet",
            )
    headline = {
        k: {"a": a[k], "b": b[k], "delta": b[k] - a[k]}
        for k in ("fleet_goodput", "chip_utilization", "makespan_s")
    }
    headline["slo_fraction"] = {
        "a": a["slo"]["fraction"], "b": b["slo"]["fraction"],
        "delta": b["slo"]["fraction"] - a["slo"]["fraction"],
    }
    ja = {j["name"]: j for j in a["jobs"]}
    jb = {j["name"]: j for j in b["jobs"]}
    movers = []
    for name in sorted(set(ja) & set(jb)):
        ga = (ja[name]["report"] or {}).get("goodput")
        gb = (jb[name]["report"] or {}).get("goodput")
        if ga is None and gb is None:
            continue
        movers.append({
            "job": name, "a": ga, "b": gb,
            "delta": (gb or 0.0) - (ga or 0.0),
        })
    movers.sort(key=lambda m: (-abs(m["delta"]), m["job"]))
    out: Dict[str, Any] = {
        "headline": headline,
        "jobs": movers[:top],
        "only_a": sorted(set(ja) - set(jb)),
        "only_b": sorted(set(jb) - set(ja)),
    }
    la = (a.get("explain") or {}).get("ledger")
    lb = (b.get("explain") or {}).get("ledger")
    if la and lb:
        out["buckets"] = {
            k: {
                "a": la["buckets"].get(k, 0.0),
                "b": lb["buckets"].get(k, 0.0),
                "delta": (lb["buckets"].get(k, 0.0)
                          - la["buckets"].get(k, 0.0)),
            }
            for k in FLEET_LEDGER_ORDER
        }
    return out


def format_fleet_diff_lines(diff: Dict[str, Any],
                            top: int = 10) -> List[str]:
    """Human rendering of :func:`diff_fleet_reports`."""
    h = diff["headline"]
    lines = [
        "== fleet diff (A -> B) ==",
        f"  fleet goodput {100.0 * h['fleet_goodput']['a']:.2f}% -> "
        f"{100.0 * h['fleet_goodput']['b']:.2f}% "
        f"({100.0 * h['fleet_goodput']['delta']:+.2f}pp)",
        f"  chip utilization "
        f"{100.0 * h['chip_utilization']['a']:.2f}% -> "
        f"{100.0 * h['chip_utilization']['b']:.2f}% "
        f"({100.0 * h['chip_utilization']['delta']:+.2f}pp)",
        f"  makespan {h['makespan_s']['a']:.1f}s -> "
        f"{h['makespan_s']['b']:.1f}s "
        f"({h['makespan_s']['delta']:+.1f}s)",
        f"  SLO attainment "
        f"{100.0 * h['slo_fraction']['a']:.1f}% -> "
        f"{100.0 * h['slo_fraction']['b']:.1f}% "
        f"({100.0 * h['slo_fraction']['delta']:+.1f}pp)",
    ]
    if diff.get("buckets"):
        lines.append("  -- fleet bucket deltas (chip-s) --")
        for k, d in diff["buckets"].items():
            if abs(d["delta"]) < 1e-9:
                continue
            lines.append(
                f"  {k:<18} {d['a']:12.1f} -> {d['b']:12.1f} "
                f"({d['delta']:+12.1f})"
            )
    if diff["jobs"]:
        lines.append("  -- top per-job goodput movers --")
        for m in diff["jobs"][:top]:
            fa = (f"{100.0 * m['a']:.2f}%" if m["a"] is not None
                  else "n/a")
            fb = (f"{100.0 * m['b']:.2f}%" if m["b"] is not None
                  else "n/a")
            lines.append(
                f"  {m['job']:<20} {fa:>8} -> {fb:>8} "
                f"({100.0 * m['delta']:+.2f}pp)"
            )
    for side, names in (("A", diff["only_a"]), ("B", diff["only_b"])):
        if names:
            lines.append(f"  only in {side}: {', '.join(names)}")
    return lines


# --------------------------------------------------------------------------
# Fleet Chrome-trace export
# --------------------------------------------------------------------------

_SPAN_COLORS = {
    "run": "good",
    "checkpoint": "thread_state_runnable",
    "rollback": "terrible",
    "reshape": "thread_state_iowait",
    "suspended": "bad",
    "maintenance": "bad",
    "degradation": "thread_state_iowait",
    "reclaim": "terrible",
}


def fleet_chrome_trace(report: Dict[str, Any]) -> dict:
    """Fleet timeline in the Chrome trace-event format (the same
    viewer as the pipeline traces): one pid per pod (lane 0 shows the
    pod's maintenance/degradation/reclaim windows, one lane per job
    homed there), job spans from the attribution ledger, flow arrows
    from each causing window to the rollback/reshape/checkpoint span
    it produced, per-pod used-chip counter tracks and the running
    fleet-goodput counter. Requires the report's ``explain``
    payload (built from its span records alone, so cached explain
    payloads re-export identically)."""
    explain = report.get("explain")
    if not explain:
        raise ConfigError(
            "fleet_chrome_trace needs the report's 'explain' payload "
            "(simulate_fleet(..., explain=True) / fleet --explain)",
            phase="fleet",
        )
    ledger = explain["ledger"]
    events_tbl = explain["events"]
    pods = sorted(ledger["per_pod"])
    pod_pid = {name: i for i, name in enumerate(pods)}
    fleet_pid = len(pods)
    out: List[dict] = []
    for name in pods:
        out.append({"ph": "M", "pid": pod_pid[name],
                    "name": "process_name",
                    "args": {"name": f"pod {name}"}})
        out.append({"ph": "M", "pid": pod_pid[name], "tid": 0,
                    "name": "thread_name",
                    "args": {"name": "fleet events"}})
    out.append({"ph": "M", "pid": fleet_pid, "name": "process_name",
                "args": {"name": "fleet"}})
    # pod window spans (the flow-arrow sources), keyed by cause id
    window_span: Dict[str, tuple] = {}
    for cause, ev in sorted(events_tbl.items()):
        kind = ev.get("kind")
        if kind == "maintenance":
            pid, t0 = pod_pid[ev["pod"]], ev["start_s"]
            dur, name = ev["end_s"] - t0, f"maintenance [{cause}]"
            color = _SPAN_COLORS["maintenance"]
        elif kind == "link_degradation":
            pid, t0 = pod_pid[ev["pod"]], ev["start_s"]
            dur = ev["end_s"] - t0
            name = (f"degradation {ev['dim']} "
                    f"x{ev['multiplier']:.2f} [{cause}]")
            color = _SPAN_COLORS["degradation"]
        elif kind == "spot_reclaim":
            pid, t0 = pod_pid[ev["pod"]], ev["start_s"]
            dur = 0.0
            name = f"reclaim -{ev['chips']} chips [{cause}]"
            color = _SPAN_COLORS["reclaim"]
        else:
            continue
        window_span[cause] = (pid, 0, t0)
        out.append({
            "ph": "X", "pid": pid, "tid": 0, "name": name,
            "ts": t0 * 1e6, "dur": max(dur, 0.0) * 1e6,
            "cname": color, "args": {"cause": cause},
        })
    # job lanes: homed on the first pod of the admission placement
    job_home: Dict[str, str] = {}
    for d in report["decisions"]:
        if d["event"] == "admitted" and d.get("pods"):
            job_home.setdefault(d["job"], d["pods"][0])
    lane_counter = {name: 0 for name in pods}
    job_lane: Dict[str, tuple] = {}
    for j in ledger["per_job"]:
        home = job_home.get(j["name"])
        if home is None:
            continue  # never admitted: no lane
        lane_counter[home] += 1
        tid = lane_counter[home]
        job_lane[j["name"]] = (pod_pid[home], tid)
        out.append({"ph": "M", "pid": pod_pid[home], "tid": tid,
                    "name": "thread_name",
                    "args": {"name": f"job {j['name']}"}})
    flow_id = 0
    for j in ledger["per_job"]:
        lane = job_lane.get(j["name"])
        if lane is None:
            continue
        pid, tid = lane
        for s in j["spans"]:
            args = {"job": j["name"]}
            if s.get("cause"):
                args["cause"] = s["cause"]
            out.append({
                "ph": "X", "pid": pid, "tid": tid, "name": s["name"],
                "ts": s["t0_s"] * 1e6,
                "dur": max(s["dur_s"], 0.0) * 1e6,
                "cname": _SPAN_COLORS.get(s["name"]),
                "args": args,
            })
            cause = s.get("cause", "")
            src = window_span.get(cause)
            if src is None and cause.startswith("preempt:"):
                # preemptions have no pod window: the arrow starts on
                # the preemptor job's own lane at the instant it hits
                pl = job_lane.get(cause[len("preempt:"):])
                if pl is not None:
                    src = (pl[0], pl[1], s["t0_s"])
            if src is not None and s["name"] != "run":
                flow_id += 1
                spid, stid, st0 = src
                out.append({"ph": "s", "pid": spid, "tid": stid,
                            "id": flow_id, "name": "cause",
                            "cat": "cause", "ts": st0 * 1e6})
                out.append({"ph": "f", "pid": pid, "tid": tid,
                            "id": flow_id, "name": "cause",
                            "cat": "cause", "ts": s["t0_s"] * 1e6,
                            "bp": "e"})
    # per-pod used-chip counters
    for name in pods:
        for (t, used) in ledger["per_pod"][name]["samples"]:
            out.append({
                "ph": "C", "pid": pod_pid[name], "name": "used_chips",
                "ts": t * 1e6, "args": {"chips": max(used, 0)},
            })
    # running fleet goodput: cumulative chip-weighted over completions
    done = sorted(
        (j for j in report["jobs"]
         if j["state"] == "done" and j["report"] is not None),
        key=lambda j: (j["completed_s"], j["name"]),
    )
    useful = wall = 0.0
    out.append({"ph": "C", "pid": fleet_pid, "name": "fleet_goodput_pct",
                "ts": 0.0, "args": {"pct": 0.0}})
    for j in done:
        useful += j["report"]["useful_time_s"] * j["chips"]
        wall += j["report"]["wall_time_s"] * j["chips"]
        out.append({
            "ph": "C", "pid": fleet_pid, "name": "fleet_goodput_pct",
            "ts": j["completed_s"] * 1e6,
            "args": {"pct": round(100.0 * useful / wall, 4)
                     if wall else 0.0},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_fleet_trace(report: Dict[str, Any], path: str) -> str:
    import json

    with open(path, "w", encoding="utf-8") as f:
        json.dump(fleet_chrome_trace(report), f)
    return path


__all__ = [
    "FLEET_LEDGER_ORDER",
    "attribute_job",
    "build_fleet_ledger",
    "build_fleet_explain",
    "slo_counterfactuals",
    "resolve_causes",
    "fleet_waterfall_lines",
    "fleet_explain_lines",
    "diff_fleet_reports",
    "format_fleet_diff_lines",
    "fleet_chrome_trace",
    "write_fleet_trace",
]

"""Multi-job fleet simulation (the JAX package's docs/fleet.md).

Walks a job-arrival trace (``fleet/trace.py``) over a shared pod
fleet and produces fleet-wide goodput, per-job SLO attainment, and a
scheduler-decision timeline. The perf headline is **cross-job replay
amortization**: one :class:`~simumax_tpu_torch.simulator.faults.ReplayContext`
per distinct template serves every job instantiated from it across the
whole trace, so the healthy-step DES run, the recorded request
streams, the snapshot ladders and the symmetry-canonicalized step
cache are paid once per *template*, not once per *job* — and scheduler
events that hit symmetric placements (the "kill rank r at t" template)
collapse to one replay per orbit through the canonical step cache.

Scheduler model (deterministic; every decision lands in the report's
``decisions`` timeline):

* **admission** — jobs need their template's ``world_size`` chips,
  allocated over pods by a placement score that prefers pods whose
  upcoming link degradations the template can absorb (the
  "tolerates X% slowdown" critical-path headroom): a job with enough
  slack takes the degraded pod — where the slack gate then proves the
  degradation free — keeping clean pods for tight jobs.
* **maintenance** — a down pod freezes the job ranks placed on it for
  the window (``preemption`` fault events; partners stall through the
  DES collectives exactly as on real hardware).
* **spot reclaim** — chips leave a pod; the victim (lowest-priority
  spot job on the pod) either *reshapes* — elastic dp shrink: keep
  committed steps, pay a redistribution + re-init cost, continue at
  the re-costed shrunk step time (``search/prune.py::shrink_strategy``
  feasibility + ``PerfLLM.rebatched_iter_time`` re-costing) — or is
  killed and restarts from its last checkpoint on backfilled chips
  (suspended until capacity frees when there are none).
* **priority preemption** — under ``policy: "priority"`` a
  higher-priority arrival may kill + suspend lower-priority running
  jobs; suspended jobs resume (possibly migrated to different pods)
  when capacity frees, their wait accounted as an all-rank freeze.

Per-job costing routes through ``predict_goodput`` against the shared
template context, so per-job ``GoodputReport``s are **bit-identical**
to the naive per-job loop (``naive=True``: a fresh replay context per
costing call — what the JAX package's fleet bench gates ≥10x
against). With elastic reshaping off, the two walks agree
byte-for-byte; ``jobs=N`` fans costing batches across a worker pool
with the fault analysis's discipline (canonical-cache merge-back,
worker-main-thread SIGALRM deadlines), serial == parallel bit-for-bit.

Copy of the JAX package's ``fleet/sim.py`` with its import paths
changed and one difference: the naive baseline's fresh replay contexts
take the walk's ``options`` (the JAX package gives them the defaults),
so a walk replays where its caller asked: ``ReplayOptions()`` launches
the replay kernel on the card, ``ReplayOptions(device="cpu")`` runs its
plain version, ``replay_backend="numpy"`` the scalar engine. The pool
forks its workers unless this process has initialised CUDA, and then
spawns them (``simulator/faults.py::_mc_context``); a spawned worker
builds its own estimate, replay context and CUDA context from the
pickled templates.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from simumax_tpu_torch.core.errors import ConfigError, FeasibilityError
from simumax_tpu_torch.fleet.trace import FleetTrace, JobSpec, TemplateSpec
from simumax_tpu_torch.simulator.faults import (
    CheckpointSpec,
    FaultEvent,
    FaultScenario,
    GoodputReport,
    ReplayContext,
    ReplayOptions,
    _deadline,
    _predict_goodput_batch,
    predict_goodput,
)

# --------------------------------------------------------------------------
# Template runtime: the shared-per-template replay state
# --------------------------------------------------------------------------


def _build_template_perf(spec: TemplateSpec):
    """One completed estimate from a template spec (model/strategy/
    system + optional field overrides), shared by every consumer of
    the template. Overrides apply BEFORE ``configure()`` so its
    sanity checks judge the overridden configs (a base config that is
    only valid after e.g. a ``layer_num`` trim must not fail early)."""
    import copy as _copy

    from simumax_tpu_torch.core.config import (
        ModelConfig,
        StrategyConfig,
        SystemConfig,
        get_model_config,
        get_strategy_config,
        get_system_config,
    )
    from simumax_tpu_torch.perf import PerfLLM, _resolve

    ov = spec.overrides or {}
    resolved = {}
    for kind, (value, cls, getter) in (
        ("model", (spec.model, ModelConfig, get_model_config)),
        ("strategy", (spec.strategy, StrategyConfig,
                      get_strategy_config)),
        ("system", (spec.system, SystemConfig, get_system_config)),
    ):
        target = _resolve(value, cls, getter)
        if ov.get(kind):
            if target is value:
                # never mutate a caller-owned config object
                target = _copy.deepcopy(target)
            for k, v in sorted(ov[kind].items()):
                if not hasattr(target, k):
                    raise ConfigError(
                        f"template {spec.name}: unknown {kind} "
                        f"override field {k!r}", phase="fleet",
                    )
                setattr(target, k, v)
            target.__post_init__()
        resolved[kind] = target
    perf = PerfLLM()
    perf.configure(resolved["strategy"], resolved["model"],
                   resolved["system"])
    perf.run_estimate()
    return perf


class TemplateRuntime:
    """Everything one template shares across its jobs: the estimate,
    the replay context (healthy step, recorded streams, snapshot
    ladders, canonical step cache), the critical-path link headroom
    the placement scorer consults, and the lazily re-costed elastic
    shrink levels."""

    def __init__(self, spec: TemplateSpec,
                 options: Optional[ReplayOptions] = None):
        self.spec = spec
        self.perf = _build_template_perf(spec)
        self.granularity = spec.granularity
        self.ctx = ReplayContext(self.perf, granularity=spec.granularity,
                                 options=options)
        self.world_size = self.perf.strategy.world_size
        st = self.perf.strategy
        #: chips of one data-parallel replica (the elastic shrink unit)
        self.replica_chips = st.tp_size * st.cp_size * st.pp_size
        self._plan = None
        self._levels: Dict[int, Tuple[float, float]] = {}
        self._cost_perf = None
        self._headroom: Dict[Optional[str], float] = {}
        self._healthy_s: Optional[float] = None

    @property
    def healthy_step_s(self) -> float:
        if self._healthy_s is None:
            self._healthy_s = self.ctx.healthy()["end_time"]
        return self._healthy_s

    def link_headroom_pct(self, dim: Optional[str] = None) -> float:
        """The template's tightest per-link slack headroom from the
        healthy critical-path report (its "tolerates X% slowdown"),
        optionally restricted to one collective dim (headroom keys are
        ``dim:tp`` / ``pp:a->b``): a link degradation multiplier
        within ``1 + headroom/100`` on that dim provably cannot move
        the step makespan, so the job can absorb it. A dim with no
        exposed headroom entry tolerates anything (``inf``)."""
        got = self._headroom.get(dim)
        if got is None:
            report = self.ctx.healthy().get("critical_path") or {}

            def match(key: str) -> bool:
                if dim is None or dim == "*":
                    return True
                if dim == "pp":
                    return key.startswith("pp:")
                return key == f"dim:{dim}"

            vals = [
                e["tolerates_slowdown_pct"]
                for e in report.get("per_link_headroom", [])
                if e.get("tolerates_slowdown_pct") is not None
                and match(e.get("link", ""))
            ]
            got = min(vals) if vals else (
                math.inf if dim not in (None, "*") else 0.0
            )
            self._headroom[dim] = got
        return got

    def orbit(self, rank: int) -> int:
        """Symmetry orbit of a job rank under the healthy reduction —
        the decision timeline annotates fault placements with it, so
        two kills whose ranks share an orbit are visibly the same
        abstract event (one replay serves both)."""
        if self._plan is None:
            from simumax_tpu_torch.simulator.reduce import build_reduction

            self._plan = build_reduction(self.perf.strategy, {})
        from simumax_tpu_torch.simulator.reduce import orbit_of

        return orbit_of(self._plan, rank)

    # -- elastic shrink levels --------------------------------------------
    def shrunk_strategy(self, replicas_lost: int):
        """``prune.shrink_strategy`` from the template base — raises
        ``FeasibilityError`` when the global batch cannot split over
        the survivors."""
        from simumax_tpu_torch.search.prune import shrink_strategy

        return shrink_strategy(self.perf.strategy, replicas_lost)

    def reshape_feasible(self, replicas_lost: int) -> bool:
        """Divisibility + HBM fit of the shrunk layout: ZeRO state
        re-shards over fewer replicas, so the closed-form memory lower
        bound must stay under usable HBM."""
        try:
            st = self.shrunk_strategy(replicas_lost)
        except FeasibilityError:
            return False
        from simumax_tpu_torch.search.prune import memory_lower_bound

        usable = self.perf.analysis_mem()["usable_bytes"]
        return memory_lower_bound(st, self.perf.model_config) <= usable

    def level(self, replicas_lost: int) -> Tuple[float, float]:
        """``(healthy_step_s, redistribution_s)`` at a cumulative
        shrink level, memoized per template (shared by every job that
        ever shrinks to it). The caller charges one redistribution
        per replica lost at the event, plus the scheduler's fixed
        ``reshape_overhead_s``.

        * step time — the base DES healthy step scaled by the
          analytical iteration-time ratio of the re-batched layout
          (``PerfLLM.rebatched_iter_time`` on a dedicated costing
          estimate: one build per template, one ``rebatch()`` fast
          path per level). The dp-group-size effect on the grad
          all-reduce is second-order (ring time is
          ``2(n-1)/n x bytes``) and absorbed by the ratio model.
        * reshape cost — redistributing the lost replicas' weight +
          optimizer shards to the survivors: one all-gather of the
          per-rank checkpoint bytes over the dp_cp path per lost
          replica (``SystemConfig.compute_net_op_terms``), plus the
          scheduler's fixed ``reshape_overhead_s`` (added by the
          caller, which knows the scheduler spec).
        """
        got = self._levels.get(replicas_lost)
        if got is not None:
            return got
        st_shrunk = self.shrunk_strategy(replicas_lost)
        if self._cost_perf is None:
            self._cost_perf = _build_template_perf(self.spec)
            self._base_iter = self._cost_perf.analysis_cost()["iter_time"]
        ratio = (
            self._cost_perf.rebatched_iter_time(
                st_shrunk.micro_batch_num
            ) / self._base_iter
        )
        h_level = self.healthy_step_s * ratio
        from simumax_tpu_torch.perf import place_strategy_paths

        paths = place_strategy_paths(self.perf.strategy,
                                     self.perf.system)
        nbytes = self.ctx.checkpoint_model(
            CheckpointSpec()
        ).bytes_per_rank
        bw_t, lat_t = self.perf.system.compute_net_op_terms(
            "all_gather", nbytes, paths["dp_cp"],
        )
        entry = (h_level, bw_t + lat_t)
        self._levels[replicas_lost] = entry
        return entry


# --------------------------------------------------------------------------
# Elastic goodput walk
# --------------------------------------------------------------------------


def elastic_goodput_walk(
    ctx: ReplayContext,
    scenario: FaultScenario,
    spec: CheckpointSpec,
    reshapes: List[Tuple[float, int]],
    levels: Dict[int, Tuple[float, float]],
    max_restarts: int = 1000,
    observer=None,
) -> GoodputReport:
    """The elastic twin of ``faults._goodput_walk``: identical
    step-by-step accounting (committed steps at the healthy step
    time, stalls, periodic checkpoint writes, death -> rollback ->
    restart), plus **reshape events**: at each ``(t_rel_s, replicas)``
    the in-flight step is abandoned (its partial wall time charged to
    the ``reshape`` bucket — committed steps are NOT rolled back,
    which is the whole point of shrinking instead of restarting),
    the level's reshape cost is charged, and the walk continues at
    the shrunk level's healthy step time.

    ``levels[cumulative_replicas] = (healthy_step_s, reshape_cost_s)``
    comes from :meth:`TemplateRuntime.level` (+ scheduler overhead).
    Perturbed steps keep routing through the shared template context:
    the stall a fault window injects is window-bound, not step-bound,
    so a post-reshape perturbed step costs
    ``h_level + (simulated - h_base)`` — the base-world replay's
    exposed stall carried onto the shrunk step (documented
    approximation, docs/fleet.md). With no reshapes this walk is not
    used; the caller routes through ``predict_goodput`` outright, so
    reshape-disabled fleet accounting is bit-identical to the
    rollback-restart path by construction.

    ``observer`` mirrors the :func:`~simumax_tpu_torch.simulator.faults.
    predict_goodput` hook (the fleet ledger's bucket provenance):
    ``("step", wall, h, dur)`` / ``("checkpoint", wall, write_s)`` /
    ``("restart", abort, extra, overhead, read)`` plus the elastic
    ``("reshape", wall, partial_s, cost_s, level)`` event. Pure
    notification — observed and unobserved walks are bit-identical.
    """
    from simumax_tpu_torch.core.records import GoodputBuckets

    ctx.validate_scenario(scenario)
    ckpt = ctx.checkpoint_model(spec)
    healthy = ctx.healthy()
    h0 = healthy["end_time"]
    horizon = scenario.horizon_steps
    interval = spec.interval_steps
    pending = sorted(reshapes)
    lost = 0
    h = h0
    b = GoodputBuckets()
    wall = 0.0
    committed = 0
    ckpt_committed = 0
    n_ckpt = n_restart = replayed = 0
    uncommitted: List[Tuple[float, float]] = []
    deaths: List[Dict[str, float]] = []
    truncated = False

    def first_death_in(t0_s: float, t1_s: float) -> Optional[float]:
        times = [
            ev.start_ms * 1e-3 for ev in scenario.events
            if ev.kind == "rank_death"
            and t0_s <= ev.start_ms * 1e-3 < t1_s
        ]
        return min(times) if times else None

    def restart(abort_wall_s: float, extra_lost_s: float):
        nonlocal wall, committed, n_restart, replayed, uncommitted
        deaths.append({
            "wall_time_s": abort_wall_s,
            "lost_steps": committed - ckpt_committed,
        })
        for (hp, sp) in uncommitted:
            b.useful_train -= hp
            b.fault_stall -= sp
            b.restart_replay += hp + sp
        replayed += len(uncommitted)
        b.restart_replay += extra_lost_s
        committed = ckpt_committed
        uncommitted = []
        wall = abort_wall_s + spec.restart_overhead_s + ckpt.read_s
        b.restart_overhead += spec.restart_overhead_s
        b.restore_read += ckpt.read_s
        n_restart += 1
        if observer is not None:
            observer(("restart", abort_wall_s, extra_lost_s,
                      spec.restart_overhead_s, ckpt.read_s))

    def fire_reshape(t_r: float, replicas: int):
        nonlocal wall, lost, h
        partial = max(0.0, t_r - wall)
        lost += replicas
        h_level, cost = levels[lost]
        b.reshape += partial + cost
        if observer is not None:
            observer(("reshape", wall, partial, cost, lost))
        wall = max(t_r, wall) + cost
        h = h_level

    while committed < horizon:
        if pending and pending[0][0] <= wall:
            # a reshape landed inside the recovery/checkpoint wall we
            # just charged: fire it before the next step (no partial)
            t_r, reps = pending.pop(0)
            fire_reshape(t_r, reps)
            continue
        span = h
        dur, death = h, None
        for _ in range(8):
            sub = scenario.shifted(wall * 1e3, span * 1e3)
            if sub.empty:
                dur, death = h, None
                break
            sdur, death = ctx.simulate_step(sub, span)
            dur = h + max(0.0, sdur - h0)
            if death is not None or dur <= span * (1 + 1e-12):
                break
            span = dur
        if pending and wall + dur > pending[0][0] and (
            death is None or wall + death > pending[0][0]
        ):
            # the reshape interrupts this step (and precedes any
            # death in it): abandon the partial step, shrink, go on
            t_r, reps = pending.pop(0)
            fire_reshape(t_r, reps)
            continue
        if death is None:
            if observer is not None:
                observer(("step", wall, h, dur))
            wall += dur
            b.useful_train += h
            b.fault_stall += dur - h
            uncommitted.append((h, dur - h))
            committed += 1
            if committed % interval == 0 and committed < horizon:
                t_d = first_death_in(wall, wall + ckpt.write_s)
                if t_d is not None:
                    restart(t_d, t_d - wall)
                    if n_restart >= max_restarts:
                        truncated = True
                        break
                    continue
                if observer is not None:
                    observer(("checkpoint", wall, ckpt.write_s))
                wall += ckpt.write_s
                b.checkpoint_write += ckpt.write_s
                n_ckpt += 1
                ckpt_committed = committed
                uncommitted = []
        else:
            restart(wall + death, death)
            if n_restart >= max_restarts:
                truncated = True
                break
    useful = b.useful_train
    return GoodputReport(
        goodput=(useful / wall) if wall > 0 else 1.0,
        wall_time_s=wall,
        useful_time_s=useful,
        healthy_step_s=h0,
        horizon_steps=horizon,
        n_checkpoints=n_ckpt,
        n_restarts=n_restart,
        steps_replayed=replayed,
        buckets=b,
        deaths=deaths,
        checkpoint=ckpt.to_dict(),
        truncated=truncated,
    )


# --------------------------------------------------------------------------
# Shared costing entry (serial parent, pool workers, naive baseline)
# --------------------------------------------------------------------------


def _cost_job(perf, ctx: Optional[ReplayContext], granularity: str,
              scenario: FaultScenario,
              reshapes: List[Tuple[float, int]],
              levels: Dict[int, Tuple[float, float]],
              options: Optional[ReplayOptions] = None) -> dict:
    """One job costing -> ``GoodputReport.to_dict()``. The checkpoint
    spec rides on ``scenario.checkpoint`` (resolved through the
    context's hoisted memo on the shared path). ``ctx=None`` is the
    naive baseline: a fresh replay context per call (exactly what a
    plain ``predict_goodput`` does, under the walk's ``options``),
    re-paying the healthy-step DES and all replay state — the loop
    the fleet walk amortizes away."""
    if reshapes:
        if ctx is None:
            raise ConfigError(
                "naive fleet costing does not support elastic "
                "reshaping (the bench baseline is the rollback-"
                "restart loop)", phase="fleet",
            )
        report = elastic_goodput_walk(
            ctx, scenario, ctx.resolve_spec(scenario), reshapes,
            levels,
        )
    else:
        report = predict_goodput(
            perf, scenario, granularity=granularity, _ctx=ctx,
            options=options,
        )
    return report.to_dict()


#: per-worker-process state (the fault analysis's pool discipline)
_FLEET_WORKER: Dict[str, Any] = {}


def _fleet_worker_init(env: tuple):
    templates, timeout = env
    _FLEET_WORKER.clear()
    _FLEET_WORKER["templates"] = templates
    _FLEET_WORKER["ctxs"] = {}
    _FLEET_WORKER["shipped"] = {}
    _FLEET_WORKER["stats"] = {}
    _FLEET_WORKER["timeout"] = timeout


def _fleet_worker_ctx(key: str) -> ReplayContext:
    ctx = _FLEET_WORKER["ctxs"].get(key)
    if ctx is None:
        from simumax_tpu_torch.perf import PerfLLM

        strategy, model, system, granularity, options = \
            _FLEET_WORKER["templates"][key]
        perf = PerfLLM()
        perf.configure(strategy, model, system)
        perf.run_estimate()
        ctx = ReplayContext(perf, granularity=granularity,
                            options=options)
        _FLEET_WORKER["ctxs"][key] = ctx
        _FLEET_WORKER["shipped"][key] = set()
        _FLEET_WORKER["stats"][key] = dict(ctx.stats)
    return ctx


def _fleet_task(task: tuple):
    """One job costing on the worker's main thread (SIGALRM-effective
    deadline). Ships back the template's fresh canonical-cache entries
    and stat deltas for parent merge-back — cached values equal
    computed values by construction, so serial == parallel
    bit-for-bit."""
    idx, key, scenario, reshapes, levels = task
    ctx = _fleet_worker_ctx(key)
    with _deadline(_FLEET_WORKER["timeout"], f"fleet job[{idx}]"):
        report = _cost_job(ctx.perf, ctx, ctx.granularity, scenario,
                           reshapes, levels)
    shipped = _FLEET_WORKER["shipped"][key]
    fresh = {k: v for k, v in ctx._canon.items() if k not in shipped}
    shipped.update(fresh)
    last = _FLEET_WORKER["stats"][key]
    delta = {k: ctx.stats[k] - last.get(k, 0) for k in ctx.stats}
    _FLEET_WORKER["stats"][key] = dict(ctx.stats)
    return idx, key, report, fresh, delta


# --------------------------------------------------------------------------
# The fleet simulator
# --------------------------------------------------------------------------


@dataclass
class _Job:
    """Runtime state of one trace job."""

    spec: JobSpec
    idx: int
    state: str = "pending"  # pending/queued/running/suspended/done
    #: first-admission anchor: scenario t=0 (absolute fleet seconds)
    start_s: Optional[float] = None
    admitted_s: Optional[float] = None
    completed_s: Optional[float] = None
    queue_wait_s: float = 0.0
    suspended_at: Optional[float] = None
    #: pod -> sorted job ranks currently placed there
    placement: Dict[str, List[int]] = field(default_factory=dict)
    #: job ranks still alive (base-world numbering; reshapes drop)
    live_ranks: List[int] = field(default_factory=list)
    #: derived + scheduler fault entries (absolute times; see
    #: ``FleetSimulator._derive_window_events``)
    timeline: List[dict] = field(default_factory=list)
    #: (t_rel_s, replicas) elastic reshapes, job-relative
    reshapes: List[Tuple[float, int]] = field(default_factory=list)
    #: causing-event ids parallel to ``reshapes`` (``spot:{ri}``)
    reshape_causes: List[str] = field(default_factory=list)
    #: causing-event id of the live suspension (the resume freeze
    #: inherits it, so the wait is attributed to what evicted the job)
    suspend_cause: Optional[str] = None
    lost_replicas: int = 0
    n_suspensions: int = 0
    version: int = 0
    report: Optional[dict] = None

    @property
    def chips(self) -> int:
        return len(self.live_ranks)


class FleetSimulator:
    """One trace walk. Build, then :meth:`run` once; ``report`` holds
    the payload and ``stats`` the (deliberately payload-external)
    cache accounting."""

    #: event-kind processing order at equal times
    _ORDER = {"complete": 0, "reclaim": 1, "arrive": 2}

    def __init__(self, trace, jobs: int = 0,
                 elastic: Optional[bool] = None, naive: bool = False,
                 scenario_timeout: Optional[float] = None,
                 options: Optional[ReplayOptions] = None):
        self.trace = FleetTrace.load(trace)
        self.fleet = self.trace.fleet
        sched = self.fleet.scheduler
        self.policy = sched.policy
        self.elastic = sched.elastic if elastic is None else bool(elastic)
        self.naive = bool(naive)
        if self.naive and self.elastic:
            raise ConfigError(
                "naive=True models the per-job predict_goodput loop, "
                "which has no elastic reshaping; disable elastic for "
                "the baseline walk", phase="fleet",
            )
        self.jobs = max(0, int(jobs or 0))
        self.options = options
        self.scenario_timeout = scenario_timeout
        self._runtimes: Dict[str, TemplateRuntime] = {}
        self._pods = sorted(self.fleet.pods, key=lambda p: p.name)
        self._pod_total = {p.name: p.chips for p in self._pods}
        self._pod_free = dict(self._pod_total)
        self._jobs = [
            _Job(spec=j, idx=i) for i, j in enumerate(self.trace.jobs)
        ]
        self.decisions: List[dict] = []
        #: per-pod chip-occupancy deltas (``used`` = chips held by a
        #: job, ``cap`` = reclaimed capacity), recorded unconditionally
        #: for the explain/trace surfaces (never in the base payload)
        self.occupancy: List[dict] = []
        self.report: Optional[dict] = None
        self.stats: Dict[str, int] = {
            "costings": 0, "templates_built": 0, "ctx_shared": 0,
        }
        self._heap: List[tuple] = []
        self._seq = 0
        self._requests: List[int] = []
        self._pool = None
        from simumax_tpu_torch.observe.telemetry import get_registry

        self._reg = get_registry()
        self._g_slo = self._reg.gauge("fleet_slo_attainment")

    # -- bookkeeping helpers ----------------------------------------------
    def _push(self, t: float, kind: str, payload):
        self._seq += 1
        heapq.heappush(
            self._heap, (t, self._ORDER[kind], self._seq, kind, payload)
        )

    def _log(self, t: float, event: str, job: Optional[_Job],
             **detail):
        d = {"t_s": round(t, 6), "event": event}
        if job is not None:
            d["job"] = job.spec.name
        d.update(detail)
        self.decisions.append(d)
        self._reg.counter("fleet_jobs_total", event=event).inc()

    def _runtime(self, key: str) -> TemplateRuntime:
        rt = self._runtimes.get(key)
        if rt is None:
            rt = TemplateRuntime(self.trace.templates[key],
                                 options=self.options)
            self._runtimes[key] = rt
            self.stats["templates_built"] += 1
            self._reg.counter("fleet_template_ctx_total",
                              kind="built").inc()
        return rt

    # -- placement ---------------------------------------------------------
    def _pod_penalties(self, tpl: TemplateRuntime, t: float,
                       est_end: float) -> Dict[str, Tuple[float, float]]:
        """Per-pod ``(penalty_s, absorbable_s)`` over ``[t, est_end)``:
        maintenance overlap and intolerable-degradation overlap
        penalize; degradations within the template's critical-path
        link headroom on the degraded dim are absorbable (preferred —
        the slack gate will prove them free)."""
        out: Dict[str, Tuple[float, float]] = {}
        for p in self._pods:
            pen = absorb = 0.0
            for w in self.fleet.maintenance:
                if w.pod == p.name:
                    pen += max(
                        0.0, min(w.end_s, est_end) - max(w.start_s, t)
                    )
            for w in self.fleet.link_degradations:
                if w.pod != p.name:
                    continue
                ov = max(
                    0.0, min(w.end_s, est_end) - max(w.start_s, t)
                )
                if ov <= 0.0:
                    continue
                if (w.multiplier - 1.0) * 100.0 \
                        <= tpl.link_headroom_pct(w.dim):
                    absorb += ov
                else:
                    pen += ov
            out[p.name] = (pen, absorb)
        return out

    def _allocate(self, job: _Job, tpl: TemplateRuntime, t: float,
                  rank_ids: List[int],
                  pens: Optional[Dict[str, Tuple[float, float]]] = None,
                  ) -> Optional[Dict[str, List[int]]]:
        """Place ``rank_ids`` over pods by score: least penalized
        first, most absorbable-degradation first among equals (the
        headroom-bearing job soaks the degraded pod), then by name.
        Returns None when the fleet lacks the chips. ``pens`` reuses
        a penalty map the caller already computed for this
        ``(tpl, t)``."""
        need = len(rank_ids)
        if sum(self._pod_free.values()) < need:
            return None
        if pens is None:
            est_end = (t + tpl.healthy_step_s
                       * job.spec.horizon_steps * 1.5)
            pens = self._pod_penalties(tpl, t, est_end)
        order = sorted(
            (p.name for p in self._pods),
            key=lambda n: (pens[n][0], -pens[n][1], n),
        )
        placement: Dict[str, List[int]] = {}
        i = 0
        for name in order:
            take = min(self._pod_free[name], need - i)
            if take <= 0:
                continue
            placement[name] = rank_ids[i:i + take]
            i += take
            if i == need:
                break
        for name, ranks in placement.items():
            self._pod_free[name] -= len(ranks)
            self.occupancy.append({
                "t": t, "pod": name, "used": len(ranks),
                "job": job.spec.name,
            })
        return placement

    def _release(self, job: _Job, t: float):
        for name, ranks in job.placement.items():
            self._pod_free[name] += len(ranks)
            self.occupancy.append({
                "t": t, "pod": name, "used": -len(ranks),
                "job": job.spec.name,
            })
        job.placement = {}

    # -- fault-event derivation --------------------------------------------
    def _derive_window_events(self, job: _Job, t_from: float):
        """(Re)derive the pod-window fault entries for ``job``'s
        current placement from ``t_from`` on: maintenance freezes the
        job ranks on the pod, link degradations scale the dim scoped
        to those ranks. Prior window derivations are clipped at
        ``t_from`` (the remainder is re-derived below under the new
        placement — keeping them whole would double-apply the
        overlap, and multiplicative link windows would compound);
        scheduler entries (kills, suspension freezes) are
        placement-independent and kept whole."""
        kept = []
        for e in job.timeline:
            if e["src"] == "sched":
                kept.append(e)
                continue
            if e["t"] >= t_from:
                continue  # re-derived below
            dur = min(e["dur"], t_from - e["t"])
            if dur > 0:
                kept.append(dict(e, dur=dur))
        job.timeline = kept
        for wi, w in enumerate(self.fleet.maintenance):
            if w.end_s <= t_from:
                continue
            start = max(w.start_s, t_from)
            for pod, ranks in sorted(job.placement.items()):
                if pod != w.pod:
                    continue
                # one ranks-list event per (window, pod): exactly
                # equivalent to per-rank events, O(pod) cheaper
                job.timeline.append({
                    "t": start, "kind": "preemption",
                    "ranks": list(ranks), "dur": w.end_s - start,
                    "src": f"maint:{wi}",
                })
        for wi, w in enumerate(self.fleet.link_degradations):
            if w.end_s <= t_from:
                continue
            start = max(w.start_s, t_from)
            for pod, ranks in sorted(job.placement.items()):
                if pod != w.pod:
                    continue
                job.timeline.append({
                    "t": start, "kind": "link_degradation",
                    "dim": w.dim, "mult": w.multiplier,
                    "ranks": list(ranks), "dur": w.end_s - start,
                    "src": f"link:{wi}",
                })

    def _materialize(self, job: _Job, with_causes: bool = False):
        """The job's scenario in its own frame (ms from first
        admission), deterministically ordered. ``with_causes=True``
        additionally returns the causing-event id of each scenario
        event, index-parallel (window events carry their window id,
        scheduler events the recorded eviction cause) — the fleet
        ledger's event -> job causality."""
        events: List[FaultEvent] = []
        causes: List[str] = []
        for e in sorted(
            job.timeline,
            key=lambda e: (e["t"], e["kind"], e.get("rank", -1),
                           tuple(e.get("ranks") or ()), e["src"]),
        ):
            start_ms = (e["t"] - job.start_s) * 1e3
            if start_ms < 0:
                continue
            if e["kind"] == "preemption":
                events.append(FaultEvent(
                    "preemption", start_ms=start_ms,
                    duration_ms=e["dur"] * 1e3, rank=e.get("rank"),
                    ranks=list(e["ranks"]) if e.get("ranks")
                    else None,
                ))
            elif e["kind"] == "link_degradation":
                events.append(FaultEvent(
                    "link_degradation", start_ms=start_ms,
                    duration_ms=e["dur"] * 1e3, dim=e["dim"],
                    multiplier=e["mult"], ranks=list(e["ranks"]),
                ))
            elif e["kind"] == "rank_death":
                events.append(FaultEvent(
                    "rank_death", start_ms=start_ms, rank=e["rank"],
                ))
            else:
                continue
            causes.append(e.get("cause", e["src"]))
        scenario = FaultScenario(
            events=events, horizon_steps=job.spec.horizon_steps,
            checkpoint=job.spec.checkpoint,
        )
        if with_causes:
            return scenario, causes
        return scenario

    # -- scheduler actions -------------------------------------------------
    def _suspend(self, job: _Job, t: float, reason: str, cause: str):
        """Kill + park a running job: its chips free immediately, a
        death event enters its scenario, and the wait until resume
        becomes an all-rank freeze appended at resume time. ``cause``
        names the evicting trace event (``preempt:{job}`` /
        ``spot:{ri}``) for the attribution ledger."""
        tpl = self._runtime(job.spec.template)
        victim_rank = job.live_ranks[0]
        job.timeline.append({
            "t": t, "kind": "rank_death", "rank": victim_rank,
            "src": "sched", "cause": cause,
        })
        self._release(job, t)
        job.state = "suspended"
        job.suspended_at = t
        job.suspend_cause = cause
        job.n_suspensions += 1
        job.version += 1
        job.report = None
        self._log(t, reason, job, rank=victim_rank,
                  orbit=tpl.orbit(victim_rank), cause=cause)

    def _admit(self, t: float):
        """Admission pass: scan the wait queue in policy order, place
        whoever fits (priority policy may preempt lower-priority
        running jobs to make room)."""
        while True:
            waiting = [
                j for j in self._jobs
                if j.state in ("queued", "suspended")
            ]
            if not waiting:
                return
            if self.policy == "priority":
                waiting.sort(key=lambda j: (
                    -j.spec.priority, j.spec.arrival_s, j.idx,
                ))
            else:
                waiting.sort(key=lambda j: (j.spec.arrival_s, j.idx))
            admitted_one = False
            for job in waiting:
                tpl = self._runtime(job.spec.template)
                if not job.live_ranks:
                    job.live_ranks = list(range(tpl.world_size))
                need = job.chips
                pens = self._pod_penalties(
                    tpl, t,
                    t + tpl.healthy_step_s
                    * job.spec.horizon_steps * 1.5,
                )
                placement = self._allocate(job, tpl, t,
                                           job.live_ranks, pens=pens)
                if placement is None and self.policy == "priority":
                    victims = [
                        v for v in self._jobs
                        if v.state == "running"
                        and v.spec.priority < job.spec.priority
                    ]
                    victims.sort(key=lambda v: (
                        v.spec.priority, -(v.admitted_s or 0.0),
                        -v.idx,
                    ))
                    freeable = sum(self._pod_free.values())
                    chosen = []
                    for v in victims:
                        if freeable >= need:
                            break
                        chosen.append(v)
                        freeable += v.chips
                    if freeable >= need:
                        for v in chosen:
                            self._suspend(v, t, "preempted",
                                          f"preempt:{job.spec.name}")
                        placement = self._allocate(
                            job, tpl, t, job.live_ranks, pens=pens,
                        )
                if placement is None:
                    if self.policy == "fifo":
                        return
                    continue
                job.placement = placement
                resumed = job.state == "suspended"
                waited = (t - job.suspended_at) if resumed else 0.0
                job.state = "running"
                if job.start_s is None:
                    job.start_s = job.admitted_s = t
                    job.queue_wait_s = t - job.spec.arrival_s
                    event = "admitted"
                else:
                    # the whole suspension becomes an all-rank freeze
                    # (a killed job waiting for chips makes no
                    # progress; the walk stalls through it)
                    if waited > 0.0:
                        job.timeline.append({
                            "t": job.suspended_at,
                            "kind": "preemption",
                            "ranks": list(job.live_ranks),
                            "dur": waited, "src": "sched",
                            "cause": job.suspend_cause or "sched",
                        })
                    event = "resumed"
                self._derive_window_events(job, t)
                detail = {"pods": sorted(placement)}
                if resumed:
                    detail["waited_s"] = round(waited, 6)
                    if job.suspend_cause:
                        detail["cause"] = job.suspend_cause
                job.suspended_at = None
                job.suspend_cause = None
                absorbed = [
                    p for p in sorted(placement) if pens[p][1] > 0.0
                ]
                if absorbed:
                    detail["absorbs_degraded"] = absorbed
                    detail["headroom_pct"] = round(
                        tpl.link_headroom_pct(), 4
                    )
                self._log(t, event, job, **detail)
                self._request_cost(job)
                admitted_one = True
                break  # re-sort the queue after any state change
            if not admitted_one:
                return

    def _apply_reclaim(self, t: float, ri: int, rec):
        """Spot reclaim: chips leave the pod; free chips go first,
        then spot jobs on the pod — lowest priority first, cascading
        to further victims while chips remain to be taken — each
        reshaping (elastic) or being killed (restart on backfill /
        suspension). A remainder no spot job can cover is logged as
        ``shortfall`` (non-spot capacity is never reclaimed).
        ``ri`` is the reclaim's index in the deterministic
        ``materialize_spot()`` enumeration — the ``spot:{ri}`` cause
        id every consequence of this reclaim is attributed to."""
        pod = rec.pod
        cause = f"spot:{ri}"
        take_free = min(self._pod_free[pod], rec.chips)
        self._pod_free[pod] -= take_free
        self._pod_total[pod] -= take_free
        if take_free:
            self.occupancy.append({"t": t, "pod": pod,
                                   "cap": -take_free})
        rem = rec.chips - take_free
        if rem <= 0:
            self._log(t, "reclaimed", None, pod=pod,
                      chips=rec.chips, idle=take_free, cause=cause)
            return
        while rem > 0:
            victims = [
                j for j in self._jobs
                if j.state == "running" and j.spec.spot
                and j.placement.get(pod)
            ]
            victims.sort(key=lambda j: (
                j.spec.priority, -(j.admitted_s or 0.0), -j.idx,
            ))
            if not victims:
                # only spot capacity is reclaimable; the rest stays
                self._log(t, "reclaimed", None, pod=pod,
                          chips=rec.chips, idle=take_free,
                          shortfall=rem, cause=cause)
                return
            job = victims[0]
            tpl = self._runtime(job.spec.template)
            on_pod = job.placement[pod]
            take = min(len(on_pod), rem)
            taken_ranks = on_pod[-take:]
            self._pod_total[pod] -= take
            self.occupancy.append({"t": t, "pod": pod, "cap": -take})
            rem -= take
            self._log(t, "reclaimed", job, pod=pod, chips=rec.chips,
                      idle=take_free, taken=take, cause=cause)
            handled = False
            if self.elastic:
                replicas = -(-take // tpl.replica_chips)
                total = job.lost_replicas + replicas
                if tpl.reshape_feasible(total):
                    self._reshape(job, tpl, t, pod, taken_ranks,
                                  replicas, cause)
                    handled = True
            if not handled:
                self._kill_for_reclaim(job, tpl, t, pod, taken_ranks,
                                       cause)

    def _reshape(self, job: _Job, tpl: TemplateRuntime, t: float,
                 pod: str, taken_ranks: List[int], replicas: int,
                 cause: str):
        """Elastic dp shrink: drop whole replicas covering the taken
        chips; surplus chips return to their pods' free pools; the
        job continues at the shrunk level without rollback."""
        drop_n = replicas * tpl.replica_chips
        job.lost_replicas += replicas
        # memoize the level now (the walk's flush reuses it)
        h_level, _redist = tpl.level(job.lost_replicas)
        # drop the taken ranks first, then the highest live ranks up
        # to whole replicas; the taken chips left the fleet, the
        # surplus returns to its pods' free pools
        taken = set(taken_ranks)
        extra = [
            r for r in reversed(job.live_ranks) if r not in taken
        ][:drop_n - len(taken)]
        dropped = set(taken) | set(extra)
        job.live_ranks = [
            r for r in job.live_ranks if r not in dropped
        ]
        for name in sorted(job.placement):
            ranks = job.placement[name]
            kept = [r for r in ranks if r not in dropped]
            freed = sum(
                1 for r in ranks
                if r in dropped and r not in taken
            )
            if freed:
                self._pod_free[name] += freed
            if len(kept) != len(ranks):
                self.occupancy.append({
                    "t": t, "pod": name,
                    "used": len(kept) - len(ranks),
                    "job": job.spec.name,
                })
            if kept:
                job.placement[name] = kept
            else:
                del job.placement[name]
        dropped = sorted(dropped)
        job.reshapes.append((t - job.start_s, replicas))
        job.reshape_causes.append(cause)
        # window events for ranks that no longer exist are harmless
        # (they target dropped ranks the walk never consults), but
        # re-derive for cleanliness on the shrunk placement
        self._derive_window_events(job, t)
        job.version += 1
        self._log(t, "reshaped", job, replicas=replicas,
                  level=job.lost_replicas,
                  chips=len(job.live_ranks),
                  orbit=tpl.orbit(dropped[0]),
                  step_scale=round(h_level / tpl.healthy_step_s, 6),
                  cause=cause)
        self._request_cost(job)

    def _kill_for_reclaim(self, job: _Job, tpl: TemplateRuntime,
                          t: float, pod: str,
                          taken_ranks: List[int], cause: str):
        """Non-elastic reclaim: the job dies at the reclaim and
        restarts from its last checkpoint — on backfilled chips when
        the fleet has them, suspended until capacity frees
        otherwise."""
        victim = taken_ranks[0]
        # remove the taken chips from the placement (they left the
        # fleet); the rest of the job's chips stay held for backfill
        kept = [r for r in job.placement[pod] if r not in
                set(taken_ranks)]
        self.occupancy.append({
            "t": t, "pod": pod, "used": -len(taken_ranks),
            "job": job.spec.name,
        })
        if kept:
            job.placement[pod] = kept
        else:
            del job.placement[pod]
        job.timeline.append({
            "t": t, "kind": "rank_death", "rank": victim,
            "src": "sched", "cause": cause,
        })
        backfill = self._allocate(job, tpl, t, taken_ranks)
        if backfill is not None:
            for name, ranks in backfill.items():
                job.placement[name] = sorted(
                    job.placement.get(name, []) + ranks
                )
            self._derive_window_events(job, t)
            job.version += 1
            self._log(t, "restarted", job, rank=victim,
                      orbit=tpl.orbit(victim),
                      backfill=sorted(backfill), cause=cause)
            self._request_cost(job)
        else:
            self._release(job, t)
            job.state = "suspended"
            job.suspended_at = t
            job.suspend_cause = cause
            job.n_suspensions += 1
            job.version += 1
            job.report = None
            self._log(t, "frozen", job, rank=victim,
                      orbit=tpl.orbit(victim), cause=cause)

    # -- costing -----------------------------------------------------------
    def _request_cost(self, job: _Job):
        if job.idx not in self._requests:
            self._requests.append(job.idx)

    def _job_levels(self, job: _Job,
                    rt: TemplateRuntime) -> Dict[int, Tuple[float, float]]:
        """The job's elastic shrink-level table for costing:
        ``{cumulative_replicas: (healthy_step_s, reshape_cost_s)}``
        with one redistribution collective per replica lost at each
        event plus the scheduler's fixed re-init overhead. Shared by
        the walk's flush and the attribution ledger's re-drive."""
        levels: Dict[int, Tuple[float, float]] = {}
        if job.reshapes:
            overhead = self.fleet.scheduler.reshape_overhead_s
            lost = 0
            for (_tr, reps) in job.reshapes:
                lost += reps
                h_l, redist = rt.level(lost)
                levels[lost] = (h_l, redist * reps + overhead)
        return levels

    def _cost_serial(self, batch: List[tuple]) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        # lockstep costing: jobs sharing a template context advance
        # their goodput walks in rounds, so one flush's step misses
        # reach the batched replay backend together instead of one at
        # a time (bit-identical to the serial loop — the replay cache
        # contract). Reshape jobs walk the elastic path and per-job
        # SIGALRM deadlines need one job on the clock at a time, so
        # both keep the serial loop.
        lockstep: Dict[str, List[Tuple[int, FaultScenario]]] = {}
        for (idx, key, scenario, reshapes, levels) in batch:
            rt = self._runtimes[key]
            if (self.naive or reshapes
                    or self.scenario_timeout is not None):
                ctx = None if self.naive else rt.ctx
                with _deadline(self.scenario_timeout,
                               f"fleet job[{idx}]"):
                    out[idx] = _cost_job(
                        rt.perf, ctx, rt.granularity, scenario,
                        reshapes, levels, options=rt.ctx.options,
                    )
            else:
                lockstep.setdefault(key, []).append((idx, scenario))
        for key in sorted(lockstep):
            ctx = self._runtimes[key].ctx
            items = lockstep[key]
            reports = _predict_goodput_batch(
                ctx,
                [(sc, ctx.resolve_spec(sc)) for _i, sc in items],
            )
            for (idx, _sc), report in zip(items, reports):
                out[idx] = report.to_dict()
        return out

    def _cost_pool(self, batch: List[tuple]) -> Dict[int, dict]:
        if self._pool is None:
            import concurrent.futures as _cf

            from simumax_tpu_torch.simulator.faults import _mc_context

            templates = {
                key: (rt.perf.strategy, rt.perf.model_config,
                      rt.perf.system, rt.granularity,
                      rt.ctx.options)
                for key, rt in sorted(self._runtimes.items())
            }
            # templates not yet built in the parent cannot appear in
            # a batch (the runtime is built at admission), so the
            # worker env is complete for this walk
            self._pool = _cf.ProcessPoolExecutor(
                max_workers=self.jobs,
                mp_context=_mc_context(),
                initializer=_fleet_worker_init,
                initargs=((templates, self.scenario_timeout),),
            )
        futures = [
            self._pool.submit(_fleet_task, task) for task in batch
        ]
        out: Dict[int, dict] = {}
        for fut in futures:
            idx, key, report, fresh, delta = fut.result()
            rt = self._runtimes[key]
            rt.ctx._canon.update(fresh)
            rt.ctx.absorb_stats(delta)
            out[idx] = report
        return out

    def _flush(self, t: float):
        """Cost every job whose scenario changed in this time group,
        in deterministic job order, then (re)schedule completions.
        Serial and pooled costing are bit-identical (the replay cache's
        contract), so the walk's decisions cannot depend on the
        mode."""
        if not self._requests:
            return
        from simumax_tpu_torch.observe.telemetry import get_tracer

        reqs = sorted(self._requests)
        self._requests = []
        batch = []
        for idx in reqs:
            job = self._jobs[idx]
            if job.state != "running":
                continue
            key = job.spec.template
            rt = self._runtimes[key]
            scenario = self._materialize(job)
            levels = self._job_levels(job, rt)
            batch.append((idx, key, scenario,
                          list(job.reshapes), levels))
            self.stats["costings"] += 1
            if not self.naive:
                self.stats["ctx_shared"] += 1
                self._reg.counter("fleet_template_ctx_total",
                                  kind="shared").inc()
        if not batch:
            return
        with get_tracer().span("fleet_cost", n=len(batch),
                               t_s=round(t, 3)):
            if self.jobs > 1 and not self.naive and len(batch) > 1:
                results = self._cost_pool(batch)
            else:
                results = self._cost_serial(batch)
        for idx in sorted(results):
            job = self._jobs[idx]
            job.report = results[idx]
            job.version += 1
            end = job.start_s + job.report["wall_time_s"]
            self._push(end, "complete", (idx, job.version))

    def prepare(self) -> "FleetSimulator":
        """Build every referenced template's *estimate* ahead of the
        walk (replay state — healthy DES, streams, caches — stays
        lazy). The bench calls this untimed on both modes: shared and
        naive walks share the template estimates either way, so the
        timed comparison isolates what the modes actually differ in —
        the replay state."""
        for key in sorted({j.spec.template for j in self._jobs}):
            self._runtime(key)
        return self

    # -- the walk ----------------------------------------------------------
    def run(self) -> dict:
        from simumax_tpu_torch.observe.telemetry import get_tracer

        if self.report is not None:
            return self.report
        # every referenced template is built up front: the pool
        # worker env snapshots the runtime set at pool creation, and
        # eager builds keep "templates_built" mode-independent
        self.prepare()
        for j in self._jobs:
            self._push(j.spec.arrival_s, "arrive", j.idx)
        for ri, rec in enumerate(self.fleet.materialize_spot()):
            self._push(rec.start_s, "reclaim", (ri, rec))
        makespan = 0.0
        try:
            with get_tracer().span(
                "fleet_walk", jobs=len(self._jobs),
                templates=len(self.trace.templates),
                policy=self.policy, elastic=self.elastic,
            ):
                while self._heap:
                    t = self._heap[0][0]
                    while self._heap and self._heap[0][0] == t:
                        _, _, _, kind, payload = heapq.heappop(
                            self._heap
                        )
                        if kind == "arrive":
                            job = self._jobs[payload]
                            job.state = "queued"
                            self._log(t, "queued", job,
                                      template=job.spec.template,
                                      priority=job.spec.priority)
                        elif kind == "reclaim":
                            self._apply_reclaim(t, *payload)
                        elif kind == "complete":
                            idx, version = payload
                            job = self._jobs[idx]
                            if (job.state != "running"
                                    or job.version != version):
                                continue  # stale completion
                            job.state = "done"
                            job.completed_s = t
                            makespan = max(makespan, t)
                            self._release(job, t)
                            self._log(t, "completed", job,
                                      goodput=round(
                                          job.report["goodput"], 9))
                    self._admit(t)
                    self._flush(t)
                for job in self._jobs:
                    if job.state != "done":
                        self._log(makespan, "starved", job,
                                  state=job.state)
        finally:
            if self._pool is not None:
                self._pool.shutdown(cancel_futures=True)
                self._pool = None
        from simumax_tpu_torch.fleet.report import build_fleet_report

        self.report = build_fleet_report(self)
        self._g_slo.set(self.report["slo"]["fraction"])
        return self.report


def simulate_fleet(trace, jobs: int = 0,
                   elastic: Optional[bool] = None,
                   naive: bool = False,
                   scenario_timeout: Optional[float] = None,
                   options: Optional[ReplayOptions] = None,
                   explain: bool = False) -> dict:
    """Walk a fleet trace and return the fleet report (docs/fleet.md
    schema ``simumax-fleet-v1``). ``jobs=N`` fans job costings across
    a worker pool (serial == parallel bit-for-bit); ``naive=True``
    re-pays replay state per costing call — the bench baseline;
    ``elastic`` overrides the trace's scheduler setting.
    ``explain=True`` attaches the causal attribution ledger, the SLO
    counterfactual probe table and the Chrome-trace span records
    under an ``explain`` key (``observe/fleetledger.py``); the rest
    of the payload is byte-identical to an ``explain=False`` run."""
    sim = FleetSimulator(
        trace, jobs=jobs, elastic=elastic, naive=naive,
        scenario_timeout=scenario_timeout, options=options,
    )
    report = sim.run()
    if explain:
        from simumax_tpu_torch.observe.fleetledger import build_fleet_explain

        report = dict(report)
        report["explain"] = build_fleet_explain(sim)
    return report


__all__ = [
    "TemplateRuntime",
    "FleetSimulator",
    "simulate_fleet",
    "elastic_goodput_walk",
]

"""Fault injection, checkpoint/restore cost model, goodput prediction.

SimuMax predicts MFU for a *healthy* job; at pod scale a real TPU
training run also spends wall-clock on preemptions, slow hosts,
degraded links, and checkpoint/restore — the gap between MFU and
*goodput* that resilient-training systems (Bamboo, Oobleck) exist to
close. This module makes failure a first-class, simulatable input:

* :class:`FaultEvent` / :class:`FaultScenario` — a declarative,
  JSON-loadable timeline of faults: per-rank compute-slowdown windows,
  ICI/DCN link-bandwidth degradation scoped to specific collective
  groups, host preemptions (a rank frozen for a window), and rank
  deaths followed by restart-from-checkpoint.
* :class:`StepFaultModel` — the discrete-event engine's view of one
  training step: piecewise compute-rate multipliers integrated at
  event-service time, comm-time multipliers per collective dim, and
  death times. A dead rank no longer deadlocks the world: its
  collective partners resolve against the fault model
  (``SimuEngine`` consults it, see ``simulator/engine.py``) and the
  run returns a structured :class:`FaultOutcome` instead of crashing.
* :class:`CheckpointCostModel` — checkpoint write / restore read times
  derived from :class:`~simumax_tpu_torch.core.config.SystemConfig`'s
  HBM→host→storage chain (``SystemConfig.host``) and the per-rank
  weight + optimizer-state bytes of the estimate.
* :func:`predict_goodput` — composes perturbed step simulations,
  periodic checkpoint writes, and death→restart→replay sequences into
  a wall-time decomposition (:class:`GoodputBuckets`) whose buckets
  sum to the wall time exactly; ``goodput = useful_train / wall``.
* :func:`analyze_faults` — seeded Monte-Carlo over sampled scenarios:
  goodput distribution plus the empirically optimal checkpoint
  interval (cross-checked against the Young–Daly closed form).
* :class:`ReplayContext` — the incremental fault-replay engine:
  per-estimate memoized state that makes the Monte-Carlo
  hot path ~free with **bit-identical** reports. Four independent,
  individually toggleable optimizations (:class:`ReplayOptions`):

  1. *slack-gated short-circuit* — a perturbed step whose fault
     timeline provably fits inside the healthy step's critical-path
     slack headroom (``observe/critpath.py`` ``slack_index``) moves
     the makespan by zero, so it is answered as the healthy step
     without simulating;
  2. *symmetry-canonicalized step cache* — sub-scenario cache keys are
     normalized through ``reduce.py``'s color-refinement classes, so
     two scenarios hitting symmetric ranks share one replay;
  3. *healthy-prefix fork* — each scenario partition's step program is
     recorded once (``RecordingProc``) and replayed (``ReplayProc``);
     the engine is paused at the first fault onset and the paused
     state forked into a snapshot ladder, so later scenarios replay
     only the suffix after their onset;
  4. *process-parallel Monte-Carlo* — ``analyze_faults(jobs=N)`` fans
     scenarios across a worker pool with the sweep executor's discipline
     (worker-main-thread SIGALRM deadlines, canonical-cache
     merge-back, serial == parallel bit-for-bit).

All scenario times are **milliseconds relative to the simulated
window** (one step for ``simulate(faults=...)``; job wall-clock for
:func:`predict_goodput`, which re-bases events per step itself).

Copy of the JAX package's ``simulator/faults.py`` with its import paths
changed and the batched miss replay moved from JAX to the card:
``ReplayOptions.replay_backend`` takes ``"numpy"``, ``"cuda"`` (every
lowerable miss group through the CUDA kernel of
``simulator/batched_replay.py``) or ``"auto"`` (the kernel for groups
of at least ``JIT_BATCH_MIN``), and ``ReplayOptions.device`` (default
``"cuda"``; ``"cpu"`` runs the kernel's plain PyTorch version). A
backend that needs the card raises at :class:`ReplayContext`
construction when there is none; the JAX package's ``jax_unavailable``
fallback has no counterpart. ``analyze_faults(jobs=N)`` starts its
workers with ``spawn`` once this process has initialised CUDA.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from simumax_tpu_torch.core.errors import ConfigError, SimulationError
from simumax_tpu_torch.core.records import GoodputBuckets

EVENT_KINDS = ("slowdown", "link_degradation", "preemption", "rank_death")

#: dims a link_degradation may target: the collective-group dims the
#: schedule issues rendezvous on, plus "pp" (p2p) and "*" (every comm op)
LINK_DIMS = ("tp", "cp", "ep", "etp", "dp_cp", "edp", "pp", "*")

#: canonical-cache probes tolerated without a single hit before the
#: layer goes dormant for the context's lifetime (probing serializes
#: the whole engine problem — the costliest key in the pipeline)
CANON_PROBE_LIMIT = 512


# --------------------------------------------------------------------------
# Scenario schema
# --------------------------------------------------------------------------


@dataclass
class FaultEvent:
    """One timed fault. Field use per ``kind``:

    * ``slowdown`` — ``rank``'s compute takes ``multiplier``× longer
      during ``[start_ms, start_ms + duration_ms)`` (``duration_ms``
      None = until the end of the window).
    * ``preemption`` — ``rank`` is frozen (makes no progress) for
      ``duration_ms`` starting at ``start_ms``; collective partners
      stall on its late arrivals.
    * ``link_degradation`` — comm ops on ``dim`` take ``multiplier``×
      longer while active; ``ranks`` (optional) scopes it to ops whose
      rendezvous involves at least one listed rank.
    * ``rank_death`` — ``rank`` dies at ``start_ms`` and never
      returns; the job must restart from the last checkpoint
      (:func:`predict_goodput` accounts the restart).

    ``slowdown`` / ``preemption`` / ``rank_death`` may target a
    ``ranks`` *list* instead of a single ``rank`` — exactly equivalent
    to (and bit-identical with) one single-rank event per listed rank,
    but O(ranks) cheaper to window and replay. The fleet simulator
    leans on this: a maintenance window freezing a 128-chip pod is one
    event, not 128 (``fleet/sim.py``).
    """

    kind: str
    start_ms: float = 0.0
    duration_ms: Optional[float] = None
    rank: Optional[int] = None
    multiplier: float = 1.0
    dim: Optional[str] = None
    ranks: Optional[List[int]] = None

    @property
    def end_ms(self) -> float:
        if self.kind == "rank_death":
            return math.inf
        if self.duration_ms is None:
            return math.inf
        return self.start_ms + self.duration_ms

    def targets(self) -> Tuple[int, ...]:
        """The perturbed ranks: ``rank`` or the ``ranks`` list (for
        ``link_degradation`` the list is a *scope*, not a target —
        this returns () there)."""
        if self.kind == "link_degradation":
            return ()
        if self.rank is not None:
            return (self.rank,)
        if self.ranks is not None:
            return tuple(self.ranks)
        return ()

    def validate(self, world_size: Optional[int] = None) -> "FaultEvent":
        def bad(msg):
            raise ConfigError(
                f"fault event {self.to_dict()}: {msg}",
                phase="simulate", fault_kind=self.kind,
            )

        if self.kind not in EVENT_KINDS:
            bad(f"unknown kind (expected one of {EVENT_KINDS})")
        if not (isinstance(self.start_ms, (int, float))
                and math.isfinite(self.start_ms) and self.start_ms >= 0):
            bad("start_ms must be a finite non-negative number")
        if self.duration_ms is not None and not (
            isinstance(self.duration_ms, (int, float))
            and math.isfinite(self.duration_ms) and self.duration_ms > 0
        ):
            bad("duration_ms must be a finite positive number")
        if self.kind in ("slowdown", "preemption", "rank_death"):
            if self.rank is None and not self.ranks:
                bad("needs a target rank (or a ranks list)")
            if self.rank is not None and self.ranks is not None:
                bad("rank and ranks are mutually exclusive")
            if world_size is not None:
                oob = [r for r in self.targets()
                       if not 0 <= r < world_size]
                if oob:
                    bad(f"rank {oob[0]} outside world "
                        f"[0, {world_size})")
        if self.kind == "preemption" and self.duration_ms is None:
            bad("preemption needs a finite duration_ms")
        if self.kind in ("slowdown", "link_degradation"):
            if not (math.isfinite(self.multiplier) and self.multiplier >= 1.0):
                bad("multiplier must be finite and >= 1.0")
        if self.kind == "link_degradation":
            if self.dim not in LINK_DIMS:
                bad(f"dim {self.dim!r} not one of {LINK_DIMS}")
            if self.ranks is not None and world_size is not None:
                oob = [r for r in self.ranks
                       if not 0 <= r < world_size]
                if oob:
                    bad(f"scope ranks {oob} outside world "
                        f"[0, {world_size})")
        return self

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "start_ms": self.start_ms}
        if self.duration_ms is not None:
            d["duration_ms"] = self.duration_ms
        if self.rank is not None:
            d["rank"] = self.rank
        if self.kind in ("slowdown", "link_degradation"):
            d["multiplier"] = self.multiplier
        if self.dim is not None:
            d["dim"] = self.dim
        if self.ranks is not None:
            d["ranks"] = list(self.ranks)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultEvent":
        known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        extra = set(d) - known
        if extra:
            raise ConfigError(
                f"fault event has unknown fields {sorted(extra)} "
                f"(known: {sorted(known)})", phase="simulate",
            )
        return cls(**d)

    def signature(self) -> tuple:
        """Hashable identity used for symmetry-reduction coloring."""
        return (self.kind, self.start_ms, self.duration_ms,
                self.multiplier, self.dim)


@dataclass
class FaultScenario:
    """A declarative fault timeline plus the job-level knobs goodput
    prediction needs (horizon length, checkpoint overrides)."""

    events: List[FaultEvent] = field(default_factory=list)
    #: job horizon for goodput prediction (training steps)
    horizon_steps: int = 100
    #: optional :class:`CheckpointSpec` field overrides
    checkpoint: Optional[Dict[str, Any]] = None
    #: provenance when sampled by :func:`sample_scenario`
    seed: Optional[int] = None

    @property
    def empty(self) -> bool:
        return not self.events

    def validate(self, world_size: Optional[int] = None) -> "FaultScenario":
        if not isinstance(self.horizon_steps, int) or self.horizon_steps < 1:
            raise ConfigError(
                f"horizon_steps must be a positive int, got "
                f"{self.horizon_steps!r}", phase="simulate",
            )
        for ev in self.events:
            ev.validate(world_size)
        return self

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "schema": "simumax-fault-scenario-v1",
            "horizon_steps": self.horizon_steps,
            "events": [e.to_dict() for e in self.events],
        }
        if self.checkpoint:
            d["checkpoint"] = dict(self.checkpoint)
        if self.seed is not None:
            d["seed"] = self.seed
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultScenario":
        schema = d.get("schema", "simumax-fault-scenario-v1")
        if schema != "simumax-fault-scenario-v1":
            raise ConfigError(
                f"unknown fault-scenario schema {schema!r}",
                phase="simulate",
            )
        events = [
            e if isinstance(e, FaultEvent) else FaultEvent.from_dict(e)
            for e in d.get("events", [])
        ]
        return cls(
            events=events,
            horizon_steps=int(d.get("horizon_steps", 100)),
            checkpoint=d.get("checkpoint"),
            seed=d.get("seed"),
        )

    @classmethod
    def from_json(cls, path: str) -> "FaultScenario":
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            raise ConfigError(
                f"cannot load fault scenario {path}: {exc}",
                phase="simulate", path=path,
            )
        return cls.from_dict(data)

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    # -- step windowing / reduction support --------------------------------
    def shifted(self, offset_ms: float, span_ms: float) -> "FaultScenario":
        """The sub-scenario active inside ``[offset, offset + span)``,
        with event times re-based to the window start (clamped at 0 —
        an event already in progress is active from the window start,
        with its remaining duration)."""
        out: List[FaultEvent] = []
        for ev in self.events:
            if ev.kind == "rank_death":
                if offset_ms <= ev.start_ms < offset_ms + span_ms:
                    out.append(FaultEvent(
                        "rank_death", start_ms=ev.start_ms - offset_ms,
                        rank=ev.rank,
                        ranks=list(ev.ranks)
                        if ev.ranks is not None else None,
                    ))
                continue
            if ev.end_ms <= offset_ms or ev.start_ms >= offset_ms + span_ms:
                continue
            start = max(ev.start_ms - offset_ms, 0.0)
            dur = None
            if ev.duration_ms is not None:
                dur = ev.end_ms - offset_ms - start
            out.append(FaultEvent(
                ev.kind, start_ms=start, duration_ms=dur, rank=ev.rank,
                multiplier=ev.multiplier, dim=ev.dim,
                ranks=list(ev.ranks) if ev.ranks is not None else None,
            ))
        return FaultScenario(events=out, horizon_steps=self.horizon_steps,
                             checkpoint=self.checkpoint, seed=self.seed)

    def signature(self) -> tuple:
        """Hashable identity of the event set (step-result caching)."""
        return tuple(
            ev.signature() + (ev.rank, tuple(ev.ranks) if ev.ranks else None)
            for ev in self.events
        )

    def rank_signatures(self) -> Dict[int, tuple]:
        """Per-rank fault signature for rank-symmetry reduction: two
        ranks with different signatures must land in different classes
        (``simulator/reduce.py`` colors on this), so a fault shatters
        exactly the symmetry it breaks — globally-scoped link events
        perturb every group of a dim identically and shatter nothing."""
        sigs: Dict[int, List[tuple]] = {}
        for ev in self.events:
            targets: Sequence[int] = ev.targets()
            if ev.kind == "link_degradation" and ev.ranks is not None:
                targets = ev.ranks
            for r in targets:
                sigs.setdefault(r, []).append(ev.signature())
        return {r: tuple(sorted(s)) for r, s in sigs.items()}


# --------------------------------------------------------------------------
# Engine-facing fault model (one step window, times in SECONDS)
# --------------------------------------------------------------------------


def key_dim(key) -> Optional[str]:
    """Collective dim of an engine rendezvous key. Keys are either
    ``(dim, group)`` tuples (leaf collectives), strings like
    ``"grad_rs:dp_cp"`` / ``"param_ag:edp"`` (bucketed DP streams and
    their async-stream names), or ``"optimizer_barrier"``. Shared with
    the critical-path engine (``observe/critpath.py``), which blames
    exposed rendezvous time onto the same dims the fault model scales."""
    if isinstance(key, tuple):
        key = key[0]
    if not isinstance(key, str):
        return None
    return key.rsplit(":", 1)[-1] if ":" in key else key


#: backwards-compatible private alias (pre-critpath internal name)
_key_dim = key_dim


class StepFaultModel:
    """The engine's consult-at-service-time view of a scenario, scoped
    to one simulated step. All times are seconds relative to the step
    start. ``rank_map`` translates engine ranks to global ranks when
    the engine runs one representative per symmetry class."""

    def __init__(self, scenario: FaultScenario,
                 rank_map: Optional[Sequence[int]] = None):
        self.scenario = scenario
        self._map = list(rank_map) if rank_map is not None else None
        #: global rank -> [(start_s, end_s, multiplier)]; multiplier
        #: math.inf encodes a preemption freeze (progress rate 0)
        self._slow: Dict[int, List[Tuple[float, float, float]]] = {}
        #: (dim, start_s, end_s, multiplier, scope frozenset | None)
        self._links: List[Tuple[str, float, float, float,
                                Optional[frozenset]]] = []
        #: global rank -> earliest death time (s)
        self._deaths: Dict[int, float] = {}
        for ev in scenario.events:
            s = ev.start_ms * 1e-3
            e = ev.end_ms * 1e-3 if math.isfinite(ev.end_ms) else math.inf
            if ev.kind == "slowdown":
                if ev.multiplier == 1.0:
                    # a 1.0x slowdown is the identity by definition —
                    # keep it out of the piecewise integration, whose
                    # float re-association at window edges would
                    # otherwise drift span ends by an ulp (the slack
                    # gate proves such events delay nothing and must
                    # agree with the engine to the bit)
                    continue
                for r in ev.targets():
                    self._slow.setdefault(r, []).append(
                        (s, e, ev.multiplier)
                    )
            elif ev.kind == "preemption":
                for r in ev.targets():
                    self._slow.setdefault(r, []).append(
                        (s, e, math.inf)
                    )
            elif ev.kind == "link_degradation":
                scope = (frozenset(ev.ranks)
                         if ev.ranks is not None else None)
                self._links.append((ev.dim, s, e, ev.multiplier, scope))
            elif ev.kind == "rank_death":
                for r in ev.targets():
                    prev = self._deaths.get(r)
                    self._deaths[r] = s if prev is None \
                        else min(prev, s)
        for wins in self._slow.values():
            wins.sort()

    def _g(self, engine_rank: int) -> int:
        return self._map[engine_rank] if self._map is not None \
            else engine_rank

    def death_time(self, engine_rank: int) -> Optional[float]:
        return self._deaths.get(self._g(engine_rank))

    def has_slow(self, engine_rank: int) -> bool:
        """Whether any slowdown/preemption window targets this rank —
        the engine's per-run fast path (untouched ranks skip the
        ``compute_end`` piecewise integration entirely)."""
        return self._g(engine_rank) in self._slow

    @property
    def has_deaths(self) -> bool:
        return bool(self._deaths)

    def compute_end(self, engine_rank: int, start: float,
                    duration: float) -> float:
        """Wall end time of ``duration`` seconds of work starting at
        ``start`` under this rank's piecewise slowdown windows
        (progress rate ``1/Π multipliers`` of the active windows, 0
        while preempted)."""
        wins = self._slow.get(self._g(engine_rank))
        if not wins or duration <= 0:
            return start + duration
        edges = sorted({x for w in wins for x in w[:2]
                        if math.isfinite(x) and x > start})
        t, work = start, duration
        ei = 0
        while True:
            mult = 1.0
            for (s, e, m) in wins:
                if s <= t < e:
                    mult = math.inf if m == math.inf else mult * m
            while ei < len(edges) and edges[ei] <= t:
                ei += 1
            nxt = edges[ei] if ei < len(edges) else math.inf
            if mult == math.inf:
                # frozen: no progress until the window closes (finite
                # by validation)
                t = nxt
                continue
            need = work * mult
            if t + need <= nxt:
                return t + need
            work -= (nxt - t) / mult
            t = nxt

    def comm_scale(self, key, engine_peers: Sequence[int],
                   t: float) -> float:
        """Comm-time multiplier of one rendezvous/p2p op at service
        time ``t``: the product of active link windows matching its dim
        whose scope (if any) intersects the participating ranks."""
        if not self._links:
            return 1.0
        dim = _key_dim(key)
        m = 1.0
        for (d, s, e, mult, scope) in self._links:
            if not s <= t < e:
                continue
            if d != "*" and d != dim:
                continue
            if scope is not None and not any(
                self._g(p) in scope for p in engine_peers
            ):
                continue
            m *= mult
        return m


@dataclass
class FaultOutcome:
    """Structured result of a faulted simulation: whether the step
    completed, who died when, how much was injected."""

    applied_events: int
    completed: bool
    deaths: List[Dict[str, float]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": "simumax-fault-outcome-v1",
            "applied_events": self.applied_events,
            "completed": self.completed,
            "deaths": list(self.deaths),
        }


# --------------------------------------------------------------------------
# Checkpoint / restore cost model
# --------------------------------------------------------------------------


@dataclass
class CheckpointSpec:
    """Checkpointing policy knobs (overridable per scenario via
    ``FaultScenario.checkpoint``)."""

    #: write a checkpoint every N committed steps
    interval_steps: int = 50
    #: failure detection + rescheduling + process restart + re-init,
    #: before the restore read begins
    restart_overhead_s: float = 120.0
    #: bandwidth overrides (GB/s per chip); None = derive from
    #: ``SystemConfig.host``
    write_gbps: Optional[float] = None
    read_gbps: Optional[float] = None

    @classmethod
    def from_overrides(cls, overrides: Optional[Dict[str, Any]],
                       base: Optional["CheckpointSpec"] = None
                       ) -> "CheckpointSpec":
        spec = base or cls()
        if not overrides:
            return spec
        known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        extra = set(overrides) - known
        if extra:
            raise ConfigError(
                f"unknown checkpoint fields {sorted(extra)} "
                f"(known: {sorted(known)})", phase="simulate",
            )
        kw = {f: getattr(spec, f) for f in known}
        kw.update(overrides)
        out = cls(**kw)
        if out.interval_steps < 1:
            raise ConfigError(
                f"checkpoint interval_steps must be >= 1, got "
                f"{out.interval_steps}", phase="simulate",
            )
        return out


@dataclass
class CheckpointCostModel:
    """Per-rank checkpoint write / restore read times.

    The checkpointed state per rank is its weights + optimizer state
    (gradients are not checkpointed). The write streams HBM → host
    (``host.d2h_gbps``) → persistent storage / DCN
    (``host.ckpt_write_gbps``); pipelined streaming is bound by the
    slowest stage of the chain (HBM read bandwidth included for
    completeness — it never binds on real parts), plus a fixed
    commit/barrier latency. Restore is the reverse chain with the read
    bandwidths."""

    bytes_per_rank: float
    write_s: float
    read_s: float
    spec: CheckpointSpec

    @classmethod
    def from_perf(cls, perf,
                  spec: Optional[CheckpointSpec] = None
                  ) -> "CheckpointCostModel":
        spec = spec or CheckpointSpec()
        mem = perf.analysis_mem()
        nbytes = max(
            s["weight_bytes"] + s["optimizer_state_bytes"]
            for s in mem["stages"]
        )
        host = perf.system.host
        hbm = perf.system.accelerator.bandwidth["default"].gbps
        write_bw = spec.write_gbps or min(
            hbm, host.d2h_gbps, host.ckpt_write_gbps
        )
        read_bw = spec.read_gbps or min(
            hbm, host.d2h_gbps, host.ckpt_read_gbps
        )
        return cls(
            bytes_per_rank=nbytes,
            write_s=nbytes / (write_bw * 1e9) + host.latency_s,
            read_s=nbytes / (read_bw * 1e9) + host.latency_s,
            spec=spec,
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "bytes_per_rank": self.bytes_per_rank,
            "write_s": self.write_s,
            "read_s": self.read_s,
            "interval_steps": self.spec.interval_steps,
            "restart_overhead_s": self.spec.restart_overhead_s,
        }


# --------------------------------------------------------------------------
# Goodput prediction
# --------------------------------------------------------------------------


@dataclass
class GoodputReport:
    """Wall-time decomposition of a scenario over ``horizon_steps``
    training steps. ``buckets`` sum to ``wall_time_s`` exactly (the
    accounting is constructive); ``goodput = useful_train / wall``."""

    goodput: float
    wall_time_s: float
    useful_time_s: float
    healthy_step_s: float
    horizon_steps: int
    n_checkpoints: int
    n_restarts: int
    steps_replayed: int
    buckets: GoodputBuckets
    deaths: List[Dict[str, float]]
    checkpoint: Dict[str, Any]
    truncated: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": "simumax-goodput-v1",
            "goodput": self.goodput,
            "wall_time_s": self.wall_time_s,
            "useful_time_s": self.useful_time_s,
            "healthy_step_s": self.healthy_step_s,
            "horizon_steps": self.horizon_steps,
            "n_checkpoints": self.n_checkpoints,
            "n_restarts": self.n_restarts,
            "steps_replayed": self.steps_replayed,
            "buckets": self.buckets.to_dict(),
            "deaths": list(self.deaths),
            "checkpoint": dict(self.checkpoint),
            "truncated": self.truncated,
        }


def _simulate_step(perf, sub: FaultScenario,
                   cache: Dict[tuple, Tuple[float, Optional[float]]],
                   granularity: str, reduce) -> Tuple[float, Optional[float]]:
    """(wall duration, death time | None) of one step under the
    re-based sub-scenario ``sub``; death times arrive in the same
    straggler-inflated wall base as ``end_time``."""
    from simumax_tpu_torch.simulator.runner import run_simulation

    key = sub.signature()
    hit = cache.get(key)
    if hit is not None:
        return hit
    res = run_simulation(
        perf, None, granularity=granularity, world_ranks=True,
        reduce=reduce, faults=sub,
    )
    deaths = res["faults"]["deaths"]
    if deaths:
        t_death = min(d["time_ms"] for d in deaths) * 1e-3
        out = (t_death, t_death)
    else:
        out = (res["end_time"], None)
    cache[key] = out
    return out


def _batched_replay():
    """Lazy import of the batched-replay lowering (keeps faults.py
    importable without numpy and torch on the path until a batch
    dispatch actually needs them)."""
    from simumax_tpu_torch.simulator import batched_replay

    return batched_replay


# --------------------------------------------------------------------------
# Incremental fault replay
# --------------------------------------------------------------------------


@dataclass
class ReplayOptions:
    """Per-optimization toggles for the incremental replay engine.
    Every switch is independently disableable, and every combination
    is bit-identical to the exact path — enforced by the
    incremental-vs-exact sweep in ``tests/test_faults.py``."""

    #: answer provably makespan-neutral steps from the healthy step's
    #: critical-path slack headroom, without simulating
    short_circuit: bool = True
    #: share one replay between scenarios perturbing symmetric ranks
    #: (step cache additionally keyed by the canonicalized problem)
    canonical_cache: bool = True
    #: record step request streams once per scenario partition, replay
    #: them, and resume from forked healthy-prefix snapshots
    prefix_fork: bool = True
    #: treat fault windows that outlast the step's realized end as
    #: open-ended in the step-cache keys (validity-checked against the
    #: realized end), so every interior step of a long-running fault —
    #: and its interval-grid wall shifts — shares one replay
    horizon_clamp: bool = True
    #: fork-ladder bound: snapshots retained per step-program family
    max_snapshots: int = 16
    #: miss-replay backend: ``"numpy"`` keeps every miss on the scalar
    #: engine walk; ``"cuda"`` lowers miss batches to the batched
    #: replay (``simulator/batched_replay.py``: one CUDA kernel launch
    #: per family group) whenever the family can lower; ``"auto"``
    #: dispatches the kernel only when the miss batch is large enough
    #: to amortize dispatch — per-scenario scalar fallback with a
    #: counted reason otherwise, never a whole-batch downgrade
    replay_backend: str = "auto"
    #: auto-dispatch floor for ``replay_backend="auto"`` (0 = use
    #: ``batched_replay.JIT_BATCH_MIN``)
    jit_batch_min: int = 0
    #: where the batched replay runs: ``"cuda"`` launches the kernel
    #: (raising without a card), ``"cpu"`` runs its plain PyTorch
    #: version
    device: str = "cuda"


@dataclass
class _StepFamily:
    """Replay state shared by every sub-scenario with one touched-rank
    partition: the faulted reduction plan, the recorded per-class
    request streams, and the fork ladder of paused engine snapshots
    (``(pause time, engine with no fault model attached)``)."""

    plan: Any
    streams: Optional[List[list]] = None
    ladder: List[Tuple[float, Any]] = field(default_factory=list)


def _union_len(wins: List[Tuple[float, float]]) -> float:
    """Total length of the union of ``[start, end)`` windows
    (``math.inf`` if any window is unbounded)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(wins):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@contextlib.contextmanager
def _deadline(seconds: Optional[float], label: str):
    """Per-scenario SIGALRM deadline (the sweep executor's discipline:
    armed on the running thread only when it is a process main thread,
    which in pool mode is the worker's main thread). No timeout, or a
    non-main thread, is a no-op."""
    if (not seconds or seconds <= 0
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    import signal

    def _alarm(signum, frame):
        raise SimulationError(
            f"goodput scenario exceeded its {seconds:g}s deadline: "
            f"{label}",
            phase="simulate", scenario=label,
        )

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


class ReplayContext:
    """Memoized incremental-replay state shared across
    :func:`predict_goodput` / :func:`analyze_faults` calls on one
    completed estimate.

    Everything is lazy: the fault-free step (recorded with the
    critical-path skeleton when the slack gate is on), the checkpoint
    cost chain, step-program families (recorded request streams + fork
    ladders per touched-rank partition), and the perturbed-step cache
    in two keyings — the exact event signature and the
    symmetry-canonicalized engine problem. Cached values are
    bit-identical to what the exact path computes; the context only
    removes duplicated work, never changes a number.

    ``stats`` is observational (cache hits, short-circuits, forks…)
    and mirrored into the telemetry registry counters
    (``faults_*_total``); it is deliberately NOT part of any analysis
    result, because parallel scheduling makes hit counts
    non-deterministic while the results stay bit-identical.
    """

    def __init__(self, perf, granularity: str = "chunk", reduce="auto",
                 options: Optional[ReplayOptions] = None):
        if reduce is False:
            raise ConfigError(
                "ReplayContext replays through symmetry-reduction "
                "plans; reduce=False requests the exact unreduced "
                "path — call predict_goodput/analyze_faults with "
                "incremental=False instead",
                phase="simulate",
            )
        self.perf = perf
        self.granularity = granularity
        self.reduce = reduce
        self.options = options or ReplayOptions()
        _batched_replay().check_backend(self.options.replay_backend,
                                        self.options.device)
        self.stats: Dict[str, int] = {k: 0 for k in (
            "scenarios", "steps", "sims", "recordings", "replays",
            "forks", "shortcircuits", "cache_hits", "canon_hits",
            "clamp_hits", "batched",
        )}
        from simumax_tpu_torch.observe.telemetry import get_registry

        _reg = get_registry()
        self._registry = _reg
        self._c_scenarios = _reg.counter("faults_scenarios_total")
        self._c_hits = _reg.counter("faults_step_cache_hits_total",
                                    kind="exact")
        self._c_canon = _reg.counter("faults_step_cache_hits_total",
                                     kind="canonical")
        self._c_clamp = _reg.counter("faults_step_cache_hits_total",
                                     kind="clamped")
        self._c_gate = _reg.counter("faults_slack_shortcircuits_total")
        self._c_forks = _reg.counter("faults_prefix_forks_total")
        self._c_batched = _reg.counter("replay_batched_total",
                                       backend="cuda")
        #: reason -> counter, filled lazily from the closed catalogue
        self._c_fallbacks: Dict[str, Any] = {}
        self._healthy: Optional[dict] = None
        self._slack: Optional[tuple] = None
        self._structure = None  # memoized reduction relations
        self._healthy_classes: Optional[List[int]] = None
        self._families: Dict[tuple, _StepFamily] = {}
        #: stage -> (recorded stream, its plan, its engine rank): the
        #: remap source shared by every family (a step program is a
        #: pure function of stage + rendezvous structure)
        self._stage_sources: Dict[int, Tuple[list, Any, int]] = {}
        self._cache: Dict[tuple, Tuple[float, Optional[float]]] = {}
        #: id -> weakref of scenarios already validated against this
        #: estimate's world — the fleet walk re-costs one scenario
        #: object many times against a shared context, and validation
        #: is O(events)/call. (id-keyed because dataclass equality
        #: makes FaultScenario unhashable; the weakref guards against
        #: id reuse after collection.)
        self._validated: Dict[int, Any] = {}
        #: checkpoint-override dict -> resolved CheckpointSpec
        self._specs: Dict[Optional[tuple], CheckpointSpec] = {}
        #: clamped / canonical entries additionally carry the realized
        #: raw end (`raw_limit`) their open-ended windows must cover
        self._clamped: Dict[tuple, Tuple[float, Optional[float],
                                         float]] = {}
        self._canon: Dict[tuple, Tuple[float, Optional[float],
                                       float]] = {}
        self._ckpt: Dict[tuple, CheckpointCostModel] = {}
        #: id(fam) -> LoweredProgram | fallback-reason str (fams are
        #: owned by self._families, so ids are stable for our lifetime)
        self._lowerings: Dict[int, Any] = {}
        #: (id(plan), rank_events) -> canonical class order — the
        #: refinement in reduce.canonical_class_order is a pure
        #: function of both, and Monte-Carlo rounds re-ask it for the
        #: same few event patterns thousands of times
        self._canon_orders: Dict[tuple, Any] = {}
        #: adaptive canonical probing: key serialization is the most
        #: expensive cache layer, and a workload whose scenarios never
        #: relabel onto each other pays it for nothing. After
        #: CANON_PROBE_LIMIT misses with zero hits the layer goes
        #: dormant (cache-speed only: a canon hit returns the same
        #: bytes a fresh sim would, so skipping can't change results)
        self._canon_misses = 0

    # -- hoisted per-call prologue ------------------------------------------
    def validate_scenario(self, scenario: FaultScenario):
        """``scenario.validate(world_size)`` hoisted to once per
        scenario *object* per context. Scenarios are immutable once
        handed to a prediction (the step cache already keys on event
        identity), so re-validating the same object on every
        ``predict_goodput`` call — thousands of times per template in
        the fleet walk — only re-pays an O(events) walk. The
        single-call path (no shared context) still validates every
        time, unchanged."""
        key = id(scenario)
        ref = self._validated.get(key)
        if ref is not None and ref() is scenario:
            return
        scenario.validate(self.perf.strategy.world_size)
        self._validated[key] = weakref.ref(
            scenario,
            lambda _r, k=key, m=self._validated: m.pop(k, None),
        )

    def resolve_spec(self, scenario: FaultScenario) -> CheckpointSpec:
        """``CheckpointSpec.from_overrides(scenario.checkpoint)``
        memoized on the override values — byte-identical resolution,
        one dataclass build per distinct override set instead of one
        per call."""
        ck = scenario.checkpoint
        key = tuple(sorted(ck.items())) if ck else None
        spec = self._specs.get(key)
        if spec is None:
            spec = CheckpointSpec.from_overrides(ck)
            self._specs[key] = spec
        return spec

    # -- memoized healthy step + checkpoint chain --------------------------
    def healthy(self) -> dict:
        """The fault-free step, simulated once per context. With the
        slack gate enabled the same run records the critical-path
        skeleton (recorder-on is bit-identical to recorder-off — the
        critical-path contract), so the gate tables come for free."""
        if self._healthy is None:
            from simumax_tpu_torch.simulator.runner import run_simulation

            self._healthy = run_simulation(
                self.perf, None, granularity=self.granularity,
                world_ranks=True, reduce=self.reduce,
                critical_path=self.options.short_circuit,
            )
        return self._healthy

    def checkpoint_model(self, spec: CheckpointSpec) -> CheckpointCostModel:
        """``CheckpointCostModel.from_perf`` memoized on the bandwidth
        overrides (the bytes/chain analysis is spec-independent)."""
        key = (spec.write_gbps, spec.read_gbps)
        base = self._ckpt.get(key)
        if base is None:
            base = CheckpointCostModel.from_perf(self.perf, spec)
            self._ckpt[key] = base
        if base.spec is spec:
            return base
        return CheckpointCostModel(
            bytes_per_rank=base.bytes_per_rank, write_s=base.write_s,
            read_s=base.read_s, spec=spec,
        )

    def _healthy_reduction(self) -> List[int]:
        """Healthy (fault-free) symmetry classes + memoized relational
        structure — shared by the slack gate's rank mapping and every
        step family's plan build."""
        if self._healthy_classes is None:
            from simumax_tpu_torch.simulator.reduce import (
                build_reduction,
                reduction_structure,
            )

            self._structure = reduction_structure(self.perf.strategy)
            plan = build_reduction(self.perf.strategy, {},
                                   structure=self._structure)
            self._healthy_classes = plan.class_of
            self._healthy_rep_of = [
                plan.reps[plan.class_of[r]]
                for r in range(plan.world_size)
            ]
        return self._healthy_classes

    # -- (a) slack-gated short-circuit -------------------------------------
    def _gate_tables(self):
        if self._slack is None:
            report = self.healthy().get("critical_path") or {}
            idx = report.get("slack_index") or {}

            def _fin(arr):
                return [math.inf if v is None else v for v in arr]

            ranks = {
                int(r): (w, math.inf if s is None else s)
                for (r, w, s) in idx.get("ranks", [])
            }
            links = {
                k: (w, math.inf if s is None else s)
                for (k, w, s) in idx.get("links", [])
            }
            rank_b = {
                int(r): (bw, _fin(bs))
                for (r, bw, bs) in idx.get("rank_buckets", [])
            }
            link_b = {
                k: (bw, _fin(bs))
                for (k, bw, bs) in idx.get("link_buckets", [])
            }
            n_b = int(idx.get("buckets") or 0)
            mk = float(idx.get("makespan_s") or 0.0)
            rep_of = None
            if idx.get("mode") == "reduced":
                self._healthy_reduction()
                rep_of = self._healthy_rep_of
            self._slack = (ranks, links, rank_b, link_b, n_b, mk,
                           rep_of)
        return self._slack

    def _gate(self, sub: FaultScenario) -> bool:
        """Sound makespan-neutrality proof for one re-based
        sub-scenario against the healthy step's slack tables.

        Model every fault as added delay on the events it touches and
        bound the total, ``D``:

        * slowdowns on rank ``r`` with combined multiplier ``M`` (the
          product — overlapping windows compose multiplicatively in
          ``compute_end``): ``D_r <= min(U * (1 - 1/M),
          (M - 1) * work_r)`` where ``U`` is the union length of the
          windows (progress deficit accrues only inside them, at rate
          at most ``1 - 1/M``) and ``work_r`` the rank's healthy work
          overlapping the windows (each second of work stretches at
          most ``M``-fold);
        * a preemption freezes progress, so its rank's deficit is at
          most the union length of all its windows (deficit rate <= 1);
        * link degradations scale a comm op's whole duration by the
          product of matching windows at its start, so per slack-index
          key ``D_k <= (M_k - 1) * work_k`` with ``work_k`` the
          class-weighted wire+exposed seconds on that key overlapping
          the windows (scoped events are treated as unscoped —
          conservative).

        If ``sum(D) <= min slack over every touched node`` the
        makespan provably cannot move: any dependency path accumulates
        at most ``sum(D)`` of delay, and a path through a touched node
        has float at least that node's slack (``slack_j`` is the
        minimum float over paths through ``j``).

        Touched nodes are window-local, so work and the slack
        threshold are evaluated over the slack index's *time buckets*:
        a fault only touches nodes overlapping its window inflated
        left by the coarse whole-step delay bound from pass 1 (delays
        only shift nodes right, by at most the total delay), and the
        threshold is the minimum bucket slack over the covered buckets
        — whole-step minima are ~always zero (the optimizer barrier
        alone puts a zero-slack node on every rank), but mid-step
        windows routinely clear. Deaths never gate. Replay-verified by
        the slack-soundness property test, mirroring the critical path's slack
        soundness tests."""
        (ranks, links, rank_b, link_b, n_b, mk,
         rep_of) = self._gate_tables()
        if not ranks or not n_b or mk <= 0.0:
            return False
        by_rank: Dict[int, list] = {}
        link_events: List[Tuple[str, float, float, float]] = []
        for ev in sub.events:
            if ev.kind == "rank_death":
                return False
            s = ev.start_ms * 1e-3
            e = (ev.end_ms * 1e-3 if math.isfinite(ev.end_ms)
                 else math.inf)
            if ev.kind == "link_degradation":
                link_events.append((ev.dim, ev.multiplier, s, e))
                continue
            for r in ev.targets():
                entry = by_rank.setdefault(r, [1.0, [], False])
                entry[1].append((s, e))
                if ev.kind == "preemption":
                    entry[2] = True
                else:
                    entry[0] *= ev.multiplier

        def _link_mult_wins(key):
            m, wins = 1.0, []
            for (dim, mult, s, e) in link_events:
                if (dim == "*" or key == f"dim:{dim}"
                        or (dim == "pp" and key.startswith("pp:"))):
                    m *= mult
                    wins.append((s, e))
            return m, wins

        # pass 1 — coarse whole-step delay bound (how far any node can
        # shift right), used to inflate the windows in pass 2
        coarse = 0.0
        for r, (mult, wins, preempt) in by_rank.items():
            g = rep_of[r] if rep_of is not None else r
            ent = ranks.get(g)
            if ent is None:
                return False
            work, _ = ent
            union = _union_len(wins)
            if preempt:
                d = union
            else:
                d = (mult - 1.0) * work
                if math.isfinite(union):
                    d = min(d, union * (1.0 - 1.0 / mult))
            if not math.isfinite(d):
                return False
            coarse += d
        touched_links = []
        for key, (work, _) in links.items():
            m, wins = _link_mult_wins(key)
            if m == 1.0 or work <= 0.0:
                continue
            touched_links.append((key, m, wins))
            coarse += (m - 1.0) * work

        # pass 2 — windowed work bound + windowed slack threshold
        scale = n_b / mk

        def _covered(wins):
            bset = set()
            for (s, e) in wins:
                lo = int((s - coarse) * scale)
                lo = 0 if lo < 0 else min(lo, n_b - 1)
                hi = (n_b - 1 if not math.isfinite(e)
                      else max(lo, min(int(e * scale), n_b - 1)))
                bset.update(range(lo, hi + 1))
            return bset

        total = 0.0
        min_slack = math.inf
        for r, (mult, wins, preempt) in by_rank.items():
            g = rep_of[r] if rep_of is not None else r
            ent = rank_b.get(g)
            if ent is None:
                return False
            bwork, bslack = ent
            bset = _covered(wins)
            union = _union_len(wins)
            if preempt:
                d = union
            else:
                d = (mult - 1.0) * sum(bwork[b] for b in bset)
                if math.isfinite(union):
                    d = min(d, union * (1.0 - 1.0 / mult))
            if not math.isfinite(d):
                return False
            total += d
            for b in bset:
                if bslack[b] < min_slack:
                    min_slack = bslack[b]
        for key, m, wins in touched_links:
            ent = link_b.get(key)
            if ent is None:
                return False
            bwork, bslack = ent
            bset = _covered(wins)
            total += (m - 1.0) * sum(bwork[b] for b in bset)
            for b in bset:
                if bslack[b] < min_slack:
                    min_slack = bslack[b]
        return total <= min_slack

    # -- (b) symmetry-canonicalized step cache -----------------------------
    def _family(self, sub: FaultScenario) -> _StepFamily:
        """The step-program family of ``sub``'s touched-rank partition.
        Signature *values* reach the color refinement only through
        equality, so renaming them to partition-group indices memoizes
        one reduction plan across every window of the same pattern."""
        sigs = sub.rank_signatures()
        groups: Dict[tuple, List[int]] = {}
        for r, s in sigs.items():
            groups.setdefault(s, []).append(r)
        part = tuple(sorted(tuple(sorted(g)) for g in groups.values()))
        fam = self._families.get(part)
        if fam is None:
            from simumax_tpu_torch.simulator.reduce import build_reduction

            h_cls = self._healthy_reduction()
            touch = {r: gi for gi, g in enumerate(part) for r in g}
            # seed every rank with its healthy class: the refinement
            # then converges from the already-stable healthy partition
            # (same fixpoint — seeds only matter through equality)
            seeds = {
                r: (h_cls[r], touch.get(r, -1))
                for r in range(len(h_cls))
            }
            fam = _StepFamily(plan=build_reduction(
                self.perf.strategy, {}, signatures=seeds,
                structure=self._structure,
            ))
            self._families[part] = fam
        return fam

    def _clamp_events(self, sub: FaultScenario, span_s: float):
        """Per-event cache signatures with the horizon clamp applied.

        With ``horizon_clamp`` on, any window that outlasts the
        nominal step span is keyed as open-ended (``"open"`` in the
        duration slot): the engine never consults fault state past the
        step's *realized* end, so two windows both covering it behave
        identically — which is what lets every interior step of a
        long-running fault (and its interval-grid wall shifts) share
        one replay. Returns ``(sigs, min_end, any_clamped)`` where
        ``min_end`` is the smallest finite original end among clamped
        events: a cached entry is valid only while its realized raw
        end stays at or below it (checked at lookup AND at store)."""
        sigs: List[tuple] = []
        min_end = math.inf
        clamped = False
        for ev in sub.events:
            if (self.options.horizon_clamp and ev.kind != "rank_death"
                    and ev.end_ms * 1e-3 >= span_s):
                clamped = True
                end_s = ev.end_ms * 1e-3
                if end_s < min_end:
                    min_end = end_s
                sigs.append((ev.kind, ev.start_ms, "open",
                             ev.multiplier, ev.dim))
            else:
                sigs.append(ev.signature())
        return sigs, min_end, clamped

    def _clamped_key(self, sub: FaultScenario, sigs: List[tuple]
                     ) -> tuple:
        """Horizon-clamped twin of ``FaultScenario.signature()``."""
        return tuple(
            sig + (ev.rank, tuple(ev.ranks) if ev.ranks else None)
            for sig, ev in zip(sigs, sub.events)
        )

    def _canonical_key(self, sub: FaultScenario, plan,
                       sigs: List[tuple]) -> tuple:
        """Serialize the *engine-level problem* — per-class fault
        timelines (horizon-clamped ``sigs``, aligned with
        ``sub.events``) plus the plan's rendezvous/neighbor structure —
        in a structure-canonical class numbering
        (``reduce.canonical_class_order``). Byte-equal keys are the
        same abstract problem up to class relabeling, which the engine
        resolves identically (the reduce-parity contract), so two
        scenarios hitting symmetric ranks at the same offsets share
        one replay. An imperfect relabeling can only cost hits, never
        correctness: the key carries the full problem."""
        from simumax_tpu_torch.simulator.reduce import canonical_class_order

        k = plan.n_classes
        reps = plan.reps
        by_rank: Dict[int, List[tuple]] = {}
        for sig, ev in zip(sigs, sub.events):
            if ev.kind != "link_degradation":
                for r in ev.targets():
                    by_rank.setdefault(r, []).append(sig)
        rank_events = [
            tuple(sorted(by_rank.get(reps[i], ()), key=repr))
            for i in range(k)
        ]
        mkey = (id(plan), tuple(rank_events))
        order = self._canon_orders.get(mkey)
        if order is None:
            order = canonical_class_order(plan, rank_events)
            self._canon_orders[mkey] = order
        perm = [0] * k
        for new, old in enumerate(order):
            perm[old] = new
        parts = []
        for old in order:
            groups = tuple(sorted(
                (dim, tuple(sorted(perm[p] for p in g)))
                for dim, g in plan.groups[old].items()
            ))
            nbrs = tuple(sorted(
                (s, perm[p])
                for s, p in plan.neighbor_maps[old].items()
            ))
            parts.append((plan.stages[old], plan.perturbs[old],
                          len(plan.classes[old]), rank_events[old],
                          groups, nbrs))
        links = []
        for sig, ev in zip(sigs, sub.events):
            if ev.kind != "link_degradation":
                continue
            scope = None
            if ev.ranks is not None:
                # engine-level scope: the classes whose REPRESENTATIVE
                # is scoped (only reps are consulted in a reduced run)
                sset = set(ev.ranks)
                scope = tuple(sorted(
                    perm[i] for i in range(k) if reps[i] in sset
                ))
            links.append(sig + (scope,))
        return (self.granularity, tuple(parts),
                tuple(sorted(links, key=repr)))

    # -- (c) recorded-stream replay + healthy-prefix fork ------------------

    def _remap_streams(self, fam: _StepFamily) -> Optional[List[list]]:
        """Build ``fam``'s per-class request streams by rewriting a
        recorded stream of the same pipeline stage from another family.

        ``StageProcess`` output is a pure function of ``(stage,
        granularity, perturb, groups, neighbor_map, barrier)``, so a
        stream recorded under one reduction plan converts exactly into
        any other plan's stream for the same stage by rewriting the
        engine ids it carries: rendezvous groups/peers by dim, p2p
        src/dst through the pipeline-stage neighbor map, and the
        optimizer barrier to ``range(n_classes)``. The request
        vocabulary is closed (``engine.py`` docstring); an unknown
        kind or missing source aborts the remap (``None``) and the
        family records its own streams instead."""
        plan = fam.plan
        out: List[list] = []
        for i in range(plan.n_classes):
            if plan.perturbs[i] != 1.0:
                return None
            src = self._stage_sources.get(plan.stages[i])
            if src is None:
                return None
            stream, s_plan, j = src
            if s_plan.perturbs[j] != 1.0:
                return None
            mapped = self._remap_stream(stream, s_plan, plan, i)
            if mapped is None:
                return None
            out.append(mapped)
        return out

    @staticmethod
    def _remap_stream(stream: list, s_plan, plan, i: int
                      ) -> Optional[list]:
        groups = plan.groups[i]
        nmap = plan.neighbor_maps[i]
        s_stages = s_plan.stages
        barrier = list(range(plan.n_classes))
        out: list = []
        for req in stream:
            kind = req[0]
            if kind in ("compute", "advance", "advance_rel", "trace",
                        "wait_comm"):
                out.append(req)
                continue
            if kind == "collective":
                _, key, dur, name, _peers = req
                if isinstance(key, tuple):
                    tag = key[0]
                    dim = (tag.rsplit(":", 1)[1] if ":" in tag
                           else tag)
                    g = groups.get(dim)
                    if g is None:
                        return None
                    out.append((kind, (tag, tuple(g)), dur, name,
                                list(g)))
                    continue
                if key == "optimizer_barrier":
                    out.append((kind, key, dur, name, list(barrier)))
                    continue
                return None
            if kind == "async_collective":
                _, stream_name, dur, name, _peers = req
                dim = stream_name.rsplit(":", 1)[1]
                g = groups.get(dim)
                # _async_bucket degrades to a self-rendezvous when the
                # rank carries no group on the dim
                out.append((kind, stream_name, dur, name,
                            list(g) if g else [i]))
                continue
            if kind in ("send", "send_sync", "recv"):
                peer = nmap.get(s_stages[req[1]])
                if peer is None:
                    return None
                out.append((kind, peer) + req[2:])
                continue
            if kind == "sendrecv":
                _, dst, stag, sdur, src_r, rtag, name = req[:7]
                nd = ns = None
                if dst is not None:
                    nd = nmap.get(s_stages[dst])
                    if nd is None:
                        return None
                if src_r is not None:
                    ns = nmap.get(s_stages[src_r])
                    if ns is None:
                        return None
                out.append((kind, nd, stag, sdur, ns, rtag, name)
                           + req[7:])
                continue
            return None  # unknown request kind: record instead
        return out

    def _replay(self, sub: FaultScenario,
                fam: _StepFamily) -> Tuple[float, Optional[float]]:
        from simumax_tpu_torch.simulator.engine import (
            RecordingProc,
            ReplayProc,
            SimuEngine,
        )
        from simumax_tpu_torch.simulator.runner import build_reduced_engine

        plan = fam.plan
        model = StepFaultModel(sub, rank_map=plan.reps)
        ratio = self.healthy()["straggle_ratio"]
        if (fam.streams is None and self.options.prefix_fork
                and self._stage_sources):
            fam.streams = self._remap_streams(fam)
        if fam.streams is not None and self.options.prefix_fork:
            self.stats["replays"] += 1
            onset = min(ev.start_ms for ev in sub.events) * 1e-3
            eng = None
            if onset > 0.0:
                best = None
                for (t, snap) in fam.ladder:
                    if t <= onset and (best is None or t > best[0]):
                        best = (t, snap)
                if best is not None:
                    eng = best[1].fork()
                    self.stats["forks"] += 1
                    self._c_forks.inc()
            if eng is None:
                eng = SimuEngine(plan.n_classes, drop_events=True)
                for i in range(plan.n_classes):
                    eng.add_rank(i, ReplayProc(fam.streams[i]))
            eng._fault = model
            finished = False
            if onset > 0.0:
                # pause at the onset: every decision so far is
                # fault-model-agnostic, so the paused state joins the
                # fork ladder for later scenarios of this family
                finished = eng.run_incremental(pause_at=onset)
                if (not finished
                        and len(fam.ladder) < self.options.max_snapshots
                        and all(t != onset for t, _ in fam.ladder)):
                    snap = eng.fork()
                    snap._fault = None
                    fam.ladder.append((onset, snap))
            if not finished:
                eng.run_incremental()
            raw_end = max(eng.clock) if eng.clock else 0.0
            deaths = eng.deaths
        else:
            recorders: Dict[int, RecordingProc] = {}

            def wrap(i, gen):
                rp = RecordingProc(gen)
                recorders[i] = rp
                return rp

            self.stats["recordings"] += 1
            eng = build_reduced_engine(
                self.perf, plan, self.granularity, fault_model=model,
                wrap_proc=wrap if self.options.prefix_fork else None,
                drop_events=True,
            )
            raw_end = eng.run()
            deaths = eng.deaths
            if (self.options.prefix_fork and recorders
                    and all(r.complete for r in recorders.values())):
                # a stream truncated by a rank death must not be
                # cached — it would starve longer-lived replays
                fam.streams = [
                    recorders[i].stream for i in range(plan.n_classes)
                ]
                for i in range(plan.n_classes):
                    stage = plan.stages[i]
                    if (plan.perturbs[i] == 1.0
                            and stage not in self._stage_sources):
                        self._stage_sources[stage] = (
                            fam.streams[i], plan, i,
                        )
        if deaths:
            # mirror _simulate_step's float path exactly: the runner
            # reports deaths in ms (t * ratio * 1e3) and the exact walk
            # converts back with * 1e-3 — same associativity, same bits
            t = min(t for (_r, t) in deaths)
            td = t * ratio * 1e3 * 1e-3
            return (td, td, t)
        return (raw_end * ratio, None, raw_end)

    # -- the step entry point ----------------------------------------------
    def _step_probe(self, sub: FaultScenario, span_s: float):
        """The cache/short-circuit pipeline of one step, short of
        simulating: ``(answer, None)`` when a cache layer or the slack
        gate answers, else ``(None, miss_state)`` where ``miss_state``
        carries everything :meth:`_step_commit` needs to store the
        simulated result — ``(key, hkey, ckey, fam, min_end)``."""
        key = sub.signature()
        hit = self._cache.get(key)
        if hit is not None:
            self.stats["cache_hits"] += 1
            self._c_hits.inc()
            return hit, None
        opts = self.options
        if opts.short_circuit and self._gate(sub):
            self.stats["shortcircuits"] += 1
            self._c_gate.inc()
            out = (self.healthy()["end_time"], None)
            self._cache[key] = out
            return out, None
        sigs, min_end, clamped = self._clamp_events(sub, span_s)
        hkey = None
        if clamped:
            hkey = self._clamped_key(sub, sigs)
            got = self._clamped.get(hkey)
            if got is not None and min_end >= got[2]:
                out = (got[0], got[1])
                self.stats["clamp_hits"] += 1
                self._c_clamp.inc()
                self._cache[key] = out
                return out, None
        fam = None
        ckey = None
        if opts.canonical_cache and (
                self._canon_misses < CANON_PROBE_LIMIT
                or self.stats.get("canon_hits", 0) > 0):
            fam = self._family(sub)
            ckey = self._canonical_key(sub, fam.plan, sigs)
            got = self._canon.get(ckey)
            if got is not None and min_end >= got[2]:
                out = (got[0], got[1])
                self.stats["canon_hits"] += 1
                self._c_canon.inc()
                self._cache[key] = out
                if hkey is not None:
                    self._clamped[hkey] = got
                return out, None
            self._canon_misses += 1
        if fam is None:
            fam = self._family(sub)
        return None, (key, hkey, ckey, fam, min_end)

    def _step_commit(self, state: tuple,
                     result: Tuple[float, Optional[float], float]
                     ) -> Tuple[float, Optional[float]]:
        """Store one simulated miss into every cache layer whose
        validity guard passes — the exact tail of the pre-batched
        ``simulate_step``, shared by the scalar and batched paths."""
        key, hkey, ckey, _fam, min_end = state
        dur, death, raw_limit = result
        out = (dur, death)
        self.stats["sims"] += 1
        self._cache[key] = out
        if min_end >= raw_limit:
            # the realized end stayed inside every clamped window, so
            # the result is a faithful answer for the open-ended key
            entry = (dur, death, raw_limit)
            if hkey is not None:
                self._clamped[hkey] = entry
            if ckey is not None:
                self._canon[ckey] = entry
        return out

    def simulate_step(self, sub: FaultScenario, span_s: float
                      ) -> Tuple[float, Optional[float]]:
        """(wall duration, death time | None) of one step under the
        re-based sub-scenario ``sub`` (nominal window ``span_s``
        seconds) — the incremental twin of :func:`_simulate_step`,
        bit-identical by construction."""
        self.stats["steps"] += 1
        out, state = self._step_probe(sub, span_s)
        if out is not None:
            return out
        return self._step_commit(state, self._replay(sub, state[3]))

    # -- batched miss replay -----------------------------------------------
    def simulate_step_batch(self, reqs: List[Tuple[FaultScenario, float]]
                            ) -> List[Tuple[float, Optional[float]]]:
        """Answer one lockstep round of steps together: probe every
        request through the cache pipeline, then replay the deduped
        misses — batched through the replay kernel where the
        family lowers, scalar with a counted fallback reason where it
        doesn't. Answers are bit-identical to calling
        :meth:`simulate_step` on each request in order: the caches
        guarantee cached == computed, and within-round duplicates
        (exact, clamped, or canonical) defer to the next round where
        the freshly committed entries answer them through the same
        validity guards the serial path applies."""
        outs: List[Any] = [None] * len(reqs)
        pending = []
        for j, (sub, span_s) in enumerate(reqs):
            self.stats["steps"] += 1
            out, state = self._step_probe(sub, span_s)
            if out is not None:
                outs[j] = out
            else:
                pending.append((j, sub, span_s, state))
        while pending:
            seen: set = set()
            batch, rest = [], []
            for item in pending:
                key, hkey, ckey = item[3][0], item[3][1], item[3][2]
                dup = (key in seen
                       or (hkey is not None and hkey in seen)
                       or (ckey is not None and ckey in seen))
                if dup:
                    rest.append(item)
                    continue
                seen.add(key)
                if hkey is not None:
                    seen.add(hkey)
                if ckey is not None:
                    seen.add(ckey)
                batch.append(item)
            self._solve_misses(batch, outs)
            pending = []
            for j, sub, span_s, _old in rest:
                out, state = self._step_probe(sub, span_s)
                if out is not None:
                    outs[j] = out
                else:
                    pending.append((j, sub, span_s, state))
        return outs

    def _count_fallback(self, reason: str, n: int = 1):
        k = "fallback_" + reason
        self.stats[k] = self.stats.get(k, 0) + n
        c = self._c_fallbacks.get(reason)
        if c is None:
            c = self._registry.counter("replay_batch_fallbacks_total",
                                       reason=reason)
            self._c_fallbacks[reason] = c
        c.inc(n)

    def _lowered(self, fam: _StepFamily):
        """``fam``'s lowered array program, or the fallback-reason
        string explaining why it cannot lower. Lowering outcomes are
        memoized per family; the one retryable miss — streams not
        recorded yet — is not cached, so the family lowers on the
        round after its recording run. The program keeps its
        level-ordered tables on the card once built
        (``batched_replay.replay_tables``), so they too are built once
        per family."""
        if not self.options.prefix_fork:
            return "no_streams"
        got = self._lowerings.get(id(fam))
        if got is not None:
            return got
        if fam.streams is None and self._stage_sources:
            fam.streams = self._remap_streams(fam)
        if fam.streams is None:
            return "no_streams"
        br = _batched_replay()
        try:
            prog = br.lower_family(fam.streams, fam.plan)
        except br.LoweringError as err:
            prog = err.reason
        self._lowerings[id(fam)] = prog
        return prog

    def _solve_misses(self, batch: List[tuple], outs: List[Any]):
        """Replay one deduped round of cache misses. Lowerable
        families go through ``batched_replay.solve_batch`` in one
        kernel launch per family; everything else falls back to the
        scalar engine per scenario with a counted reason."""
        backend = self.options.replay_backend
        scalar: List[Tuple[tuple, str]] = []
        groups: Dict[int, Tuple[_StepFamily, Any, list]] = {}
        if backend == "numpy":
            scalar = [(item, "backend_numpy") for item in batch]
        else:
            for item in batch:
                _j, sub, _span, state = item
                fam = state[3]
                model = StepFaultModel(sub, rank_map=fam.plan.reps)
                if model._deaths:
                    scalar.append((item, "deaths"))
                    continue
                prog = self._lowered(fam)
                if isinstance(prog, str):
                    scalar.append((item, prog))
                    continue
                groups.setdefault(id(fam), (fam, prog, []))[2].append(
                    (item, model))
            if backend == "auto":
                floor = (self.options.jit_batch_min
                         or _batched_replay().JIT_BATCH_MIN)
                for gid in list(groups):
                    members = groups[gid][2]
                    if len(members) < floor:
                        scalar.extend(
                            (it, "small_batch") for it, _m in members)
                        del groups[gid]
        self._solve_groups(groups, outs)
        # scalar loop with a staleness retry: "no_streams" is the one
        # fallback a scalar replay CURES (the first sim of a stage
        # records its stream sources), so every later no_streams item
        # in the same round re-attempts lowering and rejoins a batched
        # group instead of walking the engine — one recorder per
        # stage, not one per scenario
        retry: Dict[int, Tuple[_StepFamily, Any, list]] = {}
        for item, reason in scalar:
            j, sub, _span, state = item
            if reason == "no_streams":
                fam = state[3]
                prog = self._lowered(fam)
                if not isinstance(prog, str):
                    model = StepFaultModel(sub, rank_map=fam.plan.reps)
                    retry.setdefault(id(fam), (fam, prog, []))[2].append(
                        (item, model))
                    continue
            self._count_fallback(reason)
            outs[j] = self._step_commit(state,
                                        self._replay(sub, state[3]))
        if retry and backend == "auto":
            floor = (self.options.jit_batch_min
                     or _batched_replay().JIT_BATCH_MIN)
            for gid in list(retry):
                members = retry[gid][2]
                if len(members) < floor:
                    for it, _m in members:
                        j, sub, _span, state = it
                        self._count_fallback("small_batch")
                        outs[j] = self._step_commit(
                            state, self._replay(sub, state[3]))
                    del retry[gid]
        self._solve_groups(retry, outs)

    def _solve_groups(self, groups: Dict[int, Tuple["_StepFamily",
                                                    Any, list]],
                      outs: List[Any]):
        """Solve per-family miss groups in one kernel launch each and
        commit the makespans through the scalar engine's exact
        ``(raw * ratio, None, raw)`` tail."""
        if not groups:
            return
        ratio = self.healthy()["straggle_ratio"]
        br = _batched_replay()
        for fam, prog, members in groups.values():
            raws = br.solve_batch(prog, [m for _it, m in members],
                                  device=self.options.device)
            self.stats["batched"] += len(members)
            self._c_batched.inc(len(members))
            self.stats["replays"] += len(members)
            for (item, _m), raw in zip(members, raws):
                j, _sub, _span, state = item
                raw_end = float(raw)
                outs[j] = self._step_commit(
                    state, (raw_end * ratio, None, raw_end))

    # -- (d) parallel merge-back -------------------------------------------
    def absorb_stats(self, delta: Dict[str, int]):
        """Merge a pool worker's stat deltas into this context and its
        registry counters (observe-only; results never depend on it)."""
        for k, v in delta.items():
            if v:
                self.stats[k] = self.stats.get(k, 0) + v
        for k, counter in (
            ("scenarios", self._c_scenarios),
            ("cache_hits", self._c_hits),
            ("canon_hits", self._c_canon),
            ("clamp_hits", self._c_clamp),
            ("shortcircuits", self._c_gate),
            ("forks", self._c_forks),
        ):
            if delta.get(k):
                counter.inc(delta[k])


# -- (d) process-parallel Monte-Carlo (the sweep executor's discipline) ----

#: per-worker-process state, filled by the pool initializer
_MC_WORKER: Dict[str, Any] = {}

def _mc_context():
    """The pool's start method: ``fork`` where the platform has it,
    unless this process has initialised CUDA, whose context a forked
    child cannot use — then ``spawn``."""
    import multiprocessing as _mp
    import sys

    name = os.environ.get("SIMUMAX_MP_START", "")
    if not name:
        torch = sys.modules.get("torch")
        cuda_live = torch is not None and torch.cuda.is_initialized()
        name = ("fork" if "fork" in _mp.get_all_start_methods()
                and not cuda_live else "spawn")
    return _mp.get_context(name)


def _mc_worker_init(env: tuple):
    (strategy, model, system, granularity, reduce, options,
     timeout) = env
    from simumax_tpu_torch.perf import PerfLLM

    perf = PerfLLM()
    perf.configure(strategy, model, system)
    perf.run_estimate()
    ctx = ReplayContext(perf, granularity=granularity, reduce=reduce,
                        options=options)
    _MC_WORKER["ctx"] = ctx
    _MC_WORKER["timeout"] = timeout
    _MC_WORKER["shipped"] = set(ctx._canon)
    _MC_WORKER["stats"] = dict(ctx.stats)


def _mc_task(task: tuple):
    """One Monte-Carlo work item on the worker's MAIN thread (so the
    SIGALRM scenario deadline is fully effective). Ships back the
    fresh canonical-cache entries and stat deltas for merge-back."""
    kind, idx, scenario, spec, interval_list = task
    ctx: ReplayContext = _MC_WORKER["ctx"]
    timeout = _MC_WORKER["timeout"]
    if kind == "base":
        with _deadline(timeout, f"scenario[{idx}]"):
            out: Any = predict_goodput(
                ctx.perf, scenario, spec=spec,
                granularity=ctx.granularity, reduce=ctx.reduce,
                _ctx=ctx,
            ).to_dict()
    else:
        out = {}
        for k in interval_list:
            k_spec = CheckpointSpec(
                interval_steps=int(k),
                restart_overhead_s=spec.restart_overhead_s,
                write_gbps=spec.write_gbps,
                read_gbps=spec.read_gbps,
            )
            # one deadline per (scenario, interval) walk — the same
            # scope the serial path arms, so a scenario that fits the
            # per-walk budget cannot time out only under --jobs
            with _deadline(timeout, f"scenario[{idx}]@interval{k}"):
                out[int(k)] = predict_goodput(
                    ctx.perf, scenario, spec=k_spec,
                    granularity=ctx.granularity, reduce=ctx.reduce,
                    _ctx=ctx,
                ).goodput
    shipped = _MC_WORKER["shipped"]
    fresh = {k: v for k, v in ctx._canon.items() if k not in shipped}
    shipped.update(fresh)
    last = _MC_WORKER["stats"]
    delta = {k: ctx.stats[k] - last.get(k, 0) for k in ctx.stats}
    _MC_WORKER["stats"] = dict(ctx.stats)
    return idx, out, fresh, delta


def _mc_open_pool(ctx: ReplayContext, env: tuple, jobs: int):
    """One worker pool shared by every Monte-Carlo phase: workers keep
    their replay context (recorded streams, fork ladders, caches) warm
    between the base walk and the interval sweep, so the expensive
    per-worker init (estimate rebuild + healthy critical-path run)
    is paid exactly once. Workers always start with a cold canonical
    cache — caches warm in-worker during the base phase and ship fresh
    entries back; a parent-side fork-seed global would leak entries
    across concurrent analyses of different estimates, whose canonical
    keys encode only structural identity."""
    import concurrent.futures as _cf

    return _cf.ProcessPoolExecutor(
        max_workers=jobs,
        mp_context=_mc_context(),
        initializer=_mc_worker_init,
        initargs=(env,),
    )


def _mc_pool_map(pool, ctx: ReplayContext,
                 tasks: List[tuple]) -> Dict[int, Any]:
    """Fan tasks across the pool; merge canonical-cache entries and
    stats back into ``ctx``. Results are keyed by task index, so the
    caller assembles them in scenario order — serial == parallel
    bit-for-bit (cached values equal computed values by construction).
    A worker exception (including a scenario deadline) propagates."""
    results: Dict[int, Any] = {}
    futures = [pool.submit(_mc_task, t) for t in tasks]
    for fut in futures:
        idx, out, fresh, delta = fut.result()
        ctx._canon.update(fresh)
        ctx.absorb_stats(delta)
        results[idx] = out
    return results


def predict_goodput(
    perf,
    scenario: FaultScenario,
    spec: Optional[CheckpointSpec] = None,
    granularity: str = "chunk",
    reduce="auto",
    max_restarts: int = 1000,
    _cache: Optional[Dict[tuple, Tuple[float, Optional[float]]]] = None,
    incremental: bool = True,
    options: Optional[ReplayOptions] = None,
    _ctx: Optional[ReplayContext] = None,
    observer=None,
) -> GoodputReport:
    """Predict goodput of ``scenario`` over its ``horizon_steps``.

    Walks job wall-clock step by step: each step's duration comes from
    a discrete-event simulation with the scenario's events re-based
    onto the step window (steps no event touches reuse the fault-free
    step, so only perturbed steps pay for a simulation); every
    ``interval_steps`` committed steps a checkpoint write is charged; a
    rank death aborts the step, rolls uncommitted progress back to the
    last checkpoint (its wall time becomes ``restart_replay``), and
    charges restart overhead + restore read before training resumes.

    ``incremental=True`` (default) routes perturbed-step costing
    through the incremental replay engine (:class:`ReplayContext` —
    slack short-circuit, canonicalized step cache, recorded-stream
    replay with healthy-prefix forks), bit-identical to the exact path
    and ~10x+ faster on Monte-Carlo workloads. ``incremental=False``
    (or ``reduce=False``) keeps the pre-incremental exact walk.
    ``options`` tunes the individual optimizations; ``_ctx`` shares
    one replay context across calls (``analyze_faults`` does).
    ``observer`` (optional callable) receives the walk's accounting
    events — ``("step", wall_s, healthy_s, dur_s)``,
    ``("checkpoint", wall_s, write_s)`` and ``("restart",
    abort_wall_s, extra_lost_s, overhead_s, read_s)`` — the bucket
    provenance the fleet ledger attributes to causing trace events
    (``observe/fleetledger.py``). Pure notification: an observer
    cannot change a single number, so observed and unobserved walks
    are bit-identical by construction.
    """
    from simumax_tpu_torch.observe.telemetry import get_registry, get_tracer

    ctx = _ctx
    if ctx is None and incremental and reduce is not False:
        ctx = ReplayContext(perf, granularity=granularity,
                            reduce=reduce, options=options)
    if ctx is not None and (ctx.perf is not perf
                            or ctx.granularity != granularity):
        raise ConfigError(
            "predict_goodput _ctx mismatch: the replay context was "
            f"built for granularity {ctx.granularity!r} on a "
            "different estimate",
            phase="simulate",
        )
    # validation + checkpoint-spec resolution hoist once per shared
    # context (the fleet walk re-costs a scenario thousands of times);
    # without a context both run per call, behaviorally identical
    if ctx is not None:
        ctx.validate_scenario(scenario)
    else:
        scenario.validate(perf.strategy.world_size)
    # an explicitly passed spec wins outright (a CLI flag must beat
    # the scenario's bundled default, not the other way round); the
    # scenario's "checkpoint" block only fills in when none is given
    if spec is None:
        spec = (ctx.resolve_spec(scenario) if ctx is not None
                else CheckpointSpec.from_overrides(scenario.checkpoint))
    with get_tracer().span("predict_goodput",
                           events=len(scenario.events),
                           horizon=scenario.horizon_steps,
                           incremental=ctx is not None):
        if ctx is not None:
            ctx.stats["scenarios"] += 1
            ctx._c_scenarios.inc()
            ckpt = ctx.checkpoint_model(spec)
            healthy = ctx.healthy()
        else:
            from simumax_tpu_torch.simulator.runner import run_simulation

            get_registry().counter("faults_scenarios_total").inc()
            ckpt = CheckpointCostModel.from_perf(perf, spec)
            healthy = run_simulation(
                perf, None, granularity=granularity, world_ranks=True,
                reduce=reduce,
            )
        return _goodput_walk(perf, scenario, spec, ckpt, healthy,
                             granularity, reduce, max_restarts, _cache,
                             ctx, observer=observer)


def _goodput_walk(perf, scenario, spec, ckpt, healthy, granularity,
                  reduce, max_restarts, _cache, ctx,
                  observer=None) -> GoodputReport:
    """Drive one scenario's walk generator serially, answering each
    step request as it arrives — behaviorally identical to the
    pre-generator inline walk. The generator split exists so the
    lockstep walker (:func:`_predict_goodput_batch`) can advance many
    walks in rounds and feed whole miss batches to the batched replay
    backend."""
    cache = _cache if _cache is not None else {}
    gen = _walk_gen(scenario, spec, ckpt, healthy, max_restarts,
                    observer=observer)
    ans = None
    while True:
        try:
            sub, span = gen.send(ans)
        except StopIteration as stop:
            return stop.value
        if ctx is not None:
            ans = ctx.simulate_step(sub, span)
        else:
            ans = _simulate_step(perf, sub, cache, granularity, reduce)


def _walk_gen(scenario, spec, ckpt, healthy, max_restarts,
              observer=None):
    """The goodput walk as a coroutine: yields ``(sub, span_s)`` step
    requests, receives ``(dur, death)`` answers, and returns the
    finished :class:`GoodputReport` (via ``StopIteration.value``).
    Pure bookkeeping — every simulation happens in the caller.
    ``observer`` (see :func:`predict_goodput`) is notified of each
    accounting event; it never feeds back into the walk."""
    h = healthy["end_time"]
    horizon = scenario.horizon_steps
    interval = spec.interval_steps
    b = GoodputBuckets()
    wall = 0.0
    committed = 0
    ckpt_committed = 0
    n_ckpt = n_restart = replayed = 0
    #: (healthy_part, stall_part) of steps committed since the last
    #: checkpoint — rolled into restart_replay on a death
    uncommitted: List[Tuple[float, float]] = []
    deaths: List[Dict[str, float]] = []
    truncated = False

    def first_death_in(t0_s: float, t1_s: float) -> Optional[float]:
        """Earliest rank-death absolute time inside [t0, t1)."""
        times = [
            ev.start_ms * 1e-3 for ev in scenario.events
            if ev.kind == "rank_death"
            and t0_s <= ev.start_ms * 1e-3 < t1_s
        ]
        return min(times) if times else None

    def restart(abort_wall_s: float, extra_lost_s: float):
        """Roll uncommitted progress back to the last checkpoint and
        charge the recovery sequence. ``extra_lost_s`` is wall time of
        the aborted partial step / checkpoint write."""
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

    while committed < horizon:
        # fixpoint window growth: a step stretched by faults may pull
        # later events into its window
        span = h
        dur, death = h, None
        for _ in range(8):
            sub = scenario.shifted(wall * 1e3, span * 1e3)
            if sub.empty:
                dur, death = h, None
                break
            dur, death = yield (sub, span)
            if death is not None or dur <= span * (1 + 1e-12):
                break
            span = dur
        if death is None:
            if observer is not None:
                observer(("step", wall, h, dur))
            wall += dur
            b.useful_train += h
            b.fault_stall += dur - h
            uncommitted.append((h, dur - h))
            committed += 1
            if committed % interval == 0 and committed < horizon:
                # a rank death during the checkpoint write still kills
                # the job — and the interrupted write never commits
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
            # committed-but-uncheckpointed steps are lost: their wall
            # time (healthy + stall) turns into replay, plus the
            # aborted partial step
            restart(wall + death, death)
            if n_restart >= max_restarts:
                truncated = True
                break
    useful = b.useful_train
    return GoodputReport(
        goodput=(useful / wall) if wall > 0 else 1.0,
        wall_time_s=wall,
        useful_time_s=useful,
        healthy_step_s=h,
        horizon_steps=horizon,
        n_checkpoints=n_ckpt,
        n_restarts=n_restart,
        steps_replayed=replayed,
        buckets=b,
        deaths=deaths,
        checkpoint=ckpt.to_dict(),
        truncated=truncated,
    )


def _predict_goodput_batch(ctx: ReplayContext,
                           tasks: List[Tuple[FaultScenario,
                                             CheckpointSpec]],
                           max_restarts: int = 1000
                           ) -> List[GoodputReport]:
    """Lockstep twin of calling :func:`predict_goodput` serially on
    ``tasks`` with a shared context: every walk advances one step per
    round, and the round's step requests are answered together by
    :meth:`ReplayContext.simulate_step_batch`, so the batched replay
    backend sees whole miss batches instead of one miss at a time.
    Reports are bit-identical to the serial loop — every cache layer
    guarantees cached == computed, so answer order cannot change a
    number, only which request pays for the simulation."""
    from simumax_tpu_torch.observe.telemetry import get_tracer

    healthy = ctx.healthy()
    results: List[Any] = [None] * len(tasks)
    walks = []
    with get_tracer().span("predict_goodput_batch", walks=len(tasks),
                           incremental=True):
        for scenario, spec in tasks:
            ctx.validate_scenario(scenario)
            ctx.stats["scenarios"] += 1
            ctx._c_scenarios.inc()
            ckpt = ctx.checkpoint_model(spec)
            walks.append(_walk_gen(scenario, spec, ckpt, healthy,
                                   max_restarts))
        pend: Dict[int, tuple] = {}
        for i, gen in enumerate(walks):
            try:
                pend[i] = gen.send(None)
            except StopIteration as stop:
                results[i] = stop.value
        while pend:
            order = sorted(pend)
            answers = ctx.simulate_step_batch([pend[i] for i in order])
            for i, ans in zip(order, answers):
                try:
                    pend[i] = walks[i].send(ans)
                except StopIteration as stop:
                    results[i] = stop.value
                    del pend[i]
    return results


# --------------------------------------------------------------------------
# Monte-Carlo sampling
# --------------------------------------------------------------------------


def sample_scenario(
    rng: random.Random,
    world_size: int,
    horizon_ms: float,
    *,
    horizon_steps: int = 100,
    max_events: int = 6,
    death_prob: float = 0.3,
    seed: Optional[int] = None,
) -> FaultScenario:
    """One random-but-seeded fault scenario: a mix of slowdown windows,
    preemptions, scoped/unscoped link degradations, and (with
    ``death_prob``) rank deaths, all inside ``[0, horizon_ms)``."""
    events: List[FaultEvent] = []
    n = rng.randint(0, max_events)
    for _ in range(n):
        kind = rng.choice(("slowdown", "preemption", "link_degradation"))
        start = rng.uniform(0.0, horizon_ms * 0.9)
        dur = rng.uniform(horizon_ms * 0.005, horizon_ms * 0.25)
        if kind == "slowdown":
            events.append(FaultEvent(
                "slowdown", start_ms=start, duration_ms=dur,
                rank=rng.randrange(world_size),
                multiplier=rng.uniform(1.05, 5.0),
            ))
        elif kind == "preemption":
            events.append(FaultEvent(
                "preemption", start_ms=start,
                duration_ms=rng.uniform(horizon_ms * 0.002,
                                        horizon_ms * 0.05),
                rank=rng.randrange(world_size),
            ))
        else:
            scope = None
            if rng.random() < 0.5:
                k = rng.randint(1, max(1, min(4, world_size)))
                scope = sorted(rng.sample(range(world_size), k))
            events.append(FaultEvent(
                "link_degradation", start_ms=start, duration_ms=dur,
                dim=rng.choice(("tp", "pp", "dp_cp", "*")),
                multiplier=rng.uniform(1.1, 8.0), ranks=scope,
            ))
    if rng.random() < death_prob:
        events.append(FaultEvent(
            "rank_death", start_ms=rng.uniform(0.0, horizon_ms * 0.9),
            rank=rng.randrange(world_size),
        ))
    return FaultScenario(events=events, horizon_steps=horizon_steps,
                         seed=seed)


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def analyze_faults(
    perf,
    n_scenarios: int = 32,
    seed: int = 0,
    horizon_steps: int = 50,
    spec: Optional[CheckpointSpec] = None,
    intervals: Optional[Sequence[int]] = None,
    granularity: str = "chunk",
    reduce="auto",
    max_events: int = 6,
    death_prob: float = 0.3,
    jobs: int = 0,
    incremental: bool = True,
    options: Optional[ReplayOptions] = None,
    scenario_timeout: Optional[float] = None,
    _ctx: Optional[ReplayContext] = None,
) -> Dict[str, Any]:
    """Seeded Monte-Carlo goodput analysis: sample ``n_scenarios``
    random scenarios, predict each one's goodput, and sweep checkpoint
    intervals to find the empirically optimal one (reported next to
    the Young–Daly closed form ``sqrt(2 * write_time * MTBF)``).
    Deterministic for a given seed.

    ``incremental=True`` (default) shares one :class:`ReplayContext`
    across every prediction — the grid entry equal to
    ``spec.interval_steps`` reuses the base walk outright, and the
    remaining walks hit the slack gate / canonical cache / prefix
    forks. ``jobs=N`` fans scenarios across a process pool (the sweep
    executor discipline: worker-main-thread SIGALRM deadlines via
    ``scenario_timeout``, canonical-cache merge-back); the result is
    bit-for-bit equal to the serial one. ``incremental=False`` keeps
    the pre-incremental exact path."""
    from simumax_tpu_torch.observe.telemetry import get_tracer

    spec = spec or CheckpointSpec()
    st = perf.strategy
    jobs = max(0, int(jobs or 0))
    ctx = _ctx
    if ctx is None and incremental and reduce is not False:
        ctx = ReplayContext(perf, granularity=granularity,
                            reduce=reduce, options=options)
    if ctx is not None:
        healthy = ctx.healthy()
    else:
        from simumax_tpu_torch.simulator.runner import run_simulation

        healthy = run_simulation(
            perf, None, granularity=granularity, world_ranks=True,
            reduce=reduce,
        )
    h = healthy["end_time"]
    # sample against the rough job wall (healthy horizon + slack so
    # late-run faults land inside the actual, stretched wall-clock)
    horizon_ms = horizon_steps * h * 1e3 * 1.25
    rng = random.Random(seed)
    scenarios = [
        sample_scenario(
            rng, st.world_size, horizon_ms, horizon_steps=horizon_steps,
            max_events=max_events, death_prob=death_prob, seed=seed,
        )
        for _ in range(n_scenarios)
    ]
    parallel = ctx is not None and jobs > 1 and len(scenarios) > 1
    # lockstep batching: advance every scenario walk in rounds so the
    # batched replay backend sees whole miss batches. Off under a
    # per-scenario deadline (SIGALRM scopes one walk, not a round) and
    # under replay_backend="numpy" (nothing to batch)
    lockstep = (ctx is not None and not parallel
                and scenario_timeout is None
                and ctx.options.replay_backend != "numpy"
                and len(scenarios) > 1)
    env = None
    if parallel:
        env = (perf.strategy, perf.model_config, perf.system,
               granularity, reduce, ctx.options, scenario_timeout)
    cache: Dict[tuple, Tuple[float, Optional[float]]] = {}
    pool = None
    try:
      # (one pool for both phases: workers keep recorded streams, fork
      # ladders and caches warm between the base walk and the sweep)
      with get_tracer().span("analyze_faults", n_scenarios=n_scenarios,
                             seed=seed, jobs=jobs,
                             incremental=ctx is not None):
        if parallel:
            pool = _mc_open_pool(ctx, env, min(jobs, len(scenarios)))
            got = _mc_pool_map(
                pool, ctx,
                [("base", i, s, spec, None)
                 for i, s in enumerate(scenarios)],
            )
            report_dicts = [got[i] for i in range(len(scenarios))]
        elif lockstep:
            report_dicts = [
                r.to_dict() for r in _predict_goodput_batch(
                    ctx, [(s, spec) for s in scenarios])
            ]
        else:
            report_dicts = []
            for i, s in enumerate(scenarios):
                with _deadline(scenario_timeout, f"scenario[{i}]"):
                    report_dicts.append(predict_goodput(
                        perf, s, spec=spec, granularity=granularity,
                        reduce=reduce, _cache=cache,
                        incremental=ctx is not None, _ctx=ctx,
                    ).to_dict())
        goodputs = sorted(r["goodput"] for r in report_dicts)
        n_interrupts = sum(r["n_restarts"] for r in report_dicts)
        total_wall = sum(r["wall_time_s"] for r in report_dicts)
        mtbf = (total_wall / n_interrupts) if n_interrupts else math.inf
        ckpt = (ctx.checkpoint_model(spec) if ctx is not None
                else CheckpointCostModel.from_perf(perf, spec))
        if math.isfinite(mtbf):
            yd_interval = max(
                1, int(round(math.sqrt(2.0 * ckpt.write_s * mtbf) / h))
            )
        else:
            yd_interval = horizon_steps
        if intervals is None:
            grid = sorted({
                max(1, horizon_steps // 16), max(1, horizon_steps // 8),
                max(1, horizon_steps // 4), max(1, horizon_steps // 2),
                horizon_steps, min(yd_interval, horizon_steps),
            })
            intervals = grid
        base_goodputs = [r["goodput"] for r in report_dicts]
        pending = [
            int(k) for k in intervals
            if not (ctx is not None and int(k) == spec.interval_steps)
        ]
        grid_vals: Dict[int, Dict[int, float]] = {}
        if parallel and pending:
            grid_vals = _mc_pool_map(
                pool, ctx,
                [("grid", i, s, spec, tuple(pending))
                 for i, s in enumerate(scenarios)],
            )
        elif pending:
            # one spec per interval, shared across scenarios (the
            # per-(scenario, interval) rebuild was pure duplication)
            k_specs = {
                k: CheckpointSpec(
                    interval_steps=int(k),
                    restart_overhead_s=spec.restart_overhead_s,
                    write_gbps=spec.write_gbps,
                    read_gbps=spec.read_gbps,
                )
                for k in pending
            }
            if lockstep:
                reports = _predict_goodput_batch(
                    ctx,
                    [(s, k_specs[k]) for s in scenarios
                     for k in pending],
                )
                for i in range(len(scenarios)):
                    grid_vals[i] = {
                        int(k): reports[i * len(pending) + p].goodput
                        for p, k in enumerate(pending)
                    }
            else:
                for i, s in enumerate(scenarios):
                    per: Dict[int, float] = {}
                    for k in pending:
                        k_spec = k_specs[k]
                        with _deadline(scenario_timeout,
                                       f"scenario[{i}]@interval{k}"):
                            per[int(k)] = predict_goodput(
                                perf, s, spec=k_spec,
                                granularity=granularity, reduce=reduce,
                                _cache=cache,
                                incremental=ctx is not None, _ctx=ctx,
                            ).goodput
                    grid_vals[i] = per
        by_interval: Dict[int, float] = {}
        for k in intervals:
            k = int(k)
            if ctx is not None and k == spec.interval_steps:
                # the base walk already costed this interval: reuse its
                # reports instead of re-walking every scenario
                vals = base_goodputs
            else:
                vals = [grid_vals[i][k] for i in range(len(scenarios))]
            by_interval[k] = sum(vals) / len(vals) if vals else 1.0
    finally:
        if pool is not None:
            # cancel_futures: a worker failure (e.g. a scenario
            # deadline) must not wait out every still-queued task —
            # only the <= jobs currently-running walks drain
            pool.shutdown(cancel_futures=True)
    best_interval = max(by_interval, key=lambda k: (by_interval[k], -k))
    return {
        "schema": "simumax-fault-analysis-v1",
        "seed": seed,
        "n_scenarios": n_scenarios,
        "horizon_steps": horizon_steps,
        "healthy_step_s": h,
        "goodput": {
            "mean": sum(goodputs) / len(goodputs) if goodputs else 1.0,
            "min": goodputs[0] if goodputs else 1.0,
            "max": goodputs[-1] if goodputs else 1.0,
            "p10": _quantile(goodputs, 0.10),
            "p50": _quantile(goodputs, 0.50),
            "p90": _quantile(goodputs, 0.90),
        },
        "restarts_total": n_interrupts,
        "mtbf_s": mtbf,
        "checkpoint": ckpt.to_dict(),
        "goodput_by_interval": by_interval,
        "best_interval_steps": best_interval,
        "young_daly_interval_steps": yd_interval,
        "reports": report_dicts,
    }


__all__ = [
    "EVENT_KINDS",
    "LINK_DIMS",
    "FaultEvent",
    "FaultScenario",
    "StepFaultModel",
    "FaultOutcome",
    "CheckpointSpec",
    "CheckpointCostModel",
    "GoodputReport",
    "ReplayOptions",
    "ReplayContext",
    "predict_goodput",
    "sample_scenario",
    "analyze_faults",
]

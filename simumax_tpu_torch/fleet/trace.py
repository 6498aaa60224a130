"""Fleet trace schema: the declarative input of the multi-job fleet
simulator (``fleet/sim.py``, docs/fleet.md).

One JSON document (``simumax-fleet-trace-v1``) carries the three layers
of the datacenter question:

* **fleet spec** — the shared hardware: pods (named chip blocks),
  maintenance windows (a pod down for a window), spot reclaims (chips
  leaving a pod, explicit and/or sampled from a seeded Poisson
  process), link-degradation windows (a pod's ICI dim slowed for a
  window), and the scheduler policy knobs;
* **templates** — the distinct (model, strategy, system, granularity)
  tuples jobs instantiate. The fleet simulator builds ONE replay
  context per template and shares it across every job — the
  cross-job amortization that makes the walk interactive;
* **jobs** — the arrival trace: per-job template, arrival time,
  horizon, priority, spot eligibility, goodput SLO, checkpoint
  overrides.

All times are absolute fleet seconds from trace start. Everything is
validated up front (``FleetTrace.validate``) with
:class:`~simumax_tpu_torch.core.errors.ConfigError` on schema violations, so
a malformed trace fails before any simulation work.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.simulator.faults import LINK_DIMS

SCHEMA = "simumax-fleet-trace-v1"

#: named priorities accepted beside raw ints (higher wins)
PRIORITIES = {"low": 0, "normal": 1, "high": 2}

POLICIES = ("fifo", "priority")


def _bad(msg: str, **ctx):
    raise ConfigError(f"fleet trace: {msg}", phase="fleet", **ctx)


def _num(d: dict, key: str, default=None, positive=False,
         nonneg=False, where: str = ""):
    v = d.get(key, default)
    if v is None:
        _bad(f"{where}: missing required field {key!r}")
    if not isinstance(v, (int, float)) or not math.isfinite(v):
        _bad(f"{where}: {key} must be a finite number, got {v!r}")
    if positive and v <= 0:
        _bad(f"{where}: {key} must be > 0, got {v!r}")
    if nonneg and v < 0:
        _bad(f"{where}: {key} must be >= 0, got {v!r}")
    return v


@dataclass
class PodSpec:
    """One named block of interchangeable chips."""

    name: str
    chips: int

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "chips": self.chips}


@dataclass
class Window:
    """A timed per-pod condition: maintenance (pod down), or a link
    degradation (``dim``/``multiplier`` set)."""

    pod: str
    start_s: float
    duration_s: float
    dim: Optional[str] = None
    multiplier: float = 1.0

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "pod": self.pod, "start_s": self.start_s,
            "duration_s": self.duration_s,
        }
        if self.dim is not None:
            d["dim"] = self.dim
            d["multiplier"] = self.multiplier
        return d


@dataclass
class SpotReclaim:
    """``chips`` chips leave ``pod`` at ``start_s`` (and never come
    back within the trace)."""

    pod: str
    start_s: float
    chips: int

    def to_dict(self) -> Dict[str, Any]:
        return {"pod": self.pod, "start_s": self.start_s,
                "chips": self.chips}


@dataclass
class SchedulerSpec:
    """Scheduler policy knobs.

    * ``policy`` — ``"fifo"`` (strict arrival order, head-of-line
      blocking) or ``"priority"`` (scan the wait queue by priority;
      a higher-priority arrival may preempt lower-priority running
      jobs when the fleet is full).
    * ``elastic`` — on a spot reclaim, shrink the victim's dp instead
      of rollback-restart when feasible (divisible global batch +
      shrunk layout still fits HBM — ``search/prune.py``).
    * ``reshape_overhead_s`` — fixed re-init cost charged per reshape
      on top of the state-redistribution collectives.
    """

    policy: str = "fifo"
    elastic: bool = False
    reshape_overhead_s: float = 30.0

    def to_dict(self) -> Dict[str, Any]:
        return {"policy": self.policy, "elastic": self.elastic,
                "reshape_overhead_s": self.reshape_overhead_s}


@dataclass
class FleetSpec:
    """The shared hardware + its failure/maintenance processes."""

    pods: List[PodSpec] = field(default_factory=list)
    maintenance: List[Window] = field(default_factory=list)
    link_degradations: List[Window] = field(default_factory=list)
    spot_reclaims: List[SpotReclaim] = field(default_factory=list)
    #: optional seeded Poisson reclaim process, materialized into
    #: ``spot_reclaims`` by :meth:`materialize_spot`
    spot: Optional[Dict[str, Any]] = None
    scheduler: SchedulerSpec = field(default_factory=SchedulerSpec)

    @property
    def total_chips(self) -> int:
        return sum(p.chips for p in self.pods)

    def pod(self, name: str) -> PodSpec:
        for p in self.pods:
            if p.name == name:
                return p
        _bad(f"unknown pod {name!r}")

    def materialize_spot(self) -> List[SpotReclaim]:
        """Explicit reclaims plus the sampled process (seeded,
        deterministic): exponential inter-arrivals at
        ``rate_per_hour`` over ``horizon_s``, each taking ``chips``
        chips from a sampled pod. Returned sorted by time."""
        out = list(self.spot_reclaims)
        sp = self.spot
        if sp:
            rng = random.Random(int(sp.get("seed", 0)))
            rate = float(sp.get("rate_per_hour", 0.0))
            horizon = float(sp.get("horizon_s", 0.0))
            chips = int(sp.get("chips", 0))
            names = sorted(p.name for p in self.pods)
            t = 0.0
            while rate > 0 and chips > 0 and names:
                t += rng.expovariate(rate / 3600.0)
                if t >= horizon:
                    break
                out.append(SpotReclaim(
                    pod=rng.choice(names), start_s=t, chips=chips,
                ))
        return sorted(out, key=lambda r: (r.start_s, r.pod, r.chips))

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "pods": [p.to_dict() for p in self.pods],
            "scheduler": self.scheduler.to_dict(),
        }
        if self.maintenance:
            d["maintenance"] = [w.to_dict() for w in self.maintenance]
        if self.link_degradations:
            d["link_degradations"] = [
                w.to_dict() for w in self.link_degradations
            ]
        if self.spot_reclaims:
            d["spot_reclaims"] = [
                r.to_dict() for r in self.spot_reclaims
            ]
        if self.spot:
            d["spot"] = dict(self.spot)
        return d


@dataclass
class TemplateSpec:
    """One distinct (model, strategy, system, granularity) job shape.
    ``model``/``strategy``/``system`` are whatever
    ``PerfLLM.configure`` accepts — registry names, file paths, or
    inline dicts. ``overrides`` are post-load field overrides
    (``{"model": {...}, "strategy": {...}}``) so a trace can e.g. trim
    ``layer_num`` or pin ``world_size`` without an inline full
    config."""

    name: str
    model: Any
    strategy: Any
    system: Any
    granularity: str = "chunk"
    overrides: Optional[Dict[str, Dict[str, Any]]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "model": self.model, "strategy": self.strategy,
            "system": self.system, "granularity": self.granularity,
        }
        if self.overrides:
            d["overrides"] = self.overrides
        return d


@dataclass
class JobSpec:
    """One job of the arrival trace."""

    name: str
    template: str
    arrival_s: float = 0.0
    horizon_steps: int = 50
    priority: int = 1
    spot: bool = False
    #: goodput SLO target in (0, 1]; None = no SLO
    slo_goodput: Optional[float] = None
    #: CheckpointSpec field overrides (``faults.CheckpointSpec``)
    checkpoint: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name, "template": self.template,
            "arrival_s": self.arrival_s,
            "horizon_steps": self.horizon_steps,
            "priority": self.priority, "spot": self.spot,
        }
        if self.slo_goodput is not None:
            d["slo_goodput"] = self.slo_goodput
        if self.checkpoint:
            d["checkpoint"] = dict(self.checkpoint)
        return d


@dataclass
class FleetTrace:
    """The whole input document: fleet + templates + job arrivals."""

    fleet: FleetSpec
    templates: Dict[str, TemplateSpec]
    jobs: List[JobSpec]

    def validate(self) -> "FleetTrace":
        if not self.fleet.pods:
            _bad("fleet needs at least one pod")
        seen = set()
        for p in self.fleet.pods:
            if not isinstance(p.name, str) or not p.name:
                _bad("pod names must be non-empty strings")
            if p.name in seen:
                _bad(f"duplicate pod name {p.name!r}")
            seen.add(p.name)
            if not isinstance(p.chips, int) or p.chips < 1:
                _bad(f"pod {p.name}: chips must be a positive int")
        for w in self.fleet.maintenance:
            self.fleet.pod(w.pod)
            _num({"s": w.start_s}, "s", nonneg=True,
                 where=f"maintenance on {w.pod}")
            _num({"d": w.duration_s}, "d", positive=True,
                 where=f"maintenance on {w.pod}")
        for w in self.fleet.link_degradations:
            self.fleet.pod(w.pod)
            if w.dim not in LINK_DIMS:
                _bad(f"link degradation on {w.pod}: dim {w.dim!r} not "
                     f"one of {LINK_DIMS}")
            if not (math.isfinite(w.multiplier)
                    and w.multiplier >= 1.0):
                _bad(f"link degradation on {w.pod}: multiplier must "
                     f"be finite and >= 1.0")
        for r in self.fleet.spot_reclaims:
            self.fleet.pod(r.pod)
            if not isinstance(r.chips, int) or r.chips < 1:
                _bad(f"spot reclaim on {r.pod}: chips must be a "
                     f"positive int")
        if self.fleet.scheduler.policy not in POLICIES:
            _bad(f"scheduler policy "
                 f"{self.fleet.scheduler.policy!r} not one of "
                 f"{POLICIES}")
        if not self.templates:
            _bad("trace needs at least one template")
        if not self.jobs:
            _bad("trace needs at least one job")
        names = set()
        for j in self.jobs:
            if j.name in names:
                _bad(f"duplicate job name {j.name!r}")
            names.add(j.name)
            if j.template not in self.templates:
                _bad(f"job {j.name}: unknown template "
                     f"{j.template!r} (have "
                     f"{sorted(self.templates)})")
            if not isinstance(j.horizon_steps, int) \
                    or j.horizon_steps < 1:
                _bad(f"job {j.name}: horizon_steps must be a "
                     f"positive int")
            if j.slo_goodput is not None and not (
                isinstance(j.slo_goodput, (int, float))
                and 0.0 < j.slo_goodput <= 1.0
            ):
                _bad(f"job {j.name}: slo_goodput must be in (0, 1]")
        return self

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA,
            "fleet": self.fleet.to_dict(),
            "templates": {
                k: t.to_dict() for k, t in sorted(self.templates.items())
            },
            "jobs": [j.to_dict() for j in self.jobs],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetTrace":
        schema = d.get("schema", SCHEMA)
        if schema != SCHEMA:
            _bad(f"unknown schema {schema!r} (expected {SCHEMA})")
        f = d.get("fleet") or {}
        sched = dict(f.get("scheduler") or {})
        unknown = set(sched) - {
            "policy", "elastic", "reshape_overhead_s",
        }
        if unknown:
            _bad(f"unknown scheduler fields {sorted(unknown)}")
        fleet = FleetSpec(
            pods=[PodSpec(str(p["name"]), int(p["chips"]))
                  for p in f.get("pods", [])],
            maintenance=[
                Window(pod=str(w["pod"]),
                       start_s=float(w["start_s"]),
                       duration_s=float(w["duration_s"]))
                for w in f.get("maintenance", [])
            ],
            link_degradations=[
                Window(pod=str(w["pod"]),
                       start_s=float(w["start_s"]),
                       duration_s=float(w["duration_s"]),
                       dim=w.get("dim"),
                       multiplier=float(w.get("multiplier", 1.0)))
                for w in f.get("link_degradations", [])
            ],
            spot_reclaims=[
                SpotReclaim(pod=str(r["pod"]),
                            start_s=float(r["start_s"]),
                            chips=int(r["chips"]))
                for r in f.get("spot_reclaims", [])
            ],
            spot=f.get("spot"),
            scheduler=SchedulerSpec(**sched),
        )
        templates = {}
        for name, t in (d.get("templates") or {}).items():
            missing = {"model", "strategy", "system"} - set(t)
            if missing:
                _bad(f"template {name}: missing {sorted(missing)}")
            templates[str(name)] = TemplateSpec(
                name=str(name), model=t["model"],
                strategy=t["strategy"], system=t["system"],
                granularity=t.get("granularity", "chunk"),
                overrides=t.get("overrides"),
            )
        jobs = []
        for i, j in enumerate(d.get("jobs", [])):
            pr = j.get("priority", 1)
            if isinstance(pr, str):
                if pr not in PRIORITIES:
                    _bad(f"job {j.get('name', i)}: priority {pr!r} "
                         f"not one of {sorted(PRIORITIES)}")
                pr = PRIORITIES[pr]
            jobs.append(JobSpec(
                name=str(j.get("name", f"job-{i:02d}")),
                template=str(j.get("template", "")),
                arrival_s=float(j.get("arrival_s", 0.0)),
                horizon_steps=int(j.get("horizon_steps", 50)),
                priority=int(pr),
                spot=bool(j.get("spot", False)),
                slo_goodput=j.get("slo_goodput"),
                checkpoint=j.get("checkpoint"),
            ))
        return cls(fleet=fleet, templates=templates,
                   jobs=jobs).validate()

    @classmethod
    def load(cls, source) -> "FleetTrace":
        """A trace from a dict, a JSON file path, or a FleetTrace
        (pass-through)."""
        if isinstance(source, FleetTrace):
            return source.validate()
        if isinstance(source, dict):
            return cls.from_dict(source)
        try:
            with open(source, encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, json.JSONDecodeError, TypeError) as exc:
            _bad(f"cannot load trace {source!r}: {exc}")
        return cls.from_dict(data)

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=2)
        return path


__all__ = [
    "SCHEMA",
    "PRIORITIES",
    "POLICIES",
    "PodSpec",
    "Window",
    "SpotReclaim",
    "SchedulerSpec",
    "FleetSpec",
    "TemplateSpec",
    "JobSpec",
    "FleetTrace",
]

"""Accounting records (L1): per-module compute / activation / parameter /
cost bookkeeping with ``+`` aggregation.

Reference: ``simumax/core/model_struct.py`` (``ModuleComputeInfo:40``,
``ActivationInfo:112``, ``ModuleMemoryInfo:240``, ``ModuleCostInfo:323``,
``PathDebugContext:199``, ``RecomputeStatus:15``) — re-shaped into four flat
dataclasses keyed by the three backprop phases ``fwd`` / ``bwd_act``
(dgrad) / ``bwd_w`` (wgrad).

Copy of the JAX package's ``core/records.py``. The telemetry registry is
not ported yet, so ``Diagnostics.counters`` is a plain dict here: the
JAX package mirrors its numeric writes into ``diag_counter`` gauges,
which changes no payload.
"""

from __future__ import annotations

import contextlib
import enum
import hashlib
import json
import time as _time
import warnings as _warnings
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from simumax_tpu_torch.core.errors import SimuMaxError, _json_safe

PHASES = ("fwd", "bwd_act", "bwd_w")


class RecomputeStatus(enum.Enum):
    NONE = 0
    FIRST = 1  # first leaf of a checkpointed segment: caches segment input
    MIDDLE = 2
    LAST = 3


def _addable(cls):
    """Give a numeric dataclass field-wise __add__/__radd__ (sum-friendly)."""

    def __add__(self, other):
        if other == 0:
            return self
        kw = {}
        for f in field_names:
            a, b = getattr(self, f), getattr(other, f)
            kw[f] = a + b
        return cls(**kw)

    field_names = [f.name for f in cls.__dataclass_fields__.values()]  # type: ignore[attr-defined]
    cls.__add__ = __add__
    cls.__radd__ = __add__
    return cls


@_addable
@dataclass
class ComputeInfo:
    """FLOPs + HBM bytes accessed per phase."""

    fwd_flops: float = 0.0
    bwd_act_flops: float = 0.0
    bwd_w_flops: float = 0.0
    fwd_accessed: float = 0.0
    bwd_act_accessed: float = 0.0
    bwd_w_accessed: float = 0.0

    @property
    def bwd_flops(self) -> float:
        return self.bwd_act_flops + self.bwd_w_flops

    @property
    def total_flops(self) -> float:
        return self.fwd_flops + self.bwd_flops


@_addable
@dataclass
class ActivationInfo:
    """Activation-memory accounting for one module (all per-microbatch,
    per-device bytes)."""

    #: bytes held from fwd until this module's bwd (the "activation cache")
    cache_bytes: float = 0.0
    #: transient extra bytes live only while the fwd op runs
    fwd_temp_bytes: float = 0.0
    #: transient extra bytes live only while the bwd op runs
    bwd_temp_bytes: float = 0.0
    #: module input / output sizes (for replay & p2p sizing)
    input_bytes: float = 0.0
    output_bytes: float = 0.0

    @property
    def grad_flight_bytes(self) -> float:
        """Gradient tensors live while this module's backward runs:
        incoming output-grad + outgoing input-grad."""
        return self.input_bytes + self.output_bytes


@_addable
@dataclass
class ParamInfo:
    """Weight / grad / optimizer-state bytes, dense vs expert (MoE) split
    (reference ``ModuleMemoryInfo`` model_struct.py:240)."""

    weight_bytes: float = 0.0
    grad_bytes: float = 0.0
    state_bytes: float = 0.0
    moe_weight_bytes: float = 0.0
    moe_grad_bytes: float = 0.0
    moe_state_bytes: float = 0.0
    #: raw (unsharded-optimizer) elements, for DP-comm sizing
    dense_numel: float = 0.0
    moe_numel: float = 0.0

    @property
    def total_bytes(self) -> float:
        return (
            self.weight_bytes
            + self.grad_bytes
            + self.state_bytes
            + self.moe_weight_bytes
            + self.moe_grad_bytes
            + self.moe_state_bytes
        )


@dataclass
class CollectiveCall:
    """One collective issued by a leaf in a given phase.

    ``point`` orders it against the leaf's compute within the phase
    ('pre' before, 'post' after) — the discrete-event simulator replays
    these as real jobs; the analytical path adds ``time`` when ``exposed``.
    """

    phase: str  # fwd | bwd_act | bwd_w
    op: str  # all_gather | reduce_scatter | all_reduce | all2all | p2p
    dim: str  # parallel dim name -> CommPath (tp/cp/dp/ep/etp/edp/pp)
    size_bytes: float
    point: str = "pre"  # pre | post
    exposed: bool = True
    time: float = 0.0  # filled by the framework
    #: serialized portion of ``time`` on the critical path; defaults to
    #: ``time`` when exposed, 0 when overlapped — composites may move
    #: part of a "hidden" call back onto the critical path when the
    #: overlap budget (adjacent compute) is smaller than the comm
    exposed_time: float = 0.0


@_addable
@dataclass
class _PhaseTimes:
    fwd: float = 0.0
    bwd_act: float = 0.0
    bwd_w: float = 0.0

    def get(self, phase: str) -> float:
        return getattr(self, phase)

    def add(self, phase: str, v: float):
        setattr(self, phase, getattr(self, phase) + v)

    @property
    def bwd(self) -> float:
        return self.bwd_act + self.bwd_w

    @property
    def total(self) -> float:
        return self.fwd + self.bwd_act + self.bwd_w


@dataclass
class CostInfo:
    """Per-phase times (reference ``ModuleCostInfo`` model_struct.py:323).

    ``compute`` is the rooflined on-chip time, ``net_exposed`` the
    serialized collective time, ``net_hidden`` collectives assumed
    overlapped (counted for traces but not the critical path).
    """

    compute: _PhaseTimes = field(default_factory=_PhaseTimes)
    net_exposed: _PhaseTimes = field(default_factory=_PhaseTimes)
    net_hidden: _PhaseTimes = field(default_factory=_PhaseTimes)
    #: HBM-access component of each rooflined phase (mem_t before the
    #: max(comp, mem) combiner). ``compute - mem_bound`` per phase is
    #: the MXU-bound slack an async HBM stream (e.g. a fused optimizer
    #: update under a single jit) can hide inside.
    mem_bound: _PhaseTimes = field(default_factory=_PhaseTimes)
    recompute_time: float = 0.0  # extra fwd replay before bwd_act

    def __add__(self, other):
        if other == 0:
            return self
        return CostInfo(
            compute=self.compute + other.compute,
            net_exposed=self.net_exposed + other.net_exposed,
            net_hidden=self.net_hidden + other.net_hidden,
            mem_bound=self.mem_bound + other.mem_bound,
            recompute_time=self.recompute_time + other.recompute_time,
        )

    __radd__ = __add__

    def phase_time(self, phase: str) -> float:
        return self.compute.get(phase) + self.net_exposed.get(phase)

    @property
    def fwd_time(self) -> float:
        return self.phase_time("fwd")

    @property
    def bwd_time(self) -> float:
        return (
            self.phase_time("bwd_act") + self.phase_time("bwd_w") + self.recompute_time
        )

    @property
    def total_time(self) -> float:
        return self.fwd_time + self.bwd_time

    @property
    def total_net_exposed(self) -> float:
        return self.net_exposed.total


@dataclass
class OpSpan:
    """One cost decision of the analytical estimate: a leaf op in one
    backprop phase, with full provenance — enough to audit the predicted
    time against a real run (the cost-attribution ledger's compute-side
    record, see ``observe/ledger.py`` and ``docs/observability.md``).

    Times are per-microbatch, per-device seconds, exactly the numbers
    ``PerfLLM`` summed into the headline estimate."""

    path: str  # module path, e.g. stage0_chunk0.layer0.attention.qkv_proj
    module_type: str  # leaf class name (LinearCol, CoreAttention, ...)
    category: str  # op family tag (gemm | attention | norm | ...)
    stage: int
    chunk: int
    phase: str  # fwd | bwd_act | bwd_w
    op_key: str  # efficiency table consulted (matmul, sdp_fwd, default...)
    shape_key: Optional[str]  # canonical shape key, None for flat ops
    flops: float
    bytes_accessed: float
    comp_time: float  # FLOPs / (peak * efficiency)
    mem_time: float  # bytes / (bw * efficiency) + latency
    time: float  # rooflined max(comp, mem) — what the estimate charged
    efficiency: float  # the factor actually used
    calibrated: bool  # True = per-shape calibrated hit, False = table miss
    regime: str  # compute | memory — which roofline side bound the op
    recompute: bool  # leaf belongs to a checkpointed segment

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class CollectiveSpan:
    """One collective issued by a leaf, with its cost decomposed into
    bandwidth and latency terms and exposed-vs-overlapped accounting
    (the ledger's comm-side record)."""

    path: str
    stage: int
    chunk: int
    phase: str
    op: str  # all_gather | reduce_scatter | all_reduce | all2all | p2p
    dim: str  # parallel dim (tp/cp/dp_cp/ep/etp/edp/pp)
    size_bytes: float  # full logical tensor (net-op contract)
    time: float  # total collective time
    exposed_time: float  # serialized portion on the critical path
    hidden_time: float  # overlapped portion
    bw_time: float  # bandwidth-proportional term
    lat_time: float  # hop/launch latency term
    on_dcn: bool  # path crosses the data-center network

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class MemSpan:
    """One live allocation at a stage's predicted HBM peak — the memory
    ledger's per-tensor record (``observe/memledger.py``,
    ``docs/observability.md``). The spans of one stage sum to that
    stage's ``analysis_mem`` ``peak_bytes`` within 1e-6 relative.

    ``bytes`` is the total contribution at the peak (``count`` instances
    folded in — e.g. one activation cache held for each of ``count``
    outstanding microbatches). ``bytes`` may be slightly negative for
    the ``saved_input_reuse`` adjustment of a recompute-segment replay
    (the saved segment input is reused, not re-allocated)."""

    path: str  # module path, e.g. stage0_chunk0.layer0.attention.qkv_proj
    module_type: str  # leaf class name (LinearCol, CoreAttention, ...)
    category: str  # op family tag (gemm | attention | moe_dispatch | ...)
    stage: int
    chunk: int
    bucket: str  # peak-waterfall bucket (params | grads | ... see memledger)
    kind: str  # weight | grad | opt_state | act_cache | recompute_cache |
    #          fwd_temp | bwd_temp | grad_flight | saved_input_reuse
    bytes: float  # total bytes live at the peak (count instances)
    count: int  # instances folded into ``bytes`` (outstanding microbatches)
    shape: Optional[str]  # best-effort tensor shape, None when unknown
    dtype: str
    sharding: str  # provenance: which dims shard/replicate this tensor

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class CritSegment:
    """One merged run of the simulated critical path (consecutive path
    events on the same rank landing in the same blame bucket) — the
    critical-path engine's record (``observe/critpath.py``,
    ``docs/observability.md``). ``work`` is the time beyond the binding
    dependency; the segments of one path sum to the DES makespan within
    1e-6 relative."""

    rank: int  # global rank (class-expanded under symmetry reduction)
    stage: int  # pipeline stage of that rank
    bucket: str  # simulated-waterfall blame bucket (compute | comm:tp | ...)
    name: str  # representative event name (first event of the run)
    start: float  # engine seconds (pre-straggler)
    end: float
    work: float  # seconds on the critical path beyond the binding pred
    events: int  # path events merged into this segment
    fault_extra: float  # fault-injected share of ``work``

    def to_dict(self) -> Dict[str, Any]:
        # hand-rolled (not asdict): a pod-size path has thousands of
        # segments and asdict's deepcopy dominated the whole post-pass
        return {
            "rank": self.rank, "stage": self.stage,
            "bucket": self.bucket, "name": self.name,
            "start": self.start, "end": self.end, "work": self.work,
            "events": self.events, "fault_extra": self.fault_extra,
        }


@_addable
@dataclass
class GoodputBuckets:
    """Wall-time decomposition of a multi-step goodput prediction
    (``simulator/faults.py::predict_goodput``, rendered by
    ``observe/ledger.py::goodput_waterfall_lines``). All seconds; the
    accounting is constructive, so the fields sum to the job wall time
    exactly and ``goodput = useful_train / wall_time``."""

    #: committed training steps charged at the healthy step time
    useful_train: float = 0.0
    #: extra step time injected by slowdowns / preemptions / degraded
    #: links on committed steps
    fault_stall: float = 0.0
    #: periodic checkpoint writes (HBM -> host -> storage chain)
    checkpoint_write: float = 0.0
    #: restore reads after a failure (storage -> host -> HBM chain)
    restore_read: float = 0.0
    #: failure detection + rescheduling + re-init per restart
    restart_overhead: float = 0.0
    #: wall time of work lost to a failure and re-run: steps committed
    #: since the last checkpoint plus the aborted partial step
    restart_replay: float = 0.0
    #: elastic dp-reshape cost (fleet simulation): aborted partial step
    #: plus the state-redistribution collectives and re-init overhead
    #: when survivors shrink instead of rolling back to a checkpoint
    reshape: float = 0.0

    @property
    def wall_time(self) -> float:
        return (
            self.useful_train + self.fault_stall + self.checkpoint_write
            + self.restore_read + self.restart_overhead
            + self.restart_replay + self.reshape
        )

    def to_dict(self) -> Dict[str, float]:
        return asdict(self)


@dataclass
class DiagnosticEvent:
    """One diagnostic fact: a funneled warning, a quarantined candidate,
    a calibration skip. ``context`` carries structured coordinates
    (candidate key, op/shape key, phase...).

    ``ts`` is ``time.monotonic()`` at creation — CLOCK_MONOTONIC is
    system-wide on Linux, so events merged from sweep worker processes
    on the same host order correctly. ``run_id`` is the run identity the
    owning collector was stamped with (the same identity the sweep
    journal carries), so merged cross-process diagnostics stay
    attributable to their run."""

    severity: str  # "warning" | "error"
    category: str  # e.g. "config", "placement", "calibration", "quarantine"
    message: str
    context: Dict[str, Any] = field(default_factory=dict)
    ts: float = field(default_factory=_time.monotonic)
    run_id: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "severity": self.severity,
            "category": self.category,
            "message": self.message,
            "context": _json_safe(self.context),
            "ts": self.ts,
            "run_id": self.run_id,
        }


class Diagnostics:
    """Central diagnostics collector (the report side of the resilience
    layer — see ``docs/diagnostics.md`` for the JSON schema).

    Funnels the previously ad-hoc ``warnings.warn`` calls (via
    :meth:`capture`), quarantined sweep failures, calibration skips, and
    efficiency-table hit/miss coverage into one machine-readable report
    emitted by ``perf`` / ``search`` / ``simulate`` / ``calibrate``.

    ``strict`` promotes any warning / miss / quarantined failure into a
    hard failure: :meth:`violations` lists what strict mode objects to,
    and the CLI turns a non-empty list into exit code 3."""

    SCHEMA = "simumax-diagnostics-v1"

    #: innermost :meth:`activate` collector — lets deep layers (each
    #: sweep candidate builds its own PerfLLM) report into the run-level
    #: collector without threading it through every call signature
    _active: List["Diagnostics"] = []

    def __init__(self, strict: bool = False, run_id: str = ""):
        self.strict = strict
        #: run identity stamped onto every recorded event (see
        #: :meth:`set_run_identity`); empty until a run claims the
        #: collector (the CLI, a sweep, a worker merging upstream)
        self.run_id = run_id
        self.events: List[DiagnosticEvent] = []
        self._dedup: Dict[tuple, DiagnosticEvent] = {}
        self._eff_hits: Dict[str, set] = {}
        self._eff_misses: Dict[str, set] = {}
        #: free-form numeric counters (sweep cell accounting: total /
        #: pruned / evaluated / replayed / quarantined cells, worker
        #: count, pool restarts, ...) — reported, never a violation;
        #: writes mirror into the ``diag_counter`` registry gauge so
        #: a running sweep is observable from ``GET /metrics``
        self.counters: Dict[str, float] = {}

    @classmethod
    def active(cls) -> Optional["Diagnostics"]:
        return cls._active[-1] if cls._active else None

    @contextlib.contextmanager
    def activate(self):
        """Make this the collector that ``Diagnostics.active()`` (and so
        every ``PerfBase`` built inside the block) reports into."""
        Diagnostics._active.append(self)
        try:
            yield self
        finally:
            Diagnostics._active.pop()

    @staticmethod
    def identity_hash(identity: Any) -> str:
        """Stable short hash of a run-identity payload (e.g. the sweep
        journal's header dict): the same identity always maps to the
        same ``run_id``, so a resumed sweep's events merge with the
        original run's under one identity."""
        blob = json.dumps(_json_safe(identity), sort_keys=True,
                          default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def adopt_run_id(self, run_id: str) -> str:
        """Take over an externally chosen run_id (e.g. the process
        reporter's, for commands that never compute a content
        identity), backfilling events recorded before it was known."""
        self.run_id = run_id
        for e in self.events:
            if not e.run_id:
                e.run_id = run_id
        return run_id

    def set_run_identity(self, identity: Any) -> str:
        """Stamp this collector with the hash of ``identity``. Events
        recorded before the identity was known (config capture happens
        before a sweep computes its identity) are backfilled, and the
        process-wide reporter joins the same identity so ``--log-json``
        lines, the diagnostics report, and the attribution ledger of
        one run all cross-reference by run_id. Returns the run_id."""
        self.adopt_run_id(self.identity_hash(identity))
        from simumax_tpu_torch.observe.report import get_reporter

        get_reporter().configure(run_id=self.run_id)
        return self.run_id

    # -- recording ---------------------------------------------------------
    def _record(self, event: DiagnosticEvent, n: int = 1):
        # a sweep repeats the same warning for thousands of candidates:
        # collapse identical facts into one event with a `count`, but
        # never collapse across distinct coordinates (candidate / table
        # key). ``n > 1`` merges an already-collapsed fact (a worker's
        # deduped event) without losing its count.
        if not event.run_id:
            event.run_id = self.run_id
        ctx = event.context
        key = (event.severity, event.category, event.message,
               ctx.get("candidate"), ctx.get("op_key"), ctx.get("shape_key"))
        prior = self._dedup.get(key)
        if prior is not None:
            prior.context["count"] = prior.context.get("count", 1) + n
            return
        if n > 1:
            event.context["count"] = n
        self._dedup[key] = event
        self.events.append(event)

    def warn(self, category: str, message: str, **context: Any):
        self._record(
            DiagnosticEvent("warning", category, message, dict(context))
        )

    def error(self, category: str, message: str, **context: Any):
        self._record(
            DiagnosticEvent("error", category, message, dict(context))
        )

    def record_exception(self, exc: BaseException, category: str = "error",
                         **context: Any):
        """Record a caught exception; ``SimuMaxError`` context is merged."""
        ctx = dict(context)
        if isinstance(exc, SimuMaxError):
            ctx.update(exc.context)
        ctx["exception"] = type(exc).__name__
        self.error(category, str(exc) or type(exc).__name__, **ctx)

    def count(self, name: str, n: float = 1):
        """Bump a numeric counter (sweep cell accounting etc.)."""
        self.counters[name] = self.counters.get(name, 0) + n

    def merge_coverage(self, hits: Dict[str, set], misses: Dict[str, set]):
        """Union raw efficiency-coverage sets into this collector —
        the merge-back path for coverage measured inside sweep worker
        processes (the in-process path is :meth:`record_efficiency`)."""
        for op_key, keys in hits.items():
            self._eff_hits.setdefault(op_key, set()).update(keys)
        for op_key, keys in misses.items():
            self._eff_misses.setdefault(op_key, set()).update(keys)

    def merge_events(self, events: List[Dict[str, Any]]):
        """Re-record serialized :class:`DiagnosticEvent` dicts (from
        ``to_dict``) shipped back by a sweep worker process, preserving
        the same dedup-by-coordinates collapsing as local recording —
        including each event's accumulated ``count`` (a worker may have
        already collapsed thousands of occurrences into one event)."""
        for ev in events:
            ctx = dict(ev.get("context") or {})
            n = ctx.pop("count", 1) or 1
            # keep the worker's own timestamp (CLOCK_MONOTONIC is
            # system-wide: cross-process events stay orderable) and its
            # run identity when it stamped one; otherwise the merged
            # event inherits this collector's identity via _record
            self._record(DiagnosticEvent(
                ev.get("severity", "warning"),
                ev.get("category", ""),
                ev.get("message", ""),
                ctx,
                ts=ev.get("ts") or _time.monotonic(),
                run_id=ev.get("run_id", ""),
            ), n=int(n))

    def record_efficiency(self, system):
        """Merge efficiency-table coverage from a ``SystemConfig`` after
        an estimate (``hit_efficiency`` / ``miss_efficiency``). Merging
        (not snapshotting) matters for sweeps: ``run_estimate`` resets
        the per-candidate status, so the report must union coverage
        across every candidate it saw."""
        for op_key, hits in system.hit_efficiency.items():
            self._eff_hits.setdefault(op_key, set()).update(hits)
        for op_key, misses in system.miss_efficiency.items():
            self._eff_misses.setdefault(op_key, set()).update(misses)

    @property
    def efficiency(self) -> Dict[str, Dict[str, Any]]:
        """Per-op coverage: shape keys hit vs missed across the run."""
        per_op: Dict[str, Dict[str, Any]] = {}
        for op_key, hits in self._eff_hits.items():
            per_op.setdefault(op_key, {"hits": 0, "misses": 0})["hits"] = (
                len(hits)
            )
        for op_key, misses in self._eff_misses.items():
            entry = per_op.setdefault(op_key, {"hits": 0, "misses": 0})
            entry["misses"] = len(misses)
            entry["miss_keys"] = sorted(misses)
        return per_op

    @contextlib.contextmanager
    def capture(self, category: str = "warning"):
        """Funnel ``warnings.warn`` calls raised inside the block into
        this collector (they land in the report instead of stderr).

        Exceptions are NOT recorded here: an error escaping this block
        may still be handled upstream (a sweep rejecting an infeasible
        candidate is not a run failure). Recording belongs to whoever
        decides the error's fate — the sweep's quarantine handler, or
        the CLI boundary for genuinely fatal ones."""
        with _warnings.catch_warnings(record=True) as buf:
            _warnings.simplefilter("always")
            try:
                yield self
            finally:
                for w in buf:
                    self.warn(category, str(w.message),
                              warning_class=w.category.__name__)

    # -- reporting ---------------------------------------------------------
    @property
    def warnings(self) -> List[DiagnosticEvent]:
        return [e for e in self.events if e.severity == "warning"]

    @property
    def errors(self) -> List[DiagnosticEvent]:
        return [e for e in self.events if e.severity == "error"]

    @property
    def quarantined(self) -> List[DiagnosticEvent]:
        return [e for e in self.events if e.category == "quarantine"]

    @property
    def miss_count(self) -> int:
        return sum(e.get("misses", 0) for e in self.efficiency.values())

    @property
    def hit_count(self) -> int:
        return sum(e.get("hits", 0) for e in self.efficiency.values())

    def to_dict(self) -> Dict[str, Any]:
        hits, misses = self.hit_count, self.miss_count
        total = hits + misses
        return {
            "schema": self.SCHEMA,
            "strict": self.strict,
            "run_id": self.run_id,
            "counts": {
                "warnings": len(self.warnings),
                "errors": len(self.errors),
                "quarantined": len(self.quarantined),
            },
            "counters": dict(self.counters),
            "efficiency": {
                "hits": hits,
                "misses": misses,
                "coverage": (hits / total) if total else 1.0,
                "per_op": self.efficiency,
            },
            "warnings": [e.to_dict() for e in self.warnings],
            "errors": [e.to_dict() for e in self.errors],
        }

    def write(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    def summary_line(self) -> str:
        return (
            f"warnings={len(self.warnings)} errors={len(self.errors)} "
            f"quarantined={len(self.quarantined)} "
            f"eff_hits={self.hit_count} eff_misses={self.miss_count}"
        )

    def violations(self) -> List[str]:
        """What strict mode would object to."""
        out = []
        if self.errors:
            out.append(f"{len(self.errors)} error(s)")
        if self.warnings:
            out.append(f"{len(self.warnings)} warning(s)")
        if self.miss_count:
            out.append(f"{self.miss_count} efficiency-table miss(es)")
        return out


@dataclass
class PathDebugContext:
    """Per-path cost probe carrier (reference ``model_struct.py:199``)."""

    enabled: bool = False
    rows: List[Dict] = field(default_factory=list)

    def record(self, path: str, cost: "CostInfo", compute: "ComputeInfo"):
        if not self.enabled:
            return
        self.rows.append(
            {
                "path": path,
                "fwd_ms": cost.fwd_time * 1e3,
                "bwd_ms": cost.bwd_time * 1e3,
                "net_ms": cost.total_net_exposed * 1e3,
                "fwd_gflops": compute.fwd_flops / 1e9,
            }
        )

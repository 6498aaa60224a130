"""Unified telemetry (L12): one process-wide measurement plane.

SimuMax predicts distributed training *before* you run it; this module
makes the predictor itself measurable. Two halves, both dependency-free
(stdlib only) and both strictly observe-only — telemetry-on and
telemetry-off runs produce bit-identical payloads:

**Metrics.** A :class:`MetricsRegistry` of labelled counters, gauges,
and histograms. Every previously ad-hoc counting surface — the HTTP
server's request/latency accounting, ``ContentStore.counters``,
``Planner`` single-flight/hit counters, ``Diagnostics.counters``, the
DES progress heartbeat — mirrors into the registry, which renders as
either a JSON snapshot (:meth:`MetricsRegistry.snapshot`) or Prometheus
text exposition (:func:`render_prometheus`, served by ``GET /metrics``).
Histograms keep exact count/sum/min/max plus a **bounded quantile
reservoir** (deterministic stride decimation, never a full-stream
sort), so snapshotting is O(reservoir) regardless of traffic.

Metric names are a closed catalogue: :data:`METRICS` declares every
legal name with its type and help text, the registry rejects unknown
names at runtime, and the port's tests hold every literal
``counter/gauge/histogram(...)`` name in the package to it. Dynamic
dimensions travel in labels, never in names.

**Traces.** A :class:`Tracer` of nested :class:`SpanRecord`s with
contextvar-propagated ``trace_id``/``span_id``: the HTTP server opens
one trace per request (echoed in ``X-SimuMax-Trace``), the planner,
store, sweep, and DES layers annotate their phases with
:meth:`Tracer.span`, ``Reporter --log-json`` lines carry the active
ids, and finished traces export as Chrome-trace events
(:func:`chrome_trace`) so a planner request's internals render in the
same viewer as the pipeline traces. Id propagation is always on (the
header must correlate even when nothing records); span *records* are
kept only while :attr:`Tracer.enabled` (``--trace-requests``), in a
bounded per-trace buffer.

See the JAX package's ``docs/observability.md`` ("Unified telemetry")
for the span model.

Copy of the JAX package's ``observe/telemetry.py`` with its import
paths changed and its own closed catalogue: :data:`METRICS` holds the
metrics this package emits (the ``Diagnostics`` counter mirror, the
simulator's ``des_*`` heartbeat, the tracer's drop counter, the fault
replay's ``faults_*`` and ``replay_*`` counters, the content store's
``store_*`` counters). The serving, pool, ring and fleet metrics return
with the modules that emit them.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from simumax_tpu_torch.core.errors import ConfigError

# --------------------------------------------------------------------------
# Metric catalogue
# --------------------------------------------------------------------------

#: the closed catalogue of legal metric names: name -> {type, help}.
#: Every ``registry.counter/gauge/histogram(...)`` call site must use a
#: literal name declared (and documented) here — enforced at runtime by
#: the registry. Dynamic
#: dimensions (endpoint, op, counter name) are labels, not names.
METRICS: Dict[str, Dict[str, str]] = {
    "diag_counter": {
        "type": "gauge",
        "help": "Latest value of a free-form Diagnostics counter "
                "(sweep cell accounting etc.), by counter name.",
    },
    "des_events_served": {
        "type": "gauge",
        "help": "Trace events emitted so far by the running "
                "discrete-event simulation (progress heartbeat).",
    },
    "des_blocked_ranks": {
        "type": "gauge",
        "help": "Ranks currently blocked on a rendezvous in the "
                "running discrete-event simulation.",
    },
    "des_clock_seconds": {
        "type": "gauge",
        "help": "Virtual clock of the running discrete-event "
                "simulation, in simulated seconds.",
    },
    "trace_spans_dropped_total": {
        "type": "counter",
        "help": "Span records dropped because a trace exceeded the "
                "tracer's per-trace buffer bound.",
    },
    "faults_scenarios_total": {
        "type": "counter",
        "help": "Fault scenarios walked by predict_goodput (one per "
                "goodput prediction).",
    },
    "faults_step_cache_hits_total": {
        "type": "counter",
        "help": "Perturbed-step simulations answered from the replay "
                "step cache, by kind (exact/canonical signature).",
    },
    "faults_slack_shortcircuits_total": {
        "type": "counter",
        "help": "Perturbed steps proven makespan-neutral by the "
                "critical-path slack gate and answered without a "
                "replay.",
    },
    "faults_prefix_forks_total": {
        "type": "counter",
        "help": "Perturbed-step replays resumed from a forked "
                "healthy-prefix engine snapshot instead of replaying "
                "the step from t=0.",
    },
    "replay_batched_total": {
        "type": "counter",
        "help": "Perturbed-step cache misses replayed through the "
                "batched scenario replay (the CUDA kernel, or its "
                "plain version on the CPU), by backend.",
    },
    "replay_batch_fallbacks_total": {
        "type": "counter",
        "help": "Batch-round cache misses that fell back to the "
                "scalar engine, by counted reason (deaths/sendrecv/"
                "unknown_kind/no_streams/lowering_error/"
                "small_batch/backend_numpy).",
    },
    "store_ops_total": {
        "type": "counter",
        "help": "Content-addressed store operations, by op "
                "(hits/misses/puts/evictions/corrupt_dropped).",
    },
    "store_quarantined_total": {
        "type": "counter",
        "help": "Corrupt/torn store entries moved into .quarantine/ "
                "(read-path drops, verify --drop, and the start-time "
                "recovery sweep all route here).",
    },
}

#: default bounded-reservoir size for histograms: big enough for stable
#: p50/p99, small enough that a snapshot sort is microseconds
DEFAULT_RESERVOIR = 512


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# --------------------------------------------------------------------------
# Instruments
# --------------------------------------------------------------------------


class Counter:
    """Monotonic labelled counter."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Labelled gauge: set to the latest value (or inc/dec)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Labelled histogram with exact count/sum/min/max and a bounded
    quantile reservoir.

    The reservoir is filled by **deterministic stride decimation**:
    every observation is kept until the buffer reaches its bound, then
    the buffer is halved (every second sample dropped) and the keep
    stride doubles. The retained sample is a uniform systematic
    subsample of the arrival sequence — deterministic in the
    observation order, never random — and quantiles are nearest-rank
    over the sorted reservoir, so :meth:`quantile` (and any snapshot)
    is O(reservoir), independent of how many observations were made.
    """

    __slots__ = ("name", "labels", "_lock", "_count", "_sum", "_min",
                 "_max", "_reservoir", "_bound", "_stride", "_seen")

    def __init__(self, name: str, labels: Dict[str, str],
                 reservoir: int = DEFAULT_RESERVOIR):
        if reservoir < 2:
            raise ConfigError(
                f"histogram reservoir must be >= 2, got {reservoir}",
                metric=name,
            )
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._reservoir: List[float] = []
        self._bound = int(reservoir)
        self._stride = 1
        self._seen = 0  # observations since the last kept sample

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            # systematic subsample: keep every stride-th observation
            if self._seen % self._stride == 0:
                self._reservoir.append(v)
                if len(self._reservoir) >= self._bound:
                    # decimate: halve the buffer, double the stride
                    self._reservoir = self._reservoir[::2]
                    self._stride *= 2
            self._seen += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _snapshot_values(self) -> Tuple[int, float, Optional[float],
                                        Optional[float], List[float]]:
        with self._lock:
            return (self._count, self._sum, self._min, self._max,
                    sorted(self._reservoir))

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the bounded reservoir (0.0 when
        nothing was observed) — same rank convention as the server's
        ``percentile`` helper, applied to the subsample."""
        _, _, _, _, vals = self._snapshot_values()
        if not vals:
            return 0.0
        i = min(len(vals) - 1,
                max(0, int(round(q * (len(vals) - 1)))))
        return vals[i]

    def to_dict(self) -> Dict[str, Any]:
        count, total, vmin, vmax, vals = self._snapshot_values()

        def rank(q: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1,
                            max(0, int(round(q * (len(vals) - 1)))))]

        return {
            "count": count,
            "sum": total,
            "min": vmin if vmin is not None else 0.0,
            "max": vmax if vmax is not None else 0.0,
            "reservoir_size": len(vals),
            "p50": rank(0.50),
            "p90": rank(0.90),
            "p99": rank(0.99),
        }


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


class MetricsRegistry:
    """Thread-safe get-or-create registry of labelled instruments.

    Instruments are keyed by ``(name, sorted labels)``; the same call
    from two threads returns the same object. Names must be declared in
    :data:`METRICS` with the matching type — unknown names raise
    :class:`ConfigError`.
    Tests that need isolation construct their own registry; library
    code defaults to the process-wide one (:func:`get_registry`).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], Any] = {}

    def _get(self, name: str, kind: str, labels: Dict[str, str],
             factory):
        spec = METRICS.get(name)
        if spec is None:
            raise ConfigError(
                f"unknown metric name {name!r}: declare it in "
                f"telemetry.METRICS before use",
                metric=name,
            )
        if spec["type"] != kind:
            raise ConfigError(
                f"metric {name!r} is declared as a {spec['type']}, "
                f"not a {kind}",
                metric=name,
            )
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = factory()
                self._metrics[key] = inst
            return inst

    def counter(self, name: str, /, **labels: str) -> Counter:
        return self._get(name, "counter", labels,
                         lambda: Counter(name, labels))

    def gauge(self, name: str, /, **labels: str) -> Gauge:
        return self._get(name, "gauge", labels,
                         lambda: Gauge(name, labels))

    def histogram(self, name: str, /, *,
                  reservoir: int = DEFAULT_RESERVOIR,
                  **labels: str) -> Histogram:
        return self._get(name, "histogram", labels,
                         lambda: Histogram(name, labels, reservoir))

    def instruments(self) -> List[Any]:
        """All registered instruments, sorted by (name, labels) for
        deterministic rendering."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe snapshot of every instrument: ``{name: [{labels,
        value | histogram fields}, ...]}``."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        for inst in self.instruments():
            entry: Dict[str, Any] = {"labels": dict(inst.labels)}
            if isinstance(inst, Histogram):
                entry.update(inst.to_dict())
            else:
                entry["value"] = inst.value
            out.setdefault(inst.name, []).append(entry)
        return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (``/metrics`` of a default
    ``serve`` renders this one)."""
    return _REGISTRY


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

#: content type of the text exposition format (version 0.0.4)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels_text(labels: Dict[str, str],
                 extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render a registry in the Prometheus text exposition format
    (v0.0.4): ``# HELP`` / ``# TYPE`` per family, one sample line per
    labelled instrument; histograms render as summaries (quantile
    samples from the bounded reservoir plus ``_sum`` / ``_count``)."""
    registry = registry or get_registry()
    by_name: Dict[str, List[Any]] = {}
    for inst in registry.instruments():
        by_name.setdefault(inst.name, []).append(inst)
    lines: List[str] = []
    for name in sorted(by_name):
        spec = METRICS[name]
        ptype = "summary" if spec["type"] == "histogram" else spec["type"]
        lines.append(f"# HELP {name} {spec['help']}")
        lines.append(f"# TYPE {name} {ptype}")
        for inst in by_name[name]:
            if isinstance(inst, Histogram):
                d = inst.to_dict()
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    lines.append(
                        f"{name}"
                        f"{_labels_text(inst.labels, {'quantile': q})} "
                        f"{_fmt(d[key])}"
                    )
                lines.append(
                    f"{name}_sum{_labels_text(inst.labels)} "
                    f"{_fmt(d['sum'])}"
                )
                lines.append(
                    f"{name}_count{_labels_text(inst.labels)} "
                    f"{_fmt(d['count'])}"
                )
            else:
                lines.append(
                    f"{name}{_labels_text(inst.labels)} "
                    f"{_fmt(inst.value)}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------

#: (trace_id, span_id) of the active span — contextvars give correct
#: propagation per thread (each HTTP request thread gets its own copy)
_CTX: contextvars.ContextVar[Optional[Tuple[str, str]]] = \
    contextvars.ContextVar("simumax_trace", default=None)


class SpanRecord:
    """One finished span: ids, name, wall bounds (perf_counter
    seconds), and free-form attributes."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "attrs", "thread")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, start: float,
                 end: float, attrs: Dict[str, Any], thread: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end = end
        self.attrs = attrs
        self.thread = thread

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": self.start,
            "duration_s": self.duration,
            "thread": self.thread,
            "attrs": self.attrs,
        }


#: per-thread PRNG for id generation: ids must be cheap (they are
#: minted on every served request) and unique, not cryptographic —
#: uuid4 costs ~25us/call on entropy-starved hosts, getrandbits ~0.5us.
#: Seeded per thread from urandom once; thread-local so no lock and no
#: cross-thread sequence coupling
_ID_RNG = threading.local()


def _rng() -> "random.Random":
    rng = getattr(_ID_RNG, "rng", None)
    if rng is None:
        rng = _ID_RNG.rng = random.Random(
            int.from_bytes(os.urandom(8), "big")
            ^ threading.get_ident()
        )
    return rng


def new_trace_id() -> str:
    return f"{_rng().getrandbits(64):016x}"


def new_span_id() -> str:
    # 64-bit like trace ids: span_tree() keys nodes by span_id alone,
    # and a maximal 4096-span trace has a ~0.2% birthday collision at
    # 32 bits — enough to silently corrupt 1 in ~500 large artifacts
    return f"{_rng().getrandbits(64):016x}"


class Tracer:
    """Contextvar-propagated span tracer with bounded retention.

    Id propagation is unconditional once a trace is opened (the HTTP
    server needs ``X-SimuMax-Trace`` and Reporter correlation whether
    or not anyone is recording); :class:`SpanRecord` retention is
    gated on :attr:`enabled` and bounded per trace
    (``max_spans_per_trace``) and across traces (``max_traces``,
    oldest-finished-first eviction)."""

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.enabled = False
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        #: finished spans per trace id, in completion order
        self._spans: Dict[str, List[SpanRecord]] = {}
        #: trace ids in creation order (for bounded eviction)
        self._order: List[str] = []
        self._registry = registry

    def configure(self, enabled: Optional[bool] = None,
                  registry: Optional[MetricsRegistry] = None) -> "Tracer":
        if enabled is not None:
            self.enabled = bool(enabled)
        if registry is not None:
            self._registry = registry
        return self

    # -- context -----------------------------------------------------------
    @staticmethod
    def current_ids() -> Optional[Tuple[str, str]]:
        """(trace_id, span_id) of the active span, or None."""
        return _CTX.get()

    @staticmethod
    def current_trace_id() -> Optional[str]:
        ids = _CTX.get()
        return ids[0] if ids else None

    @contextlib.contextmanager
    def trace(self, name: str, trace_id: Optional[str] = None,
              **attrs: Any) -> Iterator[str]:
        """Open a root span (a new trace); yields the trace id. Always
        propagates ids; records spans only while :attr:`enabled`."""
        tid = trace_id or new_trace_id()
        sid = new_span_id()
        token = _CTX.set((tid, sid))
        start = time.perf_counter()
        try:
            yield tid
        finally:
            end = time.perf_counter()
            _CTX.reset(token)
            if self.enabled:
                self._record(SpanRecord(
                    tid, sid, None, name, start, end, dict(attrs),
                    threading.current_thread().name,
                ))

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Optional[str]]:
        """Open a child span under the active trace. A no-op (yields
        None) when no trace is active — library code can annotate
        unconditionally without paying for id generation outside a
        traced request."""
        ids = _CTX.get()
        if ids is None:
            yield None
            return
        tid, parent = ids
        sid = new_span_id()
        token = _CTX.set((tid, sid))
        start = time.perf_counter()
        try:
            yield sid
        finally:
            end = time.perf_counter()
            _CTX.reset(token)
            if self.enabled:
                self._record(SpanRecord(
                    tid, sid, parent, name, start, end, dict(attrs),
                    threading.current_thread().name,
                ))

    # -- retention ---------------------------------------------------------
    def _record(self, rec: SpanRecord):
        with self._lock:
            spans = self._spans.get(rec.trace_id)
            if spans is None:
                spans = self._spans[rec.trace_id] = []
                self._order.append(rec.trace_id)
                while len(self._order) > self.max_traces:
                    evicted = self._order.pop(0)
                    self._spans.pop(evicted, None)
            if len(spans) >= self.max_spans_per_trace:
                if self._registry is not None:
                    self._registry.counter(
                        "trace_spans_dropped_total").inc()
                return
            spans.append(rec)

    def pop_trace(self, trace_id: str) -> List[SpanRecord]:
        """Remove and return one trace's finished spans (completion
        order) — the per-request artifact path."""
        with self._lock:
            spans = self._spans.pop(trace_id, [])
            if trace_id in self._order:
                self._order.remove(trace_id)
            return spans

    def drain(self) -> List[SpanRecord]:
        """Remove and return every finished span (trace creation
        order) — the end-of-command artifact path."""
        with self._lock:
            out: List[SpanRecord] = []
            for tid in self._order:
                out.extend(self._spans.get(tid, []))
            self._spans.clear()
            self._order.clear()
            return out


_TRACER = Tracer(registry=_REGISTRY)


def get_tracer() -> Tracer:
    return _TRACER


def current_ids() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, or None — the Reporter's
    correlation hook."""
    return _CTX.get()


# --------------------------------------------------------------------------
# Span export
# --------------------------------------------------------------------------


def span_tree(spans: List[SpanRecord]) -> List[Dict[str, Any]]:
    """Nest finished spans into parent->children trees (one root per
    trace), each node a ``to_dict`` record plus ``children``."""
    nodes: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        d = s.to_dict()
        d["children"] = []
        nodes[s.span_id] = d
    roots: List[Dict[str, Any]] = []
    for s in spans:
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id) if s.parent_id else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: n["start_s"])
    roots.sort(key=lambda n: n["start_s"])
    return roots


def chrome_trace(spans: List[SpanRecord]) -> Dict[str, Any]:
    """Lay finished spans out as Chrome-trace complete events (``ph:
    "X"``), one tid lane per thread — loadable in the same trace viewer
    (Perfetto / chrome://tracing) as the pipeline-schedule traces."""
    if spans:
        t0 = min(s.start for s in spans)
    else:
        t0 = 0.0
    threads = sorted({s.thread for s in spans})
    tid_of = {t: i for i, t in enumerate(threads)}
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "simumax_tpu_torch request tracing"}},
    ]
    for t in threads:
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0,
            "tid": tid_of[t], "args": {"name": t},
        })
    for s in sorted(spans, key=lambda s: (s.start, s.span_id)):
        args: Dict[str, Any] = {
            "trace_id": s.trace_id, "span_id": s.span_id,
        }
        if s.parent_id:
            args["parent_id"] = s.parent_id
        args.update(s.attrs)
        events.append({
            "name": s.name, "ph": "X", "pid": 0, "tid": tid_of[s.thread],
            "ts": (s.start - t0) * 1e6, "dur": s.duration * 1e6,
            "cat": "span", "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: List[SpanRecord], path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans), f)
    return path

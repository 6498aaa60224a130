"""Stdlib-only JSON-over-HTTP planning server (L9).

The JAX package's ``serve`` command runs a long-lived
``ThreadingHTTPServer`` whose query endpoints all route through one
shared :class:`~simumax_tpu_torch.service.planner.Planner` — so concurrent
requests share the persistent content-addressed store, identical
in-flight queries are single-flighted down to one evaluation, and every
response is bit-identical to a direct (cache-off) evaluation.

API (all request bodies are JSON; ``model`` / ``strategy`` / ``system``
accept registry names, config-file paths, or fully inline config
dicts):

====================  =====================================================
``GET /healthz``      liveness: ``{"status": "ok", "uptime_s": ...}``
``GET /stats``        service counters: requests / errors / latency
                      percentiles per endpoint, planner hit/miss/
                      single-flight counters, store size + eviction
                      counters
``GET /metrics``      the same counters (plus everything else the
                      process registered: DES gauges, diagnostics
                      counters) in Prometheus text exposition format
                      (``observe/telemetry.py``)
``POST /v1/estimate`` full analytical estimate (``Planner.estimate``)
``POST /v1/explain``  cost-attribution ledger + per-op rows
``POST /v1/search``   strategy sweep; ``"stream": true`` switches the
                      response to chunked NDJSON — one
                      ``{"cell": ...}`` line per settled grid cell
                      (store-served cells first, evaluated cells in
                      completion order) then a final ``{"result": ...}``
``POST /v1/faults``   seeded Monte-Carlo goodput analysis
``POST /v1/simulate`` discrete-event replay summary
``POST /v1/fleet``    multi-job fleet-trace walk (docs/fleet.md):
                      fleet goodput, per-job SLO attainment, and the
                      scheduler-decision timeline
====================  =====================================================

Every response carries ``X-SimuMax-Cache: hit|miss`` (+ the
content-addressed key in ``X-SimuMax-Key``) and an ``X-SimuMax-Trace``
request-trace id (``observe/telemetry.py`` — the same id the request's
spans and ``--log-json`` lines carry); the *body* is the canonical
payload either way. Config-family errors return 400 with
``{"error": ...}``; unexpected failures 500. Request logging goes
through the shared Reporter at debug level (``serve --log-level
debug``).

Production serving (L13, docs/service.md "Production deployment"):
``serve --workers N`` dispatches non-streaming queries to a
multi-process worker pool (``service/pool.py``: read-only store
replicas, a single parent-side writer, request coalescing, a
dependency-validated response memory cache, worker respawn + retry);
``--admission N`` sheds excess load with 429 + ``Retry-After``
(:class:`AdmissionController`, per-priority budgets via the
``X-SimuMax-Priority`` header); ``--warm N`` precomputes the neighbor
sweep cells clients statistically ask for next
(``service/warmer.py``). All three default to off — the threaded
server — and every served byte stays bit-identical across modes.

Copy of the JAX package's ``service/server.py`` with its import paths
changed and one addition: :func:`make_server` takes ``device``
(``"cuda"`` by default) for the planner it builds when none is given.
``/metrics`` refreshes the ``replay_compile_cache_*`` gauges from the
port's :func:`~simumax_tpu_torch.simulator.batched_replay.compile_cache_info`,
which counts the replay's level schedules. The ``docs/`` and the
``serve`` options this module names are the JAX package's.
"""

from __future__ import annotations

import json
import math
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.observe.telemetry import (
    Histogram,
    MetricsRegistry,
    PROMETHEUS_CONTENT_TYPE,
    get_registry,
    get_tracer,
    render_prometheus,
    span_tree,
)
from simumax_tpu_torch.service.planner import Planner

#: admission-control load budget per priority class, as a fraction of
#: ``--admission N``: low traffic is shed first (half the budget),
#: high-priority clients ride out 1.5x the nominal backlog before a
#: 429 — so under overload the classes degrade in order instead of
#: collapsing together
PRIORITY_HEADROOM = {"high": 1.5, "normal": 1.0, "low": 0.5}


def response_bytes(payload: Any) -> bytes:
    """The one serialization every JSON response body goes through —
    shared with the bench/tests so bit-identity checks compare the
    exact wire bytes."""
    return json.dumps(
        payload, sort_keys=True, separators=(",", ":"), default=str,
    ).encode("utf-8")


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over pre-sorted values — the one
    implementation behind both /stats and the service bench, so the
    benched p50/p99 stay comparable with the served ones."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


class _ServiceStats:
    """Thread-safe request/latency accounting behind ``/stats``,
    registry-backed (``observe/telemetry.py``).

    Per-endpoint latency lives in bounded-reservoir histograms, so a
    ``/stats`` (or ``/metrics``) snapshot sorts O(reservoir) samples —
    never the full request stream, and never inside the lock
    :meth:`record` takes. Request/error counts keep a per-instance
    dict (the ``/stats`` schema, exactly as before) and mirror into
    the shared registry for the Prometheus exposition."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self.registry = registry or get_registry()
        self.started = time.time()
        self.requests: Dict[str, int] = {}
        self.errors = 0
        #: per-instance latency histograms (one server's /stats must
        #: not see another's traffic, so these are standalone
        #: instruments, not registry lookups)
        self._lat: Dict[str, Histogram] = {}
        #: cached registry handles per endpoint — record() runs on
        #: every request, so resolve each instrument (label-key build
        #: + the process-wide registry lock) once, not per call
        self._mirror: Dict[str, tuple] = {}

    def record(self, endpoint: str, elapsed_s: float, error: bool):
        with self._lock:
            self.requests[endpoint] = self.requests.get(endpoint, 0) + 1
            if error:
                self.errors += 1
            lat = self._lat.get(endpoint)
            if lat is None:
                lat = self._lat[endpoint] = Histogram(
                    "http_request_seconds", {"endpoint": endpoint}
                )
            mirror = self._mirror.get(endpoint)
            if mirror is None:
                mirror = self._mirror[endpoint] = (
                    self.registry.counter(
                        "http_requests_total", endpoint=endpoint
                    ),
                    self.registry.histogram(
                        "http_request_seconds", endpoint=endpoint
                    ),
                )
        lat.observe(elapsed_s)
        # registry mirror: the scrapeable view of the same accounting
        requests_total, request_seconds = mirror
        requests_total.inc()
        if error:
            # errors are rare — resolved on demand so the counter only
            # appears in /metrics once an error actually happened
            self.registry.counter(
                "http_errors_total", endpoint=endpoint
            ).inc()
        request_seconds.observe(elapsed_s)

    def snapshot(self) -> dict:
        with self._lock:
            requests = dict(self.requests)
            errors = self.errors
            lat = dict(self._lat)
        uptime = time.time() - self.started
        total = sum(requests.values())
        latency = {}
        for k, h in lat.items():
            d = h.to_dict()  # one locked reservoir sort per endpoint
            latency[k] = {
                "count": d["count"],
                "p50_ms": round(d["p50"] * 1e3, 3),
                "p99_ms": round(d["p99"] * 1e3, 3),
            }
        return {
            "uptime_s": round(uptime, 3),
            "requests": requests,
            "requests_total": total,
            "qps": round(total / uptime, 3) if uptime > 0 else 0.0,
            "errors": errors,
            "latency": latency,
        }


class AdmissionController:
    """Bounded-load admission control (``serve --admission N``).

    Every ``/v1/*`` request passes :meth:`try_admit` before any work
    happens: when the current load (the pool's queued + in-flight
    backlog, or this controller's own in-flight count in threaded
    mode) has reached the request's per-priority budget
    (``N x PRIORITY_HEADROOM[priority]``), the request is shed with a
    429 and a ``Retry-After`` estimate instead of queuing unboundedly
    — p99 of *admitted* requests stays bounded under overload. An
    admitted request is never dropped: admission happens exactly once,
    before dispatch, and everything admitted runs to an answer."""

    def __init__(self, max_backlog: int, pool=None, registry=None):
        self.max_backlog = int(max_backlog)
        self.pool = pool
        self.registry = registry or get_registry()
        self._lock = threading.Lock()
        self._inflight = 0
        self.counters: Dict[str, int] = {
            "admitted": 0, "rejected": 0,
        }

    def load(self) -> int:
        if self.pool is not None:
            return self.pool.backlog()
        with self._lock:
            return self._inflight

    def retry_after_s(self) -> int:
        """Whole seconds a shed client should wait — the pool's
        EWMA-based wait estimate, or a queue-depth guess in threaded
        mode. Always >= 1 (a 0 invites an immediate retry storm)."""
        if self.pool is not None:
            wait = self.pool.estimated_wait_s()
        else:
            wait = 0.05 * self.load()
        return max(1, int(math.ceil(wait)))

    def try_admit(self, priority: str) -> bool:
        limit = self.max_backlog * PRIORITY_HEADROOM.get(priority, 1.0)
        # check-and-increment under ONE lock hold: a burst racing at
        # the limit must not all read the same pre-increment load and
        # overshoot the backlog bound (pooled load is the pool's own
        # backlog — serialized here, though submission lag keeps it
        # an estimate)
        with self._lock:
            load = (self.pool.backlog() if self.pool is not None
                    else self._inflight)
            if load >= limit:
                self.counters["rejected"] += 1
                key = f"rejected_{priority}"
                self.counters[key] = self.counters.get(key, 0) + 1
                admitted = False
            else:
                self.counters["admitted"] += 1
                self._inflight += 1
                admitted = True
        if not admitted:
            self.registry.counter("admission_rejected_total",
                                  priority=priority).inc()
        return admitted

    def release(self):
        with self._lock:
            self._inflight -= 1

    def stats(self) -> dict:
        load = self.load()
        with self._lock:
            return dict(self.counters, max_backlog=self.max_backlog,
                        load=load)


class PlannerHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the shared planner + stats +
    metrics registry (``GET /metrics`` renders it)."""

    daemon_threads = True
    allow_reuse_address = True
    #: small responses leave in one segment, not a Nagle-delayed two
    disable_nagle_algorithm = True

    def __init__(self, addr, planner: Planner,
                 registry: Optional[MetricsRegistry] = None,
                 trace_log: Optional[str] = None,
                 pool=None, admission: Optional[AdmissionController]
                 = None, warmer=None):
        super().__init__(addr, _Handler)
        self.planner = planner
        self.registry = registry or planner.registry
        self.stats = _ServiceStats(self.registry)
        #: ``serve --workers N``: the multi-process serving pool
        #: (service/pool.py); non-streaming ``/v1/*`` queries dispatch
        #: to its workers, streaming sweeps stay on this process's
        #: planner (which shares the pool's single-writer store)
        self.pool = pool
        #: ``serve --admission N``: load-shedding front door
        self.admission = admission
        #: ``serve --warm N``: speculative neighbor-cell warmer
        self.warmer = warmer
        #: ``serve --trace-requests DIR``: finished request span trees
        #: append to ``<DIR>/requests.jsonl`` (one JSON line each)
        self.trace_log = trace_log
        self._trace_log_lock = threading.Lock()
        #: fleet attachments (``serve --ring/--join``, service/node.py
        #: ``attach_fleet``): the node state serving ``/ring/*`` and
        #: the affinity router forwarding non-owned ``/v1/*`` requests
        #: to their ring owner. None = a standalone (pre-L19) server.
        self.fleet = None
        self.router = None

    def server_close(self):
        super().server_close()
        if self.warmer is not None:
            self.warmer.close()
        if self.pool is not None:
            self.pool.close()
        if self.fleet is not None:
            self.fleet.close()

    def write_trace(self, trace_id: str, endpoint: str):
        """Append the finished request's span tree to the trace log
        (no-op unless ``--trace-requests`` armed the tracer)."""
        if not self.trace_log:
            return
        spans = get_tracer().pop_trace(trace_id)
        if not spans:
            return
        line = json.dumps({
            "trace_id": trace_id,
            "endpoint": endpoint,
            "spans": span_tree(spans),
        }, default=str)
        with self._trace_log_lock:
            with open(self.trace_log, "a", encoding="utf-8") as f:
                f.write(line + "\n")


class _FastHeaders(dict):
    """Case-insensitive str header view built by the fast lane's lean
    parser (every handler path only ever calls ``.get``)."""

    def get(self, name, default=None):
        return super().get(name.lower(), default)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "simumax-tpu-planner/1"
    #: buffer the response writer: status line + headers + body leave
    #: in ONE sendall (handle_one_request flushes after each request;
    #: the NDJSON stream flushes per chunk below)
    wbufsize = -1

    # -- plumbing ----------------------------------------------------------
    def log_message(self, fmt, *args):  # route through the Reporter
        from simumax_tpu_torch.observe.report import get_reporter

        get_reporter().debug(
            f"[serve] {self.address_string()} {fmt % args}",
            event="serve_request",
        )

    def _body(self) -> dict:
        raw = getattr(self, "_raw_body", None)
        if raw is None:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b"{}"
            self._raw_body = raw
        data = json.loads(raw.decode("utf-8") or "{}")
        if not isinstance(data, dict):
            raise ConfigError("request body must be a JSON object")
        return data

    def _incoming_trace(self):
        """The client- (or router-) supplied ``X-SimuMax-Trace`` id,
        when plausible — honoring it joins this hop's spans to the
        caller's trace, so one routed request's span tree covers the
        whole fleet (router hop, owner node, pool worker). Bounded and
        charset-checked: the id becomes a trace-log key and a response
        header, never trusted further than that."""
        tid = self.headers.get("X-SimuMax-Trace")
        if tid and len(tid) <= 64 \
                and all(c in "0123456789abcdef" for c in tid):
            return tid
        return None

    def _send_trace_header(self):
        """Stamp the active request trace id (every response path —
        JSON, /metrics, streams — goes through this one helper)."""
        trace_id = get_tracer().current_trace_id()
        if trace_id:
            self.send_header("X-SimuMax-Trace", trace_id)

    def _send_json(self, code: int, payload: Any,
                   meta: Optional[dict] = None):
        body = payload if isinstance(payload, bytes) \
            else response_bytes(payload)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self._send_trace_header()
        if meta and meta.get("content_encoding"):
            # transport encoding of a memcache hit the client opted
            # into (Accept-Encoding: gzip) — the canonical identity
            # stays the uncompressed bytes
            self.send_header("Content-Encoding",
                             meta["content_encoding"])
        if meta:
            self.send_header("X-SimuMax-Cache", meta.get("cache", ""))
            if meta.get("key"):
                self.send_header("X-SimuMax-Key", meta["key"])
            if meta.get("served"):
                # how the bytes were produced (memory / coalesced) —
                # serving-dependent, so a header, never the body
                self.send_header("X-SimuMax-Served", meta["served"])
            if "cells_cached" in meta:
                # serving-dependent sweep accounting rides headers so
                # the body stays bit-identical warm vs cold
                cells = (f"cached={meta['cells_cached']} "
                         f"evaluated={meta['cells_evaluated']}")
                if meta.get("cells_coalesced"):
                    cells += f" coalesced={meta['cells_coalesced']}"
                self.send_header("X-SimuMax-Cells", cells)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, code: int, message: str):
        self._send_json(code, {"error": message})

    def _send_metrics(self):
        # the batched-replay compile-cache gauges mirror module state,
        # not an event stream — refresh them per scrape so they appear
        # even when no walk in this process touched the cache
        from simumax_tpu_torch.simulator.batched_replay import (
            compile_cache_info,
        )

        compile_cache_info(self.server.registry)
        body = render_prometheus(self.server.registry).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self._send_trace_header()
        self.end_headers()
        self.wfile.write(body)

    #: the served routes — the only values the ``endpoint`` metric
    #: label may take. Anything else (crawlers, port scanners, typo'd
    #: clients) records as "other": the label is otherwise
    #: client-controlled, and the registry never evicts, so unique
    #: paths would mint unbounded instruments and /metrics series
    KNOWN_ENDPOINTS = frozenset({
        "/v1/fleet",
        "/healthz", "/stats", "/metrics",
        "/v1/estimate", "/v1/explain", "/v1/faults",
        "/v1/simulate", "/v1/search",
        # the fleet control plane (service/node.py; fleet nodes only)
        "/ring/state", "/ring/cells/claim", "/ring/cells/publish",
        "/ring/cells/abandon", "/ring/cells/wait", "/ring/entries",
        "/ring/entry", "/ring/replicate", "/ring/ping",
    })

    #: endpoints the router may hedge (duplicate to a successor on a
    #: p99-slow owner): idempotent reads whose response is a pure
    #: function of the request. ``/v1/search`` is the write path — a
    #: sweep populates the owner's shard through the flight table, and
    #: two racing writers would break the single-writer discipline —
    #: so it is NEVER hedged (pinned by the chaos tests).
    HEDGE_SAFE_ENDPOINTS = frozenset({
        "/v1/estimate", "/v1/explain", "/v1/faults",
        "/v1/simulate", "/v1/fleet",
    })

    def _metric_endpoint(self, endpoint: str) -> str:
        return endpoint if endpoint in self.KNOWN_ENDPOINTS else "other"

    # -- GET ---------------------------------------------------------------
    def do_GET(self):  # noqa: N802 (http.server API)
        t0 = time.perf_counter()
        endpoint = self.path.split("?")[0]
        err = False
        tracer = get_tracer()
        with tracer.trace(f"GET {endpoint}", endpoint=endpoint,
                          trace_id=self._incoming_trace()) as tid:
            try:
                if self.path == "/healthz":
                    self._send_json(200, {
                        "status": "ok",
                        "uptime_s": round(
                            time.time() - self.server.stats.started, 3),
                    })
                elif self.path == "/stats":
                    self._send_json(200, self._stats_snapshot())
                elif self.path == "/metrics":
                    self._send_metrics()
                elif self.path == "/ring/state" \
                        and self.server.fleet is not None:
                    self._send_json(200, self.server.fleet.state())
                else:
                    err = True
                    self._send_error_json(
                        404, f"unknown path {self.path}")
            except BrokenPipeError:
                err = True
            finally:
                self.server.stats.record(
                    self._metric_endpoint(endpoint),
                    time.perf_counter() - t0, err,
                )
        self.server.write_trace(tid, endpoint)

    def _stats_snapshot(self) -> dict:
        """The ``/stats`` body. The threaded server's schema (requests / latency /
        planner / store) is preserved exactly; pooled serving,
        admission control, and the warmer append NEW keys only, so
        existing scrapers keep working under ``--workers``."""
        srv = self.server
        snap = srv.stats.snapshot()
        if srv.pool is not None:
            pooled = srv.pool.planner_stats()
            # the parent planner still serves streaming sweeps: its
            # counters fold into the worker aggregate so /stats keeps
            # counting every evaluation this service performed
            parent = srv.planner.stats()
            merged = dict(pooled["planner"])
            for name, value in parent["planner"].items():
                merged[name] = merged.get(name, 0) + value
            pooled["planner"] = merged
            snap.update(pooled)
            snap["coalesce"] = parent.get("coalesce", {})
            snap["pool"] = srv.pool.stats()
        else:
            snap.update(srv.planner.stats())
        if srv.admission is not None:
            snap["admission"] = srv.admission.stats()
        if srv.warmer is not None:
            snap["warmer"] = srv.warmer.stats()
        return snap

    def _accepts_gzip(self) -> bool:
        return "gzip" in (self.headers.get("Accept-Encoding") or "")

    def _priority(self) -> str:
        """Per-client priority class of this request — the
        ``X-SimuMax-Priority`` header (``high`` / ``normal`` /
        ``low``), defaulting to ``normal``."""
        p = (self.headers.get("X-SimuMax-Priority") or "normal").lower()
        return p if p in PRIORITY_HEADROOM else "normal"

    def _deadline_s(self) -> Optional[float]:
        """Remaining request budget in seconds from the
        ``X-SimuMax-Deadline`` millisecond header (clients set it;
        router hops forward the decremented remainder). None = no
        budget — the per-hop ``FORWARD_TIMEOUT_S`` still bounds
        forwards."""
        raw = self.headers.get("X-SimuMax-Deadline")
        if not raw:
            return None
        try:
            ms = int(raw)
        except ValueError:
            return None
        return max(ms, 1) / 1000.0

    #: endpoints eligible for the raw-body memcache fast path: the
    #: exact request bytes of a hot repeat map straight to the cached
    #: response, skipping the JSON parse and canonicalization. Search
    #: stays off it (a parsed body is needed for the stream check and
    #: the warm offer).
    FAST_PATH_ENDPOINTS = ("/v1/estimate", "/v1/explain",
                           "/v1/faults", "/v1/simulate",
                           "/v1/fleet")

    # -- the pooled serving fast lane --------------------------------------
    # Part of the --workers serving rebuild: siege-level traffic is
    # pipelined POSTs of small JSON bodies, and the stdlib
    # readline-per-header parser + send_response machinery + a flush
    # syscall per response costs more than the whole lookup. The lane
    # parses that one shape with a lean loop and batches response
    # flushes across a pipeline burst; EVERYTHING else (GETs, odd
    # versions, huge request lines) falls back to the stdlib parser
    # mid-connection. A threaded server (pool=None) never enters it.

    def handle_one_request(self):  # noqa: A003 (stdlib override)
        if self.server.pool is None:
            return super().handle_one_request()
        try:
            self.raw_requestline = self.rfile.readline(65537)
            if len(self.raw_requestline) > 65536:
                self.requestline = ""
                self.request_version = ""
                self.command = ""
                self.send_error(414)
                return
            if not self.raw_requestline:
                self.close_connection = True
                return
            if self._fast_lane():
                return
            # unusual request: the stdlib parser takes over from the
            # already-read request line (stdlib handle_one_request
            # tail, verbatim semantics)
            if not self.parse_request():
                return
            mname = "do_" + self.command
            if not hasattr(self, mname):
                self.send_error(
                    501, f"Unsupported method ({self.command})")
                return
            getattr(self, mname)()
            self.wfile.flush()
        except (TimeoutError, socket.timeout) as exc:
            self.log_error("Request timed out: %r", exc)
            self.close_connection = True

    def _fast_lane(self) -> bool:
        """Serve one pipelined ``POST /v1/...`` leanly; returns False
        (with only the request line consumed) when this request needs
        the stdlib parser instead."""
        line = self.raw_requestline
        if not (line.startswith(b"POST /v1/")
                and line.endswith(b" HTTP/1.1\r\n")):
            return False
        try:
            requestline = line.decode("ascii").rstrip("\r\n")
        except UnicodeDecodeError:
            return False  # the stdlib parser answers the 400
        # requestline/command/request_version must be set BEFORE any
        # send_error below: its log_request reads them
        self.requestline = requestline
        self.command, path, self.request_version = \
            requestline.split(" ", 2)
        self.path = path
        headers = _FastHeaders()
        while True:
            h = self.rfile.readline(65537)
            if h in (b"\r\n", b"\n", b""):
                break
            key, sep, value = h.partition(b":")
            if not sep:
                self.send_error(400, "malformed header line")
                return True
            try:
                headers[key.decode("ascii").lower()] = \
                    value.decode("latin-1").strip()
            except UnicodeDecodeError:
                self.send_error(400, "malformed header name")
                return True
        self.headers = headers
        self.close_connection = \
            (headers.get("connection") or "").lower() == "close"
        if headers.get("expect", "").lower() == "100-continue":
            self.wfile.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            self.wfile.flush()
        t0 = time.perf_counter()
        endpoint = path.split("?")[0]
        adm = self.server.admission
        admitted = False
        if adm is not None:
            if not adm.try_admit(self._priority()):
                self._fast_shed(endpoint, adm, t0)
                return True
            admitted = True
        length = int(headers.get("content-length") or 0)
        self._raw_body = self.rfile.read(length) if length else b"{}"
        pool = self.server.pool
        got = None
        if pool.memcache is not None \
                and endpoint in self.FAST_PATH_ENDPOINTS:
            got = pool.memcache.get_raw(
                endpoint, self._raw_body, gzip_ok=self._accepts_gzip())
        if got is not None:
            err = False
            try:
                self._fast_respond(200, got[0], got[1])
            except BrokenPipeError:
                err = True
            finally:
                if admitted:
                    adm.release()
                self.server.stats.record(
                    self._metric_endpoint(endpoint),
                    time.perf_counter() - t0, err,
                )
            return True
        # miss / search / streaming: the full machinery (which skips
        # re-admission — this request is already in)
        self._pre_admitted = admitted
        self._delegated = True
        try:
            self.do_POST()
        finally:
            self._pre_admitted = False
            self._delegated = False
        self.wfile.flush()
        return True

    def _fast_shed(self, endpoint: str, adm, t0: float):
        """The lean 429: drain the unread body (keep-alive hygiene,
        as in do_POST) and answer with Retry-After."""
        length = int(self.headers.get("content-length") or 0)
        if 0 < length <= 1 << 20:
            self.rfile.read(length)
        elif length:
            self.close_connection = True
        body = response_bytes({
            "error": "overloaded: request shed by admission control; "
                     "retry after the indicated delay",
        })
        out = bytearray(b"HTTP/1.1 429 Too Many Requests\r\n"
                        b"Content-Type: application/json\r\n")
        out += b"Content-Length: %d\r\n" % len(body)
        out += b"Retry-After: %d\r\n" % adm.retry_after_s()
        if self.close_connection:
            out += b"Connection: close\r\n"
        out += b"\r\n" + body
        try:
            self.wfile.write(bytes(out))
            self._maybe_flush()
        except BrokenPipeError:
            pass
        self.server.stats.record(self._metric_endpoint(endpoint),
                                 time.perf_counter() - t0, True)

    def _fast_respond(self, code: int, payload: bytes, meta: dict):
        out = bytearray(b"HTTP/1.1 %d OK\r\n"
                        b"Content-Type: application/json\r\n"
                        % code)
        out += b"Content-Length: %d\r\n" % len(payload)
        if meta.get("content_encoding"):
            out += b"Content-Encoding: gzip\r\n"
        cache = meta.get("cache")
        if cache:
            out += b"X-SimuMax-Cache: %s\r\n" % cache.encode("ascii")
        if meta.get("key"):
            out += b"X-SimuMax-Key: %s\r\n" \
                % str(meta["key"]).encode("ascii")
        if meta.get("served"):
            out += b"X-SimuMax-Served: %s\r\n" \
                % meta["served"].encode("ascii")
        if self.close_connection:
            out += b"Connection: close\r\n"
        out += b"\r\n" + payload
        self.wfile.write(bytes(out))
        self._maybe_flush()

    def _maybe_flush(self):
        """Flush the buffered response writer. (A select-based "defer
        while more pipelined requests are queued" variant measured
        SLOWER here: the zero-timeout poll costs a syscall per
        response and pipelining clients refill their window after
        reading, so the poll almost never says readable.)"""
        self.wfile.flush()

    # -- POST --------------------------------------------------------------
    def do_POST(self):  # noqa: N802
        t0 = time.perf_counter()
        endpoint = self.path.split("?")[0]
        if endpoint.startswith("/ring/"):
            # fleet control plane (service/node.py): no admission (a
            # shed claim RPC would deadlock the sweep it serves into
            # re-evaluating), no routing (ring RPCs are already
            # addressed to the right node by the caller)
            self._ring_rpc(endpoint, t0)
            return
        err = False
        tracer = get_tracer()
        adm = self.server.admission
        admitted = None
        delegated = getattr(self, "_delegated", False)
        if not delegated:
            self._raw_body = None
        if getattr(self, "_pre_admitted", False):
            # the fast lane admitted this request before delegating;
            # this path releases it (admission happens exactly once)
            admitted = True
        elif not delegated and adm is not None \
                and endpoint.startswith("/v1/"):
            # admission happens before the body is even read: a shed
            # request costs the server a load check and a 429, nothing
            # else. An admitted request is released in the finally —
            # it always runs to an answer.
            admitted = adm.try_admit(self._priority())
            if not admitted:
                # keep-alive hygiene: the unread request body would be
                # parsed as the NEXT request line on this connection.
                # Drain small bodies (they're already in the socket
                # buffer); drop the connection for oversized ones
                # rather than read them under overload.
                length = int(self.headers.get("Content-Length") or 0)
                if 0 < length <= 1 << 20:
                    self.rfile.read(length)
                elif length:
                    self.close_connection = True
                retry = adm.retry_after_s()
                body = response_bytes({
                    "error": "overloaded: request shed by admission "
                             "control; retry after the indicated "
                             "delay",
                })
                self.send_response(429)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", str(retry))
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                try:
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass
                self.server.stats.record(
                    self._metric_endpoint(endpoint),
                    time.perf_counter() - t0, True,
                )
                return
        pool = self.server.pool
        if pool is not None and pool.memcache is not None \
                and endpoint in self.FAST_PATH_ENDPOINTS \
                and not delegated:
            length = int(self.headers.get("Content-Length") or 0)
            self._raw_body = self.rfile.read(length) if length \
                else b"{}"
            got = pool.memcache.get_raw(endpoint, self._raw_body,
                                        gzip_ok=self._accepts_gzip())
            if got is not None:
                payload, meta = got
                try:
                    with tracer.trace(f"POST {endpoint}",
                                      endpoint=endpoint,
                                      trace_id=self._incoming_trace(),
                                      ) as tid:
                        self._send_json(200, payload, meta)
                except BrokenPipeError:
                    err = True
                finally:
                    if admitted:
                        adm.release()
                    self.server.stats.record(
                        self._metric_endpoint(endpoint),
                        time.perf_counter() - t0, err,
                    )
                self.server.write_trace(tid, endpoint)
                return
        with tracer.trace(f"POST {endpoint}", endpoint=endpoint,
                          trace_id=self._incoming_trace()) as tid:
            try:
                q = None
                try:
                    q = self._body()
                except (ValueError, json.JSONDecodeError) as exc:
                    err = True
                    self._send_error_json(
                        400, f"bad request body: {exc}")
                router = self.server.router
                if q is not None and router is not None \
                        and endpoint.startswith("/v1/") \
                        and not self.headers.get(
                            "X-SimuMax-Forwarded") \
                        and not router.is_local(endpoint, q):
                    # fleet affinity routing: this node doesn't own the
                    # request's store key — relay it to the owner and
                    # stream the owner's bytes back untouched (routed
                    # responses stay bit-identical to direct serving).
                    # The loop guard means a forwarded request is always
                    # served where it lands, even mid-ring-change.
                    try:
                        relayed = self._relay_remote(endpoint, q)
                        if relayed is not None:  # handled remotely
                            err = err or relayed >= 400
                            q = None
                    except BrokenPipeError:
                        err = True
                        q = None
                if q is not None:
                    try:
                        self._dispatch(endpoint, q)
                        # a streamed search that failed mid-body could
                        # only report the error as an NDJSON line, and
                        # a pooled 400/500 comes back as a status, not
                        # an exception; count both (popped so the flag
                        # never leaks into the next keep-alive request)
                        err = err \
                            or self.__dict__.pop("_stream_error",
                                                 False) \
                            or self.__dict__.pop("_dispatch_error",
                                                 False)
                    except BrokenPipeError:
                        err = True
                    except Exception as exc:
                        err = True
                        code = 400 if self._is_config_error(exc) \
                            else 500
                        self._send_error_json(
                            code, f"{type(exc).__name__}: {exc}"
                        )
            finally:
                if admitted:
                    adm.release()
                self.server.stats.record(
                    self._metric_endpoint(endpoint),
                    time.perf_counter() - t0, err,
                )
        self.server.write_trace(tid, endpoint)

    def _ring_rpc(self, endpoint: str, t0: float):
        """Serve one fleet control-plane RPC (cell claim/publish/wait,
        entry transfer, replication round) via
        ``service/node.py:FleetNode.handle_ring``."""
        err = False
        self._raw_body = None
        try:
            fleet = self.server.fleet
            if fleet is None:
                err = True
                self._send_error_json(404, "not a fleet node")
                return
            try:
                q = self._body()
            except (ValueError, json.JSONDecodeError) as exc:
                err = True
                self._send_error_json(
                    400, f"bad request body: {exc}")
                return
            status, payload = fleet.handle_ring(endpoint, q)
            err = status >= 400
            if isinstance(payload, bytes):
                # raw store-entry bytes (/ring/entry): the replica
                # wire format IS the disk format — no re-encode
                self.send_response(status)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self._send_json(status, payload)
        except BrokenPipeError:
            err = True
        except Exception as exc:
            err = True
            code = 400 if self._is_config_error(exc) else 500
            try:
                self._send_error_json(
                    code, f"{type(exc).__name__}: {exc}")
            except BrokenPipeError:
                pass
        finally:
            self.server.stats.record(
                self._metric_endpoint(endpoint),
                time.perf_counter() - t0, err,
            )

    def _relay_remote(self, endpoint: str, q: dict) -> Optional[int]:
        """Relay this request to its ring owner and copy the owner's
        response back byte-for-byte (identity bodies, relayed serving
        headers). Returns the upstream status, or None when no peer
        answered — the caller serves locally (any node can evaluate;
        the ring only places the cache)."""
        router = self.server.router
        raw = getattr(self, "_raw_body", None) or b"{}"
        fwd = router.forward(
            endpoint, raw, self.headers, q=q,
            deadline_s=self._deadline_s(),
            hedge=endpoint in self.HEDGE_SAFE_ENDPOINTS)
        if fwd is None:
            return None
        try:
            self.send_response(fwd.status)
            for name, value in fwd.headers.items():
                self.send_header(name, value)
            if fwd.chunked:
                # re-chunk the owner's NDJSON stream as it arrives:
                # http.client strips the upstream framing, so each
                # read is re-framed (cell lines keep flowing live)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while True:
                    piece = fwd.response.read(65536)
                    if not piece:
                        break
                    self.wfile.write(
                        f"{len(piece):x}\r\n".encode("ascii")
                        + piece + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            else:
                body = fwd.response.read()
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
        except BrokenPipeError:
            # client went away mid-relay: the upstream response is
            # part-read, the connection can't be pooled
            router.finish(fwd, reuse=False)
            raise
        router.finish(fwd, reuse=True)
        return fwd.status

    @staticmethod
    def _is_config_error(exc: Exception) -> bool:
        from simumax_tpu_torch.core.errors import (
            ConfigError,
            FeasibilityError,
            UnknownConfigError,
        )

        return isinstance(
            exc, (ConfigError, FeasibilityError, UnknownConfigError,
                  TypeError, KeyError, ValueError)
        )

    def _dispatch(self, endpoint: str, q: dict):
        planner = self.server.planner
        pool = self.server.pool
        if pool is not None and endpoint in self.KNOWN_ENDPOINTS \
                and endpoint.startswith("/v1/") \
                and not (endpoint == "/v1/search" and q.get("stream")):
            # pooled serving: memory cache -> single-flight -> worker.
            # Streaming sweeps stay on this process's planner (the
            # NDJSON cell stream needs the in-process on_cell hook),
            # which shares the pool's single-writer store.
            tracer = get_tracer()
            trace_ids = tracer.current_ids() if tracer.enabled else None
            status, payload, meta = pool.serve(
                endpoint, q, priority=self._priority(),
                trace_ids=trace_ids,
                # the deadline budget crosses the dispatch boundary
                # too: a budgeted request never queues past its
                # deadline (the pool answers 504, the client moves on)
                timeout=self._deadline_s(),
                raw=self._raw_body
                if endpoint in self.FAST_PATH_ENDPOINTS else None,
                accept_gzip=self._accepts_gzip(),
            )
            if status >= 400:
                # counted by do_POST: the threaded path raises and is
                # recorded as an error — the pooled path must match
                self._dispatch_error = True
            self._send_json(status, payload,
                            meta if status == 200 else None)
            if endpoint == "/v1/search" and status == 200:
                self._offer_warm(q)
            return
        if endpoint == "/v1/estimate":
            # raw=True: a hit streams the stored canonical bytes
            # without a parse + re-dump (same bytes either way)
            payload, meta = planner.estimate(
                q["model"], q["strategy"], q["system"], with_meta=True,
                raw=True,
            )
            self._send_json(200, payload, meta)
        elif endpoint == "/v1/explain":
            payload, meta = planner.explain(
                q["model"], q["strategy"], q["system"], with_meta=True,
                raw=True,
            )
            self._send_json(200, payload, meta)
        elif endpoint == "/v1/faults":
            payload, meta = planner.faults(
                q["model"], q["strategy"], q["system"],
                monte_carlo=int(q.get("monte_carlo") or 8),
                seed=int(q.get("seed") or 0),
                horizon_steps=int(q.get("horizon") or 50),
                granularity=q.get("granularity", "chunk"),
                with_meta=True, raw=True,
            )
            self._send_json(200, payload, meta)
        elif endpoint == "/v1/simulate":
            payload, meta = planner.simulate(
                q["model"], q["strategy"], q["system"],
                granularity=q.get("granularity", "chunk"),
                track_memory=bool(q.get("track_memory", False)),
                with_meta=True, raw=True,
            )
            self._send_json(200, payload, meta)
        elif endpoint == "/v1/fleet":
            payload, meta = planner.fleet(
                q["trace"],
                jobs=int(q.get("jobs") or 0),
                elastic=q.get("elastic"),
                explain=bool(q.get("explain")),
                with_meta=True, raw=True,
            )
            self._send_json(200, payload, meta)
        elif endpoint == "/v1/search":
            self._search(planner, q)
        else:
            self._send_error_json(404, f"unknown path {endpoint}")

    def _offer_warm(self, q: dict):
        """Queue the served sweep's neighbor-warming job (non-blocking
        best-effort; a full queue drops, never delays the response)."""
        warmer = self.server.warmer
        if warmer is not None:
            warmer.offer(q)

    def _search_kwargs(self, q: dict) -> dict:
        # the one /v1/search body parser, shared with the pool workers
        # and the warmer's neighbor derivation (service/pool.py)
        from simumax_tpu_torch.service.pool import search_kwargs

        return search_kwargs(q)

    def _search(self, planner: Planner, q: dict):
        kwargs = self._search_kwargs(q)
        if not q.get("stream"):
            payload, meta = planner.search(**kwargs, with_meta=True)
            self._send_json(200, payload, meta)
            self._offer_warm(q)
            return
        # chunked NDJSON: one line per settled cell, then the result
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self._send_trace_header()
        self.end_headers()

        def chunk(obj):
            line = response_bytes(obj) + b"\n"
            self.wfile.write(
                f"{len(line):x}\r\n".encode("ascii") + line + b"\r\n"
            )
            self.wfile.flush()

        def on_cell(key, status, row):
            chunk({"cell": key, "status": status, "row": row})

        try:
            payload, meta = planner.search(**kwargs, on_cell=on_cell,
                                           with_meta=True)
            chunk({"result": payload})
            # serving accounting on its own line: the result line stays
            # bit-identical however the cells were served
            chunk({"serving": {
                "cache": meta["cache"],
                "cells_cached": meta["cells_cached"],
                "cells_evaluated": meta["cells_evaluated"],
                "cells_coalesced": meta.get("cells_coalesced", 0),
            }})
            self._offer_warm(q)
        except Exception as exc:
            self._stream_error = True
            chunk({"error": f"{type(exc).__name__}: {exc}"})
        self.wfile.write(b"0\r\n\r\n")


def make_server(planner: Optional[Planner] = None,
                host: str = "127.0.0.1",
                port: int = 8642,
                registry: Optional[MetricsRegistry] = None,
                trace_log: Optional[str] = None,
                pool=None,
                admission: Optional[AdmissionController] = None,
                warmer=None, device: str = "cuda") -> PlannerHTTPServer:
    """Build (but do not start) the server; ``port=0`` binds an
    ephemeral port (``server.server_address[1]`` has the real one).
    ``registry`` defaults to the planner's (itself the process-wide
    one unless the planner was built with an isolated registry);
    ``trace_log`` arms per-request span-tree logging (the ``serve
    --trace-requests`` artifact). ``pool`` / ``admission`` /
    ``warmer`` are the production-serving attachments
    (``service/pool.py`` / ``service/warmer.py``, docs/service.md
    "Production deployment"); all default to off, which is exactly
    the threaded server. ``device`` is where the planner built when
    none is given runs its kernels."""
    return PlannerHTTPServer((host, port),
                             planner or Planner(device=device),
                             registry=registry, trace_log=trace_log,
                             pool=pool, admission=admission,
                             warmer=warmer)


def serve_forever(server: PlannerHTTPServer):
    """Run until interrupted, closing the socket (and reaping the
    pool's daemon workers via ``server_close``) on the way out.

    SIGTERM gets the same graceful path as Ctrl-C: a terminated
    parent that skips ``pool.close()`` orphans its daemon workers,
    which then hold the parent's inherited stdout/stderr pipes open
    forever — fleet reaping (``serve --nodes``) relies on this."""
    def _term(signum, frame):
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread (embedded use): keep default
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.server_close()

"""Multi-process worker pool behind the planning server (L13).

The threaded ``serve`` runs every query on a ``ThreadingHTTPServer`` thread
against one in-process, GIL-bound :class:`Planner`. This module is the
production serving path behind ``serve --workers N``:

* **worker processes** — ``N`` long-lived planner workers (the same
  fork-context + SIGALRM/hard-deadline hardening discipline as the
  sweep executor, ``search/executor.py``), each owning a Planner over a
  **read-only replica** of the shared content-addressed store;
* **single writer** — workers never write the store: evaluated payloads
  ship back with the result and a single parent-side writer thread
  applies them (:class:`ReplicaStore` defers, the pool drains), so the
  write path is contention-free by construction;
* **request coalescing** — byte-identical concurrent queries share one
  in-flight worker evaluation (the parent-side single-flight), and
  ``search`` queries are affinity-routed by their (model, system, gbs,
  engine) coalescing key so overlapping grids land on the same worker
  and share per-cell results through its store/flight table
  (``service/coalesce.py``) instead of evaluating twice;
* **response memory cache** — a bounded LRU of canonical response
  *bytes* keyed by (endpoint, canonical request body), validated
  against the (path, mtime, size) of every config file the response
  resolved (shipped in the worker's meta), so the hot Zipf head of
  production traffic is served without resolving configs, hashing
  identities, or touching the store — content addressing makes the
  cached bytes exact, the dependency stamps make them current;
* **fault isolation** — a worker that dies mid-query is respawned and
  the query retried once on another worker (then quarantined as a 500),
  a worker wedged past the hard deadline is killed; an admitted request
  is always answered, never dropped or hung.

Every response is bit-identical to a direct cache-off evaluation — the
same contract the threaded path holds (the service bench's parity
sample runs against both).

See ``docs/service.md`` ("Production deployment").

Copy of the JAX package's ``service/pool.py`` with its import paths
changed and one addition: :class:`WorkerPool` takes ``device``
(``"cuda"`` by default), which each worker's :class:`Planner` runs its
kernels on. The workers take their start method from
``search/executor.py::_mp_context``: fork, unless this process has
initialised CUDA, and then spawn; a spawned worker builds its own CUDA
context at its first kernel. The ``docs/`` this module names are the
JAX package's.
"""

from __future__ import annotations

import collections
import hashlib
import os
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from simumax_tpu_torch.service.store import ContentStore, canonical_bytes

#: hard-deadline backstop over the per-request timeout, mirroring the
#: sweep executor's contract: a worker running one request longer than
#: FACTOR x timeout + SLACK is presumed wedged beyond SIGALRM's reach
HARD_TIMEOUT_FACTOR = 5.0
HARD_TIMEOUT_SLACK = 30.0

#: priority classes, best first ("warm" is the speculative warmer's
#: internal class — always behind real traffic)
PRIORITIES = ("high", "normal", "low", "warm")

#: response-cache defaults (entries / payload bytes)
MEMCACHE_ENTRIES = 8192
MEMCACHE_BYTES = 128 * 1024 * 1024


def search_kwargs(q: dict) -> dict:
    """Parse a ``/v1/search`` request body into ``Planner.search``
    kwargs — the one parser the threaded handler, the pool workers,
    and the warmer's neighbor derivation all share."""
    def ints(v, default):
        if v is None:
            return default
        if isinstance(v, str):
            return tuple(int(x) for x in v.split(","))
        return tuple(int(x) for x in v)

    return dict(
        model=q["model"], system=q["system"],
        global_batch_size=int(q["gbs"]),
        base_strategy=q.get("base_strategy", "tp1_pp1_dp8_mbs1"),
        world=int(q.get("world") or 0),
        seq_len=int(q.get("seq_len") or 0),
        tp_list=ints(q.get("tp"), (1, 2, 4, 8)),
        pp_list=ints(q.get("pp"), (1, 2, 4)),
        ep_list=ints(q.get("ep"), (1,)),
        cp_list=ints(q.get("cp"), (1,)),
        zero_list=ints(q.get("zero"), (1,)),
        topk=int(q.get("topk") or 5),
        engine=q.get("engine", "scalar"),
        verify_topk=q.get("verify_topk"),
    )


def search_affinity(q: dict) -> int:
    """The coalescing affinity of a search body: overlapping grids
    (same model/system/gbs/engine/base, any axis lists) hash to the
    same worker slot, so their shared cells are computed once and
    served from that worker's store/flight table."""
    ident = {k: q.get(k) for k in
             ("model", "system", "gbs", "engine", "base_strategy",
              "world", "seq_len")}
    return int.from_bytes(
        hashlib.sha256(canonical_bytes(ident)).digest()[:4], "big")


def classify_error(exc: Exception) -> int:
    """HTTP status of an evaluation failure — the same config-family
    == 400 split the threaded handler applies."""
    from simumax_tpu_torch.core.errors import (
        ConfigError,
        FeasibilityError,
        UnknownConfigError,
    )

    return 400 if isinstance(
        exc, (ConfigError, FeasibilityError, UnknownConfigError,
              TypeError, KeyError, ValueError)
    ) else 500


def evaluate_query(planner, endpoint: str, q: dict
                   ) -> Tuple[int, bytes, dict]:
    """Evaluate one (non-streaming) query against a Planner, returning
    ``(status, canonical payload bytes, meta)`` — the worker-side half
    of the HTTP dispatch (the threaded handler produces identical
    bytes from the same planner calls)."""
    try:
        if endpoint == "/v1/estimate":
            payload, meta = planner.estimate(
                q["model"], q["strategy"], q["system"], with_meta=True,
                raw=True,
            )
        elif endpoint == "/v1/explain":
            payload, meta = planner.explain(
                q["model"], q["strategy"], q["system"], with_meta=True,
                raw=True,
            )
        elif endpoint == "/v1/faults":
            payload, meta = planner.faults(
                q["model"], q["strategy"], q["system"],
                monte_carlo=int(q.get("monte_carlo") or 8),
                seed=int(q.get("seed") or 0),
                horizon_steps=int(q.get("horizon") or 50),
                granularity=q.get("granularity", "chunk"),
                with_meta=True, raw=True,
            )
        elif endpoint == "/v1/simulate":
            payload, meta = planner.simulate(
                q["model"], q["strategy"], q["system"],
                granularity=q.get("granularity", "chunk"),
                track_memory=bool(q.get("track_memory", False)),
                with_meta=True, raw=True,
            )
        elif endpoint == "/v1/fleet":
            payload, meta = planner.fleet(
                q["trace"],
                jobs=int(q.get("jobs") or 0),
                elastic=q.get("elastic"),
                with_meta=True, raw=True,
            )
        elif endpoint == "/v1/search":
            payload, meta = planner.search(
                **search_kwargs(q), with_meta=True)
            payload = canonical_bytes(payload)
        else:
            return 404, canonical_bytes(
                {"error": f"unknown path {endpoint}"}), {}
    except Exception as exc:  # shipped to the client as the error body
        return classify_error(exc), canonical_bytes(
            {"error": f"{type(exc).__name__}: {exc}"}), {}
    return 200, payload, meta


class ReplicaStore:
    """Read-only replica view of a shared :class:`ContentStore`.

    Reads (``get`` / ``get_bytes``) pass straight through to the shared
    root — entries written by the parent writer are visible immediately
    (content-addressed files, atomic renames). Writes are **deferred**:
    ``put`` records the entry in :attr:`pending` instead of touching
    the filesystem; the worker ships the drained batch back with its
    result and the parent's single writer thread applies it. Workers
    therefore never contend on the write path, and a torn worker can
    never tear the store."""

    def __init__(self, root: Optional[str] = None, registry=None):
        self._store = ContentStore(root, registry=registry)
        self.root = self._store.root
        self.max_bytes = self._store.max_bytes
        self.counters = self._store.counters
        self.pending: List[tuple] = []

    def get(self, namespace: str, key: str, default=None):
        return self._store.get(namespace, key, default)

    def get_bytes(self, namespace: str, key: str):
        return self._store.get_bytes(namespace, key)

    def put(self, namespace: str, key: str, payload: Any,
            fmt: str = "json") -> str:
        self.pending.append((namespace, key, payload, fmt))
        return ""

    def drain(self) -> List[tuple]:
        out, self.pending = self.pending, []
        return out

    def stats(self) -> dict:
        return self._store.stats()


class PoolFuture:
    """One pooled request's pending result."""

    __slots__ = ("event", "status", "payload", "meta", "queued_at")

    def __init__(self):
        self.event = threading.Event()
        self.status: int = 0
        self.payload: bytes = b""
        self.meta: dict = {}
        self.queued_at = time.perf_counter()

    def resolve(self, status: int, payload: bytes, meta: dict):
        self.status = status
        self.payload = payload
        self.meta = meta
        self.event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.event.wait(timeout)


#: how long a verified dependency stamp stays trusted before the next
#: hit re-stats the config files (seconds). Config files change on
#: human timescales; re-statting them on every hit of a hot entry
#: costs more than the whole lookup on network/overlay filesystems.
DEPS_TTL_S = 2.0

#: responses at least this big grow a cached gzip variant for clients
#: that send ``Accept-Encoding: gzip`` — a 500 KiB explain ledger in
#: the hot Zipf head would otherwise spend more wall time in socket
#: copies than the whole lookup. Compressed ONCE per entry (amortized
#: over its hits); the canonical identity stays the uncompressed
#: bytes — encoding is transport, never content.
GZIP_MIN_BYTES = 16 * 1024


class ResponseCache:
    """Bounded LRU of canonical response bytes keyed by (endpoint,
    canonical request body), each entry validated on hit against the
    (path, mtime_ns, size) of every config file its evaluation
    resolved (re-checked at most every :data:`DEPS_TTL_S`). Content
    addressing makes a revalidated entry exact: the same body + the
    same config files + the same code resolve to the same content
    key, hence the same canonical bytes.

    Hot entries are additionally reachable through a **raw-body
    alias**: the exact request bytes a client sent map straight to the
    entry, so a repeat of a hot query is served without JSON parsing
    or canonicalization (the alias was registered by a request whose
    canonical identity WAS computed from those bytes)."""

    def __init__(self, max_entries: int = MEMCACHE_ENTRIES,
                 max_bytes: int = MEMCACHE_BYTES, registry=None):
        from simumax_tpu_torch.observe.telemetry import get_registry

        self.registry = registry or get_registry()
        self._lock = threading.Lock()
        self._od: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        #: (endpoint, raw request bytes) -> canonical entry key
        self._alias: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _deps_fresh(deps) -> bool:
        try:
            for path, mtime_ns, size in deps:
                st = os.stat(path)
                if st.st_mtime_ns != mtime_ns or st.st_size != size:
                    return False
        except OSError:
            return False
        return True

    def _gzip(self, payload: bytes, gz_box: list):
        """The entry's transport-encoded variant, compressed exactly
        once (the first gzip-accepting hit pays; the hot head rides
        the cached bytes)."""
        gz = gz_box[0]
        if gz is None:
            import gzip as _gz

            gz = _gz.compress(payload, compresslevel=1)
            with self._lock:
                if gz_box[0] is None:
                    gz_box[0] = gz
                    self._bytes += len(gz)
                else:
                    gz = gz_box[0]
        return gz

    def _serve(self, payload, meta, gz_box, gzip_ok: bool):
        self.registry.counter("pool_memcache_hits_total").inc()
        if gzip_ok and len(payload) >= GZIP_MIN_BYTES:
            gz = self._gzip(payload, gz_box)
            if len(gz) < len(payload):
                out = dict(meta)
                out["content_encoding"] = "gzip"
                return gz, out
        return payload, dict(meta)

    def get(self, key: tuple, gzip_ok: bool = False):
        now = time.monotonic()
        deps = None
        ttl_fresh = False
        with self._lock:
            entry = self._od.get(key)
            if entry is None:
                self.misses += 1
                return None
            payload, meta, deps, checked, gz_box = entry
            if now - checked[0] <= DEPS_TTL_S:
                self._od.move_to_end(key)
                self.hits += 1
                ttl_fresh = True
        if ttl_fresh:
            return self._serve(payload, meta, gz_box, gzip_ok)
        # stat outside the lock: a slow filesystem must not serialize
        # every other lookup behind it
        fresh = self._deps_fresh(deps)
        with self._lock:
            entry = self._od.get(key)
            if entry is None:
                self.misses += 1
                return None
            payload, meta, deps, checked, gz_box = entry
            if not fresh:
                self._od.pop(key, None)
                self._bytes -= len(payload)
                if gz_box[0] is not None:
                    self._bytes -= len(gz_box[0])
                self.misses += 1
                self.registry.gauge("pool_memcache_entries").set(
                    len(self._od))
                return None
            checked[0] = now
            self._od.move_to_end(key)
            self.hits += 1
        return self._serve(payload, meta, gz_box, gzip_ok)

    def get_raw(self, endpoint: str, raw: bytes,
                gzip_ok: bool = False):
        """Serve a repeat of a hot query straight off its raw request
        bytes — no JSON parse, no canonicalization. Returns ``None``
        when the alias is unknown (full path registers it)."""
        with self._lock:
            key = self._alias.get((endpoint, raw))
        if key is None:
            return None
        return self.get(key, gzip_ok=gzip_ok)

    def alias(self, endpoint: str, raw: bytes, key: tuple):
        """Register the raw-bytes alias of an entry (called by the
        serving path that computed ``key`` from exactly ``raw``)."""
        with self._lock:
            self._alias[(endpoint, raw)] = key
            self._alias.move_to_end((endpoint, raw))
            while len(self._alias) > self.max_entries:
                self._alias.popitem(last=False)

    def put(self, key: tuple, payload: bytes, meta: dict):
        deps = tuple(tuple(d) for d in meta.get("deps") or ())
        hit_meta = dict(meta)
        hit_meta["cache"] = "hit"
        hit_meta["served"] = "memory"
        if "cells_evaluated" in hit_meta:
            # a memory hit serves every cell; the accounting headers
            # are serving-dependent by contract
            hit_meta["cells_cached"] = (
                int(hit_meta.get("cells_cached") or 0)
                + int(hit_meta.get("cells_evaluated") or 0))
            hit_meta["cells_evaluated"] = 0
        checked = [time.monotonic()]
        with self._lock:
            old = self._od.pop(key, None)
            if old is not None:
                self._bytes -= len(old[0])
                if old[4][0] is not None:
                    self._bytes -= len(old[4][0])
            self._od[key] = (payload, hit_meta, deps, checked, [None])
            self._bytes += len(payload)
            while self._od and (len(self._od) > self.max_entries
                                or self._bytes > self.max_bytes):
                _, (pl, _m, _d, _c, gzb) = self._od.popitem(last=False)
                self._bytes -= len(pl)
                if gzb[0] is not None:
                    self._bytes -= len(gzb[0])
            self.registry.gauge("pool_memcache_entries").set(
                len(self._od))

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._od), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses}


# --------------------------------------------------------------------------
# Worker process
# --------------------------------------------------------------------------


def _worker_main(slot: int, task_q, result_q, cache_dir: Optional[str],
                 enabled: bool, request_timeout: Optional[float],
                 trace: bool, fleet_spec: Optional[tuple] = None,
                 device: str = "cuda"):
    """Long-lived planner worker: evaluates one request at a time on
    its MAIN thread (so the SIGALRM per-request deadline is fully
    effective, like a sweep pool worker), over a read-only store
    replica whose writes ship back with each result."""
    from simumax_tpu_torch.observe.telemetry import get_tracer
    from simumax_tpu_torch.search.searcher import _candidate_deadline
    from simumax_tpu_torch.service.planner import Planner
    from simumax_tpu_torch.service.warmer import warm_cells

    tracer = get_tracer()
    if trace:
        tracer.configure(enabled=True)
    replica = ReplicaStore(cache_dir) if enabled else None
    planner = Planner(store=replica, enabled=enabled, device=device)
    if fleet_spec is not None:
        # fleet member: this worker's cell claims go over the wire to
        # each cell's ring owner (non-authoritative — even cells this
        # NODE owns round-trip through the parent's flight table via
        # loopback, which also coalesces sibling workers against each
        # other)
        from simumax_tpu_torch.service.node import build_worker_flights

        node_id, ring_spec = fleet_spec
        planner.cell_flights = build_worker_flights(
            node_id, ring_spec, registry=planner.registry)

    def totals() -> dict:
        out = {"planner": dict(planner.counters)}
        out["store"] = dict(replica.counters) if replica else {}
        return out

    while True:
        task = task_q.get()
        if task is None:
            return
        req_id, kind, endpoint, body, trace_ids = task
        spans: List[dict] = []
        t0 = time.perf_counter()
        try:
            ctx = (tracer.trace(f"worker {endpoint}",
                                trace_id=trace_ids[0], worker=slot)
                   if trace_ids else None)
            if ctx is not None:
                ctx.__enter__()
            try:
                with _candidate_deadline(request_timeout,
                                         f"pool:{endpoint}"):
                    if kind == "warm":
                        warmed = warm_cells(
                            planner, body,
                            max_cells=body.get("_max_cells"))
                        status = 200
                        payload = canonical_bytes({"warmed": warmed})
                        meta: dict = {}
                    else:
                        status, payload, meta = evaluate_query(
                            planner, endpoint, body)
            finally:
                if ctx is not None:
                    ctx.__exit__(None, None, None)
                if trace_ids:
                    # re-parent the worker's root span under the
                    # request span the parent opened, so the shipped
                    # spans join the request's one trace
                    for rec in tracer.pop_trace(trace_ids[0]):
                        d = rec.to_dict()
                        if d["parent_id"] is None:
                            d["parent_id"] = trace_ids[1]
                        spans.append(d)
        except Exception as exc:  # deadline, planner bug: never die
            status = classify_error(exc) \
                if isinstance(exc, Exception) else 500
            payload = canonical_bytes(
                {"error": f"{type(exc).__name__}: {exc}"})
            meta = {}
        writes = replica.drain() if replica else []
        result_q.put((
            "done", slot, req_id, status, payload, meta, totals(),
            writes, spans, time.perf_counter() - t0,
        ))


class _Worker:
    __slots__ = ("slot", "process", "task_q", "result_q", "inflight",
                 "inflight_since", "last_totals")

    def __init__(self, slot: int):
        self.slot = slot
        self.process = None
        self.task_q = None
        self.result_q = None
        self.inflight = None  # (req_id, task tuple)
        self.inflight_since = 0.0
        self.last_totals: Dict[str, Dict[str, int]] = {}


class WorkerPool:
    """The serving pool: dispatch, coalescing, memory cache, single
    writer, and fault recovery. See the module docstring."""

    def __init__(self, cache_dir: Optional[str] = None,
                 enabled: bool = True, workers: int = 2,
                 registry=None, request_timeout: Optional[float] = None,
                 memcache_entries: int = MEMCACHE_ENTRIES,
                 memcache_bytes: int = MEMCACHE_BYTES,
                 max_bytes: Optional[int] = None,
                 trace: bool = False,
                 fleet_spec: Optional[tuple] = None,
                 device: str = "cuda"):
        from simumax_tpu_torch.observe.telemetry import get_registry
        from simumax_tpu_torch.search.executor import _mp_context

        self.registry = registry or get_registry()
        self.enabled = enabled
        self.workers = max(1, int(workers))
        self.request_timeout = request_timeout
        self.trace = trace
        #: ``(node_id, ring_spec)`` when this pool serves a fleet node:
        #: workers claim sweep cells at each cell's ring owner instead
        #: of a per-process table (service/node.py)
        self.fleet_spec = fleet_spec
        #: where the workers' planners run the kernels
        self.device = device
        self._ctx = _mp_context()
        #: the parent-side store: THE single writer of the shared root
        store_kwargs = {} if max_bytes is None \
            else {"max_bytes": max_bytes}
        self.store = ContentStore(cache_dir, registry=self.registry,
                                  **store_kwargs) \
            if enabled else None
        self.cache_dir = self.store.root if self.store else None
        self.memcache = ResponseCache(memcache_entries, memcache_bytes,
                                      registry=self.registry) \
            if memcache_entries else None
        self._write_q: "_queue.Queue" = _queue.Queue()
        self._lock = threading.Lock()
        self._seq = 0
        self._reqs: Dict[int, dict] = {}
        #: queued tasks per priority: (seq, task, future, affinity)
        self._pending: Dict[str, collections.deque] = {
            p: collections.deque() for p in PRIORITIES
        }
        self._flights: Dict[tuple, PoolFuture] = {}
        self._workers = [_Worker(i) for i in range(self.workers)]
        #: aggregated worker-side planner/store counters (the /stats
        #: totals of a pooled server)
        self.counters: Dict[str, Dict[str, int]] = {
            "planner": {}, "store": {},
        }
        self.stats_counters: Dict[str, int] = {
            "requests": 0, "coalesced": 0, "retries": 0,
            "restarts": 0, "timeouts": 0,
        }
        #: EWMA of worker service seconds (Retry-After estimation)
        self._ewma_service_s = 0.05
        self._closed = False
        for w in self._workers:
            self._spawn(w)
        self.registry.gauge("pool_workers").set(self.workers)
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name="pool-collector")
        self._collector.start()
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True, name="pool-writer")
        self._writer.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="pool-monitor")
        self._monitor.start()

    # -- lifecycle ---------------------------------------------------------
    def _spawn(self, w: _Worker):
        # NEVER reuse a dead worker's queues: a SIGKILL can land while
        # the worker holds an internal queue lock (a reader blocked in
        # get() holds the queue's rlock), which would wedge any
        # successor on the same queue forever. Per-worker queues,
        # created fresh on every (re)spawn, make a worker's death
        # fully isolated — whatever lock it took dies with its queues.
        w.task_q = self._ctx.Queue()
        w.result_q = self._ctx.Queue()
        w.process = self._ctx.Process(
            target=_worker_main,
            args=(w.slot, w.task_q, w.result_q, self.cache_dir,
                  self.enabled, self.request_timeout, self.trace,
                  self.fleet_spec, self.device),
            daemon=True, name=f"planner-worker-{w.slot}",
        )
        w.process.start()

    def close(self):
        self._closed = True
        for w in self._workers:
            try:
                w.task_q.put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 5.0
        for w in self._workers:
            if w.process is None:
                continue
            w.process.join(max(0.1, deadline - time.monotonic()))
            if w.process.is_alive():
                w.process.terminate()
        self._write_q.put(None)

    # -- dispatch ----------------------------------------------------------
    def _preferred_slot(self, affinity: Optional[int]) -> Optional[int]:
        if affinity is None:
            return None
        return affinity % self.workers

    def _idle_workers(self) -> List[_Worker]:
        return [w for w in self._workers if w.inflight is None]

    def _dispatch_locked(self):
        """Hand queued tasks to idle workers, best priority first;
        affinity tasks wait for their preferred worker (that is the
        coalescing point), everything else takes any idle worker."""
        idle = {w.slot: w for w in self._idle_workers()}
        if not idle:
            return
        for prio in PRIORITIES:
            dq = self._pending[prio]
            kept = collections.deque()
            while dq and idle:
                seq, task, future, affinity = dq.popleft()
                slot = self._preferred_slot(affinity)
                if slot is not None and slot not in idle:
                    alive = self._workers[slot].process is not None \
                        and self._workers[slot].process.is_alive()
                    if alive:
                        kept.append((seq, task, future, affinity))
                        continue
                    slot = None  # preferred worker gone: run anywhere
                w = idle.pop(slot) if slot is not None \
                    else idle.pop(next(iter(idle)))
                self._assign(w, task, future)
            kept.extend(dq)
            self._pending[prio] = kept
            if not idle:
                break
        depth = {p: len(self._pending[p]) for p in PRIORITIES}
        for p, n in depth.items():
            self.registry.gauge("pool_queue_depth", priority=p).set(n)

    def _assign(self, w: _Worker, task: tuple, future: PoolFuture):
        req_id = task[0]
        self._reqs[req_id]["worker"] = w.slot
        w.inflight = (req_id, task)
        w.inflight_since = time.monotonic()
        self.registry.histogram("pool_queue_wait_seconds").observe(
            time.perf_counter() - future.queued_at)
        w.task_q.put(task)

    def submit(self, endpoint: str, body: dict, kind: str = "query",
               priority: str = "normal",
               trace_ids: Optional[tuple] = None,
               affinity: Optional[int] = None) -> PoolFuture:
        """Queue one task for a worker; returns its future. Admitted
        tasks are never dropped: every submitted future eventually
        resolves (result, retry-then-quarantine, or hard-deadline
        kill)."""
        if priority not in PRIORITIES:
            priority = "normal"
        future = PoolFuture()
        with self._lock:
            self._seq += 1
            req_id = self._seq
            task = (req_id, kind, endpoint, body, trace_ids)
            self._reqs[req_id] = {
                "future": future, "task": task, "retried": False,
                "priority": priority, "worker": None,
            }
            self._pending[priority].append(
                (req_id, task, future, affinity))
            self._dispatch_locked()
        return future

    def backlog(self) -> int:
        """Queued + in-flight requests (the admission-control load
        signal)."""
        with self._lock:
            queued = sum(len(d) for p, d in self._pending.items()
                         if p != "warm")
            inflight = sum(1 for w in self._workers
                           if w.inflight is not None)
        return queued + inflight

    def estimated_wait_s(self) -> float:
        """Rough seconds a newly admitted request would wait — the
        Retry-After estimate (backlog x EWMA service time / workers)."""
        return (self.backlog() + 1) * self._ewma_service_s \
            / max(1, self.workers)

    # -- serving front door ------------------------------------------------
    def serve(self, endpoint: str, body: dict,
              priority: str = "normal",
              trace_ids: Optional[tuple] = None,
              timeout: Optional[float] = None,
              raw: Optional[bytes] = None,
              accept_gzip: bool = False
              ) -> Tuple[int, bytes, dict]:
        """The request path: memory cache, then identical-query
        single-flight, then a pooled evaluation. Returns ``(status,
        canonical payload bytes, meta)``. ``raw`` (the exact request
        bytes ``body`` was parsed from) registers the memcache's
        raw-body alias so the next repeat skips the parse entirely;
        ``accept_gzip`` lets a memcache hit serve its cached gzip
        variant (``meta["content_encoding"]`` says when)."""
        key = (endpoint, canonical_bytes(body))
        if self.memcache is not None:
            if raw is not None:
                self.memcache.alias(endpoint, raw, key)
            got = self.memcache.get(key, gzip_ok=accept_gzip)
            if got is not None:
                return 200, got[0], got[1]
        with self._lock:
            leader_future = self._flights.get(key)
            if leader_future is None:
                future = PoolFuture()
                self._flights[key] = future
                leader = True
            else:
                future = leader_future
                leader = False
                self.stats_counters["coalesced"] += 1
        if not leader:
            self.registry.counter("pool_coalesced_total").inc()
            future.wait(timeout)
            meta = dict(future.meta)
            if future.status == 200:
                meta["cache"] = "hit"
                meta["served"] = "coalesced"
            return future.status, future.payload, meta
        try:
            affinity = search_affinity(body) \
                if endpoint == "/v1/search" else None
            inner = self.submit(endpoint, body, priority=priority,
                                trace_ids=trace_ids, affinity=affinity)
            if not inner.wait(timeout):
                payload = canonical_bytes(
                    {"error": "pooled request timed out"})
                # the flight future must resolve on EVERY leader exit:
                # coalesced followers wait on it without a timeout
                future.resolve(504, payload, {})
                return 504, payload, {}
            status, payload, meta = (inner.status, inner.payload,
                                     dict(inner.meta))
            if status == 200 and self.memcache is not None:
                self.memcache.put(key, payload, meta)
            future.resolve(status, payload, meta)
            return status, payload, meta
        except BaseException:
            future.resolve(500, canonical_bytes(
                {"error": "pool dispatch failed"}), {})
            raise
        finally:
            with self._lock:
                self._flights.pop(key, None)

    # -- background threads ------------------------------------------------
    def _collect_loop(self):
        """Drain every worker's own result queue (a respawned worker
        gets fresh queues, so a dead worker's wedged or torn queue is
        simply no longer read)."""
        while not self._closed:
            msg = None
            with self._lock:
                queues = [(w.slot, w.result_q) for w in self._workers
                          if w.result_q is not None]
            for _slot, q in queues:
                try:
                    msg = q.get_nowait()
                except (_queue.Empty, OSError, EOFError, ValueError):
                    continue
                if msg is not None:
                    break
            if msg is None:
                time.sleep(0.005)
                continue
            (_kind, slot, req_id, status, payload, meta, totals,
             writes, spans, service_s) = msg
            w = self._workers[slot]
            with self._lock:
                rec = self._reqs.pop(req_id, None)
                if w.inflight is not None and w.inflight[0] == req_id:
                    w.inflight = None
                self._merge_totals(w, totals)
                self._ewma_service_s = (0.9 * self._ewma_service_s
                                        + 0.1 * service_s)
                self.stats_counters["requests"] += 1
                self._dispatch_locked()
            for write in writes:
                self._write_q.put(write)
            if spans:
                self._inject_spans(spans)
            self.registry.counter(
                "pool_requests_total",
                outcome="ok" if status == 200 else "error",
            ).inc()
            if rec is not None:
                rec["future"].resolve(status, payload, meta)

    def _merge_totals(self, w: _Worker, totals: Dict[str, dict]):
        """Fold a worker's cumulative planner/store counters into the
        pool aggregate (workers are serial, so per-result deltas are
        exact)."""
        for family, now in totals.items():
            last = w.last_totals.setdefault(family, {})
            agg = self.counters.setdefault(family, {})
            for name, value in now.items():
                delta = value - last.get(name, 0)
                if delta:
                    agg[name] = agg.get(name, 0) + delta
                last[name] = value

    def _write_loop(self):
        """The single writer: applies worker-shipped store entries to
        the shared root (atomic replace; identical content races are
        harmless)."""
        while True:
            item = self._write_q.get()
            if item is None:
                return
            if self.store is None:
                continue
            namespace, key, payload, fmt = item
            try:
                self.store.put(namespace, key, payload, fmt=fmt)
            except OSError:
                continue  # full disk etc.: queries already answered

    def _inject_spans(self, spans: List[dict]):
        from simumax_tpu_torch.observe.telemetry import SpanRecord, get_tracer

        tracer = get_tracer()
        if not tracer.enabled:
            return
        for d in spans:
            tracer._record(SpanRecord(
                d["trace_id"], d["span_id"], d["parent_id"], d["name"],
                d["start_s"], d["start_s"] + d["duration_s"],
                d.get("attrs") or {}, str(d.get("thread", "worker")),
            ))

    def _hard_deadline_s(self) -> Optional[float]:
        if not self.request_timeout or self.request_timeout <= 0:
            return None
        return (self.request_timeout * HARD_TIMEOUT_FACTOR
                + HARD_TIMEOUT_SLACK)

    def _monitor_loop(self):
        """Worker supervision: respawn dead workers (retrying their
        in-flight request once, then quarantining it) and kill workers
        wedged past the hard deadline."""
        hard = self._hard_deadline_s()
        while not self._closed:
            time.sleep(0.05)
            for w in self._workers:
                p = w.process
                if p is None:
                    continue
                if not p.is_alive():
                    self._recover(w, killed=False)
                elif (hard and w.inflight is not None
                        and time.monotonic() - w.inflight_since > hard):
                    try:
                        p.terminate()
                    except (OSError, ValueError):
                        pass
                    p.join(2.0)
                    self._recover(w, killed=True)

    def _recover(self, w: _Worker, killed: bool):
        with self._lock:
            if self._closed:
                return
            inflight = w.inflight
            w.inflight = None
            # _spawn swaps in fresh queues, so whatever the dead
            # process left queued (or locked) is abandoned with them
            self._spawn(w)
            self.stats_counters["restarts"] += 1
            self.registry.counter("pool_worker_restarts_total").inc()
            if inflight is None:
                self._dispatch_locked()
                return
            req_id, task = inflight
            rec = self._reqs.get(req_id)
        if rec is None:
            return
        if killed:
            self.stats_counters["timeouts"] += 1
            self.registry.counter("pool_requests_total",
                                  outcome="timeout").inc()
            with self._lock:
                self._reqs.pop(req_id, None)
                self._dispatch_locked()
            rec["future"].resolve(500, canonical_bytes({
                "error": "worker exceeded the request hard deadline "
                         "and was killed",
            }), {})
            return
        if rec["retried"]:
            with self._lock:
                self._reqs.pop(req_id, None)
                self._dispatch_locked()
            rec["future"].resolve(500, canonical_bytes({
                "error": "worker died twice evaluating this request; "
                         "quarantined",
            }), {})
            return
        # first death: retry once on any worker (no affinity — the
        # preferred worker is the one that just died)
        with self._lock:
            rec["retried"] = True
            self.stats_counters["retries"] += 1
            self._pending[rec["priority"]].appendleft(
                (req_id, task, rec["future"], None))
            self._dispatch_locked()
        self.registry.counter("pool_retries_total").inc()

    # -- observability -----------------------------------------------------
    def planner_stats(self) -> dict:
        """The pooled equivalent of ``Planner.stats()``: aggregated
        worker-side planner counters + the shared store's stats with
        the aggregated read counters and the parent writer's write
        counters summed — so ``/stats`` keeps its schema and its
        meaning under ``--workers``."""
        with self._lock:
            planner = dict(self.counters.get("planner", {}))
            worker_store = dict(self.counters.get("store", {}))
        out: Dict[str, Any] = {"enabled": self.enabled,
                               "planner": planner}
        if self.store is not None:
            st = self.store.stats()
            merged = dict(st["counters"])
            for name, value in worker_store.items():
                merged[name] = merged.get(name, 0) + value
            st["counters"] = merged
            out["store"] = st
        else:
            out["store"] = None
        return out

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.stats_counters)
            queued = {p: len(d) for p, d in self._pending.items()}
            inflight = sum(1 for w in self._workers
                           if w.inflight is not None)
        out = {
            "workers": self.workers,
            "inflight": inflight,
            "queued": queued,
            **counters,
        }
        if self.memcache is not None:
            out["memcache"] = self.memcache.stats()
        return out

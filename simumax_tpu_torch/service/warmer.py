"""Speculative cache warming (L13): precompute the cells clients ask
for next.

Sweep traffic is spatially local: a client that swept ``tp=1,2 x
pp=1`` very often follows up with ``tp=1,2,4`` or ``pp=1,2`` — one
index step along one swept axis. Per-cell sweep persistence
makes those neighbor cells independently addressable, and the
:class:`~simumax_tpu_torch.search.prune.CellNeighborhood` already defines
"one step along one axis" — so when a sweep query lands, the server
offers its grid to a bounded background :class:`Warmer`, which expands
each swept axis by one step in both directions, selects exactly the
neighbor cells of the queried grid through ``CellNeighborhood``, and
evaluates the ones the store does not already hold — at strictly lower
priority than real traffic (the pool's ``warm`` class, or an idle
daemon thread in threaded mode).

Safety rails:

* **bounded** — a fixed-size job queue (``serve --warm N``); a full
  queue drops the job (counted), never blocks a request;
* **deduplicated** — a recently-warmed spec is not re-warmed on every
  repeat of the same query;
* **eviction-safe** — warming must never evict the hot entries real
  traffic relies on: a job is skipped (counted) when the store is
  above ``HEADROOM_FRACTION`` of its size budget, so the warmer only
  ever fills headroom;
* **best-effort** — a failing warm job is counted and dropped; it can
  never affect a served response (warm payloads are store entries,
  and the store is content-addressed).
"""

from __future__ import annotations

import hashlib
import queue as _queue
import threading
import time
from typing import Callable, List, Optional, Sequence

from simumax_tpu_torch.service.store import canonical_bytes

#: never warm a store past this fraction of its byte budget — the
#: remaining headroom belongs to real traffic (warming into a full
#: store would LRU-evict hot entries to make room for guesses)
HEADROOM_FRACTION = 0.8

#: recently-warmed spec hashes remembered for dedup
RECENT_SPECS = 256

#: axes whose domains are powers of two (one "index step" = x2 / /2);
#: zero_state steps +-1 within its 0..3 domain
POW2_AXES = ("tp", "cp", "ep", "pp")


def _step_axis(values: Sequence[int], pow2: bool, world: int,
               lo: int = 1, hi: Optional[int] = None) -> List[int]:
    """Extend one swept axis by one index step below its min and above
    its max (the values a follow-up query statistically adds)."""
    vals = sorted(set(int(v) for v in values))
    out = list(vals)
    if pow2:
        down = vals[0] // 2
        up = vals[-1] * 2
        if down >= lo and down not in out:
            out.append(down)
        if up <= (hi or world) and up not in out:
            out.append(up)
    else:
        if vals[0] - 1 >= lo and vals[0] - 1 not in out:
            out.append(vals[0] - 1)
        if hi is not None and vals[-1] + 1 <= hi \
                and vals[-1] + 1 not in out:
            out.append(vals[-1] + 1)
    return sorted(out)


def neighbor_spec(search_body: dict) -> dict:
    """The warm-job spec derived from a ``/v1/search`` request body:
    the same body plus the expanded axis lists (JSON-safe — it ships
    to pool workers as-is)."""
    from simumax_tpu_torch.service.pool import search_kwargs

    kw = search_kwargs(search_body)
    world = int(search_body.get("world") or 0) or 1 << 20
    spec = dict(search_body)
    spec.pop("stream", None)
    spec["tp"] = _step_axis(kw["tp_list"], True, world)
    spec["cp"] = _step_axis(kw["cp_list"], True, world)
    spec["ep"] = _step_axis(kw["ep_list"], True, world)
    spec["pp"] = _step_axis(kw["pp_list"], True, world)
    spec["zero"] = _step_axis(kw["zero_list"], False, world,
                              lo=0, hi=3)
    return spec


def warm_cells(planner, spec: dict,
               max_cells: Optional[int] = None) -> int:
    """Evaluate the neighbor cells of ``spec``'s original grid that
    the store does not already hold; returns the number warmed.

    The expanded grid is enumerated exactly like a sweep
    (``enumerate_cells``), the original grid's cells are located in
    it, and the warm set is their :class:`CellNeighborhood` neighbors
    minus the grid itself — cells one index step away along one swept
    axis. Results are written through ``planner``'s store (a worker's
    deferred replica or a direct store), under the exact per-cell keys
    the sweep path uses, so the next overlapping query hits."""
    from simumax_tpu_torch.search.executor import run_cells
    from simumax_tpu_torch.search.prune import CellNeighborhood, enumerate_cells
    from simumax_tpu_torch.service.pool import search_kwargs

    store = planner.store if planner.enabled else None
    if store is None:
        return 0
    kw = search_kwargs(spec)
    model = planner._loader.load("model", kw["model"])
    system = planner._loader.load("system", kw["system"])
    base = planner._loader.load("strategy", kw["base_strategy"])
    if kw["world"]:
        base.world_size = kw["world"]
    if kw["seq_len"]:
        base.seq_len = kw["seq_len"]
    gbs = kw["global_batch_size"]
    # the original axis values ride the spec ("_orig", stamped by
    # Warmer.offer); without them everything counts as original and
    # there is nothing to warm
    orig_axes = spec.get("_orig") or {}

    cells, _pruned, _deduped = enumerate_cells(
        base, model, system, gbs,
        kw["tp_list"], kw["cp_list"], kw["ep_list"], kw["pp_list"],
        kw["zero_list"], ("none", "selective", "full_block"),
        prune=True,
    )
    if not cells:
        return 0

    def in_original(cell) -> bool:
        for axis in ("tp", "cp", "ep", "pp", "zero"):
            ovals = orig_axes.get(axis)
            if ovals is not None and getattr(cell, axis) not in ovals:
                return False
        return True

    originals = [c for c in cells if in_original(c)]
    if not originals or len(originals) == len(cells):
        return 0
    hood = CellNeighborhood(cells)
    original_idx = {c.idx for c in originals}
    warm = {}
    for c in originals:
        for nb in hood.neighbors(c):
            if nb.idx not in original_idx:
                warm[nb.idx] = nb
    targets = [warm[i] for i in sorted(warm)]
    if max_cells:
        targets = targets[:max_cells]
    # the per-cell store keys of this (base, model, system, gbs,
    # engine) family — the sweep path's own key builder, so a warmed
    # cell lands under exactly the key the next overlapping sweep
    # computes
    from simumax_tpu_torch.search.searcher import sweep_cell_key_fn

    engine = kw["engine"]
    cell_key = sweep_cell_key_fn(base, model, system, gbs, engine)

    todo = [c for c in targets
            if not isinstance(store.get("sweep", cell_key(c)), dict)]
    if not todo:
        return 0
    warmed = 0

    def persist(outcome):
        nonlocal warmed
        if outcome.status not in ("ok", "empty"):
            return
        try:
            store.put("sweep", cell_key(outcome.cell), {
                "status": outcome.status,
                "row": outcome.row,
                "error": outcome.error,
            })
            warmed += 1
        except OSError:
            pass

    run_cells(
        todo, base_strategy=base, model=model, system=system,
        global_batch_size=gbs, engine=engine, jobs=1,
        on_done=persist,
    )
    return warmed


def pool_runner(pool, timeout: float = 600.0,
                max_cells: Optional[int] = None) -> Callable[[dict], int]:
    """Warm-job runner for pooled serving: ships the spec to a
    ``warm``-priority pool task — evaluated on a worker strictly
    behind real traffic — and returns the number of cells warmed.
    ``max_cells`` (``serve --warm-cells``) rides the spec so the
    worker-side :func:`warm_cells` enforces the same cap the threaded
    runner applies directly."""
    import json

    def run(spec: dict) -> int:
        if max_cells:
            spec = dict(spec, _max_cells=int(max_cells))
        future = pool.submit("/v1/search", spec, kind="warm",
                             priority="warm")
        if not future.wait(timeout):
            return 0
        try:
            return int(json.loads(future.payload).get("warmed", 0))
        except (ValueError, TypeError, AttributeError):
            return 0

    return run


class Warmer:
    """Bounded background warm-job queue. ``offer`` is called by the
    serving path after each sweep query (non-blocking, drop-on-full);
    a daemon thread executes jobs through ``runner(spec)`` — directly
    against the planner in threaded mode, or as a ``warm``-priority
    pool task in pooled mode."""

    def __init__(self, runner: Callable[[dict], int],
                 store=None, max_jobs: int = 8,
                 max_cells: int = 64, registry=None):
        from simumax_tpu_torch.observe.telemetry import get_registry

        self.registry = registry or get_registry()
        self.runner = runner
        self.store = store
        self.max_cells = max_cells
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(1, max_jobs))
        self._recent: "list" = []
        self._recent_set: set = set()
        self._lock = threading.Lock()
        self.counters = {"offered": 0, "warmed_jobs": 0,
                         "warmed_cells": 0, "duplicate": 0,
                         "dropped": 0, "skipped_headroom": 0,
                         "skipped_remote": 0, "skipped_degraded": 0,
                         "errors": 0}
        #: fleet gate (service/node.py): when set, only sweeps this
        #: node OWNS are warmed — warming a remote shard would guess
        #: into a store the owner never reads
        self.route_filter: Optional[Callable[[dict], bool]] = None
        #: fleet health gate (service/node.py): when set and True, a
        #: member is down — every core is worth more re-serving the
        #: dead node's remapped keys than speculating on neighbors,
        #: so warming pauses until the detector sees the fleet whole
        self.degraded: Optional[Callable[[], bool]] = None
        #: True while the loop is executing a dequeued job — drain()
        #: must wait this out, not just an empty queue
        self._busy = False
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="planner-warmer")
        self._thread.start()

    def _count(self, name: str, n: int = 1, outcome: str = ""):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if outcome:
            self.registry.counter("warmer_jobs_total",
                                  outcome=outcome).inc(n)

    def _headroom_ok(self) -> bool:
        """Refuse to warm a store already near its byte budget:
        warming then would LRU-evict hot entries to store guesses."""
        store = self.store
        if store is None:
            return True
        total = 0
        try:
            st = store.stats()
            total = int(st.get("total_bytes") or 0)
            budget = int(st.get("max_bytes") or 0)
        except OSError:
            return True
        if not budget:
            return True
        return total < HEADROOM_FRACTION * budget

    def offer(self, search_body: dict):
        """Queue the neighbor-warming job of one served sweep query.
        Never blocks and never raises into the serving path."""
        if self.degraded is not None:
            try:
                degraded = bool(self.degraded())
            except Exception:
                degraded = False  # never let health checks break serving
            if degraded:
                self._count("skipped_degraded",
                            outcome="skipped_degraded")
                return
        if self.route_filter is not None:
            try:
                owned = bool(self.route_filter(search_body))
            except Exception:
                owned = True  # never let routing break serving
            if not owned:
                self._count("skipped_remote", outcome="skipped_remote")
                return
        try:
            spec = neighbor_spec(search_body)
        except Exception:
            return
        # remember the original axis values so warm_cells can separate
        # grid from neighbors after the expansion
        from simumax_tpu_torch.service.pool import search_kwargs

        kw = search_kwargs(search_body)
        spec["_orig"] = {
            "tp": sorted(kw["tp_list"]), "cp": sorted(kw["cp_list"]),
            "ep": sorted(kw["ep_list"]), "pp": sorted(kw["pp_list"]),
            "zero": sorted(kw["zero_list"]),
        }
        digest = hashlib.sha256(canonical_bytes(spec)).hexdigest()
        with self._lock:
            self.counters["offered"] += 1
            if digest in self._recent_set:
                dup = True
            else:
                dup = False
                self._recent.append(digest)
                self._recent_set.add(digest)
                while len(self._recent) > RECENT_SPECS:
                    self._recent_set.discard(self._recent.pop(0))
        if dup:
            self._count("duplicate", outcome="duplicate")
            return
        try:
            self._q.put_nowait(spec)
        except _queue.Full:
            self._count("dropped", outcome="dropped")

    def _loop(self):
        while True:
            spec = self._q.get()
            if spec is None:
                return
            self._busy = True
            try:
                if not self._headroom_ok():
                    self._count("skipped_headroom",
                                outcome="skipped_headroom")
                    continue
                try:
                    warmed = int(self.runner(spec) or 0)
                except Exception:
                    self._count("errors", outcome="error")
                    continue
                self._count("warmed_jobs", outcome="warmed")
                if warmed:
                    self._count("warmed_cells", warmed)
                    self.registry.counter(
                        "warmer_cells_total").inc(warmed)
            finally:
                self._busy = False

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty and the in-flight job (if
        any) finished — test/bench synchronization, not a serving
        API."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.empty() and not self._busy:
                # settle tick: the loop flips _busy between get() and
                # the try, so re-check once after a short sleep
                time.sleep(0.05)
                if self._q.empty() and not self._busy:
                    return True
            time.sleep(0.02)
        return False

    def close(self):
        self._closed = True
        try:
            self._q.put_nowait(None)
        except _queue.Full:
            pass

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, queued=self._q.qsize())

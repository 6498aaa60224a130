"""The ``Planner`` facade (L9): every query surface — CLI subcommands,
the HTTP server, the Streamlit app — routes estimate / explain / search
/ faults / simulate queries through one object that

* resolves configs (names, paths, inline dicts, or config objects) to
  fully-resolved config objects,
* computes the content-addressed cache key of the query (see
  ``service/store.py`` and ``docs/service.md``): the canonical hash of
  the resolved (model, strategy, system incl. calibration provenance,
  package code-version) tuple,
* serves the persistent store when it can, evaluates otherwise, and
  **single-flights** identical concurrent queries — N threads asking
  the same cold question produce exactly one evaluation, the rest wait
  for the leader's result.

Responses are *canonical payloads* (``store.canonical``): the same
JSON-safe normalization is applied whether the answer came from the
store or a fresh evaluation, so cache-on and cache-off responses are
bit-identical — the same parity discipline the batched sweep kernel
holds against the scalar oracle (``docs/search.md``), applied to the
cache layer.

Sweeps decompose per grid cell: ``Planner.search`` (and the CLI's
``search --cache-dir``) checks the store for every cell of the grid, so
an overlapping grid re-evaluates only the delta cells (the rest are
served, marked ``status=cached`` in the audit CSV, and skipped by the
journal).

Copy of the JAX package's ``service/planner.py`` with its import paths
changed and one addition: :class:`Planner` takes ``device`` (``"cuda"``
by default), where its queries run the port's kernels. ``faults`` and
``fleet`` replay with ``ReplayOptions(device=device)`` (the replay
kernel on the card, its plain version for ``"cpu"``), and ``search``
passes it to the strategy search, whose batched engine folds there;
:func:`save_batched_profiles` reads the scorer of that device. Like
``jobs``, ``device`` is never part of a query's identity: every
backend's answer is equal as JSON. Nothing gives way to the CPU when
the card or a kernel fails: the query fails. The ``docs/`` this module
names are the JAX package's.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from simumax_tpu_torch.service.store import (
    ContentStore,
    canonical,
    code_version,
    content_key,
    normalized,
)


class ConfigLoader:
    """Memoized config resolution for a hot query path.

    Registry name -> path lookups and parsed config JSON are cached,
    validated per call against the file's (mtime, size) — an edited
    config re-reads; a renamed/removed one re-resolves. Every call
    still builds a *fresh* config object from a deep copy of the
    parsed dict: estimates mutate their configs (vocab padding,
    hit/miss recording), so object sharing between queries would
    corrupt cache keys."""

    def __init__(self):
        self._lock = threading.Lock()
        self._paths: Dict[Tuple[str, str], str] = {}
        self._data: Dict[Tuple[str, float, int], dict] = {}

    def load(self, kind: str, value, deps=None):
        """Resolve one config. ``deps`` (a list) collects the
        ``(path, mtime_ns, size)`` stamp of every config *file* the
        resolution read — the freshness dependencies a response cache
        keyed on the raw request body must validate (inline dicts and
        config objects carry their content in the request itself, so
        they add no dependency)."""
        import copy
        import json
        import os

        from simumax_tpu_torch.core import config as _config
        from simumax_tpu_torch.core.errors import UnknownConfigError

        cls, reg_dir, getter = {
            "model": (_config.ModelConfig, "models",
                      _config.get_model_config),
            "strategy": (_config.StrategyConfig, "strategy",
                         _config.get_strategy_config),
            "system": (_config.SystemConfig, "system",
                       _config.get_system_config),
        }[kind]
        if not isinstance(value, str):
            if isinstance(value, cls):
                # never hand the caller's object to an evaluation:
                # estimates mutate configs in place (vocab padding,
                # hit/miss recording), which would both corrupt the
                # caller's state and make the same logical query hash
                # to a different key next time
                return copy.deepcopy(value)
            from simumax_tpu_torch.perf import _resolve

            return _resolve(value, cls, getter)
        if os.path.isfile(value):
            path = value
        else:
            with self._lock:
                path = self._paths.get((kind, value))
            if path is None or not os.path.isfile(path):
                reg = _config._registry(reg_dir)
                if value not in reg:
                    raise UnknownConfigError(kind, value, available=reg)
                path = reg[value]
                with self._lock:
                    self._paths[(kind, value)] = path
        st = os.stat(path)
        if deps is not None:
            deps.append((path, st.st_mtime_ns, st.st_size))
        ck = (path, st.st_mtime_ns, st.st_size)
        with self._lock:
            data = self._data.get(ck)
        if data is None:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            with self._lock:
                # drop stale generations of the same file; pop() so
                # two threads racing the same reload never KeyError
                for k in [k for k in self._data if k[0] == path]:
                    self._data.pop(k, None)
                self._data[ck] = data
        obj = cls.init_from_dict(copy.deepcopy(data))
        obj.config_path = path
        return obj


def query_identity(kind: str, model=None, strategy=None, system=None,
                   **extra) -> dict:
    """The content identity of one query: kind + package code-version +
    the fully resolved config dicts (``to_dict`` — registry names,
    explicit paths and inline dicts that resolve to the same content
    hash the same; ``config_path`` is not part of a config's identity).
    The system dict includes the calibration efficiency tables AND the
    provenance stamp, so recalibration or a provenance swap invalidates
    every dependent key."""
    ident: Dict[str, Any] = {
        "kind": kind,
        "code_version": code_version(),
    }
    if model is not None:
        ident["model"] = model.to_dict()
    if strategy is not None:
        ident["strategy"] = strategy.to_dict()
    if system is not None:
        ident["system"] = system.to_dict()
    ident.update(extra)
    return ident


def replay_coverage(diagnostics, hits: dict, misses: dict):
    """Re-record efficiency-table coverage from a cached payload into a
    live Diagnostics collector, so ``--strict`` and the diagnostics
    report behave identically cache-on and cache-off."""
    diagnostics.merge_coverage(
        {k: set(v) for k, v in (hits or {}).items()},
        {k: set(v) for k, v in (misses or {}).items()},
    )


def batched_profiles_key(model, system) -> str:
    """The profiles-namespace store key of a (model, system) pair.
    Must be computed BEFORE any sweep runs: evaluations mutate the
    model in place (``maybe_pad_vocab_size``), so a key derived
    afterwards would never match the one the next fresh process
    computes."""
    return content_key(query_identity("profiles", model=model,
                                      system=system))


def load_batched_profiles(store: Optional[ContentStore], model, system,
                          key: Optional[str] = None):
    """Seed the batched sweep engine's block-kind profile cache from
    the store (namespace ``profiles``), so a warm process skips profile
    construction entirely. Returns the number of seeded profiles."""
    if store is None:
        return 0
    from simumax_tpu_torch.search import executor as _executor
    from simumax_tpu_torch.search.searcher import _model_system_key

    seed = store.get("profiles", key or batched_profiles_key(model,
                                                             system))
    if not seed:
        return 0
    _executor._PROFILE_SEED[_model_system_key(model, system)] = seed
    return len(seed)


def save_batched_profiles(store: Optional[ContentStore], model, system,
                          key: Optional[str] = None, device: str = "cuda"):
    """Persist the block-kind profiles the sweep just built (best
    effort: serial/fork-parent scorers only — pool workers die with
    their caches; an unwritable store is skipped, never fatal). Pass
    the ``key`` computed by :func:`batched_profiles_key` before the
    sweep — the sweep mutates the model, so deriving it here would
    store under an unreachable key. ``device`` names the scorer the
    sweep folded with. Returns the number saved."""
    if store is None:
        return 0
    from simumax_tpu_torch.search import executor as _executor
    from simumax_tpu_torch.search.searcher import _model_system_key

    mkey = _model_system_key(model, system)
    scorer = _executor._SCORERS.get((mkey, device))
    if scorer is None or not scorer._kind_cache:
        return 0
    seeded = _executor._PROFILE_SEED.get(mkey) or {}
    if len(scorer._kind_cache) <= len(seeded):
        return 0  # nothing new since the seed
    try:
        store.put("profiles",
                  key or batched_profiles_key(model, system),
                  dict(scorer._kind_cache), fmt="pickle")
    except OSError:
        return 0
    return len(scorer._kind_cache)


class _Flight:
    """One in-flight evaluation other threads can wait on."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class Planner:
    """Cache-backed, single-flighted facade over the analytical stack.

    ``enabled=False`` (or ``store=None`` with ``cache_dir=None`` and
    ``enabled=False``) turns the planner into a pass-through evaluator
    that still returns canonical payloads — the cache-off oracle the
    parity tests and the bench compare against.

    ``device`` is where the fault replay and the search's folds run:
    ``"cuda"`` launches the kernels (and fails without a card),
    ``"cpu"`` runs their plain versions.
    """

    def __init__(self, store: Optional[ContentStore] = None,
                 cache_dir: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 enabled: bool = True,
                 registry=None,
                 cell_flights=None,
                 device: str = "cuda"):
        from simumax_tpu_torch.observe.telemetry import get_registry

        #: metrics registry this planner (and the store it builds)
        #: mirrors its counters into — the ``/metrics`` plane; the
        #: per-instance dict below stays the ``stats()`` source
        self.registry = registry or get_registry()
        self.device = device
        if store is None and enabled:
            kwargs = {} if max_bytes is None else {"max_bytes": max_bytes}
            store = ContentStore(cache_dir, registry=self.registry,
                                 **kwargs)
        self.store = store if enabled else None
        self.enabled = enabled and self.store is not None
        self._lock = threading.Lock()
        self._inflight: Dict[Tuple[str, str], _Flight] = {}
        self.counters: Dict[str, int] = {
            "evaluations": 0, "hits": 0, "misses": 0,
            "singleflight_waits": 0,
        }
        self._loader = ConfigLoader()
        #: in-flight sweep-cell coalescing across this planner's
        #: concurrent sweeps (service/coalesce.py): overlapping grids
        #: share cells that are being evaluated, not just stored ones.
        #: A fleet node swaps in the wire-level table
        #: (service/node.py FleetCellFlightTable — same contract,
        #: coordinated through each cell's ring owner); pool workers
        #: in a fleet are built with one directly (``cell_flights=``).
        from simumax_tpu_torch.service.coalesce import CellFlightTable

        self.cell_flights = cell_flights if cell_flights is not None \
            else CellFlightTable(registry=self.registry)

    # -- plumbing ----------------------------------------------------------
    def _count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        self.registry.counter("planner_ops_total", op=name).inc(n)

    def _cached(self, namespace: str, identity: dict,
                compute: Callable[[], Any],
                raw: bool = False) -> Tuple[Any, bool, str]:
        """Serve ``identity`` from the store or evaluate exactly once
        (single-flight). Returns ``(payload, hit, key)``; the payload
        is canonical in every path. ``raw=True`` returns the canonical
        JSON *bytes* instead of the parsed payload — on a hit these are
        the stored bytes verbatim (no parse + re-dump), and the store
        serialization is the same function as the fresh-evaluation
        serialization, so the bytes are identical either way."""
        from simumax_tpu_torch.observe.telemetry import get_tracer
        from simumax_tpu_torch.service.store import canonical_bytes

        tracer = get_tracer()
        key = content_key(identity)
        if not self.enabled:
            self._count("evaluations")
            with tracer.span("evaluate", namespace=namespace,
                             key=key[:16]):
                payload = normalized(compute())
            return (canonical_bytes(payload) if raw else payload), \
                False, key
        with tracer.span("store_lookup", namespace=namespace,
                         key=key[:16]):
            got = self.store.get_bytes(namespace, key) if raw \
                else self.store.get(namespace, key)
        if got is not None:
            self._count("hits")
            return got, True, key
        flight_key = (namespace, key)
        with self._lock:
            flight = self._inflight.get(flight_key)
            leader = flight is None
            if leader:
                flight = _Flight()
                self._inflight[flight_key] = flight
        if not leader:
            self._count("singleflight_waits")
            with tracer.span("singleflight_wait", namespace=namespace,
                             key=key[:16]):
                flight.event.wait()
            if flight.error is not None:
                raise flight.error
            result = flight.result
            return (canonical_bytes(result) if raw else result), \
                True, key
        try:
            self._count("misses")
            self._count("evaluations")
            with tracer.span("evaluate", namespace=namespace,
                             key=key[:16]):
                payload = normalized(compute())
            try:
                # best-effort: an unwritable cache dir (read-only HOME,
                # full disk) must not fail a query that evaluated fine
                self.store.put(namespace, key, payload)
            except OSError:
                self._count("put_errors")
            flight.result = payload
        except BaseException as exc:
            flight.error = exc
            raise
        finally:
            flight.event.set()
            with self._lock:
                self._inflight.pop(flight_key, None)
        return (canonical_bytes(payload) if raw else payload), \
            False, key

    def replay_options(self):
        """The fault replay's options for this planner's queries."""
        from simumax_tpu_torch.simulator.faults import ReplayOptions

        return ReplayOptions(device=self.device)

    # -- queries -----------------------------------------------------------
    def estimate(self, model, strategy, system,
                 with_meta: bool = False, raw: bool = False):
        """Full analytical estimate of one configuration: the
        ``PerfLLM.analysis`` result (minus the run-scoped diagnostics
        block) plus efficiency coverage, realized collective
        bandwidths, and — for eligible even-pp layouts — the DualPipe
        projection."""
        deps: list = []
        model = self._loader.load("model", model, deps=deps)
        strategy = self._loader.load("strategy", strategy, deps=deps)
        system = self._loader.load("system", system, deps=deps)
        identity = query_identity("estimate", model=model,
                                  strategy=strategy, system=system)

        def compute():
            from simumax_tpu_torch.perf import PerfLLM

            perf = PerfLLM().configure(strategy, model, system)
            perf.run_estimate()
            result = perf.analysis(verbose=False)
            # run-scoped (timestamps, run_id): not part of the answer
            result.pop("diagnostics", None)
            result["efficiency_hits"] = perf.system.hit_efficiency
            result["real_comm_bw"] = perf.system.real_comm_bw
            st = perf.strategy
            result["dualpp"] = (
                perf.analysis_dualpp()
                if (st.pp_size >= 2 and st.pp_size % 2 == 0
                    and st.vp_size == 1)
                else None
            )
            return result

        payload, hit, key = self._cached("estimate", identity, compute,
                                         raw=raw)
        if with_meta:
            return payload, {"cache": "hit" if hit else "miss",
                             "key": key, "deps": deps}
        return payload

    def explain(self, model, strategy, system, with_meta: bool = False,
                raw: bool = False):
        """Cost-attribution ledger of one configuration: the full
        ledger dict (``observe/ledger.py`` schema, the ``diff`` input
        format) plus the aggregated per-op rows the top-N table
        renders from."""
        deps: list = []
        model = self._loader.load("model", model, deps=deps)
        strategy = self._loader.load("strategy", strategy, deps=deps)
        system = self._loader.load("system", system, deps=deps)
        identity = query_identity("explain", model=model,
                                  strategy=strategy, system=system)

        def compute():
            from simumax_tpu_torch.perf import PerfLLM

            perf = PerfLLM().configure(strategy, model, system)
            perf.run_estimate()
            led = perf.ledger()
            return {"ledger": led.to_dict(), "op_rows": led.op_rows()}

        payload, hit, key = self._cached("explain", identity, compute,
                                         raw=raw)
        if with_meta:
            return payload, {"cache": "hit" if hit else "miss",
                             "key": key, "deps": deps}
        return payload

    def batch_split(self, model, strategy, system, global_batch_size: int,
                    with_meta: bool = False):
        """Fixed-GBS (mbs, mbc) search at one layout (the app's search
        tab): the best fitting row, or None."""
        model = self._loader.load("model", model)
        strategy = self._loader.load("strategy", strategy)
        system = self._loader.load("system", system)
        identity = query_identity("batch_split", model=model,
                                  strategy=strategy, system=system,
                                  gbs=global_batch_size)

        def compute():
            from simumax_tpu_torch.search import search_micro_batch_config

            row = search_micro_batch_config(
                strategy, model, system,
                global_batch_size=global_batch_size,
            )
            return {"row": row}

        payload, hit, key = self._cached("sweep", identity, compute)
        if with_meta:
            return payload, {"cache": "hit" if hit else "miss",
                             "key": key}
        return payload

    def simulate(self, model, strategy, system, save_path=None,
                 granularity: str = "chunk", with_meta: bool = False,
                 raw: bool = False, **kwargs):
        """Discrete-event replay summary. Cached (namespace ``des``)
        only when no artifact directory is requested — artifact files
        live outside the store."""
        deps: list = []
        model = self._loader.load("model", model, deps=deps)
        strategy = self._loader.load("strategy", strategy, deps=deps)
        system = self._loader.load("system", system, deps=deps)

        def compute(path=save_path):
            from simumax_tpu_torch.observe.telemetry import get_tracer
            from simumax_tpu_torch.perf import PerfLLM

            perf = PerfLLM().configure(strategy, model, system)
            perf.run_estimate()
            with get_tracer().span("des_replay",
                                   granularity=granularity):
                result = perf.simulate(path, granularity=granularity,
                                       **kwargs)
            result.pop("critical_path", None)
            return result

        if save_path is not None:
            from simumax_tpu_torch.service.store import canonical_bytes

            payload = normalized(compute())
            if raw:
                payload = canonical_bytes(payload)
            self._count("evaluations")
            meta = {"cache": "bypass", "key": ""}
        else:
            identity = query_identity(
                "simulate", model=model, strategy=strategy,
                system=system, granularity=granularity,
                options=canonical(kwargs),
            )
            payload, hit, key = self._cached("des", identity, compute,
                                             raw=raw)
            meta = {"cache": "hit" if hit else "miss", "key": key}
        if with_meta:
            meta["deps"] = deps
            return payload, meta
        return payload

    def faults(self, model, strategy, system, monte_carlo: int = 0,
               seed: int = 0, horizon_steps: int = 50,
               granularity: str = "chunk", with_meta: bool = False,
               raw: bool = False):
        """Seeded Monte-Carlo goodput analysis (deterministic in the
        seed, hence cacheable; namespace ``des``)."""
        deps: list = []
        model = self._loader.load("model", model, deps=deps)
        strategy = self._loader.load("strategy", strategy, deps=deps)
        system = self._loader.load("system", system, deps=deps)
        identity = query_identity(
            "faults", model=model, strategy=strategy, system=system,
            monte_carlo=monte_carlo, seed=seed,
            horizon_steps=horizon_steps, granularity=granularity,
        )

        def compute():
            from simumax_tpu_torch.perf import PerfLLM

            perf = PerfLLM().configure(strategy, model, system)
            perf.run_estimate()
            return perf.analyze_faults(
                n_scenarios=monte_carlo or 16, seed=seed,
                horizon_steps=horizon_steps, granularity=granularity,
                options=self.replay_options(),
            )

        payload, hit, key = self._cached("des", identity, compute,
                                         raw=raw)
        if with_meta:
            return payload, {"cache": "hit" if hit else "miss",
                             "key": key, "deps": deps}
        return payload

    def fleet(self, trace, jobs: int = 0,
              elastic: Optional[bool] = None, explain: bool = False,
              with_meta: bool = False, raw: bool = False):
        """Multi-job fleet-trace walk (``fleet/sim.py``,
        docs/fleet.md): deterministic in the trace, hence cacheable
        (namespace ``fleet``). Template configs resolve through the
        loader so an edited registry config or recalibration
        invalidates the key; ``jobs`` (costing fan-out) is a serving
        detail and never part of the identity — serial and parallel
        walks are bit-identical by the fleet contract. ``explain``
        attaches the fleet forensics payload
        (``observe/fleetledger.py``) and IS part of the identity:
        the base report stays byte-identical either way, but the
        cached payloads differ by the ``explain`` key."""
        import copy as _copy

        from simumax_tpu_torch.fleet.trace import FleetTrace

        # deep copy: FleetTrace.load passes FleetTrace objects
        # through, and the template refs below are replaced with
        # loaded configs — the caller's object (and the identity of
        # its repeat queries) must stay untouched
        tr = _copy.deepcopy(FleetTrace.load(trace))
        trace_dict = tr.to_dict()
        deps: list = []
        resolved: Dict[str, Any] = {}
        for name in sorted(tr.templates):
            t = tr.templates[name]
            m = self._loader.load("model", t.model, deps=deps)
            st = self._loader.load("strategy", t.strategy, deps=deps)
            sysc = self._loader.load("system", t.system, deps=deps)
            resolved[name] = {
                "model": m.to_dict(),
                "strategy": st.to_dict(),
                "system": sysc.to_dict(),
            }
            # the walk consumes the loaded objects (template
            # ``overrides`` still apply on top at build time)
            t.model, t.strategy, t.system = m, st, sysc
        identity = query_identity(
            "fleet", trace=canonical(trace_dict),
            templates=resolved, elastic=elastic, explain=explain,
        )

        def compute():
            from simumax_tpu_torch.fleet.sim import simulate_fleet

            return simulate_fleet(tr, jobs=jobs, elastic=elastic,
                                  explain=explain,
                                  options=self.replay_options())

        payload, hit, key = self._cached("fleet", identity, compute,
                                         raw=raw)
        if with_meta:
            return payload, {"cache": "hit" if hit else "miss",
                             "key": key, "deps": deps}
        return payload

    def search(self, model, system, global_batch_size: int,
               base_strategy="tp1_pp1_dp8_mbs1", world: int = 0,
               seq_len: int = 0, tp_list=(1, 2, 4, 8),
               pp_list=(1, 2, 4), ep_list=(1,), cp_list=(1,),
               zero_list=(1,), topk: int = 5, engine: str = "scalar",
               verify_topk: Optional[int] = None, jobs: int = 1,
               csv_path: Optional[str] = None,
               journal_path: Optional[str] = None,
               on_cell: Optional[Callable] = None,
               diagnostics=None, with_meta: bool = False):
        """Strategy sweep decomposed per grid cell against the store:
        previously-scored cells (any grid, any process) are served, and
        only the delta is evaluated. Returns the ranked rows plus the
        sweep's cell accounting."""
        from simumax_tpu_torch.core.records import Diagnostics
        from simumax_tpu_torch.search import search_best_parallel_strategy

        deps: list = []
        model = self._loader.load("model", model, deps=deps)
        system = self._loader.load("system", system, deps=deps)
        base = self._loader.load("strategy", base_strategy, deps=deps)
        if world:
            base.world_size = world
        if seq_len:
            base.seq_len = seq_len
        diag = diagnostics if diagnostics is not None else Diagnostics()
        store = self.store if self.enabled else None
        profiles_key = None
        if engine == "batched":
            # key pinned pre-sweep: evaluations mutate the model
            profiles_key = batched_profiles_key(model, system)
            load_batched_profiles(store, model, system,
                                  key=profiles_key)
        self._count("evaluations")
        from simumax_tpu_torch.observe.telemetry import get_tracer

        with get_tracer().span("sweep", engine=engine):
            rows = search_best_parallel_strategy(
                base, model, system, global_batch_size,
                tp_list=tuple(tp_list), pp_list=tuple(pp_list),
                ep_list=tuple(ep_list), cp_list=tuple(cp_list),
                zero_list=tuple(zero_list), topk=topk,
                csv_path=csv_path, journal_path=journal_path,
                diagnostics=diag, jobs=jobs, engine=engine,
                verify_topk=verify_topk, store=store, on_cell=on_cell,
                cell_flights=self.cell_flights if store is not None
                else None, device=self.device,
            )
        if engine == "batched":
            save_batched_profiles(store, model, system,
                                  key=profiles_key, device=self.device)
        c = diag.counters
        # the response carries only run-INVARIANT accounting: a warm
        # sweep must answer byte-identically to a cache-off one, so the
        # serving-dependent counters (cached/evaluated) travel in the
        # meta (-> X-SimuMax headers, stream "serving" line, /stats),
        # never in the payload
        payload = normalized({
            "rows": rows,
            "cells": {
                "total": int(c.get("sweep_cells_total", 0)),
                "pruned": int(c.get("sweep_cells_pruned", 0)),
                "deduped": int(c.get("sweep_cells_deduped", 0)),
                "quarantined": int(
                    c.get("sweep_cells_quarantined", 0)),
            },
        })
        cached = int(c.get("sweep_cells_cached", 0))
        evaluated = int(c.get("sweep_cells_evaluated", 0))
        coalesced = int(c.get("sweep_cells_coalesced", 0))
        self._count("hits", cached)
        self._count("misses", evaluated)
        if coalesced:
            self._count("cells_coalesced", coalesced)
        if with_meta:
            hit = evaluated == 0 and (cached > 0 or coalesced > 0)
            return payload, {
                "cache": "hit" if hit else "miss", "key": "",
                "cells_cached": cached, "cells_evaluated": evaluated,
                "cells_coalesced": coalesced,
                "cells_replayed": int(
                    c.get("sweep_cells_replayed", 0)),
                "deps": deps,
            }
        return payload

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        out = {"enabled": self.enabled, "planner": counters}
        out["store"] = self.store.stats() if self.store else None
        out["coalesce"] = self.cell_flights.stats()
        return out

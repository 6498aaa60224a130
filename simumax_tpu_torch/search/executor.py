"""Sweep execution engine (L7): evaluates scheduled sweep cells either
serially or fanned out across a ``ProcessPoolExecutor`` worker pool,
preserving the serial sweep's fault-isolation contract bit-for-bit.

Guarantees, identical in both modes:

* every cell ends in exactly one of ``ok`` / ``empty`` / ``error``;
* a crashing cell becomes an ``error`` outcome (quarantined upstream as
  a ``status=error`` CSV row + Diagnostics entry), never a dead sweep;
* a hanging cell is interrupted by the per-candidate deadline — in a
  pool worker the cell runs on the worker process's main thread, so the
  SIGALRM deadline applies *inside* the worker; a pool-level hard
  backstop (``HARD_TIMEOUT_FACTOR`` x the deadline) additionally kills
  and restarts the pool if a worker wedges somewhere SIGALRM cannot
  reach (native code), quarantining the stuck cells;
* results are keyed by the cell's deterministic grid index, so the
  orchestrator merges them back in grid order and parallel sweeps rank,
  dedup, and journal exactly like serial ones.

Workers keep a per-process result cache keyed by ``_strategy_key``,
seeded from the parent's cache at pool start (so a warm
``StrategySearcher.cache`` keeps paying off under ``--jobs``), and ship
only the *new* entries back with each result; the parent merges them
into the caller's (bounded) cache, so memoization survives the process
boundary in both directions. Worker-side Diagnostics events and efficiency-table
coverage are shipped and merged the same way.

Copy of the JAX package's ``search/executor.py`` with its import paths
changed and three differences: the batched scorer is built for a
``device`` (``_Env.device``, part of the scorer cache's key); the pool
forks its workers unless this process has initialised CUDA, whose
context a forked child cannot use, and then spawns them; and a
:class:`~simumax_tpu_torch.torchref.kernels.KernelError` (the fold
kernel, its build or its copies failed) is never quarantined as a
``status=error`` row: it stops the sweep, serial or pooled.
"""

from __future__ import annotations

import concurrent.futures as _cf
import multiprocessing as _mp
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from simumax_tpu_torch.core.records import Diagnostics
from simumax_tpu_torch.search.prune import SweepCell, make_cell_strategy
from simumax_tpu_torch.torchref.kernels import KernelError

#: bound of the cross-cell result cache (entries); FIFO-evicted beyond
RESULT_CACHE_MAX = 65536
#: pool backstop: a worker running one cell longer than this multiple of
#: the per-candidate deadline is presumed wedged beyond SIGALRM's reach
HARD_TIMEOUT_FACTOR = 5.0
#: extra grace (seconds) on top of the factor (pool queueing, pickling)
HARD_TIMEOUT_SLACK = 30.0


class BoundedCache(dict):
    """Insertion-ordered dict with FIFO eviction beyond ``maxsize`` —
    keeps the sweep's cross-cell result cache bounded however many
    cells a long campaign evaluates."""

    def __init__(self, maxsize: int = RESULT_CACHE_MAX):
        super().__init__()
        self.maxsize = maxsize

    def __setitem__(self, key, value):
        if key not in self and len(self) >= self.maxsize:
            del self[next(iter(self))]
        super().__setitem__(key, value)

    def update(self, other):  # keep eviction on bulk merges
        for k, v in other.items():
            self[k] = v


@dataclass
class CellOutcome:
    cell: SweepCell
    status: str  # ok | empty | error
    row: Optional[dict]
    error: Optional[dict]


@dataclass
class _Env:
    """Everything a cell evaluation needs besides the cell itself."""

    base_strategy: object
    model: object
    system: object
    global_batch_size: int
    project_dualpp: bool
    candidate_timeout: Optional[float]
    #: simulator-backed evaluation: fitting candidates get a
    #: discrete-event ``sim_ms`` cross-check; a SimulationError
    #: quarantines the cell like any other candidate failure
    simulate: bool = False
    #: "scalar" walks the PerfLLM object graph per candidate; "batched"
    #: scores the cell's candidate batch with the vectorized kernel
    #: (``search/batched.py``) and falls back to the scalar path per
    #: cell when the kernel does not model the configuration
    engine: str = "scalar"
    #: where the batched engine's fold kernel runs: "cuda" (the card)
    #: or "cpu" (its plain version)
    device: str = "cuda"


#: per-process cache of BatchedScorer instances (the kernels hold
#: unpicklable closures, so each pool worker builds its own lazily)
_SCORERS: dict = {}

#: block-kind profile seed per (model, system) key, set by the planner
#: from the persistent store (``service/planner.py::
#: load_batched_profiles``) before a sweep: a warm process skips
#: profile construction entirely. Under the fork start method pool
#: workers inherit the seed copy-on-write.
_PROFILE_SEED: dict = {}


def _batched_scorer(model, system, device="cuda"):
    from simumax_tpu_torch.search.batched import BatchedScorer
    from simumax_tpu_torch.search.searcher import _model_system_key

    key = (_model_system_key(model, system), device)
    got = _SCORERS.get(key)
    if got is None:
        if len(_SCORERS) > 2:
            _SCORERS.clear()
        got = BatchedScorer(model, system, device=device)
        seed = _PROFILE_SEED.get(key[0])
        if seed:
            # profile values are pure functions of their content key
            # (deterministic rebuilds), so seeding can never change a
            # score — it only skips the construction
            got._kind_cache.update(seed)
        _SCORERS[key] = got
    return got


def _strategy_spec(base, strategy, gib_margin: float) -> dict:
    """JSON-safe reconstruction recipe of a batched row's exact winning
    candidate: the strategy fields differing from the sweep's base plus
    the feasibility margin its family used — enough for the scalar
    oracle to re-verify the row (``searcher`` top-k verification)."""
    import dataclasses

    fields = {}
    for f in dataclasses.fields(type(strategy)):
        a, b = getattr(strategy, f.name), getattr(base, f.name)
        if a != b:
            fields[f.name] = a
    return {"fields": fields, "gib_margin": gib_margin}


def _evaluate_cell_guarded(cell: SweepCell, env: _Env, cache,
                           diagnostics) -> tuple:
    """Evaluate one cell under the per-candidate deadline. Never raises:
    returns (status, row, err_dict, exception)."""
    from simumax_tpu_torch.observe.telemetry import get_tracer

    # observe-only span (no-op outside a traced request/command): one
    # per evaluated cell, tagged with the engine that scored it
    with get_tracer().span("evaluate_cell", cell=cell.key,
                           engine=env.engine):
        return _evaluate_cell_guarded_inner(cell, env, cache,
                                            diagnostics)


def _evaluate_cell_guarded_inner(cell: SweepCell, env: _Env, cache,
                                 diagnostics) -> tuple:
    # late import: executor is imported by searcher at module load
    from simumax_tpu_torch.search import searcher as _searcher

    st = make_cell_strategy(
        env.base_strategy, cell.tp, cell.cp, cell.ep, cell.pp, cell.zero
    )
    try:
        with _searcher._candidate_deadline(
            env.candidate_timeout, cell.key, diagnostics=diagnostics
        ):
            row = None
            batched_done = False
            fallback_reason = None
            if env.engine == "batched":
                from simumax_tpu_torch.search.batched import UnsupportedBatched

                if env.project_dualpp or env.simulate:
                    # both need the built scalar estimate — fall back
                    # per cell, counted like any other fallback (no
                    # whole-sweep downgrade)
                    fallback_reason = ("project_dualpp"
                                       if env.project_dualpp
                                       else "simulate")
                else:
                    scorer = _batched_scorer(env.model, env.system,
                                             env.device)
                    stats_before = dict(scorer.stats)
                    try:
                        got = scorer.evaluate_cell(
                            st, cell.rc, env.model, env.global_batch_size
                        )
                        batched_done = True
                    except UnsupportedBatched as exc:
                        fallback_reason = str(exc)  # scalar path below
                if fallback_reason is not None:
                    diagnostics.count("sweep_batched_fallbacks")
                    diagnostics.count(
                        f"sweep_batched_fallback[{fallback_reason}]")
                if batched_done:
                    diagnostics.count("sweep_cells_batched")
                    # per-cell scoring-telemetry deltas: additive so the
                    # pool merge (and the serial path) can sum them;
                    # max_batch keeps max semantics via _merge_counters
                    for k, v in scorer.stats.items():
                        key = f"sweep_batched_{k}"
                        if k == "max_batch":
                            diagnostics.counters[key] = max(
                                diagnostics.counters.get(key, 0), v)
                        else:
                            delta = v - stats_before.get(k, 0)
                            if delta:
                                diagnostics.count(key, delta)
                if batched_done and got is not None:
                    row, strategy, margin = got
                    row["strategy_spec"] = _strategy_spec(
                        env.base_strategy, strategy, margin
                    )
            if not batched_done:
                row = _searcher._evaluate_sweep_cell(
                    st, cell.rc, env.model, env.system,
                    env.global_batch_size, cache, env.project_dualpp,
                    simulate=env.simulate,
                )
                if row is not None and fallback_reason is not None:
                    # audit trail: this row came from the scalar
                    # fallback path (CSV column + journal field)
                    row["batched_fallback"] = fallback_reason
    except KernelError:
        raise  # the fold kernel failed: stop the sweep
    except Exception as exc:  # quarantine upstream, keep sweeping
        err = {
            "error_type": type(exc).__name__,
            "error_msg": str(exc)[:500],
        }
        return ("error", None, err, exc)
    if row is not None:
        row.setdefault("status", "ok")
        return ("ok", row, None, None)
    return ("empty", None, None, None)


def run_cells(
    cells: List[SweepCell],
    *,
    base_strategy,
    model,
    system,
    global_batch_size: int,
    project_dualpp: bool = False,
    candidate_timeout: Optional[float] = None,
    cache=None,
    diagnostics: Optional[Diagnostics] = None,
    jobs: int = 1,
    on_done: Optional[Callable[[CellOutcome], None]] = None,
    simulate: bool = False,
    engine: str = "scalar",
    device: str = "cuda",
) -> Dict[int, CellOutcome]:
    """Evaluate every cell; returns {cell.idx: CellOutcome}.

    ``on_done`` fires as each cell finishes (journal checkpoint hook) —
    completion order in pool mode, grid order serially. ``jobs <= 1``
    (or a single cell) runs serially on the calling thread.
    ``engine="batched"`` scores cells with the vectorized kernel,
    falling back to the scalar path per cell for configurations the
    kernel does not lower; ``device`` is where its fold kernel runs
    (``"cpu"``: the kernel's plain version). A
    :class:`~simumax_tpu_torch.torchref.kernels.KernelError` stops the
    run."""
    cache = BoundedCache() if cache is None else cache
    diagnostics = diagnostics if diagnostics is not None else Diagnostics()
    env = _Env(base_strategy, model, system, global_batch_size,
               project_dualpp, candidate_timeout, simulate, engine,
               device)
    jobs = max(1, int(jobs or 1))
    if jobs > 1 and len(cells) > 1:
        return _run_cells_pool(cells, env, cache, diagnostics, jobs, on_done)
    return _run_cells_serial(cells, env, cache, diagnostics, on_done)


def _run_cells_serial(cells, env, cache, diagnostics, on_done):
    outcomes: Dict[int, CellOutcome] = {}
    for cell in cells:
        status, row, err, exc = _evaluate_cell_guarded(
            cell, env, cache, diagnostics
        )
        if exc is not None:
            diagnostics.record_exception(
                exc, category="quarantine",
                candidate=cell.key, phase="search",
            )
        out = CellOutcome(cell, status, row, err)
        outcomes[cell.idx] = out
        if on_done:
            on_done(out)
    return outcomes


# --------------------------------------------------------------------------
# Pool mode
# --------------------------------------------------------------------------

#: per-worker-process state, filled by the pool initializer
_WORKER_ENV: dict = {}

#: parent-side cache snapshot set just before pool creation — under the
#: default fork context workers inherit it copy-on-write, avoiding an
#: O(jobs x cache_size) pickle per pool (re)start; under spawn it is
#: empty in the child and seeding degrades to a cold (still correct)
#: worker cache
_SEED_CACHE: dict = {}


def _pool_worker_init(env: _Env, cache_max: int):
    _WORKER_ENV["env"] = env
    cache = BoundedCache(cache_max)
    if _SEED_CACHE:
        # warm start from the parent's cache (a repeated
        # StrategySearcher.search, a prior pool round): seeded entries
        # are memo hits, and never shipped back
        cache.update(_SEED_CACHE)
    _WORKER_ENV["cache"] = cache
    _WORKER_ENV["shipped"] = set(cache)


def _pool_worker_eval(cell: SweepCell):
    """Runs on the worker process's MAIN thread, so the SIGALRM
    per-candidate deadline is fully effective here."""
    from simumax_tpu_torch.core.errors import SimuMaxError, _json_safe

    env = _WORKER_ENV["env"]
    cache = _WORKER_ENV["cache"]
    shipped = _WORKER_ENV["shipped"]
    diag = Diagnostics()
    with diag.activate():
        status, row, err, exc = _evaluate_cell_guarded(
            cell, env, cache, diag
        )
    diag_err = None
    if exc is not None:
        # ship the typed exception's structured context + untruncated
        # message separately from the (journal-format) err dict, so the
        # parent's quarantine Diagnostics entry matches a serial run's
        # record_exception() output without changing journal rows
        diag_err = {"message": str(exc) or type(exc).__name__}
        if isinstance(exc, SimuMaxError):
            diag_err["context"] = _json_safe(exc.context)
    fresh = {k: cache[k] for k in cache if k not in shipped}
    shipped.update(fresh)
    coverage = (
        {k: set(v) for k, v in diag._eff_hits.items()},
        {k: set(v) for k, v in diag._eff_misses.items()},
    )
    events = [e.to_dict() for e in diag.events]
    return (cell.idx, status, row, err, diag_err, fresh, coverage,
            events, dict(diag.counters))


def _mp_context():
    """fork where available (Linux): monkeypatched test doubles and
    in-memory config tweaks in the parent are inherited by workers, and
    start-up cost stays low — unless this process has initialised CUDA,
    whose context a forked child cannot use: then spawn. Override with
    SIMUMAX_MP_START."""
    import sys

    name = os.environ.get("SIMUMAX_MP_START", "")
    if not name:
        torch = sys.modules.get("torch")
        cuda_live = torch is not None and torch.cuda.is_initialized()
        name = ("fork" if "fork" in _mp.get_all_start_methods()
                and not cuda_live else "spawn")
    return _mp.get_context(name)


def _record_pool_quarantine(diagnostics, cell, err, diag_err=None):
    """Mirror the serial path's ``record_exception`` output: base
    coordinates, overridden by the typed exception's own structured
    context when the worker shipped one (``diag_err``)."""
    ctx = {"candidate": cell.key, "phase": "search"}
    ctx.update((diag_err or {}).get("context") or {})
    ctx["exception"] = err.get("error_type", "")
    msg = ((diag_err or {}).get("message")
           or err.get("error_msg") or "candidate failed")
    diagnostics.error("quarantine", msg, **ctx)


def _run_cells_pool(cells, env, cache, diagnostics, jobs, on_done):
    outcomes: Dict[int, CellOutcome] = {}
    pending = list(cells)
    hard = None
    if env.candidate_timeout and env.candidate_timeout > 0:
        hard = (env.candidate_timeout * HARD_TIMEOUT_FACTOR
                + HARD_TIMEOUT_SLACK)
    ctx = _mp_context()
    broken_rounds = 0

    def finish(cell, status, row, err, diag_err=None):
        if status == "error":
            _record_pool_quarantine(diagnostics, cell, err, diag_err)
        out = CellOutcome(cell, status, row, err)
        outcomes[cell.idx] = out
        if on_done:
            on_done(out)

    def collect(cell, result):
        (_, status, row, err, diag_err, fresh, coverage, events,
         counters) = result
        cache.update(fresh)
        diagnostics.merge_coverage(*coverage)
        diagnostics.merge_events(events)
        # worker counters are per-cell deltas (additive), except the
        # *_max_batch high-water mark
        for k, v in counters.items():
            if k.endswith("max_batch"):
                diagnostics.counters[k] = max(
                    diagnostics.counters.get(k, 0), v)
            else:
                diagnostics.count(k, v)
        finish(cell, status, row, err, diag_err)

    while pending:
        _SEED_CACHE.clear()
        _SEED_CACHE.update(cache)
        executor = _cf.ProcessPoolExecutor(
            max_workers=min(jobs, len(pending)),
            mp_context=ctx,
            initializer=_pool_worker_init,
            initargs=(env, RESULT_CACHE_MAX),
        )
        fut_to_cell = {
            executor.submit(_pool_worker_eval, c): c for c in pending
        }
        running_since: Dict[object, float] = {}
        stuck: List[object] = []
        raised: List[object] = []
        not_done = set(fut_to_cell)
        try:
            while not_done:
                done, not_done = _cf.wait(
                    not_done, timeout=0.25,
                    return_when=_cf.FIRST_COMPLETED,
                )
                now = time.monotonic()
                # observe who is actually running: on pool breakage the
                # observed-running futures are the crash suspects, and
                # under a deadline they feed the hard backstop below
                for f in not_done:
                    if f.running():
                        running_since.setdefault(f, now)
                for f in done:
                    try:
                        result = f.result()
                    except KernelError:
                        raise  # a worker's fold kernel failed
                    except Exception:
                        # the worker process died without returning a
                        # result. A hard crash breaks the whole pool, so
                        # every pending future raises at once — healthy
                        # cells are retried; the crash suspects (the
                        # cells observed running) are re-tried ISOLATED
                        # below so only a cell that really kills its
                        # worker is quarantined.
                        raised.append(f)
                        continue
                    collect(fut_to_cell[f], result)
                if raised:
                    break
                if hard and not_done:
                    stuck = [
                        f for f, t0 in running_since.items()
                        if f in not_done and now - t0 > hard
                    ]
                    if stuck:
                        break
        finally:
            if stuck or raised:
                # kill wedged workers outright; shutdown would join them
                for p in list(getattr(executor, "_processes", {}).values()):
                    try:
                        p.terminate()
                    except (OSError, ValueError):
                        continue  # already dead / closed handle
                executor.shutdown(wait=False, cancel_futures=True)
            else:
                executor.shutdown(wait=True)
        for f in stuck:
            cell = fut_to_cell[f]
            if cell.idx in outcomes:
                continue
            finish(cell, "error", None, {
                "error_type": "CandidateTimeoutError",
                "error_msg": (
                    f"candidate {cell.key} exceeded the pool hard "
                    f"deadline ({hard:.0f}s backstop over the "
                    f"{env.candidate_timeout:g}s per-candidate timeout); "
                    f"worker killed"
                ),
            })
        if raised:
            broken_rounds += 1
            suspects = [f for f in raised if f in running_since] or raised
            if broken_rounds > max(4, len(cells)):
                # pathological environment (workers keep dying with no
                # identifiable culprit): stop retrying, record the rest
                for f in raised:
                    cell = fut_to_cell[f]
                    if cell.idx not in outcomes:
                        finish(cell, "error", None, {
                            "error_type": "BrokenProcessPool",
                            "error_msg": (
                                f"worker pool kept breaking "
                                f"({broken_rounds} rounds); giving up on "
                                f"{cell.key}"
                            ),
                        })
            else:
                for f in suspects:
                    cell = fut_to_cell[f]
                    if cell.idx not in outcomes:
                        _run_cell_isolated(cell, env, hard, collect, finish)
        pending = [c for c in pending if c.idx not in outcomes]
        if pending:
            diagnostics.count("sweep_pool_restarts")
    _SEED_CACHE.clear()  # don't pin row dicts past the sweep
    return outcomes


def _run_cell_isolated(cell, env, hard, collect, finish):
    """Re-try one crash-suspect cell in its own single-worker pool: if
    the worker dies again the cell really is the culprit and is
    quarantined; otherwise its result is collected normally."""
    ctx = _mp_context()
    executor = _cf.ProcessPoolExecutor(
        max_workers=1, mp_context=ctx,
        initializer=_pool_worker_init,
        initargs=(env, RESULT_CACHE_MAX),
    )
    fut = executor.submit(_pool_worker_eval, cell)
    killed = False
    try:
        result = fut.result(timeout=hard)
    except KernelError:
        raise
    except _cf.TimeoutError:
        killed = True
        finish(cell, "error", None, {
            "error_type": "CandidateTimeoutError",
            "error_msg": (
                f"candidate {cell.key} exceeded the pool hard deadline "
                f"({hard:.0f}s) in an isolated retry; worker killed"
            ),
        })
    except Exception as exc:
        finish(cell, "error", None, {
            "error_type": type(exc).__name__,
            "error_msg": (
                f"worker process died evaluating {cell.key} (isolated "
                f"retry after a pool breakage): {str(exc)[:300]}"
            ),
        })
    else:
        collect(cell, result)
    finally:
        if killed:
            for p in list(getattr(executor, "_processes", {}).values()):
                try:
                    p.terminate()
                except (OSError, ValueError):
                    continue
            executor.shutdown(wait=False, cancel_futures=True)
        else:
            executor.shutdown(wait=True)

"""Strategy search family (L7).

Reference: ``simumax/tuning/strategy_searcher.py`` (grid ``StrategySearcher``)
and the ``PerfLLM.search_*`` family (``perf_llm.py:3080-3578``): binary
search of the max micro-batch size, fixed-GBS (mbs, mbc) search with a
GiB safety margin, selective-recompute combos, recompute-layer binary
search, and the full tp x ep x pp sweep with CSV dump, memoized so the
sweep stays tractable.

TPU notes: every evaluated candidate records its mesh placement
(``net`` column in result rows; ``dcn_dims`` in the CSV flags parallel
dims that spilled over the slice onto DCN).

Copy of the JAX package's ``search/searcher.py`` with its import paths
changed and two additions: :func:`search_best_parallel_strategy` and
:meth:`StrategySearcher.search` take ``device`` (``"cuda"`` by default),
where the batched engine's pipeline-schedule fold kernel runs
(``"cpu"``: its plain version). A batched sweep refuses to start
without a card unless ``device="cpu"``; ``engine="scalar"`` builds no
scorer and needs no card. And the caches key a system on its network
(:func:`_network_key`): the torus axes on a TPU system, as the JAX
package does, the node size on an NVSwitch system, nothing on one card.
The ``docs/`` this module names are the JAX package's.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from simumax_tpu_torch.core.config import (
    ConfigError,
    GiB,
    ModelConfig,
    StrategyConfig,
    SystemConfig,
)
from simumax_tpu_torch.core.errors import CandidateTimeoutError, FeasibilityError
from simumax_tpu_torch.core.records import Diagnostics
from simumax_tpu_torch.perf import PerfLLM
from simumax_tpu_torch.search.executor import BoundedCache, run_cells
from simumax_tpu_torch.search.prune import (
    base_cell_row,
    clone_strategy,
    enumerate_cells,
    make_cell_strategy,
)

#: result-cache key: the strategy fields that affect estimates
_KEY_FIELDS = (
    "seq_len", "micro_batch_size", "micro_batch_num", "dtype", "fp8",
    "world_size", "tp_size", "cp_size", "pp_size", "ep_size", "etp_size",
    "enable_sequence_parallel", "cp_comm_type", "cp_a2a_mode",
    "interleaving_size", "microbatch_group_size_per_vp_stage",
    "pp_comm_async", "zero_state", "use_fused_norm", "use_flash_sdp",
    "use_fused_ce", "use_fp32_accum_grad", "grad_reduce_in_bf16",
    "optimizer_style", "enable_recompute", "recompute_granularity",
    "recompute_layer_num", "attn_recompute", "attn_norm_recompute",
    "mla_rms_recompute", "mlp_recompute", "mlp_rms_recompute",
    "sdp_recompute", "recompute_variance", "moe_act_recompute",
    "mla_up_proj_recompute", "megatron_recompute",
    "megatron_recompute_modules", "moe_capacity_factor",
    "dispatch_probs", "mesh_order", "group_linear_mode",
    "offload_groupgemm_col_inputs", "mem_factor",
    "enable_straggler_model", "num_layers_in_first_pipeline_stage",
    "num_layers_in_last_pipeline_stage",
    "account_for_embedding_in_pipeline_split",
    "account_for_loss_in_pipeline_split", "use_math_sdp", "quant_dtype",
    "sdp_backend", "overlap_grad_reduce", "overlap_param_gather",
    "moe_dispatcher_policy", "attention_sparse_ratio", "enable_dropout",
)


def _key_value(st: StrategyConfig, field_name: str):
    """Hashable cache-key value for one strategy field
    (megatron_recompute_modules is a list)."""
    v = getattr(st, field_name)
    return tuple(v) if isinstance(v, list) else v


#: _KEY_FIELDS the parallel-strategy sweep overrides per cell — the
#: complement (base fields) is the journal's run identity
_SWEPT_FIELDS = frozenset({
    "tp_size", "cp_size", "ep_size", "pp_size", "etp_size", "zero_state",
    "micro_batch_size", "micro_batch_num", "enable_recompute",
    "recompute_granularity", "recompute_layer_num", "sdp_recompute",
})


def _network_key(system) -> tuple:
    """The network's shape: the ICI torus axes, ``("nvlink", gpus per
    node)`` on an NVSwitch system, ``()`` on one card."""
    if system.ici is not None:
        return tuple(system.ici.axes)
    if system.nvlink is not None:
        return ("nvlink", system.nvlink.gpus_per_node)
    return ()


def _model_system_key(model, system) -> tuple:
    """Stable content-ish identity of a (model, system) pair — not
    id() (which CPython reuses after GC). Shared by the result cache
    and the build cache so the two can never desynchronize."""
    return (
        (model.model_name, model.layer_num, model.hidden_size,
         model.vocab_size, model.expert_num, model.attention_type),
        (system.sys_name, system.accelerator.mem_gbs,
         _network_key(system), system.num_slices),
    )


def _strategy_key(st: StrategyConfig, model, system, gib_margin) -> tuple:
    # model/system identity + margin are part of the verdict, not just
    # the strategy fields
    return _model_system_key(model, system) + (
        gib_margin,
        tuple(_key_value(st, f) for f in _KEY_FIELDS),
    )


@contextlib.contextmanager
def _candidate_deadline(seconds: Optional[float], candidate: str,
                        diagnostics: Optional[Diagnostics] = None):
    """Interrupt a candidate evaluation that runs past ``seconds`` with a
    :class:`CandidateTimeoutError` (SIGALRM-based on the main thread —
    including each pool worker's main thread).

    Off the main thread, or without ``setitimer``, enforcement degrades
    to a monotonic post-hoc check: the cell cannot be interrupted
    mid-flight, but an overrunning candidate is still quarantined once
    it returns, and a Diagnostics warning records the degraded mode
    (previously this silently disabled the timeout altogether)."""
    if seconds is None or seconds <= 0:
        yield
        return
    usable = (
        hasattr(signal, "setitimer")
        and threading.current_thread() is threading.main_thread()
    )
    if not usable:
        if diagnostics is not None:
            diagnostics.warn(
                "search",
                "per-candidate timeout enforced post-hoc: SIGALRM is "
                "only available on the main thread, so a hung candidate "
                "cannot be interrupted mid-flight (it is quarantined "
                "after it returns)",
                timeout_s=seconds,
            )
        start = time.monotonic()
        yield
        elapsed = time.monotonic() - start
        if elapsed > seconds:
            raise CandidateTimeoutError(
                f"candidate {candidate} took {elapsed:.2f}s, exceeding "
                f"the {seconds:g}s per-candidate timeout (post-hoc "
                f"monotonic check; SIGALRM unavailable off the main "
                f"thread)",
                candidate=candidate, timeout_s=seconds, phase="search",
                elapsed_s=round(elapsed, 3), enforcement="post_hoc",
            )
        return

    def _on_alarm(signum, frame):
        raise CandidateTimeoutError(
            f"candidate {candidate} exceeded the {seconds:g}s "
            f"per-candidate timeout",
            candidate=candidate, timeout_s=seconds, phase="search",
        )

    prev = signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev)


class SweepJournal:
    """Incremental JSONL checkpoint of evaluated sweep cells.

    One line per evaluated candidate cell: ``{"key": ..., "status":
    "ok" | "empty" | "error", "row": {...} | null, "error": {...} |
    null}``. Appended (and flushed) as soon as each cell finishes, so a
    killed sweep loses at most the in-flight candidate;
    ``--resume <journal>`` replays the journal instead of re-evaluating
    the memoized prefix.

    A fresh journal starts with a ``{"header": {...}}`` line stamping
    the run identity (model / system fingerprint / gbs / world) —
    resuming against a journal recorded for a *different* run is
    refused instead of silently replaying wrong rows."""

    def __init__(self, path: str, header: Optional[dict] = None):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "a", encoding="utf-8")
        if fresh and header is not None:
            self._f.write(json.dumps({"header": header}) + "\n")
            self._f.flush()

    def append(self, key: str, status: str, row: Optional[dict] = None,
               error: Optional[dict] = None):
        entry = {"key": key, "status": status, "row": row, "error": error}
        self._f.write(json.dumps(entry, default=str) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    @staticmethod
    def load(path: str) -> Dict[str, dict]:
        """Parse a journal into {cell_key: last entry}. Tolerates a torn
        final line (the sweep was killed mid-write)."""
        done: Dict[str, dict] = {}
        if not os.path.exists(path):
            return done
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write from a killed sweep
                if isinstance(entry, dict) and "key" in entry:
                    done[entry["key"]] = entry
        return done

    @staticmethod
    def read_header(path: str) -> Optional[dict]:
        """The run-identity header of a journal, if it has one (older
        journals and hand-built fixtures may not)."""
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    return None
                if isinstance(entry, dict) and "header" in entry:
                    return entry["header"]
                return None  # first line is a cell entry: headerless
        return None


#: builds kept alive per build cache — the current wiring plus a couple
#: of recompute-layer binary-search neighbours
BUILD_CACHE_MAX = 4


def _layout_build_key(st: StrategyConfig, model, system) -> tuple:
    """Like :func:`_strategy_key` minus the batch-split fields
    (``PerfLLM.BATCH_ONLY_FIELDS`` — the single source ``rebatch``
    validates against): two strategies with the same build key share a
    built chunk graph."""
    return _model_system_key(model, system) + (
        tuple(_key_value(st, f) for f in _KEY_FIELDS
              if f not in PerfLLM.BATCH_ONLY_FIELDS),
    )


def _identity_mismatch(stamped: dict, identity: dict) -> List[str]:
    """Keys on which a journal's run-identity header actually disagrees
    with this run. ``base_strategy`` is compared only over the keys
    BOTH sides stamped: a newer release may key additional strategy
    fields, and a journal recorded before that must still resume (the
    run it describes has not changed)."""
    diff = [  # noqa: SIM003 — sorted() on return erases the set order
        k for k in set(stamped) | set(identity)
        if k != "base_strategy" and stamped.get(k) != identity.get(k)
    ]
    sb = stamped.get("base_strategy") or {}
    ib = identity.get("base_strategy") or {}
    if any(sb[k] != ib[k] for k in set(sb) & set(ib)):
        diff.append("base_strategy")
    return sorted(diff)


def evaluate_strategy(
    strategy: StrategyConfig,
    model: ModelConfig,
    system: SystemConfig,
    cache: Optional[Dict] = None,
    gib_margin: float = 0.0,
    project_dualpp: bool = False,
    build_cache: Optional[Dict] = None,
    simulate: bool = False,
) -> Optional[dict]:
    """Estimate one candidate; returns a flat result row or None when
    the candidate is invalid or does not fit in HBM (reference
    feasibility gate ``perf_llm.py:3148-3149``).

    ``project_dualpp`` adds a DualPipe projection column for eligible
    layouts (even pp, no VPP) — opt-in because it costs ~8% sweep
    throughput.

    ``build_cache`` (dict-like) enables the per-layout build reuse fast
    path: candidates differing only in the batch split rebatch a cached
    built ``PerfLLM`` (``PerfLLM.rebatch``) instead of rebuilding the
    whole chunk graph.

    ``simulate`` cross-checks every fitting candidate with the
    discrete-event simulator (chunk granularity, merged ranks) and adds
    ``sim_ms`` / ``sim_vs_analytical`` columns — opt-in because it adds
    a schedule replay per candidate. A ``SimulationError`` (deadlocked
    or inconsistent schedule) propagates so the sweep loop quarantines
    the cell exactly like a candidate timeout."""
    key = _strategy_key(strategy, model, system, gib_margin) + (
        project_dualpp, simulate,
    )
    if cache is not None and key in cache:
        return cache[key]
    row = None
    try:
        strategy = copy.deepcopy(strategy)
        strategy.__post_init__()
        perf = None
        if build_cache is not None:
            bkey = _layout_build_key(strategy, model, system)
            built = build_cache.get(bkey)
            if built is not None:
                try:
                    perf = built.rebatch(strategy)
                except ValueError:
                    # the build key abstracts over _KEY_FIELDS; a field
                    # outside it differing fails rebatch's exhaustive
                    # check — fall back to a fresh build rather than
                    # crashing the cell
                    perf = None
        if perf is None:
            perf = PerfLLM().configure(strategy, model, system)
            perf.run_estimate()
            if build_cache is not None:
                build_cache[bkey] = perf
        mem = perf.analysis_mem()
        cost = perf.analysis_cost()
        fits = mem["max_peak_bytes"] + gib_margin * GiB <= (
            system.mem_bytes * strategy.mem_factor
        )
        from simumax_tpu_torch.observe.ledger import attribution_line
        from simumax_tpu_torch.observe.memledger import memory_attribution_line

        row = {
            "tp": strategy.tp_size, "cp": strategy.cp_size,
            "pp": strategy.pp_size, "dp": strategy.dp_size,
            "ep": strategy.ep_size, "etp": strategy.etp_size,
            "vp": strategy.vp_size,
            "mbs": strategy.micro_batch_size,
            "mbc": strategy.micro_batch_num,
            "zero": strategy.zero_state,
            "recompute": (
                strategy.recompute.granularity
                if strategy.recompute.enabled
                else "none"
            ),
            "recompute_layers": strategy.recompute_layer_num,
            "mfu": cost["mfu"],
            "iter_ms": cost["iter_time_ms"],
            "tgs": cost["tgs"],
            "peak_gib": mem["max_peak_gib"],
            "fits": fits,
            # headroom in GiB against the SAME threshold THIS row's
            # fits verdict used (usable HBM minus this family's
            # gib_margin safety band — 1 GiB for the batch-split
            # search, 0 for the recompute families, raw usable for
            # pruned rows), so margin >= 0 <=> fits on every row —
            # consumers see headroom, not just a bare boolean
            "mem_margin_gib": (
                mem["fits_margin_bytes"] - gib_margin * GiB
            ) / GiB,
            "net": {k: p.describe() for k, p in perf.ctx.paths.items()},
            "dcn_dims": ",".join(
                d for d, p in perf.ctx.paths.items() if p.on_dcn
            ),
            # one-line MFU-loss attribution (observe/ledger.py): where
            # this candidate's step time went, so a sweep CSV row can be
            # triaged without re-running `explain` on it. Derived from
            # the already-cached analyses — no ledger is built (sweeps
            # stay on the zero-cost path).
            "attribution": attribution_line(perf),
            # one-line peak-memory attribution, same contract: derived
            # from the cached analysis_mem only, no ledger walk
            "mem_attribution": memory_attribution_line(perf),
        }
        # DualPipe projection for eligible layouts (reuses the cached
        # analyses; no re-estimate) — lets a sweep surface candidates
        # whose bidirectional-schedule potential beats their 1F1B rank
        # before anyone commits to the schedule
        if (project_dualpp and strategy.pp_size >= 2
                and strategy.pp_size % 2 == 0 and strategy.vp_size == 1):
            dual = perf.analysis_dualpp()
            row["dualpp_mfu"] = dual["projected_mfu"]
            # same feasibility convention as the baseline gate,
            # including the GiB safety margin
            row["dualpp_fits"] = (
                dual["max_peak_bytes"] + gib_margin * GiB
                <= system.mem_bytes * strategy.mem_factor
            )
        elif project_dualpp:
            row["dualpp_mfu"] = None
            row["dualpp_fits"] = None
        if simulate and fits:
            # simulator-backed cross-check (chunk granularity: one
            # compute span per microbatch — the cheap replay). Failures
            # are NOT caught here: a SimulationError quarantines the
            # sweep cell upstream, it must never pass as a clean row.
            sim = perf.simulate(None, granularity="chunk",
                                track_memory=False)
            row["sim_ms"] = sim["end_time_ms"]
            row["sim_vs_analytical"] = (
                sim["end_time_ms"] / cost["iter_time_ms"]
                if cost["iter_time_ms"] else None
            )
        if not fits:
            row = {**row, "mfu": 0.0}
    except ConfigError:
        # genuinely infeasible candidate (divisibility / capability):
        # rejected silently. Internal invariant failures (AssertionError
        # from conservation/schedule checks, SimulationError) propagate —
        # the sweep loop quarantines them per-candidate so one bad cell
        # cannot kill the run, but they stay visible in the report.
        row = None
    if cache is not None:
        cache[key] = row
    return row


def search_max_micro_batch_size(
    strategy: StrategyConfig,
    model: ModelConfig,
    system: SystemConfig,
    limit: int = 64,
    cache: Optional[Dict] = None,
    build_cache: Optional[Dict] = None,
) -> int:
    """Binary-search the largest feasible micro_batch_size
    (reference ``perf_llm.py:3080``)."""
    lo, hi, best = 1, limit, 0
    while lo <= hi:
        mid = (lo + hi) // 2
        st = copy.deepcopy(strategy)
        st.micro_batch_size = mid
        row = evaluate_strategy(st, model, system, cache,
                                build_cache=build_cache)
        if row is not None and row["fits"]:
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    return best


def search_micro_batch_config(
    strategy: StrategyConfig,
    model: ModelConfig,
    system: SystemConfig,
    global_batch_size: int,
    gib_margin: float = 1.0,
    cache: Optional[Dict] = None,
    project_dualpp: bool = False,
    build_cache: Optional[Dict] = None,
    simulate: bool = False,
) -> Optional[dict]:
    """Fixed-GBS (mbs, mbc) search with a GiB safety margin
    (reference ``perf_llm.py:3111-3167``, ``gmi_error``)."""
    dp = strategy.dp_size
    if dp < 1 or global_batch_size % dp:
        raise FeasibilityError(
            f"global_batch_size {global_batch_size} does not divide over "
            f"dp {dp}",
            phase="search", global_batch_size=global_batch_size, dp=dp,
        )
    per_dp = global_batch_size // dp
    best = None
    for mbs in range(1, per_dp + 1):
        if per_dp % mbs:
            continue
        st = copy.deepcopy(strategy)
        st.micro_batch_size = mbs
        st.micro_batch_num = per_dp // mbs
        if st.vp_size > 1 and st.micro_batch_num % st.vpp_group_size:
            continue
        row = evaluate_strategy(st, model, system, cache, gib_margin,
                                project_dualpp=project_dualpp,
                                build_cache=build_cache,
                                simulate=simulate)
        if row is None or not row["fits"]:
            continue
        if best is None or row["mfu"] > best["mfu"]:
            best = row
    return best


_SELECTIVE_COMBOS = (
    # curated combos (reference ``perf_llm.py:3213-3268``)
    dict(sdp_recompute=True),
    dict(attn_recompute=True, attn_norm_recompute=True),
    dict(attn_recompute=True, attn_norm_recompute=True,
         mlp_recompute=True, mlp_rms_recompute=True),
)


def search_best_selective_recompute(
    strategy: StrategyConfig,
    model: ModelConfig,
    system: SystemConfig,
    cache: Optional[Dict] = None,
    project_dualpp: bool = False,
    build_cache: Optional[Dict] = None,
    simulate: bool = False,
) -> Optional[dict]:
    best = None
    for combo in _SELECTIVE_COMBOS:
        st = copy.deepcopy(strategy)
        st.enable_recompute = True
        st.recompute_granularity = "selective"
        st.recompute_layer_num = -1
        for k, v in combo.items():
            setattr(st, k, v)
        row = evaluate_strategy(st, model, system, cache,
                                project_dualpp=project_dualpp,
                                build_cache=build_cache,
                                simulate=simulate)
        if row is None or not row["fits"]:
            continue
        if best is None or row["mfu"] > best["mfu"]:
            best = row
    return best


def search_best_recompute_layer_num(
    strategy: StrategyConfig,
    model: ModelConfig,
    system: SystemConfig,
    cache: Optional[Dict] = None,
    project_dualpp: bool = False,
    build_cache: Optional[Dict] = None,
    simulate: bool = False,
) -> Optional[dict]:
    """Binary-search the fewest full-recompute layers that still fit
    (reference ``perf_llm.py:3270-3328``) — fewer recomputed layers is
    always faster, so the optimum is the smallest feasible count."""
    layers_per_stage = -(-model.layer_num // (strategy.pp_size * strategy.vp_size))
    lo, hi = 0, layers_per_stage
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        st = copy.deepcopy(strategy)
        st.enable_recompute = mid > 0
        st.recompute_granularity = "full_block"
        st.recompute_layer_num = mid
        row = evaluate_strategy(st, model, system, cache,
                                project_dualpp=project_dualpp,
                                build_cache=build_cache,
                                simulate=simulate)
        if row is not None and row["fits"]:
            best = row
            hi = mid - 1
        else:
            lo = mid + 1
    return best


def sweep_cell_key_fn(base_strategy, model, system, global_batch_size,
                      engine, simulate=False, project_dualpp=False):
    """THE definition of a sweep cell's persistent store key
    (``docs/service.md``): the content-addressed prefix of one sweep
    family — full resolved model/system content plus every
    base-strategy field the grid does not override — combined with the
    cell coordinates. Returns ``cell -> key``. The sweep path and the
    speculative warmer (``service/warmer.py``) MUST share this one
    builder, or warmed cells land under keys the sweep never
    computes."""
    import dataclasses as _dc

    from simumax_tpu_torch.service.store import code_version, content_key

    overridden = {"tp_size", "cp_size", "ep_size", "pp_size",
                  "zero_state", "micro_batch_size", "micro_batch_num"}
    sweep_prefix = content_key({
        "kind": "sweep_cell",
        "code_version": code_version(),
        "engine": engine,
        "simulate": simulate,
        "project_dualpp": project_dualpp,
        "gbs": global_batch_size,
        "model": model.to_dict(),
        "system": system.to_dict(),
        "base_strategy": {
            f.name: getattr(base_strategy, f.name)
            for f in _dc.fields(type(base_strategy))
            if f.name not in overridden
        },
    })

    def cell_key(cell, _prefix=sweep_prefix):
        return content_key({"sweep": _prefix, "cell": cell.key})

    return cell_key


def _evaluate_sweep_cell(
    st, rc, model, system, global_batch_size, cache, project_dualpp,
    simulate=False,
) -> Optional[dict]:
    """Evaluate one (layout, recompute-family) sweep cell: search the
    batch split, then the recompute family; at most one result row.

    The cell-local ``build_cache`` lets the batch searches inside this
    cell rebatch one built chunk graph per recompute wiring instead of
    re-running ``PerfLLM.build()`` per candidate split."""
    build_cache = BoundedCache(maxsize=BUILD_CACHE_MAX)
    if st.dp_size < 1 or global_batch_size % st.dp_size:
        # every family below synthesizes an (mbs, mbc) split from
        # global_batch_size // dp — with a non-dividing gbs that split
        # would silently train a different global batch size
        raise FeasibilityError(
            f"global_batch_size {global_batch_size} does not divide over "
            f"dp {st.dp_size}: no (mbs, mbc) split reproduces it",
            phase="search", global_batch_size=global_batch_size,
            dp=st.dp_size,
        )
    st_rc = copy.deepcopy(st)
    if rc == "none":
        st_rc.enable_recompute = False
        return search_micro_batch_config(
            st_rc, model, system, global_batch_size,
            cache=cache, project_dualpp=project_dualpp,
            build_cache=build_cache, simulate=simulate,
        )
    if rc == "selective":
        # pick the batch split under selective-recompute memory,
        # not whatever recompute the base strategy carried
        st_rc.enable_recompute = True
        st_rc.recompute_granularity = "selective"
        st_rc.recompute_layer_num = -1
        st_rc.sdp_recompute = True
        base_batch = search_micro_batch_config(
            st_rc, model, system, global_batch_size, cache=cache,
            build_cache=build_cache,
        )
        # the guard above makes the mbs=1 fallback split exact; no
        # silently-wrong-GBS row is possible
        bs = base_batch or {"mbs": 1, "mbc": global_batch_size // st.dp_size}
        st_rc.micro_batch_size = bs["mbs"]
        st_rc.micro_batch_num = bs["mbc"]
        return search_best_selective_recompute(
            st_rc, model, system, cache=cache,
            project_dualpp=project_dualpp,
            build_cache=build_cache, simulate=simulate,
        )
    if rc == "full_block":
        st_rc.micro_batch_size = 1
        st_rc.micro_batch_num = global_batch_size // st.dp_size
        return search_best_recompute_layer_num(
            st_rc, model, system, cache=cache,
            project_dualpp=project_dualpp,
            build_cache=build_cache, simulate=simulate,
        )
    raise ConfigError(f"unknown recompute family {rc!r}", phase="search")


def search_best_parallel_strategy(
    base_strategy: StrategyConfig,
    model: ModelConfig,
    system: SystemConfig,
    global_batch_size: int,
    tp_list: Sequence[int] = (1, 2, 4, 8),
    pp_list: Sequence[int] = (1, 2, 4),
    ep_list: Sequence[int] = (1,),
    cp_list: Sequence[int] = (1,),
    zero_list: Sequence[int] = (1,),
    recompute_types: Sequence[str] = ("none", "selective", "full_block"),
    topk: int = 5,
    csv_path: Optional[str] = None,
    verbose: bool = False,
    cache: Optional[Dict] = None,
    project_dualpp: bool = False,
    candidate_timeout: Optional[float] = None,
    journal_path: Optional[str] = None,
    resume: Optional[str] = None,
    diagnostics: Optional[Diagnostics] = None,
    jobs: int = 1,
    prune: bool = True,
    simulate: bool = False,
    engine: str = "scalar",
    verify_topk: Optional[int] = None,
    store=None,
    on_cell=None,
    search_mode: str = "grid",
    cell_flights=None,
    device: str = "cuda",
) -> List[dict]:
    """Full tp x cp x ep x pp sweep (reference
    ``search_best_parallel_strategy`` perf_llm.py:3355-3578): enumerate
    the grid, prune cells that cannot possibly fit (``search/prune.py``
    — recorded as auditable ``status=pruned`` CSV rows), evaluate the
    rest (serially, or fanned out over ``jobs`` worker processes via
    ``search/executor.py``), merge results back in deterministic grid
    order, and rank by MFU — so serial and parallel sweeps produce
    identical top-k rows and identical CSV row sets.

    Fault isolation: each (layout, recompute) cell is evaluated under an
    optional ``candidate_timeout`` (seconds), and any exception —
    invariant failure, timeout, crash — quarantines just that cell: it
    lands in the CSV as a ``status=error`` row carrying the exception
    class and in ``diagnostics``, while the sweep continues. In pool
    mode the deadline runs on each worker's main thread (SIGALRM), with
    a pool-level hard backstop that kills wedged workers.
    ``journal_path`` checkpoints every finished cell to a JSONL journal;
    ``resume`` replays a journal so an interrupted sweep continues
    without re-evaluating the journaled prefix (pass the same path as
    both to extend one journal across runs) — in any mix of serial and
    parallel runs. A journal stamped for a different run identity
    (model / system / gbs / world) is refused. ``prune=False`` restores
    the evaluate-everything legacy behavior (``--no-prune``).

    ``simulate=True`` asks every cell for simulator-backed evaluation
    (``sim_ms`` cross-check column on fitting rows); a cell whose
    schedule replay raises ``SimulationError`` is quarantined as a
    ``status=error`` CSV row exactly like a candidate timeout — never a
    sweep abort.

    ``engine="batched"`` scores every cell's candidate batch with the
    vectorized cost kernel (``search/batched.py``) instead of walking a
    ``PerfLLM`` object graph per candidate, then re-verifies the top
    ``verify_topk`` ranked rows (default: ``topk``) with the scalar
    oracle — the returned top-k rows are exact scalar rows. Since PR 11
    the kernel covers every strategy family; the tiny residual surface
    (and ``project_dualpp`` / ``simulate``, which need the built
    estimate) falls back to the scalar path PER CELL with counted
    telemetry: a ``sweep_batched_fallbacks`` total, a per-reason
    ``sweep_batched_fallback[...]`` histogram, and a
    ``batched_fallback`` column on the affected rows
    (``docs/search.md``).

    ``search_mode="guided"`` replaces exhaustive grid evaluation with
    Pareto-guided selection: every cell is screened with one cheap
    batched-kernel score, only the (iter_time, peak_mem, comm_fraction)
    frontier plus seeds and their local neighborhoods evaluate fully,
    refining around the top-k until stable; skipped cells appear as
    ``status=screened`` CSV rows. Journaled and resumable exactly like
    the grid walk (guided journals are mode-stamped). See
    ``docs/search.md`` "Guided search".

    ``store`` (a ``service.store.ContentStore``) adds the persistent
    per-cell layer (``docs/service.md``): every finished cell is written
    under a content-addressed key — the canonical hash of the resolved
    (model, system, non-swept base-strategy fields, gbs, engine,
    code-version) tuple plus the cell coordinates — and cells already in
    the store (from any previous grid, process, or server) are served
    instead of evaluated: an overlapping grid only evaluates the delta.
    Served cells are counted (``sweep_cells_cached``), marked
    ``status=cached`` in the audit CSV, and NOT journaled (the journal
    checkpoints only this run's delta; the store already holds the
    rest). The returned rows are bit-identical either way.

    ``on_cell(key, status, row)`` fires for every settled cell —
    replayed and store-served cells first, then evaluated cells in
    completion order (the server's NDJSON row stream).

    ``cell_flights`` (a ``service.coalesce.CellFlightTable``) extends
    the store layer to *in-flight* cells: a cell another concurrent
    sweep is already evaluating is not evaluated again — this sweep
    claims only the unclaimed delta, publishes each claimed cell as it
    settles (same checkpoint as the store write), and afterwards waits
    for the cells it followed, falling back to evaluating any the
    leader abandoned. Served-by-leader cells are counted
    ``sweep_cells_coalesced``; the returned rows are bit-identical
    either way. Grid mode only (guided sweeps skip claiming — their
    selection may never evaluate a claimed cell).

    ``device`` is where ``engine="batched"`` folds pipeline schedules:
    ``"cuda"`` launches the fold kernel (and refuses to start without a
    card), ``"cpu"`` runs its plain version. A failure of the kernel
    (:class:`~simumax_tpu_torch.torchref.kernels.KernelError`) stops the
    sweep: it is never quarantined as a ``status=error`` row nor turned
    into a must-evaluate guided screen."""
    cache = BoundedCache() if cache is None else cache
    diagnostics = diagnostics if diagnostics is not None else Diagnostics()
    if engine not in ("scalar", "batched"):
        raise ConfigError(f"unknown search engine {engine!r}",
                          phase="search")
    if search_mode not in ("grid", "guided"):
        raise ConfigError(f"unknown search_mode {search_mode!r}",
                          phase="search")
    if engine == "batched":
        from simumax_tpu_torch.search.batched import check_fold_backend

        check_fold_backend("auto", device)
    if engine == "batched" and (project_dualpp or simulate):
        # both need the built scalar estimate: every cell falls back to
        # the scalar path PER CELL — counted in the batched_fallbacks
        # histogram and tagged in the CSV, never a silent whole-sweep
        # engine downgrade
        diagnostics.warn(
            "search",
            "engine='batched' with project_dualpp/simulate evaluates "
            "every cell on the scalar path (per-cell fallback, counted "
            "in batched_fallbacks)",
        )
    # run identity for the journal: everything a cell row depends on
    # besides the swept dims themselves — model, hardware fingerprint,
    # batch size, and every estimate-relevant base-strategy field the
    # sweep does NOT override (seq_len, dtype, world_size, ...).
    # json round-trip so the comparison against a loaded header is
    # apples-to-apples (tuples become lists, etc.)
    identity_extra = {"simulate": True} if simulate else {}
    if engine != "scalar":
        # batched rows differ from scalar rows in last-ulp floats and
        # placeholder attribution columns: refuse cross-engine resume
        identity_extra["engine"] = engine
    if search_mode != "grid":
        # a guided journal covers only the frontier neighborhood, not
        # the whole grid: refuse cross-mode resume
        identity_extra["search_mode"] = search_mode
    identity = json.loads(json.dumps({
        **identity_extra,
        "model": model.model_name,
        "system": system.sys_name,
        "system_hash": system.fingerprint(),
        "gbs": global_batch_size,
        "base_strategy": {
            f: getattr(base_strategy, f)
            for f in _KEY_FIELDS if f not in _SWEPT_FIELDS
        },
    }, default=str, sort_keys=True))
    # events recorded from here on (and merged back from workers) carry
    # the sweep's run identity — the same identity the journal header
    # stamps, so diagnostics and journal rows cross-attribute
    if not diagnostics.run_id:
        diagnostics.set_run_identity(identity)
    resumed: Dict[str, dict] = {}
    if resume:
        if not os.path.exists(resume):
            raise ConfigError(
                f"--resume journal {resume} does not exist — check the "
                f"path (a fresh sweep wants --journal, not --resume)",
                phase="search", journal=resume,
            )
        stamped = SweepJournal.read_header(resume)
        diff = _identity_mismatch(stamped, identity) \
            if stamped is not None else []
        if diff:
            raise ConfigError(
                f"journal {resume} was recorded for a different run "
                f"(mismatched: {', '.join(diff)}); refusing to replay "
                f"its rows — start a fresh journal",
                phase="search", journal=resume,
                journal_identity=stamped, run_identity=identity,
            )
        resumed = SweepJournal.load(resume)
    journal = SweepJournal(journal_path, header=identity) \
        if journal_path else None
    # --journal pointing at a different file than --resume starts a new
    # checkpoint: carry replayed cells over so it is complete on its own
    rejournal = (
        journal is not None and resume is not None
        and os.path.abspath(journal_path) != os.path.abspath(resume)
    )
    # grid expansion + dominance / memory-lower-bound pruning: cells
    # carry a deterministic grid index so results merge back in the
    # same order serial evaluation would have produced them
    cells, pruned_rows, deduped_rows = enumerate_cells(
        base_strategy, model, system, global_batch_size,
        tp_list, cp_list, ep_list, pp_list, zero_list, recompute_types,
        prune=prune,
    )
    # persistent per-cell layer: the content-addressed key prefix of
    # this sweep — full resolved model/system content (calibration
    # tables + provenance included) and every base-strategy field the
    # grid does not override, so any relevant change misses while an
    # overlapping grid hits cell-for-cell
    cell_key_fn = None
    if store is not None:
        cell_key_fn = sweep_cell_key_fn(
            base_strategy, model, system, global_batch_size, engine,
            simulate=simulate, project_dualpp=project_dualpp)

    rows: List[dict] = []
    quarantine: List[dict] = []
    replayed: Dict[int, dict] = {}
    cached: Dict[int, dict] = {}
    #: in-flight coalescing state (grid mode with a flight table):
    #: cells this sweep leads (idx -> store key, published as each
    #: settles) and cells it follows (idx -> (flight, cell))
    flights = cell_flights if (cell_flights is not None
                               and cell_key_fn is not None
                               and search_mode == "grid") else None
    owned: Dict[int, str] = {}
    published: set = set()
    following: Dict[int, tuple] = {}
    coalesced: Dict[int, dict] = {}
    to_run = []
    for cell in cells:
        prior = resumed.get(cell.key)
        if prior is not None \
                and prior.get("status") not in ("ok", "empty", "error"):
            # hand-built or torn entry with no recognizable status:
            # re-evaluate rather than guess
            prior = None
        if prior is not None:
            replayed[cell.idx] = prior
            continue
        if cell_key_fn is not None:
            ckey = cell_key_fn(cell)
            entry = store.get("sweep", ckey)
            # only settled verdicts are served; "error" outcomes are
            # transient (timeouts, crashed workers) and never persisted
            # — serving one forever would quarantine an evaluable cell
            # for every future grid
            if isinstance(entry, dict) \
                    and entry.get("status") in ("ok", "empty"):
                cached[cell.idx] = entry
                continue
            if flights is not None:
                flight, leader = flights.claim(ckey)
                if not leader:
                    following[cell.idx] = (flight, cell)
                    continue
                # close the miss->claim race: the previous leader may
                # have stored + released between our miss and our
                # claim — re-check once before committing to evaluate
                entry = store.get("sweep", ckey)
                if isinstance(entry, dict) \
                        and entry.get("status") in ("ok", "empty"):
                    flights.publish(ckey, entry)
                    cached[cell.idx] = entry
                    continue
                owned[cell.idx] = ckey
        to_run.append(cell)
    diagnostics.count("sweep_cells_total",
                      len(cells) + len(pruned_rows) + len(deduped_rows))
    diagnostics.count("sweep_cells_pruned", len(pruned_rows))
    diagnostics.count("sweep_cells_deduped", len(deduped_rows))
    diagnostics.count("sweep_cells_replayed", len(replayed))
    diagnostics.count("sweep_cells_cached", len(cached))
    if search_mode == "grid":
        diagnostics.count("sweep_cells_evaluated", len(to_run))
    diagnostics.counters["sweep_jobs"] = max(1, int(jobs or 1))
    # every PerfLLM built under a candidate reports into this run's
    # collector (Diagnostics.active()) instead of a throwaway one
    try:
        with diagnostics.activate():

            def _checkpoint(outcome):
                # journal as soon as each cell finishes (completion
                # order in pool mode) — a killed sweep loses at most
                # the in-flight candidates
                if journal:
                    journal.append(outcome.cell.key, outcome.status,
                                   row=outcome.row, error=outcome.error)
                # persist the finished cell for every future
                # overlapping grid (same moment as the journal write,
                # so a killed sweep's store is as fresh as its
                # journal). Transient failures are journal-only; the
                # store write itself is best-effort — a full disk must
                # not kill a sweep that evaluated fine.
                if cell_key_fn is not None \
                        and outcome.status in ("ok", "empty"):
                    try:
                        store.put("sweep", cell_key_fn(outcome.cell), {
                            "status": outcome.status,
                            "row": outcome.row,
                            "error": outcome.error,
                        })
                    except OSError as exc:
                        diagnostics.warn(
                            "search",
                            f"could not persist sweep cell "
                            f"{outcome.cell.key} to the planner cache: "
                            f"{exc}",
                        )
                # publish the settled cell to any concurrent sweep
                # following it — AFTER the store write, so a sweep
                # arriving post-publish finds it in the store. Error
                # outcomes publish too (a follower's own evaluation
                # would fail the same way) but are never persisted.
                okey = owned.get(outcome.cell.idx)
                if flights is not None and okey is not None:
                    published.add(outcome.cell.idx)
                    flights.publish(okey, {
                        "status": outcome.status,
                        "row": outcome.row,
                        "error": outcome.error,
                    })
                if on_cell is not None:
                    on_cell(outcome.cell.key, outcome.status,
                            outcome.row)
                row = outcome.row
                if verbose and row and row.get("fits"):
                    from simumax_tpu_torch.observe.report import get_reporter

                    # progress streams as cells finish, like the old
                    # serial loop (completion order under --jobs)
                    get_reporter().info(
                        f"tp{row['tp']} cp{row['cp']} ep{row['ep']} "
                        f"pp{row['pp']} {row['recompute']}: "
                        f"mfu {row['mfu']*100:.2f}% "
                        f"peak {row['peak_gib']:.1f} GiB",
                        event="sweep_cell", mfu=row["mfu"],
                        attribution=row.get("attribution"),
                    )

            # replayed / store-served cells ride the journal or the
            # store, not the executor — processed (and re-journaled)
            # BEFORE the long evaluation phase, so a sweep killed
            # mid-run keeps its resumed prefix in the new journal.
            # Store-served cells are never journaled: the journal
            # checkpoints this run's delta, the store holds the rest.
            for cell in cells:
                prior = replayed.get(cell.idx)
                from_store = prior is None
                if from_store:
                    prior = cached.get(cell.idx)
                if prior is None:
                    continue
                status = prior["status"]
                if status == "error":
                    err = prior.get("error") or {}
                    # the resumed run's report must count this failure
                    # just like the run that journaled it
                    diagnostics.error(
                        "quarantine",
                        err.get("error_msg") or "journaled failure",
                        candidate=cell.key, phase="search",
                        exception=err.get("error_type", ""),
                        replayed=not from_store, cached=from_store,
                    )
                if rejournal and not from_store:
                    journal.append(cell.key, status,
                                   row=prior.get("row"),
                                   error=prior.get("error"))
                if on_cell is not None:
                    on_cell(cell.key, status, prior.get("row"))
            run_kwargs = dict(
                base_strategy=base_strategy, model=model, system=system,
                global_batch_size=global_batch_size,
                project_dualpp=project_dualpp,
                candidate_timeout=candidate_timeout,
                cache=cache, diagnostics=diagnostics, jobs=jobs,
                on_done=_checkpoint, simulate=simulate, engine=engine,
                device=device,
            )
            screened_rows: List[dict] = []
            if search_mode == "guided":
                outcomes, screened_rows = _run_guided(
                    cells, to_run, replayed, cached, base_strategy,
                    model, diagnostics, topk, run_kwargs,
                    global_batch_size, system,
                )
                diagnostics.count("sweep_cells_evaluated",
                                  len(outcomes))
            else:
                outcomes = run_cells(to_run, **run_kwargs)
            if following:
                # collect the cells concurrent sweeps were already
                # evaluating. Leaders publish as they settle and
                # abandon unpublished claims on the way out (their own
                # finally), so these waits always terminate; a cell
                # whose leader abandoned it is evaluated here.
                abandoned = []
                for idx in sorted(following):
                    flight, fcell = following[idx]
                    outcome = flights.wait(flight)
                    if outcome is None:
                        abandoned.append(fcell)
                        continue
                    coalesced[idx] = outcome
                    if outcome.get("status") == "error":
                        err = outcome.get("error") or {}
                        diagnostics.error(
                            "quarantine",
                            err.get("error_msg") or "coalesced failure",
                            candidate=fcell.key, phase="search",
                            exception=err.get("error_type", ""),
                            coalesced=True,
                        )
                    if on_cell is not None:
                        on_cell(fcell.key, outcome.get("status"),
                                outcome.get("row"))
                diagnostics.count("sweep_cells_coalesced",
                                  len(coalesced))
                if abandoned:
                    diagnostics.count("sweep_cells_evaluated",
                                      len(abandoned))
                    outcomes.update(run_cells(abandoned, **run_kwargs))
    finally:
        if flights is not None:
            # a sweep that dies mid-run must wake its followers: any
            # claim it never published is abandoned (they re-evaluate)
            for idx, okey in owned.items():
                if idx not in published:
                    flights.abandon(okey)
        if journal:
            journal.close()
    # merge outcomes back in deterministic grid order so ranking and
    # dedup are identical however the cells were scheduled
    cached_row_ids = set()
    for cell in cells:
        from_store = False
        prior = replayed.get(cell.idx)
        if prior is None and cell.idx in cached:
            prior = cached[cell.idx]
            from_store = True
        if prior is None and cell.idx in coalesced:
            # served by a concurrent sweep's in-flight evaluation:
            # same record shape as a store hit, same merge semantics
            prior = coalesced[cell.idx]
            from_store = True
        if prior is not None:
            status, row = prior["status"], prior.get("row")
            err = prior.get("error")
        else:
            out = outcomes.get(cell.idx)
            if out is None:  # defensive: executor lost a cell
                continue
            status, row, err = out.status, out.row, out.error
        if status == "error":
            st = make_cell_strategy(base_strategy, cell.tp, cell.cp,
                                    cell.ep, cell.pp, cell.zero)
            quarantine.append(_quarantine_row(st, cell.rc, err or {}))
        elif status == "ok" and row and row.get("fits"):
            rows.append(row)
            if from_store:
                cached_row_ids.add(id(row))
    diagnostics.count("sweep_cells_quarantined", len(quarantine))
    # dedup: the recompute-layer search bottoming out at 0 layers is the
    # same candidate as the no-recompute row
    seen = set()
    uniq = []
    for r in rows:
        rl = r["recompute_layers"] if r["recompute"] != "none" else 0
        key = (r["tp"], r["cp"], r["ep"], r["pp"], r["vp"], r["zero"],
               r["mbs"], r["mbc"], r["recompute"], rl)
        if key in seen:
            continue
        seen.add(key)
        uniq.append(r)
    rows = uniq
    rows.sort(key=lambda r: r["mfu"], reverse=True)
    if engine == "batched":
        _verify_topk_rows(
            rows, base_strategy, model, system,
            topk if verify_topk is None else verify_topk,
            cache, diagnostics,
        )
        for r in rows:
            r.pop("strategy_spec", None)
    if csv_path:
        # store-served cells are auditable in the CSV (status=cached,
        # like status=deduped rows) without perturbing the returned
        # rows — responses stay bit-identical cache-on vs cache-off
        csv_result_rows = [
            {**r, "status": "cached"} if id(r) in cached_row_ids else r
            for r in rows
        ]
        csv_rows = csv_result_rows + quarantine + pruned_rows \
            + deduped_rows + screened_rows
        fields: List[str] = []
        for r in csv_rows:
            for k in r:
                if k != "net" and k not in fields:
                    fields.append(k)
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(csv_rows)
    return rows[:topk]


def _run_guided(cells, to_run, replayed, cached, base_strategy, model,
                diagnostics, topk, run_kwargs, global_batch_size,
                system):
    """Pareto-guided evaluation (docs/search.md "Guided search"):
    screen every schedulable cell with one cheap batched-kernel score,
    fully evaluate only the Pareto frontier over
    (iter_time, peak_mem, comm_fraction) plus seeds and their local
    neighborhoods, then iteratively refine around the current top-k
    until no unevaluated neighbor remains. Returns
    ``(outcomes, screened_rows)`` — outcomes only for evaluated cells;
    the screened-but-skipped cells become auditable ``status=screened``
    CSV rows. Journaling/resume ride the normal ``run_cells``
    checkpoint hook, so a killed guided sweep resumes like a grid one."""
    from simumax_tpu_torch.search import executor as _executor
    from simumax_tpu_torch.search.batched import UnsupportedBatched
    from simumax_tpu_torch.search.prune import (
        CellNeighborhood,
        pareto_frontier,
        screened_row,
    )

    hood = CellNeighborhood(cells)
    by_idx = {c.idx: c for c in cells}
    to_run_by_idx = {c.idx: c for c in to_run}
    scorer = _executor._batched_scorer(model, system,
                                       run_kwargs["device"])
    screens: Dict[int, Optional[dict]] = {}
    cell_strategies: Dict[int, object] = {}
    must = set()
    for cell in to_run:
        cell_strategies[cell.idx] = make_cell_strategy(
            base_strategy, cell.tp, cell.cp, cell.ep, cell.pp,
            cell.zero)
    # one sweep-wide batched screen: every cell's fold rides a shared
    # FoldBatch (cells sharing a schedule shape share one kernel
    # launch), with triples bit-identical to per-cell
    # screen_cell — see docs/search.md "Guided search"
    results = scorer.screen_cells(
        [(cell_strategies[c.idx], c.rc) for c in to_run],
        model, global_batch_size)
    for cell, res in zip(to_run, results):
        if isinstance(res, UnsupportedBatched):
            must.add(cell.idx)  # unscreenable: evaluate unconditionally
        elif isinstance(res, Exception):
            # conservative: ANY screen failure (incl. a FeasibilityError
            # the prune layer should have caught) must not skip the
            # cell — evaluating it reproduces grid mode's verdict
            # (quarantined error row) instead of silently dropping it
            diagnostics.warn(
                "search",
                f"guided screen failed for {cell.key}: {res}",
            )
            must.add(cell.idx)
        else:
            screens[cell.idx] = res
    diagnostics.count("sweep_cells_screened", len(screens) + len(must))
    valid = {i: t for i, t in screens.items() if t is not None}
    frontier = pareto_frontier({
        i: (t["iter_time"], t["peak_bytes"], t["comm_fraction"])
        for i, t in valid.items()
    })
    # seeds: the frontier plus the fastest-screened cells (covers
    # frontier gaps when one objective dominates the ranking)
    n_seed = max(topk, 4)
    by_time = sorted(valid,
                     key=lambda i: (valid[i]["iter_time"], i))[:n_seed]
    seeds = set(frontier) | set(by_time)
    selected = set(seeds) | must
    for i in sorted(seeds):
        for nb in hood.neighbors(by_idx[i]):
            selected.add(nb.idx)
    # already-settled cells (journal replay / store) participate in the
    # refinement ranking but are never re-evaluated
    rows_by_idx: Dict[int, dict] = {}
    for idx, prior in list(replayed.items()) + list(cached.items()):
        row = prior.get("row")
        if prior.get("status") == "ok" and row and row.get("fits"):
            rows_by_idx[idx] = row
    outcomes: Dict[int, object] = {}
    evaluated = set()
    wave = sorted(i for i in selected if i in to_run_by_idx)
    while wave:
        got = run_cells([to_run_by_idx[i] for i in wave], **run_kwargs)
        outcomes.update(got)
        evaluated.update(wave)
        for i, out in got.items():
            if out.status == "ok" and out.row and out.row.get("fits"):
                rows_by_idx[i] = out.row
        # refine: expand around the current top-k until it stabilizes
        top = sorted(
            rows_by_idx,
            key=lambda i: (-rows_by_idx[i]["mfu"], i),
        )[:topk]
        new = set()
        for i in top:
            cell = by_idx.get(i)
            if cell is None:
                continue
            for nb in hood.neighbors(cell):
                if nb.idx in to_run_by_idx and nb.idx not in selected:
                    new.add(nb.idx)
        selected |= new
        wave = sorted(i for i in new if i not in evaluated)
    screened_rows = []
    for cell in to_run:
        if cell.idx in selected:
            continue
        tri = screens.get(cell.idx)
        if tri is None:
            continue  # invalid family: an empty cell either way
        screened_rows.append(
            screened_row(cell_strategies[cell.idx], cell.rc, tri))
    diagnostics.count("sweep_cells_guided_skipped", len(screened_rows))
    return outcomes, screened_rows


def _verify_topk_rows(rows, base_strategy, model, system, k,
                      cache, diagnostics):
    """Re-evaluate the top ``k`` ranked batched rows with the scalar
    oracle (``evaluate_strategy``) and replace them in place, so the
    rows a batched sweep returns are exact scalar rows (attribution
    lines included). Each batched row carries a ``strategy_spec``
    reconstruction recipe (``executor._strategy_spec``); rows without
    one came from a scalar-fallback cell and are already exact. A
    disagreement (the oracle says the candidate does not fit or is
    invalid) is recorded as a diagnostics error and the batched row is
    kept — with the 1e-9 score parity contract this is a should-never
    guard, not an expected path."""
    build_cache = BoundedCache(maxsize=BUILD_CACHE_MAX)
    verified = 0
    for i in range(min(k, len(rows))):
        spec = rows[i].get("strategy_spec")
        if not spec:
            continue
        st = clone_strategy(base_strategy)
        for name, value in spec["fields"].items():
            setattr(st, name, value)
        st.__post_init__()
        vrow = evaluate_strategy(
            st, model, system, cache=cache,
            gib_margin=spec.get("gib_margin", 0.0),
            build_cache=build_cache,
        )
        if vrow is not None and vrow.get("fits"):
            vrow["status"] = "ok"
            rows[i] = vrow
            verified += 1
        else:
            diagnostics.error(
                "batched_verify",
                "scalar oracle disagrees with a batched top-k row "
                "(keeping the batched row)",
                candidate=f"tp{st.tp_size}_cp{st.cp_size}_ep{st.ep_size}"
                          f"_pp{st.pp_size}_z{st.zero_state}",
                mbs=st.micro_batch_size, mbc=st.micro_batch_num,
            )
    diagnostics.count("sweep_rows_verified", verified)


def _quarantine_row(st, rc: str, err: dict) -> dict:
    """A CSV-compatible ``status=error`` row for a failed sweep cell."""
    row = base_cell_row(st, rc, "error")
    row["error_type"] = err.get("error_type", "")
    row["error_msg"] = err.get("error_msg", "")
    return row


@dataclass
class StrategySearcher:
    """Grid searcher over candidate dicts (reference
    ``tuning/strategy_searcher.py:12-216``)."""

    model: ModelConfig
    system: SystemConfig
    base_strategy: StrategyConfig
    cache: Dict = field(default_factory=BoundedCache)

    def search(
        self,
        global_batch_size: int,
        topk: int = 3,
        csv_path: Optional[str] = None,
        device: str = "cuda",
        **sweep_lists,
    ) -> List[dict]:
        return search_best_parallel_strategy(
            self.base_strategy,
            self.model,
            self.system,
            global_batch_size,
            topk=topk,
            csv_path=csv_path,
            cache=self.cache,
            device=device,
            **sweep_lists,
        )

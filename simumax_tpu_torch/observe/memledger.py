"""Per-tensor HBM ledger, peak-memory waterfall, and OOM forensics —
the memory-side twin of the cost-attribution ledger (``observe/ledger``).

``analysis_mem`` predicts each stage's peak HBM as one scalar; this
module keeps the provenance behind that scalar. :meth:`MemoryLedger.
collect` replays the same analytical schedules the estimate used (the
1F1B / interleaved replay paths in ``perf.py`` and the per-chunk
activation walk in ``models/llm.py``) and materializes the **full live
set at each stage's predicted peak**: every allocation as a
:class:`~simumax_tpu_torch.core.records.MemSpan` with module path, best-effort
shape, dtype, and sharding provenance, bucketed into a **peak-HBM
waterfall** (params / grads / optimizer states / activation cache /
recompute working set / workspace / comm buffers / MoE routing / MLA
latent-KV) whose buckets sum to ``analysis_mem()["max_peak_bytes"]``
within 1e-6 relative (asserted in tests across dense/MoE/MLA x
pp{1,2,4} x recompute).

Collection is post-hoc and read-only: ledger-on and ledger-off headline
predictions are bit-identical, and sweeps never collect (their rows
carry only the one-line :func:`memory_attribution_line`, derived from
the already-cached ``analysis_mem``).

Three more surfaces ride on the same data:

* **analytical memory timeline** — :func:`analytical_memory_trackers`
  drives a :class:`~simumax_tpu_torch.simulator.memory.SimuMemoryTracker`
  per stage from the schedule replay, so the analytical prediction
  ships the *same* artifacts as the discrete-event simulator (JSON
  snapshot schema, torch memory-viz pickle, Chrome counter tracks) and
  the two can be diffed directly;
* **analytical-vs-DES cross-check** — :func:`mem_crosscheck` compares
  per-stage peaks against a ``simulate(track_memory=True)`` run, the
  memory analog of the sweep's ``sim_vs_analytical`` column;
* **OOM forensics** — :func:`oom_forensics` reports the top holders at
  the binding stage's peak plus :func:`whatif_probes`: re-costed
  candidate fixes (halved micro-batch via the existing ``rebatch()``
  build-reuse fast path, recompute escalation, the next ZeRO stage),
  ranked so the *cheapest fitting change* is named explicitly.

CLI: ``simumax_tpu_torch explain --memory`` and ``simumax_tpu_torch diff
--memory`` (see the JAX package's ``docs/observability.md``).

Copy of the JAX package's ``observe/memledger.py`` with its import paths
changed and the snapshot schema tag naming this package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from simumax_tpu_torch.core.config import GiB
from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.core.records import Diagnostics, MemSpan

MEM_LEDGER_SCHEMA = "simumax-memledger-v1"

#: peak-HBM waterfall buckets in presentation order; they sum to the
#: stage's ``analysis_mem`` ``peak_bytes`` (definitions in
#: docs/observability.md). ``recompute_working_set`` may go slightly
#: negative when a peak lands mid-replay with the saved segment input
#: reuse outweighing the re-materialized raw caches.
MEM_WATERFALL_ORDER = (
    "params",
    "grads",
    "optimizer_states",
    "activation_cache",
    "recompute_working_set",
    "workspace",
    "comm_buffers",
    "moe_routing",
    "mla_latent_kv",
)

_MEM_SHORT = {
    "params": "wt",
    "grads": "grad",
    "optimizer_states": "opt",
    "activation_cache": "act",
    "recompute_working_set": "recomp",
    "workspace": "wksp",
    "comm_buffers": "comm",
    "moe_routing": "moe",
    "mla_latent_kv": "kv",
}

#: leaf op categories whose activation state is routing bookkeeping
#: (dispatch/combine indices, router logits) rather than generic caches
_MOE_ROUTING_CATEGORIES = frozenset({"router", "moe_dispatch"})
#: MLA down-projections cache the compressed latent the runtime would
#: keep as the KV cache — surfaced as their own bucket so the latent-KV
#: saving of MLA (ROADMAP item 4's serving workload) is visible
_MLA_LATENT_CATEGORIES = frozenset({"mla_down_proj"})

#: transient probe kinds -> waterfall bucket
_TRANSIENT_BUCKET = {
    "fwd_temp": "workspace",
    "bwd_temp": "workspace",
    "grad_flight": "comm_buffers",
    "saved_input_reuse": "recompute_working_set",
    "recompute_cache": "recompute_working_set",
}


def _cache_bucket(leaf) -> str:
    cat = getattr(leaf, "op_category", "other")
    if cat in _MOE_ROUTING_CATEGORIES:
        return "moe_routing"
    if cat in _MLA_LATENT_CATEGORIES:
        return "mla_latent_kv"
    return "activation_cache"


def _holder_bucket(leaf, kind: str) -> str:
    if kind == "act_cache":
        return _cache_bucket(leaf)
    return _TRANSIENT_BUCKET[kind]


def _param_shape(leaf) -> Optional[str]:
    """Best-effort parameter shape: GEMM leaves expose their (k, n) via
    ``gemm_mnk``; the embedding its (vocab, hidden); norms their width."""
    if hasattr(leaf, "gemm_mnk") and leaf.outputs:
        b, _, k, n = leaf.gemm_mnk("fwd")
        return f"({b}, {k}, {n})" if b > 1 else f"({k}, {n})"
    if hasattr(leaf, "vocab") and hasattr(leaf, "hidden"):
        return f"({leaf.vocab}, {leaf.hidden})"
    if hasattr(leaf, "hidden"):
        return f"({leaf.hidden},)"
    return None


def _act_shape_dtype(leaf) -> Tuple[Optional[str], str]:
    """Indicative shape/dtype of a leaf's cached activation (the module
    input it saves for backward)."""
    if leaf.inputs:
        t = leaf.inputs[0]
        return str(list(t.shape)), t.dtype
    return None, ""


def _param_sharding(st, kind: str, moe: bool) -> str:
    """Provenance string: which ZeRO stage shards this tensor family and
    over which data-parallel group (mirrors ``make_param_info``)."""
    dim = "edp" if moe else "dp_cp"
    group = st.edp_size if moe else st.dp_size * st.cp_size
    sharded_from = {"weight": 3, "grad": 2, "opt_state": 1}[kind]
    z = st.zero_state
    verb = "sharded" if z >= sharded_from and group > 1 else "replicated"
    return f"zero{z}: {verb} over {dim}{group}"


def _act_sharding(st) -> str:
    parts = [f"cp{st.cp_size}"]
    if st.enable_sequence_parallel and st.tp_size > 1:
        parts.append(f"sp{st.tp_size}")
    return "seq " + "x".join(parts)


# --------------------------------------------------------------------------
# Peak live-set materialization
# --------------------------------------------------------------------------


def replay_peak_holders(chunk) -> Tuple[float, List[Tuple[Any, str, float]]]:
    """Fold one chunk's ``activation_events()`` walk (the exact stream
    ``compute_activations`` folds to the scalar ``peak_point``) and
    materialize the live set at the winning probe.

    Returns ``(peak_bytes, holders)`` where ``holders`` is a list of
    ``(leaf, kind, bytes)`` summing to ``peak_bytes`` (up to float
    association); ``peak_bytes`` equals ``chunk.peak_point.bytes``.

    Two passes: the first locates the winning probe (the same
    ``cand > peak`` fold as ``compute_activations``), the second
    materializes holders only up to that probe — no per-probe copies.
    """
    # pass 1: locate the winning probe index
    live = 0.0
    peak_bytes = 0.0
    peak_idx = -1
    for idx, ev in enumerate(chunk.activation_events()):
        op = ev[0]
        if op == "alloc":
            live += ev[3]
        elif op == "free":
            live -= ev[3]
        else:
            cand = live
            for _, extra in ev[3]:
                cand += extra
            if cand > peak_bytes:
                peak_bytes, peak_idx = cand, idx
    if peak_idx < 0:
        return 0.0, []
    # pass 2: materialize the live set at that probe
    holders: Dict[Tuple[int, str], List] = {}
    for idx, ev in enumerate(chunk.activation_events()):
        op = ev[0]
        if op == "alloc":
            h = holders.setdefault((id(ev[1]), ev[2]), [ev[1], ev[2], 0.0])
            h[2] += ev[3]
        elif op == "free":
            h = holders.get((id(ev[1]), ev[2]))
            if h is not None:
                h[2] -= ev[3]
                if h[2] == 0.0:
                    del holders[(id(ev[1]), ev[2])]
        elif idx == peak_idx:
            out = [(l, k, b) for l, k, b in
                   (tuple(h) for h in holders.values()) if b]
            out.extend(
                (ev[1], kind, extra) for kind, extra in ev[3] if extra
            )
            return peak_bytes, out
    raise AssertionError("activation walk changed between passes")


def _interleaved_peak_state(perf, stage: int):
    """The interleaved schedule-position replay of one stage — the
    SHARED fold (``perf.interleaved_stage_peak``, the one
    ``_analysis_mem_interleaved`` itself uses) with the holder-side
    outputs kept: ``(counts, active_chunk)`` where ``counts`` maps
    chunk_idx -> number of full per-microbatch caches held at the peak
    (the active chunk's own microbatch already excluded — its partial
    state is the chunk walk's holder set) and ``active_chunk`` is None
    when the plain outstanding-cache sum won the max."""
    from simumax_tpu_torch.parallel.pipeline import interleaved_order
    from simumax_tpu_torch.perf import interleaved_stage_peak

    st = perf.strategy
    order = interleaved_order(
        st.pp_size, stage, st.micro_batch_num, st.vp_size,
        st.vpp_group_size,
    )
    chunks = perf.stage_chunks(stage)
    cache = {ch.chunk_idx: ch.act_info.cache_bytes for ch in chunks}
    peakpt = {
        ch.chunk_idx: ch.peak_point.bytes if ch.peak_point else 0.0
        for ch in chunks
    }
    _, _, peak_counts, peak_active = interleaved_stage_peak(
        order, cache, peakpt
    )
    return peak_counts, peak_active


def _param_spans(perf, stage: int) -> List[MemSpan]:
    st = perf.strategy
    spans: List[MemSpan] = []
    for chunk in perf.stage_chunks(stage):
        for leaf in chunk.called_leaves():
            pi = leaf.param_info
            if not pi.total_bytes:
                continue
            shape = _param_shape(leaf)
            for moe in (False, True):
                fam = (
                    (("weight", pi.moe_weight_bytes, "params", st.dtype),
                     ("grad", pi.moe_grad_bytes, "grads",
                      "fp32" if st.grad_element_size == 4 else st.dtype),
                     ("opt_state", pi.moe_state_bytes,
                      "optimizer_states", "fp32"))
                    if moe else
                    (("weight", pi.weight_bytes, "params", st.dtype),
                     ("grad", pi.grad_bytes, "grads",
                      "fp32" if st.grad_element_size == 4 else st.dtype),
                     ("opt_state", pi.state_bytes,
                      "optimizer_states", "fp32"))
                )
                for kind, nbytes, bucket, dtype in fam:
                    if not nbytes:
                        continue
                    spans.append(MemSpan(
                        path=leaf.path_name(),
                        module_type=type(leaf).__name__,
                        category=leaf.op_category,
                        stage=stage,
                        chunk=chunk.chunk_idx,
                        bucket=bucket,
                        kind=kind,
                        bytes=nbytes,
                        count=1,
                        shape=shape,
                        dtype=dtype,
                        sharding=_param_sharding(st, kind, moe),
                    ))
    return spans


def collect_stage_spans(perf, stage: int) -> List[MemSpan]:
    """The full live set at ``stage``'s predicted peak, as MemSpans that
    sum to ``analysis_mem()["stages"][stage]["peak_bytes"]`` within 1e-6
    relative (param spans + one activation cache per outstanding
    microbatch + the active chunk's internal-walk holders, mirroring the
    exact arithmetic ``analysis_mem`` used)."""
    st = perf.strategy
    spans = _param_spans(perf, stage)
    chunks = perf.stage_chunks(stage)
    act_shard = _act_sharding(st)

    if st.vp_size > 1:
        counts, active = _interleaved_peak_state(perf, stage)
        active_chunks = [c for c in chunks if c.chunk_idx == active]
    else:
        # the stage's in-flight count comes from analysis_mem itself
        # (the stable schema's live_microbatches), not a re-derived
        # formula — one source, so the ledger cannot drift from the
        # headline's admission model
        live = perf.analysis_mem()["stages"][stage]["live_microbatches"]
        out = max(live - 1, 0)
        counts = {c.chunk_idx: out for c in chunks}
        # vp=1 has one chunk per stage; its internal walk peak always
        # rides on top of the outstanding caches (analysis_mem adds
        # replay_peak unconditionally)
        active_chunks = (
            [max(chunks, key=lambda c:
                 c.peak_point.bytes if c.peak_point else 0.0)]
            if chunks else []
        )

    # one full per-microbatch activation cache per outstanding microbatch
    for chunk in chunks:
        n = counts.get(chunk.chunk_idx, 0)
        if n <= 0:
            continue
        for leaf in chunk.called_leaves():
            cb = leaf.act_info.cache_bytes
            if not cb:
                continue
            shape, dtype = _act_shape_dtype(leaf)
            spans.append(MemSpan(
                path=leaf.path_name(),
                module_type=type(leaf).__name__,
                category=leaf.op_category,
                stage=stage,
                chunk=chunk.chunk_idx,
                bucket=_cache_bucket(leaf),
                kind="act_cache",
                bytes=cb * n,
                count=n,
                shape=shape,
                dtype=dtype,
                sharding=act_shard,
            ))

    # the active chunk's internal activation walk at ITS peak: building
    # caches, recompute raw caches, fwd/bwd workspace, grads in flight
    for chunk in active_chunks:
        _, holders = replay_peak_holders(chunk)
        for leaf, kind, nbytes in holders:
            shape, dtype = _act_shape_dtype(leaf)
            spans.append(MemSpan(
                path=leaf.path_name(),
                module_type=type(leaf).__name__,
                category=leaf.op_category,
                stage=stage,
                chunk=chunk.chunk_idx,
                bucket=_holder_bucket(leaf, kind),
                kind=kind,
                bytes=nbytes,
                count=1,
                shape=shape,
                dtype=dtype,
                sharding=act_shard,
            ))
    return spans


def _bucket_sums(spans: List[MemSpan]) -> Dict[str, float]:
    buckets = {k: 0.0 for k in MEM_WATERFALL_ORDER}
    for s in spans:
        buckets[s.bucket] += s.bytes
    return buckets


def build_memory_waterfall(perf, spans_by_stage=None) -> Dict[str, Any]:
    """Decompose the headline peak-HBM prediction into the memory
    buckets. ``buckets`` belong to the binding (max-peak) stage and sum
    to ``analysis_mem()["max_peak_bytes"]`` within 1e-6 relative;
    ``per_stage`` carries every stage's decomposition.

    ``spans_by_stage`` (stage -> span list) reuses an already-collected
    live set instead of re-walking every chunk — ``MemoryLedger.
    collect`` passes its own so each stage is materialized once."""
    mem = perf.analysis_mem()
    if spans_by_stage is None:
        spans_by_stage = {
            s: collect_stage_spans(perf, s)
            for s in range(len(mem["stages"]))
        }
    per_stage = []
    for s, entry in enumerate(mem["stages"]):
        buckets = _bucket_sums(spans_by_stage[s])
        per_stage.append({
            "stage": s,
            "buckets": buckets,
            "total": entry["peak_bytes"],
            "fits_margin_bytes": entry["fits_margin_bytes"],
        })
    binding = mem["binding_stage"]
    return {
        "order": list(MEM_WATERFALL_ORDER),
        "buckets": per_stage[binding]["buckets"],
        "total": mem["max_peak_bytes"],
        "binding_stage": binding,
        "per_stage": per_stage,
        "usable_bytes": mem["usable_bytes"],
        "fits": mem["fits"],
    }


def memory_attribution_line(perf) -> str:
    """One-line peak-memory summary for sweep CSV rows, e.g.
    ``wt 21.3% | grad 10.7% | opt 32.0% | act 36.0%``. Derived from the
    already-cached ``analysis_mem`` only — no ledger walk, so sweeps
    stay on the zero-cost path (``act`` folds every activation-side
    bucket; the full split is ``explain --memory``)."""
    mem = perf.analysis_mem()
    entry = mem["stages"][mem["binding_stage"]]
    peak = entry["peak_bytes"] or 1.0
    act = entry["peak_bytes"] - entry["model_bytes"]
    parts = []
    for tag, v in (("wt", entry["weight_bytes"]),
                   ("grad", entry["grad_bytes"]),
                   ("opt", entry["optimizer_state_bytes"]),
                   ("act", act)):
        pct = round(100.0 * v / peak, 1) + 0.0
        parts.append(f"{tag} {pct:.1f}%")
    return " | ".join(parts)


# --------------------------------------------------------------------------
# Analytical memory timeline (SimuMemoryTracker schema)
# --------------------------------------------------------------------------


def analytical_memory_trackers(perf, record_events: bool = True) -> list:
    """Drive one :class:`~simumax_tpu_torch.simulator.memory.SimuMemoryTracker`
    per stage from the analytical schedule replay (``_schedule_events``
    — the exact intervals the headline time came from): static = the
    stage's model bytes, one activation-cache token per (microbatch,
    chunk) allocated at its forward's end and freed at its backward's
    end. Token naming (``mb{i}:c{chunk}``) matches the discrete-event
    simulator's chunk granularity, so snapshots/pickles from the two
    predictors diff directly. This is also the single source of the
    analytical ``hbm_bytes`` counter tracks in ``observe/trace.py``
    (which passes ``record_events=False`` to skip the per-event viz
    trace it does not serialize)."""
    from simumax_tpu_torch.simulator.memory import SimuMemoryTracker

    perf.analysis_cost()  # ensures the schedule replay ran (cached)
    st = perf.strategy
    trackers = []
    for s in range(st.pp_size):
        chunks = perf.stage_chunks(s)
        static = sum(c.param_info.total_bytes for c in chunks)
        cache = {c.chunk_idx: c.act_info.cache_bytes for c in chunks}
        tr = SimuMemoryTracker(s, static_bytes=static,
                               record_events=record_events,
                               source="analytical")
        stage_events = sorted(
            (e for e in perf._schedule_events if e[0] == s),
            key=lambda e: (e[4], e[5]),
        )
        for (_, kind, c, mb, _, end) in stage_events:
            nbytes = cache.get(c, 0.0)
            if not nbytes:
                continue
            token = f"mb{mb}:c{c}"
            if kind == "F":
                tr.alloc(end, nbytes, token, "act")
            else:
                tr.free(end, token=token, tag="act")
        trackers.append(tr)
    return trackers


def export_analytical_memory(perf, save_path: str) -> Dict[str, str]:
    """Write the analytical memory timeline in the simulator's artifact
    formats: the JSON snapshot (``simumax_tpu_torch_memory_snapshot_v1``), the
    torch memory-viz pickle (binding stage), and a Chrome trace of the
    per-stage ``hbm_bytes`` counter tracks."""
    from simumax_tpu_torch.simulator.memory import export_memory_viz
    from simumax_tpu_torch.simulator.trace import write_chrome_trace

    os.makedirs(save_path, exist_ok=True)
    trackers = analytical_memory_trackers(perf)
    paths = {}
    snap_path = os.path.join(save_path, "analytical_memory_snapshot.json")
    with open(snap_path, "w", encoding="utf-8") as f:
        json.dump([t.snapshot() for t in trackers], f)
    paths["snapshot"] = snap_path
    # the stage analysis_mem calls binding, not the tracker-peak argmax:
    # tracker timelines carry only whole-microbatch caches, so their
    # peaks can rank stages differently from the headline (which adds
    # the replay transient) — all artifacts of one run must agree on
    # which stage is binding
    binding = perf.analysis_mem()["binding_stage"]
    paths["memory_viz"] = export_memory_viz(
        trackers[binding],
        os.path.join(save_path, "analytical_memory_viz.pickle"),
    )
    paths["counters"] = write_chrome_trace(
        os.path.join(save_path, "analytical_memory_counters.json"),
        [], trackers,
    )
    return paths


def mem_crosscheck(perf, granularity: str = "leaf") -> Dict[str, Any]:
    """Per-stage analytical-vs-DES peak cross-check (the memory analog
    of the sweep's ``sim_vs_analytical`` time column): run the
    discrete-event simulator with memory tracking (one representative
    rank per stage) and compare each stage's simulated peak against
    ``analysis_mem``'s prediction. ``leaf`` granularity replays temps /
    recompute / grad-flight like the analytical walk; ``chunk`` only
    tracks whole-microbatch caches, so its peaks sit below the
    analytical number by the transient working set."""
    mem = perf.analysis_mem()
    sim = perf.simulate(None, granularity=granularity, track_memory=True)
    stages = []
    for s, summ in enumerate(sim["memory"]):
        ana = mem["stages"][s]["peak_bytes"]
        des = summ["peak_bytes"]
        stages.append({
            "stage": s,
            "analytical_peak_gib": ana / GiB,
            "des_peak_gib": des / GiB,
            "des_vs_analytical": (des / ana) if ana else None,
        })
    ratios = [r["des_vs_analytical"] for r in stages
              if r["des_vs_analytical"] is not None]
    return {
        "granularity": granularity,
        "stages": stages,
        "min_ratio": min(ratios) if ratios else None,
        "max_ratio": max(ratios) if ratios else None,
    }


# --------------------------------------------------------------------------
# OOM forensics / what-if probes
# --------------------------------------------------------------------------


def whatif_probes(perf) -> List[Dict[str, Any]]:
    """Re-cost candidate memory-saving changes against this estimate and
    report each one's feasibility and step-time cost. Probes:

    * ``halve_mbs`` — micro_batch_size/2, micro_batch_num*2 (same GBS),
      evaluated through the existing ``rebatch()`` build-reuse fast path
      on a copy of the built graph;
    * ``recompute=selective`` / ``recompute=full_block`` — escalate the
      recompute family (fresh build);
    * ``zero=N`` — the next ZeRO stage (fresh build).

    Never mutates ``perf``; probe failures from genuinely infeasible
    configs (``SimuMaxError`` family, ``rebatch``'s ``ValueError``) are
    reported as rows with an ``error`` field instead of aborting.
    ``AssertionError`` is deliberately NOT caught: an internal
    invariant violation (conservation/schedule checks) is an estimator
    bug and must stay loud — the same policy the sweep's
    ``evaluate_strategy`` documents."""
    import copy as _copy

    from simumax_tpu_torch.core.errors import SimuMaxError

    st = perf.strategy
    base_iter = perf.analysis_cost()["iter_time_ms"]
    # the schema's own threshold, not a re-derivation — probe margins
    # must use the same usable-HBM number the headline fits verdict did
    cap = perf.analysis_mem()["usable_bytes"]
    probes: List[Dict[str, Any]] = []

    def record(change: str, perf2):
        mem2 = perf2.analysis_mem()
        cost2 = perf2.analysis_cost()
        probes.append({
            "change": change,
            "fits": mem2["fits"],
            "peak_gib": mem2["max_peak_gib"],
            "mem_margin_gib": (cap - mem2["max_peak_bytes"]) / GiB,
            "iter_time_ms": cost2["iter_time_ms"],
            "iter_penalty_pct": (
                100.0 * (cost2["iter_time_ms"] - base_iter) / base_iter
                if base_iter else 0.0
            ),
        })

    def fail(change: str, exc: Exception):
        probes.append({"change": change, "fits": False,
                       "error": f"{type(exc).__name__}: {exc}"})

    if st.micro_batch_size > 1 and st.micro_batch_size % 2 == 0:
        change = (f"mbs {st.micro_batch_size} -> "
                  f"{st.micro_batch_size // 2} (mbc x2)")
        st2 = _copy.deepcopy(st)
        st2.micro_batch_size //= 2
        st2.micro_batch_num *= 2
        probe = _copy.deepcopy(perf)
        probe.diagnostics = Diagnostics()
        try:
            probe.rebatch(st2)
            record(change, probe)
        except (SimuMaxError, ValueError) as exc:
            fail(change, exc)

    rc = st.recompute
    rebuilds: List[Tuple[str, Dict[str, Any]]] = []
    if not rc.enabled:
        rebuilds.append(("recompute=selective(sdp)", dict(
            enable_recompute=True, recompute_granularity="selective",
            recompute_layer_num=-1, sdp_recompute=True,
        )))
    if rc.granularity != "full_block":
        rebuilds.append(("recompute=full_block", dict(
            enable_recompute=True, recompute_granularity="full_block",
            recompute_layer_num=-1,
        )))
    if st.zero_state < 3 and st.dp_size * st.cp_size > 1:
        rebuilds.append((f"zero={st.zero_state + 1}", dict(
            zero_state=st.zero_state + 1,
        )))
    for change, fields in rebuilds:
        st2 = _copy.deepcopy(st)
        for k, v in fields.items():
            setattr(st2, k, v)
        try:
            st2.__post_init__()
            from simumax_tpu_torch.perf import PerfLLM

            p2 = PerfLLM()
            p2.diagnostics = Diagnostics()
            p2.configure(st2, _copy.deepcopy(perf.model_config),
                         _copy.deepcopy(perf.system))
            p2.run_estimate()
            record(change, p2)
        except (SimuMaxError, ValueError) as exc:
            fail(change, exc)
    fitting = [p for p in probes if p.get("fits")]
    if fitting:
        cheapest = min(fitting, key=lambda p: p["iter_time_ms"])
        cheapest["cheapest_fit"] = True
    return probes


def oom_forensics(perf, top: int = 8, probes: bool = True,
                  spans: Optional[List[MemSpan]] = None) -> Dict[str, Any]:
    """Forensic report for a config's HBM verdict: the binding stage,
    deficit vs usable HBM, the top holders of its peak live set, and
    (optionally) the what-if probe table naming the cheapest fitting
    change. Useful for fits=True configs too (headroom audit), but built
    for the ``fits=False`` triage loop.

    ``spans`` reuses an already-collected span list (e.g. a
    ``MemoryLedger``'s) instead of re-walking the binding stage."""
    mem = perf.analysis_mem()
    binding = mem["binding_stage"]
    if spans is None:
        spans = collect_stage_spans(perf, binding)
    holders = sorted((s for s in spans if s.stage == binding),
                     key=lambda s: s.bytes, reverse=True)
    return {
        "fits": mem["fits"],
        "binding_stage": binding,
        "peak_gib": mem["max_peak_gib"],
        "usable_gib": mem["usable_gib"],
        "deficit_gib": max(0.0, -mem["fits_margin_bytes"]) / GiB,
        "top_holders": [s.to_dict() for s in holders[:top]],
        "what_if": whatif_probes(perf) if probes else [],
    }


def oom_forensic_lines(report: Dict[str, Any]) -> List[str]:
    """Human rendering of an OOM forensics report."""
    verdict = "fits" if report["fits"] else "OOM"
    lines = [
        f"== memory forensics: stage {report['binding_stage']} peaks at "
        f"{report['peak_gib']:.2f} GiB / {report['usable_gib']:.2f} GiB "
        f"usable ({verdict}"
        + (f", deficit {report['deficit_gib']:.2f} GiB" if not report["fits"]
           else "")
        + ") =="
    ]
    if report["top_holders"]:
        lines.append("  -- top holders at the peak --")
        for h in report["top_holders"]:
            n = f" x{h['count']}" if h["count"] > 1 else ""
            shape = f" {h['shape']}" if h["shape"] else ""
            lines.append(
                f"  {h['bytes'] / GiB:8.3f} GiB  [{h['bucket']}] "
                f"{h['path']} ({h['kind']}{n}{shape}, {h['sharding']})"
            )
    if report["what_if"]:
        lines.append("  -- what-if probes (same GBS) --")
        for p in report["what_if"]:
            if "error" in p:
                lines.append(f"    {p['change']:<28} infeasible: "
                             f"{p['error']}")
                continue
            tag = "fits" if p["fits"] else "OOM "
            star = "  <- cheapest fit" if p.get("cheapest_fit") else ""
            lines.append(
                f"    {p['change']:<28} {tag} peak {p['peak_gib']:7.2f} "
                f"GiB  iter {p['iter_time_ms']:9.2f} ms "
                f"({p['iter_penalty_pct']:+.1f}%){star}"
            )
    return lines


# --------------------------------------------------------------------------
# The ledger object
# --------------------------------------------------------------------------


@dataclass
class MemoryLedger:
    """The collected memory-attribution record of one estimate."""

    meta: Dict[str, Any] = field(default_factory=dict)
    headline: Dict[str, Any] = field(default_factory=dict)
    waterfall: Dict[str, Any] = field(default_factory=dict)
    spans: List[MemSpan] = field(default_factory=list)
    #: per-stage analytical timeline in the simulator's snapshot schema
    timeline: List[Dict[str, Any]] = field(default_factory=list)

    @classmethod
    def collect(cls, perf, timeline: bool = True) -> "MemoryLedger":
        assert perf.ctx is not None, "call run_estimate() before collect()"
        st, m, sysc = perf.strategy, perf.model_config, perf.system
        mem = perf.analysis_mem()
        identity = {
            "model": m.model_name,
            "system": sysc.sys_name,
            "system_hash": sysc.fingerprint(),
            "seq_len": st.seq_len,
            "global_batch_size": st.global_batch_size,
            "parallelism": {
                "tp": st.tp_size, "cp": st.cp_size, "pp": st.pp_size,
                "dp": st.dp_size, "ep": st.ep_size, "etp": st.etp_size,
                "vp": st.vp_size, "zero": st.zero_state,
                "mbs": st.micro_batch_size, "mbc": st.micro_batch_num,
            },
            # memory-relevant knobs the time ledger's identity omits:
            # two runs differing only in recompute wiring have
            # different peaks and must not share a run_id. Explicit
            # fields (not asdict) so the hash stays stable: the
            # frozenset tail_modules would stringify in hash-seed order
            "recompute": {
                "granularity": st.recompute.granularity,
                "layer_num": st.recompute.recompute_layer_num,
                "attn": st.recompute.attn_recompute,
                "attn_norm": st.recompute.attn_norm_recompute,
                "mlp": st.recompute.mlp_recompute,
                "mlp_norm": st.recompute.mlp_norm_recompute,
                "sdp": st.recompute.sdp_recompute,
                "moe_act": st.recompute.moe_act_recompute,
                "mla_up_proj": st.recompute.mla_up_proj_recompute,
                "variance": st.recompute.variance,
                "tail_modules": sorted(st.recompute.tail_modules),
            },
            "mem_factor": st.mem_factor,
        }
        run_id = Diagnostics.identity_hash(identity)
        if not perf.diagnostics.run_id:
            perf.diagnostics.set_run_identity(identity)
        # one walk per stage: the waterfall and the span list are two
        # views of the same collected live sets
        spans_by_stage = {
            s: collect_stage_spans(perf, s) for s in range(st.pp_size)
        }
        wf = build_memory_waterfall(perf, spans_by_stage=spans_by_stage)
        spans = [
            span
            for s in range(st.pp_size)
            for span in spans_by_stage[s]
        ]
        return cls(
            meta={"run_id": run_id, **identity,
                  "world_size": st.world_size},
            headline={
                "max_peak_gib": mem["max_peak_gib"],
                "usable_gib": mem["usable_gib"],
                "hbm_capacity_gib": mem["hbm_capacity_gib"],
                "fits": mem["fits"],
                "mem_margin_gib": mem["fits_margin_bytes"] / GiB,
                "stage_peak_gib": [s["peak_gib"] for s in mem["stages"]],
                "stage_margin_gib": [
                    s["fits_margin_bytes"] / GiB for s in mem["stages"]
                ],
            },
            waterfall=wf,
            spans=spans,
            # snapshot() never serializes the per-event viz trace, so
            # skip recording it (export_analytical_memory builds its
            # own event-recording trackers for the pickle)
            timeline=(
                [t.snapshot() for t in
                 analytical_memory_trackers(perf, record_events=False)]
                if timeline else []
            ),
        )

    # -- aggregation -------------------------------------------------------
    def span_rows(self, stage: Optional[int] = None) -> List[Dict[str, Any]]:
        """Per-path rows (kinds folded) for one stage (default: the
        binding stage), sorted by bytes held at the peak descending —
        the `explain --memory` top-holders table."""
        if stage is None:
            stage = self.waterfall.get("binding_stage", 0)
        rows: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for s in self.spans:
            if s.stage != stage:
                continue
            r = rows.setdefault((s.path, s.bucket), {
                "path": s.path, "module_type": s.module_type,
                "category": s.category, "stage": s.stage,
                "chunk": s.chunk, "bucket": s.bucket, "kinds": [],
                "bytes": 0.0, "count": 0, "shape": s.shape,
                "dtype": s.dtype, "sharding": s.sharding,
            })
            r["bytes"] += s.bytes
            # additive: total instances folded into ``bytes`` (e.g. 3
            # outstanding full caches + the active microbatch's partial
            # one -> count 4), keeping bytes/count a true average
            r["count"] += s.count
            if s.kind not in r["kinds"]:
                r["kinds"].append(s.kind)
        out = sorted(rows.values(), key=lambda r: r["bytes"], reverse=True)
        # share is of the REQUESTED stage's own peak, not the binding
        # stage's — rows of any stage sum to ~1
        per_stage = self.waterfall.get("per_stage") or []
        total = (
            per_stage[stage]["total"] if stage < len(per_stage)
            else self.waterfall.get("total")
        ) or 1.0
        for r in out:
            r["share"] = r["bytes"] / total
            r["kinds"] = ",".join(r["kinds"])
        return out

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": MEM_LEDGER_SCHEMA,
            "meta": self.meta,
            "headline": self.headline,
            "waterfall": self.waterfall,
            "spans": [s.to_dict() for s in self.spans],
            "timeline": self.timeline,
        }

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @staticmethod
    def load(path: str) -> Dict[str, Any]:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        schema = data.get("schema")
        if schema != MEM_LEDGER_SCHEMA:
            raise ConfigError(
                f"{path}: not a simumax memory ledger (schema={schema!r}; "
                f"expected {MEM_LEDGER_SCHEMA!r} — produce one with "
                f"`simumax_tpu_torch explain ... --memory --json PATH`)"
            )
        return data

    # -- presentation ------------------------------------------------------
    def waterfall_lines(self) -> List[str]:
        """Human peak-HBM waterfall rendering (the `explain --memory`
        default output)."""
        wf = self.waterfall
        total = wf["total"] or 1.0
        width = max(len(k) for k in wf["order"])
        verdict = "fits" if self.headline["fits"] else "OOM"
        lines = [
            f"== peak-HBM waterfall: {self.meta['model']} on "
            f"{self.meta['system']} — stage {wf['binding_stage']} peaks "
            f"at {self.headline['max_peak_gib']:.2f} GiB / "
            f"{self.headline['usable_gib']:.2f} GiB usable "
            f"({verdict}, margin "
            f"{self.headline['mem_margin_gib']:+.2f} GiB) =="
        ]
        for key in wf["order"]:
            v = wf["buckets"][key]
            if v == 0.0:
                continue
            gib = round(v / GiB, 3) + 0.0
            pct = round(100.0 * v / total, 2) + 0.0
            lines.append(f"  {key:<{width}}  {gib:10.3f} GiB  {pct:6.2f}%")
        lines.append(
            f"  {'= peak HBM':<{width}}  {total / GiB:10.3f} GiB  100.00%"
        )
        return lines

    def top_holder_lines(self, n: int = 10) -> List[str]:
        rows = self.span_rows()[:n]
        if not rows:
            return []
        lines = [
            f"-- top holders at stage "
            f"{self.waterfall['binding_stage']}'s peak --"
        ]
        for r in rows:
            cnt = f" x{r['count']}" if r["count"] > 1 else ""
            shape = f" {r['shape']}" if r["shape"] else ""
            lines.append(
                f"  {r['bytes'] / GiB:8.3f} GiB  {r['share'] * 100:5.1f}%  "
                f"[{r['bucket']}]  {r['path']} "
                f"({r['kinds']}{cnt}{shape}, {r['sharding']})"
            )
        return lines


# --------------------------------------------------------------------------
# Memory-ledger diffing
# --------------------------------------------------------------------------


def _span_totals(ledger: Dict[str, Any]) -> Dict[str, float]:
    """Per-path byte totals at the binding stage's peak."""
    binding = ledger["waterfall"].get("binding_stage", 0)
    out: Dict[str, float] = {}
    for s in ledger.get("spans", []):
        if s["stage"] != binding:
            continue
        out[s["path"]] = out.get(s["path"], 0.0) + s["bytes"]
    return out


def diff_memory_ledgers(a: Dict[str, Any], b: Dict[str, Any],
                        top: int = 20) -> Dict[str, Any]:
    """Compare two memory ledgers (two strategies, or before/after a
    model change): which buckets and which tensors account for the peak
    delta. Diffing a ledger against itself reports zero everywhere."""
    headline = {
        k: {
            "a": a["headline"].get(k),
            "b": b["headline"].get(k),
            "delta": (b["headline"].get(k) or 0.0)
            - (a["headline"].get(k) or 0.0),
        }
        for k in ("max_peak_gib", "mem_margin_gib")
    }
    wf = {
        k: {
            "a": a["waterfall"]["buckets"].get(k, 0.0),
            "b": b["waterfall"]["buckets"].get(k, 0.0),
            "delta": b["waterfall"]["buckets"].get(k, 0.0)
            - a["waterfall"]["buckets"].get(k, 0.0),
        }
        for k in set(a["waterfall"]["buckets"]) | set(b["waterfall"]["buckets"])
    }
    spans_a, spans_b = _span_totals(a), _span_totals(b)
    deltas = [
        {"path": p, "a": spans_a.get(p, 0.0), "b": spans_b.get(p, 0.0),
         "delta": spans_b.get(p, 0.0) - spans_a.get(p, 0.0)}
        for p in set(spans_a) | set(spans_b)
    ]
    deltas.sort(key=lambda d: abs(d["delta"]), reverse=True)
    # per-stage peaks: a change confined to a NON-binding stage moves
    # none of the binding-stage numbers above, but it is still a real
    # memory delta and must not read as "identical"
    peaks_a = a["headline"].get("stage_peak_gib") or []
    peaks_b = b["headline"].get("stage_peak_gib") or []
    n_stages = max(len(peaks_a), len(peaks_b))
    stage_peaks = [
        {"stage": s,
         "a": peaks_a[s] if s < len(peaks_a) else None,
         "b": peaks_b[s] if s < len(peaks_b) else None,
         "delta": (peaks_b[s] if s < len(peaks_b) else 0.0)
         - (peaks_a[s] if s < len(peaks_a) else 0.0)}
        for s in range(n_stages)
    ]
    identical = (
        all(v["delta"] == 0 for v in headline.values())
        and all(v["delta"] == 0 for v in wf.values())
        and all(d["delta"] == 0 for d in deltas)
        and len(peaks_a) == len(peaks_b)
        and all(s["delta"] == 0 for s in stage_peaks)
        and a["headline"].get("fits") == b["headline"].get("fits")
    )
    return {
        "schema": "simumax-memledger-diff-v1",
        "a": {"run_id": a["meta"].get("run_id"),
              "model": a["meta"].get("model"),
              "system": a["meta"].get("system"),
              "fits": a["headline"].get("fits"),
              "binding_stage": a["waterfall"].get("binding_stage", 0)},
        "b": {"run_id": b["meta"].get("run_id"),
              "model": b["meta"].get("model"),
              "system": b["meta"].get("system"),
              "fits": b["headline"].get("fits"),
              "binding_stage": b["waterfall"].get("binding_stage", 0)},
        "identical": identical,
        "headline": headline,
        "stage_peaks": stage_peaks,
        "waterfall": wf,
        "span_deltas": deltas[:top],
        "spans_only_in_a": sorted(set(spans_a) - set(spans_b))[:top],
        "spans_only_in_a_count": len(set(spans_a) - set(spans_b)),
        "spans_only_in_b": sorted(set(spans_b) - set(spans_a))[:top],
        "spans_only_in_b_count": len(set(spans_b) - set(spans_a)),
    }


def format_memory_diff_lines(diff: Dict[str, Any],
                             top: int = 10) -> List[str]:
    """Human rendering of a memory-ledger diff."""
    lines = [
        f"== memory-ledger diff: a={diff['a']['run_id']} "
        f"({diff['a']['model']} on {diff['a']['system']})  vs  "
        f"b={diff['b']['run_id']} "
        f"({diff['b']['model']} on {diff['b']['system']}) =="
    ]
    if diff["identical"]:
        lines.append("  identical: zero delta in every bucket and span")
        return lines
    h = diff["headline"]
    fits = {True: "fits", False: "OOM", None: "?"}
    lines.append(
        f"  peak {h['max_peak_gib']['a']:.2f} -> "
        f"{h['max_peak_gib']['b']:.2f} GiB "
        f"({h['max_peak_gib']['delta']:+.2f} GiB)   "
        f"margin {h['mem_margin_gib']['a']:+.2f} -> "
        f"{h['mem_margin_gib']['b']:+.2f} GiB   "
        f"[{fits[diff['a']['fits']]} -> {fits[diff['b']['fits']]}]"
    )
    if diff["a"].get("binding_stage") != diff["b"].get("binding_stage"):
        # each ledger's buckets and span totals describe its OWN binding
        # stage, so when the peak moved stages every section below
        # compares different stages' live sets — say so up front
        lines.append(
            f"  note: binding stage moved "
            f"{diff['a']['binding_stage']} -> {diff['b']['binding_stage']}"
            f" — the bucket and per-tensor sections below compare "
            f"different stages' live sets"
        )
    moved = [s for s in diff.get("stage_peaks", []) if s["delta"] != 0]
    if moved:
        lines.append("  -- per-stage peak deltas (b - a) --")
        for s in moved:
            a_gib = s["a"] if s["a"] is not None else 0.0
            b_gib = s["b"] if s["b"] is not None else 0.0
            lines.append(
                f"    stage {s['stage']}: {a_gib:8.2f} -> {b_gib:8.2f} "
                f"GiB  ({s['delta']:+.2f} GiB)"
            )
    lines.append("  -- waterfall bucket deltas (b - a) --")
    for key in MEM_WATERFALL_ORDER:
        d = diff["waterfall"].get(key)
        if d is None or (d["a"] == 0.0 and d["b"] == 0.0):
            continue
        lines.append(
            f"    {key:<22} {d['a'] / GiB:9.3f} -> {d['b'] / GiB:9.3f} GiB"
            f"  ({d['delta'] / GiB:+.3f} GiB)"
        )
    shown = [d for d in diff["span_deltas"] if d["delta"] != 0][:top]
    if shown:
        lines.append("  -- largest per-tensor deltas (binding stage) --")
        for d in shown:
            lines.append(
                f"    {d['delta'] / GiB:+9.3f} GiB  {d['path']}"
            )
    for side, key in (("a", "spans_only_in_a"), ("b", "spans_only_in_b")):
        if diff[key]:
            count = diff.get(f"{key}_count", len(diff[key]))
            lines.append(
                f"  tensors only in {side}: {count} (e.g. {diff[key][0]})"
            )
    return lines

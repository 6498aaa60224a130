"""Cost-attribution ledger (the tentpole of the observability layer).

``PerfLLM`` computes per-op FLOPs, bytes, efficiency factors and
per-collective cost terms, then aggregates them into ``CostInfo`` sums —
this module preserves that provenance instead of throwing it away:
:meth:`Ledger.collect` walks the retained symbolic module tree *after*
an estimate and materializes

* one :class:`~simumax_tpu_torch.core.records.OpSpan` per (leaf, phase) with
  the efficiency factor used, whether it was a calibrated hit or a
  default-table miss, and the roofline regime that bound the op;
* one :class:`~simumax_tpu_torch.core.records.CollectiveSpan` per collective
  call with its bandwidth/latency terms and exposed-vs-overlapped split;
* the **MFU-loss waterfall**: the headline step time decomposed into
  ideal compute -> compute inefficiency -> exposed comms -> pipeline
  bubble -> recompute -> DP/optimizer sync -> straggler, summing to the
  predicted iteration time (asserted to 1e-6 relative in tests).

Collection is strictly post-hoc and read-only: a run that never calls
``collect`` does zero ledger work, and a run that does gets bit-identical
predictions (the sweep therefore opts out by default and keeps its
throughput — see ``bench_sweep.py --baseline``).

Consumers: :func:`diff_ledgers` and the analytical Chrome-trace export
(``observe/trace.py``). Schema and a worked triage example: the JAX
package's ``docs/observability.md``.

Copy of the JAX package's ``observe/ledger.py`` with its import paths
changed and the JAX package's command-line surface (``explain``,
``diff``), which the port does not have yet, no longer named as a
consumer or in an error message.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.core.records import (
    PHASES,
    CollectiveSpan,
    Diagnostics,
    OpSpan,
)

LEDGER_SCHEMA = "simumax-ledger-v1"

#: waterfall buckets in presentation order; they sum to the headline
#: iteration time (the bucket definitions live in docs/observability.md)
WATERFALL_ORDER = (
    "ideal_compute",
    "compute_inefficiency",
    "exposed_comm",
    "pipeline_bubble",
    "recompute",
    "dp_optimizer_sync",
    "straggler",
)

#: compact labels for the one-line sweep attribution summary
_SHORT = {
    "ideal_compute": "ideal",
    "compute_inefficiency": "ineff",
    "exposed_comm": "comm",
    "pipeline_bubble": "bubble",
    "recompute": "recomp",
    "dp_optimizer_sync": "dp+opt",
    "straggler": "strag",
}

#: goodput waterfall buckets in presentation order; they sum to the job
#: wall time (``simulator/faults.py::predict_goodput``, docs/faults.md)
GOODPUT_WATERFALL_ORDER = (
    "useful_train",
    "fault_stall",
    "checkpoint_write",
    "restore_read",
    "restart_overhead",
    "restart_replay",
    "reshape",
)

_GOODPUT_SHORT = {
    "useful_train": "useful",
    "fault_stall": "stall",
    "checkpoint_write": "ckpt",
    "restore_read": "restore",
    "restart_overhead": "restart",
    "restart_replay": "replay",
    "reshape": "reshape",
}


def build_goodput_waterfall(report) -> Dict[str, Any]:
    """Normalize a ``GoodputReport`` (or its ``to_dict()``) into the
    same ``{order, buckets, total}`` shape as the MFU-loss waterfall —
    buckets sum to the job wall time within 1e-6 by construction (the
    goodput accounting is itself the decomposition)."""
    d = report if isinstance(report, dict) else report.to_dict()
    # .get: pre-reshape persisted reports carry no "reshape" bucket
    buckets = {k: d["buckets"].get(k, 0.0)
               for k in GOODPUT_WATERFALL_ORDER}
    return {
        "order": list(GOODPUT_WATERFALL_ORDER),
        "buckets": buckets,
        "total": d["wall_time_s"],
        "goodput": d["goodput"],
        "horizon_steps": d["horizon_steps"],
        "n_restarts": d["n_restarts"],
        "n_checkpoints": d["n_checkpoints"],
    }


def goodput_waterfall_lines(report) -> List[str]:
    """Human rendering of the goodput wall-time decomposition (the
    ``faults`` subcommand's default output)."""
    wf = build_goodput_waterfall(report)
    total = wf["total"] or 1.0
    width = max(len(k) for k in wf["order"])
    lines = [
        f"== goodput waterfall: {wf['horizon_steps']} steps — wall "
        f"{total:.1f} s, goodput {100.0 * wf['goodput']:.2f}% "
        f"({wf['n_checkpoints']} checkpoints, {wf['n_restarts']} "
        f"restarts) =="
    ]
    for key in wf["order"]:
        v = wf["buckets"][key]
        pct = round(100.0 * v / total, 2) + 0.0
        lines.append(f"  {key:<{width}}  {v:12.3f} s  {pct:6.2f}%")
    lines.append(
        f"  {'= wall time':<{width}}  {total:12.3f} s  100.00%"
    )
    return lines


def goodput_attribution_line(report) -> str:
    """One-line goodput summary, e.g. ``useful 91.2% | stall 3.1% |
    ckpt 2.0% | restore 0.4% | restart 1.8% | replay 1.5%``."""
    wf = build_goodput_waterfall(report)
    total = wf["total"] or 1.0
    parts = []
    for k in GOODPUT_WATERFALL_ORDER:
        pct = round(100.0 * wf["buckets"][k] / total, 1) + 0.0
        parts.append(f"{_GOODPUT_SHORT[k]} {pct:.1f}%")
    return " | ".join(parts)


def collect_op_spans(perf) -> Tuple[List[OpSpan], List[CollectiveSpan]]:
    """Walk every called leaf of the estimate's module tree and rebuild
    each cost decision's provenance. Adopted (layer-dedup) leaves share
    their representative's info objects, so the walk yields every
    physical leaf with the values the estimate actually charged."""
    sysc = perf.system
    ops: List[OpSpan] = []
    comms: List[CollectiveSpan] = []
    for (stage, chunk), model_chunk in sorted(perf.chunks.items()):
        for leaf in model_chunk.called_leaves():
            ci, cost = leaf.compute_info, leaf.cost_info
            for phase in PHASES:
                flops = getattr(ci, f"{phase}_flops")
                accessed = getattr(ci, f"{phase}_accessed")
                if flops <= 0 and accessed <= 0:
                    continue
                op_key, shape_key = leaf.comp_key(phase)
                # the estimate's own lookup, minus the hit/miss
                # recording side effect — provenance cannot diverge
                # from what was charged
                eff, hit, spec = sysc.resolve_op_efficiency(
                    op_key, shape_key, record=False
                )
                comp_t = (
                    flops / (spec.tflops * 1e12 * eff) if flops > 0 else 0.0
                )
                mem_t = (
                    sysc.compute_mem_access_time(accessed, leaf.bw_key(phase))
                    if accessed > 0 else 0.0
                )
                regime = (
                    "memory"
                    if sysc.accelerator.mode != "compute_only"
                    and mem_t > comp_t
                    else "compute"
                )
                ops.append(OpSpan(
                    path=leaf.path_name(),
                    module_type=type(leaf).__name__,
                    category=leaf.op_category,
                    stage=stage,
                    chunk=chunk,
                    phase=phase,
                    op_key=op_key,
                    shape_key=shape_key,
                    flops=flops,
                    bytes_accessed=accessed,
                    comp_time=comp_t,
                    mem_time=mem_t,
                    time=cost.compute.get(phase),
                    efficiency=eff,
                    calibrated=hit,
                    regime=regime,
                    recompute=leaf.in_recompute,
                ))
            for call in leaf.collective_calls:
                path = perf.ctx.path(call.dim)
                bw_t, lat_t = sysc.compute_net_op_terms(
                    call.op, call.size_bytes, path
                )
                comms.append(CollectiveSpan(
                    path=leaf.path_name(),
                    stage=stage,
                    chunk=chunk,
                    phase=call.phase,
                    op=call.op,
                    dim=call.dim,
                    size_bytes=call.size_bytes,
                    time=call.time,
                    exposed_time=call.exposed_time,
                    hidden_time=call.time - call.exposed_time,
                    bw_time=bw_t,
                    lat_time=lat_t,
                    on_dcn=path.on_dcn,
                ))
    return ops, comms


def build_waterfall(perf) -> Dict[str, Any]:
    """Decompose the headline iteration time into the MFU-loss buckets.

    The decomposition is constructive along the critical path the
    estimate itself took: the barrier-binding stage's schedule end is
    split into work (compute / exposed comm / recompute, each x mbc)
    plus bubble (waiting, incl. blocking p2p); the tail adds the
    exposed DP grad reduce, optimizer, and param gather of their
    binding stages; the straggler bucket is the closed-form inflation.
    The buckets therefore sum to ``iter_time`` up to float rounding
    (~1e-15 relative — asserted at 1e-6 in tests).

    ``compute_inefficiency`` may go slightly negative when a calibrated
    per-shape efficiency exceeds 1.0 (the validator admits up to 1.05);
    the sum invariant still holds.
    """
    cost = perf.analysis_cost()
    st = perf.strategy
    mbc = st.micro_batch_num
    s_rs = cost["binding_stage_rs"]
    s_tail = cost["binding_stage_tail"]
    end_rs = cost["per_stage_end"][s_rs]
    chunks = perf.stage_chunks(s_rs)
    peak = perf.system.accelerator.op["default"].tflops * 1e12
    flops_mb = sum(c.compute_info.total_flops for c in chunks)
    compute_t = mbc * sum(c.cost_info.compute.total for c in chunks)
    net_t = mbc * sum(c.cost_info.net_exposed.total for c in chunks)
    rec_t = mbc * sum(c.cost_info.recompute_time for c in chunks)
    ideal = mbc * flops_mb / peak
    work = compute_t + net_t + rec_t
    bubble = end_rs - work
    dp_opt = (cost["exposed_rs_time"] + cost["optim_time"]
              + cost["exposed_ag_time"])
    pre_straggle = end_rs + dp_opt
    buckets = {
        "ideal_compute": ideal,
        "compute_inefficiency": compute_t - ideal,
        "exposed_comm": net_t,
        "pipeline_bubble": bubble,
        "recompute": rec_t,
        "dp_optimizer_sync": dp_opt,
        "straggler": cost["iter_time"] - pre_straggle,
    }
    return {
        "order": list(WATERFALL_ORDER),
        "buckets": buckets,
        "total": cost["iter_time"],
        "binding_stage_rs": s_rs,
        "binding_stage_tail": s_tail,
        "mfu": cost["mfu"],
        "straggle_ratio": cost["straggle_ratio"],
    }


def attribution_line(perf) -> str:
    """One-line waterfall summary for sweep CSV rows / quick scans,
    e.g. ``ideal 41.9% | ineff 22.1% | comm 3.0% | bubble 12.4% |
    recomp 0.0% | dp+opt 11.6% | strag 9.0%``."""
    wf = build_waterfall(perf)
    total = wf["total"] or 1.0
    parts = []
    for k in WATERFALL_ORDER:
        # + 0.0 folds float -0.0 (epsilon-negative buckets) into "0.0"
        pct = round(100.0 * wf["buckets"][k] / total, 1) + 0.0
        parts.append(f"{_SHORT[k]} {pct:.1f}%")
    return " | ".join(parts)


@dataclass
class Ledger:
    """The collected attribution record of one estimate."""

    meta: Dict[str, Any] = field(default_factory=dict)
    headline: Dict[str, Any] = field(default_factory=dict)
    waterfall: Dict[str, Any] = field(default_factory=dict)
    mem: Dict[str, Any] = field(default_factory=dict)
    efficiency: Dict[str, Any] = field(default_factory=dict)
    #: per-stage bucketed DP grad/param comm + pp p2p detail (charged
    #: outside the leaf collectives, so recorded at step level)
    step_comm: Dict[str, Any] = field(default_factory=dict)
    op_spans: List[OpSpan] = field(default_factory=list)
    collective_spans: List[CollectiveSpan] = field(default_factory=list)

    # -- construction ------------------------------------------------------
    @classmethod
    def collect(cls, perf) -> "Ledger":
        assert perf.ctx is not None, "call run_estimate() before collect()"
        st, m, sysc = perf.strategy, perf.model_config, perf.system
        cost = perf.analysis_cost()
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
        }
        run_id = Diagnostics.identity_hash(identity)
        if not perf.diagnostics.run_id:
            # the estimate's diagnostics (and the process reporter) join
            # the ledger's run identity — also backfilling events that
            # were recorded during the estimate — so the diagnostics
            # report, --log-json lines, and this ledger all
            # cross-reference by run_id
            perf.diagnostics.set_run_identity(identity)
        ops, comms = collect_op_spans(perf)
        # step-level comm provenance: the bucketed DP grad/param comm
        # and per-microbatch pp transfer are charged outside the leaf
        # collectives, so their detail is recorded per stage here
        step_comm = {}
        for s in range(st.pp_size):
            detail = dict(perf._compute_dp_time(s))
            detail["pp_p2p_per_microbatch"] = (
                cost["stage_phase_inputs"][s]["p2p"]
            )
            for d in ("dp_cp", "edp", "pp"):
                path = perf.ctx.paths.get(d)
                if path is not None:
                    detail[f"{d}_on_dcn"] = path.on_dcn
            step_comm[f"stage{s}"] = detail
        eff = {
            "hits": {k: sorted(v) for k, v in sysc.hit_efficiency.items()},
            "misses": {k: sorted(v) for k, v in sysc.miss_efficiency.items()},
            "hit_count": sum(len(v) for v in sysc.hit_efficiency.values()),
            "miss_count": sum(len(v) for v in sysc.miss_efficiency.values()),
        }
        return cls(
            meta={"run_id": run_id, **identity,
                  "world_size": st.world_size},
            headline={
                "iter_time": cost["iter_time"],
                "iter_time_ms": cost["iter_time_ms"],
                "mfu": cost["mfu"],
                "tflops_per_chip": cost["tflops_per_chip"],
                "tgs": cost["tgs"],
                "peak_gib": mem["max_peak_gib"],
                "fits": mem["fits"],
                "straggle_ratio": cost["straggle_ratio"],
            },
            waterfall=build_waterfall(perf),
            mem={
                "max_peak_gib": mem["max_peak_gib"],
                "usable_gib": mem["usable_gib"],
                "stage_peak_gib": [s["peak_gib"] for s in mem["stages"]],
            },
            step_comm=step_comm,
            efficiency=eff,
            op_spans=ops,
            collective_spans=comms,
        )

    # -- aggregation -------------------------------------------------------
    def op_rows(self) -> List[Dict[str, Any]]:
        """Per-leaf rows (phases folded), sorted by total charged time
        descending — the `explain` top-N table. Times are per-microbatch
        seconds; ``share`` scales by mbc against the headline step time
        (an upper bound on the op's step share: ops off the binding
        stage or overlapped contribute less)."""
        rows: Dict[str, Dict[str, Any]] = {}
        for s in self.op_spans:
            r = rows.setdefault(s.path, {
                "path": s.path, "module_type": s.module_type,
                "category": s.category, "stage": s.stage, "chunk": s.chunk,
                "fwd_time": 0.0, "bwd_time": 0.0, "time": 0.0,
                "flops": 0.0, "bytes_accessed": 0.0,
                "efficiency": s.efficiency, "calibrated": s.calibrated,
                "regime": s.regime, "recompute": s.recompute,
            })
            r["time"] += s.time
            if s.phase == "fwd":
                r["fwd_time"] += s.time
            else:
                r["bwd_time"] += s.time
            r["flops"] += s.flops
            r["bytes_accessed"] += s.bytes_accessed
            # the op's weakest link is what calibration should target
            if s.efficiency < r["efficiency"]:
                r["efficiency"] = s.efficiency
            r["calibrated"] = r["calibrated"] and s.calibrated
            if s.regime == "memory":
                r["regime"] = "memory"
        for s in self.collective_spans:
            r = rows.get(s.path)
            if r is None:
                r = rows.setdefault(s.path, {
                    "path": s.path, "module_type": "", "category": "comm",
                    "stage": s.stage, "chunk": s.chunk,
                    "fwd_time": 0.0, "bwd_time": 0.0, "time": 0.0,
                    "flops": 0.0, "bytes_accessed": 0.0,
                    "efficiency": 1.0, "calibrated": True,
                    "regime": "comm", "recompute": False,
                })
            r.setdefault("net_exposed_time", 0.0)
            r.setdefault("net_hidden_time", 0.0)
            r["net_exposed_time"] += s.exposed_time
            r["net_hidden_time"] += s.hidden_time
            r["time"] += s.exposed_time
        mbc = (self.meta.get("parallelism") or {}).get("mbc", 1)
        total = self.headline.get("iter_time") or 1.0
        out = sorted(rows.values(), key=lambda r: r["time"], reverse=True)
        for r in out:
            r.setdefault("net_exposed_time", 0.0)
            r.setdefault("net_hidden_time", 0.0)
            r["share"] = mbc * r["time"] / total
        return out

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": LEDGER_SCHEMA,
            "meta": self.meta,
            "headline": self.headline,
            "waterfall": self.waterfall,
            "mem": self.mem,
            "efficiency": self.efficiency,
            "step_comm": self.step_comm,
            "ops": [s.to_dict() for s in self.op_spans],
            "collectives": [s.to_dict() for s in self.collective_spans],
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
        if schema != LEDGER_SCHEMA:
            raise ConfigError(
                f"{path}: not a simumax ledger (schema={schema!r}; "
                f"expected {LEDGER_SCHEMA!r} — produce one with "
                f"`Ledger.save`)"
            )
        return data

    # -- presentation ------------------------------------------------------
    def waterfall_lines(self) -> List[str]:
        """Human waterfall rendering (the `explain` default output)."""
        return waterfall_lines_from_dict({
            "meta": self.meta, "headline": self.headline,
            "waterfall": self.waterfall,
        })

    def top_op_lines(self, n: int = 10) -> List[str]:
        return top_op_lines_from_rows(self.op_rows(), n)


def waterfall_lines_from_dict(data: Dict[str, Any]) -> List[str]:
    """The waterfall rendering, from a ledger *dict* (``to_dict`` /
    ``load`` / a cached planner payload) — one renderer shared with the
    live :class:`Ledger`, so cached and fresh `explain` output cannot
    diverge."""
    wf = data["waterfall"]
    meta, headline = data["meta"], data["headline"]
    total = wf["total"] or 1.0
    width = max(len(k) for k in wf["order"])
    lines = [
        f"== MFU-loss waterfall: {meta['model']} on "
        f"{meta['system']} — iter "
        f"{headline['iter_time_ms']:.2f} ms, "
        f"MFU {100.0 * headline['mfu']:.2f}% =="
    ]
    for key in wf["order"]:
        v = wf["buckets"][key]
        # round-then-add-0.0 folds epsilon-negative buckets' float
        # -0.0 into plain 0.0 for display
        ms = round(v * 1e3, 3) + 0.0
        pct = round(100.0 * v / total, 2) + 0.0
        lines.append(f"  {key:<{width}}  {ms:10.3f} ms  {pct:6.2f}%")
    lines.append(
        f"  {'= step time':<{width}}  {total * 1e3:10.3f} ms  "
        f"100.00%"
    )
    return lines


def top_op_lines_from_rows(rows: List[Dict[str, Any]],
                           n: int = 10) -> List[str]:
    """The top-op table rendering, from aggregated ``op_rows``."""
    rows = rows[:n]
    if not rows:
        return []
    lines = [
        "-- top ops by charged time (per microbatch; share scales "
        "by mbc vs step) --"
    ]
    for r in rows:
        cal = "cal" if r["calibrated"] else "MISS"
        lines.append(
            f"  {r['time'] * 1e3:9.3f} ms  {r['share'] * 100:5.1f}%  "
            f"[{r['regime']:>7}|{cal:>4}|eff {r['efficiency']:.2f}]  "
            f"{r['path']} ({r['category']})"
        )
    return lines


# --------------------------------------------------------------------------
# Ledger diffing
# --------------------------------------------------------------------------


def _agg_op_times(ledger: Dict[str, Any]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in ledger.get("ops", []):
        out[s["path"]] = out.get(s["path"], 0.0) + s["time"]
    for s in ledger.get("collectives", []):
        out[s["path"]] = out.get(s["path"], 0.0) + s["exposed_time"]
    return out


def _category_totals(ledger: Dict[str, Any]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in ledger.get("ops", []):
        out[s["category"]] = out.get(s["category"], 0.0) + s["time"]
    for s in ledger.get("collectives", []):
        key = f"comm:{s['dim']}"
        out[key] = out.get(key, 0.0) + s["exposed_time"]
    return out


def diff_ledgers(a: Dict[str, Any], b: Dict[str, Any],
                 top: int = 20) -> Dict[str, Any]:
    """Compare two ledgers (two strategies, or a prediction vs a
    calibrated re-run): which buckets, op families, and individual ops
    account for the headline delta. Diffing a ledger against itself
    reports zero everywhere (``identical: True``)."""
    headline = {
        k: {
            "a": a["headline"].get(k),
            "b": b["headline"].get(k),
            "delta": (b["headline"].get(k, 0.0) or 0.0)
            - (a["headline"].get(k, 0.0) or 0.0),
        }
        for k in ("iter_time_ms", "mfu", "tgs", "peak_gib")
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
    cat_a, cat_b = _category_totals(a), _category_totals(b)
    categories = {
        k: {
            "a": cat_a.get(k, 0.0),
            "b": cat_b.get(k, 0.0),
            "delta": cat_b.get(k, 0.0) - cat_a.get(k, 0.0),
        }
        for k in set(cat_a) | set(cat_b)
    }
    ops_a, ops_b = _agg_op_times(a), _agg_op_times(b)
    deltas = [
        {"path": p, "a": ops_a.get(p, 0.0), "b": ops_b.get(p, 0.0),
         "delta": ops_b.get(p, 0.0) - ops_a.get(p, 0.0)}
        for p in set(ops_a) | set(ops_b)
    ]
    deltas.sort(key=lambda d: abs(d["delta"]), reverse=True)
    eff = {
        "miss_count": {
            "a": a["efficiency"]["miss_count"],
            "b": b["efficiency"]["miss_count"],
            "delta": b["efficiency"]["miss_count"]
            - a["efficiency"]["miss_count"],
        },
        "hit_count": {
            "a": a["efficiency"]["hit_count"],
            "b": b["efficiency"]["hit_count"],
            "delta": b["efficiency"]["hit_count"]
            - a["efficiency"]["hit_count"],
        },
    }
    identical = (
        all(v["delta"] == 0 for v in headline.values())
        and all(v["delta"] == 0 for v in wf.values())
        and all(d["delta"] == 0 for d in deltas)
        and all(v["delta"] == 0 for v in categories.values())
        and eff["miss_count"]["delta"] == 0
        and eff["hit_count"]["delta"] == 0
    )
    return {
        "schema": "simumax-ledger-diff-v1",
        "a": {"run_id": a["meta"].get("run_id"),
              "model": a["meta"].get("model"),
              "system": a["meta"].get("system")},
        "b": {"run_id": b["meta"].get("run_id"),
              "model": b["meta"].get("model"),
              "system": b["meta"].get("system")},
        "identical": identical,
        "headline": headline,
        "waterfall": wf,
        "categories": categories,
        "op_deltas": deltas[:top],
        # lists are truncated to `top`; the *_count fields carry the
        # true totals so the rendering never understates the divergence
        "ops_only_in_a": sorted(set(ops_a) - set(ops_b))[:top],
        "ops_only_in_a_count": len(set(ops_a) - set(ops_b)),
        "ops_only_in_b": sorted(set(ops_b) - set(ops_a))[:top],
        "ops_only_in_b_count": len(set(ops_b) - set(ops_a)),
        "efficiency": eff,
    }


def format_diff_lines(diff: Dict[str, Any], top: int = 10) -> List[str]:
    """Human rendering of a ledger diff."""
    lines = [
        f"== ledger diff: a={diff['a']['run_id']} "
        f"({diff['a']['model']} on {diff['a']['system']})  vs  "
        f"b={diff['b']['run_id']} "
        f"({diff['b']['model']} on {diff['b']['system']}) =="
    ]
    if diff["identical"]:
        lines.append("  identical: zero delta in every bucket and op")
        return lines
    h = diff["headline"]
    lines.append(
        f"  iter {h['iter_time_ms']['a']:.2f} -> "
        f"{h['iter_time_ms']['b']:.2f} ms "
        f"({h['iter_time_ms']['delta']:+.2f} ms)   "
        f"MFU {100 * h['mfu']['a']:.2f}% -> {100 * h['mfu']['b']:.2f}% "
        f"({100 * h['mfu']['delta']:+.2f}pp)   "
        f"peak {h['peak_gib']['a']:.2f} -> {h['peak_gib']['b']:.2f} GiB"
    )
    lines.append("  -- waterfall bucket deltas (b - a) --")
    for key in WATERFALL_ORDER:
        d = diff["waterfall"].get(key)
        if d is None:
            continue
        lines.append(
            f"    {key:<21} {d['a'] * 1e3:10.3f} -> {d['b'] * 1e3:10.3f} ms"
            f"  ({d['delta'] * 1e3:+.3f} ms)"
        )
    shown = [d for d in diff["op_deltas"] if d["delta"] != 0][:top]
    if shown:
        lines.append("  -- largest per-op deltas (per microbatch) --")
        for d in shown:
            lines.append(
                f"    {d['delta'] * 1e3:+9.3f} ms  {d['path']}"
            )
    for side, key in (("a", "ops_only_in_a"), ("b", "ops_only_in_b")):
        if diff[key]:
            count = diff.get(f"{key}_count", len(diff[key]))
            lines.append(
                f"  ops only in {side}: {count} "
                f"(e.g. {diff[key][0]})"
            )
    e = diff["efficiency"]["miss_count"]
    if e["delta"]:
        lines.append(
            f"  efficiency-table misses {e['a']} -> {e['b']} "
            f"({e['delta']:+d})"
        )
    return lines

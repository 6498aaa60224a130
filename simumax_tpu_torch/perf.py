"""PerfLLM orchestrator (L4).

Reference: ``simumax/core/perf_llm.py`` — ``configure`` (:1426),
``run_estimate`` (:489), ``build``/``get_num_layers_to_build`` (:539-835),
``analysis_mem`` (:1599-1969), ``analysis_cost`` (:1971-2910) with the
event-matched 1F1B replay (``calculate_1f1b_bubble`` :2097), DP comm
(:1513) and Megatron-style optimizer timing (:1470), straggler inflation
(:255-291), and ``analysis`` (:3585-3668).

TPU redesign: ``analysis_net`` places every parallel dim on the ICI torus
/ DCN via ``SystemConfig.place_group`` (mesh-axis model) instead of
choosing NVLink/PCIe link classes.

Copy of the JAX package's ``perf.py`` with its import paths changed;
the flash-backend sanity check uses the CUDA kernels' shape gate
(``cuda_flash_supported``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Union

from simumax_tpu_torch.core.config import (
    CommPath,
    GiB,
    ModelConfig,
    StrategyConfig,
    SystemConfig,
    _require,
    get_model_config,
    get_strategy_config,
    get_system_config,
)
from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.core.module import BuildContext
from simumax_tpu_torch.core.records import Diagnostics
from simumax_tpu_torch.core.utils import dp_comm_buckets, human_time
from simumax_tpu_torch.models.llm import LLMModel

#: stable schema tag of the :meth:`PerfLLM.analysis_mem` result dict
#: (documented in docs/observability.md; bump on breaking changes)
MEM_SCHEMA = "simumax-mem-v1"


def interleaved_stage_peak(order, cache, peakpt):
    """Schedule-position memory replay of one stage's interleaved op
    list — the single source for both ``_analysis_mem_interleaved``'s
    scalar peak and the memory ledger's peak live-set materialization
    (``observe/memledger.py``), so the two folds can never diverge.

    ``order`` is the stage's (kind, chunk, mb) op list; ``cache`` /
    ``peakpt`` map chunk_idx -> per-microbatch cache bytes / internal
    walk peak. At each op, the active chunk's own microbatch walk
    contributes its internal PeakPoint (which includes that
    microbatch's cache) on top of every OTHER outstanding microbatch's
    cache — no last-chunk heuristic (round-1 VERDICT weak #3).

    Returns ``(peak_sched, peak_outstanding, peak_counts,
    peak_active)``: the peak bytes over model memory, the number of
    outstanding microbatches at the peak, the per-chunk count of FULL
    caches held there (the active chunk's own microbatch already
    excluded), and the chunk whose internal walk the peak rode on
    (None when the plain outstanding-cache sum won the max)."""
    live = peak_sched = 0.0
    counts: Dict[int, int] = {}
    peak_outstanding = 0
    peak_counts: Dict[int, int] = {}
    peak_active: Optional[int] = None
    for kind, c, _ in order:
        if kind == "F":
            live += cache.get(c, 0.0)
            counts[c] = counts.get(c, 0) + 1
        cand = live - cache.get(c, 0.0) + peakpt.get(c, 0.0)
        if max(cand, live) > peak_sched:
            peak_sched = max(cand, live)
            peak_outstanding = sum(counts.values())
            peak_counts = dict(counts)
            if cand >= live:
                peak_active = c
                peak_counts[c] = peak_counts.get(c, 0) - 1
            else:
                peak_active = None
        if kind == "B":
            live -= cache.get(c, 0.0)
            counts[c] = counts.get(c, 0) - 1
    return peak_sched, peak_outstanding, peak_counts, peak_active


def place_strategy_paths(strategy: StrategyConfig,
                         system: SystemConfig) -> Dict[str, CommPath]:
    """Mesh placement of every parallel dim for one strategy (reference
    ``analysis_net`` perf_llm.py:369-474) — extracted to module level so
    the batched sweep kernel (``search/batched.py``) places layouts with
    exactly the code :meth:`PerfLLM.analysis_net` uses."""
    st, sysc = strategy, system
    tp, cp, dp, pp = st.tp_size, st.cp_size, st.dp_size, st.pp_size
    ep, etp = st.ep_size, st.etp_size
    sizes = {"tp": tp, "cp": cp, "dp": dp, "pp": pp}
    order = st.mesh_order.split(",")

    def inner(dim: str) -> int:
        n = 1
        for d in order:
            if d == dim:
                return n
            n *= sizes[d]
        raise KeyError(dim)

    paths = {
        d: sysc.place_group(d, inner(d), sizes[d]) for d in sizes
    }
    # dp_cp (ZeRO sharding + grad reduce group) = the cp and dp dims
    # combined. With the default order they are adjacent and a single
    # placement reproduces the round-3 anchor behavior exactly; with
    # dp moved outermost the group is strided across pp, which the
    # hierarchical span concatenation expresses (innermost first).
    if st.mesh_order == "tp,cp,dp,pp":
        paths["dp_cp"] = sysc.place_group("dp_cp", tp, cp * dp)
    else:
        first, second = sorted(("cp", "dp"), key=order.index)
        combined = CommPath(dim="dp_cp", group_size=cp * dp)
        combined.spans = list(paths[first].spans) + list(
            paths[second].spans
        )
        paths["dp_cp"] = combined
    # MoE dims: etp shares the tp placement; ep strides over etp
    paths["etp"] = sysc.place_group("etp", 1, etp)
    paths["ep"] = sysc.place_group("ep", etp, ep)
    if st.mesh_order == "tp,cp,dp,pp":
        paths["edp"] = sysc.place_group("edp", etp * ep, st.edp_size)
    else:
        # non-default orders are guarded to ep=etp=1, where the edp
        # group is exactly tp x cp x dp — strided across pp when pp
        # is not outermost. Reuse those dims' placements so expert
        # gradients see the same DCN spans the dense dims do.
        assert ep == 1 and etp == 1, (ep, etp)
        combined = CommPath(dim="edp", group_size=st.edp_size)
        for d in order:
            if d != "pp":
                combined.spans.extend(paths[d].spans)
        paths["edp"] = combined
    return paths


def stage_layer_split(strategy: StrategyConfig,
                      model: ModelConfig) -> List[List[int]]:
    """counts[stage][vpp_rank] = transformer layers in that chunk
    (reference ``get_num_layers_to_build`` perf_llm.py:539) — extracted
    to module level for the same reason as
    :func:`place_strategy_paths`."""
    st, m = strategy, model
    pp, vp = st.pp_size, st.vp_size
    total_v = pp * vp
    counts = [[0] * vp for _ in range(pp)]
    layers = m.layer_num
    eff = layers
    if st.account_for_embedding_in_pipeline_split:
        eff += 1
    if st.account_for_loss_in_pipeline_split:
        eff += 1
    first = st.num_layers_in_first_pipeline_stage
    last = st.num_layers_in_last_pipeline_stage
    per_v = [0] * total_v
    if first or last:
        rem_v = total_v - (1 if first else 0) - (1 if last else 0)
        rem_layers = layers - (first or 0) - (last or 0)
        base = rem_layers // max(rem_v, 1)
        for v in range(total_v):
            per_v[v] = base
        if first:
            per_v[0] = first
        if last:
            per_v[-1] = last
    else:
        base = eff // total_v
        for v in range(total_v):
            per_v[v] = base
        if st.account_for_embedding_in_pipeline_split:
            per_v[0] -= 1
        if st.account_for_loss_in_pipeline_split:
            per_v[-1] -= 1
    # virtual stage v = chunk * pp + stage (Megatron interleaving)
    for v in range(total_v):
        chunk, stage = divmod(v, pp)
        counts[stage][chunk] = per_v[v]
    assert sum(sum(c) for c in counts) == layers
    return counts


def _resolve(cfg, cls, getter):
    if isinstance(cfg, cls):
        return cfg
    if isinstance(cfg, dict):
        return cls.init_from_dict(cfg)
    if isinstance(cfg, str):
        if os.path.isfile(cfg):
            return cls.init_from_config_file(cfg)
        return getter(cfg)
    raise TypeError(f"cannot resolve {cls.__name__} from {type(cfg)}")


def print_summary(result: dict) -> None:
    """Render the estimate headline (the ``perf`` CLI output) from an
    ``analysis`` result dict. Module-level so the planning service can
    render a cached payload without a built ``PerfLLM`` — one renderer,
    so cached and fresh output cannot diverge."""
    from simumax_tpu_torch.observe.report import get_reporter

    log = get_reporter()
    cost, mem = result["compute_result"], result["mem_result"]
    info = result["base_info"]
    p = info["parallelism"]
    log.info(
        f"== {info['model']} on {info['system']} "
        f"(world={info['world_size']} tp={p['tp']} cp={p['cp']} "
        f"pp={p['pp']} dp={p['dp']} ep={p['ep']}) ==",
        event="perf_header", model=info["model"], system=info["system"],
    )
    log.info(
        f"iter time {human_time(cost['iter_time'])}  "
        f"MFU {cost['mfu']*100:.2f}%  "
        f"TFLOPS/chip {cost['tflops_per_chip']:.1f}  "
        f"TGS {cost['tgs']:.1f}",
        event="perf_cost", iter_time_ms=cost["iter_time_ms"],
        mfu=cost["mfu"], tgs=cost["tgs"],
    )
    log.info(
        f"peak HBM {mem['max_peak_gib']:.2f} GiB / "
        f"{mem['hbm_capacity_gib']:.0f} GiB  fits={mem['fits']}",
        event="perf_mem", peak_gib=mem["max_peak_gib"],
        fits=mem["fits"],
    )
    misses = result["efficiency_misses"]
    if misses:
        nmiss = sum(len(v) for v in misses.values())
        log.info(
            f"[calibration] {nmiss} efficiency-table misses "
            f"(run simumax_tpu_torch.calibration to refine)",
            event="perf_misses", misses=nmiss,
        )


class PerfBase:
    """Config plumbing shared by perf frontends."""

    def __init__(self):
        self.strategy: Optional[StrategyConfig] = None
        self.model_config: Optional[ModelConfig] = None
        self.system: Optional[SystemConfig] = None
        #: central collector for this estimate's warnings / calibration
        #: coverage / quarantined failures (see docs/diagnostics.md).
        #: Inside a ``Diagnostics.activate()`` block (a sweep, a CLI run)
        #: this joins the run-level collector instead of starting a
        #: throwaway one, so per-candidate warnings reach the report.
        self.diagnostics = Diagnostics.active() or Diagnostics()

    def configure(
        self,
        strategy: Union[str, dict, StrategyConfig],
        model: Union[str, dict, ModelConfig],
        system: Union[str, dict, SystemConfig],
    ):
        with self.diagnostics.capture(category="config"):
            self.strategy = _resolve(strategy, StrategyConfig, get_strategy_config)
            self.model_config = _resolve(model, ModelConfig, get_model_config)
            self.system = _resolve(system, SystemConfig, get_system_config)
            self.strategy.sanity_check()
            self.model_config.sanity_check()
            self._cross_sanity_check()
        return self

    def _cross_sanity_check(self):
        """Reference ``perf_llm.py:1381-1424``."""
        st, m, sysc = self.strategy, self.model_config, self.system
        _require(
            st.world_size <= sysc.total_chips,
            f"strategy world_size {st.world_size} exceeds system "
            f"{sysc.total_chips} chips",
        )
        if st.dispatch_probs and m.model_type == "moe":
            _require(
                m.use_swiglu,
                "dispatch_probs fuses the prob-weighting into the SwiGLU "
                "expert activation (weighted-SiLU); a gelu MoE has no "
                "fusion point, so the combine cache cannot be dropped",
            )
        if st.recompute.mla_up_proj_recompute:
            _require(
                m.attention_type == "mla",
                "mla_up_proj recompute requires an MLA model "
                f"(model {m.model_name!r} uses {m.attention_type})",
            )
        if st.recompute.moe_act_recompute:
            _require(
                m.model_type == "moe",
                "moe_act recompute requires a MoE model "
                f"(model {m.model_name!r} is {m.model_type})",
            )
        head_shard = st.tp_size
        if st.cp_size > 1 and st.cp_comm_type == "a2a":
            head_shard *= st.cp_size  # Ulysses scatters heads over cp too
        _require(
            m.head_num % head_shard == 0,
            f"head_num {m.head_num} must divide tp"
            f"{'*cp' if head_shard != st.tp_size else ''} ({head_shard})",
        )
        if m.kv_head_num < st.tp_size:
            pass  # kv heads replicated within tp; allowed
        if m.model_type == "moe":
            _require(
                m.expert_num % st.ep_size == 0, "expert_num % ep != 0"
            )
        if st.use_flash_sdp and st.sdp_backend == "cuda":
            # same predicate the runtime dispatcher applies — reject
            # configs whose measurement would silently fall back to math
            # attention while the estimate charged flash-kernel rates
            from simumax_tpu_torch.core.utils import cuda_flash_supported

            # post-collective shapes the kernel actually sees: under
            # cp=all_gather each rank runs its seq/cp query shard
            # against the FULL gathered KV; under a2a (and cp=1) both
            # are the full sequence
            if st.cp_size > 1 and st.cp_comm_type == "all_gather":
                sq_attn, skv_attn = st.seq_len // st.cp_size, st.seq_len
            else:
                sq_attn = skv_attn = st.seq_len
            _require(
                cuda_flash_supported(sq_attn, skv_attn, m.head_size),
                f"sdp_backend='cuda' needs attention shapes the CUDA "
                f"flash kernels take (sq {sq_attn} and skv {skv_attn} "
                f"multiples of 64, head_size {m.head_size} in (64, 128)) "
                f"— the runtime would fall back to math attention; use "
                f"sdp_backend='torch'",
            )
        if st.fp8:
            needed = [f"{st.quant_dtype}_matmul"]
            # sequential mode costs experts off the dense matmul table
            if m.model_type == "moe" and st.group_linear_mode == "parallel":
                needed.append(f"{st.quant_dtype}_group_matmul")
            for key in needed:
                _require(
                    key in sysc.accelerator.op,
                    f"system {sysc.sys_name!r} has no {key!r} efficiency "
                    f"table — this chip does not support {st.quant_dtype} "
                    f"matmuls (available: {sorted(sysc.accelerator.op)})",
                )
        total_stages = st.pp_size * st.vp_size
        layers = m.layer_num
        if st.num_layers_in_first_pipeline_stage:
            layers -= st.num_layers_in_first_pipeline_stage
        if st.num_layers_in_last_pipeline_stage:
            layers -= st.num_layers_in_last_pipeline_stage
        # remaining layers must split evenly over remaining virtual stages
        rem = total_stages
        if st.num_layers_in_first_pipeline_stage:
            rem -= 1
        if st.num_layers_in_last_pipeline_stage:
            rem -= 1
        eff = layers + (
            1 if st.account_for_embedding_in_pipeline_split else 0
        ) + (1 if st.account_for_loss_in_pipeline_split else 0)
        _require(
            eff % max(rem, 1) == 0,
            f"{layers} layers do not split evenly over {rem} virtual stages",
        )


class PerfLLM(PerfBase):
    """Analytical perf/memory estimation for one (system, strategy, model)
    triple. Usage: ``configure() -> run_estimate() -> analysis_mem() /
    analysis_cost() / analysis() / simulate()``."""

    def __init__(self):
        super().__init__()
        self.ctx: Optional[BuildContext] = None
        self.chunks: Dict[tuple, LLMModel] = {}  # (stage, vpp_rank) -> chunk
        self._mem_result = None
        self._cost_result = None
        self._interleaved_result = None
        self._dp_time_cache: Dict[int, dict] = {}
        #: per-op schedule intervals of the last analysis_cost replay:
        #: [(stage, kind, chunk, mb, start, end)] — the analytical
        #: trace export (observe/trace.py) lays these out as Chrome
        #: trace slices; kept off the result dict so saved JSONs stay
        #: headline-sized
        self._schedule_events: List[tuple] = []

    # ------------------------------------------------------------------
    # Net placement (reference ``analysis_net`` perf_llm.py:369-474)
    # ------------------------------------------------------------------
    def analysis_net(self) -> Dict[str, object]:
        return place_strategy_paths(self.strategy, self.system)

    # ------------------------------------------------------------------
    # Stage chunking (reference ``get_num_layers_to_build`` perf_llm.py:539)
    # ------------------------------------------------------------------
    def stage_layer_counts(self) -> List[List[int]]:
        """Return counts[stage][vpp_rank] = number of transformer layers."""
        return stage_layer_split(self.strategy, self.model_config)

    def build(self):
        """Construct per-(stage, vpp_rank) model chunks
        (reference ``build`` perf_llm.py:676-835)."""
        st = self.strategy
        self.model_config.maybe_pad_vocab_size(st.tp_size)
        paths = self.analysis_net()
        self.ctx = BuildContext(st, self.model_config, self.system, paths)
        counts = self.stage_layer_counts()
        self.chunks = {}
        offset = 0
        # build in virtual-stage (layer) order so offsets are consecutive
        for v in range(st.pp_size * st.vp_size):
            chunk_idx, stage = divmod(v, st.pp_size)
            n = counts[stage][chunk_idx]
            pre = v == 0
            post = v == st.pp_size * st.vp_size - 1
            self.chunks[(stage, chunk_idx)] = LLMModel(
                self.ctx,
                layer_num=n,
                layer_offset=offset,
                preprocess=pre,
                postprocess=post,
                stage_idx=stage,
                chunk_idx=chunk_idx,
                name=f"stage{stage}_chunk{chunk_idx}",
            )
            offset += n

    def _run(self):
        """Symbolic forward over every chunk (reference ``_run``
        perf_llm.py:2938-3047)."""
        for chunk in self.chunks.values():
            chunk.run()
            chunk.compute_activations()

    def run_estimate(self, capture_graph: bool = False,
                     debug: bool = False):
        assert self.strategy is not None, "call configure() first"
        with self.diagnostics.capture(category="placement"):
            self.build()
        env_graph = os.environ.get("ENABLE_SIMU_GRAPH", "").lower()
        if capture_graph or env_graph in ("1", "true", "yes", "on"):
            from simumax_tpu_torch.core.graph import GraphBuilder

            self.ctx.graph = GraphBuilder()
        # per-path cost probes (reference debug_points -> cost_log.json)
        env_debug = os.environ.get("SIMU_DEBUG", "").lower()
        if debug or env_debug in ("1", "true", "yes", "on"):
            self.ctx.debug.enabled = True
        return self.estimate()

    def estimate(self):
        """Symbolic estimate over the already-built chunk graph (the
        estimate half of the build/estimate split; ``run_estimate`` is
        ``build() + estimate()``). Separated so the strategy sweep can
        re-estimate a layout under a new batch split (:meth:`rebatch`)
        without reconstructing the module tree."""
        assert self.ctx is not None, "call build() first"
        self.system.reset_status()
        with self.diagnostics.capture(category="estimate"):
            self._run()
        # merge (not snapshot) so a sweep's run-level collector
        # accumulates table coverage across every candidate it estimates
        self.diagnostics.record_efficiency(self.system)
        self._mem_result = None
        self._cost_result = None
        self._interleaved_result = None
        self._dp_time_cache = {}
        self._schedule_events = []
        return self

    #: strategy fields the built chunk graph does NOT depend on — they
    #: only enter at estimate/analysis time (input shapes, schedule
    #: replay), so :meth:`rebatch` may change them without a rebuild
    BATCH_ONLY_FIELDS = frozenset({"micro_batch_size", "micro_batch_num"})

    def rebatch(self, strategy: StrategyConfig):
        """Swap in a strategy differing from the current one only in
        :attr:`BATCH_ONLY_FIELDS` and re-estimate, reusing the built
        chunk graph (recompute wiring, stage split, mesh placement are
        all batch-independent). A micro_batch_num-only change skips even
        the symbolic re-run — only the schedule/memory analyses read it.

        This is the sweep's per-layout build cache fast path: the
        (mbs, mbc) searches inside one layout call this instead of
        rebuilding via ``configure() + run_estimate()``."""
        assert self.ctx is not None, "call build()/run_estimate() first"
        import dataclasses

        for f in dataclasses.fields(StrategyConfig):
            if f.name in self.BATCH_ONLY_FIELDS:
                continue
            if getattr(strategy, f.name) != getattr(self.strategy, f.name):
                raise ConfigError(
                    f"rebatch: field {f.name!r} differs from the built "
                    f"strategy — only {sorted(self.BATCH_ONLY_FIELDS)} may "
                    f"change without a rebuild; call configure() instead"
                )
        # validate BEFORE mutating: a failed sanity check must leave the
        # built estimate untouched (the caller may retry another split)
        with self.diagnostics.capture(category="config"):
            strategy.sanity_check()
        rerun = (
            strategy.micro_batch_size != self.strategy.micro_batch_size
        )
        self.strategy = strategy
        self.ctx.strategy = strategy
        self._mem_result = None
        self._cost_result = None
        self._interleaved_result = None
        self._dp_time_cache = {}
        self._schedule_events = []
        if rerun:
            return self.estimate()
        return self

    # ------------------------------------------------------------------
    # Memory analysis (reference perf_llm.py:1599-1969)
    # ------------------------------------------------------------------
    def stage_chunks(self, stage: int) -> List[LLMModel]:
        return [c for (s, _), c in sorted(self.chunks.items()) if s == stage]

    def analysis_mem(self) -> dict:
        """Per-stage peak-HBM prediction. Stable documented schema
        (``simumax-mem-v1``, see docs/observability.md):

        * ``stages[i]`` — per pipeline stage: ``model_bytes`` split into
          ``weight_bytes`` / ``grad_bytes`` / ``optimizer_state_bytes``,
          ``act_cache_per_microbatch_bytes``, ``live_microbatches``,
          ``replay_peak_bytes`` (the per-chunk activation-walk peak),
          ``peak_bytes`` / ``peak_gib``, and ``fits_margin_bytes``
          (usable HBM minus this stage's peak; negative = over);
        * top level — ``binding_stage`` (the max-peak stage every
          memory surface keys on), ``max_peak_bytes`` /
          ``max_peak_gib``, ``hbm_capacity_gib``, ``usable_bytes`` /
          ``usable_gib`` (capacity x ``mem_factor``), ``fits``, and
          ``fits_margin_bytes`` for the binding stage.

        The memory ledger (:meth:`memory_ledger`) decomposes each
        stage's ``peak_bytes`` into its live tensors."""
        if self._mem_result is not None:
            return self._mem_result
        st = self.strategy
        pp, mbc, vp = st.pp_size, st.micro_batch_num, st.vp_size
        if vp > 1:
            stages = self._analysis_mem_interleaved()
        else:
            stages = []
            for s in range(pp):
                chunks = self.stage_chunks(s)
                model_mem = sum(c.param_info.total_bytes for c in chunks)
                cache_per_mb = sum(c.act_info.cache_bytes for c in chunks)
                replay_peak = max(
                    (c.peak_point.bytes for c in chunks), default=0.0
                )
                live = min(mbc, pp - s)
                peak = model_mem + max(live - 1, 0) * cache_per_mb + replay_peak
                weight = sum(
                    c.param_info.weight_bytes + c.param_info.moe_weight_bytes
                    for c in chunks
                )
                grad = sum(
                    c.param_info.grad_bytes + c.param_info.moe_grad_bytes
                    for c in chunks
                )
                state = sum(
                    c.param_info.state_bytes + c.param_info.moe_state_bytes
                    for c in chunks
                )
                stages.append(
                    {
                        "stage": s,
                        "model_bytes": model_mem,
                        "weight_bytes": weight,
                        "grad_bytes": grad,
                        "optimizer_state_bytes": state,
                        "act_cache_per_microbatch_bytes": cache_per_mb,
                        "live_microbatches": live,
                        "replay_peak_bytes": replay_peak,
                        "peak_bytes": peak,
                        "peak_gib": peak / GiB,
                    }
                )
        cap = self.system.mem_bytes * st.mem_factor
        for s in stages:
            s["fits_margin_bytes"] = cap - s["peak_bytes"]
        max_peak = max(s["peak_bytes"] for s in stages)
        # the single source every memory surface (waterfall, forensics,
        # timeline artifacts) keys its "binding stage" on — first stage
        # at the max on ties (max returns the first maximal element)
        binding = max(range(len(stages)),
                      key=lambda i: stages[i]["peak_bytes"])
        result = {
            "schema": MEM_SCHEMA,
            "stages": stages,
            "binding_stage": binding,
            "max_peak_bytes": max_peak,
            "max_peak_gib": max_peak / GiB,
            "hbm_capacity_gib": self.system.mem_bytes / GiB,
            "usable_bytes": cap,
            "usable_gib": cap / GiB,
            "fits": all(s["peak_bytes"] <= cap for s in stages),
            "fits_margin_bytes": cap - max_peak,
        }
        self._mem_result = result
        return result

    # ------------------------------------------------------------------
    # Cost analysis
    # ------------------------------------------------------------------
    def _stage_phase_inputs(self, stage: int) -> dict:
        """Per-stage fwd/bwd compute + p2p times (reference
        ``_compute_single_batch_phase_inputs`` perf_llm.py:2644)."""
        chunks = self.stage_chunks(stage)
        fwd = sum(c.cost_info.fwd_time for c in chunks)
        bwd = sum(c.cost_info.bwd_time for c in chunks)
        p2p_bytes = chunks[0].boundary_bytes()
        p2p = self.system.compute_net_op_time("p2p", p2p_bytes, self.ctx.path("pp"))
        return {"fwd": fwd, "bwd": bwd, "p2p": p2p}

    def calculate_1f1b_bubble(self, phase_inputs: List[dict]) -> dict:
        """Event-matched non-interleaved 1F1B replay (reference
        ``calculate_1f1b_bubble`` perf_llm.py:2097-2306): per-stage op
        queues with p2p dependencies, no collective batching subtleties —
        on TPU the p2p is an XLA collective-permute on the pp mesh axis.
        """
        st = self.strategy
        pp, mbc = st.pp_size, st.micro_batch_num
        if pp == 1:
            from simumax_tpu_torch.parallel.pipeline import single_stage_order

            ph = phase_inputs[0]
            events, t = [], 0.0
            for kind, i in single_stage_order(mbc):
                d = ph["fwd"] if kind == "F" else ph["bwd"]
                events.append((0, kind, 0, i, t, t + d))
                t += d
            total = mbc * (ph["fwd"] + ph["bwd"])
            return {"total": total, "bubble": 0.0, "per_stage_end": [total],
                    "events": events}

        # standard Megatron 1F1B op order per stage (shared with the
        # event simulator so the cross-check cannot desynchronize)
        from simumax_tpu_torch.parallel.pipeline import one_f_one_b_order

        orders: List[List[tuple]] = [
            one_f_one_b_order(pp, s, mbc) for s in range(pp)
        ]

        # ``None`` marks "not yet completed"; a legitimate 0.0 completion
        # time (zero-cost degenerate stage) must not read as unready.
        F_end = [[None] * mbc for _ in range(pp)]
        B_end = [[None] * mbc for _ in range(pp)]
        stage_clock = [0.0] * pp
        events: List[tuple] = []  # (stage, kind, chunk, mb, start, end)
        # iterate op queues round-robin until all done (dependencies always
        # resolvable because 1F1B is deadlock-free)
        idx = [0] * pp
        remaining = sum(len(o) for o in orders)
        while remaining:
            progressed = False
            for s in range(pp):
                while idx[s] < len(orders[s]):
                    kind, i = orders[s][idx[s]]
                    ph = phase_inputs[s]
                    blocking = (
                        0.0 if self.strategy.pp_comm_async else ph["p2p"]
                    )
                    if kind == "F":
                        dep = 0.0 if s == 0 else F_end[s - 1][i]
                        if dep is None:
                            break  # dependency not ready yet
                        start = max(stage_clock[s], dep + (ph["p2p"] if s > 0 else 0.0))
                        end = start + ph["fwd"]
                        F_end[s][i] = end
                        events.append((s, "F", 0, i, start, end))
                        if s < pp - 1:
                            end += blocking  # blocking isend stalls sender
                    else:
                        dep = 0.0 if s == pp - 1 else B_end[s + 1][i]
                        if dep is None:
                            break
                        start = max(
                            stage_clock[s], dep + (ph["p2p"] if s < pp - 1 else 0.0)
                        )
                        end = start + ph["bwd"]
                        B_end[s][i] = end
                        events.append((s, "B", 0, i, start, end))
                        if s > 0:
                            end += blocking
                    stage_clock[s] = end
                    idx[s] += 1
                    remaining -= 1
                    progressed = True
            assert progressed, "1F1B schedule deadlocked (internal error)"

        per_stage_end = [stage_clock[s] for s in range(pp)]
        total = max(per_stage_end)
        work0 = mbc * (phase_inputs[0]["fwd"] + phase_inputs[0]["bwd"])
        return {
            "total": total,
            "bubble": total - work0,
            "per_stage_end": per_stage_end,
            "events": events,
        }

    def calculate_interleaved_schedule(self) -> dict:
        """Event-matched interleaved (VPP) schedule replay (reference
        ``_compute_interleaved_sync_schedule`` perf_llm.py:2322-2605):
        ops are (kind, chunk, microbatch); chunk c's forward output on
        the last stage feeds chunk c+1 on stage 0, and backward wraps
        the other way."""
        if self._interleaved_result is not None:
            return self._interleaved_result
        from simumax_tpu_torch.parallel.pipeline import interleaved_order

        st = self.strategy
        pp, mbc, vp = st.pp_size, st.micro_batch_num, st.vp_size
        orders = [
            interleaved_order(pp, s, mbc, vp, st.vpp_group_size)
            for s in range(pp)
        ]
        fwd_t = {
            (s, c): sum(
                ch.cost_info.fwd_time
                for ch in self.stage_chunks(s)
                if ch.chunk_idx == c
            )
            for s in range(pp)
            for c in range(vp)
        }
        bwd_t = {
            (s, c): sum(
                ch.cost_info.bwd_time
                for ch in self.stage_chunks(s)
                if ch.chunk_idx == c
            )
            for s in range(pp)
            for c in range(vp)
        }
        p2p = self._stage_phase_inputs(0)["p2p"] if pp > 1 else 0.0

        F_end: Dict[tuple, float] = {}
        B_end: Dict[tuple, float] = {}
        clock = [0.0] * pp
        events: List[tuple] = []  # (stage, kind, chunk, mb, start, end)
        idx = [0] * pp
        remaining = sum(len(o) for o in orders)
        while remaining:
            progressed = False
            for s in range(pp):
                while idx[s] < len(orders[s]):
                    kind, c, mb = orders[s][idx[s]]
                    blocking = 0.0 if st.pp_comm_async else p2p
                    if kind == "F":
                        if s > 0:
                            dep = F_end.get((s - 1, c, mb))
                        elif c > 0:
                            dep = F_end.get((pp - 1, c - 1, mb))
                        else:
                            dep = 0.0
                        if dep is None:
                            break
                        start = max(clock[s], dep + (p2p if (s > 0 or c > 0) else 0.0))
                        end = start + fwd_t[(s, c)]
                        F_end[(s, c, mb)] = end
                        events.append((s, "F", c, mb, start, end))
                        if s < pp - 1 or c < vp - 1:
                            end += blocking  # blocking isend stalls sender
                    else:
                        if s < pp - 1:
                            dep = B_end.get((s + 1, c, mb))
                        elif c < vp - 1:
                            dep = B_end.get((0, c + 1, mb))
                        else:
                            dep = 0.0  # loss chunk: ready after own fwd
                        if dep is None:
                            break
                        start = max(
                            clock[s],
                            dep + (p2p if (s < pp - 1 or c < vp - 1) else 0.0),
                        )
                        end = start + bwd_t[(s, c)]
                        B_end[(s, c, mb)] = end
                        events.append((s, "B", c, mb, start, end))
                        if s > 0 or c > 0:
                            end += blocking
                    clock[s] = end
                    idx[s] += 1
                    remaining -= 1
                    progressed = True
            assert progressed, "interleaved schedule deadlocked"
        total = max(clock)
        work0 = sum(
            mbc * (fwd_t[(0, c)] + bwd_t[(0, c)]) for c in range(vp)
        )
        self._interleaved_result = {
            "total": total,
            "bubble": total - work0,
            "per_stage_end": clock,
            "orders": orders,
            "events": events,
        }
        return self._interleaved_result

    def _analysis_mem_interleaved(self) -> list:
        """Per-stage peak via interleaved schedule replay (reference
        sync-VPP phase-sequence memory replay perf_llm.py:1745-1928):
        walk each stage's (F/B, chunk, mb) op list accumulating
        per-chunk activation caches."""
        from simumax_tpu_torch.parallel.pipeline import interleaved_order

        st = self.strategy
        orders = [
            interleaved_order(
                st.pp_size, s, st.micro_batch_num, st.vp_size,
                st.vpp_group_size,
            )
            for s in range(st.pp_size)
        ]
        stages = []
        for s in range(st.pp_size):
            cache = {
                ch.chunk_idx: ch.act_info.cache_bytes
                for ch in self.stage_chunks(s)
            }
            chunks = self.stage_chunks(s)
            peakpt = {
                ch.chunk_idx: ch.peak_point.bytes if ch.peak_point else 0.0
                for ch in chunks
            }
            model_mem = sum(ch.param_info.total_bytes for ch in chunks)
            # schedule-position replay shared with the memory ledger
            # (see interleaved_stage_peak)
            peak_sched, peak_outstanding, _, _ = interleaved_stage_peak(
                orders[s], cache, peakpt
            )
            replay_peak = max((peakpt[c] for c in peakpt), default=0.0)
            peak = model_mem + peak_sched
            stages.append(
                {
                    "stage": s,
                    "model_bytes": model_mem,
                    "weight_bytes": sum(
                        ch.param_info.weight_bytes + ch.param_info.moe_weight_bytes
                        for ch in chunks
                    ),
                    "grad_bytes": sum(
                        ch.param_info.grad_bytes + ch.param_info.moe_grad_bytes
                        for ch in chunks
                    ),
                    "optimizer_state_bytes": sum(
                        ch.param_info.state_bytes + ch.param_info.moe_state_bytes
                        for ch in chunks
                    ),
                    "act_cache_per_microbatch_bytes": sum(cache.values()) / st.vp_size,
                    "live_microbatches": peak_outstanding,
                    "replay_peak_bytes": replay_peak,
                    "peak_bytes": peak,
                    "peak_gib": peak / (1024**3),
                }
            )
        return stages

    def _compute_dp_time(self, stage: int = 0) -> dict:
        """Bucketed DP grad reduce-scatter + param all-gather for one
        stage's params, dense over dp_cp and MoE over edp (reference
        ``_compute_dp_time`` perf_llm.py:1513-1597). Stages can differ
        (embedding/head placement, leading dense layers in MoE models),
        so ``analysis_cost`` takes the max path over stages."""
        if stage in self._dp_time_cache:
            return self._dp_time_cache[stage]
        st, sysc = self.strategy, self.system
        dense_numel = moe_numel = 0.0
        for c in self.stage_chunks(stage):
            dense_numel += c.param_info.dense_numel
            moe_numel += c.param_info.moe_numel
        g_el = 2.0 if st.grad_reduce_in_bf16 else 4.0
        p_el = st.element_size
        t = 0.0
        detail = {}
        last_bucket_times = []  # per stream: its final bucket's rs time
        if st.dp_size * st.cp_size > 1 and dense_numel and st.zero_state < 3:
            # ZeRO-3 grads reduce-scatter per layer inside the backward
            # (leaf collectives) and params gather per layer in the next
            # forward — no step-end bulk comm for dense params
            path = self.ctx.path("dp_cp")
            group = st.dp_size * st.cp_size
            op = "reduce_scatter" if st.zero_state >= 1 else "all_reduce"
            bt = [
                sysc.compute_net_op_time(op, nb * g_el, path)
                for nb in dp_comm_buckets(dense_numel, group)
            ]
            rs = sum(bt)
            last_bucket_times.append(bt[-1])
            if st.zero_state == 2:
                # grads live sharded: reduce-scatter each microbatch
                rs *= st.micro_batch_num
            ag = (
                sum(
                    sysc.compute_net_op_time("all_gather", nb * p_el, path)
                    for nb in dp_comm_buckets(dense_numel, group)
                )
                if st.zero_state >= 1
                else 0.0
            )
            detail["dense_grad_rs_time"] = rs
            detail["dense_param_ag_time"] = ag
            t += rs + ag
        # tied-embedding grad sync between first/last stage replicas
        # (Megatron embedding-group all-reduce), ~a ring of two over the
        # pp path: two p2p transfers of the grad
        if (
            st.pp_size > 1
            and not self.model_config.untie_embeddings
            and stage in (0, st.pp_size - 1)
        ):
            emb_grad = (
                self.model_config.padded_vocab_size
                * self.model_config.hidden_size
                / st.tp_size
                * st.grad_element_size
            )
            t_tied = 2 * sysc.compute_net_op_time(
                "p2p", emb_grad, self.ctx.path("pp")
            )
            detail["tied_embedding_grad_ar_time"] = t_tied
            t += t_tied
        if st.edp_size > 1 and moe_numel and st.zero_state < 3:
            path = self.ctx.path("edp")
            op = "reduce_scatter" if st.zero_state >= 1 else "all_reduce"
            bt = [
                sysc.compute_net_op_time(op, nb * g_el, path)
                for nb in dp_comm_buckets(moe_numel, st.edp_size)
            ]
            rs = sum(bt)
            last_bucket_times.append(bt[-1])
            if st.zero_state == 2:
                rs *= st.micro_batch_num
            ag = (
                sum(
                    sysc.compute_net_op_time("all_gather", nb * p_el, path)
                    for nb in dp_comm_buckets(moe_numel, st.edp_size)
                )
                if st.zero_state >= 1
                else 0.0
            )
            detail["moe_grad_rs_time"] = rs
            detail["moe_param_ag_time"] = ag
            t += rs + ag
        # Megatron overlap flags: bucketed grad reduce hides under the
        # last microbatch's backward; the ZeRO-1 param all-gather hides
        # under the next iteration's first forward — only the excess is
        # exposed (keys below are what the simulator replays too)
        if t > 0 and (st.overlap_grad_reduce or st.overlap_param_gather):
            phases = self._stage_phase_inputs(stage)
            if st.overlap_grad_reduce:
                rs = (detail.get("dense_grad_rs_time", 0.0)
                      + detail.get("moe_grad_rs_time", 0.0))
                # ZeRO-2 reduce-scatters are issued per microbatch, each
                # hiding under its own backward; otherwise one bucketed
                # reduce overlaps only the last microbatch's backward.
                # Each stream's FINAL bucket only becomes ready when the
                # backward finishes, so it is never hideable (the dense
                # and MoE streams run on parallel channels — the longer
                # final bucket bounds the tail).
                n_windows = (
                    st.micro_batch_num if st.zero_state == 2 else 1
                )
                tail = max(last_bucket_times) if last_bucket_times else 0.0
                hidden = min(max(rs - tail * n_windows, 0.0),
                             phases["bwd"] * n_windows)
                if rs > 0:
                    scale = (rs - hidden) / rs
                    for k in ("dense_grad_rs_time", "moe_grad_rs_time"):
                        if k in detail:
                            detail[k] *= scale
                    detail["grad_reduce_hidden_time"] = hidden
                    t -= hidden
            if st.overlap_param_gather:
                ag = (detail.get("dense_param_ag_time", 0.0)
                      + detail.get("moe_param_ag_time", 0.0))
                # the gathers must complete once the first forward has
                # consumed the params; with VPP that first forward is
                # one chunk (1/vp of the stage's per-microbatch forward)
                hidden = min(ag, phases["fwd"] / st.vp_size)
                if ag > 0:
                    scale = (ag - hidden) / ag
                    for k in ("dense_param_ag_time", "moe_param_ag_time"):
                        if k in detail:
                            detail[k] *= scale
                    detail["param_gather_hidden_time"] = hidden
                    t -= hidden
        detail["total"] = t
        detail["exposed_rs"] = (
            detail.get("dense_grad_rs_time", 0.0)
            + detail.get("moe_grad_rs_time", 0.0)
            + detail.get("tied_embedding_grad_ar_time", 0.0)
        )
        detail["exposed_ag"] = (
            detail.get("dense_param_ag_time", 0.0)
            + detail.get("moe_param_ag_time", 0.0)
        )
        self._dp_time_cache[stage] = detail
        return detail

    def _compute_optim_time(self, stage: int = 0) -> float:
        """Optimizer-step time, memory-bound on HBM.

        "megatron" style models the distributed-optimizer phases
        (reference ``_compute_optim_time`` perf_llm.py:1470-1511):
        zero-grad, l2-norm, adam over fp32 master+moments, param copy.
        "functional" models one fused adam kernel as XLA emits for a
        functional JAX train step: read grad+param+moments, write
        param+moments.
        """
        st, sysc = self.strategy, self.system
        numel = 0.0
        for c in self.stage_chunks(stage):
            numel += c.param_info.dense_numel + c.param_info.moe_numel
        shard = numel / max(1, st.dp_size * st.cp_size) if st.zero_state else numel
        if st.optimizer_style == "functional":
            e = st.element_size
            # grad read + param read/write + two fp32 moments read/write;
            # the multi-stream fused update gets its own measured
            # bandwidth class when calibrated (falls back to default)
            traffic = shard * (st.grad_element_size + 2 * e + 16)
            return sysc.compute_mem_access_time(traffic, bw_key="fused_adam")
        t = 0.0
        t += sysc.compute_mem_access_time(numel * st.grad_element_size)  # zero grad
        t += sysc.compute_mem_access_time(shard * 4)  # l2 norm read
        t += sysc.compute_mem_access_time(shard * 28)  # adam r/w m,v,master+grad
        t += sysc.compute_mem_access_time(shard * (4 + st.element_size))  # cast copy
        return t

    def straggler_ratio(self) -> float:
        """Machine-variance inflation (reference perf_llm.py:255-291)."""
        st = self.strategy
        if not st.enable_straggler_model:
            return 1.0
        sysc = self.system
        hosts = max(1, st.world_size // max(1, sysc.chips_per_slice))
        n = min(hosts, st.dp_size, max(st.edp_size, 1))
        if n <= 1:
            return 1.0
        nhat = math.log2(n)
        return 1.0 + nhat / (nhat + 1.0) * 0.09 * math.sqrt(nhat)

    def analysis_cost(self) -> dict:
        if self._cost_result is not None:
            return self._cost_result
        st, m = self.strategy, self.model_config
        phase_inputs = [self._stage_phase_inputs(s) for s in range(st.pp_size)]
        if st.vp_size > 1:
            pp_res = self.calculate_interleaved_schedule()
            pp_res.pop("orders", None)
        else:
            pp_res = self.calculate_1f1b_bubble(phase_inputs)
        # per-op intervals feed the analytical trace export, not the
        # (JSON-saved) result dict
        self._schedule_events = pp_res.pop("events", [])
        # stages differ in params (embedding/head, MoE dense_layers), so
        # the iteration ends on the *max path*: each stage finishes its
        # backward, exposes its grad comm, all ranks barrier before the
        # step, then each runs its optimizer + param gather
        dp_by_stage = [self._compute_dp_time(s) for s in range(st.pp_size)]
        optim_by_stage = [
            self._compute_optim_time(s) for s in range(st.pp_size)
        ]
        ends = pp_res["per_stage_end"]
        s_rs = max(
            range(st.pp_size),
            key=lambda s: ends[s] + dp_by_stage[s]["exposed_rs"],
        )
        barrier_t = ends[s_rs] + dp_by_stage[s_rs]["exposed_rs"]
        s_tail = max(
            range(st.pp_size),
            key=lambda s: optim_by_stage[s] + dp_by_stage[s]["exposed_ag"],
        )
        tail = optim_by_stage[s_tail] + dp_by_stage[s_tail]["exposed_ag"]
        iter_time = barrier_t + tail
        # breakdown reports the binding (max-path) stages so the parts
        # still account for iter_time: iter = end[s_rs] + dp_comm + optim
        dp_res = dict(dp_by_stage[s_rs])
        dp_res["total"] = (
            dp_by_stage[s_rs]["exposed_rs"] + dp_by_stage[s_tail]["exposed_ag"]
        )
        optim = optim_by_stage[s_tail]
        ratio = self.straggler_ratio()
        iter_time *= ratio

        tokens = st.tokens_per_iter
        model_flops = m.train_flops_per_token(st.seq_len) * tokens
        per_chip = model_flops / st.world_size / iter_time
        peak = self.system.accelerator.op["default"].tflops * 1e12
        # time breakdown (stage 0 representative, per microbatch)
        chunks0 = self.stage_chunks(0)
        net_exposed = sum(c.cost_info.total_net_exposed for c in chunks0)
        compute_mb = sum(c.cost_info.compute.total for c in chunks0)
        recompute_mb = sum(c.cost_info.recompute_time for c in chunks0)
        # HBM-busy share of the rooflined compute (diagnostic: the
        # remainder is MXU-bound slack an async HBM stream could hide in)
        hbm_busy_mb = sum(c.cost_info.mem_bound.total for c in chunks0)
        breakdown = {
            "compute_per_microbatch": compute_mb,
            "exposed_comm_per_microbatch": net_exposed,
            "recompute_per_microbatch": recompute_mb,
            "hbm_busy_per_microbatch": hbm_busy_mb,
            "bubble": pp_res["bubble"],
            "dp_comm": dp_res["total"],
            "optimizer": optim,
        }
        result = {
            "iter_time": iter_time,
            "iter_time_ms": iter_time * 1e3,
            "pp_total_time": pp_res["total"],
            "bubble_time": pp_res["bubble"],
            "dp_comm": dp_res,
            "optim_time": optim,
            "straggle_ratio": ratio,
            "mfu": per_chip / peak,
            "tflops_per_chip": per_chip / 1e12,
            "tokens_per_sec": tokens / iter_time,
            "tgs": tokens / iter_time / st.world_size,
            "stage_phase_inputs": phase_inputs,
            "net_exposed_per_microbatch": net_exposed,
            "time_breakdown": breakdown,
            # attribution provenance (observe/ledger.py waterfall): the
            # schedule's per-stage finish times and the two binding
            # (max-path) stages the iteration end actually rode on
            "per_stage_end": list(ends),
            "binding_stage_rs": s_rs,
            "binding_stage_tail": s_tail,
            "exposed_rs_time": dp_by_stage[s_rs]["exposed_rs"],
            "exposed_ag_time": dp_by_stage[s_tail]["exposed_ag"],
        }
        self._cost_result = result
        return result

    # ------------------------------------------------------------------
    # Combined report (reference ``analysis`` perf_llm.py:3585-3668)
    # ------------------------------------------------------------------
    def analysis(self, save_path: Optional[str] = None, verbose: bool = True) -> dict:
        mem = self.analysis_mem()
        cost = self.analysis_cost()
        st = self.strategy
        result = {
            "base_info": {
                "model": self.model_config.model_name,
                "system": self.system.sys_name,
                "world_size": st.world_size,
                "parallelism": {
                    "tp": st.tp_size, "cp": st.cp_size, "pp": st.pp_size,
                    "dp": st.dp_size, "ep": st.ep_size, "etp": st.etp_size,
                    "vp": st.vp_size,
                },
                "seq_len": st.seq_len,
                "global_batch_size": st.global_batch_size,
                "param_numel": self.model_config.param_numel(),
            },
            "mem_result": mem,
            "compute_result": cost,
            "net_info": {k: p.describe() for k, p in self.ctx.paths.items()},
            "efficiency_misses": self.system.miss_efficiency,
        }
        self.diagnostics.record_efficiency(self.system)
        result["diagnostics"] = self.diagnostics.to_dict()
        if verbose:
            self._print_summary(result)
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            self.diagnostics.write(os.path.join(save_path, "diagnostics.json"))
            for key in ("base_info", "mem_result", "compute_result", "net_info"):
                with open(os.path.join(save_path, f"{key}.json"), "w") as f:
                    json.dump(result[key], f, indent=2, default=str)
            with open(os.path.join(save_path, "op_table.json"), "w") as f:
                json.dump(
                    {
                        f"stage{s}": [
                            row
                            for c in self.stage_chunks(s)
                            for row in c.op_table()
                        ]
                        for s in range(self.strategy.pp_size)
                    },
                    f,
                    indent=1,
                )
            if self.ctx.graph is not None:
                self.ctx.graph.save_json(
                    os.path.join(save_path, "graph.json")
                )
                self.ctx.graph.save_dot(os.path.join(save_path, "graph.dot"))
            if self.ctx.debug.enabled and self.ctx.debug.rows:
                with open(os.path.join(save_path, "cost_log.json"), "w") as f:
                    json.dump(self.ctx.debug.rows, f, indent=1)
            # annotated module tree (reference model_arch dump)
            with open(os.path.join(save_path, "model_arch.txt"), "w") as f:
                for (stage, chunk_idx), chunk in sorted(self.chunks.items()):
                    f.write(f"===== stage {stage} chunk {chunk_idx} =====\n")
                    f.write(repr(chunk) + "\n")
            # the exact configs this estimate ran with (reference
            # *_config.json dumps)
            for name, cfg in (
                ("model_config", self.model_config),
                ("strategy_config", self.strategy),
                ("system_config", self.system),
            ):
                with open(os.path.join(save_path, f"{name}.json"), "w") as f:
                    f.write(cfg.to_json_string())
        return result

    def _print_summary(self, result: dict):
        print_summary(result)

    def ledger(self):
        """Collect the cost-attribution ledger of the current estimate
        (see ``observe/ledger.py``): per-op and per-collective spans with
        efficiency provenance, the MFU-loss waterfall, and the headline
        summary. Post-hoc over the retained symbolic tree — calling it
        never changes the estimate (ledger-on and ledger-off predictions
        are bit-identical)."""
        from simumax_tpu_torch.observe.ledger import Ledger

        return Ledger.collect(self)

    def memory_ledger(self, timeline: bool = True):
        """Collect the per-tensor HBM ledger of the current estimate
        (``observe/memledger.py``): the full live set at each stage's
        predicted peak as ``MemSpan`` records, the peak-HBM waterfall
        (buckets sum to ``analysis_mem()["max_peak_bytes"]`` within
        1e-6), and the analytical memory timeline in the simulator's
        snapshot schema. Post-hoc and read-only like :meth:`ledger` —
        headline numbers with and without collection are bit-identical."""
        from simumax_tpu_torch.observe.memledger import MemoryLedger

        return MemoryLedger.collect(self, timeline=timeline)

    def memory_crosscheck(self, granularity: str = "leaf"):
        """Per-stage analytical-vs-DES peak cross-check
        (``observe/memledger.py::mem_crosscheck``): replay the step in
        the discrete-event simulator with memory tracking and compare
        each stage's simulated peak against this estimate's
        ``analysis_mem`` prediction — the memory analog of the sweep's
        ``sim_vs_analytical`` time column."""
        from simumax_tpu_torch.observe.memledger import mem_crosscheck

        return mem_crosscheck(self, granularity=granularity)

    def simulate(self, save_path: Optional[str] = None, **kwargs):
        """Discrete-event replay of the estimated iteration
        (``simulator/runner.py``). Key kwargs: ``granularity``
        ("leaf"/"chunk"), ``world_ranks`` (simulate every global rank),
        ``perturbation`` ({rank: compute multiplier} straggler
        injection), ``reduce`` (rank-symmetry reduction: "auto" / True /
        False), ``track_memory``, ``stream_trace`` (bounded-RSS
        incremental trace write), ``critical_path`` (record the
        event-dependency skeleton and attach the slack / blame /
        divergence report — ``observe/critpath.py``,
        ``docs/observability.md``). Reports into
        ``self.diagnostics``."""
        from simumax_tpu_torch.simulator.runner import run_simulation

        return run_simulation(self, save_path, **kwargs)

    def critical_path(self, save_path: Optional[str] = None, **kwargs):
        """Convenience wrapper: :meth:`simulate` with
        ``critical_path=True``, returning just the critical-path report
        (per-event slack, the cross-rank path, the simulated waterfall
        summing to the DES makespan, sim-vs-analytical divergence, and
        per-rank / per-link slack headroom)."""
        return self.simulate(
            save_path, critical_path=True, **kwargs
        )["critical_path"]

    def predict_goodput(self, scenario, **kwargs):
        """Goodput prediction for a fault scenario over its job horizon
        (``simulator/faults.py``, ``docs/faults.md``): per-step
        discrete-event replays under the scenario's timed faults plus
        the checkpoint-write / restore-read / restart-replay cost
        model. Returns a ``GoodputReport`` whose wall-time buckets sum
        to the wall time exactly."""
        from simumax_tpu_torch.simulator.faults import predict_goodput

        return predict_goodput(self, scenario, **kwargs)

    def analyze_faults(self, **kwargs):
        """Seeded Monte-Carlo goodput analysis: sample N random fault
        scenarios, predict each one's goodput, and sweep checkpoint
        intervals for the optimum (``simulator/faults.py::
        analyze_faults``)."""
        from simumax_tpu_torch.simulator.faults import analyze_faults

        return analyze_faults(self, **kwargs)

    def rebatched_iter_time(self, micro_batch_num: int) -> float:
        """Analytical iteration time (seconds) of this built layout
        under a different micro-batch count, via the :meth:`rebatch`
        fast path — the fleet simulator's elastic-reshape re-costing
        (``fleet/sim.py``): after a dp shrink the surviving replicas
        carry ``gbs / (dp_eff * mbs)`` microbatches each, and only the
        schedule/memory analyses read ``micro_batch_num``, so the
        shrunk step is re-costed without rebuilding the module tree.

        Mutates this estimate's strategy (the caller owns a dedicated
        costing estimate; the fleet's per-template runtime keeps one
        beside the replay context's untouched estimate) and leaves it
        re-estimated at ``micro_batch_num`` on return."""
        from simumax_tpu_torch.search.prune import clone_strategy

        st = clone_strategy(self.strategy)
        st.micro_batch_num = int(micro_batch_num)
        st.__post_init__()
        self.rebatch(st)
        return self.analysis_cost()["iter_time"]

    def analysis_dualpp(self, save_path: Optional[str] = None):
        """Per-rank DualPipe projection of this estimate (even pp only):
        bidirectional schedule, 2 stage chunks per rank, pp+1 in-flight
        activation bound. ``save_path`` renders the overlapped F&B cell
        timeline PNG. See ``parallel/dualpp.py``."""
        from simumax_tpu_torch.parallel.dualpp import analyze

        return analyze(self, save_path)

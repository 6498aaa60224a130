"""LLM block / per-stage model chunk (L3 top).

Reference: ``simumax/core/transformer/language_model.py`` (``LLMBlock:98``,
``LLMModel:210``, activation replay ``compute_activations:355-467``,
``PeakPoint:12``).

Copy of the JAX package's ``models/llm.py``; only its import paths
changed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from simumax_tpu_torch.core.module import BuildContext, MetaModule
from simumax_tpu_torch.core.tensor import TensorSpec
from simumax_tpu_torch.models.dense import (
    AddFunction,
    Attention,
    Dropout,
    Embedding,
    LayerNorm,
    LinearCol,
    MLP,
    ParallelCE,
)


@dataclass
class PeakPoint:
    path: str = ""
    stage: str = ""
    bytes: float = 0.0


class LLMBlock(MetaModule):
    """One transformer layer (reference ``language_model.py:98-207``):
    input norm -> attention -> residual -> pre-MLP norm -> MLP/ExpertMLP ->
    residual, with per-layer recompute wiring."""

    def __init__(self, ctx: BuildContext, layer_idx: int, idx_in_stage: int,
                 name=""):
        super().__init__(ctx, name or f"layer{layer_idx}")
        self.layer_idx = layer_idx
        m, st = ctx.model, ctx.strategy
        quantized = st.fp8
        self.input_norm = LayerNorm(ctx, name="input_norm")
        if m.attention_type == "mla":
            try:
                from simumax_tpu_torch.models.mla import MLAAttention
            except ImportError as e:  # pragma: no cover
                raise NotImplementedError(
                    "MLA attention is not available in this build"
                ) from e

            self.attention = MLAAttention(ctx, quantized=quantized)
        else:
            self.attention = Attention(ctx, quantized=quantized)
        if ctx.strategy.enable_dropout:
            self.attn_dropout = Dropout(ctx, name="attn_dropout")
        self.add_attn = AddFunction(ctx, name="residual_attn")
        self.pre_mlp_norm = LayerNorm(ctx, name="pre_mlp_norm")
        self.is_moe_layer = (
            m.model_type == "moe" and layer_idx >= m.dense_layers
        )
        if self.is_moe_layer:
            from simumax_tpu_torch.models.moe import ExpertMLP

            self.mlp = ExpertMLP(ctx, quantized=quantized)
        else:
            self.mlp = MLP(ctx, quantized=quantized)
        if ctx.strategy.enable_dropout:
            self.mlp_dropout = Dropout(ctx, name="mlp_dropout")
        self.add_mlp = AddFunction(ctx, name="residual_mlp")
        self._wire_recompute(idx_in_stage)

    def _wire_recompute(self, idx_in_stage: int):
        rc = self.ctx.strategy.recompute
        if not rc.enabled or not rc.layer_recomputes(idx_in_stage):
            return
        if rc.granularity == "full_block":
            self.mark_recompute()
            return
        # selective
        # megatron tail modules force the tail model on exactly their
        # own segments (reference use_variance_tail_model, per-module);
        # None -> the segment follows the global recompute_variance flag
        def tail(module_name):
            return True if module_name in rc.tail_modules else None

        if rc.sdp_recompute:
            core = getattr(self.attention, "core", None)
            if core is not None:
                core.mark_recompute()
        if rc.attn_recompute:
            self.attention.mark_recompute()
        if rc.attn_norm_recompute:
            self.input_norm.mark_recompute(variance=tail("layernorm"))
            # MLA internal rms norms (reference mla_rms_recompute)
            for norm in getattr(self.attention, "norms", []):
                norm.mark_recompute(variance=tail("layernorm"))
        if rc.mla_up_proj_recompute:
            # MLA up-projections only (megatron_recompute_modules
            # "mla_up_proj"): the latent caches stay, the big q/kv
            # expansions replay
            for name in ("q_up", "kv_up"):
                mod = getattr(self.attention, name, None)
                if mod is not None:
                    mod.mark_recompute(variance=tail("mla_up_proj"))
        if rc.mlp_recompute:
            self.mlp.mark_recompute()
        if rc.mlp_norm_recompute:
            self.pre_mlp_norm.mark_recompute(variance=tail("layernorm"))
        if rc.moe_act_recompute and self.is_moe_layer:
            # expert activation only (megatron_recompute_modules
            # "moe_act"); skipped when the whole mlp is already marked
            if not self.mlp.recompute:
                self.mlp.act.mark_recompute(variance=tail("moe_act"))

    def _post_forward(self):
        st = self.ctx.strategy
        if st.zero_state >= 3:
            # FSDP gathers/reduce-scatters hide under the block's own
            # compute; only the excess lands on the critical path. The
            # compute already granted to async-CP a2a hiding is not
            # available twice.
            leaves = self.called_leaves()
            for phase in ("fwd", "bwd_act", "bwd_w"):
                compute = sum(
                    l.cost_info.compute.get(phase) for l in leaves
                )
                cp_hidden = sum(
                    c.time - c.exposed_time
                    for l in leaves
                    for c in l.collective_calls
                    if c.dim == "cp" and c.phase == phase
                )
                budget = max(compute - cp_hidden, 0.0)
                self.expose_unhidden(leaves, phase, budget,
                                     dims=("dp_cp", "edp"))
            # leaf mutations must propagate through the intermediate
            # composites (attention/mlp) before this block aggregates
            for c in self.children():
                c.reaggregate()

    def forward(self, x: TensorSpec) -> TensorSpec:
        h = self.input_norm(x)
        h = self.attention(h)
        if self.ctx.strategy.enable_dropout:
            h = self.attn_dropout(h)
        x = self.add_attn(x, h)
        h = self.pre_mlp_norm(x)
        h = self.mlp(h)
        if self.ctx.strategy.enable_dropout:
            h = self.mlp_dropout(h)
        return self.add_mlp(x, h)


class LLMModel(MetaModule):
    """One PP-stage model chunk (reference ``language_model.py:210-607``):
    optional Embedding (preprocess), N LLMBlocks, optional final norm +
    LM head + ParallelCE (postprocess)."""

    def __init__(
        self,
        ctx: BuildContext,
        layer_num: int,
        layer_offset: int = 0,
        preprocess: bool = True,
        postprocess: bool = True,
        stage_idx: int = 0,
        chunk_idx: int = 0,
        name: str = "",
    ):
        super().__init__(ctx, name or f"stage{stage_idx}")
        self.layer_num = layer_num
        self.layer_offset = layer_offset
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.stage_idx = stage_idx
        self.chunk_idx = chunk_idx
        m = ctx.model
        if preprocess:
            self.embedding = Embedding(ctx)
            if ctx.strategy.enable_dropout:
                self.embedding_dropout = Dropout(ctx, name="embedding_dropout")
        self.blocks: List[LLMBlock] = []
        for i in range(layer_num):
            blk = LLMBlock(ctx, layer_offset + i, i)
            self.add_child(f"layer{layer_offset + i}", blk)
            self.blocks.append(blk)
        if postprocess:
            self.final_norm = LayerNorm(ctx, name="final_norm")
            # a tied lm_head owns no extra params only when the
            # embedding lives in the same chunk; at pp>1 the last stage
            # holds a physical replica of the tied weight (Megatron)
            self.lm_head = LinearCol(
                ctx, m.hidden_size, m.padded_vocab_size, "lm_head",
                count_params=m.untie_embeddings or not preprocess,
            )
            self.ce = ParallelCE(ctx, name="parallel_ce")
        self.peak_point: Optional[PeakPoint] = None

    # -- symbolic run ------------------------------------------------------
    def input_spec(self) -> TensorSpec:
        st = self.ctx.strategy
        b, s = st.micro_batch_size, st.seq_len
        s_cp = s // st.cp_size
        if self.preprocess:
            return TensorSpec((b, s_cp), "int32")
        s_sp = s_cp // st.tp_size if st.enable_sequence_parallel else s_cp
        return TensorSpec((b, s_sp, self.ctx.model.hidden_size), st.dtype)

    def forward(self, x: TensorSpec) -> TensorSpec:
        if self.preprocess:
            x = self.embedding(x)
            if self.ctx.strategy.enable_dropout:
                x = self.embedding_dropout(x)
        # layer dedup: blocks with identical construction signature and
        # input shape produce identical profiles — evaluate one
        # representative, adopt for the rest (search-loop scalability;
        # disabled under graph capture, which needs every real edge, and
        # under the per-path debug probe, which records per-layer rows)
        dedup = (
            self.ctx.layer_dedup
            and self.ctx.graph is None
            and not self.ctx.debug.enabled
        )
        reps = {}
        for blk in self.blocks:
            if not dedup:
                x = blk(x)
                continue
            sig = (
                blk.is_moe_layer,
                self._block_recompute_sig(blk),
                x.shape,
                x.dtype,
            )
            rep = reps.get(sig)
            if rep is not None:
                x = blk.adopt_call_from(rep, x)
            else:
                x = blk(x)
                reps[sig] = blk
        if self.postprocess:
            x = self.final_norm(x)
            x = self.lm_head(x)
            x = self.ce(x)
        return x

    @staticmethod
    def _block_recompute_sig(blk: LLMBlock) -> tuple:
        """Recompute wiring fingerprint: which leaves are checkpointed
        and how (layer_recomputes(idx) makes leading layers differ)."""
        return tuple(
            (l.in_recompute, l.recompute_status.name, l.variance_tail)
            for l in blk.leaves()
        )

    def run(self) -> TensorSpec:
        return self(self.input_spec())

    # -- p2p message size --------------------------------------------------
    def boundary_bytes(self) -> float:
        """Bytes of the hidden-state tensor crossing a PP boundary
        (reference ``core/utils.py:203-212``)."""
        st = self.ctx.strategy
        s_cp = st.seq_len // st.cp_size
        s_sp = s_cp // st.tp_size if st.enable_sequence_parallel else s_cp
        return (
            st.micro_batch_size
            * s_sp
            * self.ctx.model.hidden_size
            * st.element_size
        )

    # -- activation replay (reference ``language_model.py:355-467``) -------
    def activation_events(self):
        """The activation-replay walk as an event stream — the single
        source for both :meth:`compute_activations` (scalar fold to the
        peak) and the memory ledger's peak live-set materialization
        (``observe/memledger.py``), so the two can never diverge.

        Yields tuples:

        * ``("alloc", leaf, kind, bytes)`` / ``("free", leaf, kind,
          bytes)`` — the live set grows/shrinks by ``bytes``; ``kind``
          is ``act_cache`` (fwd-to-bwd activation cache) or
          ``recompute_cache`` (raw cache re-materialized during a
          checkpointed segment's replay);
        * ``("probe", leaf, stage, extras)`` — a candidate peak at the
          current live set plus the transient ``extras``: an ordered
          tuple of ``(kind, bytes)`` terms (``fwd_temp`` /
          ``bwd_temp`` / ``grad_flight`` / the negative
          ``saved_input_reuse`` adjustment of a segment replay), summed
          onto ``live`` left-to-right so the fold reproduces the
          historical float-op order bit-for-bit.
        """
        leaves = self.called_leaves()
        # ---- forward walk
        for leaf in leaves:
            yield ("alloc", leaf, "act_cache", leaf.act_info.cache_bytes)
            yield ("probe", leaf, "fwd",
                   (("fwd_temp", leaf.raw_act_info.fwd_temp_bytes),))

        # ---- backward walk with recompute replay. Segments need not be
        # contiguous in the call order (e.g. sdp-only inside a
        # checkpointed attention), so consumed leaves are tracked in a set.
        done = set()
        i = len(leaves) - 1
        while i >= 0:
            leaf = leaves[i]
            if id(leaf) in done:
                i -= 1
                continue
            seg = getattr(leaf, "recompute_segment", None)
            if leaf.in_recompute and seg is not None:
                seg_leaves = [
                    l
                    for l in leaves
                    if getattr(l, "recompute_segment", None) is seg
                ]
                # replay fwd: raw caches come alive again; the saved segment
                # input (FIRST leaf's effective cache) is reused, not
                # re-allocated, and is freed with FIRST's raw cache below.
                # A variance-tail leaf is not replayed, so its raw cache
                # never re-materialises; if the tail IS the first leaf
                # (single-leaf segment) the saved input must stay live
                # until that leaf's backward consumes it.
                saved = seg_leaves[0].act_info.cache_bytes
                tail_is_first = seg_leaves[0].variance_tail
                for sl in seg_leaves:
                    if sl.variance_tail:
                        continue
                    yield ("alloc", sl, "recompute_cache",
                           sl.raw_act_info.cache_bytes)
                    yield ("probe", sl, "recompute",
                           (("saved_input_reuse", -saved),
                            ("fwd_temp", sl.raw_act_info.fwd_temp_bytes)))
                if not tail_is_first:
                    yield ("free", seg_leaves[0], "act_cache", saved)
                # consume raw caches in reverse as bwd proceeds
                for sl in reversed(seg_leaves):
                    yield ("probe", sl, "bwd",
                           (("bwd_temp", sl.raw_act_info.bwd_temp_bytes),
                            ("grad_flight",
                             sl.raw_act_info.grad_flight_bytes)))
                    if sl.variance_tail:
                        if sl is seg_leaves[0]:
                            yield ("free", sl, "act_cache", saved)
                    else:
                        yield ("free", sl, "recompute_cache",
                               sl.raw_act_info.cache_bytes)
                    done.add(id(sl))
                i -= 1
                continue
            yield ("probe", leaf, "bwd",
                   (("bwd_temp", leaf.raw_act_info.bwd_temp_bytes),
                    ("grad_flight", leaf.raw_act_info.grad_flight_bytes)))
            yield ("free", leaf, "act_cache", leaf.act_info.cache_bytes)
            done.add(id(leaf))
            i -= 1

    def compute_activations(self) -> PeakPoint:
        """Fold :meth:`activation_events`, tracking the live activation
        set; returns the peak.

        Conservation invariant: the live set must return to ~0 after the
        backward walk (reference ``language_model.py:462-465``).
        """
        live = 0.0
        peak = PeakPoint()
        for ev in self.activation_events():
            op = ev[0]
            if op == "alloc":
                live += ev[3]
            elif op == "free":
                live -= ev[3]
            else:  # probe
                cand = live
                for _, extra in ev[3]:
                    cand += extra
                if cand > peak.bytes:
                    peak = PeakPoint(ev[1].path_name(), ev[2], cand)

        assert abs(live) < 1024, (
            f"activation conservation violated: {live} bytes left live"
        )
        self.peak_point = peak
        return peak

    # -- tables ------------------------------------------------------------
    def op_table(self) -> List[dict]:
        """Per-leaf cost/memory rows (reference ``language_model.py:514``)."""
        rows = []
        for leaf in self.called_leaves():
            rows.append(
                {
                    "path": leaf.path_name(),
                    "fwd_ms": leaf.cost_info.fwd_time * 1e3,
                    "bwd_ms": leaf.cost_info.bwd_time * 1e3,
                    "net_ms": leaf.cost_info.total_net_exposed * 1e3,
                    "fwd_gflops": leaf.compute_info.fwd_flops / 1e9,
                    "cache_mib": leaf.act_info.cache_bytes / 2**20,
                    "weight_mib": (
                        leaf.param_info.weight_bytes
                        + leaf.param_info.moe_weight_bytes
                    )
                    / 2**20,
                }
            )
        return rows

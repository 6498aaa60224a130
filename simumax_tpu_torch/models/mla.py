"""Multi-head Latent Attention (MLA) analytical ops (L3).

Reference: ``simumax/core/transformer/dense_module.py``
(``MLACoreAttention:1606-1805``, ``MLAAttention:2569-2887``).

Structure (DeepSeek-V2/V3): optionally low-rank q path
(``q_down -> q_norm -> q_up``), low-rank kv path
(``kv_down -> kv_norm -> kv_up``) plus a shared RoPE key branch; the
score dot uses ``qk_head_dim + qk_pos_emb_head_dim`` while values use
``v_head_dim``. Down-projections are replicated (no TP comm, rows stay
seq-sharded); up-projections are column-parallel with the usual SP
gathers. The RoPE key branch is gathered explicitly (SeqAllGather) since
it bypasses the column-parallel kv_up.

Copy of the JAX package's ``models/mla.py``; only its import paths
changed.
"""

from __future__ import annotations

from simumax_tpu_torch.core.module import MetaModule
from simumax_tpu_torch.core.tensor import TensorSpec
from simumax_tpu_torch.models.dense import (
    ContextParallelA2A,
    CoreAttention,
    KVAllGather,
    LayerNorm,
    LinearCol,
    LinearRow,
    RotaryEmbedding,
    SeqAllGather,
    _st,
)


class MLAAttention(MetaModule):
    def __init__(self, ctx, name="mla_attention", quantized=False):
        super().__init__(ctx, name)
        m, st = ctx.model, ctx.strategy
        self.qk_dim = m.qk_head_dim + m.qk_pos_emb_head_dim
        q_out = m.head_num * self.qk_dim
        if m.q_lora_rank:
            self.q_down = LinearCol(ctx, m.hidden_size, m.q_lora_rank,
                                    "q_down", replicated=True)
            self.q_norm = LayerNorm(ctx, hidden=m.q_lora_rank, name="q_norm")
            self.q_up = LinearCol(ctx, m.q_lora_rank, q_out, "q_up",
                                  quantized=quantized)
        else:
            self.q_proj = LinearCol(ctx, m.hidden_size, q_out, "q_proj",
                                    quantized=quantized)
        self.kv_down = LinearCol(
            ctx, m.hidden_size, m.kv_lora_rank + m.qk_pos_emb_head_dim,
            "kv_down", replicated=True,
        )
        self.kv_norm = LayerNorm(ctx, hidden=m.kv_lora_rank, name="kv_norm")
        self.kv_up = LinearCol(
            ctx,
            m.kv_lora_rank,
            m.head_num * (m.qk_head_dim + m.v_head_dim),
            "kv_up",
            quantized=quantized,
        )
        # ledger tags: keep the low-rank latent path distinguishable from
        # generic GEMMs in `explain` output — the mla_up_proj recompute
        # knob targets exactly the "mla_up_proj" rows, and the down/up
        # split is the first thing a DeepSeek-shape misprediction triage
        # looks at (docs/observability.md)
        for mod in ([self.q_up] if m.q_lora_rank else []) + [self.kv_up]:
            mod.op_category = "mla_up_proj"
        for mod in ([self.q_down] if m.q_lora_rank else []) + [self.kv_down]:
            mod.op_category = "mla_down_proj"
        if st.enable_sequence_parallel and st.tp_size > 1:
            self.rope_gather = SeqAllGather(ctx, "tp", "rope_k_gather")
        self.rope = RotaryEmbedding(ctx, name="rope")
        if st.cp_size > 1 and st.cp_comm_type == "a2a":
            self.cp_q = ContextParallelA2A(ctx, "scatter_heads", "cp_a2a_q")
            self.cp_k = ContextParallelA2A(ctx, "scatter_heads", "cp_a2a_k")
            self.cp_v = ContextParallelA2A(ctx, "scatter_heads", "cp_a2a_v")
            self.cp_o = ContextParallelA2A(ctx, "gather_seq", "cp_a2a_o")
        elif st.cp_size > 1 and st.cp_comm_type == "all_gather":
            self.kv_gather_k = KVAllGather(ctx, name="kv_allgather_k")
            self.kv_gather_v = KVAllGather(ctx, name="kv_allgather_v")
        self.core = CoreAttention(ctx, name="mla_core_attention")
        self.out_proj = LinearRow(
            ctx, m.head_num * m.v_head_dim, m.hidden_size, "out_proj",
            quantized=quantized,
        )
        self.norms = [self.kv_norm] + (
            [self.q_norm] if m.q_lora_rank else []
        )

    def _post_forward(self):
        from simumax_tpu_torch.models.dense import bound_async_cp_overlap

        bound_async_cp_overlap(self)

    def forward(self, x: TensorSpec) -> TensorSpec:
        st, m = _st(self.ctx), self.ctx.model
        tp = st.tp_size
        hl = m.head_num // tp

        if m.q_lora_rank:
            q = self.q_down(x)
            q = self.q_norm(q)
            q = self.q_up(q)
        else:
            q = self.q_proj(x)
        b, s, _ = q.shape
        q = q.with_shape(b, s, hl, self.qk_dim)

        kv = self.kv_down(x)
        kv_c = kv.with_shape(kv.shape[0], kv.shape[1], m.kv_lora_rank)
        k_rope = kv.with_shape(kv.shape[0], kv.shape[1], m.qk_pos_emb_head_dim)
        kv_c = self.kv_norm(kv_c)
        kv_up = self.kv_up(kv_c)  # [b, s, hl*(qk_nope + v)]
        if hasattr(self, "rope_gather"):
            k_rope = self.rope_gather(k_rope)
        # k = concat(k_nope, broadcast k_rope): [b, s, hl, qk_dim]
        k = kv_up.with_shape(b, s, hl, self.qk_dim)
        v = kv_up.with_shape(b, s, hl, m.v_head_dim)
        q, k = self.rope(q, k)
        if st.cp_size > 1 and st.cp_comm_type == "a2a":
            q = self.cp_q(q)
            k = self.cp_k(k)
            v = self.cp_v(v)
        elif st.cp_size > 1 and st.cp_comm_type == "all_gather":
            k = self.kv_gather_k(k)
            v = self.kv_gather_v(v)
        o = self.core(q, k, v)
        if st.cp_size > 1 and st.cp_comm_type == "a2a":
            o = self.cp_o(o)
        b2, s2, hl2, dv = o.shape
        return self.out_proj(o.with_shape(b2, s2, hl2 * dv))

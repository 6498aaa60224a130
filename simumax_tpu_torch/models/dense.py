"""Dense analytical ops (L3).

Reference: ``simumax/core/transformer/dense_module.py`` (Embedding:18,
LinearCol:195, LinearRow:511, LayerNorm:784, CoreAttention:1061,
RotaryEmbedding:1806, Swiglu/Gelu:1874, ParallelCE:2097, Attention:2454,
MLP:2888).

Shape conventions (all sizes are **per-device, per-microbatch**):

* ``s_cp``  = seq_len / cp — the sequence shard attention-external ops see
  under context parallelism;
* ``s_sp``  = s_cp / tp when Megatron sequence-parallel is on — the shard
  between TP regions;
* TP collectives ride the ``tp`` CommPath (innermost ICI axis), CP a2a the
  ``cp`` path, etc. Collective ``size_bytes`` is always the *full logical
  tensor* being communicated (matching ``SystemConfig.compute_net_op_time``
  semantics).

Copy of the JAX package's ``models/dense.py``; the one change is the
default attention backend of the sdp shape keys, ``"torch"`` instead of
``"xla"`` (a ``"cuda"`` key is prefixed ``backend=cuda,``).
"""

from __future__ import annotations

from typing import Dict, List

from simumax_tpu_torch.core.config import _require
from simumax_tpu_torch.core.module import BuildContext, GemmBase, LeafModule, MetaModule
from simumax_tpu_torch.core.records import ActivationInfo, CollectiveCall
from simumax_tpu_torch.core.tensor import TensorSpec


def _st(ctx: BuildContext):
    return ctx.strategy


# --------------------------------------------------------------------------
# Shape-only "function" ops (reference ``transformer/function.py``)
# --------------------------------------------------------------------------


class AddFunction(LeafModule):
    """Residual add: memory-bound, no cache (bwd is fan-out passthrough)."""

    op_category = "elementwise"

    def forward_spec(self, a: TensorSpec, b: TensorSpec) -> TensorSpec:
        assert a.shape == b.shape, (a.shape, b.shape)
        return a.with_shape(*a.shape)

    def op_accessed(self) -> Dict[str, float]:
        n = self.outputs[0].bytes
        return {"fwd": 3 * n}


class SplitFunction(LeafModule):
    """Split last dim into parts; zero-cost shape op."""

    op_category = "elementwise"

    def __init__(self, ctx, sizes, name=""):
        super().__init__(ctx, name)
        self.sizes = sizes

    def forward_spec(self, x: TensorSpec):
        assert sum(self.sizes) == x.shape[-1]
        return tuple(x.with_shape(*x.shape[:-1], sz) for sz in self.sizes)


class ConcatFunction(LeafModule):
    op_category = "elementwise"

    def __init__(self, ctx, dim=-1, name=""):
        super().__init__(ctx, name)
        self.dim = dim

    def forward_spec(self, *xs: TensorSpec):
        base = list(xs[0].shape)
        base[self.dim] = sum(x.shape[self.dim] for x in xs)
        return xs[0].with_shape(*base)

    def op_accessed(self) -> Dict[str, float]:
        n = self.outputs[0].bytes
        return {"fwd": 2 * n, "bwd_act": 2 * n}


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------


class Embedding(LeafModule):
    """TP-sharded vocab embedding (reference ``dense_module.py:18-193``):
    fwd TP all-reduce (or SP reduce-scatter); bwd-W all-gather under SP;
    ZeRO-1 state sharding."""

    op_category = "embedding"

    def __init__(self, ctx, name="embedding"):
        super().__init__(ctx, name)
        st = _st(ctx)
        self.vocab = ctx.model.padded_vocab_size
        self.hidden = ctx.model.hidden_size
        self.numel = self.vocab * self.hidden // st.tp_size

    def forward_spec(self, ids: TensorSpec) -> TensorSpec:
        st = _st(self.ctx)
        b, s = ids.shape
        if st.enable_sequence_parallel:
            s = s // st.tp_size
        return TensorSpec((b, s, self.hidden), st.dtype)

    def op_accessed(self) -> Dict[str, float]:
        out = self.outputs[0]
        full = out.bytes * (_st(self.ctx).tp_size if _st(self.ctx).enable_sequence_parallel else 1)
        # lookup write + bwd scatter-add read/write of fp32 grad
        return {"fwd": 2 * full, "bwd_w": 2 * full + self.inputs[0].bytes}

    def activation_info(self) -> ActivationInfo:
        fsdp = _fsdp_temp(self, self.numel)
        return ActivationInfo(
            cache_bytes=self.inputs[0].numel() * 4,  # ids
            fwd_temp_bytes=fsdp,
            bwd_temp_bytes=fsdp + _zero_grad_temp(self, self.numel),
        )

    def extra_param_info(self):
        return self.make_param_info(self.numel)

    def collectives(self) -> List[CollectiveCall]:
        st = _st(self.ctx)
        calls = _fsdp_calls(self, self.numel)
        if st.tp_size == 1:
            return calls
        out = self.outputs[0]
        full = out.bytes * (st.tp_size if st.enable_sequence_parallel else 1)
        if st.enable_sequence_parallel:
            calls.append(CollectiveCall("fwd", "reduce_scatter", "tp", full, "post"))
            calls.append(CollectiveCall("bwd_w", "all_gather", "tp", full, "pre"))
        else:
            calls.append(CollectiveCall("fwd", "all_reduce", "tp", full, "post"))
        return calls


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


class LayerNorm(LeafModule):
    """RMS/LayerNorm (reference ``dense_module.py:784-995``): memory-bound,
    caches its input; weight is dense state."""

    op_category = "norm"

    def __init__(self, ctx, hidden=None, name="norm"):
        super().__init__(ctx, name)
        self.hidden = hidden or ctx.model.hidden_size

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        return x

    def op_flops(self) -> Dict[str, float]:
        n = self.inputs[0].numel()
        return {"fwd": 4 * n, "bwd_act": 8 * n}

    def op_accessed(self) -> Dict[str, float]:
        nb = self.inputs[0].bytes
        fused = _st(self.ctx).use_fused_norm
        return {
            "fwd": (2 if fused else 3) * nb,
            "bwd_act": (3 if fused else 4) * nb,
            "bwd_w": nb,  # weight-grad reduction pass
        }

    def activation_info(self) -> ActivationInfo:
        nb = self.inputs[0].bytes
        rows = self.inputs[0].numel() / self.hidden
        return ActivationInfo(cache_bytes=nb + rows * 4)  # input + rstd

    def extra_param_info(self):
        return self.make_param_info(self.hidden)


# --------------------------------------------------------------------------
# Linear layers
# --------------------------------------------------------------------------


def _fsdp_calls(leaf, numel, is_moe=False):
    """ZeRO-3/FSDP per-layer weight collectives: all-gather the shard
    before fwd and again before the wgrad, reduce-scatter the grads
    right after bwd (per microbatch)."""
    st = leaf.ctx.strategy
    if st.zero_state < 3 or numel <= 0:
        return []
    dim = "edp" if is_moe else "dp_cp"
    group = st.edp_size if is_moe else st.dp_size * st.cp_size
    if group <= 1:
        return []
    w_bytes = numel * st.element_size
    g_bytes = numel * st.grad_element_size
    # FSDP prefetches gathers under compute; the excess beyond the
    # block's compute budget is re-exposed by LLMBlock._post_forward
    return [
        CollectiveCall("fwd", "all_gather", dim, w_bytes, "pre",
                       exposed=False),
        CollectiveCall("bwd_act", "all_gather", dim, w_bytes, "pre",
                       exposed=False),
        CollectiveCall("bwd_w", "reduce_scatter", dim, g_bytes, "post",
                       exposed=False),
    ]


def _fsdp_temp(leaf, numel, is_moe=False):
    """Transient full (gathered) weight bytes while the op runs."""
    st = leaf.ctx.strategy
    if st.zero_state < 3 or numel <= 0:
        return 0.0
    group = st.edp_size if is_moe else st.dp_size * st.cp_size
    if group <= 1:
        return 0.0
    return numel * st.element_size * (1 - 1 / group)


def _zero_grad_temp(leaf, numel, is_moe=False):
    """ZeRO>=2: the full-size layer gradient exists between the wgrad
    and its reduce-scatter; only the shard survives."""
    st = leaf.ctx.strategy
    if st.zero_state < 2 or numel <= 0:
        return 0.0
    group = st.edp_size if is_moe else st.dp_size * st.cp_size
    if group <= 1:
        return 0.0
    return numel * st.grad_element_size * (1 - 1 / group)


class LinearCol(GemmBase):
    """Column-parallel linear (reference ``dense_module.py:195-509``).

    Under SP: fwd all-gather of the seq-sharded input, bwd-act
    reduce-scatter of the input grad, bwd-w re-all-gather of the input for
    the wgrad GEMM. Without SP (tp>1): bwd-act all-reduce.
    """

    def __init__(self, ctx, in_features, out_features, name="linear_col",
                 quantized=False, skip_comm=False, replicated=False,
                 count_params=True):
        super().__init__(ctx, name, quantized=quantized)
        st = _st(ctx)
        self.in_features = in_features
        self.out_features = out_features
        # replicated: weight duplicated on every TP rank, rows stay
        # seq-sharded, no collectives (MLA down-projections)
        self.replicated = replicated
        self.out_local = out_features // (1 if replicated else st.tp_size)
        self.numel = in_features * self.out_local
        self.skip_comm = skip_comm or replicated
        # tied-weight layers (lm_head sharing the embedding) compute but
        # do not own parameters
        self.count_params = count_params

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        st = _st(self.ctx)
        b, s, k = x.shape
        assert k == self.in_features, (k, self.in_features, self.name)
        if st.enable_sequence_parallel and st.tp_size > 1 and not self.skip_comm:
            s = s * st.tp_size  # gathered inside the TP region
        return TensorSpec((b, s, self.out_local), st.dtype)

    def gemm_mnk(self, phase: str):
        out = self.outputs[0]
        m = out.shape[0] * out.shape[1]
        k, n = self.in_features, self.out_local
        if phase == "fwd":
            return (1, m, k, n)
        if phase == "bwd_act":
            return (1, m, n, k)
        return (1, k, m, n)

    def op_flops(self) -> Dict[str, float]:
        _, m, k, n = self.gemm_mnk("fwd")
        f = 2.0 * m * k * n
        return {"fwd": f, "bwd_act": f, "bwd_w": f}

    def op_accessed(self) -> Dict[str, float]:
        st = _st(self.ctx)
        e = st.element_size
        _, m, k, n = self.gemm_mnk("fwd")
        io = (m * k + k * n + m * n) * e
        wgrad_extra = k * n * (st.grad_element_size - e)  # fp32 accum out
        return {
            "fwd": io + self.quant_cast_bytes("fwd"),
            "bwd_act": io + self.quant_cast_bytes("bwd_act"),
            "bwd_w": io + wgrad_extra + self.quant_cast_bytes("bwd_w"),
        }

    def activation_info(self) -> ActivationInfo:
        st = _st(self.ctx)
        # cache the *pre-gather* input under SP (re-gathered for wgrad)
        cached = self.inputs[0].bytes
        temp = 0.0
        if st.enable_sequence_parallel and st.tp_size > 1 and not self.skip_comm:
            temp = cached * st.tp_size  # gathered copy live during compute
        n = self.numel if self.count_params else 0
        fsdp = _fsdp_temp(self, n)
        return ActivationInfo(
            cache_bytes=cached,
            fwd_temp_bytes=temp + fsdp,
            bwd_temp_bytes=temp + fsdp + _zero_grad_temp(self, n),
        )

    def extra_param_info(self):
        if not self.count_params:
            return self.make_param_info(0)
        return self.make_param_info(self.numel)

    def collectives(self) -> List[CollectiveCall]:
        st = _st(self.ctx)
        calls = _fsdp_calls(self, self.numel if self.count_params else 0)
        if st.tp_size == 1 or self.skip_comm:
            return calls
        _, m, k, _ = self.gemm_mnk("fwd")
        full_in = m * k * st.element_size
        if st.enable_sequence_parallel:
            return calls + [
                CollectiveCall("fwd", "all_gather", "tp", full_in, "pre"),
                CollectiveCall("bwd_act", "reduce_scatter", "tp", full_in, "post"),
                CollectiveCall("bwd_w", "all_gather", "tp", full_in, "pre"),
            ]
        return calls + [
            CollectiveCall("bwd_act", "all_reduce", "tp", full_in, "post")
        ]


class LinearRow(GemmBase):
    """Row-parallel linear (reference ``dense_module.py:511-783``):
    fwd reduce-scatter (SP) / all-reduce (TP); bwd-act all-gather under SP.
    """

    def __init__(self, ctx, in_features, out_features, name="linear_row",
                 quantized=False, skip_comm=False):
        super().__init__(ctx, name, quantized=quantized)
        st = _st(ctx)
        self.in_features = in_features
        self.out_features = out_features
        self.in_local = in_features // st.tp_size
        self.numel = self.in_local * out_features
        self.skip_comm = skip_comm

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        st = _st(self.ctx)
        b, s, k = x.shape
        assert k == self.in_local, (k, self.in_local, self.name)
        if st.enable_sequence_parallel and st.tp_size > 1 and not self.skip_comm:
            s = s // st.tp_size  # scattered back to seq shards
        return TensorSpec((b, s, self.out_features), st.dtype)

    def gemm_mnk(self, phase: str):
        x = self.inputs[0]
        m = x.shape[0] * x.shape[1]
        k, n = self.in_local, self.out_features
        if phase == "fwd":
            return (1, m, k, n)
        if phase == "bwd_act":
            return (1, m, n, k)
        return (1, k, m, n)

    def op_flops(self) -> Dict[str, float]:
        _, m, k, n = self.gemm_mnk("fwd")
        f = 2.0 * m * k * n
        return {"fwd": f, "bwd_act": f, "bwd_w": f}

    def op_accessed(self) -> Dict[str, float]:
        st = _st(self.ctx)
        e = st.element_size
        _, m, k, n = self.gemm_mnk("fwd")
        io = (m * k + k * n + m * n) * e
        wgrad_extra = k * n * (st.grad_element_size - e)  # fp32 accum out
        return {
            "fwd": io + self.quant_cast_bytes("fwd"),
            "bwd_act": io + self.quant_cast_bytes("bwd_act"),
            "bwd_w": io + wgrad_extra + self.quant_cast_bytes("bwd_w"),
        }

    def activation_info(self) -> ActivationInfo:
        fsdp = _fsdp_temp(self, self.numel)
        return ActivationInfo(
            cache_bytes=self.inputs[0].bytes,
            fwd_temp_bytes=fsdp,
            bwd_temp_bytes=fsdp + _zero_grad_temp(self, self.numel),
        )

    def extra_param_info(self):
        return self.make_param_info(self.numel)

    def collectives(self) -> List[CollectiveCall]:
        st = _st(self.ctx)
        calls = _fsdp_calls(self, self.numel)
        if st.tp_size == 1 or self.skip_comm:
            return calls
        _, m, _, n = self.gemm_mnk("fwd")
        full_out = m * n * st.element_size
        if st.enable_sequence_parallel:
            return calls + [
                CollectiveCall("fwd", "reduce_scatter", "tp", full_out, "post"),
                CollectiveCall("bwd_act", "all_gather", "tp", full_out, "pre"),
            ]
        return calls + [
            CollectiveCall("fwd", "all_reduce", "tp", full_out, "post")
        ]


# --------------------------------------------------------------------------
# Attention core
# --------------------------------------------------------------------------


class RotaryEmbedding(LeafModule):
    """RoPE application to q,k: memory-bound (reference
    ``dense_module.py:1806-1873``)."""

    op_category = "rope"

    def forward_spec(self, q: TensorSpec, k: TensorSpec):
        return q, k

    def op_accessed(self) -> Dict[str, float]:
        nb = sum(t.bytes for t in self.inputs)
        return {"fwd": 2 * nb, "bwd_act": 2 * nb}


class CoreAttention(LeafModule):
    """Scaled-dot-product attention cost model (reference
    ``dense_module.py:1061-1604``): flash vs math paths, causal sparsity,
    GQA; CP handled by the enclosing :class:`Attention` via
    :class:`ContextParallelA2A` / KV all-gather (ring) wrappers.

    Inputs q,k,v are per-device: ``[b, sq, hl, d]`` / ``[b, skv, kvl, d]``.
    """

    op_category = "attention"

    def __init__(self, ctx, head_dim_v=None, name="core_attention"):
        super().__init__(ctx, name)
        self.head_dim_v = head_dim_v

    def forward_spec(self, q: TensorSpec, k: TensorSpec, v: TensorSpec):
        b, sq, hl, d = q.shape
        dv = v.shape[-1]
        return TensorSpec((b, sq, hl, dv), q.dtype)

    def _dims(self):
        q, k, v = self.inputs
        b, sq, hl, d = q.shape
        skv = k.shape[1]
        dv = v.shape[-1]
        return b, sq, skv, hl, d, dv

    def _causal(self) -> bool:
        return bool(self.ctx.model.use_causal_attention)

    def op_flops(self) -> Dict[str, float]:
        st = _st(self.ctx)
        b, sq, skv, hl, d, dv = self._dims()
        # causal masking skips this fraction; full attention skips none
        sparse = st.attention_sparse_ratio if self._causal() else 0.0
        qk = 2.0 * b * hl * sq * skv * d
        pv = 2.0 * b * hl * sq * skv * dv
        fwd = (qk + pv) * (1.0 - sparse)
        bwd = 2.5 * fwd if st.use_flash_sdp else 2.0 * fwd
        return {"fwd": fwd, "bwd_act": bwd}

    def op_accessed(self) -> Dict[str, float]:
        st = _st(self.ctx)
        b, sq, skv, hl, d, dv = self._dims()
        e = st.element_size
        kvl = self.inputs[1].shape[2]
        qo = b * sq * hl * (d + dv) * e
        kv = b * skv * kvl * (d + dv) * e
        lse = b * hl * sq * 4
        if st.use_flash_sdp:
            return {"fwd": qo + kv + lse, "bwd_act": 2 * (qo + kv) + lse}
        # math path materializes the fp32 score/probs matrices (XLA
        # computes softmax in fp32 — see docs/memory_validation.md)
        score = b * hl * sq * skv * 4.0
        return {"fwd": qo + kv + 2 * score, "bwd_act": 2 * (qo + kv) + 4 * score}

    @staticmethod
    def render_sdp_shape_key(b, sq, skv, hn, kv_hn, hd, hd_v, causal,
                             flash, dtype, backend="torch") -> str:
        """Canonical sdp efficiency-table key — static single source
        shared with the batched sweep kernel (``search/batched.py``)."""
        prefix = "" if backend == "torch" else f"backend={backend}, "
        return (
            f"{prefix}b={b}, sq={sq}, skv={skv}, hn={hn}, kv_hn={kv_hn}, "
            f"hd={hd}, hd_v={hd_v}, causal={causal}, "
            f"flash={flash}, dtype={dtype}"
        )

    def comp_key(self, phase):
        st = _st(self.ctx)
        b, sq, skv, hl, d, dv = self._dims()
        kvl = self.inputs[1].shape[2]
        key = self.render_sdp_shape_key(
            b, sq, skv, hl, kvl, d, dv, self._causal(),
            st.use_flash_sdp, st.dtype, backend=st.sdp_backend,
        )
        return ("sdp_fwd" if phase == "fwd" else "sdp_bwd", key)

    def activation_info(self) -> ActivationInfo:
        st = _st(self.ctx)
        b, sq, skv, hl, d, dv = self._dims()
        e = st.element_size
        kvl = self.inputs[1].shape[2]
        lse = b * hl * sq * 4
        if st.use_flash_sdp:
            # flash caches q,k,v,o,lse
            cache = (
                b * sq * hl * d * e
                + b * skv * kvl * (d + dv) * e
                + b * sq * hl * dv * e
                + lse
            )
            return ActivationInfo(cache_bytes=cache)
        # math (XLA composite) path: softmax runs in fp32; the fp32
        # probs are cached for the backward (the pre-softmax scores fuse
        # into the probs buffer). The backward ADDITIONALLY materializes
        # dP = dO @ V^T — a matmul output in the model dtype — while the
        # cached probs are still live; the fp32 dS chain then fuses into
        # the dq/dk/dv matmul operand reads, so exactly one extra score
        # matrix is transient (anchored against TPU
        # compiled.memory_analysis() across seq/layers/remat,
        # docs/memory_validation.md: omitting it underpredicted the
        # 8192-seq remat case by 18%)
        probs_f32 = b * hl * sq * skv * 4.0
        cache = (
            b * sq * hl * d * e
            + b * skv * kvl * (d + dv) * e
            + probs_f32
        )
        return ActivationInfo(
            cache_bytes=cache,
            bwd_temp_bytes=b * hl * sq * skv * e,
        )

    def bw_key(self, phase):
        return "default"


class ContextParallelA2A(LeafModule):
    """One Ulysses-style CP all-to-all stage: re-shard ``[b, s/cp, H, d]``
    (seq-sharded) <-> ``[b, s, H/cp, d]`` (head-sharded) over the cp axis
    (reference ``_get_cp_a2a_stage_specs`` dense_module.py:1158-1186).

    ``direction='scatter_heads'`` gathers sequence / scatters heads (the
    pre-attention direction); 'gather_seq' is the inverse. The backward of
    each is the opposite a2a with the same volume, so fwd/bwd sizes match.
    """

    op_category = "comm"

    def __init__(self, ctx, direction="scatter_heads", name="cp_a2a"):
        super().__init__(ctx, name)
        self.direction = direction

    def _replication(self, h: int) -> int:
        """GQA with fewer (kv) heads than cp ranks: real Ulysses
        replicates the heads to ``cp`` before the a2a so every rank owns
        one; the a2a then moves the replicated volume. (Without this the
        k/v shard would round to zero heads and the KV cache/comm would
        be modeled as free.)"""
        cp = _st(self.ctx).cp_size
        if self.direction != "scatter_heads":
            return 1
        if h >= cp:
            _require(
                h % cp == 0,
                f"{h} local (kv) heads not divisible by cp_size {cp}",
            )
            return 1
        _require(
            cp % h == 0,
            f"cp_size {cp} not a multiple of the {h} local kv heads",
        )
        return cp // h

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        cp = _st(self.ctx).cp_size
        b, s, h, d = x.shape
        if self.direction == "scatter_heads":
            r = self._replication(h)
            return x.with_shape(b, s * cp, (h * r) // cp, d)
        return x.with_shape(b, s // cp, h * cp, d)

    def collectives(self) -> List[CollectiveCall]:
        st = _st(self.ctx)
        if st.cp_size == 1:
            return []
        # full logical tensor = per-chip shard * cp (net-op contract);
        # kv-head replication inflates the moved volume accordingly
        r = self._replication(self.inputs[0].shape[2])
        nbytes = self.inputs[0].bytes * r * st.cp_size
        exposed = st.cp_a2a_mode == "sync_cp"
        return [
            CollectiveCall("fwd", "all2all", "cp", nbytes, "pre", exposed=exposed),
            CollectiveCall("bwd_act", "all2all", "cp", nbytes, "post", exposed=exposed),
        ]

    def activation_info(self) -> ActivationInfo:
        # the re-sharded copy is a transient; source freed after a2a
        r = self._replication(self.inputs[0].shape[2])
        return ActivationInfo(fwd_temp_bytes=self.inputs[0].bytes * r)




# --------------------------------------------------------------------------
# Activations / losses
# --------------------------------------------------------------------------


class Dropout(LeafModule):
    """Hidden dropout: memory-bound elementwise with a cached 1-byte
    mask per element for the backward. (The reference warns and ignores
    ``enable_dropout`` — config.py:678-681; modeled fully here:
    embedding-output + both residual-branch sites, the standard
    Megatron recipe.)"""

    op_category = "elementwise"

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        return x

    def op_accessed(self) -> Dict[str, float]:
        nb = self.inputs[0].bytes
        mask = self.inputs[0].numel()
        return {"fwd": 2 * nb + mask, "bwd_act": 2 * nb + mask}

    def activation_info(self) -> ActivationInfo:
        return ActivationInfo(cache_bytes=self.inputs[0].numel())  # mask


class SeqAllGather(LeafModule):
    """Gather a seq-sharded tensor over a parallel dim (fwd all-gather,
    bwd-act reduce-scatter) — used for e.g. the MLA RoPE branch whose
    producer is a replicated linear outside the column-parallel gather."""

    op_category = "comm"

    def __init__(self, ctx, dim="tp", name="seq_allgather"):
        super().__init__(ctx, name)
        self.dim = dim

    def _group(self) -> int:
        return getattr(_st(self.ctx), f"{self.dim}_size")

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        g = self._group()
        return x.with_shape(x.shape[0], x.shape[1] * g, *x.shape[2:])

    def collectives(self) -> List[CollectiveCall]:
        if self._group() == 1:
            return []
        full = self.outputs[0].bytes
        return [
            CollectiveCall("fwd", "all_gather", self.dim, full, "pre"),
            CollectiveCall("bwd_act", "reduce_scatter", self.dim, full, "post"),
        ]

    def activation_info(self) -> ActivationInfo:
        return ActivationInfo(fwd_temp_bytes=self.outputs[0].bytes)


class KVAllGather(SeqAllGather):
    """CP ``all_gather`` (ring-attention family) KV gather: fwd all-gather
    of k or v over cp, bwd reduce-scatter of its grad. The reference only
    costs the net time and raises on flops (``dense_module.py:1521-1524``);
    here it is a complete op. The gathered copy also stays live through
    the attention backward (re-gathered), unlike the plain SeqAllGather."""

    def __init__(self, ctx, name="kv_allgather"):
        super().__init__(ctx, dim="cp", name=name)

    def activation_info(self) -> ActivationInfo:
        full = self.outputs[0].bytes
        return ActivationInfo(fwd_temp_bytes=full, bwd_temp_bytes=full)


class Swiglu(LeafModule):
    """SwiGLU activation (reference ``dense_module.py:1874-2096``):
    memory-bound; input is the concatenated ``[.., 2*f]`` projection.
    ``weighted`` fuses the router-prob multiply into the activation
    (reference ``is_weighted_silu``, the ``dispatch_probs`` MoE path):
    one extra per-token fp32 prob is read each phase and cached for the
    backward's dL/dprob term."""

    op_category = "activation"

    def __init__(self, ctx, name="swiglu", weighted: bool = False):
        super().__init__(ctx, name)
        self.weighted = weighted

    def _probs_bytes(self) -> float:
        if not self.weighted:
            return 0.0
        b, s, _ = self.outputs[0].shape
        return b * s * 4.0  # one fp32 prob per routed token copy

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        return x.split_dim(-1, 2)

    def op_accessed(self) -> Dict[str, float]:
        i, o = self.inputs[0].bytes, self.outputs[0].bytes
        p = self._probs_bytes()
        return {"fwd": i + o + p, "bwd_act": 2 * i + o + p}

    def activation_info(self) -> ActivationInfo:
        return ActivationInfo(
            cache_bytes=self.inputs[0].bytes + self._probs_bytes()
        )


class Gelu(LeafModule):
    op_category = "activation"

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        return x

    def op_accessed(self) -> Dict[str, float]:
        n = self.inputs[0].bytes
        return {"fwd": 2 * n, "bwd_act": 3 * n}

    def activation_info(self) -> ActivationInfo:
        return ActivationInfo(cache_bytes=self.inputs[0].bytes)


class ParallelCE(LeafModule):
    """Vocab-parallel cross-entropy (reference ``dense_module.py:2097-2363``):
    three TP all-reduces of ``[b, s]`` fp32 scalars (max, predicted logit,
    sum-exp); the fused variant batches two into one collective and keeps
    only the bf16 logits cached."""

    op_category = "loss"

    def forward_spec(self, logits: TensorSpec) -> TensorSpec:
        b, s, v = logits.shape
        return TensorSpec((b, s), "fp32")

    def op_accessed(self) -> Dict[str, float]:
        st = _st(self.ctx)
        lg = self.inputs[0].bytes
        # Under jit, XLA fuses the log-softmax + target-gather: the fp32
        # log-probs are never materialized (the elementwise x - lse
        # fuses into the gather), so both variants stream the bf16
        # logits — fwd two reduction passes, bwd read-logits +
        # write-dlogits (anchored: the fp32-probs model overpredicted
        # the CE-peaked rows of docs/memory_validation.md by ~10%).
        return {"fwd": 2 * lg, "bwd_act": 2 * lg}

    def bw_key(self, phase):
        return "ce_fusion" if _st(self.ctx).use_fused_ce else "ce"

    def activation_info(self) -> ActivationInfo:
        st = _st(self.ctx)
        b, s, _ = self.inputs[0].shape
        # bf16 logits + the fp32 log-sum-exp row vector; no fp32 probs
        # materialization on the XLA path (see op_accessed)
        return ActivationInfo(
            cache_bytes=self.inputs[0].bytes + b * s * 4.0
        )

    def collectives(self) -> List[CollectiveCall]:
        st = _st(self.ctx)
        if st.tp_size == 1:
            return []
        b, s, _ = self.inputs[0].shape
        scalar = b * s * 4.0
        ncalls = 2 if st.use_fused_ce else 3
        return [
            CollectiveCall("fwd", "all_reduce", "tp", scalar, "post")
            for _ in range(ncalls)
        ]


# --------------------------------------------------------------------------
# Composites
# --------------------------------------------------------------------------


def bound_async_cp_overlap(attention: MetaModule):
    """Async CP can hide its a2a only under the attention-core compute;
    the excess goes back onto the critical path (shared by Attention and
    MLAAttention _post_forward hooks)."""
    st = _st(attention.ctx)
    if not (st.cp_size > 1 and st.cp_comm_type == "a2a"
            and st.cp_a2a_mode == "async_cp"):
        return
    cp_leaves = [
        c for c in attention.children() if isinstance(c, ContextParallelA2A)
    ]
    for phase in ("fwd", "bwd_act"):
        budget = attention.core.cost_info.compute.get(phase)
        attention.expose_unhidden(cp_leaves, phase, budget)


class Attention(MetaModule):
    """GQA/MHA attention (reference ``dense_module.py:2454-2568``):
    LinearCol(qkv) -> split -> RoPE -> [CP re-shard] -> CoreAttention ->
    [CP re-shard back] -> LinearRow(out)."""

    def __init__(self, ctx, name="attention", quantized=False):
        super().__init__(ctx, name)
        m, st = ctx.model, ctx.strategy
        self.hd = m.head_size
        self.q_out = m.head_num * m.head_size
        self.kv_out = m.kv_head_num * m.head_size
        self.qkv_proj = LinearCol(
            ctx, m.hidden_size, self.q_out + 2 * self.kv_out, "qkv_proj",
            quantized=quantized,
        )
        self.rope = RotaryEmbedding(ctx, name="rope")
        if st.cp_size > 1 and st.cp_comm_type == "a2a":
            self.cp_q = ContextParallelA2A(ctx, "scatter_heads", "cp_a2a_q")
            self.cp_k = ContextParallelA2A(ctx, "scatter_heads", "cp_a2a_k")
            self.cp_v = ContextParallelA2A(ctx, "scatter_heads", "cp_a2a_v")
            self.cp_o = ContextParallelA2A(ctx, "gather_seq", "cp_a2a_o")
        elif st.cp_size > 1 and st.cp_comm_type == "all_gather":
            self.kv_gather_k = KVAllGather(ctx, name="kv_allgather_k")
            self.kv_gather_v = KVAllGather(ctx, name="kv_allgather_v")
        self.core = CoreAttention(ctx, name="core_attention")
        self.out_proj = LinearRow(
            ctx, self.q_out, m.hidden_size, "out_proj", quantized=quantized
        )

    def _post_forward(self):
        bound_async_cp_overlap(self)

    def forward(self, x: TensorSpec) -> TensorSpec:
        st = _st(self.ctx)
        m = self.ctx.model
        qkv = self.qkv_proj(x)
        b, s, _ = qkv.shape
        tp = st.tp_size
        hl = m.head_num // tp
        kvl = max(m.kv_head_num // tp, 1)
        q = qkv.with_shape(b, s, hl, self.hd)
        k = qkv.with_shape(b, s, kvl, self.hd)
        v = qkv.with_shape(b, s, kvl, self.hd)
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


class MLP(MetaModule):
    """Dense MLP (reference ``dense_module.py:2888-2988``)."""

    def __init__(self, ctx, ffn=None, name="mlp", quantized=False,
                 tp_override=None):
        super().__init__(ctx, name)
        m = ctx.model
        self.ffn = ffn or m.intermediate_size
        fan = 2 * self.ffn if m.use_swiglu else self.ffn
        self.up_proj = LinearCol(ctx, m.hidden_size, fan, "up_proj",
                                 quantized=quantized)
        self.act = Swiglu(ctx, name="swiglu") if m.use_swiglu else Gelu(ctx, name="gelu")
        self.down_proj = LinearRow(ctx, self.ffn, m.hidden_size, "down_proj",
                                   quantized=quantized)

    def forward(self, x: TensorSpec) -> TensorSpec:
        return self.down_proj(self.act(self.up_proj(x)))

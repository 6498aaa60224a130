"""MoE analytical ops (L3).

Reference: ``simumax/core/transformer/moe_module.py`` (Router:20,
Permutation:214, UnPermutation:531, GroupLinearCol/Row:835,
ExpertMLP:1370).

TPU notes: the EP dispatch/combine is an all-to-all over the ``ep``
CommPath (which the mesh placement lays across ICI axes, giving the 2D
torus its bisection advantage; cross-slice EP lands on DCN
automatically). Permute/unpermute kernels are memory-bound with their
own HBM-bandwidth classes (``permute_fwd``/``permute_bwd``), matching
the reference's calibration keys.

Token accounting (balanced-routing / dropless assumption, per device,
per microbatch): pre-dispatch tokens ``T0 = b * s_sp``; post-dispatch
``T1 = T0 * topk * cap`` where ``cap`` is the optional capacity factor.

Copy of the JAX package's ``models/moe.py``; only its import paths
changed.
"""

from __future__ import annotations

from typing import Dict, List

from simumax_tpu_torch.core.module import BuildContext, GemmBase, LeafModule, MetaModule
from simumax_tpu_torch.core.records import ActivationInfo, CollectiveCall
from simumax_tpu_torch.core.tensor import TensorSpec
from simumax_tpu_torch.models.dense import (
    MLP,
    AddFunction,
    Swiglu,
    _fsdp_calls,
    _fsdp_temp,
    _zero_grad_temp,
    _st,
)


def _tokens_post_dispatch(ctx: BuildContext, t0: int) -> int:
    st = _st(ctx)
    cap = st.moe_capacity_factor or 1.0
    return int(t0 * ctx.model.topk * cap)


class Router(LeafModule):
    """MoE gating (reference ``moe_module.py:20-213``): replicated linear
    ``h -> E`` + top-k; logits/probs kept fp32."""

    op_category = "router"

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        b, s, h = x.shape
        return TensorSpec((b, s, self.ctx.model.expert_num), "fp32")

    def op_flops(self) -> Dict[str, float]:
        b, s, h = self.inputs[0].shape
        f = 2.0 * b * s * h * self.ctx.model.expert_num
        return {"fwd": f, "bwd_act": f, "bwd_w": f}

    def op_accessed(self) -> Dict[str, float]:
        i, o = self.inputs[0].bytes, self.outputs[0].bytes
        # logits -> softmax -> topk passes
        return {"fwd": i + 3 * o, "bwd_act": i + 3 * o, "bwd_w": i + o}

    def activation_info(self) -> ActivationInfo:
        m = self.ctx.model
        b, s, _ = self.inputs[0].shape
        probs = b * s * m.topk * 4
        return ActivationInfo(
            cache_bytes=self.inputs[0].bytes + self.outputs[0].bytes + probs
        )

    def extra_param_info(self):
        return self.make_param_info(
            self.ctx.model.hidden_size * self.ctx.model.expert_num
        )


class Permutation(LeafModule):
    """Token dispatch (reference ``moe_module.py:214-530``): permute to
    expert order (memory-bound, ``permute_fwd`` bandwidth class) + EP
    all-to-all; ETP all-gather when experts are tensor-parallel with SP.
    """

    op_category = "moe_dispatch"

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        st = _st(self.ctx)
        b, s, h = x.shape
        t1 = _tokens_post_dispatch(self.ctx, b * s)
        # etp seq-gather factor: expert region gathers over etp like SP
        if st.etp_size > 1 and st.enable_sequence_parallel:
            t1 *= st.etp_size
        return TensorSpec((1, t1, h), x.dtype)

    def op_accessed(self) -> Dict[str, float]:
        o = self.outputs[0].bytes
        return {"fwd": 2 * o, "bwd_act": 2 * o}

    def bw_key(self, phase):
        return "permute_fwd" if phase == "fwd" else "permute_bwd"

    def activation_info(self) -> ActivationInfo:
        b, s, h = self.inputs[0].shape
        idx = b * s * self.ctx.model.topk * 4  # routing map
        # permuted copy is consumed by the expert GEMM which caches it;
        # dispatch itself keeps only the routing indices
        return ActivationInfo(cache_bytes=idx,
                              fwd_temp_bytes=self.outputs[0].bytes)

    def collectives(self) -> List[CollectiveCall]:
        st = _st(self.ctx)
        calls = []
        permuted = self.outputs[0].bytes
        if st.etp_size > 1 and st.enable_sequence_parallel:
            pre_etp = permuted / st.etp_size
            calls.append(
                CollectiveCall("fwd", "all_gather", "etp", permuted, "pre")
            )
            calls.append(
                CollectiveCall("bwd_act", "reduce_scatter", "etp", permuted, "post")
            )
            permuted = pre_etp  # a2a happens on the pre-gather tokens
        if st.ep_size > 1:
            full = permuted * st.ep_size  # full logical tensor contract
            calls.append(CollectiveCall("fwd", "all2all", "ep", full, "pre"))
            calls.append(CollectiveCall("bwd_act", "all2all", "ep", full, "post"))
            if st.dispatch_probs:
                # router probs ride their own a2a to the experts
                # (reference ``moe_module.py:407-424``)
                b, s, _ = self.inputs[0].shape
                probs_full = b * s * self.ctx.model.topk * 4 * st.ep_size
                calls.append(
                    CollectiveCall("fwd", "all2all", "ep", probs_full, "pre")
                )
                calls.append(
                    CollectiveCall("bwd_act", "all2all", "ep", probs_full,
                                   "post")
                )
        return calls


class UnPermutation(LeafModule):
    """Token combine (reference ``moe_module.py:531-834``): inverse EP
    all-to-all + weighted unpermute back to the original order."""

    op_category = "moe_dispatch"

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        st = _st(self.ctx)
        b = st.micro_batch_size
        s_cp = st.seq_len // st.cp_size
        s_sp = s_cp // st.tp_size if st.enable_sequence_parallel else s_cp
        return TensorSpec((b, s_sp, self.ctx.model.hidden_size), x.dtype)

    def op_accessed(self) -> Dict[str, float]:
        i, o = self.inputs[0].bytes, self.outputs[0].bytes
        m = self.ctx.model
        # weighted sum over topk copies + probs read
        return {"fwd": i + o, "bwd_act": i + o}

    def bw_key(self, phase):
        return "permute_fwd" if phase == "fwd" else "permute_bwd"

    def activation_info(self) -> ActivationInfo:
        if _st(self.ctx).dispatch_probs:
            # weighting already happened inside the expert activation:
            # the combine is a pure layout op — nothing cached, just the
            # in/out copies live at once (reference
            # ``moe_module.py:737-746``)
            return ActivationInfo(
                fwd_temp_bytes=max(self.inputs[0].bytes,
                                   self.outputs[0].bytes)
            )
        # cache the pre-combine expert outputs (for grad w.r.t. probs)
        return ActivationInfo(cache_bytes=self.inputs[0].bytes)

    def collectives(self) -> List[CollectiveCall]:
        st = _st(self.ctx)
        calls = []
        permuted = self.inputs[0].bytes
        if st.etp_size > 1 and st.enable_sequence_parallel:
            permuted = permuted / st.etp_size
            calls.append(
                CollectiveCall("fwd", "reduce_scatter", "etp",
                               self.inputs[0].bytes, "pre")
            )
            calls.append(
                CollectiveCall("bwd_act", "all_gather", "etp",
                               self.inputs[0].bytes, "post")
            )
        if st.ep_size > 1:
            full = permuted * st.ep_size
            calls.append(CollectiveCall("fwd", "all2all", "ep", full, "pre"))
            calls.append(CollectiveCall("bwd_act", "all2all", "ep", full, "post"))
        return calls


class GroupLinearBase(GemmBase):
    """Grouped-GEMM bookkeeping (reference ``GroupLinearBase``
    base_struct.py:1188-1204 + ``moe_module.py:835-1289``): ng local
    experts, canonical ``ng=,M=,N=,K=,...`` efficiency keys."""

    def __init__(self, ctx, in_features, out_features, name, quantized=False):
        super().__init__(ctx, name, quantized=quantized)
        st = _st(ctx)
        m = ctx.model
        self.ng = m.expert_num // st.ep_size
        self.in_features = in_features
        self.out_features = out_features
        self.numel = self.ng * in_features * out_features

    @property
    def sequential(self) -> bool:
        """``group_linear_mode="sequential"``: per-expert GEMMs (a
        ``lax.scan`` of dense matmuls on TPU) instead of one grouped
        kernel — costed off the ``matmul`` table at batch=ng with the
        smaller per-expert m, which is where the mode's MXU
        under-utilisation shows up."""
        return _st(self.ctx).group_linear_mode == "sequential"

    @property
    def matmul_op_key(self) -> str:
        kind = "matmul" if self.sequential else "group_matmul"
        if self.quantized:
            return f"{self.ctx.strategy.quant_dtype}_{kind}"
        return kind

    def gemm_mnk(self, phase: str):
        tokens = self._tokens()
        if self.sequential:
            tokens = max(tokens // self.ng, 1)  # per-expert share
        k, n = self.in_features, self.out_features
        if phase == "fwd":
            return (self.ng, tokens, k, n)
        if phase == "bwd_act":
            return (self.ng, tokens, n, k)
        return (self.ng, k, tokens, n)

    @staticmethod
    def render_group_shape_key(ng, m, k, n, phase, dtype,
                               fp32_accum) -> str:
        """Canonical grouped-GEMM efficiency-table key — static single
        source shared with the batched sweep kernel
        (``search/batched.py``)."""
        acc = phase == "bwd_w" and fp32_accum
        return (
            f"ng={ng}, M={m}, N={n}, K={k}, dtype={dtype}, "
            f"stage={phase}, accumulate={acc}"
        )

    def gemm_shape_key(self, phase: str):
        if self.sequential:
            # dense-matmul grammar (batch=ng) so the matmul efficiency
            # table and its batched calibration path apply; gemm_mnk
            # already returns a (b, m, k, n)-compatible tuple
            return super().gemm_shape_key(phase)
        ng, m, k, n = self.gemm_mnk(phase)
        return self.render_group_shape_key(
            ng, m, k, n, phase, self.ctx.strategy.dtype,
            self.ctx.strategy.use_fp32_accum_grad,
        )

    def _tokens(self) -> int:
        return self.inputs[0].shape[0] * self.inputs[0].shape[1]

    def op_flops(self) -> Dict[str, float]:
        # totals over ALL experts — independent of the execution mode
        # (gemm_mnk's m is per-expert under group_linear_mode=sequential)
        tokens = self._tokens()
        k, n = self.in_features, self.out_features
        f = 2.0 * tokens * k * n
        return {"fwd": f, "bwd_act": f, "bwd_w": f}

    def op_accessed(self) -> Dict[str, float]:
        st = _st(self.ctx)
        e = st.element_size
        tokens = self._tokens()
        k, n = self.in_features, self.out_features
        io = (tokens * k + self.ng * k * n + tokens * n) * e
        wgrad_extra = self.ng * k * n * (st.grad_element_size - e)
        return {
            "fwd": io + self.quant_cast_bytes("fwd"),
            "bwd_act": io + self.quant_cast_bytes("bwd_act"),
            "bwd_w": io + wgrad_extra + self.quant_cast_bytes("bwd_w"),
        }

    def quant_cast_bytes(self, phase: str) -> float:
        # totals, not per-expert (see op_flops); phase-dependent like
        # GemmBase: bwd_act quantizes the output-grad (tokens x n)
        if not self.quantized:
            return 0.0
        e = _st(self.ctx).element_size
        width = (
            self.out_features if phase == "bwd_act" else self.in_features
        )
        return self._tokens() * width * (e + 1.0)

    def activation_info(self) -> ActivationInfo:
        fsdp = _fsdp_temp(self, self.numel, is_moe=True)
        return ActivationInfo(
            cache_bytes=self.inputs[0].bytes,
            fwd_temp_bytes=fsdp,
            bwd_temp_bytes=fsdp + _zero_grad_temp(self, self.numel,
                                                  is_moe=True),
        )

    def extra_param_info(self):
        return self.make_param_info(self.numel, is_moe=True)

    def collectives(self) -> List[CollectiveCall]:
        return _fsdp_calls(self, self.numel, is_moe=True)


class GroupLinearCol(GroupLinearBase):
    def __init__(self, ctx, name="group_linear_col", quantized=False):
        m, st = ctx.model, ctx.strategy
        fan = 2 * m.moe_ffn_hidden_size if m.use_swiglu else m.moe_ffn_hidden_size
        super().__init__(
            ctx, m.hidden_size, fan // st.etp_size, name, quantized=quantized
        )

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        return x.with_shape(x.shape[0], x.shape[1], self.out_features)

    def activation_info(self) -> ActivationInfo:
        info = super().activation_info()
        if (_st(self.ctx).offload_groupgemm_col_inputs
                and not self.in_recompute):
            # dispatched-token inputs live on the host (reference
            # ``moe_module.py:962-979``): no HBM cache; the backward
            # re-uploads them as a transient next to the grads. Inside a
            # recompute segment the replay regenerates the input in HBM,
            # so there is nothing to offload (full-block recompute is
            # rejected at sanity; selective mlp recompute lands here).
            info.bwd_temp_bytes += info.cache_bytes
            info.cache_bytes = 0.0
        return info


class GroupLinearRow(GroupLinearBase):
    def __init__(self, ctx, name="group_linear_row", quantized=False):
        m, st = ctx.model, ctx.strategy
        super().__init__(
            ctx,
            m.moe_ffn_hidden_size // st.etp_size,
            m.hidden_size,
            name,
            quantized=quantized,
        )

    def forward_spec(self, x: TensorSpec) -> TensorSpec:
        assert x.shape[-1] == self.in_features, (x.shape, self.in_features)
        return x.with_shape(x.shape[0], x.shape[1], self.out_features)


class ExpertMLP(MetaModule):
    """Full MoE layer (reference ``moe_module.py:1370-1566``):
    shared-expert MLP + Router -> Permutation -> GroupLinearCol ->
    Swiglu -> GroupLinearRow -> UnPermutation (+ residual add of the
    shared-expert branch)."""

    def __init__(self, ctx, name="expert_mlp", quantized=False):
        super().__init__(ctx, name)
        m = ctx.model
        self.router = Router(ctx, name="router")
        self.permutation = Permutation(ctx, name="dispatch")
        self.experts_up = GroupLinearCol(ctx, quantized=quantized)
        if m.use_swiglu:
            self.act = Swiglu(ctx, name="expert_swiglu",
                              weighted=ctx.strategy.dispatch_probs)
        else:
            from simumax_tpu_torch.models.dense import Gelu

            self.act = Gelu(ctx, name="expert_gelu")
        self.experts_down = GroupLinearRow(ctx, quantized=quantized)
        self.unpermutation = UnPermutation(ctx, name="combine")
        self.has_shared = bool(m.moe_shared_expert_intermediate_size)
        if self.has_shared:
            self.shared_expert = MLP(
                ctx,
                ffn=m.moe_shared_expert_intermediate_size,
                name="shared_expert",
                quantized=quantized,
            )
            self.add_shared = AddFunction(ctx, name="add_shared")

    def forward(self, x: TensorSpec) -> TensorSpec:
        self.router(x)
        t = self.permutation(x)
        t = self.experts_up(t)
        t = self.act(t)
        t = self.experts_down(t)
        out = self.unpermutation(t)
        if self.has_shared:
            s = self.shared_expert(x)
            out = self.add_shared(out, s)
        return out

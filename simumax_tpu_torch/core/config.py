"""Config layer (L0): model / strategy / system configs + the TPU hardware
cost model.

Capability parity with the reference simulator's ``simumax/core/config.py``
(ModelConfig ``config.py:1041``, StrategyConfig ``config.py:209``,
SystemConfig ``config.py:695`` with the four cost primitives
``compute_op_accuracy_time/compute_mem_access_time/compute_net_op_time/
compute_end2end_time``), but the interconnect model is re-designed
TPU-first:

* instead of NCCL link classes (``low/high_intra_node``, ``pcie_*``,
  ``inter_node``) the system config describes an **ICI torus** (axes,
  per-link GB/s, wraparound) plus a **DCN** class for multi-slice;
* a collective is costed over a :class:`CommPath` — the list of torus-axis
  spans a parallel group occupies (computed from the mesh placement of the
  strategy), with hierarchical per-axis ring formulas in the style of the
  public TPU scaling literature, rather than per-link-class alpha-beta
  heuristics;
* the measured-efficiency override architecture
  (``accurate_efficient_factor`` tables keyed by canonical shape strings,
  hit/miss recording — reference ``config.py:815-861``) is kept unchanged:
  it is the accuracy workhorse, populated here by JAX microbenchmarks
  (see ``simumax_tpu_torch/calibration``).

All times are in **seconds**; bandwidths ``gbps`` are **GB/s** (1e9 bytes
per second); ``latency_us`` in microseconds.

Copy of the JAX package's ``core/config.py`` with these changes for the
CUDA port:

* ``StrategyConfig.sdp_backend`` takes ``"torch"`` (eager math
  attention) and ``"cuda"`` (the hand-written flash kernels) instead of
  ``"xla"`` and ``"pallas"``;
* ``SystemConfig.ici`` and ``SystemConfig.dcn`` are optional. A GPU
  system describes its network with ``SystemConfig.nvlink``
  (:class:`NvlinkConfig`, the NVSwitch domain of one node) and
  ``SystemConfig.ib`` (:class:`IbConfig`, one InfiniBand rail a GPU
  between nodes) instead; ``num_slices`` then counts nodes and
  :attr:`SystemConfig.chips_per_slice` is ``gpus_per_node``. A system
  with both ``ici`` and ``nvlink`` is a :class:`ConfigError`; a system
  with neither network is one card, and placing a group of more than
  one on it, or costing a collective, raises :class:`ConfigError`;
* :meth:`SystemConfig.place_group` on an NVSwitch system walks the node
  as one axis of ``gpus_per_node`` with the torus walk's rules for inner
  strides and misaligned placements, but a span inside the node is
  ``kind="nvlink"``, never wraps, and has the full ``link_gbps`` with no
  ``1/inner`` share (a switch has no intermediate chips, and every GPU's
  links are its own); what remains is one ``kind="ib"`` span at
  ``gbps_per_gpu``, unshared as well (each GPU has its own rail).
  :attr:`CommPath.on_dcn` is true for ``dcn`` and ``ib`` spans, and
  ``_op_spec`` picks the op table by span kind;
* :meth:`SystemConfig.compute_net_op_terms` costs ``all2all`` on an
  ``nvlink`` or ``ib`` span as ``local·(e−1)/e`` over the span's
  bandwidth plus one hop of latency (derived there) in place of the
  torus's bisection term; every other term, and every term on a torus,
  is the JAX package's;
* :meth:`SystemConfig.fingerprint` hashes the NVLink and IB rates where
  the system has them, as it hashes the ICI and DCN ones;
* ``AcceleratorSpec.backend`` defaults to ``"cuda"``;
* the registry reads this package's ``configs/`` first, then the
  repository's, and its override variable is
  ``SIMUMAX_TPU_TORCH_CONFIG_ROOT``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from simumax_tpu_torch.core.errors import ConfigError, UnknownConfigError

# --------------------------------------------------------------------------
# Constants / small helpers
# --------------------------------------------------------------------------

#: collective op vocabulary (reference ``config.py:27-33`` kNetOp)
NET_OPS = ("all_reduce", "all_gather", "reduce_scatter", "p2p", "all2all")

DTYPE_BYTES = {
    "fp32": 4,
    "tf32": 4,
    "bf16": 2,
    "fp16": 2,
    "fp8": 1,
    "int8": 1,
    "int4": 0.5,
    "int32": 4,
    "bool": 1,
}

GiB = 1024**3
MiB = 1024**2


def dtype_to_bytes(dtype: str) -> float:
    if dtype not in DTYPE_BYTES:
        raise ConfigError(f"unknown dtype {dtype!r}")
    return DTYPE_BYTES[dtype]


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def _require(cond: bool, msg: str = "invalid config"):
    if not cond:
        raise ConfigError(msg)


class ConfigBase:
    """Shared JSON-dict plumbing (reference ``config.py:77-145``)."""

    @classmethod
    def init_from_dict(cls, data: Dict[str, Any]):
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in known}
        unknown = {k: v for k, v in data.items() if k not in known}
        obj = cls(**kwargs)  # type: ignore[call-arg]
        obj.extra_fields = unknown
        if unknown:
            # A typo'd field would otherwise silently fall back to its
            # default and skew the estimate with no signal.
            warnings.warn(
                f"{cls.__name__}: unknown config keys ignored "
                f"(kept in extra_fields): {sorted(unknown)}",
                stacklevel=2,
            )
        return obj

    @classmethod
    def init_from_config_file(cls, path: str):
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        obj = cls.init_from_dict(data)
        obj.config_path = path
        return obj

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                v = dataclasses.asdict(v)
            out[f.name] = v
        return out

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


# --------------------------------------------------------------------------
# ModelConfig
# --------------------------------------------------------------------------


@dataclass
class ModelConfig(ConfigBase):
    """LLM architecture description (reference ``config.py:1041-1227``).

    Supports dense GQA/MHA models, MoE (DeepSeek/Mixtral style with shared
    experts and leading dense layers) and MLA attention.
    """

    model_name: str = "model"
    model_type: str = "dense"  # dense | moe
    attention_type: str = "gqa"  # gqa | mla
    hidden_size: int = 0
    head_num: int = 0
    kv_head_num: int = 0
    head_size: int = 0
    intermediate_size: int = 0
    layer_num: int = 0
    vocab_size: int = 0
    use_swiglu: bool = True
    untie_embeddings: bool = True
    make_vocab_size_divisible_by: int = 128
    #: decoder-style causal masking. A config property, NOT inferred from
    #: sq==skv shapes: CP re-sharding makes sq!=skv for causal models and
    #: a bidirectional model can have sq==skv (VERDICT round-1, weak #6).
    use_causal_attention: bool = True

    # MoE
    expert_num: int = 0
    topk: int = 1
    moe_ffn_hidden_size: int = 0
    moe_shared_expert_intermediate_size: int = 0
    dense_layers: int = 0  # leading dense layers in a MoE model

    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_head_dim: int = 0
    qk_pos_emb_head_dim: int = 0
    v_head_dim: int = 0

    padded_vocab_size: int = 0  # filled by maybe_pad_vocab_size

    def __post_init__(self):
        if self.kv_head_num == 0:
            self.kv_head_num = self.head_num
        if self.head_size == 0 and self.head_num:
            self.head_size = self.hidden_size // self.head_num
        if self.attention_type == "mla":
            if self.qk_head_dim == 0:
                self.qk_head_dim = self.head_size
            if self.v_head_dim == 0:
                self.v_head_dim = self.head_size
        if self.padded_vocab_size == 0:
            self.padded_vocab_size = self.vocab_size

    # -- sanity ------------------------------------------------------------
    def sanity_check(self):
        _require(self.model_type in ("dense", "moe"), str(self.model_type))
        _require(
            self.attention_type in ("gqa", "mla"), str(self.attention_type)
        )
        _require(self.hidden_size > 0 and self.layer_num > 0, "bad dims")
        _require(self.head_num > 0 and self.vocab_size > 0, "bad dims")
        if self.model_type == "moe":
            _require(
                self.expert_num > 0 and self.moe_ffn_hidden_size > 0,
                "moe model needs expert_num and moe_ffn_hidden_size",
            )
            _require(1 <= self.topk <= self.expert_num, "bad topk")
        if self.attention_type == "mla":
            _require(
                self.kv_lora_rank > 0 and self.v_head_dim > 0,
                "mla model needs kv_lora_rank and v_head_dim",
            )

    # -- derived -----------------------------------------------------------
    def maybe_pad_vocab_size(self, tp_size: int) -> int:
        """Megatron-style vocab padding (reference ``config.py:1091``)."""
        mult = self.make_vocab_size_divisible_by * tp_size
        self.padded_vocab_size = int(math.ceil(self.vocab_size / mult) * mult)
        return self.padded_vocab_size

    @property
    def moe_layer_num(self) -> int:
        if self.model_type != "moe":
            return 0
        return self.layer_num - self.dense_layers

    @property
    def dense_layer_num(self) -> int:
        if self.model_type != "moe":
            return self.layer_num
        return self.dense_layers

    def qkv_proj_elements(self) -> int:
        """Per-layer attention projection weight elements (incl. MLA branch,
        reference ``config.py:1181-1196``)."""
        h = self.hidden_size
        if self.attention_type == "mla":
            n = 0
            q_out = self.head_num * (self.qk_head_dim + self.qk_pos_emb_head_dim)
            if self.q_lora_rank:
                n += h * self.q_lora_rank + self.q_lora_rank  # q_down + q_norm
                n += self.q_lora_rank * q_out  # q_up
            else:
                n += h * q_out
            n += h * (self.kv_lora_rank + self.qk_pos_emb_head_dim)  # kv_down
            n += self.kv_lora_rank  # kv_norm
            n += self.kv_lora_rank * self.head_num * (
                self.qk_head_dim + self.v_head_dim
            )  # kv_up
            n += self.head_num * self.v_head_dim * h  # out proj
            return n
        q_out = self.head_num * self.head_size
        kv_out = 2 * self.kv_head_num * self.head_size
        return h * (q_out + kv_out) + q_out * h

    def mlp_elements(self, ffn: Optional[int] = None) -> int:
        h = self.hidden_size
        f = self.intermediate_size if ffn is None else ffn
        fan_in = 2 * f if self.use_swiglu else f
        return h * fan_in + f * h

    def layer_param_elements(self, layer_idx: int) -> Tuple[int, int]:
        """Return (dense_elements, expert_elements) for one layer."""
        h = self.hidden_size
        dense = self.qkv_proj_elements() + 2 * h  # attn + 2 norms
        expert = 0
        is_moe = self.model_type == "moe" and layer_idx >= self.dense_layers
        if is_moe:
            dense += h * self.expert_num  # router
            if self.moe_shared_expert_intermediate_size:
                dense += self.mlp_elements(self.moe_shared_expert_intermediate_size)
            expert = self.expert_num * self.mlp_elements(self.moe_ffn_hidden_size)
        else:
            dense += self.mlp_elements()
        return dense, expert

    def param_numel(self) -> int:
        """Total parameter elements (reference ``config.py:1128`` region)."""
        n = self.padded_vocab_size * self.hidden_size  # embedding
        if self.untie_embeddings:
            n += self.padded_vocab_size * self.hidden_size  # lm head
        n += self.hidden_size  # final norm
        for i in range(self.layer_num):
            d, e = self.layer_param_elements(i)
            n += d + e
        return n

    def active_param_numel(self) -> int:
        """Parameters touched per token (MoE: topk experts only)."""
        n = self.padded_vocab_size * self.hidden_size
        if self.untie_embeddings:
            n += self.padded_vocab_size * self.hidden_size
        n += self.hidden_size
        for i in range(self.layer_num):
            d, e = self.layer_param_elements(i)
            if e:
                e = e * self.topk // self.expert_num
            n += d + e
        return n

    def flops_per_token(self, seq_len: int, causal: bool = False) -> float:
        """Theoretical forward FLOPs per token (reference ``config.py:1128``).

        Counts 2*elements per matmul weight touched per token plus the
        attention score/value matmuls. ``causal=True`` halves the attention
        term (MFU convention counts full attention by default).
        """
        flops = 0.0
        for i in range(self.layer_num):
            d, e = self.layer_param_elements(i)
            # norms are not matmuls; negligible, keep them out
            d -= 2 * self.hidden_size
            if self.model_type == "moe" and i >= self.dense_layers:
                d -= 0  # router is a matmul, keep
            if e:
                e = e * self.topk // self.expert_num
            flops += 2 * (d + e)
            # attention score + value matmuls
            if self.attention_type == "mla":
                qk_d = self.qk_head_dim + self.qk_pos_emb_head_dim
                att = 2 * seq_len * self.head_num * (qk_d + self.v_head_dim)
            else:
                att = 4 * seq_len * self.head_num * self.head_size
            if causal:
                att /= 2
            flops += att
        flops += 2 * self.hidden_size * self.padded_vocab_size  # logits
        return flops

    def train_flops_per_token(self, seq_len: int, causal: bool = False) -> float:
        return 3.0 * self.flops_per_token(seq_len, causal=causal)


# --------------------------------------------------------------------------
# Recompute configuration
# --------------------------------------------------------------------------


#: valid ``megatron_recompute_modules`` entries (reference
#: ``valid_megatron_recompute_modules`` config.py:308-315) — the single
#: source for sanity validation and the flag mapping below
MEGATRON_RECOMPUTE_MODULES = frozenset(
    {"core_attn", "layernorm", "mla_up_proj", "moe_act", "mlp", "moe"}
)
#: the subset whose segments are single ops: their replay is pure tail,
#: so they get the variance-tail model automatically (reference
#: ``use_variance_tail_model`` config.py:416-418)
MEGATRON_TAIL_MODULES = frozenset({"layernorm", "mla_up_proj", "moe_act"})


@dataclass
class RecomputeConfig:
    """Activation recompute policy (reference's three generations of flags,
    ``config.py:261-315`` + ``parse_attention_recompute config.py:469`` /
    ``parse_mlp_recompute config.py:522``), normalised to one struct."""

    granularity: str = "none"  # none | full_block | selective | sdp_only
    recompute_layer_num: int = -1  # -1 => all layers in the stage
    # selective flags
    attn_recompute: bool = False
    attn_norm_recompute: bool = False
    mlp_recompute: bool = False
    mlp_norm_recompute: bool = False
    sdp_recompute: bool = False
    #: Megatron-0.14 module granularities (reference
    #: ``valid_megatron_recompute_modules`` config.py:308-315)
    moe_act_recompute: bool = False  # expert activation only
    mla_up_proj_recompute: bool = False  # MLA q_up/kv_up projections
    #: variance-tail optimisation (reference ``config.py:264,416-418``):
    #: the LAST leaf of each checkpointed segment skips its forward
    #: replay — its backward only needs the recomputed *input* produced
    #: by the preceding replay, never its own output. Only meaningful
    #: for selective recompute; Megatron full-block recompute does not
    #: support it (reference ``config.py:690``), so it is forced off.
    variance: bool = False
    #: megatron modules whose segments get the tail model regardless of
    #: the global ``variance`` flag (their replay is pure tail); kept
    #: per-module so e.g. core_attn + layernorm does NOT make the sdp
    #: segment free
    tail_modules: frozenset = frozenset()

    @classmethod
    def from_strategy_dict(cls, d: Dict[str, Any]) -> "RecomputeConfig":
        if not d.get("enable_recompute", False):
            return cls()
        gran = d.get("recompute_granularity", "full_block")
        cfg = cls(
            granularity=gran,
            recompute_layer_num=d.get("recompute_layer_num", -1),
            attn_recompute=d.get("attn_recompute", False),
            attn_norm_recompute=d.get("attn_norm_recompute", False),
            mlp_recompute=d.get("mlp_recompute", False),
            mlp_norm_recompute=d.get("mlp_rms_recompute", False),
            sdp_recompute=d.get("sdp_recompute", False),
            variance=d.get("recompute_variance", False),
        )
        if gran == "full_recompute":
            cfg.granularity = "full_block"
        if gran == "selective_recompute":
            cfg.granularity = "selective"
        if gran == "sdp_only":
            cfg.granularity = "selective"
            cfg.sdp_recompute = True
        if gran == "attn_only":
            cfg.granularity = "selective"
            cfg.attn_recompute = True
            cfg.attn_norm_recompute = True
        if gran == "mlp_only":
            cfg.granularity = "selective"
            cfg.mlp_recompute = True
            cfg.mlp_norm_recompute = True
        # Megatron-0.14 spelling: a module list instead of flags
        # (reference ``megatron_recompute``/``megatron_recompute_modules``
        # config.py:265-266,308-315). Normalised onto the same flags
        # AFTER the granularity remaps so the module list cannot be
        # silently discarded; unlike the reference, core_attn maps onto
        # the supported sdp-only path instead of asserting. Single-op
        # modules get the tail model per-segment (reference
        # ``use_variance_tail_model`` config.py:416), not globally.
        modules = set(d.get("megatron_recompute_modules") or [])
        if d.get("megatron_recompute") and modules:
            cfg.granularity = "selective"
            cfg.attn_norm_recompute |= "layernorm" in modules
            cfg.mlp_norm_recompute |= "layernorm" in modules
            cfg.sdp_recompute |= "core_attn" in modules
            cfg.mla_up_proj_recompute |= "mla_up_proj" in modules
            cfg.moe_act_recompute |= "moe_act" in modules
            cfg.mlp_recompute |= bool(modules & {"mlp", "moe"})
            cfg.tail_modules = frozenset(
                modules & MEGATRON_TAIL_MODULES
            )
        if cfg.granularity == "full_block":
            cfg.variance = False  # full-block recompute replays everything
            cfg.tail_modules = frozenset()
        return cfg

    @property
    def enabled(self) -> bool:
        return self.granularity != "none"

    def layer_recomputes(self, layer_idx_in_stage: int) -> bool:
        """Whether a given layer (index within its PP stage) recomputes."""
        if not self.enabled:
            return False
        if self.recompute_layer_num < 0:
            return True
        return layer_idx_in_stage < self.recompute_layer_num


# --------------------------------------------------------------------------
# StrategyConfig
# --------------------------------------------------------------------------


@dataclass
class StrategyConfig(ConfigBase):
    """Parallelism strategy + runtime policy surface (reference
    ``config.py:209-693``), TPU-flavoured: the parallel dims map onto a
    device mesh laid over the ICI torus in order
    ``tp -> cp -> (ep/etp within dp*cp*tp) -> dp -> pp`` innermost-first.
    """

    seq_len: int = 4096
    micro_batch_size: int = 1
    micro_batch_num: int = 8
    dtype: str = "bf16"
    fp8: bool = False  # quantized matmul path (TPU: int8 via quant_dtype)
    quant_dtype: str = "int8"  # TPU-native low-precision matmul dtype

    world_size: int = 8
    tp_size: int = 1
    cp_size: int = 1
    pp_size: int = 1
    ep_size: int = 1
    etp_size: int = 1

    moe_dispatcher_policy: str = "all2all"
    moe_capacity_factor: float = 0.0  # 0 => dropless (balanced assumption)
    #: grouped-GEMM execution style (reference ``group_linear_mode``,
    #: ``moe_module.py:835-1289``): "parallel" = one grouped kernel
    #: (TPU: megablox/ragged_dot; costed via the ``group_matmul``
    #: efficiency table), "sequential" = per-expert GEMMs (TPU: a
    #: ``lax.scan`` of dense matmuls; costed via the ``matmul`` table at
    #: batch=ng with the smaller per-expert m — capturing the MXU
    #: under-utilisation of small per-expert tiles).
    group_linear_mode: str = "parallel"
    #: host-offload the dispatched-token inputs of the first expert GEMM
    #: (reference ``offload_groupgemm_col_inputs`` config.py:239,
    #: ``moe_module.py:962-979``): their HBM cache drops to zero and the
    #: backward re-uploads them as a transient. Memory-only effect, as
    #: in the reference (the d2h/h2d rides the async DMA engines).
    offload_groupgemm_col_inputs: bool = False
    #: Megatron-0.14 combine-fusion (reference ``config.py:297``):
    #: router probs ride their own EP all-to-all at dispatch and the
    #: weighting fuses into the expert activation (weighted-SiLU), so
    #: the combine step caches nothing. Trades a small probs a2a for
    #: the pre-combine hidden-states cache.
    dispatch_probs: bool = False
    enable_sequence_parallel: bool = True
    cp_comm_type: str = "a2a"  # a2a (Ulysses) | all_gather (ring/KV-gather)
    cp_a2a_mode: str = "sync_cp"  # sync_cp | async_cp

    # pipeline
    interleaving_size: int = 1  # VPP chunks per rank
    microbatch_group_size_per_vp_stage: int = 0  # 0 => pp_size
    pp_comm_async: bool = True
    num_layers_in_first_pipeline_stage: int = 0
    num_layers_in_last_pipeline_stage: int = 0
    account_for_embedding_in_pipeline_split: bool = False
    account_for_loss_in_pipeline_split: bool = False

    #: 0: replicated grads+state; 1: ZeRO-1 (state sharded); 2: +grads
    #: sharded (per-microbatch reduce-scatter); 3: FSDP (params sharded,
    #: per-layer all-gathers). The reference clamps 2/3 to 1; modeled
    #: fully here — FSDP is the dominant TPU/JAX pattern.
    zero_state: int = 1
    enable_dropout: bool = False
    use_fused_norm: bool = True
    use_math_sdp: bool = False
    use_flash_sdp: bool = True
    #: attention kernel backend the modeled framework runs: "torch"
    #: (eager math attention) or "cuda" (the hand-written flash kernels,
    #: simumax_tpu_torch.torchref.kernels.flash_attention).
    #: Efficiency-table keys are prefixed for non-default backends so
    #: both can be calibrated side by side.
    sdp_backend: str = "torch"
    use_fused_ce: bool = False
    use_fp32_accum_grad: bool = True
    grad_reduce_in_bf16: bool = False
    #: "megatron": distributed-optimizer phases (zero-grad buffer, l2
    #: norm/clip, adam, fp32->param copy). "functional": one fused
    #: adam kernel as XLA emits for a functional train step.
    optimizer_style: str = "megatron"
    #: Megatron-style comm/compute overlap: bucketed grad reduce hides
    #: under the last microbatch's backward; the ZeRO-1 param
    #: all-gather hides under the next forward
    overlap_grad_reduce: bool = False
    overlap_param_gather: bool = False
    attention_sparse_ratio: float = 0.5  # causal => half the score flops

    enable_recompute: bool = False
    recompute_granularity: str = "full_block"
    recompute_layer_num: int = -1
    attn_recompute: bool = False
    mla_rms_recompute: bool = False
    attn_norm_recompute: bool = False
    mlp_recompute: bool = False
    mlp_rms_recompute: bool = False
    sdp_recompute: bool = False
    moe_act_recompute: bool = False
    mla_up_proj_recompute: bool = False
    recompute_variance: bool = False
    #: Megatron-0.14 spelling: recompute a module list instead of flags
    #: (reference ``config.py:265-266``); normalised into ``recompute``
    megatron_recompute: bool = False
    megatron_recompute_modules: Optional[List[str]] = None

    mem_factor: float = 0.94  # usable fraction of HBM
    enable_straggler_model: bool = False
    #: innermost-first placement of the dense parallel dims on the ICI
    #: torus / DCN (the TPU analog of the reference's per-dim net
    #: selection ``tp_net..edp_net``). Default keeps pp outermost (it
    #: spans DCN in multi-slice); "tp,cp,pp,dp" is the standard
    #: multislice recipe — dp gradients over DCN (overlappable), pipeline
    #: p2p inside the slice. tp must stay innermost (MXU sharding).
    mesh_order: str = "tp,cp,dp,pp"

    def __post_init__(self):
        self.recompute = RecomputeConfig.from_strategy_dict(
            {
                "enable_recompute": self.enable_recompute,
                "recompute_granularity": self.recompute_granularity,
                "recompute_layer_num": self.recompute_layer_num,
                "attn_recompute": self.attn_recompute,
                "attn_norm_recompute": (
                    self.attn_norm_recompute or self.mla_rms_recompute
                ),
                "mlp_recompute": self.mlp_recompute,
                "mlp_rms_recompute": self.mlp_rms_recompute,
                "sdp_recompute": self.sdp_recompute,
                "recompute_variance": self.recompute_variance,
                "megatron_recompute": self.megatron_recompute,
                "megatron_recompute_modules": self.megatron_recompute_modules,
            }
        )
        self.recompute.moe_act_recompute |= self.moe_act_recompute
        self.recompute.mla_up_proj_recompute |= self.mla_up_proj_recompute


    # -- derived sizes (reference ``config.py:352-368``) -------------------
    @property
    def dp_size(self) -> int:
        return self.world_size // (self.tp_size * self.cp_size * self.pp_size)

    @property
    def edp_size(self) -> int:
        return self.world_size // (self.etp_size * self.ep_size * self.pp_size)

    @property
    def global_batch_size(self) -> int:
        return self.micro_batch_size * self.micro_batch_num * self.dp_size

    @property
    def tokens_per_iter(self) -> int:
        return self.global_batch_size * self.seq_len

    @property
    def vp_size(self) -> int:
        return max(1, self.interleaving_size)

    @property
    def vpp_group_size(self) -> int:
        """Microbatch group size per virtual-pipeline stage (Megatron
        ``microbatch_group_size_per_vp_stage``; defaults to pp_size)."""
        return self.microbatch_group_size_per_vp_stage or self.pp_size

    @property
    def element_size(self) -> float:
        return dtype_to_bytes(self.dtype)

    @property
    def grad_element_size(self) -> float:
        return 4.0 if self.use_fp32_accum_grad else self.element_size

    # -- string form -------------------------------------------------------
    @classmethod
    def init_from_format_strings(cls, spec: str, **overrides) -> "StrategyConfig":
        """Parse ``tp2_pp2_dp2_mbs1_mbc8``-style compact strings
        (reference ``config.py:321-350``)."""
        mapping = {
            "tp": "tp_size",
            "pp": "pp_size",
            "dp": None,  # derived; used for world_size
            "cp": "cp_size",
            "ep": "ep_size",
            "etp": "etp_size",
            "vp": "interleaving_size",
            "mbs": "micro_batch_size",
            "mbc": "micro_batch_num",
            "seq": "seq_len",
        }
        kwargs: Dict[str, Any] = {}
        dp = None
        for token in spec.split("_"):
            key = token.rstrip("0123456789")
            val = token[len(key):]
            if key not in mapping or not val:
                continue
            if key == "dp":
                dp = int(val)
            elif mapping[key]:
                kwargs[mapping[key]] = int(val)
        kwargs.update(overrides)
        cfg = cls(**kwargs)
        if dp is not None and "world_size" not in overrides:
            cfg.world_size = cfg.tp_size * cfg.cp_size * cfg.pp_size * dp
        return cfg

    # -- sanity (reference ``config.py:592-690``) --------------------------
    def sanity_check(self):
        _require(self.world_size > 0, "world_size must be positive")
        prod = self.tp_size * self.cp_size * self.pp_size
        _require(
            self.world_size % prod == 0,
            f"world_size {self.world_size} not divisible by tp*cp*pp {prod}",
        )
        _require(self.dp_size >= 1, "dp_size must be >= 1")
        eprod = self.etp_size * self.ep_size * self.pp_size
        _require(
            self.world_size % eprod == 0,
            f"world_size {self.world_size} not divisible by etp*ep*pp {eprod}",
        )
        _require(self.etp_size <= self.tp_size, "etp must divide tp")
        _require(self.tp_size % self.etp_size == 0, "etp must divide tp")
        _require(self.dtype in DTYPE_BYTES, f"unknown dtype {self.dtype!r}")
        _require(self.zero_state in (0, 1, 2, 3), "zero_state in 0..3")
        _require(
            self.cp_comm_type in ("a2a", "all_gather"),
            f"unknown cp_comm_type {self.cp_comm_type!r}",
        )
        _require(
            self.cp_a2a_mode in ("sync_cp", "async_cp"),
            f"unknown cp_a2a_mode {self.cp_a2a_mode!r}",
        )
        _require(
            self.moe_dispatcher_policy in ("all2all",),
            f"unknown moe_dispatcher_policy {self.moe_dispatcher_policy!r}",
        )
        _require(
            self.group_linear_mode in ("parallel", "sequential"),
            f"unknown group_linear_mode {self.group_linear_mode!r}",
        )
        if self.offload_groupgemm_col_inputs:
            _require(
                not (self.enable_recompute
                     and self.recompute_granularity
                     in ("full_block", "full_recompute")),
                "offload_groupgemm_col_inputs is incompatible with "
                "full-block recompute (the replay would re-offload; "
                "reference config.py:601-602 forbids the same)",
            )
        _require(
            self.optimizer_style in ("megatron", "functional"),
            f"unknown optimizer_style {self.optimizer_style!r}",
        )
        if self.interleaving_size > 1:
            _require(self.pp_size > 1, "VPP requires pp_size > 1")
            _require(
                self.micro_batch_num % self.vpp_group_size == 0,
                f"interleaved schedule requires micro_batch_num "
                f"({self.micro_batch_num}) divisible by the vp microbatch "
                f"group size ({self.vpp_group_size})",
            )
            _require(
                self.vpp_group_size >= self.pp_size,
                f"vp microbatch group size ({self.vpp_group_size}) must be "
                f">= pp_size ({self.pp_size}): a smaller group starves the "
                f"downstream stages and the interleaved schedule deadlocks "
                f"(Megatron enforces the same bound)",
            )
        if self.enable_sequence_parallel:
            _require(
                self.seq_len % (self.tp_size * self.cp_size) == 0,
                "sequence parallelism requires seq_len divisible by tp*cp",
            )
        if self.use_math_sdp:
            _require(
                not self.use_flash_sdp,
                "use_math_sdp and use_flash_sdp are mutually exclusive",
            )
        _require(
            self.sdp_backend in ("torch", "cuda"),
            f"unknown sdp_backend {self.sdp_backend!r}",
        )
        if self.sdp_backend == "cuda":
            _require(
                self.use_flash_sdp,
                "sdp_backend='cuda' is the fused flash kernel — "
                "use_flash_sdp must be set (math accounting would time "
                "one kernel while modeling another)",
            )
        if self.megatron_recompute:
            modules = set(self.megatron_recompute_modules or [])
            _require(
                bool(modules),
                "megatron_recompute requires non-empty "
                "megatron_recompute_modules",
            )
            _require(
                modules <= MEGATRON_RECOMPUTE_MODULES,
                "unknown megatron_recompute_modules "
                f"{modules - MEGATRON_RECOMPUTE_MODULES}",
            )
            _require(
                self.recompute_granularity
                in ("selective", "selective_recompute"),
                "megatron_recompute requires "
                "recompute_granularity='selective' (the module list is "
                "meaningless under full-block recompute)",
            )
            _require(
                not any([self.attn_recompute, self.attn_norm_recompute,
                         self.mla_rms_recompute, self.mlp_recompute,
                         self.mlp_rms_recompute, self.sdp_recompute,
                         self.moe_act_recompute,
                         self.mla_up_proj_recompute,
                         self.recompute_variance]),
                "megatron_recompute is mutually exclusive with the legacy "
                "selective flags and recompute_variance",
            )
        order = self.mesh_order.split(",")
        _require(
            sorted(order) == ["cp", "dp", "pp", "tp"],
            f"mesh_order {self.mesh_order!r} must be a permutation of "
            "tp,cp,dp,pp",
        )
        _require(
            order[0] == "tp",
            "mesh_order must keep tp innermost (MXU sharding rides the "
            "fastest ICI axis)",
        )
        if self.mesh_order != "tp,cp,dp,pp":
            _require(
                self.ep_size == 1,
                "non-default mesh_order with expert parallelism is not "
                "modeled yet (the ep/edp overlay assumes pp outermost)",
            )


# --------------------------------------------------------------------------
# SystemConfig: the TPU hardware cost model
# --------------------------------------------------------------------------


@dataclass
class CompOpSpec:
    """One compute-op efficiency row (reference ``CompOpConfig``)."""

    tflops: float = 0.0
    efficient_factor: float = 0.6
    accurate_efficient_factor: Dict[str, float] = field(default_factory=dict)


@dataclass
class BandwidthSpec:
    gbps: float = 0.0
    efficient_factor: float = 0.8
    latency_us: float = 1.0


@dataclass
class NetOpSpec:
    """Per-collective tuning knobs on a network class."""

    efficient_factor: float = 1.0
    latency_us: float = 0.0  # extra fixed latency per call


@dataclass
class Span:
    """One hop-class of a communication path: a (possibly partial/strided)
    torus-axis segment, or the DCN stage.

    ``gbps`` is the *effective per-chip* bandwidth for bandwidth-bound ring
    collectives along this span: per-direction link GB/s, doubled when the
    span wraps around the torus axis (bidirectional ring), divided by the
    number of sibling groups time-sharing the physical links when the group
    is strided within the axis.
    """

    extent: int
    gbps: float
    wrap: bool
    latency_us: float
    kind: str = "ici"  # ici | dcn | nvlink | ib


#: span kinds behind a switch, where every member reaches every other in
#: one hop over links of its own (the NVSwitch domain, the IB fabric)
SWITCHED_KINDS = ("nvlink", "ib")
#: span kinds that leave the slice or node
OUTER_KINDS = ("dcn", "ib")


@dataclass
class CommPath:
    """Where a parallel group lives on the machine: ordered spans
    (innermost torus axis first, DCN last)."""

    dim: str
    group_size: int
    spans: List[Span] = field(default_factory=list)

    @property
    def on_dcn(self) -> bool:
        """True where the path leaves its slice or node (a ``dcn`` or
        ``ib`` span)."""
        return any(s.kind in OUTER_KINDS for s in self.spans)

    def describe(self) -> str:
        parts = [
            f"{s.kind}[{s.extent}{'⟳' if s.wrap else ''}@{s.gbps:.0f}GB/s]"
            for s in self.spans
        ]
        return f"{self.dim}({self.group_size}): " + " × ".join(parts) if parts else f"{self.dim}(1)"


@dataclass
class IciConfig:
    """ICI slice topology. ``axes`` innermost-first, e.g. v5e-256 =
    ``[16, 16]`` 2D torus, v5p-256 = ``[8, 8, 4]`` 3D torus."""

    axes: List[int] = field(default_factory=lambda: [8])
    wraparound: List[bool] = field(default_factory=list)
    link_gbps: float = 45.0  # per link, per direction
    latency_us: float = 1.0
    op: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.wraparound:
            # v5e/v5p tori wrap on full axes; small sub-slices may not
            self.wraparound = [a >= 4 for a in self.axes]
        assert len(self.wraparound) == len(self.axes), (
            f"wraparound {self.wraparound} must match axes {self.axes}"
        )
        self.op = {
            k: (v if isinstance(v, NetOpSpec) else NetOpSpec(**v))
            for k, v in self.op.items()
        }

    @property
    def num_chips(self) -> int:
        return int(math.prod(self.axes))


@dataclass
class DcnConfig:
    """Cross-slice data-center network, per-chip effective share."""

    gbps_per_chip: float = 6.25  # e.g. 25 GB/s NIC per 4-chip host
    latency_us: float = 10.0
    op: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.op = {
            k: (v if isinstance(v, NetOpSpec) else NetOpSpec(**v))
            for k, v in self.op.items()
        }


def _net_op_table(op: Dict[str, Any]) -> Dict[str, NetOpSpec]:
    return {k: (v if isinstance(v, NetOpSpec) else NetOpSpec(**v)) for k, v in op.items()}


@dataclass
class NvlinkConfig:
    """The NVSwitch domain of one node: every GPU reaches every other in
    one switch hop over its own NVLinks. ``link_gbps`` is one GPU's
    NVLink bandwidth per direction (NVLink 4 on the H100 SXM: 18 links,
    450 GB/s, datasheet)."""

    gpus_per_node: int = 8
    link_gbps: float = 450.0
    latency_us: float = 0.8
    op: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.op = _net_op_table(self.op)


@dataclass
class IbConfig:
    """The InfiniBand fabric between nodes, one rail a GPU (a rail-
    optimised fat tree). ``gbps_per_gpu`` is one GPU's rail per direction
    (one 400 Gb/s NDR port: 50 GB/s, datasheet)."""

    gbps_per_gpu: float = 50.0
    latency_us: float = 3.0
    op: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.op = _net_op_table(self.op)


@dataclass
class HostConfig:
    """Per-chip host attach for checkpoint/restore traffic: the
    HBM → host (PCIe/offload) → persistent storage / DCN chain the
    checkpoint cost model streams through (``simulator/faults.py::
    CheckpointCostModel``, ``docs/faults.md``). Bandwidths are
    effective per-chip GB/s shares."""

    #: device-to-host transfer share per chip (e.g. 100 GB/s PCIe
    #: shared by a 4-chip host)
    d2h_gbps: float = 25.0
    #: sustained per-chip write share of the checkpoint store
    ckpt_write_gbps: float = 1.0
    #: sustained per-chip read share on restore (reads fan out wider)
    ckpt_read_gbps: float = 2.0
    #: fixed commit/barrier latency per checkpoint or restore
    latency_s: float = 1.0


@dataclass
class AcceleratorSpec:
    backend: str = "cuda"
    mem_gbs: float = 16.0  # HBM capacity in GiB
    op: Dict[str, Any] = field(default_factory=dict)
    bandwidth: Dict[str, Any] = field(default_factory=dict)
    mode: str = "roofline"  # roofline | compute_only

    def __post_init__(self):
        self.op = {
            k: (v if isinstance(v, CompOpSpec) else CompOpSpec(**v))
            for k, v in self.op.items()
        }
        self.bandwidth = {
            k: (v if isinstance(v, BandwidthSpec) else BandwidthSpec(**v))
            for k, v in self.bandwidth.items()
        }
        if "default" not in self.op:
            self.op["default"] = CompOpSpec(tflops=100.0)
        if "default" not in self.bandwidth:
            self.bandwidth["default"] = BandwidthSpec(gbps=800.0)


@dataclass
class SystemConfig(ConfigBase):
    """TPU machine description + cost primitives.

    Reference: ``SystemConfig`` ``config.py:695-1038``; the four public
    methods keep their names/roles, the network internals are mesh-native.
    """

    sys_name: str = "tpu"
    num_slices: int = 1
    accelerator: Any = field(default_factory=AcceleratorSpec)
    #: ICI torus / DCN of a TPU system; ``None`` on a GPU system
    ici: Any = None
    dcn: Any = None
    #: NVSwitch domain / InfiniBand rails of a GPU system (``num_slices``
    #: counts its nodes); ``None`` on a TPU system and on one card
    nvlink: Any = None
    ib: Any = None
    #: checkpoint/restore chain (HBM -> host -> storage), consumed by
    #: the fault/goodput layer; excluded from :meth:`fingerprint`
    #: (it is a policy surface, not calibrated compute identity)
    host: Any = field(default_factory=HostConfig)
    #: calibration-table provenance stamp written by
    #: ``calibration.autocal.calibrate_system``: ``system_hash``
    #: (``fingerprint()`` of the hardware identity at calibration time),
    #: ``created`` (ISO date), ``version``. Checked on load so a table
    #: calibrated for different hardware warns instead of silently
    #: skewing estimates.
    provenance: Optional[Dict[str, Any]] = None

    #: provenance stamps older than this warn as stale
    PROVENANCE_MAX_AGE_DAYS = 180

    def __post_init__(self):
        if isinstance(self.accelerator, dict):
            self.accelerator = AcceleratorSpec(**self.accelerator)
        if isinstance(self.ici, dict):
            self.ici = IciConfig(**self.ici)
        if isinstance(self.dcn, dict):
            self.dcn = DcnConfig(**self.dcn)
        if isinstance(self.nvlink, dict):
            self.nvlink = NvlinkConfig(**self.nvlink)
        if isinstance(self.ib, dict):
            self.ib = IbConfig(**self.ib)
        if self.ici is not None and self.nvlink is not None:
            raise ConfigError(
                f"system {self.sys_name!r} describes both an ICI torus and an "
                f"NVSwitch domain: give one network")
        if isinstance(self.host, dict):
            self.host = HostConfig(**self.host)
        self.reset_status()
        self._check_provenance()

    def fingerprint(self) -> str:
        """Stable hash of the *hardware identity* — peak rates, capacity,
        topology — excluding the measured efficiency tables (which
        calibration rewrites). Two configs with the same fingerprint
        describe the same machine, so each other's calibration tables
        are interchangeable."""
        ident = {
            "sys_name": self.sys_name,
            "num_slices": self.num_slices,
            "mem_gbs": self.accelerator.mem_gbs,
            "op_tflops": {k: v.tflops for k, v in self.accelerator.op.items()},
            # 'fused_adam' is synthesized by calibration (same physical
            # HBM as 'default'), so hashing it would make a calibrated
            # config's stamp mismatch the pristine config it came from
            "bw_gbps": {k: v.gbps
                        for k, v in self.accelerator.bandwidth.items()
                        if k != "fused_adam"},
        }
        if self.ici is not None:
            ident["ici_axes"] = list(self.ici.axes)
            ident["ici_link_gbps"] = self.ici.link_gbps
        if self.dcn is not None:
            ident["dcn_gbps_per_chip"] = self.dcn.gbps_per_chip
        if self.nvlink is not None:
            ident["nvlink_gpus_per_node"] = self.nvlink.gpus_per_node
            ident["nvlink_link_gbps"] = self.nvlink.link_gbps
        if self.ib is not None:
            ident["ib_gbps_per_gpu"] = self.ib.gbps_per_gpu
        blob = json.dumps(ident, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def stamp_provenance(self) -> Dict[str, Any]:
        """Write a fresh provenance stamp (called after calibration)."""
        import datetime

        from simumax_tpu_torch.version import __version__

        self.provenance = {
            "system_hash": self.fingerprint(),
            # calibration-time stamp: provenance is MEANT to change
            # when tables are re-measured (it invalidates cache keys)
            "created": datetime.date.today().isoformat(),  # noqa: SIM003
            "version": __version__,
        }
        return self.provenance

    def _check_provenance(self):
        """Warn when a loaded calibration table is stale: stamped for a
        different hardware identity, or older than
        ``PROVENANCE_MAX_AGE_DAYS``."""
        if not self.provenance:
            return
        stamped = self.provenance.get("system_hash")
        if stamped and stamped != self.fingerprint():
            warnings.warn(
                f"system {self.sys_name!r}: calibration tables are stale — "
                f"stamped for hardware {stamped}, this config is "
                f"{self.fingerprint()}; re-run `simumax_tpu_torch calibrate` "
                f"(estimates will use possibly-skewed efficiencies)",
                stacklevel=2,
            )
        created = self.provenance.get("created")
        if created:
            import datetime

            try:
                # staleness warning only: the age never reaches a
                # payload, a hash, or a sweep decision
                age = (
                    datetime.date.today()  # noqa: SIM003
                    - datetime.date.fromisoformat(str(created))
                ).days
            except ValueError:
                age = None
            if age is not None and age > self.PROVENANCE_MAX_AGE_DAYS:
                warnings.warn(
                    f"system {self.sys_name!r}: calibration tables are "
                    f"{age} days old (> {self.PROVENANCE_MAX_AGE_DAYS}); "
                    f"consider re-running `simumax_tpu_torch calibrate`",
                    stacklevel=2,
                )

    # -- observability (reference ``config.py:792-813``) -------------------
    def reset_status(self):
        self.hit_efficiency: Dict[str, Dict[str, float]] = {}
        #: shape keys that fell back to the flat per-op efficiency, mapped
        #: to the fallback factor used. An insertion-ordered dict keyed
        #: per op: O(1) membership (a long estimate records the same hot
        #: keys millions of times) while staying JSON-serializable and
        #: iterable in first-miss order like the old list.
        self.miss_efficiency: Dict[str, Dict[str, float]] = {}
        self.real_comm_bw: Dict[str, Dict[str, float]] = {}

    def _record_eff(self, op_key: str, shape_key: str, eff: float, hit: bool):
        if hit:
            self.hit_efficiency.setdefault(op_key, {})[shape_key] = eff
        else:
            self.miss_efficiency.setdefault(op_key, {})[shape_key] = eff

    def _record_bw(self, dim: str, op: str, bw_gbps: float):
        self.real_comm_bw.setdefault(dim, {})[op] = bw_gbps

    @property
    def mem_bytes(self) -> float:
        return self.accelerator.mem_gbs * GiB

    @property
    def chips_per_slice(self) -> int:
        """Chips of one ICI slice, or GPUs of one NVSwitch node."""
        if self.ici is not None:
            return self.ici.num_chips
        if self.nvlink is not None:
            return self.nvlink.gpus_per_node
        return 1

    def _require_network(self, what: str):
        if (self.ici is None or self.dcn is None) and (self.nvlink is None or self.ib is None):
            raise ConfigError(
                f"system {self.sys_name!r} describes one card without a "
                f"network: {what} needs an ICI torus and DCN, or an "
                f"NVSwitch domain and InfiniBand (a system config with "
                f"more than one card, e.g. h100_sxm_8x)"
            )

    @property
    def total_chips(self) -> int:
        return self.chips_per_slice * self.num_slices

    # ----------------------------------------------------------------------
    # Cost primitive (a): compute time with per-shape efficiency lookup
    # (reference ``compute_op_accuracy_time`` config.py:815-861)
    # ----------------------------------------------------------------------
    def resolve_op_efficiency(
        self, op_key: str, shape_key: Optional[str] = None,
        record: bool = True,
    ) -> Tuple[float, bool, Any]:
        """The efficiency lookup of :meth:`compute_op_accuracy_time`:
        ``(efficiency_used, calibrated_hit, spec)``. ``record=False``
        skips the hit/miss bookkeeping — the side-effect-free variant
        the cost-attribution ledger uses to re-derive exactly the
        provenance the estimate charged (one lookup implementation, so
        the two can never disagree)."""
        spec: CompOpSpec = self.accelerator.op.get(op_key) or self.accelerator.op["default"]
        eff = spec.efficient_factor
        hit = False
        if shape_key is not None:
            if shape_key in spec.accurate_efficient_factor:
                eff = spec.accurate_efficient_factor[shape_key]
                hit = True
            if record:
                self._record_eff(op_key, shape_key, eff, hit)
        return eff, hit, spec

    def compute_op_accuracy_time(
        self, op_key: str, flops: float, shape_key: Optional[str] = None
    ) -> float:
        eff, _hit, spec = self.resolve_op_efficiency(op_key, shape_key)
        if flops <= 0:
            return 0.0
        return flops / (spec.tflops * 1e12 * eff)

    # ----------------------------------------------------------------------
    # Cost primitive (b): HBM access time
    # (reference ``compute_mem_access_time`` config.py:863-893)
    # ----------------------------------------------------------------------
    def compute_mem_access_time(self, bytes_: float, bw_key: str = "default") -> float:
        spec: BandwidthSpec = (
            self.accelerator.bandwidth.get(bw_key)
            or self.accelerator.bandwidth["default"]
        )
        if bytes_ <= 0:
            return 0.0
        return bytes_ / (spec.gbps * 1e9 * spec.efficient_factor) + spec.latency_us * 1e-6

    # ----------------------------------------------------------------------
    # Cost primitive (c): collective time over a CommPath
    # (replaces reference ``compute_net_op_time`` config.py:904-1017)
    # ----------------------------------------------------------------------
    def place_group(self, dim: str, inner_size: int, group_size: int) -> CommPath:
        """Place a parallel group of ``group_size`` with ``inner_size``
        chips between members onto the ICI torus (and DCN beyond the slice).

        Mesh-native replacement for the reference's per-dim link-class
        selection (``analysis_net`` perf_llm.py:369-474): dims are laid out
        innermost-first over the torus axes; a group strided *within* an
        axis time-shares that axis's links with its sibling groups.

        On an NVSwitch system the node is one axis of ``gpus_per_node``,
        walked by the same rules: a span inside it is ``nvlink``, never
        wraps and keeps the full ``link_gbps`` however the group is
        strided (no intermediate chips, every GPU's links its own), and
        what is left of the group is one ``ib`` span at ``gbps_per_gpu``.
        """
        path = CommPath(dim=dim, group_size=group_size)
        if group_size <= 1:
            return path
        self._require_network(f"placing a {dim} group of {group_size}")
        if self.nvlink is not None:
            axes, wraparound = [self.nvlink.gpus_per_node], [False]
            link_gbps, latency_us, kind = self.nvlink.link_gbps, self.nvlink.latency_us, "nvlink"
            outer = (self.ib.gbps_per_gpu, self.ib.latency_us, "ib")
            shared, what = False, "NVLink node"
        else:
            axes, wraparound = self.ici.axes, self.ici.wraparound
            link_gbps, latency_us, kind = self.ici.link_gbps, self.ici.latency_us, "ici"
            outer = (self.dcn.gbps_per_chip, self.dcn.latency_us, "dcn")
            shared, what = True, "ICI axis"
        remaining = group_size
        inner = inner_size
        for ax_i, ax in enumerate(axes):
            if remaining <= 1:
                break
            if inner >= ax:
                # axis fully consumed by inner dims
                if inner % ax != 0 and ax % inner != 0:
                    # Misaligned (non-pow2) placement: the inner dims cannot
                    # tile this axis cleanly. Degrade conservatively — carry
                    # the rounded-up residual stride forward, which
                    # over-estimates link sharing on the outer axes.
                    warnings.warn(
                        f"place_group({dim}): inner stride {inner} does not "
                        f"tile {what} of size {ax}; using a conservative "
                        f"placement",
                        stacklevel=2,
                    )
                    inner = max(1, -(-inner // ax))
                else:
                    inner = max(1, inner // ax)
                continue
            # inner strides within this axis
            avail = ax // inner
            extent = min(remaining, avail)
            if remaining % extent != 0:
                extent = math.gcd(remaining, avail)
            covers_axis = (extent * inner == ax)
            wrap = covers_axis and wraparound[ax_i]
            # sibling groups time-share a torus axis's links; behind a
            # switch every GPU's links are its own
            share = 1.0 / inner if shared else 1.0
            gbps = link_gbps * (2.0 if wrap else 1.0) * share
            path.spans.append(
                Span(
                    extent=extent,
                    gbps=gbps,
                    wrap=wrap,
                    latency_us=latency_us,
                    kind=kind,
                )
            )
            remaining //= extent
            inner = 1  # after spanning an axis the group is contiguous
        if remaining > 1:
            # group extends across slices (nodes) -> DCN (IB) stage outermost
            path.spans.append(
                Span(
                    extent=remaining,
                    gbps=outer[0],
                    wrap=False,
                    latency_us=outer[1],
                    kind=outer[2],
                )
            )
        return path

    def net_config(self, kind: str):
        """The network behind a span kind: ``ici``, ``dcn``, ``nvlink``
        or ``ib``."""
        return {"ici": self.ici, "dcn": self.dcn, "nvlink": self.nvlink, "ib": self.ib}[kind]

    def _op_spec(self, span: Span, op: str) -> NetOpSpec:
        self._require_network(f"costing {op}")
        table = self.net_config(span.kind).op
        return table.get(op) or table.get("default") or NetOpSpec()

    def compute_net_op_time(
        self,
        op: str,
        size_bytes: float,
        path: CommPath,
        comm_num: Optional[int] = None,
    ) -> float:
        """Cost a collective of a *full logical tensor* of ``size_bytes``
        over ``path`` (same call semantics as the reference: ``size`` is the
        unsharded tensor; each chip holds ``size/group`` for AG/RS).

        Hierarchical per-axis ring decomposition: AllGather processed
        innermost-axis-out, ReduceScatter outermost-in; with equal
        bandwidth both reduce to the classic ``V*(n-1)/n / bw`` ring bound.
        AllReduce = RS + AG. AllToAll per-axis transposes cost
        ``V*extent/(4*bw)`` each — giving the bisection-limited ~sqrt(n)
        scaling a 2D torus actually provides; on an ``nvlink`` or ``ib``
        span (a switch) they cost ``V*(extent-1)/extent / bw`` and one hop.
        p2p is a single-link neighbour transfer (XLA collective-permute).
        """
        bw_t, lat_t = self.compute_net_op_terms(op, size_bytes, path,
                                                comm_num)
        t = bw_t + lat_t
        if t > 0:
            self._record_bw(path.dim, op, size_bytes / t / 1e9)
        return t

    def compute_net_op_terms(
        self,
        op: str,
        size_bytes: float,
        path: CommPath,
        comm_num: Optional[int] = None,
    ) -> Tuple[float, float]:
        """The collective cost model, decomposed into its
        ``(bandwidth_time, latency_time)`` terms — the single
        implementation :meth:`compute_net_op_time` sums (plus its
        ``real_comm_bw`` recording side effect), and the per-collective
        provenance the cost-attribution ledger records so a mispredicted
        collective can be triaged to the wire rate vs the hop/launch
        latency model. Side-effect free."""
        assert op in NET_OPS, op
        n = path.group_size if comm_num is None else comm_num
        if n <= 1 or size_bytes <= 0 or not path.spans:
            return 0.0, 0.0
        spans = path.spans

        def stage_bw(span: Span) -> float:
            spec = self._op_spec(span, op)
            return span.gbps * 1e9 * spec.efficient_factor

        def stage_lat(span: Span, hops: float) -> float:
            spec = self._op_spec(span, op)
            return (span.latency_us * hops + spec.latency_us) * 1e-6

        bw_t = lat_t = 0.0
        if op in ("all_gather", "reduce_scatter", "all_reduce"):
            phases = 2 if op == "all_reduce" else 1
            # hierarchical AG: volume per chip grows axis by axis
            held = size_bytes / n
            for span in spans:
                recv = held * (span.extent - 1)
                bw_t += recv / stage_bw(span)
                lat_t += stage_lat(span, span.extent - 1)
                held *= span.extent
            bw_t *= phases
            lat_t *= phases
        elif op == "all2all":
            # each chip holds size/n and re-shards it along every axis in
            # turn; a ring a2a of per-chip volume v over e chips costs
            # ~v*e/4 / bw (bisection-limited -> sqrt(n) scaling on a 2D
            # torus via the hierarchical decomposition)
            local = size_bytes / n
            for span in spans:
                if span.kind in SWITCHED_KINDS:
                    # behind a switch: each member keeps 1/e of its v and
                    # sends the other (e-1)/e, v/e to each peer, while it
                    # receives as much. Every pair's traffic rides the two
                    # members' own links through a non-blocking switch, so
                    # no link carries another pair's bytes and the e-1
                    # transfers share only the member's link: v*(e-1)/e /
                    # bw, one switch hop away from every peer
                    bw_t += (local * (span.extent - 1) / span.extent) / stage_bw(span)
                    lat_t += stage_lat(span, 1.0)
                    continue
                bw_t += (local * span.extent / 4.0) / stage_bw(span)
                lat_t += stage_lat(span, span.extent / 2.0)
        elif op == "p2p":
            # neighbour transfer rides one link direction
            span = spans[0]
            spec = self._op_spec(span, op)
            link = (span.gbps / (2.0 if span.wrap else 1.0)) * 1e9
            bw_t = size_bytes / (link * spec.efficient_factor)
            lat_t = stage_lat(span, 1.0)
        return bw_t, lat_t

    def net_op_coeffs(
        self, op: str, path: CommPath, comm_num: Optional[int] = None
    ) -> Tuple[float, float]:
        """Linear-cost coefficients of a collective over ``path``:
        ``(bw_per_byte, lat_seconds)`` such that
        ``compute_net_op_terms(op, size, path)`` equals
        ``(bw_per_byte * size, lat_seconds)`` up to float rounding (the
        bandwidth term of the hierarchical ring model is proportional to
        the tensor size; the latency term is size-independent). Side-effect free —
        the batched sweep kernel (``search/batched.py``) lowers each
        (dim, op) pair to these two numbers once per layout and costs
        whole candidate batches with one multiply-add."""
        bw_t, lat_t = self.compute_net_op_terms(op, 1.0, path, comm_num)
        return bw_t, lat_t

    # ----------------------------------------------------------------------
    # Cost primitive (d): roofline combiner
    # (reference ``compute_end2end_time`` config.py:1019-1035)
    # ----------------------------------------------------------------------
    def compute_end2end_time(self, comp_time: float, mem_time: float) -> float:
        if self.accelerator.mode == "compute_only":
            return comp_time
        return max(comp_time, mem_time)


# --------------------------------------------------------------------------
# Config registry
# --------------------------------------------------------------------------

#: this package's own configs (the CUDA system JSONs)
_PACKAGE_CONFIG_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "configs"
)
#: the repository's configs, read as data (model JSONs, TPU systems)
_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "configs")


def _registry(kind: str) -> Dict[str, str]:
    out = {}
    # explicit env override wins over the package tree, the repository
    # tree and the cwd fallback
    roots = []
    env_root = os.environ.get("SIMUMAX_TPU_TORCH_CONFIG_ROOT")
    if env_root:
        roots.append(os.path.join(env_root, kind))
    roots.append(os.path.join(_PACKAGE_CONFIG_ROOT, kind))
    roots.append(os.path.join(_CONFIG_ROOT, kind))
    roots.append(os.path.join(os.getcwd(), "configs", kind))
    for root in roots:
        if os.path.isdir(root):
            for fn in sorted(os.listdir(root)):
                if fn.endswith(".json"):
                    out.setdefault(fn[:-5], os.path.join(root, fn))
    return out


def get_model_config(name: str) -> ModelConfig:
    reg = _registry("models")
    if name not in reg:
        raise UnknownConfigError("model", name, available=reg)
    return ModelConfig.init_from_config_file(reg[name])


def get_strategy_config(name: str) -> StrategyConfig:
    reg = _registry("strategy")
    if name not in reg:
        raise UnknownConfigError("strategy", name, available=reg)
    return StrategyConfig.init_from_config_file(reg[name])


def get_system_config(name: str) -> SystemConfig:
    reg = _registry("system")
    if name not in reg:
        raise UnknownConfigError("system", name, available=reg)
    return SystemConfig.init_from_config_file(reg[name])


def list_configs() -> Dict[str, List[str]]:
    return {k: sorted(_registry(k)) for k in ("models", "strategy", "system")}

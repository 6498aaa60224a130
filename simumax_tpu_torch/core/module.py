"""MetaModule framework (L2): the "nn.Module of the simulator".

Reference: ``simumax/core/base_struct.py:233-1204`` (``MetaModule`` child
auto-registration, ``__call__`` protocol, ``_comp_leaf_*`` template
methods, recompute segment marking, hooks, annotated ``__repr__``).

Redesign notes (TPU-first):
* collectives are declared by leaves as :class:`CollectiveCall` records on
  a named parallel dim; the framework costs them over the dim's
  :class:`CommPath` (ICI torus spans / DCN) — there is no per-leaf NCCL
  plumbing;
* the same declarations later drive the discrete-event simulator, so leaf
  ops carry no job-construction code of their own.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

from simumax_tpu_torch.core.config import ModelConfig, StrategyConfig, SystemConfig
from simumax_tpu_torch.core.records import (
    ActivationInfo,
    CollectiveCall,
    ComputeInfo,
    CostInfo,
    ParamInfo,
    PathDebugContext,
    RecomputeStatus,
)
from simumax_tpu_torch.core.tensor import TensorSpec

TensorOrTuple = Union[TensorSpec, Tuple[TensorSpec, ...]]


class BuildContext:
    """Everything a module needs to cost itself: the three configs plus the
    mesh placement of every parallel dim (built by ``PerfLLM.analysis_net``,
    reference ``perf_llm.py:369-474``)."""

    def __init__(
        self,
        strategy: StrategyConfig,
        model: ModelConfig,
        system: SystemConfig,
        paths: Optional[Dict[str, object]] = None,
    ):
        self.strategy = strategy
        self.model = model
        self.system = system
        self.paths = paths or {}
        self.debug = PathDebugContext()
        self.graph = None  # Optional[GraphBuilder], set by PerfLLM
        #: identical-layer dedup fast path (SIMU_NO_LAYER_DEDUP=1 to
        #: force full evaluation, e.g. for an A/B check)
        self.layer_dedup = os.environ.get(
            "SIMU_NO_LAYER_DEDUP", ""
        ).lower() not in ("1", "true", "yes", "on")

    def path(self, dim: str):
        if dim not in self.paths:
            raise KeyError(f"no CommPath placed for dim {dim!r}")
        return self.paths[dim]


class MetaModule:
    """Base symbolic module. Subclasses either override :meth:`forward`
    (composites — children are auto-registered on attribute assignment) or
    the leaf template methods (ops)."""

    is_leaf = False
    #: op-family tag for the cost-attribution ledger (``observe/ledger``):
    #: leaf classes override at class level (gemm / attention / norm /
    #: moe_dispatch / ...); composites may re-tag child instances (e.g.
    #: MLA marks its up-projections so the ``mla_up_proj`` recompute
    #: knob's target is visible in ``explain`` output)
    op_category = "other"

    def __init__(self, ctx: BuildContext, name: str = ""):
        # direct __dict__ writes: none of these values are MetaModules,
        # so routing them through the child-registering __setattr__ is
        # pure interpreter overhead — at sweep scale module construction
        # is a measured hot path (docs/search_throughput.md)
        d = self.__dict__
        d["ctx"] = ctx
        d["name"] = name or type(self).__name__
        d["_children"] = []
        d["parent"] = None
        # recompute wiring
        d["recompute"] = False  # whole-subtree checkpoint flag
        d["recompute_status"] = RecomputeStatus.NONE
        d["in_recompute"] = False
        #: variance-tail leaf (reference ``base_struct.py:314,335-337``):
        #: last leaf of its checkpoint segment; its fwd replay is skipped
        #: under ``recompute_variance`` because its backward consumes the
        #: recomputed *input*, not its own output.
        d["variance_tail"] = False
        # filled by __call__
        d["inputs"] = ()
        d["outputs"] = ()
        d["compute_info"] = ComputeInfo()
        d["act_info"] = ActivationInfo()
        d["raw_act_info"] = ActivationInfo()
        d["param_info"] = ParamInfo()
        d["cost_info"] = CostInfo()
        d["collective_calls"] = []
        d["_called"] = False
        d["_pre_hooks"] = []
        d["_post_hooks"] = []

    # -- structure ---------------------------------------------------------
    _NON_CHILD_ATTRS = ("parent", "recompute_segment")

    def __setattr__(self, key, value):
        if isinstance(value, MetaModule) and key not in self._NON_CHILD_ATTRS:
            value.parent = self
            if not value.name or value.name == type(value).__name__:
                value.name = key
            children = self.__dict__.setdefault("_children", [])
            children.append((key, value))
        super().__setattr__(key, value)

    def add_child(self, name: str, module: "MetaModule") -> "MetaModule":
        module.parent = self
        module.name = name
        self._children.append((name, module))
        return module

    def children(self) -> Iterator["MetaModule"]:
        for _, c in self._children:
            yield c

    def leaves(self) -> Iterator["MetaModule"]:
        if self.is_leaf:
            yield self
        else:
            for c in self.children():
                yield from c.leaves()

    def called_leaves(self) -> List["MetaModule"]:
        """Leaves in actual forward call order."""
        return [l for l in self.leaves() if l._called]

    def path_name(self) -> str:
        parts = [self.name]
        p = self.parent
        while p is not None:
            parts.append(p.name)
            p = p.parent
        return ".".join(reversed(parts))

    # -- hooks -------------------------------------------------------------
    def register_forward_pre_hook(self, fn: Callable):
        self._pre_hooks.append(fn)

    def register_forward_hook(self, fn: Callable):
        self._post_hooks.append(fn)

    # -- call protocol -----------------------------------------------------
    def __call__(self, *ins: TensorSpec) -> TensorOrTuple:
        for h in self._pre_hooks:
            h(self, ins)
        self.inputs = tuple(i for i in ins if isinstance(i, TensorSpec))
        if self.is_leaf:
            outs = self.forward_spec(*ins)
            self.outputs = outs if isinstance(outs, tuple) else (outs,)
            self._comp_leaf_info()
        else:
            outs = self.forward(*ins)
            self.outputs = outs if isinstance(outs, tuple) else (outs,)
            self._post_forward()
            self._aggregate()
        self._called = True
        if self.is_leaf and self.ctx.graph is not None:
            self.ctx.graph.add(self)
        for h in self._post_hooks:
            h(self, ins, outs)
        self.ctx.debug.record(self.path_name(), self.cost_info, self.compute_info)
        return outs

    # -- composite default -------------------------------------------------
    def forward(self, x: TensorSpec) -> TensorSpec:
        for c in self.children():
            x = c(x)
        return x

    def adopt_call_from(self, rep: "MetaModule", *ins: TensorSpec):
        """Mark this module called with the same symbolic results as
        ``rep`` — a structurally identical, already-called sibling —
        without re-evaluating any leaf cost model (the search-loop
        layer-dedup fast path; reference memoizes chunk/unit profiles
        the same way, ``perf_llm.py:69-252,837-1379``).

        Info objects are SHARED with ``rep`` (read-only after the call);
        the module tree itself stays distinct, so replays and the event
        simulator that key on leaf identity still work.
        """
        assert type(self) is type(rep) and len(self._children) == len(
            rep._children
        ), f"adopt_call_from: structure mismatch at {self.path_name()}"
        # direct __dict__ writes (nothing here is a child module): this
        # adoption runs once per deduped layer and measurably bounds
        # sweep-verification throughput
        d = self.__dict__
        d["inputs"] = tuple(i for i in ins if isinstance(i, TensorSpec))
        d["outputs"] = rep.outputs
        d["compute_info"] = rep.compute_info
        d["act_info"] = rep.act_info
        d["raw_act_info"] = rep.raw_act_info
        d["param_info"] = rep.param_info
        d["cost_info"] = rep.cost_info
        d["collective_calls"] = rep.collective_calls
        for (_, mine), (_, theirs) in zip(self._children, rep._children):
            if theirs._called:
                mine.adopt_call_from(theirs, *theirs.inputs)
        d["_called"] = True
        return self.outputs if len(self.outputs) != 1 else self.outputs[0]

    def _post_forward(self):
        """Composite hook running after forward() but before child-info
        aggregation — the place to re-apportion overlap between
        children (e.g. bound async-CP a2a hiding by the attention
        compute)."""

    def expose_unhidden(self, leaves, phase: str, budget: float,
                        dims=None):
        """Move the portion of the given leaves' hidden collective time
        that exceeds ``budget`` back onto the critical path,
        proportionally per call (optionally only calls on ``dims``).
        Keeps the leaf CostInfo and the CollectiveCall exposed_time
        consistent (the simulator replays the same numbers)."""
        calls = [
            c
            for l in leaves
            for c in l.collective_calls
            if c.phase == phase and c.time > c.exposed_time
            and (dims is None or c.dim in dims)
        ]
        hidden = sum(c.time - c.exposed_time for c in calls)
        extra = max(0.0, hidden - budget)
        if extra <= 0 or hidden <= 0:
            return
        for l in leaves:
            for c in l.collective_calls:
                if (c.phase != phase or c.time <= c.exposed_time
                        or (dims is not None and c.dim not in dims)):
                    continue
                share = extra * (c.time - c.exposed_time) / hidden
                c.exposed_time += share
                l.cost_info.net_exposed.add(phase, share)
                l.cost_info.net_hidden.add(phase, -share)
                # a recomputed leaf replays its fwd (incl. exposed comm)
                if phase == "fwd" and l.in_recompute:
                    l.cost_info.recompute_time += share

    def reaggregate(self):
        """Recompute composite sums bottom-up after a _post_forward hook
        mutated descendant leaf infos (e.g. overlap re-exposure)."""
        if self.is_leaf:
            return
        for c in self.children():
            if c._called:
                c.reaggregate()
        self._aggregate()

    def _aggregate(self):
        kids = [c for c in self.children() if c._called]
        self.compute_info = sum((c.compute_info for c in kids), ComputeInfo())
        self.act_info = sum((c.act_info for c in kids), ActivationInfo())
        self.raw_act_info = sum((c.raw_act_info for c in kids), ActivationInfo())
        self.param_info = sum((c.param_info for c in kids), ParamInfo())
        self.cost_info = sum((c.cost_info for c in kids), CostInfo())
        self.collective_calls = [cc for c in kids for cc in c.collective_calls]
        if self.inputs:
            self.act_info.input_bytes = sum(t.bytes for t in self.inputs)
        if self.outputs:
            self.act_info.output_bytes = sum(t.bytes for t in self.outputs)

    # -- leaf template methods (override in ops) ---------------------------
    def forward_spec(self, *ins: TensorSpec) -> TensorOrTuple:
        raise NotImplementedError

    def op_flops(self) -> Dict[str, float]:
        return {}

    def op_accessed(self) -> Dict[str, float]:
        return {}

    def bw_key(self, phase: str) -> str:  # HBM bandwidth class per phase
        return "default"

    def comp_key(self, phase: str) -> Tuple[str, Optional[str]]:
        """(op efficiency table, canonical shape key) for this phase."""
        return ("default", None)

    def activation_info(self) -> ActivationInfo:
        return ActivationInfo()

    def extra_param_info(self) -> ParamInfo:
        return ParamInfo()

    def collectives(self) -> List[CollectiveCall]:
        return []

    # -- parameter accounting helper ---------------------------------------
    def make_param_info(self, numel: float, is_moe: bool = False) -> ParamInfo:
        """Parameter-memory accounting, by optimizer style.

        "megatron": bf16 weight + persistent fp32 main grad
        (``use_fp32_accum_grad``) + fp32 master + 2 moments (reference
        e.g. ``dense_module.py:448-454``).

        "functional": what XLA emits for a functional JAX train step
        with donation — no fp32 master copy (params upcast per leaf
        inside the fused adam), no persistent grad buffer (the per-leaf
        update is scheduled into the backward, so only one leaf's grad
        is in flight — validated against ``compiled.memory_analysis()``
        on TPU v5e, see docs/memory_validation.md); state = 2 fp32
        moments.
        """
        st = self.ctx.strategy
        if numel <= 0:
            return ParamInfo()
        w = numel * st.element_size
        if st.optimizer_style == "functional":
            g = 0.0
            state = numel * 8.0  # fp32 exp_avg + exp_avg_sq
        else:
            g = numel * st.grad_element_size
            state = numel * 12.0  # fp32 master + exp_avg + exp_avg_sq
        shard = st.edp_size if is_moe else st.dp_size * st.cp_size
        if st.zero_state >= 1:
            state = state / max(1, shard)
        if st.zero_state >= 2:  # grads live sharded between uses
            g = g / max(1, shard)
        if st.zero_state >= 3:  # FSDP: parameters sharded too
            w = w / max(1, shard)
        if is_moe:
            return ParamInfo(
                moe_weight_bytes=w, moe_grad_bytes=g, moe_state_bytes=state,
                moe_numel=numel,
            )
        return ParamInfo(
            weight_bytes=w, grad_bytes=g, state_bytes=state, dense_numel=numel
        )

    # -- leaf accounting ----------------------------------------------------
    def _comp_leaf_info(self):
        sysc: SystemConfig = self.ctx.system
        flops = self.op_flops()
        accessed = self.op_accessed()
        self.compute_info = ComputeInfo(
            fwd_flops=flops.get("fwd", 0.0),
            bwd_act_flops=flops.get("bwd_act", 0.0),
            bwd_w_flops=flops.get("bwd_w", 0.0),
            fwd_accessed=accessed.get("fwd", 0.0),
            bwd_act_accessed=accessed.get("bwd_act", 0.0),
            bwd_w_accessed=accessed.get("bwd_w", 0.0),
        )
        self.param_info = self.extra_param_info()
        info = self.activation_info()
        info.input_bytes = sum(t.bytes for t in self.inputs)
        info.output_bytes = sum(t.bytes for t in self.outputs)
        self.raw_act_info = info
        self.act_info = ActivationInfo(**vars(info))
        self.collective_calls = list(self.collectives())

        cost = CostInfo()
        for phase in ("fwd", "bwd_act", "bwd_w"):
            f = getattr(self.compute_info, f"{phase}_flops")
            b = getattr(self.compute_info, f"{phase}_accessed")
            if f <= 0 and b <= 0:
                continue
            op_key, shape_key = self.comp_key(phase)
            comp_t = sysc.compute_op_accuracy_time(op_key, f, shape_key)
            mem_t = sysc.compute_mem_access_time(b, self.bw_key(phase)) if b > 0 else 0.0
            t = sysc.compute_end2end_time(comp_t, mem_t)
            cost.compute.add(phase, t)
            # HBM is busy for mem_t within the rooflined time (capped:
            # compute_only mode drops the mem term from t entirely);
            # compute - mem_bound per phase is the HBM-idle slack
            cost.mem_bound.add(phase, min(mem_t, t))
        for call in self.collective_calls:
            path = self.ctx.path(call.dim)
            call.time = sysc.compute_net_op_time(call.op, call.size_bytes, path)
            call.exposed_time = call.time if call.exposed else 0.0
            cost.net_exposed.add(call.phase, call.exposed_time)
            cost.net_hidden.add(call.phase, call.time - call.exposed_time)
        # recompute: the fwd work is replayed before bwd_act; a
        # variance-tail leaf skips the replay entirely (reference
        # ``base_struct.py:750-756,854-858``)
        if self.in_recompute:
            cost.recompute_time = (
                0.0 if self.variance_tail
                else cost.compute.fwd + cost.net_exposed.fwd
            )
            # effective steady-state cache: only the segment input survives
            self.act_info.cache_bytes = 0.0
            if self.recompute_status == RecomputeStatus.FIRST:
                self.act_info.cache_bytes = self.act_info.input_bytes
        self.cost_info = cost

    # -- recompute marking (reference ``base_struct.py:499-529``) ----------
    def mark_recompute(self, variance: bool = None):
        """Mark this subtree as one checkpointed segment. Leaves already
        claimed by another segment (e.g. sdp-only inside a checkpointed
        attention) keep their original segment.

        ``variance`` controls THIS segment's tail model (reference
        ``set_variance_node`` base_struct.py:335); ``None`` falls back to
        the strategy's global ``recompute_variance`` — per-segment so a
        megatron tail module (layernorm/moe_act/mla_up_proj) does not
        make unrelated segments free."""
        self.recompute = True
        leaves = [l for l in self.leaves() if not l.in_recompute]
        for i, leaf in enumerate(leaves):
            leaf.in_recompute = True
            leaf.recompute_segment = self
            if i == 0:
                leaf.recompute_status = RecomputeStatus.FIRST
            elif i == len(leaves) - 1:
                leaf.recompute_status = RecomputeStatus.LAST
            else:
                leaf.recompute_status = RecomputeStatus.MIDDLE
        if variance is None:
            variance = self.ctx.strategy.recompute.variance
        if leaves and variance:
            leaves[-1].variance_tail = True

    # -- repr ---------------------------------------------------------------
    def __repr__(self):
        lines = [self._repr_line()]
        for _, c in self._children:
            child_repr = repr(c)
            lines.extend("  " + l for l in child_repr.splitlines())
        return "\n".join(lines)

    def _repr_line(self):
        extra = ""
        if self._called:
            extra = (
                f" fwd={self.cost_info.fwd_time*1e3:.3f}ms"
                f" bwd={self.cost_info.bwd_time*1e3:.3f}ms"
                f" cache={self.act_info.cache_bytes/2**20:.1f}MiB"
            )
        rc = " [ckpt]" if self.recompute or self.in_recompute else ""
        return f"{self.name}({type(self).__name__}){rc}{extra}"


class LeafModule(MetaModule):
    is_leaf = True


class GemmBase(LeafModule):
    """Shared GEMM shape-key bookkeeping (reference ``LinearBase``
    ``base_struct.py:1136-1154``): canonical ``b=,m=,k=,n=,layout=,...``
    efficiency-lookup keys per backprop stage. On TPU the layout tag
    records the contraction structure XLA sees, and the low-precision path
    is int8 (native MXU) rather than fp8."""

    op_category = "gemm"

    def __init__(self, ctx, name="", quantized: bool = False):
        super().__init__(ctx, name)
        self.quantized = quantized and ctx.strategy.fp8

    @property
    def matmul_op_key(self) -> str:
        if self.quantized:
            return f"{self.ctx.strategy.quant_dtype}_matmul"
        return "matmul"

    def gemm_mnk(self, phase: str) -> Tuple[int, int, int, int]:
        """Return (b, m, k, n) of the GEMM executed in ``phase``."""
        raise NotImplementedError

    @staticmethod
    def render_gemm_shape_key(b: int, m: int, k: int, n: int, phase: str,
                              dtype: str, fp32_accum: bool) -> str:
        """The canonical matmul efficiency-table key for one (shape,
        phase). Static single source shared with the batched sweep
        kernel (``search/batched.py``), so a calibrated per-shape table
        can never be hit by one engine and missed by the other."""
        layout = {"fwd": "NN", "bwd_act": "NT", "bwd_w": "TN"}[phase]
        acc = phase == "bwd_w" and fp32_accum
        out_dtype = "fp32" if acc else dtype
        return (
            f"b={b}, m={m}, k={k}, n={n}, layout={layout}, "
            f"accumulate={acc}, out_dtype={out_dtype}"
        )

    def gemm_shape_key(self, phase: str) -> str:
        b, m, k, n = self.gemm_mnk(phase)
        return self.render_gemm_shape_key(
            b, m, k, n, phase, self.ctx.strategy.dtype,
            self.ctx.strategy.use_fp32_accum_grad,
        )

    def comp_key(self, phase: str):
        return (self.matmul_op_key, self.gemm_shape_key(phase))

    def quant_cast_bytes(self, phase: str) -> float:
        """Extra HBM traffic of quantizing the GEMM input for the
        low-precision MXU path (reference models this via explicit
        Quantizer wrapper modules, ``dense_module.py:2365-2453``):
        read the bf16 activation + write its int8 copy."""
        if not self.quantized:
            return 0.0
        _, m, k, _ = self.gemm_mnk(phase)
        e = self.ctx.strategy.element_size
        q = 1.0  # int8 / fp8 byte
        return m * k * (e + q)

"""Batched vectorized cost kernel (L7): score whole candidate-strategy
batches per evaluation instead of walking a Python module graph per cell.

The scalar path (``PerfLLM`` build -> ``estimate()`` -> ``analysis_*``)
re-constructs and re-walks a ``MetaModule`` tree for every candidate; at
sweep scale that object-protocol overhead dominates (ROADMAP item 1,
``results/bench_sweep_baseline.json``). SimuMax's static-analytical
design makes every number the sweep ranks on pure arithmetic over
shapes, so this module *lowers* the scalar model into numpy array
programs whose leading axis is the candidate batch:

* per-op roofline times — the leaf tables of ``models/{dense,moe,mla}``
  (FLOPs / HBM bytes / efficiency-table keys per backprop phase)
  re-derived in closed form, with the canonical shape keys rendered by
  the SAME static renderers the scalar ops use
  (``GemmBase.render_gemm_shape_key`` etc.), so calibrated per-shape
  tables hit identically;
* collective costs — each (dim, op) pair lowered once per layout to the
  ``(bw_per_byte, latency)`` coefficients of
  ``SystemConfig.net_op_coeffs`` and costed with one multiply-add per
  candidate;
* activation-peak replay — ``LLMModel.activation_events`` mirrored per
  *block kind* (plain / recomputed x dense / MoE) and composed across a
  stage's layer runs in closed form instead of walking every layer; at
  vp>1 the per-chunk compositions feed the SAME interleaved-order
  schedule-position replay the scalar path folds
  (``perf.interleaved_stage_peak``);
* the pipeline replays — evaluated with lean exact re-implementations
  of ``PerfLLM.calculate_1f1b_bubble`` / ``calculate_interleaved_
  schedule``'s recurrences (:func:`fold_1f1b` / :func:`fold_interleaved`
  — the replays' values are order-independent max/+ algebra, so one
  pass over a cached topological order reproduces them bit-for-bit),
  optionally folded on the card by a CUDA kernel (``fold_schedule``,
  ``csrc/fold.cu``, one warp a candidate walking the op table a
  dependence level at a time, float64) that is
  **bit-identical** to the numpy fold — the numpy path remains the
  no-card fallback.

The scalar path stays the **oracle**: the sweep's ``engine="batched"``
mode re-verifies its top-k rows with ``evaluate_strategy`` (see
``searcher.py``), and the JAX package's ``tests/test_batched.py`` pins
batched == scalar
within 1e-9 for every non-pruned candidate across the
dense/MoE/MLA x pp/vp x cp x fp8/dropout/dispatch_probs/offload x
recompute-family/variance x ZeRO parity grid.

Since PR 11 the kernel lowers every strategy family the sweep axes can
produce; the tiny residual surface of :func:`check_supported` raises
:class:`UnsupportedBatched` and the caller falls back to the scalar
path per cell with counted telemetry (documented in the JAX package's
``docs/search.md``, "Fallback contract").

Copy of the JAX package's ``search/batched.py`` with its import paths
changed and these differences:

* the attention backend is the port's: ``sdp_backend="cuda"`` is gated
  by ``core.utils.cuda_flash_supported`` (the JAX package's ``"pallas"``
  by its Pallas shape gate), so the batched rows reject the families the
  port's scalar path rejects;
* the fold backends are ``"numpy"``, ``"cuda"`` and ``"auto"``: the
  JAX package's jitted ``lax.scan`` folds (``_jit_fold_1f1b``,
  ``_jit_fold_interleaved``) become one host function,
  :func:`_fold_members_cuda`, around the CUDA kernel, with each shape's
  op table (:func:`fold_table`) sorted by dependence level
  (:func:`fold_levels`) and kept on the card; ``JIT_GROUP_MIN`` and
  ``FOLD_BATCH_JIT_MIN`` keep their values and names;
* :class:`BatchedScorer` takes ``device`` (``"cuda"`` by default):
  ``"cuda"`` and ``"auto"`` launch the kernel and refuse to start without
  a card; ``device="cpu"`` runs the kernel's plain version wherever the
  kernel would run, so the CPU walks the same dispatch;
* an error of the kernel (``torchref.kernels.KernelError``) is never
  turned into a must-evaluate screen slot: it stops the search.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simumax_tpu_torch.core.config import (
    GiB,
    ModelConfig,
    StrategyConfig,
    SystemConfig,
)
from simumax_tpu_torch.core.errors import FeasibilityError, SimulationError
from simumax_tpu_torch.core.module import GemmBase
from simumax_tpu_torch.models.dense import CoreAttention
from simumax_tpu_torch.models.moe import GroupLinearBase
from simumax_tpu_torch.parallel.pipeline import (
    interleaved_order,
    one_f_one_b_order,
)
from simumax_tpu_torch.perf import place_strategy_paths, stage_layer_split
from simumax_tpu_torch.search.prune import clone_strategy


class UnsupportedBatched(Exception):
    """The batched kernel does not model this configuration; the caller
    falls back to the scalar oracle for the cell."""


# --------------------------------------------------------------------------
# Support surface
# --------------------------------------------------------------------------


def check_supported(st: StrategyConfig, model: ModelConfig,
                    system: SystemConfig) -> None:
    """Raise :class:`UnsupportedBatched` for the few residual
    configurations the kernel routes back to the scalar oracle. Since
    PR 11 every strategy family (vp>1, cp>1, fp8, dropout,
    dispatch_probs, offload, moe_act/mla_up recompute, variance tails,
    cuda sdp, DP-comm overlap) is lowered; what remains — each
    justified in the JAX package's docs/search.md — is:

    * unknown recompute granularities (a new granularity must be lowered
      deliberately, not silently treated as one of the known three);
    * unknown model/attention types (same reasoning — the model universe
      is part of the lowering contract);
    * swiglu fan shapes the scalar walk rejects with an
      ``AssertionError``: the fallback makes both engines quarantine the
      cell identically instead of the kernel scoring an impossible
      shape.
    """
    rc = st.recompute

    def need(cond: bool, what: str):
        if not cond:
            raise UnsupportedBatched(what)

    need(rc.granularity in ("none", "selective", "full_block"),
         f"recompute granularity {rc.granularity!r}")
    need(model.model_type in ("dense", "moe"),
         f"model type {model.model_type!r}")
    need(model.attention_type in ("gqa", "mla"),
         f"attention type {model.attention_type!r}")
    # shapes the scalar walk would reject with an AssertionError
    # (quarantined cell): fall back so both engines quarantine alike
    if model.use_swiglu:
        tp = st.tp_size
        fan = 2 * model.intermediate_size
        has_dense_mlp = model.model_type == "dense" or \
            model.dense_layer_num > 0
        need(not has_dense_mlp or (fan // tp) % 2 == 0,
             "swiglu fan not splittable under tp")
        if model.model_type == "moe":
            efan = 2 * model.moe_ffn_hidden_size
            need((efan // max(1, st.etp_size)) % 2 == 0,
                 "moe swiglu fan not splittable under etp")
            if model.moe_shared_expert_intermediate_size:
                sfan = 2 * model.moe_shared_expert_intermediate_size
                need((sfan // tp) % 2 == 0,
                     "shared-expert swiglu fan not splittable under tp")


# --------------------------------------------------------------------------
# Family validity: the ConfigError surface of configure()+sanity checks
# --------------------------------------------------------------------------


def _family_invalid_reason(st: StrategyConfig, model: ModelConfig,
                           system: SystemConfig) -> Optional[str]:
    """Mirror of the candidate-dependent ``ConfigError`` guards a scalar
    ``evaluate_strategy`` hits (strategy ``sanity_check`` + PerfBase
    ``_cross_sanity_check``): a non-None reason means every batch split
    of this family evaluates to ``row = None`` in the scalar path."""
    m = model
    rc = st.recompute
    if st.world_size <= 0:
        return "world_size"
    if st.world_size % (st.tp_size * st.cp_size * st.pp_size):
        return "world % tp*cp*pp"
    if st.dp_size < 1:
        return "dp < 1"
    if st.world_size % (st.etp_size * st.ep_size * st.pp_size):
        return "world % etp*ep*pp"
    if st.etp_size > st.tp_size or st.tp_size % st.etp_size:
        return "etp vs tp"
    if st.enable_sequence_parallel and \
            st.seq_len % (st.tp_size * st.cp_size):
        return "seq % tp*cp"
    if st.world_size > system.total_chips:
        return "world > chips"
    head_shard = st.tp_size
    if st.cp_size > 1 and st.cp_comm_type == "a2a":
        head_shard *= st.cp_size  # Ulysses scatters heads over cp too
    if m.head_num % head_shard:
        return "head_num % tp*cp"
    if st.cp_size > 1 and st.cp_comm_type == "a2a" \
            and m.attention_type != "mla":
        # ContextParallelA2A._replication of the kv heads
        kvl = max(m.kv_head_num // st.tp_size, 1)
        if kvl >= st.cp_size:
            if kvl % st.cp_size:
                return "kv heads % cp"
        elif st.cp_size % kvl:
            return "cp % kv heads"
    if m.model_type == "moe" and m.expert_num % st.ep_size:
        return "expert_num % ep"
    # candidate-dependent ConfigError guards of sanity_check /
    # _cross_sanity_check the sweep axes can reach
    if st.vp_size > 1:
        if st.pp_size <= 1:
            return "vpp needs pp > 1"
        if st.vpp_group_size < st.pp_size:
            return "vpp group < pp"
    if st.use_math_sdp and st.use_flash_sdp:
        return "math+flash sdp"
    if st.dispatch_probs and m.model_type == "moe" and not m.use_swiglu:
        return "dispatch_probs needs swiglu"
    if rc.mla_up_proj_recompute and m.attention_type != "mla":
        return "mla_up recompute on non-mla"
    if rc.moe_act_recompute and m.model_type != "moe":
        return "moe_act recompute on non-moe"
    if st.offload_groupgemm_col_inputs and st.enable_recompute \
            and st.recompute_granularity in ("full_block",
                                             "full_recompute"):
        return "offload + full_block recompute"
    if st.fp8:
        needed = [f"{st.quant_dtype}_matmul"]
        if m.model_type == "moe" and st.group_linear_mode == "parallel":
            needed.append(f"{st.quant_dtype}_group_matmul")
        for op_key in needed:
            if op_key not in system.accelerator.op:
                return f"no {op_key} table"
    if st.sdp_backend == "cuda":
        if not st.use_flash_sdp:
            return "cuda needs flash sdp"
        from simumax_tpu_torch.core.utils import cuda_flash_supported

        if st.cp_size > 1 and st.cp_comm_type == "all_gather":
            sq_attn, skv_attn = st.seq_len // st.cp_size, st.seq_len
        else:
            sq_attn = skv_attn = st.seq_len
        if not cuda_flash_supported(sq_attn, skv_attn, m.head_size):
            return "cuda shape unsupported"
    if st.mesh_order != "tp,cp,dp,pp" and st.ep_size != 1:
        return "mesh_order + ep"
    # layer split over virtual stages (PerfBase._cross_sanity_check)
    total_stages = st.pp_size * st.vp_size
    layers = m.layer_num
    if st.num_layers_in_first_pipeline_stage:
        layers -= st.num_layers_in_first_pipeline_stage
    if st.num_layers_in_last_pipeline_stage:
        layers -= st.num_layers_in_last_pipeline_stage
    rem = total_stages
    if st.num_layers_in_first_pipeline_stage:
        rem -= 1
    if st.num_layers_in_last_pipeline_stage:
        rem -= 1
    eff = layers + (
        1 if st.account_for_embedding_in_pipeline_split else 0
    ) + (1 if st.account_for_loss_in_pipeline_split else 0)
    if eff % max(rem, 1):
        return "layer split"
    return None


# --------------------------------------------------------------------------
# Lean exact 1F1B replay
# --------------------------------------------------------------------------

_ORDER_CACHE: Dict[Tuple[int, int], list] = {}


def _flat_1f1b_order(pp: int, mbc: int) -> list:
    """One dependency-consistent flat op order for the non-interleaved
    1F1B replay, computed once per (pp, mbc) and cached. Readiness in
    the replay's retry loop is structural (an op waits only for another
    op to have been *processed*), never time-based, so a single valid
    topological order serves every (fwd, bwd, p2p) instance."""
    key = (pp, mbc)
    flat = _ORDER_CACHE.get(key)
    if flat is not None:
        return flat
    orders = [one_f_one_b_order(pp, s, mbc) for s in range(pp)]
    done = [[[False] * mbc, [False] * mbc] for _ in range(pp)]
    idx = [0] * pp
    flat = []
    remaining = 2 * pp * mbc
    while remaining:
        progressed = False
        for s in range(pp):
            o = orders[s]
            while idx[s] < len(o):
                kind, i = o[idx[s]]
                if kind == "F":
                    if s > 0 and not done[s - 1][0][i]:
                        break
                    done[s][0][i] = True
                    flat.append((s, 0, i))
                else:
                    if s < pp - 1 and not done[s + 1][1][i]:
                        break
                    done[s][1][i] = True
                    flat.append((s, 1, i))
                idx[s] += 1
                remaining -= 1
                progressed = True
        assert progressed, "1F1B schedule deadlocked (internal error)"
    if len(_ORDER_CACHE) > 64:
        _ORDER_CACHE.clear()
    _ORDER_CACHE[key] = flat
    return flat


def fold_1f1b(pp: int, mbc: int, fwd: Sequence[float],
              bwd: Sequence[float], p2p: float,
              p2p_async: bool) -> Tuple[float, List[float]]:
    """Exact lean re-implementation of the non-interleaved replay in
    ``PerfLLM.calculate_1f1b_bubble`` (pp > 1): returns
    ``(total, per_stage_end)``. The replay's values are the unique
    solution of a max-plus recurrence, so evaluation order does not
    matter; this single pass over a cached topological op order
    reproduces the scalar numbers bit-for-bit (property-tested in
    the JAX package's ``tests/test_batched.py``)."""
    flat = _flat_1f1b_order(pp, mbc)
    F = [[0.0] * mbc for _ in range(pp)]
    B = [[0.0] * mbc for _ in range(pp)]
    clock = [0.0] * pp
    blocking = 0.0 if p2p_async else p2p
    last = pp - 1
    for s, kind, i in flat:
        c = clock[s]
        if kind == 0:
            if s == 0:
                start = c
            else:
                dep = F[s - 1][i] + p2p
                start = c if c >= dep else dep
            end = start + fwd[s]
            F[s][i] = end
            if s < last:
                end += blocking
        else:
            if s == last:
                start = c
            else:
                dep = B[s + 1][i] + p2p
                start = c if c >= dep else dep
            end = start + bwd[s]
            B[s][i] = end
            if s > 0:
                end += blocking
        clock[s] = end
    return max(clock), clock


_IORDER_CACHE: Dict[Tuple[int, int, int, int], list] = {}


def _flat_interleaved_order(pp: int, mbc: int, vp: int,
                            group: int) -> list:
    """One dependency-consistent flat op order for the interleaved
    (VPP) replay, computed once per (pp, mbc, vp, group) and cached —
    the interleaved analog of :func:`_flat_1f1b_order`."""
    key = (pp, mbc, vp, group)
    flat = _IORDER_CACHE.get(key)
    if flat is not None:
        return flat
    orders = [interleaved_order(pp, s, mbc, vp, group)
              for s in range(pp)]
    doneF, doneB = set(), set()
    idx = [0] * pp
    flat = []
    remaining = sum(len(o) for o in orders)
    while remaining:
        progressed = False
        for s in range(pp):
            o = orders[s]
            while idx[s] < len(o):
                kind, c, mb = o[idx[s]]
                if kind == "F":
                    if s > 0 and (s - 1, c, mb) not in doneF:
                        break
                    if s == 0 and c > 0 \
                            and (pp - 1, c - 1, mb) not in doneF:
                        break
                    doneF.add((s, c, mb))
                    flat.append((s, 0, c, mb))
                else:
                    if s < pp - 1 and (s + 1, c, mb) not in doneB:
                        break
                    if s == pp - 1 and c < vp - 1 \
                            and (0, c + 1, mb) not in doneB:
                        break
                    doneB.add((s, c, mb))
                    flat.append((s, 1, c, mb))
                idx[s] += 1
                remaining -= 1
                progressed = True
        assert progressed, \
            "interleaved schedule deadlocked (internal error)"
    if len(_IORDER_CACHE) > 64:
        _IORDER_CACHE.clear()
    _IORDER_CACHE[key] = flat
    return flat


def fold_interleaved(pp: int, vp: int, mbc: int, group: int,
                     fwd, bwd, p2p: float,
                     p2p_async: bool) -> Tuple[float, List[float]]:
    """Exact lean re-implementation of the interleaved replay in
    ``PerfLLM.calculate_interleaved_schedule``: ``fwd``/``bwd`` are
    per-``[stage][chunk]`` times; returns ``(total, per_stage_end)``.
    Like :func:`fold_1f1b`, the replay's values solve a max-plus
    recurrence, so one pass over a cached topological order reproduces
    the scalar numbers bit-for-bit (fuzz-tested in
    the JAX package's ``tests/test_batched.py``)."""
    flat = _flat_interleaved_order(pp, mbc, vp, group)
    F: Dict[tuple, float] = {}
    B: Dict[tuple, float] = {}
    clock = [0.0] * pp
    blocking = 0.0 if p2p_async else p2p
    last = pp - 1
    for s, kind, c, mb in flat:
        cl = clock[s]
        if kind == 0:
            if s > 0:
                dep = F[(s - 1, c, mb)] + p2p
            elif c > 0:
                dep = F[(last, c - 1, mb)] + p2p
            else:
                dep = 0.0
            start = cl if cl >= dep else dep
            end = start + fwd[s][c]
            F[(s, c, mb)] = end
            if s < last or c < vp - 1:
                end += blocking
        else:
            if s < last:
                dep = B[(s + 1, c, mb)] + p2p
            elif c < vp - 1:
                dep = B[(0, c + 1, mb)] + p2p
            else:
                dep = 0.0  # loss chunk: ready after own fwd
            start = cl if cl >= dep else dep
            end = start + bwd[s][c]
            B[(s, c, mb)] = end
            if s > 0 or c > 0:
                end += blocking
        clock[s] = end
    return max(clock), clock


# --------------------------------------------------------------------------
# CUDA backend: the pipeline-schedule folds on the card
# --------------------------------------------------------------------------

#: minimum candidate-group size for backend="auto" to dispatch the
#: kernel: below it the launch and its copies cost more than the win
#: and the numpy fold (bit-identical — tested) stays faster
JIT_GROUP_MIN = 256

#: a shape's level-ordered op table, kept per (pp, vp, mbc, group,
#: device): shapes recur across a sweep's layouts, so each table serves
#: every family sharing it
_FOLD_TABLES: Dict[tuple, object] = {}
_FOLD_TABLES_MAX = 256


def check_fold_backend(backend: str, device: str) -> None:
    """Refuse a fold backend the machine cannot run: ``"cuda"`` and
    ``"auto"`` launch the kernel on the card unless ``device="cpu"``
    asks for its plain version; nothing falls back."""
    if backend not in ("numpy", "cuda", "auto"):
        raise ValueError(f"fold backend must be 'numpy', 'cuda' or "
                         f"'auto', got {backend!r}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    if backend == "numpy" or device == "cpu":
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"backend={backend!r} folds pipeline schedules with the "
            f"CUDA kernel and this machine has no card: pass "
            f"device=\"cpu\" for its plain PyTorch version, or "
            f"backend=\"numpy\" for the numpy fold")


def fold_table(pp: int, vp: int, mbc: int, group: int):
    """The op table of one schedule shape, int32 ``[2*pp*vp*mbc, 4]``
    in the flat order of :func:`_flat_1f1b_order` (vp == 1) or
    :func:`_flat_interleaved_order`: for each op its stage with the
    blocking flag (bit 8) and the kind (bit 9, set for a backward), its
    time row ``stage * vp + chunk``, the state slot it writes and the
    slot it waits on (-1: none). Slots index ``[F | B]`` entries
    ``kind * pp*vp*mbc + (stage*vp + chunk) * mbc + microbatch``. The
    dependencies and blocking flags are :func:`fold_interleaved`'s, which
    at vp == 1 are :func:`fold_1f1b`'s."""
    last = pp - 1
    n_half = pp * vp * mbc
    if vp == 1:
        flat = [(s, kind, 0, i) for s, kind, i in _flat_1f1b_order(pp, mbc)]
    else:
        flat = _flat_interleaved_order(pp, mbc, vp, group)

    def slot(kind, s, c, mb):
        return kind * n_half + (s * vp + c) * mbc + mb

    ops = np.empty((len(flat), 4), dtype=np.int32)
    for k, (s, kind, c, mb) in enumerate(flat):
        if kind == 0:
            if s > 0:
                dep = slot(0, s - 1, c, mb)
            elif c > 0:
                dep = slot(0, last, c - 1, mb)
            else:
                dep = -1
            blk = s < last or c < vp - 1
        else:
            if s < last:
                dep = slot(1, s + 1, c, mb)
            elif c < vp - 1:
                dep = slot(1, 0, c + 1, mb)
            else:
                dep = -1
            blk = s > 0 or c > 0
        ops[k] = (s | (blk << 8) | (kind << 9), s * vp + c,
                  slot(kind, s, c, mb), dep)
    return ops


#: bits of a level-ordered table's first field below the offset of the
#: next level (stage 0-7, blocking 8, backward 9)
LEVEL_SHIFT = 10


def fold_levels(ops):
    """Sort a :func:`fold_table` by dependence level: an op's level is
    one more than that of the previous op on its stage and one more than
    that of the op that wrote the slot it waits on (0 with neither), so
    the ops of one level lie on distinct stages and depend only on ops
    of earlier levels. Returns ``(table, offsets)``: the ops in level
    order, by stage within a level, each record's first field also
    holding the offset of the next level's first op from bit
    :data:`LEVEL_SHIFT` up (what the kernel walks by), and the level
    offsets, int64 ``[levels + 1]``, ``offsets[-1] == len(ops)``."""
    ops = np.asarray(ops, dtype=np.int32)
    n_ops = len(ops)
    if n_ops >= 1 << (31 - LEVEL_SHIFT):
        raise ValueError(f"fold_levels: {n_ops} ops; a level-ordered table takes fewer than "
                         f"{1 << (31 - LEVEL_SHIFT)}")
    level = np.empty(n_ops, dtype=np.int64)
    stage_level: Dict[int, int] = {}
    slot_level: Dict[int, int] = {}
    for k, (code, _row, slot, dep) in enumerate(ops.tolist()):
        s = code & 0xFF
        lev = stage_level.get(s, -1) + 1
        if dep >= 0:
            lev = max(lev, slot_level[dep] + 1)
        level[k] = stage_level[s] = slot_level[slot] = lev
    order = np.lexsort((ops[:, 0] & 0xFF, level))
    offsets = np.searchsorted(level[order], np.arange(int(level.max(initial=-1)) + 2))
    table = ops[order].copy()
    table[:, 0] |= (offsets[level[order] + 1] << LEVEL_SHIFT).astype(np.int32)
    return table, offsets


def _fold_ops(pp: int, vp: int, mbc: int, group: int, device: str):
    """:func:`fold_levels` of :func:`fold_table` as a tensor on
    ``device``, built and copied once per shape (its records carry the
    level offsets the kernel walks by)."""
    import torch

    key = (pp, vp, mbc, group if vp > 1 else 0, device)
    got = _FOLD_TABLES.get(key)
    if got is None:
        got = torch.from_numpy(fold_levels(fold_table(pp, vp, mbc, group))[0]).to(device)
        if len(_FOLD_TABLES) >= _FOLD_TABLES_MAX:
            _FOLD_TABLES.clear()
        _FOLD_TABLES[key] = got
    return got


def _pack_members(members, pp: int, vp: int):
    """One shape-group's fold inputs in one float64 buffer
    ``[2*pp*vp + 2, n]``: ``fwd`` rows ``stage * vp + chunk``, then
    ``bwd``, then ``p2p`` and ``blocking``. Returns ``(buffer, by_job)``,
    ``by_job`` the ``(job, candidates, columns)`` to scatter back."""
    n, rows = len(members), pp * vp
    host = np.empty((2 * rows + 2, n))
    by_job: Dict[int, tuple] = {}
    for k, (job, i) in enumerate(members):
        by_job.setdefault(id(job), (job, [], []))
        by_job[id(job)][1].append(i)
        by_job[id(job)][2].append(k)
    for job, idx, cols in by_job.values():
        ncand = len(job.mbc_a)

        def take(v):
            return np.broadcast_to(np.asarray(v, dtype=float),
                                   (ncand,))[idx]

        for s in range(pp):
            for c in range(vp):
                r = s * vp + c
                if vp == 1:
                    host[r, cols] = take(job.stage_fwd[s])
                    host[rows + r, cols] = take(job.stage_bwd[s])
                else:
                    host[r, cols] = take(job.chunk_fwd[(s, c)])
                    host[rows + r, cols] = take(job.chunk_bwd[(s, c)])
        p2p = take(job.p2p_t)
        host[2 * rows, cols] = p2p
        host[2 * rows + 1, cols] = 0.0 if job.async_p2p else p2p
    return host, list(by_job.values())


def fold_views(x, pp: int, vp: int):
    """``fwd``, ``bwd`` ``[pp, vp, n]`` and ``p2p``, ``blocking``
    ``[n]``: views of a buffer :func:`_pack_members` packed."""
    rows, n = pp * vp, x.shape[1]
    return (x[:rows].view(pp, vp, n), x[rows:2 * rows].view(pp, vp, n),
            x[2 * rows], x[2 * rows + 1])


def _fold_members_cuda(members, pp: int, vp: int, mbc: int, group: int,
                       device: str):
    """Fold one shape-group of ``(job, candidate)`` members with
    ``fold_schedule`` (``torchref/kernels.py``; the CUDA kernel on the
    card, its plain version for ``device="cpu"``) and scatter
    totals/ends back into each job. Members may span jobs (FoldBatch)
    or belong to one (inline dispatch); mixed ``pp_comm_async`` is fine
    — blocking is data. The group's inputs are packed into one float64
    buffer (:func:`_pack_members`): one copy to the card, one launch,
    one copy back. Any error on the way is a
    :class:`~simumax_tpu_torch.torchref.kernels.KernelError`, which the
    search never quarantines."""
    import torch

    from simumax_tpu_torch.torchref import kernels as K

    host, by_job = _pack_members(members, pp, vp)
    try:
        ops = _fold_ops(pp, vp, mbc, group, device)
        x = torch.from_numpy(host).to(device)
        out = K.fold_schedule(ops, *fold_views(x, pp, vp)).cpu().numpy()
    except K.KernelError:
        raise
    except RuntimeError as exc:
        raise K.KernelError(
            f"fold_schedule [pp {pp}, vp {vp}, mbc {mbc}, n "
            f"{len(members)}] on {device}: {exc}") from exc
    for job, idx, cols in by_job:
        job.totals[idx] = out[pp, cols]
        job.ends[:, idx] = out[:pp, cols]


# --------------------------------------------------------------------------
# Fold dispatch: one candidate batch (inline) or a whole sweep's
# screening batch (FoldBatch)
# --------------------------------------------------------------------------

#: minimum cross-cell fold-group size for FoldBatch (sweep-wide guided
#: screening) to dispatch the kernel — far below JIT_GROUP_MIN
#: because one batched dispatch amortizes over every *cell* of the
#: sweep sharing the schedule shape, not over one family's candidates
FOLD_BATCH_JIT_MIN = 16


class _FoldJob:
    """One ``score`` call's pipeline-schedule fold: the inputs the
    fold needs, the (totals, ends) it produces, and the ``finalize``
    closure that turns them into the score dict."""

    __slots__ = ("pp", "vp", "group", "async_p2p", "mbc_a",
                 "need_cost", "stage_fwd", "stage_bwd", "chunk_fwd",
                 "chunk_bwd", "p2p_t", "finalize", "totals", "ends")

    def __init__(self, pp, vp, group, async_p2p, mbc_a, need_cost,
                 stage_fwd, stage_bwd, chunk_fwd, chunk_bwd, p2p_t):
        self.pp = pp
        self.vp = vp
        self.group = group
        self.async_p2p = async_p2p
        self.mbc_a = mbc_a
        self.need_cost = need_cost
        self.stage_fwd = stage_fwd
        self.stage_bwd = stage_bwd
        self.chunk_fwd = chunk_fwd
        self.chunk_bwd = chunk_bwd
        self.p2p_t = p2p_t
        self.finalize = None
        self.totals = None
        self.ends = None


def _fold_numpy_one(job: _FoldJob, i: int):
    """The numpy fold of one candidate — the scalar-parity reference
    path (exactly the pre-batching per-candidate code)."""
    pp, vp = job.pp, job.vp
    if pp == 1:
        tot = job.mbc_a[i] * (job.stage_fwd[0][i] + job.stage_bwd[0][i])
        return tot, [tot]
    if vp > 1:
        fwds = [[float(job.chunk_fwd[(s, c)][i]) for c in range(vp)]
                for s in range(pp)]
        bwds = [[float(job.chunk_bwd[(s, c)][i]) for c in range(vp)]
                for s in range(pp)]
        return fold_interleaved(pp, vp, int(job.mbc_a[i]), job.group,
                                fwds, bwds, job.p2p_t[i],
                                job.async_p2p)
    fwds = [job.stage_fwd[s][i] for s in range(pp)]
    bwds = [job.stage_bwd[s][i] for s in range(pp)]
    return fold_1f1b(pp, int(job.mbc_a[i]), fwds, bwds, job.p2p_t[i],
                     job.async_p2p)


def _fold_job(job: _FoldJob, backend: str, device: str = "cuda",
              jit_min: int = JIT_GROUP_MIN):
    """Fold one candidate batch inline: candidates sharing a schedule
    shape ride one kernel launch when the backend allows (``cuda``
    always; ``auto`` only for groups big enough to amortize the launch
    and its copies), everything else takes the numpy fold. Results are
    bit-identical either way (pinned in the port's tests) — both the
    1F1B and the interleaved (vp > 1) schedule go through the kernel."""
    ncand = len(job.mbc_a)
    job.totals = np.empty(ncand)
    job.ends = np.empty((job.pp, ncand))
    kernel_groups: Dict[int, List[int]] = {}
    if job.pp > 1 and backend in ("cuda", "auto"):
        by_mbc: Dict[int, List[int]] = {}
        for i in range(ncand):
            if job.need_cost[i]:
                by_mbc.setdefault(int(job.mbc_a[i]), []).append(i)
        for mbc_i, idxs in by_mbc.items():
            if backend == "cuda" or len(idxs) >= jit_min:
                kernel_groups[mbc_i] = idxs
    folded = set()
    for mbc_i, idxs in kernel_groups.items():
        _fold_members_cuda([(job, i) for i in idxs], job.pp, job.vp,
                           mbc_i, job.group, device)
        folded.update(idxs)
    for i in range(ncand):
        if i in folded:
            continue
        if not job.need_cost[i]:
            job.totals[i] = math.inf
            job.ends[:, i] = math.inf
            continue
        tot, ends_i = _fold_numpy_one(job, i)
        job.totals[i] = tot
        for s in range(job.pp):
            job.ends[s, i] = ends_i[s]


class FoldBatch:
    """Cross-cell fold batcher for sweep-wide guided screening
    (``BatchedScorer.screen_cells``).

    Per-cell ``screen_cell`` scores one candidate per call, so a
    500-cell screen runs 500 Python schedule folds — none big enough
    for the inline kernel dispatch. Here every deferred ``score`` call
    registers its fold inputs instead; :meth:`run` folds ALL
    registered candidates grouped by schedule shape — one kernel
    launch per (pp, vp, mbc, group) across the whole sweep —
    then each deferred call's finalize produces its score dict.
    Outputs are bit-identical to the inline per-call fold (same float
    ops on the same values), so batching the screen can never change
    a triple (asserted in the port's tests)."""

    def __init__(self, jit_min: int = FOLD_BATCH_JIT_MIN):
        self.jit_min = jit_min
        self._jobs: List[_FoldJob] = []
        self._ran = False
        #: shape-group accounting: {(pp, vp, mbc, group): n_members}
        #: of the groups the last run() dispatched to the kernel
        self.jit_dispatched: Dict[tuple, int] = {}

    def defer(self, job: _FoldJob):
        """Register one score call's fold; returns the thunk that
        yields its score dict after :meth:`run`."""
        self._jobs.append(job)

        def result():
            if not self._ran:
                raise SimulationError(
                    "FoldBatch.run() must be called before reading a "
                    "deferred score")
            return job.finalize(job.totals, job.ends)

        return result

    def run(self, backend: str = "auto", device: str = "cuda"):
        """Execute every registered fold, batched across jobs."""
        groups: Dict[tuple, list] = {}
        use_kernel = backend in ("cuda", "auto")
        for job in self._jobs:
            ncand = len(job.mbc_a)
            job.totals = np.empty(ncand)
            job.ends = np.empty((job.pp, ncand))
            for i in range(ncand):
                if not job.need_cost[i]:
                    job.totals[i] = math.inf
                    job.ends[:, i] = math.inf
                elif use_kernel and job.pp > 1:
                    key = (job.pp, job.vp, int(job.mbc_a[i]),
                           job.group if job.vp > 1 else 0)
                    groups.setdefault(key, []).append((job, i))
                else:
                    tot, ends_i = _fold_numpy_one(job, i)
                    job.totals[i] = tot
                    for s in range(job.pp):
                        job.ends[s, i] = ends_i[s]
        kernel_groups = {
            key: members for key, members in groups.items()
            if backend == "cuda" or len(members) >= self.jit_min
        }
        for key, members in groups.items():
            if key in kernel_groups:
                continue
            for job, i in members:
                tot, ends_i = _fold_numpy_one(job, i)
                job.totals[i] = tot
                for s in range(job.pp):
                    job.ends[s, i] = ends_i[s]
        for (pp, vp, mbc_i, group), members in kernel_groups.items():
            _fold_members_cuda(members, pp, vp, mbc_i, group, device)
        self.jit_dispatched = {
            key: len(members) for key, members in kernel_groups.items()
        }
        self._ran = True


# --------------------------------------------------------------------------
# Leaf records
# --------------------------------------------------------------------------


class _Leaf:
    """One leaf op of a block kind, quantities as (ncand,) arrays."""

    __slots__ = (
        "name", "flops", "accessed", "op_key", "key_fn", "bw_key",
        "cache_raw", "cache_eff", "fwd_temp", "bwd_temp", "in_b", "out_b",
        "numel", "moe", "coll", "rc", "seg", "variance_tail",
        "is_core", "is_cp",
        "cost_fwd", "cost_bwd_act", "cost_bwd_w",
        "net_fwd", "net_bwd_act", "net_bwd_w", "fsdp", "cp_hidden",
    )

    def __init__(self, name):
        self.name = name
        self.flops = {}      # phase -> array
        self.accessed = {}   # phase -> array
        self.op_key = {}     # phase -> str
        self.key_fn = {}     # phase -> callable(i) -> str, or absent
        self.bw_key = {}     # phase -> str (default "default")
        self.cache_raw = 0.0
        self.cache_eff = None  # filled by wiring
        self.fwd_temp = 0.0
        self.bwd_temp = 0.0
        self.in_b = 0.0
        self.out_b = 0.0
        self.numel = 0.0
        self.moe = False
        #: [(phase, op, dim, size_array, exposed, is_fsdp)]
        self.coll = []
        self.rc = False
        self.seg = None
        self.variance_tail = False
        #: the block's CoreAttention (async-CP overlap budget anchor)
        self.is_core = False
        #: a ContextParallelA2A mirror (async-CP hiding candidate)
        self.is_cp = False


class _Kernel:
    """The lowered cost program of one strategy *family* — every
    strategy field fixed except the batch split ``(mbs, mbc)`` and (for
    full-block recompute) the recompute layer count. ``score`` evaluates
    a whole candidate batch in one call.

    ``shared_cache`` (provided by :class:`BatchedScorer`) memoizes
    block-kind profiles across families: a block's leaf tables depend on
    the intra-layer sharding (tp/ep/etp), the recompute wiring, and —
    only at ZeRO >= 2 — the data-parallel group sizes, but never on
    ``pp`` or the batch counts, so sibling layouts of one sweep reuse
    them wholesale."""

    def __init__(self, st: StrategyConfig, model: ModelConfig,
                 system: SystemConfig, shared_cache: Optional[dict] = None):
        check_supported(st, model, system)
        self.st = st
        self.system = system
        self.invalid = _family_invalid_reason(st, model, system)
        self.model = copy.copy(model)
        self._shared = shared_cache if shared_cache is not None else {}
        if self.invalid is not None:
            return
        self.model.maybe_pad_vocab_size(st.tp_size)
        self.paths = place_strategy_paths(st, system)
        self.counts = stage_layer_split(st, self.model)
        self._net_coeffs: Dict[Tuple[str, str], Tuple[float, float]] = {}
        acc = system.accelerator
        self._roofline = acc.mode != "compute_only"
        # straggler inflation is layout-only (perf.straggler_ratio)
        self.straggle = self._straggler_ratio()
        # model FLOPs/token walks every layer — layout-constant, cache it
        self._flops_per_token = self.model.train_flops_per_token(
            st.seq_len)

    #: strategy fields a block-kind profile can depend on. pp/world and
    #: the batch/recompute-layer axes are deliberately absent (profiles
    #: are pp- and batch-independent; the recompute wiring is keyed
    #: separately in normalized form), and at ZeRO >= 2 the
    #: data-parallel group sizes are appended explicitly.
    _KIND_FIELDS = (
        "seq_len", "dtype", "fp8", "quant_dtype", "tp_size", "cp_size",
        "ep_size", "etp_size", "moe_capacity_factor",
        "group_linear_mode", "enable_sequence_parallel", "cp_comm_type",
        "cp_a2a_mode", "zero_state", "use_fused_norm", "use_math_sdp",
        "use_flash_sdp", "sdp_backend", "use_fused_ce",
        "use_fp32_accum_grad", "optimizer_style",
        "attention_sparse_ratio", "mesh_order", "enable_dropout",
        "dispatch_probs", "offload_groupgemm_col_inputs",
    )

    def _kind_key(self, tag, ub: tuple, wiring) -> tuple:
        """Shared-cache key of one block-kind profile: everything it can
        depend on that may vary across the scorer's kernels (the scorer
        itself is per (model, system))."""
        st = self.st
        groups = (st.dp_size * st.cp_size, st.edp_size) \
            if st.zero_state >= 2 else ()
        base = getattr(self, "_kind_base", None)
        if base is None:
            base = tuple(getattr(st, f) for f in self._KIND_FIELDS)
            self._kind_base = base
        return (tag, ub, wiring, groups) + base

    # -- cost primitives ---------------------------------------------------
    def _coeffs(self, dim: str, op: str) -> Tuple[float, float]:
        key = (dim, op)
        got = self._net_coeffs.get(key)
        if got is None:
            got = self.system.net_op_coeffs(op, self.paths[dim])
            self._net_coeffs[key] = got
        return got

    def _net_time(self, dim: str, op: str, size):
        k, lat = self._coeffs(dim, op)
        return k * size + lat

    def _mem_time(self, bytes_arr, bw_key="default"):
        # only called with positive byte counts (scalar mode)
        spec = (self.system.accelerator.bandwidth.get(bw_key)
                or self.system.accelerator.bandwidth["default"])
        return bytes_arr / (spec.gbps * 1e9 * spec.efficient_factor) \
            + spec.latency_us * 1e-6

    def _comp_time(self, op_key, flops, key_fn):
        # only called with positive flops (scalar mode)
        spec = (self.system.accelerator.op.get(op_key)
                or self.system.accelerator.op["default"])
        table = spec.accurate_efficient_factor
        if table and key_fn is not None:
            eff = table.get(key_fn(), spec.efficient_factor)
        else:
            eff = spec.efficient_factor
        return flops / (spec.tflops * 1e12 * eff)

    def _straggler_ratio(self) -> float:
        st = self.st
        if not st.enable_straggler_model:
            return 1.0
        sysc = self.system
        hosts = max(1, st.world_size // max(1, sysc.chips_per_slice))
        n = min(hosts, st.dp_size, max(st.edp_size, 1))
        if n <= 1:
            return 1.0
        nhat = math.log2(n)
        return 1.0 + nhat / (nhat + 1.0) * 0.09 * math.sqrt(nhat)

    # -- param accounting --------------------------------------------------
    def _pinfo(self, numel: float, moe: bool) -> Tuple[float, float, float]:
        """(weight, grad, state) bytes — mirror of
        ``MetaModule.make_param_info``."""
        st = self.st
        if numel <= 0:
            return 0.0, 0.0, 0.0
        w = numel * st.element_size
        if st.optimizer_style == "functional":
            g = 0.0
            state = numel * 8.0
        else:
            g = numel * st.grad_element_size
            state = numel * 12.0
        shard = st.edp_size if moe else st.dp_size * st.cp_size
        if st.zero_state >= 1:
            state = state / max(1, shard)
        if st.zero_state >= 2:
            g = g / max(1, shard)
        if st.zero_state >= 3:
            w = w / max(1, shard)
        return w, g, state

    def _fsdp_group(self, moe: bool) -> int:
        st = self.st
        return st.edp_size if moe else st.dp_size * st.cp_size

    def _fsdp_temp(self, numel: float, moe: bool) -> float:
        st = self.st
        group = self._fsdp_group(moe)
        if st.zero_state < 3 or numel <= 0 or group <= 1:
            return 0.0
        return numel * st.element_size * (1 - 1 / group)

    def _zero_grad_temp(self, numel: float, moe: bool) -> float:
        st = self.st
        group = self._fsdp_group(moe)
        if st.zero_state < 2 or numel <= 0 or group <= 1:
            return 0.0
        return numel * st.grad_element_size * (1 - 1 / group)

    def _fsdp_calls(self, leaf: _Leaf, numel: float, moe: bool):
        st = self.st
        group = self._fsdp_group(moe)
        if st.zero_state < 3 or numel <= 0 or group <= 1:
            return
        dim = "edp" if moe else "dp_cp"
        w = numel * st.element_size
        g = numel * st.grad_element_size
        leaf.coll.append(("fwd", "all_gather", dim, w, False, True))
        leaf.coll.append(("bwd_act", "all_gather", dim, w, False, True))
        leaf.coll.append(("bwd_w", "reduce_scatter", dim, g, False, True))

    # -- leaf builders -----------------------------------------------------
    # The builders run in SCALAR mode: one block-kind profile is built
    # per single micro_batch_size value with plain Python floats (bit-
    # identical to elementwise float64 array math), and ``score``
    # assembles candidate-batch arrays by concatenating cached per-b
    # profiles — maximizing cross-layout reuse and keeping numpy
    # overhead out of the build path.
    def _gemm_keyfn(self, phase, m, k, n, batch=1):
        """Lazy key renderer for a dense-grammar GEMM."""
        st = self.st

        def fn(_phase=phase, _m=int(m), _k=k, _n=n, _b=batch):
            if _phase == "fwd":
                t = (_b, _m, _k, _n)
            elif _phase == "bwd_act":
                t = (_b, _m, _n, _k)
            else:
                t = (_b, _k, _m, _n)
            return GemmBase.render_gemm_shape_key(
                t[0], t[1], t[2], t[3], _phase, st.dtype,
                st.use_fp32_accum_grad,
            )
        return fn

    def _linear(self, name, rows_in, k, n, numel, *,
                sp_comm: bool, col: bool, moe_param=False,
                count_params=True, quantized=False):
        """Shared LinearCol/LinearRow lowering.

        ``rows_in`` — the GEMM rows m (already gathered for col layers
        under SP); ``k``/``n`` the local contraction/output dims;
        ``sp_comm`` — the layer issues the SP/TP collectives; ``col`` —
        column-parallel (AG-in) vs row-parallel (RS-out); ``quantized``
        — the leaf rides the low-precision MXU path under ``st.fp8``
        (mirror of ``GemmBase``: the quant op table plus the
        input-quantization cast traffic per phase)."""
        st = self.st
        e = st.element_size
        g = st.grad_element_size
        quant = quantized and st.fp8
        lf = _Leaf(name)
        m = rows_in
        f = 2.0 * m * k * n
        lf.flops = {"fwd": f, "bwd_act": f, "bwd_w": f}
        io = (m * k + k * n + m * n) * e
        wextra = k * n * (g - e)
        lf.accessed = {"fwd": io, "bwd_act": io, "bwd_w": io + wextra}
        if quant:
            # GemmBase.quant_cast_bytes: read the bf16 GEMM input +
            # write its 1-byte copy, per phase's own (m, k)
            lf.accessed = {
                "fwd": lf.accessed["fwd"] + m * k * (e + 1.0),
                "bwd_act": lf.accessed["bwd_act"] + m * n * (e + 1.0),
                "bwd_w": lf.accessed["bwd_w"] + k * m * (e + 1.0),
            }
        op_key = f"{st.quant_dtype}_matmul" if quant else "matmul"
        for ph in ("fwd", "bwd_act", "bwd_w"):
            lf.op_key[ph] = op_key
            lf.key_fn[ph] = self._gemm_keyfn(ph, rows_in, k, n)
        pn = numel if count_params else 0.0
        lf.numel = pn
        lf.moe = moe_param
        fsdp_t = self._fsdp_temp(pn, moe_param)
        lf.bwd_temp = fsdp_t + self._zero_grad_temp(pn, moe_param)
        lf.fwd_temp = fsdp_t
        self._fsdp_calls(lf, pn, moe_param)
        if sp_comm and st.tp_size > 1:
            if col:
                full_in = m * k * e
                if st.enable_sequence_parallel:
                    lf.coll += [
                        ("fwd", "all_gather", "tp", full_in, True, False),
                        ("bwd_act", "reduce_scatter", "tp", full_in, True,
                         False),
                        ("bwd_w", "all_gather", "tp", full_in, True, False),
                    ]
                else:
                    lf.coll.append(
                        ("bwd_act", "all_reduce", "tp", full_in, True,
                         False))
            else:
                full_out = m * n * e
                if st.enable_sequence_parallel:
                    lf.coll += [
                        ("fwd", "reduce_scatter", "tp", full_out, True,
                         False),
                        ("bwd_act", "all_gather", "tp", full_out, True,
                         False),
                    ]
                else:
                    lf.coll.append(
                        ("fwd", "all_reduce", "tp", full_out, True, False))
        return lf

    def _norm(self, name, nb, rows, hidden):
        st = self.st
        lf = _Leaf(name)
        numel_in = rows * hidden  # elements of the input
        lf.flops = {"fwd": 4.0 * numel_in, "bwd_act": 8.0 * numel_in}
        fused = st.use_fused_norm
        lf.accessed = {
            "fwd": (2 if fused else 3) * nb,
            "bwd_act": (3 if fused else 4) * nb,
            "bwd_w": nb,
        }
        for ph in ("fwd", "bwd_act", "bwd_w"):
            lf.op_key[ph] = "default"
        lf.cache_raw = nb + rows * 4.0
        lf.numel = float(hidden)
        lf.in_b = nb
        lf.out_b = nb
        return lf

    def _dropout(self, name, nb):
        """Mirror of ``models.dense.Dropout``: memory-bound elementwise
        with a cached 1-byte mask per element."""
        lf = _Leaf(name)
        numel = nb / self.st.element_size
        lf.accessed = {"fwd": 2 * nb + numel, "bwd_act": 2 * nb + numel}
        lf.op_key = {"fwd": "default", "bwd_act": "default"}
        lf.cache_raw = numel
        lf.in_b = nb
        lf.out_b = nb
        return lf

    def _cp_a2a(self, name, in_bytes, r=1.0):
        """Mirror of ``ContextParallelA2A``: one Ulysses re-shard stage.
        ``r`` is the kv-head replication factor (scatter_heads with
        fewer kv heads than cp ranks); the collective moves the full
        logical tensor (per-chip bytes x r x cp) and the re-sharded
        copy is a forward transient."""
        st = self.st
        lf = _Leaf(name)
        lf.is_cp = True
        exposed = st.cp_a2a_mode == "sync_cp"
        nbytes = in_bytes * r * st.cp_size
        lf.coll = [("fwd", "all2all", "cp", nbytes, exposed, False),
                   ("bwd_act", "all2all", "cp", nbytes, exposed, False)]
        lf.fwd_temp = in_bytes * r
        lf.in_b = in_bytes
        lf.out_b = in_bytes * r
        return lf

    def _kv_allgather(self, name, in_bytes):
        """Mirror of ``KVAllGather`` (cp=all_gather ring family): fwd
        all-gather of k/v over cp, bwd reduce-scatter of the grad; the
        gathered copy stays live through the attention backward."""
        st = self.st
        lf = _Leaf(name)
        full = in_bytes * st.cp_size
        lf.coll = [("fwd", "all_gather", "cp", full, True, False),
                   ("bwd_act", "reduce_scatter", "cp", full, True,
                    False)]
        lf.fwd_temp = full
        lf.bwd_temp = full
        lf.in_b = in_bytes
        lf.out_b = full
        return lf

    # -- block kinds -------------------------------------------------------
    def _attention_leaves(self, b: int) -> List[_Leaf]:
        st, m = self.st, self.model
        e = st.element_size
        tp = st.tp_size
        sp = st.enable_sequence_parallel
        s_cp = st.seq_len // st.cp_size
        s_sp = s_cp // tp if sp else s_cp
        s_out = s_sp * tp if (sp and tp > 1) else s_sp
        A = b * s_sp * m.hidden_size * e
        out: List[_Leaf] = []
        if m.attention_type == "mla":
            out += self._mla_leaves(b)
            return out
        hd = m.head_size
        cp = st.cp_size
        a2a = cp > 1 and st.cp_comm_type == "a2a"
        allg = cp > 1 and st.cp_comm_type == "all_gather"
        q_out = m.head_num * hd
        kv_out = m.kv_head_num * hd
        qkv_out = q_out + 2 * kv_out
        out_local = qkv_out // tp
        rows = b * s_out
        qkv = self._linear("qkv_proj", rows, m.hidden_size,
                           out_local, float(m.hidden_size * out_local),
                           sp_comm=True, col=True, quantized=True)
        qkv.cache_raw = A
        if sp and tp > 1:
            qkv.fwd_temp = qkv.fwd_temp + A * tp
            qkv.bwd_temp = qkv.bwd_temp + A * tp
        qkv.in_b = A
        qkv.out_b = rows * out_local * e
        out.append(qkv)

        hl = m.head_num // tp
        kvl = max(m.kv_head_num // tp, 1)
        qb = b * s_out * hl * hd * e
        kb = b * s_out * kvl * hd * e
        rope = _Leaf("rope")
        rope.accessed = {"fwd": 2 * (qb + kb), "bwd_act": 2 * (qb + kb)}
        rope.op_key = {"fwd": "default", "bwd_act": "default"}
        rope.in_b = qb + kb
        rope.out_b = qb + kb
        out.append(rope)

        if a2a:
            r = 1 if kvl >= cp else cp // kvl
            out.append(self._cp_a2a("cp_a2a_q", qb))
            out.append(self._cp_a2a("cp_a2a_k", kb, r))
            out.append(self._cp_a2a("cp_a2a_v", kb, r))
            out.append(self._core_leaf(b, s_out * cp, s_out * cp,
                                       hl // cp, (kvl * r) // cp, hd,
                                       hd))
            out.append(self._cp_a2a("cp_a2a_o", qb))
        elif allg:
            out.append(self._kv_allgather("kv_allgather_k", kb))
            out.append(self._kv_allgather("kv_allgather_v", kb))
            out.append(self._core_leaf(b, s_out, s_out * cp, hl, kvl,
                                       hd, hd))
        else:
            out.append(self._core_leaf(b, s_out, s_out, hl, kvl, hd,
                                       hd))

        in_local = q_out // tp
        op = self._linear("out_proj", rows, in_local,
                          m.hidden_size, float(in_local * m.hidden_size),
                          sp_comm=True, col=False, quantized=True)
        op.cache_raw = rows * in_local * e
        op.in_b = rows * in_local * e
        op.out_b = A
        out.append(op)
        return out

    def _core_leaf(self, b, sq, skv, hl, kvl, d, dv) -> _Leaf:
        st, m = self.st, self.model
        e = st.element_size
        lf = _Leaf("core_attention")
        lf.is_core = True
        causal = bool(m.use_causal_attention)
        sparse = st.attention_sparse_ratio if causal else 0.0
        qk = 2.0 * b * hl * sq * skv * d
        pv = 2.0 * b * hl * sq * skv * dv
        fwd = (qk + pv) * (1.0 - sparse)
        bwd = 2.5 * fwd if st.use_flash_sdp else 2.0 * fwd
        lf.flops = {"fwd": fwd, "bwd_act": bwd}
        qo = b * sq * hl * (d + dv) * e
        kv = b * skv * kvl * (d + dv) * e
        lse = b * hl * sq * 4.0
        if st.use_flash_sdp:
            lf.accessed = {"fwd": qo + kv + lse,
                           "bwd_act": 2 * (qo + kv) + lse}
        else:
            score = b * hl * sq * skv * 4.0
            lf.accessed = {"fwd": qo + kv + 2 * score,
                           "bwd_act": 2 * (qo + kv) + 4 * score}
        lf.op_key = {"fwd": "sdp_fwd", "bwd_act": "sdp_bwd"}

        def keyfn(_b=int(b), _sq=sq, _skv=skv, _hl=hl, _kvl=kvl, _d=d,
                  _dv=dv, _causal=causal):
            return CoreAttention.render_sdp_shape_key(
                _b, _sq, _skv, _hl, _kvl, _d, _dv, _causal,
                st.use_flash_sdp, st.dtype, backend=st.sdp_backend,
            )
        lf.key_fn = {"fwd": keyfn, "bwd_act": keyfn}
        qbytes = b * sq * hl * d * e
        obytes = b * sq * hl * dv * e
        if st.use_flash_sdp:
            lf.cache_raw = qbytes + b * skv * kvl * (d + dv) * e \
                + obytes + lse
        else:
            probs = b * hl * sq * skv * 4.0
            lf.cache_raw = qbytes + b * skv * kvl * (d + dv) * e + probs
            lf.bwd_temp = b * hl * sq * skv * e
        lf.in_b = qbytes + b * skv * kvl * (d + dv) * e
        lf.out_b = obytes
        return lf

    def _mla_leaves(self, b: int) -> List[_Leaf]:
        st, m = self.st, self.model
        e = st.element_size
        tp = st.tp_size
        sp = st.enable_sequence_parallel
        s_sp = (st.seq_len // st.cp_size) // tp if sp \
            else st.seq_len // st.cp_size
        s_out = s_sp * tp if (sp and tp > 1) else s_sp
        h = m.hidden_size
        A = b * s_sp * h * e
        qk_dim = m.qk_head_dim + m.qk_pos_emb_head_dim
        q_out = m.head_num * qk_dim
        hl = m.head_num // tp
        rows_sp = b * s_sp
        rows_out = b * s_out
        out: List[_Leaf] = []
        if m.q_lora_rank:
            qd = self._linear("q_down", rows_sp, h,
                              m.q_lora_rank, float(h * m.q_lora_rank),
                              sp_comm=False, col=True)
            qd.cache_raw = A
            qd.in_b = A
            qd.out_b = rows_sp * m.q_lora_rank * e
            out.append(qd)
            qn = self._norm("q_norm", rows_sp * m.q_lora_rank * e,
                            rows_sp, m.q_lora_rank)
            out.append(qn)
            qu = self._linear("q_up", rows_out, m.q_lora_rank,
                              q_out // tp, float(m.q_lora_rank
                                                 * (q_out // tp)),
                              sp_comm=True, col=True, quantized=True)
            qu.cache_raw = rows_sp * m.q_lora_rank * e
            if sp and tp > 1:
                qu.fwd_temp = qu.fwd_temp + qu.cache_raw * tp
                qu.bwd_temp = qu.bwd_temp + qu.cache_raw * tp
            qu.in_b = rows_sp * m.q_lora_rank * e
            qu.out_b = rows_out * (q_out // tp) * e
            out.append(qu)
        else:
            qp = self._linear("q_proj", rows_out, h,
                              q_out // tp, float(h * (q_out // tp)),
                              sp_comm=True, col=True, quantized=True)
            qp.cache_raw = A
            if sp and tp > 1:
                qp.fwd_temp = qp.fwd_temp + A * tp
                qp.bwd_temp = qp.bwd_temp + A * tp
            qp.in_b = A
            qp.out_b = rows_out * (q_out // tp) * e
            out.append(qp)
        kvd_out = m.kv_lora_rank + m.qk_pos_emb_head_dim
        kvd = self._linear("kv_down", rows_sp, h, kvd_out,
                           float(h * kvd_out), sp_comm=False, col=True)
        kvd.cache_raw = A
        kvd.in_b = A
        kvd.out_b = rows_sp * kvd_out * e
        out.append(kvd)
        kvn = self._norm("kv_norm", rows_sp * m.kv_lora_rank * e,
                         rows_sp, m.kv_lora_rank)
        out.append(kvn)
        kvu_out = m.head_num * (m.qk_head_dim + m.v_head_dim)
        kvu = self._linear("kv_up", rows_out, m.kv_lora_rank,
                           kvu_out // tp,
                           float(m.kv_lora_rank * (kvu_out // tp)),
                           sp_comm=True, col=True, quantized=True)
        kvu.cache_raw = rows_sp * m.kv_lora_rank * e
        if sp and tp > 1:
            kvu.fwd_temp = kvu.fwd_temp + kvu.cache_raw * tp
            kvu.bwd_temp = kvu.bwd_temp + kvu.cache_raw * tp
        kvu.in_b = rows_sp * m.kv_lora_rank * e
        kvu.out_b = rows_out * (kvu_out // tp) * e
        out.append(kvu)
        if sp and tp > 1:
            rg = _Leaf("rope_k_gather")
            rope_in = rows_sp * m.qk_pos_emb_head_dim * e
            full = rope_in * tp
            rg.coll = [("fwd", "all_gather", "tp", full, True, False),
                       ("bwd_act", "reduce_scatter", "tp", full, True,
                        False)]
            rg.fwd_temp = full
            rg.in_b = rope_in
            rg.out_b = full
            out.append(rg)
        qb = b * s_out * hl * qk_dim * e
        kb = qb
        rope = _Leaf("rope")
        rope.accessed = {"fwd": 2 * (qb + kb), "bwd_act": 2 * (qb + kb)}
        rope.op_key = {"fwd": "default", "bwd_act": "default"}
        rope.in_b = qb + kb
        rope.out_b = qb + kb
        out.append(rope)
        cp = st.cp_size
        vb = b * s_out * hl * m.v_head_dim * e
        if cp > 1 and st.cp_comm_type == "a2a":
            out.append(self._cp_a2a("cp_a2a_q", qb))
            out.append(self._cp_a2a("cp_a2a_k", kb))
            out.append(self._cp_a2a("cp_a2a_v", vb))
            out.append(self._core_leaf(b, s_out * cp, s_out * cp,
                                       hl // cp, hl // cp, qk_dim,
                                       m.v_head_dim))
            out.append(self._cp_a2a("cp_a2a_o", vb))
        elif cp > 1 and st.cp_comm_type == "all_gather":
            out.append(self._kv_allgather("kv_allgather_k", kb))
            out.append(self._kv_allgather("kv_allgather_v", vb))
            out.append(self._core_leaf(b, s_out, s_out * cp, hl, hl,
                                       qk_dim, m.v_head_dim))
        else:
            out.append(self._core_leaf(b, s_out, s_out, hl, hl, qk_dim,
                                       m.v_head_dim))
        in_feats = m.head_num * m.v_head_dim
        op = self._linear("out_proj", rows_out,
                          in_feats // tp, h, float((in_feats // tp) * h),
                          sp_comm=True, col=False, quantized=True)
        op.cache_raw = rows_out * (in_feats // tp) * e
        op.in_b = rows_out * (in_feats // tp) * e
        op.out_b = A
        out.append(op)
        return out

    def _mlp_leaves(self, b: int, ffn=None, prefix="") -> List[_Leaf]:
        st, m = self.st, self.model
        e = st.element_size
        tp = st.tp_size
        sp = st.enable_sequence_parallel
        s_sp = (st.seq_len // st.cp_size) // tp if sp \
            else st.seq_len // st.cp_size
        s_out = s_sp * tp if (sp and tp > 1) else s_sp
        h = m.hidden_size
        A = b * s_sp * h * e
        f = ffn or m.intermediate_size
        fan = 2 * f if m.use_swiglu else f
        rows = b * s_out
        up = self._linear(prefix + "up_proj", rows, h,
                          fan // tp, float(h * (fan // tp)),
                          sp_comm=True, col=True, quantized=True)
        up.cache_raw = A
        if sp and tp > 1:
            up.fwd_temp = up.fwd_temp + A * tp
            up.bwd_temp = up.bwd_temp + A * tp
        up.in_b = A
        up.out_b = rows * (fan // tp) * e
        act = _Leaf(prefix + ("swiglu" if m.use_swiglu else "gelu"))
        i_b = rows * (fan // tp) * e
        if m.use_swiglu:
            o_b = rows * ((fan // tp) // 2) * e
            act.accessed = {"fwd": i_b + o_b, "bwd_act": 2 * i_b + o_b}
        else:
            o_b = i_b
            act.accessed = {"fwd": 2 * i_b, "bwd_act": 3 * i_b}
        act.op_key = {"fwd": "default", "bwd_act": "default"}
        act.cache_raw = i_b
        act.in_b = i_b
        act.out_b = o_b
        down = self._linear(prefix + "down_proj", rows,
                            f // tp, h, float((f // tp) * h),
                            sp_comm=True, col=False, quantized=True)
        down.cache_raw = rows * (f // tp) * e
        down.in_b = rows * (f // tp) * e
        down.out_b = A
        return [up, act, down]

    def _moe_leaves(self, b: int) -> List[_Leaf]:
        st, m = self.st, self.model
        e = st.element_size
        tp = st.tp_size
        etp = st.etp_size
        sp = st.enable_sequence_parallel
        s_sp = (st.seq_len // st.cp_size) // tp if sp \
            else st.seq_len // st.cp_size
        h = m.hidden_size
        A = b * s_sp * h * e
        E = m.expert_num
        ng = E // st.ep_size
        out: List[_Leaf] = []

        router = _Leaf("router")
        rows = b * s_sp
        f = 2.0 * rows * h * E
        router.flops = {"fwd": f, "bwd_act": f, "bwd_w": f}
        o_b = rows * E * 4.0
        router.accessed = {"fwd": A + 3 * o_b, "bwd_act": A + 3 * o_b,
                           "bwd_w": A + o_b}
        router.op_key = {ph: "default" for ph in
                         ("fwd", "bwd_act", "bwd_w")}
        router.cache_raw = A + o_b + rows * m.topk * 4.0
        router.numel = float(h * E)
        router.in_b = A
        router.out_b = o_b
        out.append(router)

        cap = st.moe_capacity_factor or 1.0
        t1 = int(b * s_sp * m.topk * cap)
        if etp > 1 and sp:
            t1 *= etp
        disp = _Leaf("dispatch")
        permuted = t1 * h * e
        disp.accessed = {"fwd": 2 * permuted, "bwd_act": 2 * permuted}
        disp.op_key = {"fwd": "default", "bwd_act": "default"}
        disp.bw_key = {"fwd": "permute_fwd", "bwd_act": "permute_bwd"}
        disp.cache_raw = b * s_sp * m.topk * 4.0
        disp.fwd_temp = permuted
        disp.in_b = A
        disp.out_b = permuted
        pre = permuted
        if etp > 1 and sp:
            disp.coll.append(("fwd", "all_gather", "etp", permuted, True,
                              False))
            disp.coll.append(("bwd_act", "reduce_scatter", "etp", permuted,
                              True, False))
            pre = permuted / etp
        if st.ep_size > 1:
            full = pre * st.ep_size
            disp.coll.append(("fwd", "all2all", "ep", full, True, False))
            disp.coll.append(("bwd_act", "all2all", "ep", full, True,
                              False))
            if st.dispatch_probs:
                # router probs ride their own a2a to the experts
                probs_full = b * s_sp * m.topk * 4.0 * st.ep_size
                disp.coll.append(("fwd", "all2all", "ep", probs_full,
                                  True, False))
                disp.coll.append(("bwd_act", "all2all", "ep",
                                  probs_full, True, False))
        out.append(disp)

        fan = 2 * m.moe_ffn_hidden_size if m.use_swiglu \
            else m.moe_ffn_hidden_size
        out.append(self._group_linear("group_linear_col", t1,
                                      h, fan // etp, ng))
        act = _Leaf("expert_swiglu" if m.use_swiglu else "expert_gelu")
        i_b = t1 * (fan // etp) * e
        weighted = st.dispatch_probs and m.use_swiglu
        # dispatch_probs fuses the prob weighting into the expert
        # activation (weighted-SiLU): one fp32 prob per routed token
        # read each phase and cached for the dL/dprob term
        probs_b = t1 * 4.0 if weighted else 0.0
        if m.use_swiglu:
            o_b = t1 * (((fan // etp)) // 2) * e
            act.accessed = {"fwd": i_b + o_b + probs_b,
                            "bwd_act": 2 * i_b + o_b + probs_b}
        else:
            o_b = i_b
            act.accessed = {"fwd": 2 * i_b, "bwd_act": 3 * i_b}
        act.op_key = {"fwd": "default", "bwd_act": "default"}
        act.cache_raw = i_b + probs_b
        act.in_b = i_b
        act.out_b = o_b
        out.append(act)
        out.append(self._group_linear("group_linear_row", t1,
                                      m.moe_ffn_hidden_size // etp, h, ng))
        comb = _Leaf("combine")
        in_b = t1 * h * e
        comb.accessed = {"fwd": in_b + A, "bwd_act": in_b + A}
        comb.op_key = {"fwd": "default", "bwd_act": "default"}
        comb.bw_key = {"fwd": "permute_fwd", "bwd_act": "permute_bwd"}
        if st.dispatch_probs:
            # weighting already happened in the expert activation: the
            # combine is a pure layout op — nothing cached, just the
            # in/out copies live at once
            comb.fwd_temp = max(in_b, A)
        else:
            comb.cache_raw = in_b
        comb.in_b = in_b
        comb.out_b = A
        pre = in_b
        if etp > 1 and sp:
            comb.coll.append(("fwd", "reduce_scatter", "etp", in_b, True,
                              False))
            comb.coll.append(("bwd_act", "all_gather", "etp", in_b, True,
                              False))
            pre = in_b / etp
        if st.ep_size > 1:
            full = pre * st.ep_size
            comb.coll.append(("fwd", "all2all", "ep", full, True, False))
            comb.coll.append(("bwd_act", "all2all", "ep", full, True,
                              False))
        out.append(comb)

        if m.moe_shared_expert_intermediate_size:
            out += self._mlp_leaves(
                b, ffn=m.moe_shared_expert_intermediate_size,
                prefix="shared_",
            )
            add_sh = _Leaf("add_shared")
            add_sh.accessed = {"fwd": 3 * A}
            add_sh.op_key = {"fwd": "default"}
            add_sh.in_b = 2 * A
            add_sh.out_b = A
            out.append(add_sh)
        return out

    def _group_linear(self, name, t1, k, n, ng) -> _Leaf:
        st = self.st
        e = st.element_size
        g = st.grad_element_size
        quant = st.fp8
        lf = _Leaf(name)
        f = 2.0 * t1 * k * n
        lf.flops = {"fwd": f, "bwd_act": f, "bwd_w": f}
        io = (t1 * k + ng * k * n + t1 * n) * e
        wextra = ng * k * n * (g - e)
        lf.accessed = {"fwd": io, "bwd_act": io, "bwd_w": io + wextra}
        if quant:
            # GroupLinearBase.quant_cast_bytes: totals over all experts;
            # bwd_act quantizes the output-grad (tokens x n)
            lf.accessed = {
                ph: lf.accessed[ph]
                + t1 * (n if ph == "bwd_act" else k) * (e + 1.0)
                for ph in ("fwd", "bwd_act", "bwd_w")
            }
        sequential = st.group_linear_mode == "sequential"
        op_key = "matmul" if sequential else "group_matmul"
        if quant:
            op_key = f"{st.quant_dtype}_{op_key}"
        for ph in ("fwd", "bwd_act", "bwd_w"):
            lf.op_key[ph] = op_key

            def keyfn(_ph=ph, _k=k, _n=n, _ng=ng, _seq=sequential):
                tokens = int(t1)
                if _seq:
                    tokens = max(tokens // _ng, 1)
                    if _ph == "fwd":
                        t = (_ng, tokens, _k, _n)
                    elif _ph == "bwd_act":
                        t = (_ng, tokens, _n, _k)
                    else:
                        t = (_ng, _k, tokens, _n)
                    return GemmBase.render_gemm_shape_key(
                        t[0], t[1], t[2], t[3], _ph, st.dtype,
                        st.use_fp32_accum_grad,
                    )
                if _ph == "fwd":
                    t = (_ng, tokens, _k, _n)
                elif _ph == "bwd_act":
                    t = (_ng, tokens, _n, _k)
                else:
                    t = (_ng, _k, tokens, _n)
                return GroupLinearBase.render_group_shape_key(
                    t[0], t[1], t[2], t[3], _ph, st.dtype,
                    st.use_fp32_accum_grad,
                )
            lf.key_fn[ph] = keyfn
        numel = float(ng * k * n)
        lf.numel = numel
        lf.moe = True
        fsdp_t = self._fsdp_temp(numel, True)
        lf.fwd_temp = fsdp_t
        lf.bwd_temp = fsdp_t + self._zero_grad_temp(numel, True)
        self._fsdp_calls(lf, numel, True)
        lf.cache_raw = t1 * k * e
        lf.in_b = t1 * k * e
        lf.out_b = t1 * n * e
        return lf

    def _block_leaves(self, b: int, is_moe: bool) -> List[_Leaf]:
        st, m = self.st, self.model
        e = st.element_size
        tp = st.tp_size
        sp = st.enable_sequence_parallel
        s_sp = (st.seq_len // st.cp_size) // tp if sp \
            else st.seq_len // st.cp_size
        A = b * s_sp * m.hidden_size * e
        leaves: List[_Leaf] = []
        inorm = self._norm("input_norm", A, b * s_sp, m.hidden_size)
        leaves.append(inorm)
        attn = self._attention_leaves(b)
        leaves += attn
        if st.enable_dropout:
            leaves.append(self._dropout("attn_dropout", A))
        add1 = _Leaf("residual_attn")
        add1.accessed = {"fwd": 3 * A}
        add1.op_key = {"fwd": "default"}
        add1.in_b = 2 * A
        add1.out_b = A
        leaves.append(add1)
        pnorm = self._norm("pre_mlp_norm", A, b * s_sp, m.hidden_size)
        leaves.append(pnorm)
        if is_moe:
            mlp = self._moe_leaves(b)
        else:
            mlp = self._mlp_leaves(b)
        leaves += mlp
        if st.enable_dropout:
            leaves.append(self._dropout("mlp_dropout", A))
        add2 = _Leaf("residual_mlp")
        add2.accessed = {"fwd": 3 * A}
        add2.op_key = {"fwd": "default"}
        add2.in_b = 2 * A
        add2.out_b = A
        leaves.append(add2)
        # stash sub-lists for recompute wiring
        self._last_block_parts = {
            "input_norm": inorm, "pre_mlp_norm": pnorm,
            "attention": attn, "mlp": mlp, "is_moe": is_moe,
        }
        return leaves

    def _pre_leaves(self, b: int) -> List[_Leaf]:
        st, m = self.st, self.model
        e = st.element_size
        tp = st.tp_size
        sp = st.enable_sequence_parallel
        s_cp = st.seq_len // st.cp_size
        s_out = s_cp // tp if sp else s_cp
        emb = _Leaf("embedding")
        out_b = b * s_out * m.hidden_size * e
        full = out_b * (tp if sp else 1)
        ids_b = b * s_cp * 4.0
        emb.accessed = {"fwd": 2 * full, "bwd_w": 2 * full + ids_b}
        emb.op_key = {"fwd": "default", "bwd_w": "default"}
        numel = float(m.padded_vocab_size * m.hidden_size // tp)
        emb.numel = numel
        emb.cache_raw = ids_b
        fsdp_t = self._fsdp_temp(numel, False)
        emb.fwd_temp = fsdp_t
        emb.bwd_temp = fsdp_t + self._zero_grad_temp(numel, False)
        self._fsdp_calls(emb, numel, False)
        if tp > 1:
            if sp:
                emb.coll.append(("fwd", "reduce_scatter", "tp", full, True,
                                 False))
                emb.coll.append(("bwd_w", "all_gather", "tp", full, True,
                                 False))
            else:
                emb.coll.append(("fwd", "all_reduce", "tp", full, True,
                                 False))
        emb.in_b = ids_b
        emb.out_b = out_b
        if st.enable_dropout:
            return [emb, self._dropout("embedding_dropout", out_b)]
        return [emb]

    def _post_leaves(self, b: int, preprocess: bool) -> List[_Leaf]:
        st, m = self.st, self.model
        e = st.element_size
        tp = st.tp_size
        sp = st.enable_sequence_parallel
        s_sp = (st.seq_len // st.cp_size) // tp if sp \
            else st.seq_len // st.cp_size
        s_out = s_sp * tp if (sp and tp > 1) else s_sp
        h = m.hidden_size
        A = b * s_sp * h * e
        fnorm = self._norm("final_norm", A, b * s_sp, h)
        count = m.untie_embeddings or not preprocess
        out_local = m.padded_vocab_size // tp
        rows = b * s_out
        head = self._linear("lm_head", rows, h, out_local,
                            float(h * out_local), sp_comm=True, col=True,
                            count_params=count)
        head.cache_raw = A
        if sp and tp > 1:
            head.fwd_temp = head.fwd_temp + A * tp
            head.bwd_temp = head.bwd_temp + A * tp
        head.in_b = A
        head.out_b = rows * out_local * e

        ce = _Leaf("parallel_ce")
        lg = rows * out_local * e
        ce.accessed = {"fwd": 2 * lg, "bwd_act": 2 * lg}
        ce.op_key = {"fwd": "default", "bwd_act": "default"}
        bw = "ce_fusion" if st.use_fused_ce else "ce"
        ce.bw_key = {"fwd": bw, "bwd_act": bw}
        ce.cache_raw = lg + rows * 4.0
        if tp > 1:
            scalar = rows * 4.0
            ncalls = 2 if st.use_fused_ce else 3
            for _ in range(ncalls):
                ce.coll.append(("fwd", "all_reduce", "tp", scalar, True,
                                False))
        ce.in_b = lg
        ce.out_b = rows * 4.0
        return [fnorm, head, ce]

    # -- recompute wiring --------------------------------------------------
    def _wire_block(self, leaves: List[_Leaf], recompute: bool):
        """Apply the recompute segment marking of
        ``LLMBlock._wire_recompute`` (incl. the megatron tail-module /
        ``recompute_variance`` variance-tail model and the
        moe_act / mla_up_proj module granularities) + the cache
        overrides of ``MetaModule._comp_leaf_info`` and the
        ``offload_groupgemm_col_inputs`` host-offload of
        ``GroupLinearCol`` to one block's leaf list."""
        rc = self.st.recompute
        for lf in leaves:
            lf.cache_eff = lf.cache_raw
            lf.rc = False
            lf.seg = None
            lf.variance_tail = False
        if recompute and rc.enabled:
            self._mark_segments(leaves)
        # GroupLinearCol host offload (reference moe_module.py:962-979):
        # applies only OUTSIDE recompute segments — a replay regenerates
        # the input in HBM, so there is nothing to offload there
        if self.st.offload_groupgemm_col_inputs:
            for lf in leaves:
                if lf.name == "group_linear_col" and not lf.rc:
                    lf.bwd_temp = lf.bwd_temp + lf.cache_raw
                    lf.cache_raw = 0.0
                    lf.cache_eff = 0.0

    def _mark_segments(self, leaves: List[_Leaf]):
        rc = self.st.recompute
        parts = self._last_block_parts
        segments: List[List[_Leaf]] = []

        def mark(seg_leaves: List[_Leaf], variance=None):
            fresh = [l for l in seg_leaves if not l.rc]
            if not fresh:
                return
            seg_id = len(segments)
            segments.append(fresh)
            for i, l in enumerate(fresh):
                l.rc = True
                l.seg = seg_id
                l.cache_eff = 0.0
                if i == 0:
                    # FIRST leaf keeps the segment input cached
                    l.cache_eff = l.in_b
            # mark_recompute: variance=None follows the strategy's
            # global flag; the LAST claimed leaf becomes the tail
            if variance is None:
                variance = rc.variance
            if variance:
                fresh[-1].variance_tail = True
        if rc.granularity == "full_block":
            mark(list(leaves))
            return

        def tail(module_name):
            # megatron tail modules force the tail model on exactly
            # their own segments; None -> the global variance flag
            return True if module_name in rc.tail_modules else None

        # selective — same claim order as _wire_recompute
        attn = parts["attention"]
        if rc.sdp_recompute:
            for c in [l for l in attn if l.is_core]:
                mark([c])
        if rc.attn_recompute:
            mark(list(attn))
        if rc.attn_norm_recompute:
            mark([parts["input_norm"]], variance=tail("layernorm"))
            for l in attn:
                if l.name in ("kv_norm", "q_norm"):
                    mark([l], variance=tail("layernorm"))
        if rc.mla_up_proj_recompute:
            # MLA up-projections only: latent caches stay, the big
            # q/kv expansions replay
            for name in ("q_up", "kv_up"):
                for l in attn:
                    if l.name == name:
                        mark([l], variance=tail("mla_up_proj"))
        if rc.mlp_recompute:
            mark(list(parts["mlp"]))
        if rc.mlp_norm_recompute:
            mark([parts["pre_mlp_norm"]], variance=tail("layernorm"))
        if rc.moe_act_recompute and parts["is_moe"] \
                and not rc.mlp_recompute:
            # expert activation only; skipped when the whole mlp is
            # already one segment
            for l in parts["mlp"]:
                if l.name in ("expert_swiglu", "expert_gelu"):
                    mark([l], variance=tail("moe_act"))

    # -- leaf costing ------------------------------------------------------
    def _cost_leaves(self, leaves: List[_Leaf]):
        """Fill per-leaf per-phase cost values (mirror of
        ``MetaModule._comp_leaf_info``; scalar mode)."""
        roofline = self._roofline
        for lf in leaves:
            for ph in ("fwd", "bwd_act", "bwd_w"):
                f = lf.flops.get(ph, 0.0)
                a = lf.accessed.get(ph, 0.0)
                have_f = f > 0
                have_a = a > 0
                if not have_f and not have_a:
                    setattr(lf, f"cost_{ph}", 0.0)
                    continue
                comp = self._comp_time(lf.op_key.get(ph, "default"), f,
                                       lf.key_fn.get(ph)) \
                    if have_f else 0.0
                mem = self._mem_time(a, lf.bw_key.get(ph, "default")) \
                    if have_a else 0.0
                t = max(comp, mem) if roofline else comp
                setattr(lf, f"cost_{ph}", t)
            net = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
            fsdp = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
            cph = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
            for (ph, op, dim, size, exposed, is_fsdp) in lf.coll:
                t = self._net_time(dim, op, size)
                if exposed:
                    net[ph] = net[ph] + t
                elif lf.is_cp:
                    # async-CP a2a: hidden under the attention-core
                    # compute; the excess is re-exposed in
                    # _block_totals (bound_async_cp_overlap mirror)
                    cph[ph] = cph[ph] + t
                if is_fsdp:
                    fsdp[ph] = fsdp[ph] + t
            lf.net_fwd, lf.net_bwd_act, lf.net_bwd_w = (
                net["fwd"], net["bwd_act"], net["bwd_w"])
            lf.fsdp = fsdp
            lf.cp_hidden = cph

    def _block_totals(self, leaves: List[_Leaf],
                      expose_fsdp: bool = True) -> dict:
        """Aggregate one block kind: times (incl. the FSDP overlap
        re-exposure of ``LLMBlock._post_forward`` — transformer blocks
        only; embedding/head leaves sit directly under ``LLMModel``,
        which has no re-exposure hook, so their FSDP collectives stay
        hidden), caches, params, and the activation-replay probe
        profile. Scalar mode: one float per quantity."""
        comp = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
        net = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
        fsdp_tot = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
        core_comp = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
        cp_hidden = {"fwd": 0.0, "bwd_act": 0.0, "bwd_w": 0.0}
        rc_cp_fwd = 0.0
        fsdp_rc_fwd = 0.0
        recompute_t = 0.0
        for lf in leaves:
            comp["fwd"] += lf.cost_fwd
            comp["bwd_act"] += lf.cost_bwd_act
            comp["bwd_w"] += lf.cost_bwd_w
            net["fwd"] += lf.net_fwd
            net["bwd_act"] += lf.net_bwd_act
            net["bwd_w"] += lf.net_bwd_w
            for ph in ("fwd", "bwd_act", "bwd_w"):
                fsdp_tot[ph] += lf.fsdp[ph]
                cp_hidden[ph] += lf.cp_hidden[ph]
            if lf.is_core:
                core_comp["fwd"] += lf.cost_fwd
                core_comp["bwd_act"] += lf.cost_bwd_act
            if lf.rc:
                if not lf.variance_tail:
                    recompute_t += lf.cost_fwd + lf.net_fwd
                # the re-exposure shares below land on ANY checkpointed
                # leaf's recompute_time (expose_unhidden has no
                # variance-tail carve-out)
                fsdp_rc_fwd += lf.fsdp["fwd"]
                rc_cp_fwd += lf.cp_hidden["fwd"]
        # async-CP re-exposure (bound_async_cp_overlap): the a2a hides
        # only under the attention-core compute; the excess returns to
        # the critical path before the block-level FSDP hook runs
        for ph in ("fwd", "bwd_act"):
            hidden = cp_hidden[ph]
            if hidden <= 0:
                continue
            extra = max(hidden - core_comp[ph], 0.0)
            net[ph] += extra
            if ph == "fwd" and extra > 0:
                recompute_t += extra * (rc_cp_fwd / hidden)
            cp_hidden[ph] = hidden - extra  # still-hidden remainder
        # FSDP re-exposure (zero>=3): hidden beyond the block's own
        # compute budget returns to the critical path — the compute
        # already granted to async-CP hiding is not available twice;
        # the recompute replay picks up its leaves' share of the fwd
        # extra
        if expose_fsdp and self.st.zero_state >= 3:
            for ph in ("fwd", "bwd_act", "bwd_w"):
                hidden = fsdp_tot[ph]
                if hidden <= 0:
                    continue
                budget = max(comp[ph] - cp_hidden[ph], 0.0)
                extra = max(hidden - budget, 0.0)
                net[ph] += extra
                if ph == "fwd":
                    recompute_t += extra * (fsdp_rc_fwd / hidden)
        fwd_time = comp["fwd"] + net["fwd"]
        bwd_time = (comp["bwd_act"] + net["bwd_act"]
                    + comp["bwd_w"] + net["bwd_w"] + recompute_t)
        cache = 0.0
        for lf in leaves:
            cache = cache + lf.cache_eff
        dn = mn = 0.0
        for lf in leaves:
            if lf.moe:
                mn += lf.numel
            else:
                dn += lf.numel
        probes, delta = self._profile(leaves)
        return {
            "fwd": fwd_time, "bwd": bwd_time, "cache": cache,
            "dense_numel": dn, "moe_numel": mn,
            # exposed-comm share of this block's step time — guided
            # search Pareto telemetry only, never a parity surface
            "net": net["fwd"] + net["bwd_act"] + net["bwd_w"],
            # every probe of one block shares its entry-live anchor, so
            # the stage composition only ever needs the block's max
            "probe_max": max(probes) if probes else float("-inf"),
            "delta": delta,
        }

    @staticmethod
    def _profile(leaves: List[_Leaf]):
        """Activation replay of ONE block kind — the exact event stream
        of ``LLMModel.activation_events`` restricted to these leaves.
        Returns (probe values relative to block-entry live, cache
        delta); scalar mode."""
        live = 0.0
        probes: List[float] = []
        for lf in leaves:
            live = live + lf.cache_eff
            probes.append(live + lf.fwd_temp)
        delta = live
        done = set()
        i = len(leaves) - 1
        while i >= 0:
            lf = leaves[i]
            if id(lf) in done:
                i -= 1
                continue
            if lf.rc and lf.seg is not None:
                seg_leaves = [l for l in leaves if l.seg == lf.seg]
                saved = seg_leaves[0].cache_eff
                tail_is_first = seg_leaves[0].variance_tail
                for sl in seg_leaves:
                    if sl.variance_tail:
                        continue
                    live = live + sl.cache_raw
                    cand = live + (-saved)
                    cand = cand + sl.fwd_temp
                    probes.append(cand)
                if not tail_is_first:
                    live = live - saved
                for sl in reversed(seg_leaves):
                    cand = live + sl.bwd_temp
                    cand = cand + (sl.in_b + sl.out_b)
                    probes.append(cand)
                    if sl.variance_tail:
                        if sl is seg_leaves[0]:
                            live = live - saved
                    else:
                        live = live - sl.cache_raw
                    done.add(id(sl))
                i -= 1
                continue
            cand = live + lf.bwd_temp
            cand = cand + (lf.in_b + lf.out_b)
            probes.append(cand)
            live = live - lf.cache_eff
            done.add(id(lf))
            i -= 1
        assert abs(live) < 1024, (
            "batched activation conservation violated"
        )
        return probes, delta

    # -- scoring -----------------------------------------------------------
    def score(self, mbs: Sequence[int], mbc: Sequence[int],
              nrc: Optional[Sequence[int]] = None,
              cost_margin: Optional[float] = None,
              backend: str = "auto",
              fold_batch: Optional[FoldBatch] = None,
              device: str = "cuda") -> Optional[dict]:
        """Score a candidate batch: arrays of ``micro_batch_size``,
        ``micro_batch_num``, and (for full-block recompute) the probed
        ``recompute_layer_num`` per candidate. Returns per-candidate
        arrays mirroring the scalar ``analysis_mem``/``analysis_cost``
        headline numbers, or ``None`` when the whole family is invalid
        (the scalar path would raise ``ConfigError`` for every split).

        ``cost_margin`` (GiB) enables the selection fast path: the 1F1B
        replay is skipped for candidates that do not fit under that
        feasibility margin (their ``iter_time`` comes back ``inf`` /
        ``mfu`` 0) — the selection walks never consume the cost of a
        non-fitting candidate. Pass ``None`` for full scoring (the
        parity tests do).

        ``fold_batch`` defers the schedule fold into a sweep-wide
        :class:`FoldBatch`: instead of the score dict, the call
        returns a zero-arg thunk that yields it after
        ``fold_batch.run()`` — the cross-cell batching behind
        ``BatchedScorer.screen_cells``. (``None`` for a whole-family
        invalid result is still returned directly.)

        ``device`` is where an inline kernel fold runs: ``"cuda"``
        launches the kernel, ``"cpu"`` runs its plain version."""
        if self.invalid is not None:
            return None
        st, m = self.st, self.model
        bi = [int(x) for x in mbs]
        ncand = len(bi)
        mbc_a = np.array([int(x) for x in mbc], dtype=float)
        rc = st.recompute
        if nrc is None:
            if rc.enabled:
                nrc_a = np.full(ncand, rc.recompute_layer_num)
            else:
                nrc_a = np.zeros(ncand)
        else:
            nrc_a = np.array([int(x) for x in nrc], dtype=float)
        # -1 => all layers in the stage recompute
        pp = st.pp_size
        e = st.element_size
        tp = st.tp_size
        sp = st.enable_sequence_parallel
        s_sp = (st.seq_len // st.cp_size) // tp if sp \
            else st.seq_len // st.cp_size
        zeros = np.zeros(ncand)

        # unique-mbs dedup: profiles are elementwise in mbs, so build at
        # unique-b resolution and expand via fancy indexing
        ub = sorted(set(bi))
        ub_t = tuple(ub)
        idx = np.array([ub.index(x) for x in bi])
        bu = np.array(ub, dtype=float)
        nu = len(ub)
        b = bu[idx]  # per-candidate float mbs (used for shapes below)

        def expand(v):
            return v[idx] if isinstance(v, np.ndarray) else v

        rc_active = rc.enabled or nrc is not None
        wiring = (
            ("rc", rc.granularity, rc.sdp_recompute, rc.attn_recompute,
             rc.attn_norm_recompute, rc.mlp_recompute,
             rc.mlp_norm_recompute, rc.moe_act_recompute,
             rc.mla_up_proj_recompute, rc.variance,
             tuple(sorted(rc.tail_modules)))
            if rc.enabled else ("plain",)
        )
        dense_layers = m.dense_layer_num if m.model_type == "moe" \
            else m.layer_num

        def _assemble(parts: List[dict]) -> dict:
            return {
                "fwd": np.array([p["fwd"] for p in parts]),
                "bwd": np.array([p["bwd"] for p in parts]),
                "cache": np.array([p["cache"] for p in parts]),
                "delta": np.array([p["delta"] for p in parts]),
                "dense_numel": parts[0]["dense_numel"],
                "moe_numel": parts[0]["moe_numel"],
                "net": np.array([p.get("net", 0.0) for p in parts]),
                "probe_max": np.array([p["probe_max"] for p in parts]),
            }

        def kind(is_moe: bool, recompute: bool) -> dict:
            wir = wiring if (recompute and rc.enabled) else ("plain",)
            akey = self._kind_key(("block-batch", is_moe), ub_t, wir)
            got = self._shared.get(akey)
            if got is None:
                parts = []
                for bv in ub:
                    k1 = self._kind_key(("block", is_moe), bv, wir)
                    p = self._shared.get(k1)
                    if p is None:
                        leaves = self._block_leaves(bv, is_moe)
                        self._wire_block(leaves, recompute and rc.enabled)
                        self._cost_leaves(leaves)
                        p = self._block_totals(leaves)
                        self._shared[k1] = p
                    parts.append(p)
                got = _assemble(parts)
                self._shared[akey] = got
            return got

        def boundary_totals(tag, builder) -> dict:
            akey = self._kind_key(tag + ("batch",), ub_t, ())
            got = self._shared.get(akey)
            if got is None:
                parts = []
                for bv in ub:
                    k1 = self._kind_key(tag, bv, ())
                    p = self._shared.get(k1)
                    if p is None:
                        leaves = builder(bv)
                        self._wire_block(leaves, False)
                        self._cost_leaves(leaves)
                        p = self._block_totals(leaves, expose_fsdp=False)
                        self._shared[k1] = p
                    parts.append(p)
                got = _assemble(parts)
                self._shared[akey] = got
            return got

        NEG = np.full(ncand, -np.inf)
        vp = st.vp_size
        total_v = pp * vp
        # per-(stage, chunk) composition in virtual-stage order (the
        # layer offsets PerfLLM.build walks); at vp=1 this is exactly
        # the historical per-stage loop
        chunk_fwd: Dict[tuple, object] = {}
        chunk_bwd: Dict[tuple, object] = {}
        chunk_cache: Dict[tuple, object] = {}
        chunk_peak: Dict[tuple, object] = {}
        chunk_net: Dict[tuple, object] = {}
        chunk_params: Dict[tuple, tuple] = {}
        offset = 0
        for v in range(total_v):
            c, s = divmod(v, pp)
            L_s = self.counts[s][c]
            preprocess = v == 0
            postprocess = v == total_v - 1
            boundary = min(max(dense_layers - offset, 0), L_s)
            # run lengths (arrays): rc region = idx_in_stage < nrc,
            # where idx_in_stage is the layer's index within ITS chunk
            nrc_s = np.where(nrc_a < 0, float(L_s),
                             np.minimum(nrc_a, float(L_s)))
            if not rc_active:
                nrc_s = zeros
            n_rcd = np.minimum(nrc_s, float(boundary))
            n_rcm = nrc_s - n_rcd
            n_pld = float(boundary) - n_rcd
            n_plm = (float(L_s) - float(boundary)) - n_rcm
            runs = []
            if L_s:
                need_rc = rc_active and float(np.max(nrc_s)) > 0
                need_plain = (not rc_active
                              or float(np.min(nrc_s)) < float(L_s))
                if boundary and need_rc:
                    runs.append((kind(False, True), n_rcd))
                if L_s - boundary and need_rc:
                    runs.append((kind(True, True), n_rcm))
                if boundary and need_plain:
                    runs.append((kind(False, False), n_pld))
                if L_s - boundary and need_plain:
                    runs.append((kind(True, False), n_plm))
            fwd = zeros
            bwd = zeros
            cache = zeros
            net = zeros
            dn = mn = 0.0
            peak_rows = []
            live = zeros
            if preprocess:
                pre_tot = boundary_totals(
                    ("pre",), lambda bv: self._pre_leaves(bv))
                fwd = fwd + expand(pre_tot["fwd"])
                bwd = bwd + expand(pre_tot["bwd"])
                cache = cache + expand(pre_tot["cache"])
                net = net + expand(pre_tot["net"])
                dn += pre_tot["dense_numel"]
                peak_rows.append(live + expand(pre_tot["probe_max"]))
                live = live + expand(pre_tot["delta"])
            for tot, cnt in runs:
                fwd = fwd + cnt * expand(tot["fwd"])
                bwd = bwd + cnt * expand(tot["bwd"])
                cache = cache + cnt * expand(tot["cache"])
                net = net + cnt * expand(tot["net"])
                delta = expand(tot["delta"])
                peak_entry = live + (cnt - 1.0) * delta
                peak_rows.append(
                    np.where(cnt > 0,
                             peak_entry + expand(tot["probe_max"]), NEG))
                live = live + cnt * delta
            # params are batch/recompute-independent: count by layer
            # kind (the rc and plain variants own identical parameters)
            if L_s and boundary:
                dk = (kind(False, True) if (rc_active
                                            and float(np.max(nrc_s)) > 0)
                      else kind(False, False))
                dn += boundary * dk["dense_numel"]
                mn += boundary * dk["moe_numel"]
            if L_s and L_s - boundary:
                mk = (kind(True, True) if (rc_active
                                           and float(np.max(nrc_s)) > 0)
                      else kind(True, False))
                dn += (L_s - boundary) * mk["dense_numel"]
                mn += (L_s - boundary) * mk["moe_numel"]
            if postprocess:
                post_tot = boundary_totals(
                    ("post", preprocess),
                    lambda bv: self._post_leaves(bv, preprocess))
                fwd = fwd + expand(post_tot["fwd"])
                bwd = bwd + expand(post_tot["bwd"])
                cache = cache + expand(post_tot["cache"])
                net = net + expand(post_tot["net"])
                dn += post_tot["dense_numel"]
                peak_rows.append(live + expand(post_tot["probe_max"]))
                live = live + expand(post_tot["delta"])
            peak_pt = np.maximum(
                np.max(np.stack(peak_rows), axis=0) if peak_rows else zeros,
                0.0)
            chunk_fwd[(s, c)] = fwd
            chunk_bwd[(s, c)] = bwd
            chunk_cache[(s, c)] = cache
            chunk_peak[(s, c)] = peak_pt
            chunk_net[(s, c)] = net
            chunk_params[(s, c)] = (dn, mn)
            offset += L_s

        stage_fwd, stage_bwd = [], []
        stage_peak, stage_cache, stage_model = [], [], []
        stage_params, stage_net = [], []
        for s in range(pp):
            fwd = bwd = cache = net = zeros
            dn = mn = 0.0
            for c in range(vp):
                fwd = fwd + chunk_fwd[(s, c)]
                bwd = bwd + chunk_bwd[(s, c)]
                cache = cache + chunk_cache[(s, c)]
                net = net + chunk_net[(s, c)]
                dn += chunk_params[(s, c)][0]
                mn += chunk_params[(s, c)][1]
            w, g, s_b = self._pinfo(dn, False)
            mw, mg, ms = self._pinfo(mn, True)
            stage_fwd.append(fwd)
            stage_bwd.append(bwd)
            stage_cache.append(cache)
            stage_peak.append(chunk_peak[(s, 0)])
            stage_model.append(w + g + s_b + mw + mg + ms)
            stage_net.append(net)
            stage_params.append({
                "dense_numel": dn, "moe_numel": mn,
            })

        # ---- memory (analysis_mem)
        cap = self.system.mem_bytes * st.mem_factor
        if vp > 1:
            max_peak = self._interleaved_peaks(
                chunk_cache, chunk_peak, stage_model, mbc_a, ncand)
        else:
            peaks = []
            for s in range(pp):
                live_mb = np.minimum(mbc_a, float(pp - s))
                peaks.append(
                    stage_model[s]
                    + np.maximum(live_mb - 1.0, 0.0) * stage_cache[s]
                    + stage_peak[s])
            max_peak = np.max(np.stack(peaks), axis=0)

        # ---- cost (analysis_cost)
        boundary_bytes = b * s_sp * m.hidden_size * e
        p2p_t = self._net_time("pp", "p2p", boundary_bytes) if pp > 1 \
            else zeros
        dp_rs, dp_ag = [], []
        optim = []
        for s in range(pp):
            rs, ag = self._dp_terms(s, stage_params[s], mbc_a, ncand,
                                    stage_fwd[s], stage_bwd[s])
            dp_rs.append(rs)
            dp_ag.append(ag)
            optim.append(self._optim_time(stage_params[s]))
        if cost_margin is None:
            need_cost = [True] * ncand
        else:
            cap_fit = cap - cost_margin * GiB
            need_cost = [bool(max_peak[i] <= cap_fit)
                         for i in range(ncand)]
        # the schedule fold — the only sequential recurrence left —
        # rides a _FoldJob: inline it dispatches right here (cuda
        # backend: candidates sharing a schedule shape ride one
        # kernel launch — 1F1B and the interleaved vp>1 fold alike —
        # bit-identical to the numpy fold, pinned in tests); deferred
        # (``fold_batch``) the job joins a sweep-wide cross-cell batch
        # and this call returns a thunk.
        job = _FoldJob(pp, vp, st.vpp_group_size, st.pp_comm_async,
                       mbc_a, need_cost, stage_fwd, stage_bwd,
                       chunk_fwd, chunk_bwd, p2p_t)

        def finalize(totals, ends):
            barrier = np.max(
                np.stack([ends[s] + dp_rs[s] for s in range(pp)]),
                axis=0)
            tail = np.max(
                np.stack([optim[s] + dp_ag[s] for s in range(pp)]),
                axis=0)
            iter_time = (barrier + tail) * self.straggle

            tokens = b * mbc_a * st.dp_size * st.seq_len
            model_flops = self._flops_per_token * tokens
            per_chip = model_flops / st.world_size / iter_time
            peak_flops = \
                self.system.accelerator.op["default"].tflops * 1e12
            # exposed-comm share — guided-search Pareto telemetry
            # (NOT a scalar-parity surface; see the JAX package's
            # docs/search.md
            # "Guided search")
            comm_time = np.max(
                np.stack([mbc_a * stage_net[s] + dp_rs[s] + dp_ag[s]
                          for s in range(pp)]), axis=0)
            return {
                "iter_time": iter_time,
                "mfu": per_chip / peak_flops,
                "tgs": tokens / iter_time / st.world_size,
                "max_peak_bytes": max_peak,
                "fits_margin_bytes": cap - max_peak,
                "usable_bytes": cap,
                "comm_time": comm_time,
                "comm_fraction": np.where(
                    np.isfinite(iter_time) & (iter_time > 0),
                    comm_time / np.where(iter_time > 0, iter_time,
                                         1.0),
                    0.0),
            }

        job.finalize = finalize
        if fold_batch is not None:
            return fold_batch.defer(job)
        _fold_job(job, backend, device)
        return job.finalize(job.totals, job.ends)

    def _interleaved_peaks(self, chunk_cache, chunk_peak, stage_model,
                           mbc_a, ncand):
        """vp>1 per-stage peak: the SAME schedule-position replay
        ``PerfLLM._analysis_mem_interleaved`` folds
        (``perf.interleaved_stage_peak``), per candidate."""
        from simumax_tpu_torch.parallel.pipeline import interleaved_order
        from simumax_tpu_torch.perf import interleaved_stage_peak

        st = self.st
        pp, vp = st.pp_size, st.vp_size
        max_peak = np.empty(ncand)
        orders_by_mbc: Dict[int, list] = {}
        for i in range(ncand):
            mbc_i = int(mbc_a[i])
            orders = orders_by_mbc.get(mbc_i)
            if orders is None:
                orders = [
                    interleaved_order(pp, s, mbc_i, vp,
                                      st.vpp_group_size)
                    for s in range(pp)
                ]
                orders_by_mbc[mbc_i] = orders
            peak_i = -math.inf
            for s in range(pp):
                cache = {c: float(chunk_cache[(s, c)][i])
                         for c in range(vp)}
                peakpt = {c: float(chunk_peak[(s, c)][i])
                          for c in range(vp)}
                peak_sched, _, _, _ = interleaved_stage_peak(
                    orders[s], cache, peakpt)
                peak_i = max(peak_i, stage_model[s] + peak_sched)
            max_peak[i] = peak_i
        return max_peak

    def _bucket_info(self, numel: float, group: int) -> Tuple[int, float]:
        """Megatron DDP bucket (count, last-bucket numel) from the SAME
        sizing helper the scalar path (and the simulator) use — one
        source, so a cap or partial-bucket tweak can never
        desynchronize the engines. Memoized: numel/group are layout
        constants re-queried per score call."""
        cache = getattr(self, "_bucket_counts", None)
        if cache is None:
            cache = self._bucket_counts = {}
        key = (numel, group)
        got = cache.get(key)
        if got is None:
            from simumax_tpu_torch.core.utils import dp_comm_buckets

            buckets = dp_comm_buckets(numel, group)
            got = (len(buckets), buckets[-1] if buckets else 0.0)
            cache[key] = got
        return got

    def _dp_terms(self, stage: int, params: dict, mbc_a, ncand,
                  stage_fwd, stage_bwd):
        """Exposed (reduce-scatter, all-gather) DP comm per stage —
        mirror of ``PerfLLM._compute_dp_time`` including the Megatron
        ``overlap_grad_reduce`` / ``overlap_param_gather`` hiding
        (``stage_fwd``/``stage_bwd`` are the stage's per-microbatch
        phase times, the overlap budgets)."""
        st, m = self.st, self.model
        zeros = np.zeros(ncand)
        g_el = 2.0 if st.grad_reduce_in_bf16 else 4.0
        p_el = st.element_size
        rs = zeros
        ag = zeros
        last_bucket_times = []  # per stream: its final bucket's rs time
        dense_numel = params["dense_numel"]
        moe_numel = params["moe_numel"]
        for numel, dim, group in (
            (dense_numel, "dp_cp", st.dp_size * st.cp_size),
            (moe_numel, "edp", st.edp_size),
        ):
            if group <= 1 or not numel or st.zero_state >= 3:
                continue
            op = "reduce_scatter" if st.zero_state >= 1 else "all_reduce"
            nbuckets, last_nb = self._bucket_info(numel, group)
            k_rs, l_rs = self._coeffs(dim, op)
            r = k_rs * (numel * g_el) + nbuckets * l_rs
            last_bucket_times.append(k_rs * (last_nb * g_el) + l_rs)
            if st.zero_state == 2:
                r = r * mbc_a
            rs = rs + r
            if st.zero_state >= 1:
                k_ag, l_ag = self._coeffs(dim, "all_gather")
                ag = ag + k_ag * (numel * p_el) + nbuckets * l_ag
        tied = 0.0
        if (st.pp_size > 1 and not m.untie_embeddings
                and stage in (0, st.pp_size - 1)):
            emb_grad = (m.padded_vocab_size * m.hidden_size
                        / st.tp_size * st.grad_element_size)
            tied = 2 * self._net_time("pp", "p2p", emb_grad)
        # Megatron overlap flags: the bucketed grad reduce hides under
        # the backward (per microbatch at ZeRO-2, the last microbatch
        # otherwise — each stream's FINAL bucket is never hideable);
        # the ZeRO-1 param all-gather hides under the next iteration's
        # first forward chunk (1/vp of the stage's forward)
        if st.overlap_grad_reduce or st.overlap_param_gather:
            active = (rs + ag + tied) > 0
            if st.overlap_grad_reduce:
                n_windows = mbc_a if st.zero_state == 2 else 1.0
                bkt_tail = max(last_bucket_times) \
                    if last_bucket_times else 0.0
                hidden = np.minimum(
                    np.maximum(rs - bkt_tail * n_windows, 0.0),
                    stage_bwd * n_windows)
                rs = rs - np.where(active, hidden, 0.0)
            if st.overlap_param_gather:
                hidden = np.minimum(ag, stage_fwd / st.vp_size)
                ag = ag - np.where(active, hidden, 0.0)
        return rs + tied, ag

    def _optim_time(self, params: dict) -> float:
        """Mirror of ``PerfLLM._compute_optim_time`` (scalar: params are
        layout-only)."""
        st = self.st
        sysc = self.system
        numel = params["dense_numel"] + params["moe_numel"]
        shard = numel / max(1, st.dp_size * st.cp_size) \
            if st.zero_state else numel
        if st.optimizer_style == "functional":
            e = st.element_size
            traffic = shard * (st.grad_element_size + 2 * e + 16)
            return sysc.compute_mem_access_time(traffic,
                                                bw_key="fused_adam")
        t = 0.0
        t += sysc.compute_mem_access_time(numel * st.grad_element_size)
        t += sysc.compute_mem_access_time(shard * 4)
        t += sysc.compute_mem_access_time(shard * 28)
        t += sysc.compute_mem_access_time(shard * (4 + st.element_size))
        return t


# --------------------------------------------------------------------------
# Cell-level engine: mirrors _evaluate_sweep_cell's selection walk
# --------------------------------------------------------------------------


class BatchedScorer:
    """Per-sweep cache of family kernels + the cell-selection walk that
    mirrors ``searcher._evaluate_sweep_cell`` decision-for-decision,
    consulting batched scores instead of scalar estimates. The winning
    candidate of each cell is returned as a (row, strategy, margin)
    triple so the orchestrator can re-verify top-k rows with the scalar
    oracle."""

    #: strategy fields erased from the kernel-cache key (the candidate
    #: axes the kernel vectorizes over)
    BATCH_FIELDS = ("micro_batch_size", "micro_batch_num",
                    "recompute_layer_num")

    def __init__(self, model: ModelConfig, system: SystemConfig,
                 backend: str = "auto", device: str = "cuda"):
        check_fold_backend(backend, device)
        self.model = model
        self.system = system
        #: fold execution backend: "numpy" | "cuda" | "auto" (the kernel
        #: for large candidate groups — results are bit-identical
        #: either way)
        self.backend = backend
        #: where the kernel folds run: "cuda" (the card) or "cpu" (the
        #: kernel's plain version)
        self.device = device
        self._kernels: Dict[tuple, _Kernel] = {}
        #: block-kind profile cache shared across family kernels (see
        #: ``_Kernel._kind_key`` — profiles are pp/mbc-independent)
        self._kind_cache: dict = {}
        #: scoring telemetry (surfaced by bench_sweep --engine batched)
        self.stats = {"score_calls": 0, "max_batch": 0,
                      "candidates_scored": 0}
        #: {(pp, vp, mbc, group): members} the last
        #: :meth:`screen_cells` batch dispatched to the kernel
        self.last_screen_jit: Dict[tuple, int] = {}

    _KEY_GETTER = None  # operator.attrgetter over the non-batch fields

    def kernel_for(self, st: StrategyConfig) -> _Kernel:
        cls = type(self)
        if cls._KEY_GETTER is None:
            import dataclasses
            import operator

            names = [f.name for f in dataclasses.fields(StrategyConfig)
                     if f.name not in self.BATCH_FIELDS]
            cls._KEY_GETTER = operator.attrgetter(*names)
        key = tuple(
            (tuple(v) if isinstance(v, list) else v)
            for v in cls._KEY_GETTER(st)
        )
        got = self._kernels.get(key)
        if got is None:
            got = _Kernel(st, self.model, self.system,
                          shared_cache=self._kind_cache)
            self._kernels[key] = got
        return got

    # -- rows --------------------------------------------------------------
    def _row(self, st: StrategyConfig, kern: _Kernel, scores: dict,
             i: int, gib_margin: float) -> dict:
        fits = bool(
            scores["max_peak_bytes"][i] + gib_margin * GiB
            <= scores["usable_bytes"]
        )
        row = {
            "tp": st.tp_size, "cp": st.cp_size,
            "pp": st.pp_size, "dp": st.dp_size,
            "ep": st.ep_size, "etp": st.etp_size,
            "vp": st.vp_size,
            "mbs": st.micro_batch_size,
            "mbc": st.micro_batch_num,
            "zero": st.zero_state,
            "recompute": (
                st.recompute.granularity
                if st.recompute.enabled else "none"
            ),
            "recompute_layers": st.recompute_layer_num,
            "mfu": float(scores["mfu"][i]),
            "iter_ms": float(scores["iter_time"][i] * 1e3),
            "tgs": float(scores["tgs"][i]),
            "peak_gib": float(scores["max_peak_bytes"][i] / GiB),
            "fits": fits,
            "mem_margin_gib": float(
                (scores["fits_margin_bytes"][i] - gib_margin * GiB) / GiB
            ),
            "net": {k: p.describe() for k, p in kern.paths.items()},
            "dcn_dims": ",".join(
                d for d, p in kern.paths.items() if p.on_dcn
            ),
            # one-line attributions need a built estimate; batched rows
            # carry placeholders — the scalar re-verification of the
            # top-k fills in the real lines (the JAX package's
            # docs/search.md)
            "attribution": "",
            "mem_attribution": "",
        }
        if not fits:
            row = {**row, "mfu": 0.0}
        return row

    def _score_batch(self, st: StrategyConfig, splits, nrc=None,
                     cost_margin=None):
        kern = self.kernel_for(st)
        stats = self.stats
        stats["score_calls"] += 1
        stats["candidates_scored"] += len(splits)
        if len(splits) > stats["max_batch"]:
            stats["max_batch"] = len(splits)
        scores = kern.score([s[0] for s in splits],
                            [s[1] for s in splits], nrc=nrc,
                            cost_margin=cost_margin,
                            backend=self.backend, device=self.device)
        return kern, scores

    # -- the three family walks -------------------------------------------
    def search_micro_batch_config(self, st: StrategyConfig,
                                  global_batch_size: int,
                                  gib_margin: float = 1.0):
        dp = st.dp_size
        if dp < 1 or global_batch_size % dp:
            raise FeasibilityError(
                f"global_batch_size {global_batch_size} does not divide "
                f"over dp {dp}",
                phase="search", global_batch_size=global_batch_size, dp=dp,
            )
        per_dp = global_batch_size // dp
        splits = []
        for mbs in range(1, per_dp + 1):
            if per_dp % mbs:
                continue
            mbc = per_dp // mbs
            if st.vp_size > 1 and mbc % st.vpp_group_size:
                continue
            splits.append((mbs, mbc))
        if not splits:
            return None
        kern, scores = self._score_batch(st, splits,
                                         cost_margin=gib_margin)
        if scores is None:
            return None
        best = None
        for i, (mbs, mbc) in enumerate(splits):
            fits = bool(
                scores["max_peak_bytes"][i] + gib_margin * GiB
                <= scores["usable_bytes"]
            )
            if not fits:
                continue
            if best is None or scores["mfu"][i] > best[0]:
                cand = clone_strategy(st)
                cand.micro_batch_size = mbs
                cand.micro_batch_num = mbc
                best = (float(scores["mfu"][i]),
                        self._row(cand, kern, scores, i, gib_margin),
                        cand)
        if best is None:
            return None
        return best[1], best[2]

    def search_selective(self, st: StrategyConfig):
        from simumax_tpu_torch.search.searcher import _SELECTIVE_COMBOS

        if st.vp_size > 1 and st.micro_batch_num % st.vpp_group_size:
            # sanity_check would reject every combo at this split
            return None
        best = None
        for combo in _SELECTIVE_COMBOS:
            cand = clone_strategy(st)
            cand.enable_recompute = True
            cand.recompute_granularity = "selective"
            cand.recompute_layer_num = -1
            for k, v in combo.items():
                setattr(cand, k, v)
            cand.__post_init__()
            kern, scores = self._score_batch(
                cand, [(cand.micro_batch_size, cand.micro_batch_num)],
                cost_margin=0.0)
            if scores is None:
                continue
            fits = bool(scores["max_peak_bytes"][0]
                        <= scores["usable_bytes"])
            if not fits:
                continue
            if best is None or scores["mfu"][0] > best[0]:
                best = (float(scores["mfu"][0]),
                        self._row(cand, kern, scores, 0, 0.0), cand)
        if best is None:
            return None
        return best[1], best[2]

    def search_recompute_layers(self, st: StrategyConfig,
                                model: ModelConfig):
        if st.vp_size > 1 and st.micro_batch_num % st.vpp_group_size:
            # sanity_check would reject every probed layer count
            return None
        layers_per_stage = -(-model.layer_num
                             // (st.pp_size * st.vp_size))
        probe = clone_strategy(st)
        probe.enable_recompute = True
        probe.recompute_granularity = "full_block"
        probe.recompute_layer_num = -1
        probe.__post_init__()
        kern = self.kernel_for(probe)
        # the n=0 probe is a no-recompute estimate in the scalar walk
        # (enable_recompute = mid > 0); its numbers coincide with the
        # full_block kernel at zero recomputed layers, but the winning
        # row must carry recompute='none'.
        # pp=1 folds are closed-form: score the whole layer range in one
        # call; deeper pipelines probe lazily along the bisection (a
        # replay per probed count, not per possible count)
        stats = self.stats

        def _scored(n):
            stats["score_calls"] += 1
            stats["candidates_scored"] += n
            if n > stats["max_batch"]:
                stats["max_batch"] = n

        if st.pp_size == 1:
            all_n = list(range(0, layers_per_stage + 1))
            _scored(len(all_n))
            scores = kern.score(
                [st.micro_batch_size] * len(all_n),
                [st.micro_batch_num] * len(all_n),
                nrc=all_n, cost_margin=0.0, backend=self.backend,
                device=self.device,
            )
            if scores is None:
                return None

            def probe_at(mid):
                return scores, mid
        else:
            first = kern.score([st.micro_batch_size],
                               [st.micro_batch_num], nrc=[0],
                               cost_margin=0.0, backend=self.backend,
                               device=self.device)
            _scored(1)
            if first is None:
                return None
            cache = {0: first}

            def probe_at(mid):
                got = cache.get(mid)
                if got is None:
                    _scored(1)
                    got = kern.score([st.micro_batch_size],
                                     [st.micro_batch_num], nrc=[mid],
                                     cost_margin=0.0,
                                     backend=self.backend,
                                     device=self.device)
                    cache[mid] = got
                return got, 0
        lo, hi = 0, layers_per_stage
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            sc, i = probe_at(mid)
            fits = bool(sc["max_peak_bytes"][i] <= sc["usable_bytes"])
            if fits:
                cand = clone_strategy(st)
                cand.enable_recompute = mid > 0
                cand.recompute_granularity = "full_block"
                cand.recompute_layer_num = mid
                cand.__post_init__()
                best = (self._row(cand, kern, sc, i, 0.0), cand)
                hi = mid - 1
            else:
                lo = mid + 1
        return best

    @staticmethod
    def family_strategy(st: StrategyConfig,
                        rc_family: str) -> StrategyConfig:
        """The recompute-family canonical wiring of a sweep cell —
        single source for the cell walk (:meth:`evaluate_cell`) and
        the guided screen (:meth:`screen_cell`), so the two can never
        screen one configuration and evaluate another."""
        cand = clone_strategy(st)
        if rc_family == "none":
            cand.enable_recompute = False
        elif rc_family == "selective":
            cand.enable_recompute = True
            cand.recompute_granularity = "selective"
            cand.recompute_layer_num = -1
            cand.sdp_recompute = True
        elif rc_family == "full_block":
            cand.enable_recompute = True
            cand.recompute_granularity = "full_block"
            cand.recompute_layer_num = -1
        else:
            from simumax_tpu_torch.core.config import ConfigError

            raise ConfigError(
                f"unknown recompute family {rc_family!r}",
                phase="search")
        cand.__post_init__()
        return cand

    def screen_cell(self, st: StrategyConfig, rc_family: str,
                    model: ModelConfig,
                    global_batch_size: int) -> Optional[dict]:
        """One-candidate guided-search screen of a sweep cell: score
        the family's canonical (mbs=1, mbc=per_dp) split — under the
        family's own recompute wiring — and return its
        ``{iter_time, peak_bytes, comm_fraction}`` Pareto triple, or
        ``None`` when the family is invalid (the scalar path would
        reject every split). Raises :class:`UnsupportedBatched` for
        families outside the lowering surface; the guided search then
        evaluates the cell unconditionally (conservative)."""
        if st.dp_size < 1 or global_batch_size % st.dp_size:
            return None
        per_dp = global_batch_size // st.dp_size
        st_rc = self.family_strategy(st, rc_family)
        st_rc.micro_batch_size = 1
        st_rc.micro_batch_num = per_dp
        st_rc.__post_init__()
        if st_rc.vp_size > 1 and per_dp % st_rc.vpp_group_size:
            return None
        kern = self.kernel_for(st_rc)
        scores = kern.score([1], [per_dp], backend=self.backend,
                            device=self.device)
        if scores is None:
            return None
        return {
            "iter_time": float(scores["iter_time"][0]),
            "peak_bytes": float(scores["max_peak_bytes"][0]),
            "comm_fraction": float(scores["comm_fraction"][0]),
        }

    def screen_cells(self, items, model: ModelConfig,
                     global_batch_size: int) -> list:
        """Sweep-wide batched guided screen (the second L11 follow-on):
        every cell's one-candidate screen score goes through ONE
        deferred-fold batch instead of a per-cell :meth:`screen_cell`
        call — the schedule folds of all cells sharing a (pp, vp, mbc,
        group) shape ride one kernel launch across the sweep
        (:class:`FoldBatch`), so a 500-cell screen launches a
        handful of kernels, not 500 Python folds.

        ``items`` is a sequence of ``(strategy, rc_family)``; returns
        one entry per item: the same ``{iter_time, peak_bytes,
        comm_fraction}`` triple :meth:`screen_cell` produces, ``None``
        for an invalid family, or the *exception* screen_cell would
        have raised (:class:`UnsupportedBatched` / anything else) for
        the caller to apply its conservative must-evaluate rule. The
        triples are bit-identical to per-cell screening (same float
        ops on the same values — asserted on the wide grid in the
        port's tests); :attr:`last_screen_jit` records the shape groups
        the batch dispatched to the kernel.

        A :class:`~simumax_tpu_torch.torchref.kernels.KernelError` (the
        kernel, its build or its copies failed) is raised, never
        returned: a guided sweep whose kernel failed must stop, not
        evaluate every cell and still return the right top-k."""
        from simumax_tpu_torch.torchref.kernels import KernelError

        fb = FoldBatch()
        slots: list = []
        for st, rc_family in items:
            try:
                if st.dp_size < 1 or global_batch_size % st.dp_size:
                    slots.append((0, None))
                    continue
                per_dp = global_batch_size // st.dp_size
                st_rc = self.family_strategy(st, rc_family)
                st_rc.micro_batch_size = 1
                st_rc.micro_batch_num = per_dp
                st_rc.__post_init__()
                if st_rc.vp_size > 1 and per_dp % st_rc.vpp_group_size:
                    slots.append((0, None))
                    continue
                kern = self.kernel_for(st_rc)
                got = kern.score([1], [per_dp], backend=self.backend,
                                 fold_batch=fb)
                slots.append((0, None) if got is None else (1, got))
            except KernelError:
                raise
            except Exception as exc:
                slots.append((2, exc))
        # the shared fold is one call for the whole sweep: a failure
        # inside it must degrade to the per-cell conservative
        # must-evaluate rule (every pending slot returns the error),
        # never abort the guided sweep — unless the kernel failed
        run_err: Optional[Exception] = None
        try:
            fb.run(self.backend, self.device)
        except KernelError:
            raise
        except Exception as exc:
            run_err = exc
        self.last_screen_jit = dict(fb.jit_dispatched)
        out: list = []
        for kind, val in slots:
            if kind != 1:
                out.append(val)
                continue
            if run_err is not None:
                out.append(run_err)
                continue
            try:
                scores = val()
            except Exception as exc:
                out.append(exc)
                continue
            out.append({
                "iter_time": float(scores["iter_time"][0]),
                "peak_bytes": float(scores["max_peak_bytes"][0]),
                "comm_fraction": float(scores["comm_fraction"][0]),
            })
        return out

    def evaluate_cell(self, st: StrategyConfig, rc_family: str,
                      model: ModelConfig, global_batch_size: int):
        """Mirror of ``searcher._evaluate_sweep_cell``. Returns
        ``(row, strategy, gib_margin)`` or ``None`` (empty cell);
        raises :class:`UnsupportedBatched` for configurations outside
        the lowering surface (caller falls back to the scalar path) and
        the same ``FeasibilityError`` the scalar walk raises."""
        if st.dp_size < 1 or global_batch_size % st.dp_size:
            raise FeasibilityError(
                f"global_batch_size {global_batch_size} does not divide "
                f"over dp {st.dp_size}: no (mbs, mbc) split reproduces it",
                phase="search", global_batch_size=global_batch_size,
                dp=st.dp_size,
            )
        st_rc = self.family_strategy(st, rc_family)
        if rc_family == "none":
            got = self.search_micro_batch_config(
                st_rc, global_batch_size, gib_margin=1.0)
            if got is None:
                return None
            return got[0], got[1], 1.0
        if rc_family == "selective":
            base = self.search_micro_batch_config(
                st_rc, global_batch_size, gib_margin=1.0)
            if base is not None:
                st_rc.micro_batch_size = base[1].micro_batch_size
                st_rc.micro_batch_num = base[1].micro_batch_num
            else:
                st_rc.micro_batch_size = 1
                st_rc.micro_batch_num = \
                    global_batch_size // st.dp_size
            got = self.search_selective(st_rc)
            if got is None:
                return None
            return got[0], got[1], 0.0
        # full_block (family_strategy already rejected unknown names)
        st_rc.micro_batch_size = 1
        st_rc.micro_batch_num = global_batch_size // st.dp_size
        got = self.search_recompute_layers(st_rc, model)
        if got is None:
            return None
        return got[0], got[1], 0.0


"""Sweep-cell pruning (L7): decide, *before building anything*, which
grid cells cannot possibly produce a feasible result row.

Two families of prunes, both recorded as auditable ``status=pruned`` CSV
rows instead of silent skips:

* **dominance / divisibility** — layouts whose tp*cp*pp or ep*pp does
  not divide the world size, expert parallelism on a dense model,
  ZeRO levels that duplicate the representative level when there are no
  data-parallel replicas, and global batch sizes that do not divide over
  dp. These mirror the historical silent ``continue`` guards of the
  sweep loop.
* **memory lower bound** — a closed-form per-device bound on the peak
  HBM a cell can ever reach: parameter + gradient + optimizer-state
  bytes under the cell's sharding (the components ``analysis_mem``
  reports per stage), plus the smallest possible activation footprint
  (one transformer-block input at micro_batch_size=1). If even that
  floor exceeds usable HBM, no batch split or recompute family can make
  the cell fit, so the entire ``PerfLLM`` build is skipped.

The bound must be a *true* lower bound — pruning a feasible cell would
change sweep results. It therefore under-counts on purpose (even layer
split across stages, tied embeddings counted once, replicated norms and
pipeline-replica weights ignored) and applies ``PRUNE_SAFETY`` headroom
on the parameter term to absorb model-accounting skew.

Copy of the JAX package's ``search/prune.py`` with its import paths
changed. The rest of that package's ``search/`` (the searcher, the
executor and the jitted pipeline folds) is a later slice of the port;
here this module serves ``PerfLLM.rebatched_iter_time``.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from simumax_tpu_torch.core.config import (
    GiB,
    ModelConfig,
    StrategyConfig,
    SystemConfig,
)
from simumax_tpu_torch.core.errors import FeasibilityError

#: headroom on the closed-form parameter bound: prune only when the
#: floor exceeds usable HBM by >10%, so modest accounting skew between
#: the closed form and the built model can never prune a feasible cell
PRUNE_SAFETY = 0.9


@dataclass(frozen=True)
class SweepCell:
    """One (layout, recompute-family) sweep cell scheduled for
    evaluation. ``idx`` is the cell's position in deterministic grid
    order — results are merged back in ``idx`` order so parallel and
    serial sweeps rank and dedup identically."""

    idx: int
    key: str
    tp: int
    cp: int
    ep: int
    pp: int
    zero: int
    rc: str


def clone_strategy(st: StrategyConfig) -> StrategyConfig:
    """Cheap strategy clone for sweep plumbing: shallow copy +
    ``__post_init__`` (rebuilds the derived ``recompute`` config from
    the unchanged flags). Equivalent to ``copy.deepcopy`` for the sweep
    walks — they only reassign scalar fields — at a fraction of the
    cost (a deepcopy per grid cell was a measured sweep hotspot)."""
    new = copy.copy(st)
    if st.megatron_recompute_modules is not None:
        new.megatron_recompute_modules = list(st.megatron_recompute_modules)
    new.__post_init__()
    return new


def shrink_strategy(st: StrategyConfig, replicas: int) -> StrategyConfig:
    """The dp-shrunk twin of ``st`` after losing ``replicas``
    data-parallel replicas to spot reclaim / rank death — the fleet
    simulator's elastic-reshape target layout (``fleet/sim.py``,
    docs/fleet.md). The layout shape (tp/cp/ep/pp) is unchanged;
    ``world_size`` drops by one replica's chips
    (``tp * cp * pp`` each) and ``micro_batch_num`` grows so the
    global batch is preserved across the survivors.

    Raises :class:`FeasibilityError` when the shrink is not
    well-formed: fewer replicas than lost, or a global batch that the
    surviving replicas cannot split evenly (the walk then falls back
    to rollback-restart accounting). Pair with
    :func:`memory_lower_bound` — the shrunk layout re-shards ZeRO
    state over fewer replicas, so it must also still fit HBM."""
    replicas = int(replicas)
    if replicas < 1:
        raise FeasibilityError(
            f"shrink_strategy: replicas must be >= 1, got {replicas}",
            phase="fleet",
        )
    dp_eff = st.dp_size - replicas
    if dp_eff < 1:
        raise FeasibilityError(
            f"cannot shrink dp {st.dp_size} by {replicas} replicas: "
            f"no survivors",
            phase="fleet", dp=st.dp_size, replicas=replicas,
        )
    gbs = st.global_batch_size
    if gbs % (dp_eff * st.micro_batch_size) != 0:
        raise FeasibilityError(
            f"global batch {gbs} does not split over {dp_eff} "
            f"surviving replicas at micro_batch_size "
            f"{st.micro_batch_size}",
            phase="fleet", gbs=gbs, dp_eff=dp_eff,
        )
    new = clone_strategy(st)
    new.world_size = (
        st.world_size
        - replicas * st.tp_size * st.cp_size * st.pp_size
    )
    new.micro_batch_num = gbs // (dp_eff * st.micro_batch_size)
    new.__post_init__()
    new.sanity_check()
    return new


def make_cell_strategy(
    base: StrategyConfig, tp: int, cp: int, ep: int, pp: int, zero: int
) -> StrategyConfig:
    """The candidate strategy for one grid layout — the single source
    for both the serial loop and pool workers, so they cannot diverge."""
    st = clone_strategy(base)
    st.tp_size, st.cp_size = tp, cp
    st.ep_size, st.pp_size = ep, pp
    st.zero_state = zero
    st.etp_size = min(st.etp_size, tp) or 1
    return st


def model_param_split(model: ModelConfig) -> Tuple[int, int]:
    """(dense_elements, expert_elements) for the whole model, counted
    the lower-bound way: unpadded vocab, tied embedding once."""
    dense = model.vocab_size * model.hidden_size  # embedding
    if model.untie_embeddings:
        dense += model.vocab_size * model.hidden_size  # lm head
    dense += model.hidden_size  # final norm
    expert = 0
    for i in range(model.layer_num):
        d, e = model.layer_param_elements(i)
        dense += d
        expert += e
    return dense, expert


def memory_lower_bound(st: StrategyConfig, model: ModelConfig,
                       audit: bool = False):
    """Closed-form lower bound (bytes) on the max per-device stage peak
    of this layout, at micro_batch_size=1 under full recompute — the
    cheapest configuration any batch/recompute search could reach.

    Mirrors ``MetaModule.make_param_info`` byte accounting: weight at
    ``element_size`` (sharded by dp*cp under ZeRO-3), grad at
    ``grad_element_size`` (sharded under ZeRO>=2, absent for the
    functional optimizer), optimizer state at 12 B/elem megatron-style
    or 8 B/elem functional (sharded under ZeRO>=1). Dense params shard
    over tp, expert params over etp*ep; the per-stage floor is the
    even-split mean (max stage >= mean).

    ``audit=True`` returns the ``{params_term, act_term, bound}``
    breakdown instead of the scalar, so the bound can be property-tested
    against the memory ledger's params+grads+optimizer bucket sums
    (``tests/test_memledger.py``): the safety-scaled params term must
    stay under the built model's param buckets, and the whole bound
    under the realized peak — bound drift fails loudly instead of
    silently over-pruning."""
    dense, expert = model_param_split(model)
    dshard = max(1, st.dp_size * st.cp_size)
    eshard = max(1, st.edp_size)
    e = st.element_size
    if st.optimizer_style == "functional":
        g, s = 0.0, 8.0
    else:
        g, s = st.grad_element_size, 12.0

    def per_elem(shard: int) -> float:
        return (
            e / (shard if st.zero_state >= 3 else 1)
            + g / (shard if st.zero_state >= 2 else 1)
            + s / (shard if st.zero_state >= 1 else 1)
        )

    params = (
        dense / max(1, st.tp_size) * per_elem(dshard)
        + expert / max(1, st.etp_size * st.ep_size) * per_elem(eshard)
    ) / max(1, st.pp_size)
    # minimum activation floor: one block input at mbs=1 (sp-sharded)
    act_seq = st.seq_len // max(1, st.cp_size)
    if st.enable_sequence_parallel:
        act_seq //= max(1, st.tp_size)
    act = act_seq * model.hidden_size * e
    if audit:
        return {
            "params_term": PRUNE_SAFETY * params,
            "act_term": act,
            "bound": PRUNE_SAFETY * params + act,
        }
    return PRUNE_SAFETY * params + act


def base_cell_row(st: StrategyConfig, rc: str, status: str) -> dict:
    """The shared CSV row skeleton for non-result rows (pruned /
    quarantined cells): layout coordinates + zeroed metrics. One
    source, so the merged CSV's columns cannot drift between the two
    row families."""
    return {
        "tp": st.tp_size, "cp": st.cp_size, "pp": st.pp_size,
        "dp": st.dp_size, "ep": st.ep_size, "etp": st.etp_size,
        "vp": st.vp_size, "mbs": st.micro_batch_size,
        "mbc": st.micro_batch_num, "zero": st.zero_state,
        "recompute": rc, "recompute_layers": 0,
        "mfu": 0.0, "iter_ms": 0.0, "tgs": 0.0, "peak_gib": 0.0,
        # None -> empty CSV cell: rows with no memory verdict (error /
        # non-memory prunes) must not claim a numeric headroom
        "fits": False, "mem_margin_gib": None, "dcn_dims": "",
        "status": status,
    }


def pruned_row(st: StrategyConfig, rc: str, reason: str,
               bound_bytes: Optional[float] = None,
               usable_bytes: Optional[float] = None) -> dict:
    """A CSV-compatible ``status=pruned`` row; ``peak_gib`` carries the
    memory floor and ``mem_margin_gib`` the — negative — headroom
    against raw usable HBM (the prune decision's own threshold: like
    every row family, the margin column measures against the exact
    threshold THIS row's feasibility verdict used) when the prune was
    memory-based."""
    row = base_cell_row(st, rc, "pruned")
    if bound_bytes:
        row["peak_gib"] = bound_bytes / GiB
        if usable_bytes is not None:
            row["mem_margin_gib"] = (usable_bytes - bound_bytes) / GiB
    row["prune_reason"] = reason
    return row


def deduped_row(st: StrategyConfig, rc: str, kept_key: str) -> dict:
    """A CSV-compatible ``status=deduped`` row for a grid cell whose
    *effective* layout (after normalization) coincides with an earlier
    cell's — the earlier cell is the one evaluated; ``dedup_of`` names
    it. In practice this fires for duplicate/overlapping sweep-list
    entries (programmatically composed lists, re-run unions): the
    itertools product of unique per-dim values cannot collide."""
    row = base_cell_row(st, rc, "deduped")
    row["dedup_of"] = kept_key
    return row


def effective_layout_key(st: StrategyConfig, rc: str) -> tuple:
    """The normalized layout identity two grid cells are considered
    duplicates under: every field ``make_cell_strategy`` may have
    normalized differently than requested, plus the recompute family."""
    return (st.tp_size, st.cp_size, st.ep_size, st.pp_size,
            st.zero_state, st.etp_size, rc)


def pareto_frontier(points: dict) -> set:
    """Keys of the non-dominated points (minimize every objective):
    the guided search's frontier over per-cell
    ``(iter_time, peak_bytes, comm_fraction)`` screening triples.
    Deterministic: iteration is over sorted keys, and equal points are
    all kept (neither dominates the other strictly)."""
    keys = sorted(points)
    frontier = set()
    for k in keys:
        p = points[k]
        dominated = False
        for k2 in keys:
            if k2 == k:
                continue
            q = points[k2]
            if all(q[i] <= p[i] for i in range(len(p))) \
                    and any(q[i] < p[i] for i in range(len(p))):
                dominated = True
                break
        if not dominated:
            frontier.add(k)
    return frontier


class CellNeighborhood:
    """Local-neighborhood structure of a sweep grid: two cells are
    neighbors when their layout coordinates differ by at most one index
    step along exactly one swept axis (tp/cp/ep/pp/zero) — or share the
    layout with a different recompute family. The guided search's
    refinement expands evaluation around frontier cells through this
    structure (docs/search.md "Guided search")."""

    _AXES = ("tp", "cp", "ep", "pp", "zero")

    def __init__(self, cells: Sequence[SweepCell]):
        self._axis_vals = [
            sorted({getattr(c, a) for c in cells}) for a in self._AXES
        ]
        self._by_coord: dict = {}
        self._coord: dict = {}
        for c in cells:
            coord = tuple(
                vals.index(getattr(c, a))
                for a, vals in zip(self._AXES, self._axis_vals)
            )
            self._coord[c.idx] = coord
            self._by_coord.setdefault(coord, []).append(c)

    def neighbors(self, cell: SweepCell):
        """Every cell within one axis step of ``cell`` (including its
        own layout's other recompute families), in deterministic grid
        order."""
        coord = self._coord[cell.idx]
        out = []
        seen = set()
        for cand in self._by_coord.get(coord, ()):
            if cand.idx != cell.idx and cand.idx not in seen:
                seen.add(cand.idx)
                out.append(cand)
        for ax in range(len(self._AXES)):
            for step in (-1, 1):
                j = coord[ax] + step
                if j < 0 or j >= len(self._axis_vals[ax]):
                    continue
                ncoord = coord[:ax] + (j,) + coord[ax + 1:]
                for cand in self._by_coord.get(ncoord, ()):
                    if cand.idx not in seen:
                        seen.add(cand.idx)
                        out.append(cand)
        return sorted(out, key=lambda c: c.idx)


def screened_row(st: StrategyConfig, rc: str, screen: dict) -> dict:
    """A CSV-compatible ``status=screened`` row for a guided-search
    cell that was screened but not selected for full evaluation; the
    screening triple rides along for auditability."""
    row = base_cell_row(st, rc, "screened")
    row["screen_iter_ms"] = screen["iter_time"] * 1e3
    row["screen_peak_gib"] = screen["peak_bytes"] / GiB
    row["screen_comm_fraction"] = screen["comm_fraction"]
    return row


def enumerate_cells(
    base_strategy: StrategyConfig,
    model: ModelConfig,
    system: SystemConfig,
    global_batch_size: int,
    tp_list: Sequence[int],
    cp_list: Sequence[int],
    ep_list: Sequence[int],
    pp_list: Sequence[int],
    zero_list: Sequence[int],
    recompute_types: Sequence[str],
    prune: bool = True,
) -> Tuple[List[SweepCell], List[dict], List[dict]]:
    """Expand the sweep grid into (cells to evaluate, pruned rows,
    deduped rows).

    Cells whose *effective* layout after normalization duplicates an
    earlier cell's are recorded as ``status=deduped`` CSV rows instead
    of being scheduled — they could only ever reproduce the earlier
    cell's row, and skipping them up front keeps journaled resume and
    ``--jobs N`` merges bit-identical (the duplicate never races the
    original for a journal slot).

    With ``prune=False`` the divisibility guards still skip impossible
    layouts (exactly the historical sweep behavior — they could never
    produce a row) but nothing is recorded, the memory bound is not
    applied, and duplicates are evaluated as the legacy sweep always
    evaluated them, so the cell set matches the legacy sweep
    bit-for-bit."""
    world = base_strategy.world_size
    cells: List[SweepCell] = []
    pruned: List[dict] = []
    deduped: List[dict] = []
    seen_layouts: dict = {}
    idx = 0
    for tp, cp, ep, pp, zero in itertools.product(
        tp_list, cp_list, ep_list, pp_list, zero_list
    ):
        reason = None
        if world % (tp * cp * pp) or world % (ep * pp):
            reason = "layout_indivisible"
        elif model.model_type != "moe" and ep > 1:
            reason = "ep_on_dense_model"
        st = make_cell_strategy(base_strategy, tp, cp, ep, pp, zero)
        if reason is None and zero > min(zero_list) \
                and st.dp_size * st.cp_size == 1:
            # ZeRO has no effect without data-parallel replicas; the
            # representative (minimum) level dominates the duplicates
            reason = "zero_dominated"
        if reason is None and (
            st.dp_size < 1 or global_batch_size % st.dp_size
        ):
            reason = "gbs_indivisible"
        bound = None
        usable = system.mem_bytes * st.mem_factor
        if reason is None and prune:
            floor = memory_lower_bound(st, model)
            if floor > usable:
                reason = "memory_lower_bound"
                bound = floor
        for rc in recompute_types:
            key = f"tp{tp}_cp{cp}_ep{ep}_pp{pp}_z{zero}_{rc}"
            if reason is None:
                norm = effective_layout_key(st, rc)
                kept = seen_layouts.get(norm)
                if prune and kept is not None:
                    deduped.append(deduped_row(st, rc, kept))
                    continue
                seen_layouts.setdefault(norm, key)
                cells.append(SweepCell(idx, key, tp, cp, ep, pp, zero, rc))
                idx += 1
            elif prune:
                pruned.append(pruned_row(st, rc, reason, bound_bytes=bound,
                                         usable_bytes=usable))
    return cells, pruned, deduped

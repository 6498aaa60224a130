"""Rank-symmetry reduction for world-rank simulation (L5).

At pod scale (256 v5e chips, thousands of v5p chips) almost every
global rank is interchangeable with hundreds of others: ranks whose
(pp stage, tp/cp/ep/etp group roles, dp/edp group roles, perturbation
multiplier) signatures are identical execute bit-identical event
sequences, because every engine request they issue — compute durations,
collective rendezvous, p2p tags, async buckets — is derived from
exactly those signatures. Analytical pod-scale models (Calculon) and
event-driven simulators (ASTRA-sim) exploit the same symmetry; here it
is computed exactly, not assumed.

Classes are found by color refinement (the 1-dimensional
Weisfeiler-Leman fixpoint): start from ``(stage, perturb)`` colors and
iteratively split ranks whose *relational* position differs — the color
tuple of their tp/cp/ep/etp group peers (in group order), of their
dp_cp/edp bucket peers, and of their pipeline neighbours. A
``perturbation`` entry therefore shatters exactly the classes whose
symmetry it breaks: untouched regions stay merged, and in the worst
case the refinement degenerates to one-rank classes, which *is* the
exact full-world simulation (the automatic fallback — reduced and full
are the same algorithm, reduction just deduplicates proven-identical
coroutines).

The reduced engine runs one representative per class; rendezvous
groups, pipeline neighbours and the optimizer barrier are mapped onto
class representatives (class-weighted rendezvous: ``max`` over one
arrival per class equals ``max`` over all members because members are
bit-identical). Results are expanded back to full-world shape by
:mod:`simumax_tpu_torch.simulator.runner`.

Copy of the JAX package's ``simulator/reduce.py`` with its import paths
changed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from simumax_tpu_torch.parallel.mesh import rank_coords, rank_groups


@dataclass
class ReductionPlan:
    """Everything the runner needs to simulate one rank per symmetry
    class and expand the result to full-world shape."""

    world_size: int
    #: global members of each class, ascending; class index == engine rank
    classes: List[List[int]]
    #: class index of every global rank
    class_of: List[int]
    #: pp stage / perturbation multiplier per class
    stages: List[int]
    perturbs: List[float]
    #: per-class rendezvous groups, mapped to engine ranks: keys are the
    #: dims StageProcess consults (tp/cp/ep/etp plus dp_cp/edp buckets)
    groups: List[Dict[str, List[int]]]
    #: per-class {pp stage -> engine rank} for p2p neighbours
    neighbor_maps: List[Dict[int, int]]

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def reps(self) -> List[int]:
        """Representative global rank per engine (class) rank — each
        class's smallest member. Critical-path expansion maps path
        nodes through this list (``observe/critpath.py``): binding
        ties break toward smaller ranks in both the reduced and the
        exact engine, and every representative is its class's minimum,
        so the reduced path expands bit-identically to the exact
        full-world path."""
        return [members[0] for members in self.classes]

    @property
    def weights(self) -> List[int]:
        return [len(members) for members in self.classes]


def _dense_dp_cp_groups(st) -> List[List[int]]:
    """dp_cp bucket membership exactly as the world-rank runner builds
    it: ranks sharing (tp, pp) coords (cp folds into the data-parallel
    grad stream)."""
    buckets: Dict[tuple, List[int]] = {}
    for r in range(st.world_size):
        c = rank_coords(r, st)
        buckets.setdefault((c["tp"], c["pp"]), []).append(r)
    return [sorted(g) for g in buckets.values()]


def _membership(groups: List[List[int]]) -> Dict[int, List[int]]:
    by_rank: Dict[int, List[int]] = {}
    for g in groups:
        for r in g:
            by_rank[r] = g
    return by_rank


def canonical_class_order(plan: ReductionPlan,
                          seeds: List[tuple]) -> List[int]:
    """A structure-canonical ordering of a plan's classes, used by the
    fault-replay step cache (``simulator/faults.py``) to relabel two
    plans that differ only in *which* symmetric ranks a scenario
    touched into one byte-equal cache key.

    Runs the same color-refinement idiom as :func:`build_reduction`,
    but over *classes*: initial colors are ``(stage, perturb, class
    size, seed)`` — ``seeds[i]`` carries the class's fault timeline —
    refined by the color tuples of each class's rendezvous-group peers
    (in group order) and pipeline neighbours until stable. Classes are
    then ordered by final color, ties broken by original class index.

    The ordering is only a *relabeling recipe*: the cache key built
    from it re-serializes the full engine problem in the new
    numbering, so an imperfect canonicalization can cost cache hits
    but never correctness (byte-equal keys are byte-equal problems).
    """
    k = plan.n_classes
    color: List[tuple] = [
        (plan.stages[i], plan.perturbs[i], len(plan.classes[i]), seeds[i])
        for i in range(k)
    ]
    canon: Dict[tuple, int] = {}
    out: List[int] = [0] * k
    n_colors = 0
    while True:
        canon.clear()
        for i in range(k):
            sig = [color[i]]
            for dim in sorted(plan.groups[i]):
                sig.append(
                    (dim, tuple(color[p] for p in plan.groups[i][dim]))
                )
            sig.append(tuple(sorted(
                (s, color[p]) for s, p in plan.neighbor_maps[i].items()
            )))
            key = tuple(sig)
            c = canon.get(key)
            if c is None:
                c = canon[key] = len(canon)
            out[i] = c
        if len(canon) == n_colors:
            break
        n_colors = len(canon)
        color = [(c,) for c in out]
    return sorted(range(k), key=lambda i: (out[i], i))


def orbit_of(plan: ReductionPlan, rank: int) -> int:
    """The symmetry-orbit (class) index of a global rank under a
    reduction plan. The fleet scheduler annotates placement decisions
    with the orbits its fault events land in: two events whose target
    ranks share an orbit of the *healthy* plan are the same abstract
    event up to relabeling, so the fault-replay step cache answers the
    second from the first's replay (``faults.ReplayContext``'s
    canonical keying) — the cross-job amortization the fleet bench
    measures."""
    return plan.class_of[rank]


def reduction_structure(st) -> tuple:
    """The world's relational structure — group memberships, pipeline
    stages and neighbours — computed once and reusable across
    :func:`build_reduction` calls on the same strategy (the
    fault-replay engine builds one plan per scenario partition, and at
    pod scale this precompute dominates the refinement itself)."""
    n = st.world_size
    pp = st.pp_size
    stride = st.tp_size * st.cp_size * st.dp_size  # == StageProcess._pp_stride

    memberships: Dict[str, Dict[int, List[int]]] = {}
    for dim in ("tp", "cp", "ep", "etp"):
        if getattr(st, f"{dim}_size") > 1:
            memberships[dim] = _membership(rank_groups(st, dim))
    if st.dp_size * st.cp_size > 1:
        memberships["dp_cp"] = _membership(_dense_dp_cp_groups(st))
    if st.edp_size > 1:
        memberships["edp"] = _membership(rank_groups(st, "edp"))
    stages = [rank_coords(r, st)["pp"] for r in range(n)]

    def pp_next(r: int) -> Optional[int]:
        if pp <= 1:
            return None
        s = stages[r]
        # interleaved schedules wrap stage pp-1 -> 0 (chunk handoff)
        return r + stride if s < pp - 1 else r - (pp - 1) * stride

    def pp_prev(r: int) -> Optional[int]:
        if pp <= 1:
            return None
        s = stages[r]
        return r - stride if s > 0 else r + (pp - 1) * stride

    nxt = [pp_next(r) for r in range(n)]
    prv = [pp_prev(r) for r in range(n)]
    dims = sorted(memberships)
    return memberships, stages, nxt, prv, dims


def build_reduction(st, perturbation: Optional[dict] = None,
                    signatures: Optional[dict] = None,
                    structure: Optional[tuple] = None) -> ReductionPlan:
    """Partition the world into symmetry classes and map the simulated
    structures onto class representatives. Deterministic: classes are
    numbered by their smallest member.

    ``signatures`` maps rank -> extra hashable identity folded into the
    initial colors: a fault scenario's per-rank event signature
    (``faults.py::FaultScenario.rank_signatures``) shatters exactly the
    classes its rank-scoped events touch, the same way a straggler
    ``perturbation`` does. Signature *values* reach the refinement only
    through equality, so any renaming that preserves the induced
    partition yields the same plan — seeding them with the healthy
    class ids (as the fault-replay engine does) additionally makes the
    refinement converge from the already-stable healthy partition.

    ``structure`` reuses a precomputed :func:`reduction_structure`."""
    perturbation = perturbation or {}
    signatures = signatures or {}
    n = st.world_size
    pp = st.pp_size

    stride = st.tp_size * st.cp_size * st.dp_size
    if structure is None:
        structure = reduction_structure(st)
    memberships, stages, nxt, prv, dims = structure

    # color refinement to fixpoint, vectorized. Color ids reach the
    # next iteration only through EQUALITY (the final plan groups by
    # partition and orders classes by smallest member), so any id
    # labeling that induces the same partition yields the same plan —
    # np.unique's sorted labeling is as good as first-occurrence, and
    # the partition sequence (hence the stop iteration and the final
    # partition) is identical to the scalar refinement's.
    #
    # Structure prep (per call, not per iteration): each dim becomes a
    # per-rank group index plus a padded member matrix; a group's color
    # signature is the row of member colors in group order, padded with
    # -2 (never a color id), so ragged groups can't collide.
    init: Dict[tuple, int] = {}
    color = np.empty(n, dtype=np.int64)
    for r in range(n):
        key = (stages[r], float(perturbation.get(r, 1.0)),
               signatures.get(r))
        c = init.get(key)
        if c is None:
            c = init[key] = len(init)
        color[r] = c
    dim_gids: List[np.ndarray] = []
    dim_members: List[np.ndarray] = []
    for dim in dims:
        byrank = memberships[dim]
        gid = np.full(n, -1, dtype=np.int64)
        groups_seen: Dict[int, int] = {}
        rows: List[List[int]] = []
        for r in range(n):
            grp = byrank.get(r)
            if grp is None:
                continue
            g = groups_seen.get(id(grp))
            if g is None:
                g = groups_seen[id(grp)] = len(rows)
                rows.append(grp)
            gid[r] = g
        lmax = max((len(g) for g in rows), default=1)
        members = np.full((max(len(rows), 1), lmax), n, dtype=np.int64)
        for g, grp in enumerate(rows):
            members[g, : len(grp)] = grp
        dim_gids.append(gid)
        dim_members.append(members)
    nxt_a = np.asarray(nxt, dtype=np.int64) if pp > 1 else None
    prv_a = np.asarray(prv, dtype=np.int64) if pp > 1 else None

    n_colors = 0
    while True:
        cols = [color]
        color_ext = np.append(color, -2)  # pad slot n -> sentinel
        for gid, members in zip(dim_gids, dim_members):
            _, guid = np.unique(color_ext[members], axis=0,
                                return_inverse=True)
            # rank not in any group of this dim -> -1 (never equal to
            # a group id), matching the scalar refinement's None
            cols.append(np.append(guid.ravel(), -1)[gid])
        if pp > 1:
            cols.append(color[nxt_a])
            cols.append(color[prv_a])
        sig = np.stack(cols, axis=1)
        uniq, inv = np.unique(sig, axis=0, return_inverse=True)
        colors_out = inv.ravel()
        if len(uniq) == n_colors:
            break
        n_colors = len(uniq)
        color = colors_out

    # classes ordered by smallest member (deterministic representative)
    members_by_color: Dict[int, List[int]] = {}
    for r in range(n):
        members_by_color.setdefault(color[r], []).append(r)
    classes = sorted(members_by_color.values(), key=lambda m: m[0])
    class_of = [0] * n
    for idx, members in enumerate(classes):
        for r in members:
            class_of[r] = idx

    def map_group(grp: List[int]) -> List[int]:
        return sorted({class_of[p] for p in grp})

    plan_groups: List[Dict[str, List[int]]] = []
    neighbor_maps: List[Dict[int, int]] = []
    for members in classes:
        rep = members[0]
        g: Dict[str, List[int]] = {}
        for dim in dims:
            grp = memberships[dim].get(rep)
            if grp is not None:
                g[dim] = map_group(grp)
        plan_groups.append(g)
        nmap: Dict[int, int] = {}
        if pp > 1:
            s = stages[rep]
            for s2 in range(pp):
                # same arithmetic as StageProcess._neighbor; stages the
                # schedule never addresses may fall outside the world
                peer = rep + (s2 - s) * stride
                if 0 <= peer < n:
                    nmap[s2] = class_of[peer]
        neighbor_maps.append(nmap)

    return ReductionPlan(
        world_size=n,
        classes=classes,
        class_of=class_of,
        stages=[stages[m[0]] for m in classes],
        perturbs=[float(perturbation.get(m[0], 1.0)) for m in classes],
        groups=plan_groups,
        neighbor_maps=neighbor_maps,
    )

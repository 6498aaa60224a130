"""Critical-path engine for the discrete-event simulator: slack,
blame, and sim-vs-analytical divergence.

The DES (``simulator/engine.py``) emits a makespan and a Chrome trace
with no account of *which* events determined it. This module closes
that gap with classic critical-path analysis of the event-dependency
graph — the technique behind Holistic Trace Analysis and Chrome's
tracing blame model:

* :class:`DependencySkeleton` — the engine's optional ``dep_recorder``:
  a compact, bounded record of the event-dependency graph built while
  the run streams (program order per rank, rendezvous joins, p2p
  send -> recv edges, async-stream joins, fault perturbations). It
  retains only flat scalar arrays + predecessor id tuples, so it works
  unchanged under ``StreamingTraceWriter`` (trace events leave the
  process; the skeleton stays).
* :func:`analyze` — the post-pass: per-event slack (how much an event
  could stretch before the makespan moves), the cross-rank critical
  path (binding-predecessor walk from the makespan rank's final
  event), and the **simulated waterfall** — the reference (binding)
  stage's timeline blame-decomposed into compute / recompute /
  exposed comm per dim / pipeline bubble / DP+optimizer sync / fault
  / straggler, summing to the reported DES makespan within 1e-6 (the
  simulated twin of ``observe/ledger.py::build_waterfall``, sharing
  its anchor-stage semantics; blocked gaps are blamed through the
  binding dependency, HTA-style).
* :func:`diverge` — aligns the simulated waterfall bucket-by-bucket
  with the analytical one and names the top disagreeing
  ops/collectives: divergence localizes which efficiency-table entries
  or comm terms drift (the calibration-drift signal for device-free
  calibration).
* :func:`diff_critpath` / :func:`format_critpath_diff_lines` — compare
  two saved reports (two strategies, or healthy vs fault scenario).

Graph model. Every recorded node ``j`` carries its observed ``start``
/ ``end`` and the predecessor set that determined it. With
``S_j = max(end of preds)`` (the join) and ``W_j = end_j - S_j`` (own
work beyond the binding dependency), delaying a predecessor by ``d``
moves ``j`` iff the delayed end exceeds ``S_j`` — the max-plus
semantics of rendezvous. The backward pass computes the latest
allowed end ``L_j`` (``L = makespan`` at the sinks;
``L_p = min(L_j - W_j)`` over successors ``j``) and
``slack_j = L_j - end_j``. Walking binding predecessors from the
makespan rank's final event telescopes exactly: consecutive path
nodes satisfy ``end_j = end_pred + W_j``, so the path works sum to
the makespan up to float reassociation.

Under rank-symmetry reduction (``simulator/reduce.py``) the skeleton
is recorded over class representatives; expansion maps engine ranks to
representative global ranks (class reps are each class's smallest
member, and binding ties break toward smaller ranks, so the reduced
path expands bit-identically to the exact full-world path — asserted
on the parity grid in ``tests/test_critpath.py``).

Consumers: ``PerfLLM.critical_path``, ``simulate(critical_path=True)``
and the fault model's slack gate; schema and a worked triage example
in the JAX package's ``docs/observability.md``.

Copy of the JAX package's ``observe/critpath.py`` with its import paths
changed and its command-line surface, which the port does not have yet,
no longer named as a consumer or in an error message.
"""

from __future__ import annotations

import json
import math
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.core.records import CritSegment

CRITPATH_SCHEMA = "simumax-critpath-v1"

#: fixed (non-comm) simulated-waterfall buckets, in presentation order;
#: ``comm:<dim>`` buckets sort between ``recompute`` and
#: ``pipeline_bubble`` (see :func:`_waterfall_order`)
_FIXED_HEAD = ("compute", "recompute")
_FIXED_TAIL = ("pipeline_bubble", "dp_optimizer_sync", "fault", "straggler")

#: step-tail event names charged to the DP/optimizer bucket (the
#: simulated twin of the analytical ``dp_optimizer_sync``)
_DP_NAMES = ("adam_step", "optimizer_barrier", "tied_embedding_grad")
_DP_PREFIXES = ("grad_rs_", "param_ag_")


_KEY_DIM = None


def _dim_of(key) -> Optional[str]:
    global _KEY_DIM
    if _KEY_DIM is None:  # lazy: avoids an import-machinery hit per call
        from simumax_tpu_torch.simulator.faults import key_dim

        _KEY_DIM = key_dim
    return _KEY_DIM(key)


class DependencySkeleton:
    """Bounded event-dependency recorder, plugged into the engine as
    ``dep_recorder``. Purely observational: recorder-on and
    recorder-off runs are bit-identical (asserted in tests).

    Nodes live in flat parallel lists; predecessor ids always precede
    the node (creation order is a topological order), so the backward
    pass is a single reverse sweep. ``emit_idx`` mirrors the engine's
    per-rank emitted-event counter (-1 for non-emitted bookkeeping
    nodes such as clock advances and stream joins), which is what lets
    a post-pass annotate Chrome-trace events by ``(rank, emit index)``
    without retaining the events themselves."""

    def __init__(self):
        self.rank: List[int] = []
        self.name: List[str] = []
        self.kind: List[str] = []  # compute|comm|p2p|wait|fault|advance|join|trace
        self.lane: List[str] = []
        self.start: List[float] = []
        self.end: List[float] = []
        self.extra: List[float] = []  # fault-injected seconds within the span
        self.dim: List[Optional[str]] = []
        self.link: List[Optional[Tuple[int, int]]] = []  # p2p (src, dst)
        self.emit_idx: List[int] = []
        self.preds: List[tuple] = []
        self.adv: List[bool] = []  # clock-advancing (tail-chain) node
        #: program-order frontier per rank (last clock-advancing node)
        self._tail: Dict[int, int] = {}
        self._emit_count: Dict[int, int] = {}
        # transient join bookkeeping (deleted as soon as consumed —
        # the bounded-memory contract mirrors the engine's own)
        self._coll_arrivals: Dict[tuple, Dict[int, int]] = {}
        self._send_nodes: Dict[tuple, int] = {}
        self._recv_posts: Dict[tuple, int] = {}
        self._async_posts: Dict[tuple, Dict[int, int]] = {}
        self._async_tmp: Dict[tuple, Tuple[tuple, List[int]]] = {}
        self._chain_prev: Dict[tuple, int] = {}
        self._pending_async: Dict[int, List[int]] = {}

    def __len__(self) -> int:
        return len(self.rank)

    # -- node construction -------------------------------------------------
    def _node(self, rank: int, name: str, kind: str, lane: str,
              start: float, end: float, preds, *, emitted: bool,
              advance_tail: bool, extra: float = 0.0,
              dim: Optional[str] = None,
              link: Optional[Tuple[int, int]] = None) -> int:
        i = len(self.rank)
        self.rank.append(rank)
        self.name.append(sys.intern(name))
        self.kind.append(kind)  # call sites pass literals (interned)
        self.lane.append(lane)
        self.start.append(start)
        self.end.append(end)
        self.extra.append(extra)
        self.dim.append(sys.intern(dim) if dim else None)
        self.link.append(link)
        if emitted:
            c = self._emit_count.get(rank, 0)
            self.emit_idx.append(c)
            self._emit_count[rank] = c + 1
        else:
            self.emit_idx.append(-1)
        ps = []
        for p in preds:
            if p is not None and p >= 0:
                ps.append(p)
        self.preds.append(tuple(ps))
        self.adv.append(advance_tail)
        if advance_tail:
            self._tail[rank] = i
        return i

    def _t(self, rank: int) -> int:
        return self._tail.get(rank, -1)

    # -- engine hooks (call order mirrors engine emission order) -----------
    def on_compute(self, rank, name, lane, start, end, extra):
        # the hottest hook (every leaf fwd/bwd span lands here):
        # hand-inlined _node, measured at ~2x the generic path
        i = len(self.rank)
        self.rank.append(rank)
        self.name.append(sys.intern(name))
        self.kind.append("compute")
        self.lane.append(lane)
        self.start.append(start)
        self.end.append(end)
        self.extra.append(extra)
        self.dim.append(None)
        self.link.append(None)
        c = self._emit_count.get(rank, 0)
        self.emit_idx.append(c)
        self._emit_count[rank] = c + 1
        t = self._tail.get(rank, -1)
        self.preds.append((t,) if t >= 0 else ())
        self.adv.append(True)
        self._tail[rank] = i

    def on_advance(self, rank, start, end):
        self._node(rank, "advance", "advance", "comp", start, end,
                   (self._t(rank),), emitted=False, advance_tail=True)

    def on_trace(self, rank, name, start, end):
        # zero-advance visibility span: no successors, never on the
        # path, excluded from the backward pass (its end may exceed
        # the rank's clock by design)
        self._node(rank, name, "trace", "comm", start, end,
                   (self._t(rank),), emitted=True, advance_tail=False)

    def on_coll_arrive(self, ckey, rank):
        self._coll_arrivals.setdefault(ckey, {})[rank] = self._t(rank)

    def on_coll_serve(self, ckey, key, rank, name, start, end, extra,
                      dead_peers):
        arrivals = self._coll_arrivals.get(ckey, {})
        preds = list(arrivals.values())
        for p in dead_peers:
            preds.append(self._t(p))  # the dead peer's death node
        if rank not in arrivals:
            preds.append(self._t(rank))
        self._node(rank, name, "comm", "comm", start, end, preds,
                   emitted=True, advance_tail=True, extra=extra,
                   dim=_dim_of(key))

    def on_coll_done(self, ckey):
        self._coll_arrivals.pop(ckey, None)

    def on_send(self, skey, rank, name, lane, start, end, extra,
                advance_tail, rendezvous):
        preds = [self._t(rank)]
        if rendezvous:
            preds.append(self._recv_posts.get(skey))
        node = self._node(rank, name, "p2p", lane, start, end, preds,
                          emitted=True, advance_tail=advance_tail,
                          extra=extra, dim="pp", link=(skey[0], skey[1]))
        self._send_nodes[skey] = node

    def on_recv_post(self, skey, rank):
        self._recv_posts[skey] = self._t(rank)

    def on_recv_serve(self, skey, rank, name, start, end, emitted):
        preds = (self._t(rank), self._send_nodes.pop(skey, None))
        self._recv_posts.pop(skey, None)
        self._node(rank, f"wait_{name}", "wait", "wait", start, end,
                   preds, emitted=emitted, advance_tail=True,
                   dim="pp", link=(skey[0], skey[1]))

    def on_sendrecv_serve(self, rank, name, start, end, in_key, out_key,
                          emitted):
        preds = [self._t(rank)]
        link = None
        if in_key is not None:
            preds.append(self._send_nodes.pop(in_key, None))
            self._recv_posts.pop(in_key, None)
            link = (in_key[0], in_key[1])
        if out_key is not None:
            # own outbound publish + the peer's recv-post marker (the
            # rendezvous half of a send-only batched pair)
            preds.append(self._send_nodes.get(out_key))
            preds.append(self._recv_posts.get(out_key))
            if link is None:
                link = (out_key[0], out_key[1])
        self._node(rank, name, "wait", "wait", start, end, preds,
                   emitted=emitted, advance_tail=True, dim="pp",
                   link=link)

    def on_async_post(self, ckey, rank):
        self._async_posts.setdefault(ckey, {})[rank] = self._t(rank)

    def on_async_finish_peer(self, ckey, chain_key, name, start, end,
                             peer, extra):
        preds = list(self._async_posts.get(ckey, {}).values())
        prev = self._chain_prev.get(chain_key)
        if prev is not None:
            preds.append(prev)
        node = self._node(peer, name, "comm", "comm", start, end, preds,
                          emitted=True, advance_tail=False, extra=extra,
                          dim=_dim_of(chain_key[0]))
        self._pending_async.setdefault(peer, []).append(node)
        self._async_tmp.setdefault(ckey, (chain_key, []))[1].append(node)

    def on_async_done(self, ckey):
        tmp = self._async_tmp.pop(ckey, None)
        if tmp is not None and tmp[1]:
            self._chain_prev[tmp[0]] = tmp[1][0]
        self._async_posts.pop(ckey, None)

    def on_wait_comm(self, rank, start, end):
        preds = [self._t(rank)] + self._pending_async.pop(rank, [])
        self._node(rank, "wait_comm", "join", "comp", start, end, preds,
                   emitted=False, advance_tail=True)

    def on_death(self, rank, t):
        self._node(rank, "rank_death", "fault", "comp", t, t,
                   (self._t(rank),), emitted=True, advance_tail=True)

    def on_fault_span(self, rank, name, start, end):
        self._node(rank, name, "fault", "comp", start, end,
                   (self._t(rank),), emitted=True, advance_tail=True,
                   extra=end - start)


# --------------------------------------------------------------------------
# Post-pass: slack, critical path, simulated waterfall
# --------------------------------------------------------------------------


def _joins_and_work(skel: DependencySkeleton):
    """Per-node join time ``S`` (max predecessor end; own start for
    sources) and own work ``W = end - S`` (clamped at 0 for float
    safety)."""
    end = skel.end
    start = skel.start
    all_preds = skel.preds
    n = len(end)
    S: List[float] = [0.0] * n
    W: List[float] = [0.0] * n
    for j in range(n):
        preds = all_preds[j]
        if preds:
            s = end[preds[0]]
            for p in preds:
                e = end[p]
                if e > s:
                    s = e
        else:
            s = start[j]
        S[j] = s
        w = end[j] - s
        W[j] = w if w > 0.0 else 0.0
    return S, W


def _slack(skel: DependencySkeleton, W: List[float],
           makespan: float) -> List[float]:
    """Latest-allowed-end backward pass: ``slack_j = L_j - end_j``.
    Zero-slack nodes form the critical paths; ``math.inf`` marks
    trace-only visibility spans (no timing successors by design)."""
    n = len(skel.end)
    L = [makespan] * n
    kind = skel.kind
    all_preds = skel.preds
    end = skel.end
    for j in range(n - 1, -1, -1):
        if kind[j] == "trace":
            continue
        allowed = L[j] - W[j]
        for p in all_preds[j]:
            if allowed < L[p]:
                L[p] = allowed
    inf = math.inf
    out = [0.0] * n
    for j in range(n):
        if kind[j] == "trace":
            out[j] = inf
        else:
            s = L[j] - end[j]
            out[j] = s if s > 0.0 else 0.0
    return out


def _sink(skel: DependencySkeleton) -> Optional[int]:
    """The makespan rank's final node (max end; ties -> smallest rank
    — the determinism contract shared with the engine's heap)."""
    best = None
    for rank in sorted(skel._tail):
        j = skel._tail[rank]
        if best is None or skel.end[j] > skel.end[best]:
            best = j
    return best


def _walk_path(skel: DependencySkeleton, sink: int) -> List[int]:
    """Binding-predecessor walk from the sink: at each node pick the
    predecessor with the maximum end (ties -> smallest rank, then
    smallest id — expands bit-identically under symmetry reduction
    because class representatives are each class's smallest member)."""
    path = [sink]
    cur = sink
    while skel.preds[cur]:
        cur = _binding_pred(skel, cur)
        path.append(cur)
    path.reverse()
    return path


def _bucket_of(skel: DependencySkeleton, j: int, ref_ranks) -> str:
    """Blame bucket of one path node — the simulated twin of the
    analytical waterfall's buckets (docs/observability.md). Compute on
    a reference-stage rank is ``compute``; path time spent on other
    stages' work while the reference stage waits is the pipeline
    bubble, exactly the analytical decomposition's anchor."""
    name, kind = skel.name[j], skel.kind[j]
    if kind == "fault":
        return "fault"
    if name in _DP_NAMES or name.startswith(_DP_PREFIXES):
        return "dp_optimizer_sync"
    if kind in ("p2p", "wait", "advance"):
        return "comm:pp"
    if kind == "comm" or skel.lane[j] == "comm":
        dim = skel.dim[j]
        return f"comm:{dim}" if dim else "comm:intra"
    if ".recompute#" in name:
        return "recompute"
    if kind == "join":
        return "dp_optimizer_sync"  # stream join residue (rare, ~0)
    return "compute" if skel.rank[j] in ref_ranks else "pipeline_bubble"


def _waterfall_order(buckets: Dict[str, float]) -> List[str]:
    comm = sorted(k for k in buckets if k.startswith("comm:"))
    return [k for k in _FIXED_HEAD if k in buckets] + comm + [
        k for k in _FIXED_TAIL if k in buckets
    ]


def _binding_pred(skel: DependencySkeleton, j: int) -> Optional[int]:
    """The predecessor whose end determined node ``j``'s join (max end;
    ties -> smallest rank, then smallest id — the shared determinism
    contract that makes reduced and exact walks expand identically)."""
    best = None
    end, rank = skel.end, skel.rank
    for p in skel.preds[j]:
        if best is None or end[p] > end[best] or (
            end[p] == end[best] and (rank[p], p) < (rank[best], best)
        ):
            best = p
    return best


def _timeline_waterfall(skel: DependencySkeleton, S, W,
                        ref_rank: int, ref_ranks, makespan: float):
    """Blame-decompose the reference rank's timeline ``[0, makespan]``
    — the simulated twin of ``build_waterfall``'s constructive
    decomposition of the binding stage's schedule end.

    Each clock-advancing node contributes its own work ``W`` to its op
    bucket; the gap before it (time the rank sat blocked) is blamed via
    the binding dependency: p2p waits split into transfer (``comm:pp``,
    bounded by the binding send's wire time) + ``pipeline_bubble``,
    rendezvous skew folds into the op's own bucket (waiting for the DP
    group IS DP sync), fault-stretched spans and fault-delayed binding
    deps land in ``fault``. The residual after the reference rank's
    final clock (the tail-binding stage's longer optimizer tail) lands
    in ``dp_optimizer_sync``. Contributions telescope, so the buckets
    sum to the makespan up to float reassociation."""
    buckets: Dict[str, float] = {}

    def add(b: str, v: float):
        if v > 0:
            buckets[b] = buckets.get(b, 0.0) + v

    prev_end = 0.0
    for j in range(len(skel)):
        if skel.rank[j] != ref_rank or not skel.adv[j]:
            continue
        gap = max(0.0, S[j] - prev_end)
        w = W[j]
        fx = min(skel.extra[j], w)
        if fx > 0:
            add("fault", fx)
            w -= fx
        b = _bucket_of(skel, j, ref_ranks)
        if gap > 0:
            bp = _binding_pred(skel, j)
            if bp is not None:
                gfx = min(gap, skel.extra[bp])
                if skel.kind[bp] == "fault":
                    gfx = gap  # waiting out a dead/aborted partner
                if gfx > 0:
                    add("fault", gfx)
                    gap -= gfx
            if b == "comm:pp":
                transfer = 0.0
                if bp is not None and skel.kind[bp] == "p2p":
                    transfer = min(gap, W[bp])
                add("comm:pp", transfer)
                add("pipeline_bubble", gap - transfer)
            elif b in ("compute", "pipeline_bubble", "recompute", "fault"):
                add("pipeline_bubble", gap)
            else:
                add(b, gap)  # rendezvous skew folds into the op bucket
        add(b, w)
        prev_end = skel.end[j]
    # tail skew: the makespan rank's optimizer tail outlasting ours
    add("dp_optimizer_sync", makespan - prev_end)
    return buckets


def _segments(skel, path, W, ref_ranks, rank_map, stage_of):
    """Merge consecutive path nodes with one (rank, bucket) into
    :class:`CritSegment` rows (readable path summary; works sum to the
    engine makespan exactly like the raw node walk)."""
    segs: List[CritSegment] = []
    for j in path:
        b = _bucket_of(skel, j, ref_ranks)
        r = skel.rank[j]
        g = rank_map[r] if rank_map is not None else r
        if segs and segs[-1].rank == g and segs[-1].bucket == b:
            s = segs[-1]
            s.end = skel.end[j]
            s.work += W[j]
            s.events += 1
            s.fault_extra += min(skel.extra[j], W[j])
            continue
        segs.append(CritSegment(
            rank=g, stage=stage_of(r) if stage_of else 0, bucket=b,
            name=skel.name[j], start=skel.start[j], end=skel.end[j],
            work=W[j], events=1,
            fault_extra=min(skel.extra[j], W[j]),
        ))
    return segs


def _headroom(work: Dict[Any, float], slack: Dict[Any, float]):
    """Tolerable uniform-slowdown bound per entity: a slowdown adding
    total delay ``D <= min_slack`` cannot move the makespan (any path
    accumulates at most ``D``, and every path's float is at least its
    minimum node slack), so ``min_slack / work`` is a sound headroom
    fraction."""
    out = []
    for k in sorted(work, key=repr):
        w = work[k]
        s = slack.get(k, math.inf)
        pct = None
        if w > 0 and math.isfinite(s):
            pct = 100.0 * s / w
        out.append({
            "key": k, "work_ms": w * 1e3,
            "min_slack_us": None if not math.isfinite(s) else s * 1e6,
            "tolerates_slowdown_pct": pct,
        })
    out.sort(key=lambda e: (
        e["tolerates_slowdown_pct"] is None,
        e["tolerates_slowdown_pct"] if e["tolerates_slowdown_pct"]
        is not None else 0.0,
    ))
    return out


def analyze(skel: DependencySkeleton, makespan: float,
            straggle_ratio: float = 1.0,
            rank_map: Optional[List[int]] = None,
            weights: Optional[List[int]] = None,
            stage_of=None, meta: Optional[Dict[str, Any]] = None,
            ref_stage: Optional[int] = None):
    """Full post-pass over a recorded skeleton.

    ``makespan`` is the engine's raw virtual end time (pre-straggler);
    the report's waterfall adds a ``straggler`` bucket of
    ``makespan * (ratio - 1)`` so buckets sum to the *reported* DES
    ``end_time`` — mirroring the analytical ``build_waterfall``.

    ``rank_map`` (class representative -> global rank) and ``weights``
    expand a symmetry-reduced skeleton; ``stage_of(engine_rank)``
    labels segments with pipeline stages.

    ``ref_stage`` anchors the compute-vs-bubble split (path work on the
    reference stage's ranks is ``compute``, other stages' work is the
    bubble). The runner passes the analytical ``binding_stage_rs`` so
    the simulated and analytical waterfalls share one anchor and their
    divergence measures model drift, not anchor mismatch; default is
    the makespan rank's own stage.

    Returns ``(report, annotations)`` where ``annotations`` maps
    ``(engine_rank, per-rank emit index) -> (slack_seconds, on_path)``
    for Chrome-trace args."""
    report: Dict[str, Any] = {
        "schema": CRITPATH_SCHEMA,
        "meta": dict(meta or {}),
        "makespan_ms": makespan * 1e3,
        "end_time_ms": makespan * straggle_ratio * 1e3,
        "straggle_ratio": straggle_ratio,
        "n_nodes": len(skel),
    }
    if not len(skel):
        report.update({
            "waterfall": {"order": [], "buckets": {}, "total": 0.0},
            "path": [], "slack": {}, "per_rank_headroom": [],
            "per_link_headroom": [],
            "slack_index": {"mode": (meta or {}).get("mode"),
                            "buckets": 0, "makespan_s": 0.0,
                            "ranks": [], "links": [],
                            "rank_buckets": [], "link_buckets": []},
        })
        return report, {}
    S, W = _joins_and_work(skel)
    slack = _slack(skel, W, makespan)
    sink = _sink(skel)
    path = _walk_path(skel, sink)
    on_path = set(path)
    if ref_stage is None:
        ref_stage = (stage_of(skel.rank[sink]) if stage_of
                     else skel.rank[sink])
    all_ranks = sorted(skel._tail)
    ref_ranks = frozenset(
        r for r in all_ranks
        if (stage_of(r) if stage_of else r) == ref_stage
    ) or frozenset({skel.rank[sink]})
    ref_rank = min(ref_ranks)

    buckets = _timeline_waterfall(skel, S, W, ref_rank, ref_ranks,
                                  makespan)
    if straggle_ratio != 1.0:
        buckets["straggler"] = makespan * (straggle_ratio - 1.0)
    segs = _segments(skel, path, W, ref_ranks, rank_map, stage_of)
    report["waterfall"] = {
        "order": _waterfall_order(buckets),
        "buckets": buckets,
        "total": makespan * straggle_ratio,
    }
    # merged segments; capped for pod-size leaf paths with the true
    # total recorded (no silent truncation — the waterfall above is
    # always complete)
    report["path"] = [s.to_dict() for s in segs[:20000]]
    report["path_segments"] = len(segs)
    report["path_truncated"] = len(segs) > 20000
    report["ref_rank"] = (
        rank_map[ref_rank] if rank_map is not None else ref_rank
    )
    report["ref_stage"] = ref_stage
    report["makespan_rank"] = (
        rank_map[skel.rank[sink]] if rank_map is not None
        else skel.rank[sink]
    )

    # one fused pass over the nodes: slack distribution, per-rank /
    # per-link headroom sources, Chrome annotations, per-op work on
    # the reference rank (bench_simulate gates this post-pass at
    # <= 15% events/s overhead, so the O(n) passes stay merged)
    n = len(skel)
    kinds, ranks_l, links, dims = skel.kind, skel.rank, skel.link, skel.dim
    emit_idxs, names = skel.emit_idx, skel.name
    finite: List[float] = []
    zero_count = 0
    rank_work: Dict[int, float] = {}
    rank_slack: Dict[int, float] = {}
    link_work: Dict[str, float] = {}
    link_slack: Dict[str, float] = {}
    #: class-weighted link/dim work: total wire+exposed seconds across
    #: the EXACT world (a reduced node stands for ``weights[r]``
    #: symmetric copies) — the fault-replay slack gate bounds the
    #: worst-case injected delay of a dim-wide degradation with it
    link_wwork: Dict[str, float] = {}
    # time-bucketed slack/work: a fault window mid-step only touches
    # the nodes it overlaps, so the replay gate needs min-slack/work
    # restricted to the window — whole-step minima are ~always zero
    # (the optimizer barrier alone puts a zero-slack node on every
    # rank). A node spanning several buckets contributes its full work
    # to each (overcount; the gate's delay bound stays conservative).
    n_buckets = 48
    bscale = (n_buckets / makespan) if makespan > 0 else 0.0
    rank_bwork: Dict[int, List[float]] = {}
    rank_bslack: Dict[int, List[float]] = {}
    link_bwork: Dict[str, List[float]] = {}
    link_bslack: Dict[str, List[float]] = {}

    def _bucket_span(lo_t: float, hi_t: float):
        lo = int(lo_t * bscale)
        hi = int(hi_t * bscale)
        lo = 0 if lo < 0 else (n_buckets - 1 if lo >= n_buckets else lo)
        hi = lo if hi < lo else (n_buckets - 1 if hi >= n_buckets
                                 else hi)
        return lo, hi
    annotations: Dict[tuple, tuple] = {}
    emitted: List[int] = []
    op_work: Dict[str, float] = {}
    inf = math.inf
    for j in range(n):
        k = kinds[j]
        sj = slack[j]
        idx = emit_idxs[j]
        r = ranks_l[j]
        if idx >= 0:
            annotations[(r, idx)] = (sj, j in on_path)
            if sj != inf:
                emitted.append(j)
        if k == "trace":
            continue
        finite.append(sj)
        if sj <= 1e-12:
            zero_count += 1
        w = W[j]
        rank_work[r] = rank_work.get(r, 0.0) + w
        if sj < rank_slack.get(r, inf):
            rank_slack[r] = sj
        blo, bhi = _bucket_span(S[j], skel.end[j])
        bw = rank_bwork.get(r)
        if bw is None:
            bw = rank_bwork[r] = [0.0] * n_buckets
            rank_bslack[r] = [inf] * n_buckets
        bs = rank_bslack[r]
        for b in range(blo, bhi + 1):
            bw[b] += w
            if sj < bs[b]:
                bs[b] = sj
        lk = links[j]
        if lk is not None:
            a, b2 = lk
            if rank_map is not None:
                a, b2 = rank_map[a], rank_map[b2]
            key = f"pp:{a}->{b2}"
        elif dims[j]:
            key = f"dim:{dims[j]}"
        else:
            key = None
        if key is not None:
            ww = w * (weights[r] if weights is not None else 1)
            link_work[key] = link_work.get(key, 0.0) + w
            link_wwork[key] = link_wwork.get(key, 0.0) + ww
            if sj < link_slack.get(key, inf):
                link_slack[key] = sj
            lbw = link_bwork.get(key)
            if lbw is None:
                lbw = link_bwork[key] = [0.0] * n_buckets
                link_bslack[key] = [inf] * n_buckets
            lbs = link_bslack[key]
            for b in range(blo, bhi + 1):
                lbw[b] += ww
                if sj < lbs[b]:
                    lbs[b] = sj
        if r == ref_rank and w > 0 and k not in ("join", "advance"):
            op = _base_op(names[j])
            op_work[op] = op_work.get(op, 0.0) + w
    finite.sort()

    def _pct(q):
        if not finite:
            return 0.0
        return finite[min(len(finite) - 1, int(q * len(finite)))]

    report["slack"] = {
        "events": len(finite),
        "zero_slack_events": zero_count,
        "p50_us": _pct(0.50) * 1e6,
        "p90_us": _pct(0.90) * 1e6,
        "max_us": (finite[-1] if finite else 0.0) * 1e6,
    }
    # deterministic per-event samples: the tightest and loosest emitted
    # events, addressable as engine (rank, emit index) — the exact key
    # the engine's ``event_delays`` perturbation hook takes, which is
    # what the slack-correctness property test replays
    emitted.sort(key=lambda j: (slack[j], ranks_l[j], j))

    def _sample(j):
        return {
            "engine_rank": ranks_l[j], "emit_idx": emit_idxs[j],
            "name": names[j], "slack_us": slack[j] * 1e6,
        }

    report["slack_samples"] = {
        "tightest": [_sample(j) for j in emitted[:32]],
        "loosest": [_sample(j) for j in emitted[-32:][::-1]],
    }
    per_rank = _headroom(rank_work, rank_slack)
    for e in per_rank:
        r = e.pop("key")
        e["rank"] = rank_map[r] if rank_map is not None else r
        e["members"] = weights[r] if weights is not None else 1
        if stage_of:
            e["stage"] = stage_of(r)
    # lists are tightest-first and capped for pod-size worlds; the
    # *_count fields carry the true totals (no silent truncation)
    report["per_rank_headroom"] = per_rank[:64]
    report["per_rank_count"] = len(per_rank)
    per_link = _headroom(link_work, link_slack)
    for e in per_link:
        e["link"] = e.pop("key")
    report["per_link_headroom"] = per_link[:64]
    report["per_link_count"] = len(per_link)

    # machine-facing slack index (the fault-replay slack gate,
    # ``simulator/faults.py``): UNtruncated, raw engine seconds.
    # Rank rows are keyed by representative global rank (class members
    # behave bit-identically, so they share the rep's row); link rows
    # carry class-weighted work so a dim-wide perturbation's delay
    # bound covers every symmetric copy in the exact world. ``None``
    # slack = unbounded (no timing successor observed).
    def _bs_out(arr: List[float]) -> List[Optional[float]]:
        return [v if math.isfinite(v) else None for v in arr]

    report["slack_index"] = {
        "mode": report["meta"].get("mode"),
        "buckets": n_buckets,
        "makespan_s": makespan,
        "ranks": [
            [rank_map[r] if rank_map is not None else r,
             rank_work.get(r, 0.0),
             (rank_slack[r]
              if math.isfinite(rank_slack.get(r, inf)) else None)]
            for r in sorted(rank_work)
        ],
        "links": [
            [k, link_wwork[k],
             (link_slack[k]
              if math.isfinite(link_slack.get(k, inf)) else None)]
            for k in sorted(link_wwork)
        ],
        "rank_buckets": [
            [rank_map[r] if rank_map is not None else r,
             rank_bwork[r], _bs_out(rank_bslack[r])]
            for r in sorted(rank_bwork)
        ],
        "link_buckets": [
            [k, link_bwork[k], _bs_out(link_bslack[k])]
            for k in sorted(link_bwork)
        ],
    }

    report["sim_ops"] = op_work
    return report, annotations


_MB_RE = re.compile(r"(?:#|_)mb\d+$")


def _base_op(name: str) -> str:
    """Collapse an engine event name to its op identity: strip the
    ``#mb<k>`` / ``_mb<k>`` instance suffix and the phase tail, so
    events aggregate per op across microbatches
    (``layer0.mlp.up.fwd#mb3`` -> ``layer0.mlp.up``, chunk-granularity
    ``fwd_mb3`` -> ``fwd``)."""
    base = _MB_RE.sub("", name)
    for suffix in (".fwd", ".bwd", ".recompute"):
        if base.endswith(suffix):
            return base[: -len(suffix)]
    return base


# --------------------------------------------------------------------------
# Sim-vs-analytical divergence
# --------------------------------------------------------------------------

#: analytical bucket -> simulated buckets alignment (see
#: docs/observability.md: the analytical ``pipeline_bubble`` includes
#: blocking p2p stalls, so ``comm:pp`` folds into it on the sim side)
_ALIGN = (
    ("ideal_compute + compute_inefficiency",
     ("ideal_compute", "compute_inefficiency"), ("compute",)),
    ("exposed_comm", ("exposed_comm",), ("comm:*",)),
    ("pipeline_bubble", ("pipeline_bubble",),
     ("pipeline_bubble", "comm:pp")),
    ("recompute", ("recompute",), ("recompute",)),
    ("dp_optimizer_sync", ("dp_optimizer_sync",), ("dp_optimizer_sync",)),
    ("straggler", ("straggler",), ("straggler",)),
    ("fault", (), ("fault",)),
)


def diverge(perf, report: Dict[str, Any], top: int = 10) -> Dict[str, Any]:
    """Align the simulated waterfall bucket-by-bucket against the
    analytical ``build_waterfall`` and name the top disagreeing
    ops/collectives (per-op analytical charge x mbc on the reference
    stage vs realized work on the reference rank's timeline).

    Bucket divergence localizes model drift: a ``compute`` gap points
    at efficiency-table entries (the calibration-drift
    signal), an ``exposed_comm`` gap at collective bw/lat terms, a
    ``pipeline_bubble`` gap at the schedule model itself."""
    from simumax_tpu_torch.observe.ledger import build_waterfall

    awf = build_waterfall(perf)
    sim = report["waterfall"]["buckets"]

    def _sum_sim(keys):
        total = 0.0
        for k in keys:
            if k == "comm:*":
                total += sum(v for b, v in sim.items()
                             if b.startswith("comm:") and b != "comm:pp")
            else:
                total += sim.get(k, 0.0)
        return total

    rows = []
    for label, akeys, skeys in _ALIGN:
        a = sum(awf["buckets"].get(k, 0.0) for k in akeys)
        s = _sum_sim(skeys)
        rows.append({
            "bucket": label,
            "analytical_ms": a * 1e3,
            "simulated_ms": s * 1e3,
            "delta_ms": (s - a) * 1e3,
        })
    # per-op disagreement on the reference stage — leaf granularity
    # only: chunk-granularity events are whole-microbatch aggregates
    # with no per-op identity to align against the analytical spans
    st = perf.strategy
    mbc = st.micro_batch_num
    ref_stage = report.get("ref_stage", 0)
    if report.get("meta", {}).get("granularity") != "leaf":
        return {
            "schema": "simumax-critpath-divergence-v1",
            "analytical_total_ms": awf["total"] * 1e3,
            "simulated_total_ms": report["waterfall"]["total"] * 1e3,
            "delta_ms": (report["waterfall"]["total"]
                         - awf["total"]) * 1e3,
            "buckets": rows,
            "ref_stage": ref_stage,
            "top_op_deltas": [],
            "note": "per-op divergence needs granularity=leaf",
        }
    analytical_ops: Dict[str, float] = {}
    for (stage, _chunk), chunk in sorted(perf.chunks.items()):
        if stage != ref_stage:
            continue
        for leaf in chunk.called_leaves():
            key = leaf.path_name().split(".", 1)[-1]
            analytical_ops[key] = (
                analytical_ops.get(key, 0.0)
                + mbc * (leaf.cost_info.compute.total
                         + leaf.cost_info.net_exposed.total)
            )
    sim_ops = report.get("sim_ops", {})
    # sim op keys carry per-leaf suffixes the analytical side charges on
    # the leaf itself (".all_gather[tp]", ".fwd_comm"): fold onto the
    # longest analytical key that prefixes them
    folded: Dict[str, float] = {}
    akeys_sorted = sorted(analytical_ops, key=len, reverse=True)
    for k, v in sim_ops.items():
        target = k
        if k not in analytical_ops:
            for ak in akeys_sorted:
                if k.startswith(ak + "."):
                    target = ak
                    break
        folded[target] = folded.get(target, 0.0) + v
    deltas = [
        {"op": p, "analytical_ms": analytical_ops.get(p, 0.0) * 1e3,
         "simulated_ms": folded.get(p, 0.0) * 1e3,
         "delta_ms": (folded.get(p, 0.0)
                      - analytical_ops.get(p, 0.0)) * 1e3}
        for p in set(analytical_ops) | set(folded)
    ]
    deltas.sort(key=lambda d: abs(d["delta_ms"]), reverse=True)
    return {
        "schema": "simumax-critpath-divergence-v1",
        "analytical_total_ms": awf["total"] * 1e3,
        "simulated_total_ms": report["waterfall"]["total"] * 1e3,
        "delta_ms": (report["waterfall"]["total"] - awf["total"]) * 1e3,
        "buckets": rows,
        "ref_stage": ref_stage,
        "top_op_deltas": deltas[:top],
    }


# --------------------------------------------------------------------------
# Presentation + persistence
# --------------------------------------------------------------------------


def waterfall_lines(report: Dict[str, Any]) -> List[str]:
    """Human rendering of the simulated waterfall (the
    ``critical-path`` subcommand's default output)."""
    wf = report["waterfall"]
    total = wf["total"] or 1.0
    if not wf["order"]:
        return ["== simulated waterfall: empty run =="]
    width = max(len(k) for k in wf["order"])
    lines = [
        f"== simulated critical-path waterfall — DES makespan "
        f"{report['end_time_ms']:.2f} ms "
        f"({report['n_nodes']} dependency nodes, ref rank "
        f"{report.get('ref_rank', 0)} / stage "
        f"{report.get('ref_stage', 0)}) =="
    ]
    for key in wf["order"]:
        v = wf["buckets"][key]
        ms = round(v * 1e3, 3) + 0.0
        pct = round(100.0 * v / total, 2) + 0.0
        lines.append(f"  {key:<{width}}  {ms:10.3f} ms  {pct:6.2f}%")
    lines.append(
        f"  {'= makespan':<{width}}  {total * 1e3:10.3f} ms  100.00%"
    )
    return lines


def headroom_lines(report: Dict[str, Any], top: int = 5) -> List[str]:
    lines = []
    tight = [e for e in report.get("per_rank_headroom", [])
             if e.get("tolerates_slowdown_pct") is not None][:top]
    if tight:
        lines.append("-- tightest ranks (tolerable uniform slowdown "
                     "before step time moves) --")
        for e in tight:
            members = (f" (x{e['members']} symmetric ranks)"
                       if e.get("members", 1) > 1 else "")
            lines.append(
                f"  rank {e['rank']} (stage {e.get('stage', '?')}): "
                f"{e['tolerates_slowdown_pct']:.2f}% "
                f"(min slack {e['min_slack_us']:.1f} us over "
                f"{e['work_ms']:.1f} ms work){members}"
            )
    tight = [e for e in report.get("per_link_headroom", [])
             if e.get("tolerates_slowdown_pct") is not None][:top]
    if tight:
        lines.append("-- tightest links/dims --")
        for e in tight:
            lines.append(
                f"  {e['link']}: {e['tolerates_slowdown_pct']:.2f}% "
                f"(min slack {e['min_slack_us']:.1f} us over "
                f"{e['work_ms']:.1f} ms comm)"
            )
    return lines


def divergence_lines(div: Dict[str, Any], top: int = 5) -> List[str]:
    lines = [
        f"-- sim vs analytical: {div['simulated_total_ms']:.2f} ms vs "
        f"{div['analytical_total_ms']:.2f} ms "
        f"({div['delta_ms']:+.2f} ms) --"
    ]
    width = max(len(r["bucket"]) for r in div["buckets"])
    for r in div["buckets"]:
        lines.append(
            f"  {r['bucket']:<{width}}  {r['analytical_ms']:10.3f} -> "
            f"{r['simulated_ms']:10.3f} ms  ({r['delta_ms']:+.3f} ms)"
        )
    shown = [d for d in div["top_op_deltas"] if d["delta_ms"] != 0][:top]
    if shown:
        lines.append("  -- top disagreeing ops/collectives "
                     "(ref stage, x mbc) --")
        for d in shown:
            lines.append(
                f"    {d['delta_ms']:+9.3f} ms  {d['op']}"
            )
    return lines


def save_report(report: Dict[str, Any], path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, default=str)
    return path


def load_report(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    schema = data.get("schema")
    if schema != CRITPATH_SCHEMA:
        raise ConfigError(
            f"{path}: not a simumax critical-path report "
            f"(schema={schema!r}; expected {CRITPATH_SCHEMA!r} — produce "
            f"one with `save_report`)"
        )
    return data


def diff_critpath(a: Dict[str, Any], b: Dict[str, Any],
                  top: int = 10) -> Dict[str, Any]:
    """Compare two critical-path reports (two strategies, or a healthy
    run vs a fault scenario): makespan movement, per-bucket waterfall
    deltas, and headroom shifts on the tightest ranks."""
    keys = set(a["waterfall"]["buckets"]) | set(b["waterfall"]["buckets"])
    wf = {
        k: {
            "a": a["waterfall"]["buckets"].get(k, 0.0),
            "b": b["waterfall"]["buckets"].get(k, 0.0),
            "delta": b["waterfall"]["buckets"].get(k, 0.0)
            - a["waterfall"]["buckets"].get(k, 0.0),
        }
        for k in keys
    }

    def _rank_headroom(rep):
        return {
            e["rank"]: e.get("tolerates_slowdown_pct")
            for e in rep.get("per_rank_headroom", [])
        }

    ha, hb = _rank_headroom(a), _rank_headroom(b)
    # compare only ranks present on BOTH sides: the per-rank lists are
    # capped tightest-first, so a rank merely entering/leaving the
    # window is a list artifact, not a headroom change
    headroom = [
        {"rank": r, "a_pct": ha[r], "b_pct": hb[r]}
        for r in sorted(set(ha) & set(hb))
        if ha[r] != hb[r]
    ]
    identical = (
        a["end_time_ms"] == b["end_time_ms"]
        and all(v["delta"] == 0 for v in wf.values())
        and not headroom
    )
    return {
        "schema": "simumax-critpath-diff-v1",
        "identical": identical,
        "end_time_ms": {
            "a": a["end_time_ms"], "b": b["end_time_ms"],
            "delta": b["end_time_ms"] - a["end_time_ms"],
        },
        "waterfall": wf,
        "headroom_changes": headroom[:top],
        "ref_rank": {"a": a.get("ref_rank"), "b": b.get("ref_rank")},
    }


def format_critpath_diff_lines(diff: Dict[str, Any],
                               top: int = 10) -> List[str]:
    lines = [
        f"== critical-path diff: {diff['end_time_ms']['a']:.2f} -> "
        f"{diff['end_time_ms']['b']:.2f} ms "
        f"({diff['end_time_ms']['delta']:+.2f} ms) =="
    ]
    if diff["identical"]:
        lines.append("  identical: zero delta in every bucket")
        return lines
    order = _waterfall_order({k: 1 for k in diff["waterfall"]})
    width = max(len(k) for k in order) if order else 1
    for k in order:
        d = diff["waterfall"][k]
        if d["a"] == 0 and d["b"] == 0:
            continue
        lines.append(
            f"  {k:<{width}}  {d['a'] * 1e3:10.3f} -> "
            f"{d['b'] * 1e3:10.3f} ms  ({d['delta'] * 1e3:+.3f} ms)"
        )
    shown = diff.get("headroom_changes", [])[:top]
    if shown:
        lines.append("  -- slack-headroom changes --")
        for h in shown:
            fa = ("-" if h["a_pct"] is None else f"{h['a_pct']:.2f}%")
            fb = ("-" if h["b_pct"] is None else f"{h['b_pct']:.2f}%")
            lines.append(f"    rank {h['rank']}: {fa} -> {fb}")
    return lines

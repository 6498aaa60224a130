"""Batched scenario replay: the reduced DES lowered into an op table
that one CUDA kernel launch replays for a whole batch of fault
scenarios.

The incremental replay (``simulator/faults.py``: ``ReplayContext``)
already collapses Monte-Carlo fault analysis onto a small set of
*step-program families* (one recorded per-class request stream per
touched-rank partition) and answers most steps from caches — but every
remaining miss walks the Python event loop of
:class:`simulator.engine.SimuEngine` one request at a time. This module
lowers a family's recorded streams ONCE into a fixed op table and
replays all of a Monte-Carlo round's cache misses of that family in
one call:

* :func:`lower_family` runs a symbolic (time-free) scheduler over the
  recorded streams, mirroring the engine's rendezvous / p2p / async
  matching rules, and emits a linear op table in a dependency-valid
  service order. With no rank deaths the engine's values are
  order-independent (every op's outputs are pure functions of its
  inputs — max/+ clock algebra), so ANY valid topological order
  reproduces the scalar engine bit-for-bit; the one order-dependent
  request kind (``sendrecv``) is a justified fallback, not lowered.
* :func:`solve_batch` evaluates the op table over the op index —
  rendezvous joins as masked max, compute ops as the exact piecewise
  slowdown integration of ``StepFaultModel.compute_end``, link
  degradations as an ordered product over the scenario's event-ordered
  link windows — for every scenario of the batch: on the card as one
  launch of the CUDA kernel ``replay_levels_kernel``
  (``csrc/replay.cu``, wrapped by ``torchref.kernels.replay_levels``),
  on the CPU as its plain PyTorch version :func:`replay_solve_plain`.
* :func:`level_schedule` sorts a family's op table by dependence level
  (146 levels for up to 9137 ops in the v5p-256 example), and
  :func:`replay_tables` puts the level-ordered table on the card once
  per family; a call then packs and copies only its scenarios' arrays
  (:func:`pack_scenarios`) and the kernel replays a level at a time.

The scalar engine remains the bit-identity oracle: batched makespans
feed the same ``(raw_end * straggle_ratio, None, raw_end)`` tail as
``ReplayContext._replay``. Scenarios that cannot lower fall back
per-scenario to the scalar engine with a counted reason
(``FALLBACK_REASONS``) — never a whole-batch downgrade.

Determinism: no wall-clock, no unsorted set iteration; the symbolic
scheduler visits ranks in index order, so the emitted op table is a
pure function of the input streams.

Copy of the JAX package's ``simulator/batched_replay.py``: the
lowering (:func:`lower_family`, :func:`prepare_scenario`,
:class:`LoweredProgram`) with its import paths changed; its
``solve_batch``, a vmapped ``fori_loop`` jitted by XLA (``_compiled``),
becomes the CUDA kernel and the plain version here, which take the op
count, the batch size and the fault arrays' real widths as they are
(the JAX package pads each to a power of two and repeats the last
scenario into padded batch rows for XLA's compile cache, which changes
no result). ``jax_unavailable`` has no counterpart. The port's one
bounded cache a shape on this path is the level-schedule LRU
(``_SCHEDULES``): :func:`compile_cache_info` reports it under the
compile cache's two gauge names.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Lowering vocabulary (the SIM002-style drift contract)
# --------------------------------------------------------------------------

#: op codes of the op table (the same numbers in ``csrc/replay.cu``)
OP_NOOP = 0          # padding
OP_COMPUTE = 1       # piecewise slowdown integration (compute_end)
OP_ADVANCE_ABS = 2   # clock = max(clock, t)
OP_ADVANCE_REL = 3   # clock = max(clock, clock + delta)
OP_COLL = 4          # sync rendezvous: masked max + link scale
OP_ASYNC_POST = 5    # record poster's clock in a value slot
OP_ASYNC_FINISH = 6  # chained stream op: max(posts, chain) + scale
OP_WAIT_COMM = 7     # clock = max(clock, comm_done)
OP_SEND = 8          # publish post + scaled duration (non-blocking)
OP_SEND_SYNC = 9     # rendezvous send: max(clock, peer recv post)
OP_RECV = 10         # consume a published send

N_OP_KINDS = 11

#: engine request kind -> lowered op kind(s). Every kind the scalar
#: engine's ``_try_serve`` handles MUST appear here or in
#: ``FALLBACK_REQUEST_KINDS`` — drift is a staticcheck finding
#: (SIM008, ``tools/staticcheck/checkers/replay_drift.py``).
LOWERED_REQUEST_KINDS: Dict[str, Tuple[int, ...]] = {
    "compute": (OP_COMPUTE,),
    "advance": (OP_ADVANCE_ABS,),
    "advance_rel": (OP_ADVANCE_REL,),
    "trace": (OP_NOOP,),  # zero-advance visibility span: no state
    "collective": (OP_COLL,),
    "async_collective": (OP_ASYNC_POST, OP_ASYNC_FINISH),
    "wait_comm": (OP_WAIT_COMM,),
    "send": (OP_SEND,),
    "send_sync": (OP_SEND_SYNC,),
    "recv": (OP_RECV,),
}

#: request kinds deliberately NOT lowered, with the justification the
#: drift checker requires. A kind listed here routes the scenario to
#: the scalar engine with a counted fallback reason.
FALLBACK_REQUEST_KINDS: Dict[str, str] = {
    "sendrecv": "completion races the peer's recv consumption "
                "(_sr_done): genuinely service-order-dependent, so no "
                "single static op order reproduces the engine",
}

#: the closed per-scenario fallback-reason catalogue surfaced by
#: ``replay_batch_fallbacks_total{reason}`` and the bench JSON lines
FALLBACK_REASONS = (
    "deaths",          # rank deaths mid-step: kill/abort paths stay scalar
    "sendrecv",        # stream contains an order-dependent sendrecv
    "unknown_kind",    # stream contains a kind outside the vocabulary
    "no_streams",      # family not recorded yet (first sim records)
    "lowering_error",  # symbolic schedule wedged / inconsistent stream
    "small_batch",     # auto backend: batch below the dispatch floor
    "backend_numpy",   # replay_backend="numpy" requested
)

#: minimum miss-batch size for ``replay_backend="auto"`` to dispatch
#: the batched replay; below it the dispatch + prep overhead beats the
#: win and the scalar engine stays faster (the search's
#: ``JIT_GROUP_MIN`` discipline, scaled to step-replay cost)
JIT_BATCH_MIN = 2


class LoweringError(Exception):
    """The family's streams cannot lower to an array program; carries
    the counted fallback ``reason``."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"{reason}: {detail}" if detail else reason)


# --------------------------------------------------------------------------
# Symbolic lowering: recorded streams -> linear op table
# --------------------------------------------------------------------------


@dataclass
class LoweredProgram:
    """The op table of one step-program family."""

    n_classes: int
    reps: Tuple[int, ...]            # class -> representative global rank
    kind: np.ndarray                 # int32 [L]
    rank: np.ndarray                 # int32 [L]
    dur: np.ndarray                  # float64 [L]
    aux: np.ndarray                  # int32 [L] (dst / slot / chain id)
    mask: np.ndarray                 # bool [L, K] rendezvous members
    refs: np.ndarray                 # int32 [L, G] async post slots
    peer_mask: np.ndarray            # bool [L, K] comm-scale scope peers
    op_dim_id: np.ndarray            # int32 [L], -1 = not a comm op
    dim_ids: Dict[str, int]          # collective-dim vocabulary
    n_chains: int                    # async chain slots (V2 length)
    #: the family's level-ordered tables on each device it was replayed
    #: on (:func:`replay_tables`), memoised with the program
    tables: Dict[str, Any] = field(default_factory=dict, repr=False,
                                   compare=False)

    @property
    def n_ops(self) -> int:
        return int(self.kind.shape[0])


def _key_dim_of(key) -> Optional[str]:
    from simumax_tpu_torch.simulator.faults import key_dim

    return key_dim(key)


def lower_family(streams: Sequence[list], plan) -> LoweredProgram:
    """Lower one family's recorded per-class request streams into a
    linear op table.

    Runs a time-free mirror of the engine's matching rules (rendezvous
    seq counters, p2p send/recv seq + post windows, async chains) and
    serves requests in a deterministic lowest-ready-class order. The
    emitted order is *a* valid topological order of the step's event
    DAG; with no deaths the engine's values are order-independent, so
    the array program reproduces the ready-heap schedule bit-for-bit.

    Raises :class:`LoweringError` with a counted reason for streams
    that cannot lower (``sendrecv``, unknown kinds, or a wedged
    symbolic schedule)."""
    k_classes = plan.n_classes
    if len(streams) != k_classes:
        raise LoweringError("lowering_error",
                            f"{len(streams)} streams for {k_classes} "
                            "classes")
    idx = [0] * k_classes
    done = [len(s) == 0 for s in streams]
    coll_seq: Dict[tuple, int] = {}
    send_seq: Dict[tuple, int] = {}
    recv_seq: Dict[tuple, int] = {}
    async_seq: Dict[tuple, int] = {}
    collectives: Dict[tuple, dict] = {}
    sends: Dict[tuple, int] = {}         # skey -> publishing op slot
    recv_posted: set = set()
    async_rv: Dict[tuple, dict] = {}
    async_pending: List[set] = [set() for _ in range(k_classes)]
    chain_ids: Dict[tuple, int] = {}

    kinds: List[int] = []
    ranks: List[int] = []
    durs: List[float] = []
    auxs: List[int] = []
    masks: List[Optional[Tuple[int, ...]]] = []
    refs: List[Optional[Tuple[int, ...]]] = []
    peer_masks: List[Optional[Tuple[int, ...]]] = []
    op_dims: List[Optional[str]] = []

    def emit(op: int, rank: int = 0, dur: float = 0.0, aux: int = 0,
             mask: Optional[Tuple[int, ...]] = None,
             ref: Optional[Tuple[int, ...]] = None,
             peers: Optional[Tuple[int, ...]] = None,
             dim: Optional[str] = None) -> int:
        kinds.append(op)
        ranks.append(rank)
        durs.append(dur)
        auxs.append(aux)
        masks.append(mask)
        refs.append(ref)
        peer_masks.append(peers)
        op_dims.append(dim)
        return len(kinds) - 1

    def serve(r: int) -> bool:
        """Attempt to serve class ``r``'s next request; True when it
        progressed (the request completed and the pointer advanced)."""
        req = streams[r][idx[r]]
        kind = req[0]
        if kind == "compute":
            _, duration, _name, _lane = req
            emit(OP_COMPUTE, rank=r, dur=float(duration))
            return True
        if kind == "advance":
            emit(OP_ADVANCE_ABS, rank=r, dur=float(req[1]))
            return True
        if kind == "advance_rel":
            emit(OP_ADVANCE_REL, rank=r, dur=float(req[1]))
            return True
        if kind == "trace":
            return True  # no clock/state effect under drop_events
        if kind == "collective":
            # seq bookkeeping mirrors the engine exactly: a rank
            # arrives under its CURRENT per-(key, rank) seq, stays
            # blocked until the rendezvous completes, and increments
            # only when it consumes the completed rendezvous — a
            # blocked peer re-served after completion must land on the
            # same ckey, not the next seq slot
            _, key, duration, _name, peers = req
            seq = coll_seq.get((key, r), 0)
            pset = frozenset(peers)
            ckey = (key, pset, seq)
            rv = collectives.get(ckey)
            if rv is None:
                rv = collectives[ckey] = {
                    "arrived": set(), "consumed": set(),
                    "dur": float(duration), "done": False,
                }
            if r not in rv["arrived"]:
                if r not in pset:
                    raise LoweringError(
                        "lowering_error",
                        f"collective {key!r}#{seq}: class {r} not in "
                        f"its own peer list")
                if rv["dur"] != float(duration):
                    raise LoweringError(
                        "lowering_error",
                        f"collective {key!r}#{seq}: mismatched "
                        "durations")
                rv["arrived"].add(r)
                if rv["arrived"] == pset:
                    members = tuple(sorted(pset))
                    emit(OP_COLL, dur=rv["dur"], mask=members,
                         peers=members, dim=_key_dim_of(key))
                    rv["done"] = True
            if not rv["done"]:
                return False  # blocked until the last peer arrives
            coll_seq[(key, r)] = seq + 1
            rv["consumed"].add(r)
            if rv["consumed"] == pset:
                del collectives[ckey]
            return True
        if kind == "async_collective":
            _, stream_name, duration, _name, peers = req
            seq = async_seq.get((stream_name, r), 0)
            async_seq[(stream_name, r)] = seq + 1
            pset = frozenset(peers)
            ckey = (stream_name, pset, seq)
            rv = async_rv.get(ckey)
            if rv is None:
                rv = async_rv[ckey] = {
                    "slots": [], "arrived": set(), "dur": float(duration),
                }
            if r not in pset or rv["dur"] != float(duration):
                raise LoweringError(
                    "lowering_error",
                    f"async {stream_name!r}#{seq}: inconsistent post")
            slot = emit(OP_ASYNC_POST, rank=r)
            rv["slots"].append(slot)
            rv["arrived"].add(r)
            async_pending[r].add(ckey)
            if rv["arrived"] == pset:
                chain_key = (stream_name, pset)
                cid = chain_ids.setdefault(chain_key, len(chain_ids))
                members = tuple(sorted(pset))
                emit(OP_ASYNC_FINISH, dur=rv["dur"], aux=cid,
                     mask=members, ref=tuple(rv["slots"]),
                     peers=members, dim=_key_dim_of(stream_name))
                del async_rv[ckey]
                for p in pset:
                    async_pending[p].discard(ckey)
            return True  # poster never blocks
        if kind == "wait_comm":
            if async_pending[r]:
                return False  # some posted op still waits on peers
            emit(OP_WAIT_COMM, rank=r)
            return True
        if kind == "send":
            _, dst, tag, duration, _name, *_rest = req
            seq = send_seq.get((r, dst, tag), 0)
            send_seq[(r, dst, tag)] = seq + 1
            skey = (r, dst, tag, seq)
            if skey in sends:
                raise LoweringError("lowering_error",
                                    f"duplicate send {skey}")
            sends[skey] = emit(OP_SEND, rank=r, dur=float(duration),
                               peers=(r, dst), dim="pp")
            return True
        if kind == "send_sync":
            _, dst, tag, duration, _name, *_rest = req
            seq = send_seq.get((r, dst, tag), 0)
            skey = (r, dst, tag, seq)
            if skey not in recv_posted:
                return False  # peer not at its recv yet
            send_seq[(r, dst, tag)] = seq + 1
            sends[skey] = emit(OP_SEND_SYNC, rank=r,
                               dur=float(duration), aux=dst,
                               peers=(r, dst), dim="pp")
            return True
        if kind == "recv":
            _, src, tag, _name, *_rest = req
            seq = recv_seq.get((r, src, tag), 0)
            skey = (src, r, tag, seq)
            recv_posted.add(skey)
            slot = sends.pop(skey, None)
            if slot is None:
                return False  # sender hasn't published yet
            recv_posted.discard(skey)
            recv_seq[(r, src, tag)] = seq + 1
            emit(OP_RECV, rank=r, aux=slot)
            return True
        if kind in FALLBACK_REQUEST_KINDS:
            raise LoweringError(kind)
        raise LoweringError("unknown_kind", repr(kind))

    remaining = sum(len(s) for s in streams)
    while remaining:
        progressed = False
        for r in range(k_classes):
            if done[r]:
                continue
            while idx[r] < len(streams[r]):
                if not serve(r):
                    break
                idx[r] += 1
                remaining -= 1
                progressed = True
            if idx[r] >= len(streams[r]):
                done[r] = True
        if not progressed:
            raise LoweringError("lowering_error",
                                "symbolic schedule made no progress "
                                "(wedged rendezvous/p2p matching)")
    if collectives or async_rv:
        raise LoweringError("lowering_error",
                            "unfinished rendezvous at stream end")

    n_ops = len(kinds)
    group = max((len(rf) for rf in refs if rf), default=1)
    mask_a = np.zeros((n_ops, k_classes), dtype=bool)
    peer_a = np.zeros((n_ops, k_classes), dtype=bool)
    refs_a = np.full((n_ops, max(group, 1)), n_ops, dtype=np.int32)
    dim_ids: Dict[str, int] = {}
    dim_a = np.full(n_ops, -1, dtype=np.int32)
    for i in range(n_ops):
        if masks[i]:
            mask_a[i, list(masks[i])] = True
        if peer_masks[i]:
            peer_a[i, list(peer_masks[i])] = True
        if refs[i]:
            refs_a[i, : len(refs[i])] = refs[i]
        d = op_dims[i]
        if d is not None:
            dim_a[i] = dim_ids.setdefault(d, len(dim_ids))
    return LoweredProgram(
        n_classes=k_classes,
        reps=tuple(plan.reps),
        kind=np.asarray(kinds, dtype=np.int32),
        rank=np.asarray(ranks, dtype=np.int32),
        dur=np.asarray(durs, dtype=np.float64),
        aux=np.asarray(auxs, dtype=np.int32),
        mask=mask_a,
        refs=refs_a,
        peer_mask=peer_a,
        op_dim_id=dim_a,
        dim_ids=dim_ids,
        n_chains=max(len(chain_ids), 1),
    )


# --------------------------------------------------------------------------
# Per-scenario host prep (vectorized numpy)
# --------------------------------------------------------------------------


@dataclass
class ScenarioArrays:
    """One scenario's fault-model arrays, padded to the batch shape."""

    win_s: np.ndarray     # [K, W]
    win_e: np.ndarray     # [K, W]
    win_m: np.ndarray     # [K, W]
    edges: np.ndarray     # [K, We]
    has_slow: np.ndarray  # [K] bool
    link_s: np.ndarray    # [E]
    link_e: np.ndarray    # [E]
    link_m: np.ndarray    # [E]
    app: np.ndarray       # [L, E] bool: link applies to op


def prepare_scenario(prog: LoweredProgram, model, wp: int, wep: int,
                     ep: int) -> ScenarioArrays:
    """Lower one ``StepFaultModel`` (no deaths) against ``prog``:
    per-class slowdown windows + integration edges, and the scenario's
    event-ordered link windows with a precomputed per-op applicability
    matrix (dim match x scope intersection), so the replay never
    branches on host state."""
    k = prog.n_classes
    win_s = np.full((k, wp), math.inf)
    win_e = np.full((k, wp), math.inf)
    win_m = np.ones((k, wp))
    edges = np.full((k, wep), math.inf)
    has_slow = np.zeros(k, dtype=bool)
    for i in range(k):
        wins = model._slow.get(prog.reps[i])
        if not wins:
            continue
        has_slow[i] = True
        for j, (s, e, m) in enumerate(wins):
            win_s[i, j] = s
            win_e[i, j] = e
            win_m[i, j] = m
        eds = sorted({x for w in wins for x in w[:2]
                      if math.isfinite(x)})
        edges[i, : len(eds)] = eds
    links = model._links
    n_ops = prog.n_ops
    link_s = np.full(ep, math.inf)
    link_e = np.full(ep, math.inf)
    link_m = np.ones(ep)
    app = np.zeros((n_ops, ep), dtype=bool)
    is_comm = prog.op_dim_id >= 0
    for j, (d, s, e, mult, scope) in enumerate(links):
        link_s[j] = s
        link_e[j] = e
        link_m[j] = mult
        if d == "*":
            dim_ok = is_comm
        else:
            dim_ok = prog.op_dim_id == prog.dim_ids.get(d, -2)
        if scope is None:
            app[:, j] = dim_ok
        else:
            in_scope = np.fromiter(
                (prog.reps[c] in scope for c in range(k)), dtype=bool,
                count=k,
            )
            app[:, j] = dim_ok & (prog.peer_mask @ in_scope)
    return ScenarioArrays(win_s, win_e, win_m, edges, has_slow,
                          link_s, link_e, link_m, app)


# --------------------------------------------------------------------------
# The batch's tensors, the plain version and the dispatch
# --------------------------------------------------------------------------

#: the most link windows a scenario may carry: each op's applicability
#: row is one 64-bit word (bit j = link j)
MAX_LINKS = 64


@dataclass
class ReplayBatch:
    """One family's op table and a batch of scenarios' fault arrays as
    tensors on one device: what ``csrc/replay.cu`` and
    :func:`replay_solve_plain` take. ``L`` ops, ``K`` classes, ``B``
    scenarios, ``W`` slowdown windows a class (``2W`` edges), ``E``
    link windows; the widths are the batch's real maxima, padded with
    inert windows (start ``+inf``, multiplier 1)."""

    n_ops: int
    n_classes: int
    n_chains: int
    kind: Any      # int32 [L]
    rank: Any      # int32 [L]
    dur: Any       # float64 [L]
    aux: Any       # int32 [L] (dst class / send slot / chain id)
    mask: Any      # int32 [L, ceil(K / 32)]: rendezvous members, bit k % 32
    refs: Any      # int32 [L, G]: async post slots, L = the -inf slot
    win_s: Any     # float64 [B, K, W]
    win_e: Any     # float64 [B, K, W]
    win_m: Any     # float64 [B, K, W]
    edges: Any     # float64 [B, K, 2W], ascending, +inf padded
    has_slow: Any  # uint8 [B, K]
    link_s: Any    # float64 [B, E]
    link_e: Any    # float64 [B, E]
    link_m: Any    # float64 [B, E]
    app_bits: Any  # int64 [B, L]: bit j = link j applies to the op

    @property
    def batch(self) -> int:
        return int(self.win_s.shape[0])


def _mask_words(mask: np.ndarray) -> np.ndarray:
    """bool [L, K] -> uint32 [L, ceil(K / 32)]: class c at bit c % 32 of
    word c // 32."""
    n, k = mask.shape
    packed = np.packbits(mask, axis=1, bitorder="little")
    out = np.zeros((n, 4 * ((k + 31) // 32)), dtype=np.uint8)
    out[:, : packed.shape[1]] = packed
    return out.view(np.dtype("<u4"))


def pack_batch(prog: LoweredProgram, models: Sequence[Any],
               device="cuda") -> ReplayBatch:
    """``prog`` and one ``StepFaultModel`` (no deaths) per scenario as a
    :class:`ReplayBatch` on ``device``."""
    import torch

    k, n_ops = prog.n_classes, prog.n_ops
    w = max((len(m._slow.get(rep, ()))
             for m in models for rep in prog.reps), default=0)
    e = max((len(m._links) for m in models), default=0)
    if e > MAX_LINKS:
        raise ValueError(f"pack_batch: {e} link windows in one scenario; "
                         f"the replay takes at most {MAX_LINKS}")
    arrs = [prepare_scenario(prog, m, w, 2 * w, e) for m in models]
    bits = _mask_words(prog.mask)
    refs = np.where(prog.refs >= n_ops, n_ops, prog.refs).astype(np.int32)
    shifts = np.arange(e, dtype=np.uint64)
    app = np.stack([
        (a.app.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)
        for a in arrs
    ]).view(np.int64)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    f64, i32 = torch.float64, torch.int32
    return ReplayBatch(
        n_ops=n_ops, n_classes=k, n_chains=prog.n_chains,
        kind=t(prog.kind, i32), rank=t(prog.rank, i32),
        dur=t(prog.dur, f64), aux=t(prog.aux, i32),
        mask=t(bits.view(np.int32), i32), refs=t(refs, i32),
        win_s=t(np.stack([a.win_s for a in arrs]), f64),
        win_e=t(np.stack([a.win_e for a in arrs]), f64),
        win_m=t(np.stack([a.win_m for a in arrs]), f64),
        edges=t(np.stack([a.edges for a in arrs]), f64),
        has_slow=t(np.stack([a.has_slow for a in arrs]), torch.uint8),
        link_s=t(np.stack([a.link_s for a in arrs]), f64),
        link_e=t(np.stack([a.link_e for a in arrs]), f64),
        link_m=t(np.stack([a.link_m for a in arrs]), f64),
        app_bits=t(app, torch.int64),
    )


def replay_solve_plain(rb: ReplayBatch):
    """Plain PyTorch version of ``replay_levels_kernel``: the raw
    makespans (float64 [B]) of the op table under each scenario, one op
    at a time in the table's order (the kernel replays a level at a
    time; any order that keeps :func:`level_schedule`'s levels gives
    the same values).

    The body of the JAX package's ``_compiled``/``run_one``
    (``batched_replay.py:539-667``) step by step, in float64 tensors
    vectorised over the scenarios, with a Python loop over the op
    index. The op kind, rank and aux are the family's, shared by the
    batch, so this version branches on the kind where ``run_one``
    computes every kind and selects; the selected values are the same.
    Every product and sum rounds on its own, as the engine's do."""
    import torch

    f64 = torch.float64
    dev = rb.win_s.device
    b, k, n_ops = rb.batch, rb.n_classes, rb.n_ops
    inf = math.inf
    kind = rb.kind.tolist()
    rank = rb.rank.tolist()
    dur = rb.dur.tolist()
    aux = rb.aux.tolist()
    words = rb.mask.tolist()
    refs = rb.refs.tolist()
    n_win, n_edge, n_link = (rb.win_s.shape[2], rb.edges.shape[2],
                             rb.link_s.shape[1])
    members = [[c for c in range(k) if (words[i][c // 32] >> (c % 32)) & 1]
               for i in range(n_ops)]
    clock = torch.zeros((b, k), dtype=f64, device=dev)
    cd = torch.zeros((b, k), dtype=f64, device=dev)
    v = torch.zeros((b, n_ops + 1), dtype=f64, device=dev)
    v[:, n_ops] = -inf
    v2 = torch.zeros((b, rb.n_chains), dtype=f64, device=dev)
    one = torch.ones(b, dtype=f64, device=dev)
    has_slow = rb.has_slow.bool()
    app = [(rb.app_bits >> j) & 1 for j in range(n_link)]

    def scaled(i, t, d):
        """d * the ordered product of the links active at t."""
        scale = one
        for j in range(n_link):
            act = (app[j][:, i] == 1) & (rb.link_s[:, j] <= t) \
                & (t < rb.link_e[:, j])
            scale = scale * torch.where(act, rb.link_m[:, j], one)
        return d * scale

    def compute_end(r, cr, d):
        """The piecewise slowdown integration, edges in table order
        with the "passed already" guard."""
        res = cr + d
        if d <= 0.0 or not bool(has_slow[:, r].any()):
            return res
        pdone = ~has_slow[:, r]
        ws, we, wm = rb.win_s[:, r], rb.win_e[:, r], rb.win_m[:, r]
        eds = rb.edges[:, r]
        t = cr
        work = torch.full_like(cr, d)
        for s_ in range(n_edge + 1):
            e = eds[:, s_] if s_ < n_edge else torch.full_like(cr, inf)
            act = ~pdone & (e > t)
            mult = one
            for j in range(n_win):
                win = (ws[:, j] <= t) & (t < we[:, j])
                mult = torch.where(win, mult * wm[:, j], mult)
            frozen = torch.isinf(mult)
            need = work * mult
            fits = ~frozen & (t + need <= e)
            res = torch.where(act & fits, t + need, res)
            pdone = pdone | (act & fits)
            work = torch.where(act & ~(fits | frozen),
                               work - (e - t) / mult, work)
            t = torch.where(act & ~fits, e, t)
            if bool(pdone.all()):
                break
        return res

    for i in range(n_ops):
        op, r, d, a = kind[i], rank[i], dur[i], aux[i]
        cr = clock[:, r].clone()
        vval = cr
        if op == OP_COMPUTE:
            clock[:, r] = compute_end(r, cr, d)
        elif op == OP_ADVANCE_ABS:
            clock[:, r] = torch.clamp_min(cr, d)
        elif op == OP_ADVANCE_REL:
            clock[:, r] = torch.maximum(cr, cr + d)
        elif op == OP_WAIT_COMM:
            clock[:, r] = torch.maximum(cr, cd[:, r])
        elif op == OP_RECV:
            clock[:, r] = torch.maximum(cr, v[:, a])
        elif op == OP_SEND:
            vval = cr + scaled(i, cr, d)
        elif op == OP_SEND_SYNC:
            start = torch.maximum(cr, clock[:, a])
            vval = start + scaled(i, start, d)
            clock[:, r] = vval
        elif op == OP_COLL:
            start = clock[:, members[i]].amax(dim=1)
            clock[:, members[i]] = (start + scaled(i, start, d))[:, None]
        elif op == OP_ASYNC_FINISH:
            start = torch.maximum(v[:, refs[i]].amax(dim=1), v2[:, a])
            end = start + scaled(i, start, d)
            cd[:, members[i]] = torch.maximum(cd[:, members[i]],
                                              end[:, None])
            v2[:, a] = end
        v[:, i] = vval
    return clock.amax(dim=1)


# --------------------------------------------------------------------------
# The level schedule and the family's tables on the card
# --------------------------------------------------------------------------


def level_schedule(prog: LoweredProgram) -> Tuple[np.ndarray, np.ndarray]:
    """The op table's dependence levels, in one pass over the ops:
    ``(order, offsets)``, ``order`` the ops sorted by level (stable,
    int64 [L]) and level ``l`` the ops ``order[offsets[l]:offsets[l + 1]]``.

    An op's level is one more than the highest level of the earlier ops
    it depends on through a state slot the replay touches, read after
    write, write after read or write after write:

    * ``clock[x]``: read by every op of class x, by a ``send_sync``
      whose peer is x and by the collectives x is in; written by every
      op of class x except sends, async posts and no-ops, and by the
      collectives x is in;
    * ``cd[x]``: read by ``wait_comm``; read and written (a max-update)
      by the async finishes x is in;
    * ``v2[c]``: the async chain, read and written by its finishes;
    * ``v[i]``: written by op i alone; read by the ``recv`` whose
      ``aux`` it is and by the finishes whose ``refs`` hold it.

    So no op of a level touches a slot another op of its level writes,
    the ops of a level may run in any order or at once, and every order
    that keeps the levels gives the lowered order's values.

    Memoised by the table's content (the families of one analysis, one
    per touched-rank partition, share a few tables): the arrays are
    shared and must not be written."""
    key = _schedule_key(prog)
    got = _SCHEDULES.get(key)
    if got is not None:
        _SCHEDULES.move_to_end(key)
        return got
    n, k = prog.n_ops, prog.n_classes
    kind, rank, aux = prog.kind.tolist(), prog.rank.tolist(), prog.aux.tolist()
    grouped = np.flatnonzero((prog.kind == OP_COLL) | (prog.kind == OP_ASYNC_FINISH))
    members = {i: np.flatnonzero(prog.mask[i]).tolist() for i in grouped.tolist()}
    posts = {i: [j for j in prog.refs[i].tolist() if j < n] for i in grouped.tolist()}
    clock_w, clock_r = [0] * k, [0] * k  # level of the last write / read
    cd_w, cd_r = [0] * k, [0] * k
    chain = [0] * prog.n_chains
    level = [0] * n
    for i in range(n):
        op = kind[i]
        if op == OP_COLL:
            lv = 0
            for x in members[i]:
                lv = max(lv, clock_w[x], clock_r[x])
            lv += 1
            for x in members[i]:
                clock_w[x] = clock_r[x] = lv
        elif op == OP_ASYNC_FINISH:
            a = aux[i]
            lv = chain[a]
            for x in members[i]:
                lv = max(lv, cd_w[x], cd_r[x])
            for j in posts[i]:
                lv = max(lv, level[j])
            lv += 1
            chain[a] = lv
            for x in members[i]:
                cd_w[x] = cd_r[x] = lv
        elif op == OP_SEND or op == OP_ASYNC_POST or op == OP_NOOP:
            r = rank[i]  # reads clock[r], writes v[i] alone
            lv = clock_w[r] + 1
            if clock_r[r] < lv:
                clock_r[r] = lv
        else:  # reads and writes clock[r], and reads one more slot
            r = rank[i]
            lv = clock_w[r] if clock_w[r] > clock_r[r] else clock_r[r]
            if op == OP_RECV:
                if level[aux[i]] > lv:
                    lv = level[aux[i]]
            elif op == OP_WAIT_COMM:
                if cd_w[r] > lv:
                    lv = cd_w[r]
                if cd_r[r] <= lv:
                    cd_r[r] = lv + 1
            elif op == OP_SEND_SYNC:
                a = aux[i]
                if clock_w[a] > lv:
                    lv = clock_w[a]
                if clock_r[a] <= lv:
                    clock_r[a] = lv + 1
            lv += 1
            clock_w[r] = clock_r[r] = lv
        level[i] = lv
    lev = np.asarray(level, dtype=np.int64)
    order = np.argsort(lev, kind="stable")
    offsets = np.zeros(int(lev.max(initial=0)) + 1, dtype=np.int64)
    np.cumsum(np.bincount(lev)[1:], out=offsets[1:])
    _SCHEDULES[key] = order, offsets
    if len(_SCHEDULES) > SCHEDULES_KEPT:
        _SCHEDULES.popitem(last=False)
    return order, offsets


#: level schedules of the op tables seen last, by content: the families
#: of one analysis (one per touched-rank partition) share a few tables
_SCHEDULES: "OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
SCHEDULES_KEPT = 64


def compile_cache_info(registry=None) -> Dict[str, int]:
    """Observability hook, the counterpart of the JAX package's XLA
    compile-cache report: the level schedules held (one a distinct op
    table, :func:`level_schedule`) and the LRU's bound
    (:data:`SCHEDULES_KEPT`), set on the ``replay_compile_cache_shapes``
    and ``replay_compile_cache_capacity`` gauges. Collect-on-scrape: the
    gauges mirror module state, so callers refresh them by calling this
    (the server does it per ``/metrics`` scrape)."""
    from simumax_tpu_torch.observe.telemetry import get_registry

    reg = registry if registry is not None else get_registry()
    reg.gauge("replay_compile_cache_shapes").set(len(_SCHEDULES))
    reg.gauge("replay_compile_cache_capacity").set(SCHEDULES_KEPT)
    return {"compiled_shapes": len(_SCHEDULES), "capacity": SCHEDULES_KEPT}


def _schedule_key(prog: LoweredProgram) -> bytes:
    """A digest of what the schedule reads: kinds, classes, aux, and the
    members and refs of the collectives and async finishes."""
    grouped = (prog.kind == OP_COLL) | (prog.kind == OP_ASYNC_FINISH)
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray([prog.n_ops, prog.n_classes, prog.n_chains]).tobytes())
    for a in (prog.kind, prog.rank, prog.aux, np.packbits(prog.mask[grouped], axis=1),
              prog.refs[grouped]):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def permute_program(prog: LoweredProgram, order) -> LoweredProgram:
    """``prog`` with its ops in ``order`` (a permutation of the op
    index): op ``j`` of the result is op ``order[j]`` of ``prog``, its
    value slot ``v[j]``, and the ``recv`` ops' ``aux`` and the finishes'
    ``refs`` point at the new slots (padding still at the -inf slot
    ``L``). Replayed in any order that keeps the dependences of
    :func:`level_schedule`, it gives ``prog``'s makespans."""
    n = prog.n_ops
    order = np.asarray(order, dtype=np.int64)
    pos = np.empty(n + 1, dtype=np.int64)
    pos[order] = np.arange(n)
    pos[n] = n
    kind = prog.kind[order]
    aux = prog.aux[order].astype(np.int64)
    recv = kind == OP_RECV
    aux[recv] = pos[aux[recv]]
    return LoweredProgram(
        n_classes=prog.n_classes, reps=prog.reps, kind=kind,
        rank=prog.rank[order], dur=prog.dur[order], aux=aux.astype(np.int32),
        mask=prog.mask[order],
        refs=pos[np.minimum(prog.refs[order], n)].astype(np.int32),
        peer_mask=prog.peer_mask[order], op_dim_id=prog.op_dim_id[order],
        dim_ids=dict(prog.dim_ids), n_chains=prog.n_chains)


#: the most ops one step of the kernel takes: a wider level is replayed in
#: consecutive steps (its ops are independent, so any cut keeps the values)
STEP_CAP = 2048
#: one op of the kernel's table: ``dur``, ``kind | arg << 8`` (``arg`` the
#: class, or for a collective and an async finish its row among the
#: step's group rows) and ``aux``; 16 bytes, as ``struct Op`` in replay.cu
OP_RECORD = np.dtype([("dur", "<f8"), ("kr", "<i4"), ("aux", "<i4")])


@dataclass
class ReplayTables:
    """A family's op table in level order, on one device, built once
    (:func:`replay_tables`) and read by every replay of the family: what
    ``replay_levels_kernel`` (``csrc/replay.cu``) takes besides the
    scenarios' arrays. Table slot ``j`` holds op ``order[j]`` of the
    lowered program, and ``v`` is indexed by the slots: the ``recv``
    ops' ``aux`` and the finishes' refs point at slots
    (:func:`permute_program`).

    The table is cut into steps, one a level, a level wider than
    ``STEP_CAP`` ops into several; within a step the collectives come
    first (a warp each), then the other ops (a thread each) by kind."""

    n_ops: int
    n_classes: int
    n_chains: int
    n_levels: int     # levels of the schedule
    n_steps: int      # steps of the kernel
    max_width: int    # ops in the widest step
    max_groups: int   # collectives and async finishes in one step, at most
    threads: int      # the kernel's block: a thread for each op of a step, <= 1024
    words: int        # mask words of a group row: ceil(K / 32)
    group: int        # refs of a group row (G)
    row: int          # int32s in a group row: words + G, padded to 16 bytes
    source: LoweredProgram  # the lowered program (host)
    order: np.ndarray       # table slot -> op of the lowered program
    dims: np.ndarray        # int32 [L]: the slots' comm dims (-1: not a comm op)
    ops: Any      # uint8 [16 L]: OP_RECORD a slot
    steps: Any    # int32 [n_steps + 1, 4]: (first slot, collectives, first group row, 0)
    groups: Any   # int32 [max(rows, 1), row]: member mask words, then refs
    scope_peers: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (slots, classes)

    @property
    def app_stride(self) -> int:
        """Link words a scenario: L rounded up to even (16-byte rows)."""
        return self.n_ops + (self.n_ops & 1)

    def peers(self) -> Tuple[np.ndarray, np.ndarray]:
        """The comm-scope peers, as (slot, class) pairs."""
        if self.scope_peers is None:
            ops, classes = np.nonzero(self.source.peer_mask)
            pos = np.empty(self.n_ops, dtype=np.int64)
            pos[self.order] = np.arange(self.n_ops)
            self.scope_peers = pos[ops], classes
        return self.scope_peers


def build_tables(prog: LoweredProgram, device="cuda") -> ReplayTables:
    """``prog``'s :class:`ReplayTables` on ``device`` (no memo: see
    :func:`replay_tables`)."""
    import torch

    n, k = prog.n_ops, prog.n_classes
    order0, offsets = level_schedule(prog)
    level = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    # in each level the collectives first, then the other ops by kind (stable),
    # so a warp's ops mostly take one branch; then each level cut at STEP_CAP
    kind0 = prog.kind[order0]
    order = order0[np.lexsort((np.where(kind0 == OP_COLL, -1, kind0), level))]
    starts = [s for lo, hi in zip(offsets[:-1].tolist(), offsets[1:].tolist())
              for s in range(lo, hi, STEP_CAP)]
    pos = np.empty(n + 1, dtype=np.int64)
    pos[order] = np.arange(n)
    pos[n] = n
    kind = prog.kind[order]
    coll = kind == OP_COLL
    grouped = coll | (kind == OP_ASYNC_FINISH)
    first_row = np.concatenate([[0], np.cumsum(grouped)])
    bounds = np.asarray(starts + [n], dtype=np.int64)
    width = np.diff(bounds)
    n_coll = (np.add.reduceat(coll.astype(np.int64), starts) if n
              else np.zeros(0, dtype=np.int64))
    steps = np.zeros((len(starts) + 1, 4), dtype=np.int32)
    steps[:, 0] = n
    steps[:, 2] = first_row[n]
    steps[: len(starts), 0] = starts
    steps[: len(starts), 1] = n_coll
    steps[: len(starts), 2] = first_row[starts]

    step_of = np.repeat(np.arange(len(starts)), width)
    arg = np.where(grouped, first_row[:n] - first_row[bounds[step_of]], prog.rank[order])
    if n and (arg.max() >= 1 << 23 or kind.max() > 0xFF):
        raise ValueError("replay tables: a class or group row does not fit the op record")
    aux = prog.aux[order].astype(np.int64)
    recv = kind == OP_RECV
    aux[recv] = pos[aux[recv]]
    rec = np.zeros(n, dtype=OP_RECORD)
    rec["dur"] = prog.dur[order]
    rec["kr"] = kind | (arg.astype(np.int32) << 8)
    rec["aux"] = aux
    words = (k + 31) // 32
    group = prog.refs.shape[1]
    row = 4 * ((words + group + 3) // 4)
    rows = order[grouped]
    groups = np.zeros((max(len(rows), 1), row), dtype=np.int32)
    groups[: len(rows), :words] = _mask_words(prog.mask[rows]).view(np.int32)
    groups[: len(rows), words:words + group] = pos[np.minimum(prog.refs[rows], n)]
    narrow = width - n_coll

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return ReplayTables(
        n_ops=n, n_classes=k, n_chains=prog.n_chains, n_levels=len(offsets) - 1,
        n_steps=len(starts), max_width=int(width.max(initial=0)),
        max_groups=int(np.diff(first_row[bounds]).max(initial=0)),
        threads=min(1024, max(32, -(-int(narrow.max(initial=0)) // 32) * 32)),
        words=words, group=group, row=row, source=prog, order=order,
        dims=prog.op_dim_id[order], ops=dev(rec.view(np.uint8)), steps=dev(steps),
        groups=dev(groups))


def replay_tables(prog: LoweredProgram, device="cuda") -> ReplayTables:
    """``prog``'s :class:`ReplayTables` on ``device``, built at its first
    replay there and kept with the program (which the replay context
    memoises per family, ``ReplayContext._lowered``)."""
    import torch

    key = str(torch.device(device))
    got = prog.tables.get(key)
    if got is None:
        got = prog.tables[key] = build_tables(prog, device)
    return got


@dataclass
class ScenarioTensors:
    """A batch of scenarios' fault arrays for one family's
    :class:`ReplayTables`, as :class:`ReplayBatch` holds them but with
    the link bits in table order, each row ``app_stride`` words long.
    :func:`pack_scenarios` writes them into one host buffer (pinned for
    the card), :meth:`to` copies that buffer in one transfer and
    returns views of the copy."""

    batch: int
    w: int
    e: int
    buffer: Any    # uint8: every array below, each at a 16-byte offset
    layout: Tuple[Tuple[str, Any, Tuple[int, ...], int], ...]
    win_s: Any     # float64 [B, K, W]
    win_e: Any
    win_m: Any
    edges: Any     # float64 [B, K, 2W]
    link_s: Any    # float64 [B, E]
    link_e: Any
    link_m: Any
    app_bits: Any  # int64 [B, app_stride], table order
    has_slow: Any  # uint8 [B, K]

    def to(self, device) -> "ScenarioTensors":
        return _scenario_views(self.buffer.to(device, non_blocking=True),
                               self.batch, self.w, self.e, self.layout)


def _scenario_views(buf, b, w, e, layout) -> ScenarioTensors:
    views = {name: buf[off:off + math.prod(shape) * dt.itemsize].view(dt).view(shape)
             for name, dt, shape, off in layout}
    return ScenarioTensors(batch=b, w=w, e=e, buffer=buf, layout=layout, **views)


def pack_scenarios(tables: ReplayTables, models: Sequence[Any],
                   pin: bool = False) -> ScenarioTensors:
    """One ``StepFaultModel`` (no deaths) per scenario as the
    :class:`ScenarioTensors` of ``tables``' family, in one host buffer
    (page-locked with ``pin``): the arrays of :func:`prepare_scenario`
    with each op's link windows as the bits of one word."""
    import torch

    k, n = tables.n_classes, tables.n_ops
    reps = tables.source.reps
    b = len(models)
    w = max((len(m._slow.get(rep, ())) for m in models for rep in reps), default=0)
    e = max((len(m._links) for m in models), default=0)
    if e > MAX_LINKS:
        raise ValueError(f"pack_scenarios: {e} link windows in one scenario; "
                         f"the replay takes at most {MAX_LINKS}")
    f64, i64, u8 = (torch.float64, torch.int64, torch.uint8)
    shapes = (("win_s", f64, (b, k, w)), ("win_e", f64, (b, k, w)),
              ("win_m", f64, (b, k, w)), ("edges", f64, (b, k, 2 * w)),
              ("link_s", f64, (b, e)), ("link_e", f64, (b, e)),
              ("link_m", f64, (b, e)), ("app_bits", i64, (b, tables.app_stride)),
              ("has_slow", u8, (b, k)))
    layout, off = [], 0
    for name, dt, shape in shapes:
        layout.append((name, dt, shape, off))
        off += -(-math.prod(shape) * dt.itemsize // 16) * 16
    buf = torch.empty(max(off, 16), dtype=torch.uint8, pin_memory=pin)
    host = _scenario_views(buf, b, w, e, tuple(layout))
    a = {name: getattr(host, name).numpy() for name, *_ in shapes}
    for name in ("win_s", "win_e", "edges", "link_s", "link_e"):
        a[name].fill(math.inf)
    a["win_m"].fill(1.0)
    a["link_m"].fill(1.0)
    a["app_bits"].fill(0)
    a["has_slow"].fill(0)
    dims = tables.dims
    dim_ids = tables.source.dim_ids
    applies: Dict[tuple, np.ndarray] = {}  # (dim, scope) -> the ops a window applies to
    app = a["app_bits"].view(np.uint64)
    for s, m in enumerate(models):
        for c, rep in enumerate(reps):
            wins = m._slow.get(rep)
            if not wins:
                continue
            a["has_slow"][s, c] = 1
            for j, (ws, we, wm) in enumerate(wins):
                a["win_s"][s, c, j] = ws
                a["win_e"][s, c, j] = we
                a["win_m"][s, c, j] = wm
            eds = sorted({x for win in wins for x in win[:2] if math.isfinite(x)})
            a["edges"][s, c, : len(eds)] = eds
        for j, (d, ls, le, mult, scope) in enumerate(m._links):
            a["link_s"][s, j] = ls
            a["link_e"][s, j] = le
            a["link_m"][s, j] = mult
            key = (d, None if scope is None else tuple(sorted(scope)))
            ok = applies.get(key)
            if ok is None:
                ok = dims >= 0 if d == "*" else dims == dim_ids.get(d, -2)
                if scope is not None:
                    slots, classes = tables.peers()
                    in_scope = np.fromiter((r in scope for r in reps), dtype=bool, count=k)
                    touched = np.zeros(n, dtype=bool)
                    touched[slots[in_scope[classes]]] = True
                    ok = ok & touched
                ok = applies[key] = ok.astype(np.uint64)
            app[s, :n] |= ok << np.uint64(j)
    return host


def table_batch(tables: ReplayTables, scen: ScenarioTensors) -> ReplayBatch:
    """The :class:`ReplayBatch` of a family's tables and a batch of
    scenarios, in table order, on the scenarios' device: what the plain
    version takes."""
    import torch

    dev = scen.win_s.device
    t = permute_program(tables.source, tables.order)

    def d(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)

    i32 = torch.int32
    return ReplayBatch(
        n_ops=t.n_ops, n_classes=t.n_classes, n_chains=t.n_chains,
        kind=d(t.kind, i32), rank=d(t.rank, i32), dur=d(t.dur, torch.float64),
        aux=d(t.aux, i32), mask=d(_mask_words(t.mask).view(np.int32), i32),
        refs=d(t.refs, i32), win_s=scen.win_s, win_e=scen.win_e, win_m=scen.win_m,
        edges=scen.edges, has_slow=scen.has_slow, link_s=scen.link_s,
        link_e=scen.link_e, link_m=scen.link_m,
        app_bits=scen.app_bits[:, : t.n_ops].contiguous())


def batch_program(rb: ReplayBatch) -> LoweredProgram:
    """The op table of a :class:`ReplayBatch` as a
    :class:`LoweredProgram` on the host (its link bits are the batch's
    own: no comm dims or scopes)."""
    n, k = rb.n_ops, rb.n_classes
    words = rb.mask.cpu().numpy().view(np.uint8).reshape(n, -1)
    return LoweredProgram(
        n_classes=k, reps=tuple(range(k)), kind=rb.kind.cpu().numpy(),
        rank=rb.rank.cpu().numpy(), dur=rb.dur.cpu().numpy(), aux=rb.aux.cpu().numpy(),
        mask=np.unpackbits(words, axis=1, count=k, bitorder="little").astype(bool),
        refs=rb.refs.cpu().numpy(), peer_mask=np.zeros((n, k), dtype=bool),
        op_dim_id=np.full(n, -1, dtype=np.int32), dim_ids={}, n_chains=rb.n_chains)


def check_backend(backend: str, device: str) -> None:
    """Refuse a replay backend the machine cannot run: ``"cuda"`` and
    ``"auto"`` launch the kernel on the card unless ``device="cpu"``
    asks for its plain version; nothing falls back."""
    if backend not in ("numpy", "cuda", "auto"):
        raise ValueError(f"replay_backend must be 'numpy', 'cuda' or "
                         f"'auto', got {backend!r}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"ReplayOptions.device must be 'cuda' or 'cpu', "
                         f"got {device!r}")
    if backend == "numpy" or device == "cpu":
        return
    import torch

    from simumax_tpu_torch.core.errors import CardRequiredError

    # NVML's count: unlike cudaGetDeviceCount it leaves CUDA
    # uninitialised, so the analysis's pool can still fork workers that
    # replay
    if torch.cuda.device_count() < 1:
        raise CardRequiredError(
            f"replay_backend={backend!r} replays miss batches with the "
            f"CUDA kernel and this machine has no card: pass "
            f"ReplayOptions(device=\"cpu\") for its plain PyTorch "
            f"version, or replay_backend=\"numpy\" for the scalar engine")


def solve_batch(prog: LoweredProgram, models: Sequence[Any],
                device: str = "cuda") -> np.ndarray:
    """Replay ``prog`` under each scenario's fault model; returns the
    raw (pre-straggle) makespans, bit-identical to ``SimuEngine.run()``
    on the same streams. On the card, one launch of the CUDA kernel for
    the whole batch over the family's tables, which stay on the card
    (:func:`replay_tables`): the call copies the scenarios' arrays over
    in one transfer from page-locked memory and the makespans back in
    one. ``device="cpu"`` runs the plain version over a
    :class:`ReplayBatch` in the lowered order.

    Caller contract: every model has no deaths (``deaths`` fall back
    scalar)."""
    from simumax_tpu_torch.torchref import kernels

    if str(device) == "cpu":
        return kernels.replay_solve(pack_batch(prog, models, "cpu")).numpy()
    tables = replay_tables(prog, device)
    scen = pack_scenarios(tables, models, pin=True).to(device)
    return kernels.replay_levels(tables, scen).cpu().numpy()


__all__ = [
    "FALLBACK_REASONS",
    "FALLBACK_REQUEST_KINDS",
    "JIT_BATCH_MIN",
    "LOWERED_REQUEST_KINDS",
    "LoweredProgram",
    "LoweringError",
    "ReplayBatch",
    "ReplayTables",
    "ScenarioArrays",
    "ScenarioTensors",
    "batch_program",
    "build_tables",
    "check_backend",
    "level_schedule",
    "lower_family",
    "pack_batch",
    "pack_scenarios",
    "permute_program",
    "prepare_scenario",
    "replay_solve_plain",
    "replay_tables",
    "solve_batch",
    "table_batch",
]

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
  launch of the CUDA kernel ``replay_solve_kernel``
  (``csrc/replay.cu``, wrapped by ``torchref.kernels.replay_solve``),
  on the CPU as its plain PyTorch version :func:`replay_solve_plain`.

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
no result). ``jax_unavailable`` and the compile cache have no
counterpart.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
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
    words = (k + 31) // 32
    bits = np.zeros((n_ops, words), dtype=np.uint32)
    for c in range(k):
        bits[:, c // 32] |= prog.mask[:, c].astype(np.uint32) << np.uint32(c % 32)
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
    """Plain PyTorch version of ``replay_solve_kernel``: the raw
    makespans (float64 [B]) of the op table under each scenario.

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

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"replay_backend={backend!r} replays miss batches with the "
            f"CUDA kernel and this machine has no card: pass "
            f"ReplayOptions(device=\"cpu\") for its plain PyTorch "
            f"version, or replay_backend=\"numpy\" for the scalar engine")


def solve_batch(prog: LoweredProgram, models: Sequence[Any],
                device: str = "cuda") -> np.ndarray:
    """Replay ``prog`` under each scenario's fault model; returns the
    raw (pre-straggle) makespans, bit-identical to ``SimuEngine.run()``
    on the same streams. On the card, one launch of the CUDA kernel for
    the whole batch; ``device="cpu"`` runs its plain version.

    Caller contract: every model has no deaths (``deaths`` fall back
    scalar)."""
    from simumax_tpu_torch.torchref.kernels import replay_solve

    out = replay_solve(pack_batch(prog, models, device))
    return out.cpu().numpy()


__all__ = [
    "FALLBACK_REASONS",
    "FALLBACK_REQUEST_KINDS",
    "JIT_BATCH_MIN",
    "LOWERED_REQUEST_KINDS",
    "LoweredProgram",
    "LoweringError",
    "ReplayBatch",
    "ScenarioArrays",
    "check_backend",
    "lower_family",
    "pack_batch",
    "prepare_scenario",
    "replay_solve_plain",
    "solve_batch",
]

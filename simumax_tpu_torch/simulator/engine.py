"""Discrete-event virtual-time engine (L5).

Reference: ``simumax/core/base_struct.py:1225-2004`` (``BarrierBackend``,
``P2PBackend``, ``SimuThread`` lanes, ``SimuSystem.simu`` heap loop,
``SimuContext`` comm state).

Redesign: the reference drives real OS threads with rendezvous locks;
here each simulated rank is a *generator coroutine* yielding typed
requests to a deterministic scheduler — no real concurrency, perfectly
reproducible, and the engine's invariants (queue ordering, deadlock
detection with a full state dump) are kept as hard errors.

Scheduling: a ready heap keyed ``(clock, rank)`` plus wake indexes.
Each runnable rank sits in the heap; serving pops the lowest-clock rank
(ties broken by rank id — the explicit determinism contract). A rank
whose request cannot complete registers the *wake keys* it awaits
(collective rendezvous, send/recv tag, async stream join) and leaves
the heap; publishing a key re-queues exactly the ranks waiting on it.
Serving is O(log R) per event instead of the previous
sort-everything-and-rescan-all-blocked O(R log R) per pass, which is
what makes pod-size world-rank runs (1024+ ranks) tractable.
Event-driven ML-system simulators (ASTRA-sim) use the same indexed
wakeup structure. Deadlock == the heap drains while ranks remain
blocked; the dump names every blocked rank and the keys it awaits.

Request vocabulary (yielded by rank coroutines):

* ``("compute", duration, name, lane)`` — advance this rank's lane clock
* ``("collective", key, duration, name, peers)`` — rendezvous of
  ``peers``; completes at ``max(arrival) + duration`` for everyone
* ``("send", dst, tag, duration, name, lane)`` — non-blocking post
  (async isend semantics: sender's clock does not advance)
* ``("send_sync", dst, tag, duration, name, lane)`` — blocking
  rendezvous send: waits until the matching recv is posted, then both
  sides complete at ``max(send_post, recv_post) + duration`` (used for
  unpaired warmup/cooldown sends in blocking pipelines, where the peer
  is in a recv-only phase — Megatron ``batch_isend_irecv`` semantics)
* ``("recv", src, tag, name, lane)`` — blocks until the matching send's
  data has arrived (``send_post_time + duration``)
* ``("sendrecv", dst, stag, sdur, src, rtag, name, lane)`` — one
  batched ``isend/irecv`` pair (Megatron ``batch_isend_irecv``): the
  send is PUBLISHED on the first service attempt (so rings of mutual
  sendrecvs cannot deadlock), then the rank blocks until (a) the
  inbound matching send has arrived and (b) the peer has posted the
  recv matching our send; completes at the max of both transfer ends.
  ``dst=None`` degrades to a plain blocking recv, ``src=None`` to a
  blocking rendezvous send (same semantics as ``send_sync``)
* ``("advance", t)`` — jump lane clock to at least t
* ``("trace", duration, name, lane)`` — zero-advance visibility span
  (overlapped comm shown in the trace without consuming rank time)
* ``("async_collective", stream, duration, name, peers)`` — post a
  rendezvous on a *comm stream* and continue immediately (NCCL-on-a-
  side-stream semantics): the op starts when every peer has posted and
  the stream's previous op finished, runs ``duration``, and records its
  completion in each peer's ``comm_done`` without advancing main clocks
* ``("wait_comm",)`` — block until every async collective this rank
  posted has completed, then advance the main clock to the latest
  completion (stream join)

Memory: trace records are slotted objects with interned name/lane/kind
strings, and an ``event_sink`` callable (see
:class:`simumax_tpu_torch.simulator.trace.StreamingTraceWriter`) replaces the
in-memory event list entirely so peak RSS no longer scales with total
event count. Completed rendezvous and consumed p2p bookkeeping are
deleted eagerly for the same reason.

Incremental replay (the ISSUE-14 fault-replay engine,
``simulator/faults.py``) adds three capabilities, all inert on the
default path:

* ``drop_events=True`` keeps the per-rank event *counters* but never
  constructs :class:`TraceEvent` objects — a replayed fault step only
  needs the makespan and the death log;
* :class:`RecordingProc` / :class:`ReplayProc` capture a rank
  coroutine's request stream once and replay it without re-running the
  schedule walk. ``advance`` targets are the one clock-derived request
  payload (``StageProcess`` computes ``clock + p2p_time``), so they are
  delta-encoded against the engine's last sent value and re-based at
  replay time — a recorded stream stays exact under a different fault
  timeline;
* :meth:`SimuEngine.run_incremental` with ``pause_at=T`` stops just
  before any service whose *timing decision* could observe fault state
  at or after ``T`` (a heap pop at clock >= T, a compute span crossing
  T, an async-stream op starting at or after T). Every service the
  paused prefix performed is therefore bit-identical under any fault
  model whose first onset is >= T, which makes the paused state a
  reusable fork point: :meth:`SimuEngine.fork` clones it (replay procs
  are plain index cursors), the caller attaches the scenario's fault
  model and resumes only the suffix.

Copy of the JAX package's ``simulator/engine.py`` with its import paths
changed.
"""

from __future__ import annotations

import sys
import time as _time
from dataclasses import dataclass, field
from heapq import heappop, heappush
from typing import Callable, Dict, Generator, List, Optional, Tuple

from simumax_tpu_torch.core.errors import SimulationError


class TraceEvent:
    """One simulated span. Slotted + interned: world-rank runs emit
    millions of these, and the previous dataclass (``__dict__`` per
    instance, fresh f-string per name) dominated peak RSS."""

    __slots__ = ("rank", "lane", "name", "start", "end", "kind", "flow_id")

    def __init__(self, rank: int, lane: str, name: str, start: float,
                 end: float, kind: str = "compute",
                 flow_id: Optional[int] = None):
        self.rank = rank
        self.lane = sys.intern(lane)
        self.name = sys.intern(name)
        self.start = start
        self.end = end
        self.kind = sys.intern(kind)
        self.flow_id = flow_id

    def __repr__(self):  # keep the old dataclass debugging ergonomics
        return (
            f"TraceEvent(rank={self.rank}, lane={self.lane!r}, "
            f"name={self.name!r}, start={self.start}, end={self.end}, "
            f"kind={self.kind!r}, flow_id={self.flow_id})"
        )

    def __eq__(self, other):
        if not isinstance(other, TraceEvent):
            return NotImplemented
        return all(
            getattr(self, s) == getattr(other, s) for s in self.__slots__
        )


@dataclass
class _Rendezvous:
    peers: frozenset
    arrivals: Dict[int, float] = field(default_factory=dict)
    duration: float = 0.0
    #: completion time, computed once when the last peer arrives
    end: Optional[float] = None
    #: peers that served their completion — the rendezvous record is
    #: deleted when every live peer consumed it (bounded-memory
    #: contract). A SET, not a count: a peer that consumed and *then*
    #: died must not be double-counted against the live quota, or the
    #: record is deleted while a live straggler still needs it — the
    #: straggler then re-creates the rendezvous at the same seq and
    #: deadlocks (found by the fleet walk's death-during-optimizer
    #: suspension pattern, pinned in tests/test_fleet.py)
    consumed: "set" = field(default_factory=set)
    #: op name, retained so a deferred completion (a dead peer resolved
    #: by the fault model) can still emit a labelled trace span
    name: str = ""
    #: seconds the fault model added on top of the nominal duration
    #: (link degradation at rendezvous start) — critical-path blame
    fault_extra: float = 0.0

    @property
    def complete(self) -> bool:
        return len(self.arrivals) == len(self.peers)


class DeadlockError(SimulationError):
    """No rank can make progress and no blocked request published new
    state — the schedule itself is wedged. Carries the full per-rank
    state dump in the message and structured context for diagnostics."""


class ReplayProc:
    """A recorded request stream driven as a rank coroutine.

    Duck-types the slice of the generator protocol the engine uses
    (``send``/``close``) and — unlike a real generator — supports
    :meth:`clone`, which is what makes :meth:`SimuEngine.fork`
    possible: the whole coroutine state is an index into a shared,
    immutable stream list.

    ``("advance_rel", delta)`` entries (see :class:`RecordingProc`)
    are re-based against the engine's last sent clock value, exactly
    mirroring how ``StageProcess`` derives its ``advance`` targets from
    the value returned by the preceding ``send`` yield.
    """

    __slots__ = ("stream", "i", "last", "closed")

    def __init__(self, stream):
        self.stream = stream
        self.i = 0
        self.last = None
        self.closed = False

    def send(self, value):
        if value is not None:
            self.last = value
        if self.closed or self.i >= len(self.stream):
            raise StopIteration
        req = self.stream[self.i]
        self.i += 1
        if req[0] == "advance_rel":
            base = self.last if self.last is not None else 0.0
            return ("advance", base + req[1])
        return req

    def close(self):
        self.closed = True

    def clone(self) -> "ReplayProc":
        c = ReplayProc.__new__(ReplayProc)
        c.stream = self.stream  # shared, append-never
        c.i = self.i
        c.last = self.last
        c.closed = self.closed
        return c


class RecordingProc:
    """Wraps a live rank coroutine and records its request stream so
    later replays of the same step program skip the schedule walk
    entirely (:class:`ReplayProc`).

    The recorded stream is fault-independent: ``StageProcess`` yields
    are structural except for ``advance`` targets, which are the value
    returned by the preceding yield plus a fixed offset — those are
    delta-encoded here (``("advance_rel", delta)``) and re-based at
    replay time. ``complete`` is True only when the coroutine ran to
    ``StopIteration``; a stream truncated by a rank death must not be
    cached (it would starve longer-lived replays).
    """

    __slots__ = ("gen", "stream", "complete", "_last")

    def __init__(self, gen):
        self.gen = gen
        self.stream: list = []
        self.complete = False
        self._last = None

    def send(self, value):
        if value is not None:
            self._last = value
        try:
            req = self.gen.send(value)
        except StopIteration:
            self.complete = True
            raise
        if req[0] == "advance" and self._last is not None:
            self.stream.append(("advance_rel", req[1] - self._last))
        else:
            self.stream.append(req)
        return req

    def close(self):
        self.gen.close()


class SimuEngine:
    """Deterministic multi-rank virtual-time executor."""

    def __init__(self, num_ranks: int,
                 event_sink: Optional[Callable[[TraceEvent], None]] = None,
                 fault_model=None, dep_recorder=None,
                 event_delays: Optional[Dict[Tuple[int, int], float]] = None,
                 progress: Optional[Callable[..., None]] = None,
                 progress_every: int = 0,
                 drop_events: bool = False):
        #: optional fault-injection hook (see ``simulator/faults.py::
        #: StepFaultModel``) consulted at event-service time: piecewise
        #: compute-rate multipliers, comm-time multipliers per
        #: collective dim, and rank death times. ``None`` keeps every
        #: code path bit-identical to the fault-free engine.
        self._fault = fault_model
        #: optional event-dependency recorder (see ``observe/critpath.
        #: py::DependencySkeleton``, duck-typed so the engine never
        #: imports the observability layer): purely observational —
        #: recorder-on and recorder-off runs are bit-identical
        self._rec = dep_recorder
        #: {(rank, per-rank emit index): extra seconds} service-time
        #: perturbations — the slack-correctness test hook: delay ONE
        #: recorded event and compare makespans (``None`` = untouched)
        self._delays = event_delays or None
        #: progress heartbeat: ``progress(served=..., events=...,
        #: clock_s=..., blocked_ranks=..., elapsed_s=...)`` every
        #: ``progress_every`` served requests (0 disables; the runner
        #: wires this to the Reporter at debug level)
        self._progress = progress if progress_every > 0 else None
        self._progress_every = progress_every
        self.num_ranks = num_ranks
        self.clock = [0.0] * num_ranks  # per-rank main lane clock
        #: retained trace records (unused when ``event_sink`` streams
        #: them out instead — the bounded-memory path)
        self.events: List[TraceEvent] = []
        self._sink = event_sink
        #: counts-only mode (incremental fault replay): keep the
        #: per-rank event counters but never construct TraceEvents
        self._drop_events = drop_events
        self._primed = False
        self.num_events = 0
        #: per-rank event counts (total / comm-kind) — symmetry-reduced
        #: runs expand these by class weight for full-world accounting
        self.events_by_rank = [0] * num_ranks
        self.comm_events_by_rank = [0] * num_ranks
        self._procs: List[Optional[Generator]] = [None] * num_ranks
        self._pending: List[Optional[tuple]] = [None] * num_ranks
        self._done = [False] * num_ranks
        self._n_done = 0
        #: ready heap of (clock, rank) + membership flags; at most one
        #: live entry per rank
        self._ready: List[Tuple[float, int]] = []
        self._queued = [False] * num_ranks
        #: wake index: key -> ranks blocked on it; inverse per rank
        self._waiters: Dict[tuple, set] = {}
        self._waiting_on: List[tuple] = [()] * num_ranks
        self._collectives: Dict[tuple, _Rendezvous] = {}
        self._coll_seq: Dict[tuple, int] = {}
        self._sends: Dict[tuple, Tuple[float, float]] = {}  # (src,dst,tag) -> (post, dur)
        self._send_seq: Dict[tuple, int] = {}
        self._recv_seq: Dict[tuple, int] = {}
        self._recv_posts: Dict[tuple, float] = {}  # sync-send rendezvous
        #: sendrecv: publish time of the outbound send of an in-flight
        #: batched pair (keyed like _sends; removed on completion)
        self._sr_done: Dict[tuple, float] = {}
        #: effective outbound duration of an in-flight sendrecv, pinned
        #: at publish time — populated only under ``event_delays`` (a
        #: re-serve attempt recomputes the nominal duration and would
        #: otherwise drop the injected perturbation)
        self._sr_dur: Dict[tuple, float] = {}
        self._flow_ids: Dict[tuple, int] = {}
        self._next_flow = 0
        #: async comm-stream state: per-(stream,peers) chained end time,
        #: per-rank latest completion, per-rank outstanding posts
        self._async_chain: Dict[tuple, float] = {}
        self._async_seq: Dict[tuple, int] = {}
        self._async_rv: Dict[tuple, _Rendezvous] = {}
        self.comm_done = [0.0] * num_ranks
        self._async_pending: List[set] = [set() for _ in range(num_ranks)]
        self.mem_hooks: List[Callable[[int, str, float], None]] = []
        #: graceful-degradation state: ranks killed by the fault model,
        #: their death (virtual) times, and the kill log in kill order
        self._dead = [False] * num_ranks
        self._death_at: Dict[int, float] = {}
        self.deaths: List[Tuple[int, float]] = []
        #: per-rank fault fast paths, refreshed at every run entry (the
        #: replay engine swaps fault models between resumes): death
        #: time and whether the rank has any slowdown window — the hot
        #: serve loop indexes these instead of calling into the model
        self._death_t: List[Optional[float]] = [None] * num_ranks
        self._has_slow: List[bool] = [False] * num_ranks

    def add_rank(self, rank: int, proc: Generator):
        self._procs[rank] = proc

    # -- engine loop -------------------------------------------------------
    def run(self) -> float:
        self.run_incremental()
        return max(self.clock) if self.clock else 0.0

    def run_incremental(self, pause_at: Optional[float] = None) -> bool:
        """Run (or resume) the engine loop; returns True when every
        rank finished.

        With ``pause_at=T`` the loop stops (returning False) just
        before any service whose *timing decision* could observe fault
        state at or after virtual time ``T``: a heap pop at clock >= T,
        a compute span that would cross T, an async-stream op whose
        rendezvous would start at or after T, or a drain-time kill
        (deaths are fault state by definition). Everything the paused
        prefix served made decisions strictly before T — compute spans
        fully inside ``[0, T)``, comm durations fixed at starts < T —
        so the paused state is bit-identical under *any* fault model
        whose earliest event starts at or after T, which is what makes
        it a reusable fork point (:meth:`fork`). Resume by calling
        again with a later ``pause_at`` or None."""
        fault = self._fault
        if fault is not None:
            self._death_t = [
                fault.death_time(r) for r in range(self.num_ranks)
            ]
            self._has_slow = [
                fault.has_slow(r) for r in range(self.num_ranks)
            ]
        if not self._primed:
            self._primed = True
            # prime every coroutine to its first request (rank order:
            # every clock is 0.0, so the heap replays this tie-break)
            for r in range(self.num_ranks):
                self._advance_rank(r, None)
        ready = self._ready
        served = 0
        every = self._progress_every if self._progress is not None else 0
        t0 = _time.monotonic() if every else 0.0
        # hot-loop locals + the conditions under which the compute fast
        # path below is bit-identical to _try_serve's compute arm (no
        # recorder/delay/progress hooks to fire, no pending death)
        pending = self._pending
        clock = self.clock
        done = self._done
        queued = self._queued
        procs = self._procs
        events_by_rank = self.events_by_rank
        death_t = self._death_t
        has_slow = self._has_slow
        drop = self._drop_events
        sink = self._sink
        events = self.events
        fast_ok = (self._rec is None and self._delays is None
                   and every == 0)
        while True:
            while ready:
                if pause_at is not None and ready[0][0] >= pause_at:
                    return False
                _, r = heappop(ready)
                queued[r] = False
                if done[r] or pending[r] is None:
                    continue
                if pause_at is not None and self._crosses_pause(
                    r, pause_at
                ):
                    # push back untouched: the resume re-pops it first
                    queued[r] = True
                    heappush(ready, (clock[r], r))
                    return False
                req = pending[r]
                if (fast_ok and req[0] == "compute"
                        and (fault is None or death_t[r] is None)):
                    # inlined compute serve (the dominant request kind
                    # in a replay): same arithmetic, same emission,
                    # same advance as _try_serve — minus the call chain
                    duration = req[1]
                    start = clock[r]
                    if fault is not None and has_slow[r]:
                        end = fault.compute_end(r, start, duration)
                    else:
                        end = start + duration
                    if end > start:
                        self.num_events += 1
                        events_by_rank[r] += 1
                        if not drop:
                            ev = TraceEvent(r, req[3], req[2], start,
                                            end)
                            if sink is not None:
                                sink(ev)
                            else:
                                events.append(ev)
                    clock[r] = end
                    proc = procs[r]
                    try:
                        nreq = proc.send(end)
                    except StopIteration:
                        done[r] = True
                        self._n_done += 1
                        pending[r] = None
                        continue
                    pending[r] = nreq
                    if not queued[r]:
                        queued[r] = True
                        heappush(ready, (end, r))
                    continue
                if not self._try_serve(r):
                    self._block(r)
                elif every:
                    served += 1
                    if served % every == 0:
                        elapsed = _time.monotonic() - t0
                        self._progress(
                            served=served,
                            events=self.num_events,
                            clock_s=max(self.clock) if self.clock else 0.0,
                            blocked_ranks=sum(
                                1 for w in self._waiting_on if w
                            ),
                            elapsed_s=elapsed,
                        )
            if self._n_done >= self.num_ranks:
                return True
            # heap drained with live ranks left: nothing can wake them —
            # unless a blocked rank is scheduled to die, in which case
            # the death resolves its partners' waits (graceful
            # degradation via the fault model, not a deadlock). Kill
            # only the EARLIEST death per drain pass: resolving it may
            # unblock later-doomed ranks, which then live to finish
            # the step instead of being spuriously killed at their own
            # (possibly far-future) death time.
            doomed = []
            if self._fault is not None:
                doomed = [
                    (self._fault.death_time(r), r)
                    for r in range(self.num_ranks)
                    if not self._done[r]
                    and self._fault.death_time(r) is not None
                ]
            if not doomed:
                self._deadlock_dump()
            if pause_at is not None:
                # deaths are never earlier than the scenario onset, so
                # the kill belongs to the suffix — pause before it
                return False
            dt, r = min(doomed)
            self.clock[r] = max(self.clock[r], dt)
            self._kill(r)

    def _crosses_pause(self, rank: int, pause_at: float) -> bool:
        """Whether serving ``rank``'s pending request now could commit
        a timing decision at or after ``pause_at``. Pops are already
        gated at clock < pause_at; the residual cases are a compute
        span crossing the pause time (its duration integrates fault
        windows inside the span) and an async-stream rendezvous this
        post would complete with a start at or after the pause (its
        comm scale is sampled at that start)."""
        req = self._pending[rank]
        kind = req[0]
        if kind == "compute":
            return self.clock[rank] + req[1] > pause_at
        if kind == "async_collective":
            _, stream, _duration, _name, peers = req
            seq = self._async_seq.get((stream, rank), 0)
            pset = frozenset(peers)
            rv = self._async_rv.get((stream, pset, seq))
            arrivals = rv.arrivals if rv is not None else {}
            missing = len(pset) - len(arrivals) - (
                0 if rank in arrivals else 1
            )
            if missing == 0:  # this post completes the rendezvous
                start = max(
                    max(arrivals.values(), default=0.0),
                    self.clock[rank],
                    self._async_chain.get((stream, pset), 0.0),
                )
                return start >= pause_at
        return False

    def fork(self) -> "SimuEngine":
        """Clone the engine's full scheduling state. Only valid when
        every rank coroutine is cloneable (:class:`ReplayProc`) — live
        generators cannot be copied, which is exactly why the
        incremental fault replay records request streams first."""
        for p in self._procs:
            if p is not None and not hasattr(p, "clone"):
                raise SimulationError(
                    "engine.fork() needs cloneable rank procs "
                    "(ReplayProc); live generators cannot be forked",
                    phase="simulate",
                )

        def rv_copy(rv: _Rendezvous) -> _Rendezvous:
            return _Rendezvous(
                peers=rv.peers, arrivals=dict(rv.arrivals),
                duration=rv.duration, end=rv.end,
                consumed=set(rv.consumed),
                name=rv.name, fault_extra=rv.fault_extra,
            )

        new = SimuEngine.__new__(SimuEngine)
        new._fault = self._fault
        new._rec = None
        new._delays = None
        new._progress = None
        new._progress_every = 0
        new.num_ranks = self.num_ranks
        new.clock = list(self.clock)
        new.events = []
        new._sink = self._sink
        new._drop_events = self._drop_events
        new._primed = self._primed
        new.num_events = self.num_events
        new.events_by_rank = list(self.events_by_rank)
        new.comm_events_by_rank = list(self.comm_events_by_rank)
        new._procs = [
            p.clone() if p is not None else None for p in self._procs
        ]
        new._pending = list(self._pending)
        new._done = list(self._done)
        new._n_done = self._n_done
        new._ready = list(self._ready)
        new._queued = list(self._queued)
        new._waiters = {k: set(v) for k, v in self._waiters.items()}
        new._waiting_on = list(self._waiting_on)
        new._collectives = {
            k: rv_copy(v) for k, v in self._collectives.items()
        }
        new._coll_seq = dict(self._coll_seq)
        new._sends = dict(self._sends)
        new._send_seq = dict(self._send_seq)
        new._recv_seq = dict(self._recv_seq)
        new._recv_posts = dict(self._recv_posts)
        new._sr_done = dict(self._sr_done)
        new._sr_dur = dict(self._sr_dur)
        new._flow_ids = dict(self._flow_ids)
        new._next_flow = self._next_flow
        new._async_chain = dict(self._async_chain)
        new._async_seq = dict(self._async_seq)
        new._async_rv = {k: rv_copy(v) for k, v in self._async_rv.items()}
        new.comm_done = list(self.comm_done)
        new._async_pending = [set(s) for s in self._async_pending]
        new.mem_hooks = []
        new._dead = list(self._dead)
        new._death_at = dict(self._death_at)
        new.deaths = list(self.deaths)
        new._death_t = list(self._death_t)
        new._has_slow = list(self._has_slow)
        return new

    # -- scheduler plumbing ------------------------------------------------
    def _enqueue(self, rank: int):
        if not self._queued[rank]:
            self._queued[rank] = True
            heappush(self._ready, (self.clock[rank], rank))

    def _wake(self, rank: int):
        """Re-queue a blocked rank and drop its remaining wake
        registrations (it will re-register if it blocks again)."""
        for k in self._waiting_on[rank]:
            ws = self._waiters.get(k)
            if ws is not None:
                ws.discard(rank)
                if not ws:
                    del self._waiters[k]
        self._waiting_on[rank] = ()
        if not self._done[rank] and self._pending[rank] is not None:
            self._enqueue(rank)

    def _publish(self, key: tuple):
        """New shared state under ``key``: wake exactly the ranks
        blocked on it (the indexed replacement for the old
        rescan-every-blocked-rank ``_state_version`` pass)."""
        ws = self._waiters.get(key)
        if ws:
            for r in sorted(ws):
                self._wake(r)

    def _block(self, rank: int):
        keys = self._wait_keys(rank)
        if not keys:  # pragma: no cover - defensive: unwakeable block
            raise SimulationError(
                f"rank {rank} blocked on {self._pending[rank]!r} with no "
                f"wake key — scheduler bug",
                phase="simulate", rank=rank,
            )
        self._waiting_on[rank] = keys
        for k in keys:
            self._waiters.setdefault(k, set()).add(rank)

    def _wait_keys(self, rank: int) -> tuple:
        """The wake keys a blocked request awaits, derived from the same
        state its failed service attempt just observed (and mutated —
        first attempts post recv windows / publish sendrecv sends)."""
        req = self._pending[rank]
        kind = req[0]
        if kind == "collective":
            _, key, _duration, _name, peers = req
            seq = self._coll_seq.get((key, rank), 0)
            return (("coll", key, frozenset(peers), seq),)
        if kind == "wait_comm":
            return (("async", rank),)
        if kind == "recv":
            _, src, tag, _name, *_rest = req
            seq = self._recv_seq.get((rank, src, tag), 0)
            return (("send", (src, rank, tag, seq)),)
        if kind == "send_sync":
            _, dst, tag, _duration, _name, *_rest = req
            seq = self._send_seq.get((rank, dst, tag), 0)
            return (("recvpost", (rank, dst, tag, seq)),)
        if kind == "sendrecv":
            _, dst, stag, _sdur, src, rtag, _name, *_rest = req
            if src is not None:
                seq = self._recv_seq.get((rank, src, rtag), 0)
                return (("send", (src, rank, rtag, seq)),)
            # send-only batched call blocked on the peer's recv: wakes
            # when the peer posts the recv window OR consumes the send
            seq = self._send_seq.get((rank, dst, stag), 0)
            out_key = (rank, dst, stag, seq - 1)
            if out_key not in self._sr_done:
                out_key = (rank, dst, stag, seq)
            return (("recvpost", out_key), ("sendpop", out_key))
        raise SimulationError(  # pragma: no cover - served kinds never block
            f"unblockable request {req!r}", phase="simulate", rank=rank
        )

    def _complete_rv(self, pub_key: tuple, rv: _Rendezvous, key):
        """Fix a sync rendezvous' completion time and wake its waiters.
        Dead peers that never arrived contribute their death time as
        the arrival (the survivors resolve via the fault model); the
        duration picks up any active link-degradation multiplier at
        the rendezvous start."""
        dead_times = []
        if self._fault is not None:
            dead_times = [
                self._death_at[p] for p in rv.peers
                if p not in rv.arrivals and self._dead[p]
            ]
        start = max(list(rv.arrivals.values()) + dead_times)
        dur = rv.duration
        if self._fault is not None:
            dur *= self._fault.comm_scale(key, rv.peers, start)
            rv.fault_extra = dur - rv.duration
        rv.end = start + dur
        self._publish(pub_key)

    def _kill(self, rank: int):
        """The fault model killed ``rank`` at its current clock: close
        its coroutine, resolve every rendezvous now waiting only on the
        dead, and wake all blocked ranks so their service attempts
        re-evaluate against the updated death state."""
        t = self.clock[rank]
        self._dead[rank] = True
        self._death_at[rank] = t
        self.deaths.append((rank, t))
        if self._rec is not None:
            self._rec.on_death(rank, t)
        self._emit_ev(rank, "comp", "rank_death", t, t, kind="fault")
        proc = self._procs[rank]
        if proc is not None:
            proc.close()
        if not self._done[rank]:
            self._done[rank] = True
            self._n_done += 1
        self._pending[rank] = None
        for k in self._waiting_on[rank]:
            ws = self._waiters.get(k)
            if ws is not None:
                ws.discard(rank)
                if not ws:
                    del self._waiters[k]
        self._waiting_on[rank] = ()
        # p2p state only the dead rank could ever consume (inbound
        # sends and its posted recv windows): drop it — bounded-memory
        # contract, and senders rendezvousing against the dead rank
        # must abort via the fault model, not complete into a corpse
        for skey in [k for k in self._sends if k[1] == rank]:
            del self._sends[skey]
            self._flow_ids.pop(skey, None)
        for skey in [k for k in self._recv_posts if k[1] == rank]:
            del self._recv_posts[skey]
        # async rendezvous the dead rank never posted to: finish the
        # ones every live peer has posted, drop the ones nobody can
        for ckey, rv in list(self._async_rv.items()):
            if rank not in rv.peers or rank in rv.arrivals:
                continue
            if all(self._dead[p] for p in rv.peers):
                del self._async_rv[ckey]
                continue
            if all(p in rv.arrivals or self._dead[p] for p in rv.peers):
                self._finish_async(ckey, rv, rv.name or "async")
        self._async_pending[rank].clear()
        # wake everyone blocked: collective / p2p dead-peer resolution
        # happens inside their re-served requests
        for r in range(self.num_ranks):
            if self._waiting_on[r]:
                self._wake(r)

    def _emit_ev(self, rank: int, lane: str, name: str, start: float,
                 end: float, kind: str = "compute",
                 flow_id: Optional[int] = None):
        """Counting emit: under ``drop_events`` (incremental fault
        replay) the per-rank counters advance — they drive the
        ``event_delays`` keying and the result accounting — but no
        :class:`TraceEvent` is ever constructed."""
        self.num_events += 1
        self.events_by_rank[rank] += 1
        if kind != "compute":
            self.comm_events_by_rank[rank] += 1
        if self._drop_events:
            return
        ev = TraceEvent(rank, lane, name, start, end, kind, flow_id)
        if self._sink is not None:
            self._sink(ev)
        else:
            self.events.append(ev)

    def _delay(self, rank: int) -> float:
        """Service-time perturbation of the event this rank is about to
        emit (keyed by its per-rank emit index) — the slack-correctness
        test hook. Zero for untouched events and untouched runs."""
        if self._delays is None:
            return 0.0
        return self._delays.get((rank, self.events_by_rank[rank]), 0.0)

    def _advance_rank(self, rank: int, value):
        proc = self._procs[rank]
        try:
            req = proc.send(value)
        except StopIteration:
            self._done[rank] = True
            self._n_done += 1
            self._pending[rank] = None
            return
        self._pending[rank] = req
        self._enqueue(rank)

    def _try_serve(self, rank: int) -> bool:
        fault = self._fault
        if fault is not None and not self._dead[rank]:
            dt = self._death_t[rank]
            if dt is not None and self.clock[rank] >= dt:
                self._kill(rank)
                return True
        req = self._pending[rank]
        kind = req[0]
        if kind == "compute":
            _, duration, name, lane = req
            start = self.clock[rank]
            if fault is not None:
                end = (fault.compute_end(rank, start, duration)
                       if self._has_slow[rank] else start + duration)
                dt = self._death_t[rank]
                if dt is not None and end > dt:
                    # the rank dies mid-op: emit the truncated span,
                    # then let the kill resolve its partners
                    if dt > start:
                        if self._rec is not None:
                            self._rec.on_compute(rank, name, lane, start,
                                                 dt, 0.0)
                        self._emit_ev(rank, lane, name, start, dt)
                    self.clock[rank] = dt
                    self._kill(rank)
                    return True
            else:
                end = start + duration
            if end > start:
                # fault share of the span (slowdown stretch) for blame
                extra = end - (start + duration)
                if self._delays is not None:
                    end += self._delay(rank)
                if self._rec is not None:
                    self._rec.on_compute(rank, name, lane, start, end,
                                         extra)
                self._emit_ev(rank, lane, name, start, end)
            self.clock[rank] = end
            self._advance_rank(rank, self.clock[rank])
            return True
        if kind == "advance":
            _, t = req
            if self._rec is not None and t > self.clock[rank]:
                self._rec.on_advance(rank, self.clock[rank], t)
            self.clock[rank] = max(self.clock[rank], t)
            self._advance_rank(rank, self.clock[rank])
            return True
        if kind == "trace":
            # zero-advance visibility span (e.g. overlapped async comm)
            _, duration, name, lane = req
            start = self.clock[rank]
            if self._rec is not None:
                self._rec.on_trace(rank, name, start, start + duration)
            self._emit_ev(rank, lane, name, start, start + duration,
                          kind="comm")
            self._advance_rank(rank, start)
            return True
        if kind == "collective":
            _, key, duration, name, peers = req
            seq = self._coll_seq.get((key, rank), 0)
            ckey = (key, frozenset(peers), seq)
            rv = self._collectives.get(ckey)
            if rv is None:
                rv = self._collectives[ckey] = _Rendezvous(
                    peers=ckey[1], duration=duration, name=name
                )
            if rank not in rv.arrivals:
                if rank not in rv.peers:
                    # membership invariant (kept as a hard error): the
                    # len-based completion check below must never let a
                    # malformed peer list complete silently
                    raise SimulationError(
                        f"collective {key}#{seq}: rank {rank} arrived at "
                        f"a rendezvous whose peers {sorted(rv.peers)} do "
                        f"not include it",
                        phase="simulate", rank=rank, collective=str(key),
                    )
                rv.arrivals[rank] = self.clock[rank]
                if self._rec is not None:
                    self._rec.on_coll_arrive(ckey, rank)
                if rv.duration != duration:
                    raise SimulationError(
                        f"collective {key}#{seq}: mismatched durations "
                        f"{rv.duration} vs {duration} from rank {rank}",
                        phase="simulate", rank=rank, collective=str(key),
                    )
                if rv.complete:
                    self._complete_rv(("coll",) + ckey, rv, key)
            if rv.end is None and fault is not None:
                # graceful degradation: with every live peer arrived
                # and the rest dead, the survivors resolve against the
                # fault model (arrival time = the peer's death time)
                # instead of deadlocking on a rendezvous that can
                # never complete
                if all(p in rv.arrivals or self._dead[p]
                       for p in rv.peers):
                    self._complete_rv(("coll",) + ckey, rv, key)
            if rv.end is None:
                return False  # stay blocked until the last peer arrives
            start = self.clock[rank]
            end = rv.end
            if self._delays is not None:
                end += self._delay(rank)
            if self._rec is not None:
                dead = [] if fault is None else [
                    p for p in rv.peers
                    if p not in rv.arrivals and self._dead[p]
                ]
                self._rec.on_coll_serve(ckey, key, rank, name, start, end,
                                        rv.fault_extra, dead)
            self._emit_ev(rank, "comm", name, start, end, kind="comm")
            self.clock[rank] = end
            self._coll_seq[(key, rank)] = seq + 1
            rv.consumed.add(rank)
            done_rv = len(rv.consumed) >= len(rv.peers)
            if not done_rv and fault is not None and self.deaths:
                # every peer either consumed or died: a dead peer that
                # consumed BEFORE dying is already in the set, so a
                # live straggler can never be counted out (deleting
                # early would re-create the rendezvous at this seq and
                # deadlock the straggler)
                done_rv = all(
                    p in rv.consumed or self._dead[p]
                    for p in rv.peers
                )
            if done_rv:
                del self._collectives[ckey]
                if self._rec is not None:
                    self._rec.on_coll_done(ckey)
            self._advance_rank(rank, end)
            return True
        if kind == "async_collective":
            _, stream, duration, name, peers = req
            seq = self._async_seq.get((stream, rank), 0)
            self._async_seq[(stream, rank)] = seq + 1
            pset = frozenset(peers)
            ckey = (stream, pset, seq)
            rv = self._async_rv.get(ckey)
            if rv is None:
                rv = self._async_rv[ckey] = _Rendezvous(
                    peers=pset, duration=duration, name=name
                )
            if rank not in rv.peers:
                raise SimulationError(
                    f"async collective {stream}#{seq}: rank {rank} posted "
                    f"to a rendezvous whose peers {sorted(rv.peers)} do "
                    f"not include it",
                    phase="simulate", rank=rank, stream=str(stream),
                )
            if rv.duration != duration:
                raise SimulationError(
                    f"async collective {stream}#{seq}: mismatched durations "
                    f"{rv.duration} vs {duration} from rank {rank}",
                    phase="simulate", rank=rank, stream=str(stream),
                )
            rv.arrivals[rank] = self.clock[rank]
            if self._rec is not None:
                self._rec.on_async_post(ckey, rank)
            self._async_pending[rank].add(ckey)
            if rv.complete:
                self._finish_async(ckey, rv, name)
            elif fault is not None and all(
                p in rv.arrivals or self._dead[p] for p in rv.peers
            ):
                # the missing posters are dead: the live peers resolve
                # via the fault model instead of waiting forever
                self._finish_async(ckey, rv, name)
            # poster never blocks: continue at the unchanged clock
            self._advance_rank(rank, self.clock[rank])
            return True
        if kind == "wait_comm":
            if self._async_pending[rank]:
                return False  # some posted op is waiting on peers
            new = max(self.clock[rank], self.comm_done[rank])
            if self._rec is not None:
                self._rec.on_wait_comm(rank, self.clock[rank], new)
            self.clock[rank] = new
            self._advance_rank(rank, self.clock[rank])
            return True
        if kind == "send":
            _, dst, tag, duration, name, *rest = req
            lane = rest[0] if rest else "pp_fwd"
            seq = self._send_seq.get((rank, dst, tag), 0)
            self._send_seq[(rank, dst, tag)] = seq + 1
            skey = (rank, dst, tag, seq)
            if skey in self._sends:
                raise SimulationError(
                    f"duplicate send {skey}",
                    phase="simulate", rank=rank, send=str(skey),
                )
            post = self.clock[rank]
            extra = 0.0
            if fault is not None:
                scaled = duration * fault.comm_scale(
                    "pp", (rank, dst), post
                )
                extra = scaled - duration
                duration = scaled
            duration += self._delay(rank)
            self._sends[skey] = (post, duration)
            fid = self._next_flow
            self._next_flow += 1
            self._flow_ids[skey] = fid
            if self._rec is not None:
                self._rec.on_send(skey, rank, name, lane, post,
                                  post + duration, extra,
                                  advance_tail=False, rendezvous=False)
            self._emit_ev(rank, lane, name, post, post + duration,
                          kind="p2p", flow_id=fid)
            self._publish(("send", skey))
            self._advance_rank(rank, post)
            return True
        if kind == "send_sync":
            _, dst, tag, duration, name, *rest = req
            lane = rest[0] if rest else "pp_fwd"
            seq = self._send_seq.get((rank, dst, tag), 0)
            skey = (rank, dst, tag, seq)
            # rendezvous: wait until the peer posts the matching recv
            recv_post = self._recv_posts.get(skey)
            if recv_post is None:
                if fault is not None and self._dead[dst]:
                    # peer died before posting its recv: the sender
                    # resolves via the fault model and aborts the send
                    self._send_seq[(rank, dst, tag)] = seq + 1
                    end = max(self.clock[rank], self._death_at[dst])
                    if end > self.clock[rank]:
                        if self._rec is not None:
                            self._rec.on_fault_span(
                                rank, f"abort_{name}", self.clock[rank],
                                end,
                            )
                        self._emit_ev(rank, lane, f"abort_{name}",
                                      self.clock[rank], end,
                                      kind="fault")
                    self.clock[rank] = end
                    self._advance_rank(rank, end)
                    return True
                return False  # peer not at its recv yet: stay blocked
            self._send_seq[(rank, dst, tag)] = seq + 1
            start = max(self.clock[rank], recv_post)
            extra = 0.0
            if fault is not None:
                scaled = duration * fault.comm_scale(
                    "pp", (rank, dst), start
                )
                extra = scaled - duration
                duration = scaled
            duration += self._delay(rank)
            end = start + duration
            # publish as a completed transfer for the recv side
            self._sends[skey] = (start, duration)
            fid = self._next_flow
            self._next_flow += 1
            self._flow_ids[skey] = fid
            if self._rec is not None:
                self._rec.on_send(skey, rank, name, lane,
                                  self.clock[rank], end, extra,
                                  advance_tail=True, rendezvous=True)
            self._emit_ev(rank, lane, name, self.clock[rank], end,
                          kind="p2p", flow_id=fid)
            self.clock[rank] = end
            self._publish(("send", skey))
            self._advance_rank(rank, end)
            return True
        if kind == "recv":
            _, src, tag, name, *rest = req
            lane = rest[0] if rest else "pp_fwd"
            seq = self._recv_seq.get((rank, src, tag), 0)
            skey = (src, rank, tag, seq)
            if skey not in self._recv_posts:
                # record when this recv was first posted (sync sends
                # rendezvous against it)
                self._recv_posts[skey] = self.clock[rank]
                if self._rec is not None:
                    self._rec.on_recv_post(skey, rank)
                self._publish(("recvpost", skey))
            if skey not in self._sends:
                if fault is not None and self._dead[src]:
                    # sender died without posting: the receiver learns
                    # of the death via the fault model and aborts
                    self._recv_posts.pop(skey, None)
                    self._recv_seq[(rank, src, tag)] = seq + 1
                    end = max(self.clock[rank], self._death_at[src])
                    if end > self.clock[rank]:
                        if self._rec is not None:
                            self._rec.on_fault_span(
                                rank, f"abort_{name}", self.clock[rank],
                                end,
                            )
                        self._emit_ev(rank, lane, f"abort_{name}",
                                      self.clock[rank], end,
                                      kind="fault")
                    self.clock[rank] = end
                    self._advance_rank(rank, end)
                    return True
                return False  # sender hasn't posted yet
            post, duration = self._sends.pop(skey)
            if skey in self._sr_done:
                # the sender is a blocked send-only sendrecv: preserve
                # the rendezvous time so its completion reflects when
                # this recv actually arrived (not just its publish time)
                self._sr_done[skey] = max(
                    self._sr_done[skey], self._recv_posts.get(skey, post)
                )
            self._recv_posts.pop(skey, None)
            self._recv_seq[(rank, src, tag)] = seq + 1
            arrive = max(self.clock[rank], post + duration)
            emitted = arrive > self.clock[rank]
            if emitted:
                if self._delays is not None:
                    arrive += self._delay(rank)
            if self._rec is not None:
                self._rec.on_recv_serve(skey, rank, name, self.clock[rank],
                                        arrive, emitted)
            if emitted:
                self._emit_ev(rank, lane, f"wait_{name}",
                              self.clock[rank], arrive, kind="wait",
                              flow_id=self._flow_ids.get(skey))
            self._flow_ids.pop(skey, None)
            self.clock[rank] = arrive
            self._publish(("sendpop", skey))
            self._advance_rank(rank, arrive)
            return True
        if kind == "sendrecv":
            _, dst, stag, sdur, src, rtag, name, *rest = req
            lane = rest[0] if rest else "pp_fwd"
            post_t = self.clock[rank]
            sdur0 = sdur
            if fault is not None and dst is not None:
                # a blocked request re-serves at an unchanged clock, so
                # this samples the same multiplier on every attempt
                sdur = sdur * fault.comm_scale("pp", (rank, dst), post_t)
            out_key = None
            if dst is not None:
                # publish the outbound send exactly once per pending
                # request (the request is re-served while blocked)
                seq = self._send_seq.get((rank, dst, stag), 0)
                if (rank, dst, stag, seq - 1) in self._sr_done:
                    out_key = (rank, dst, stag, seq - 1)  # re-serve attempt
                else:
                    out_key = (rank, dst, stag, seq)
                if out_key not in self._sends and out_key not in self._sr_done:
                    self._send_seq[(rank, dst, stag)] = seq + 1
                    extra = sdur - sdur0
                    sdur += self._delay(rank)
                    if self._delays is not None:
                        self._sr_dur[out_key] = sdur
                    self._sends[out_key] = (post_t, sdur)
                    self._sr_done[out_key] = post_t
                    fid = self._next_flow
                    self._next_flow += 1
                    self._flow_ids[out_key] = fid
                    if self._rec is not None:
                        self._rec.on_send(out_key, rank, f"send_{name}",
                                          lane, post_t, post_t + sdur,
                                          extra, advance_tail=False,
                                          rendezvous=False)
                    self._emit_ev(rank, lane, f"send_{name}", post_t,
                                  post_t + sdur, kind="p2p",
                                  flow_id=fid)
                    self._publish(("send", out_key))
                elif self._delays is not None and out_key in self._sr_dur:
                    # re-serve attempt: keep the duration the publish
                    # actually used (incl. any injected perturbation)
                    sdur = self._sr_dur[out_key]
                post_t = self._sr_done[out_key]
            in_key = None
            if src is not None:
                seq = self._recv_seq.get((rank, src, rtag), 0)
                in_key = (src, rank, rtag, seq)
                if in_key not in self._recv_posts:
                    self._recv_posts[in_key] = self.clock[rank]
                    if self._rec is not None:
                        self._rec.on_recv_post(in_key, rank)
                    self._publish(("recvpost", in_key))
                if in_key not in self._sends:
                    if fault is not None and self._dead[src]:
                        # inbound sender died without posting: resolve
                        # both halves of the batched pair via the fault
                        # model (the outbound stays published — a live
                        # peer may still consume it)
                        self._recv_posts.pop(in_key, None)
                        self._recv_seq[(rank, src, rtag)] = seq + 1
                        if out_key is not None:
                            self._sr_done.pop(out_key, None)
                            self._sr_dur.pop(out_key, None)
                        end = max(self.clock[rank], self._death_at[src])
                        if end > self.clock[rank]:
                            if self._rec is not None:
                                self._rec.on_fault_span(
                                    rank, f"abort_{name}",
                                    self.clock[rank], end,
                                )
                            self._emit_ev(rank, lane, f"abort_{name}",
                                          self.clock[rank], end,
                                          kind="fault")
                        self.clock[rank] = end
                        self._advance_rank(rank, end)
                        return True
                    return False  # inbound not posted yet
            if out_key is not None and in_key is None:
                # send-only batched call: true rendezvous — completes
                # only once the peer has posted (or consumed) the
                # matching recv. Paired calls instead complete when the
                # inbound data arrives (the outbound is eager wire
                # time): requiring the peer's recv-post for paired
                # sends would chain op-granular pairs into cycles the
                # real schedule's wider batch_isend_irecv calls (4-way
                # at 1F1B phase boundaries) do not have.
                peer_post = self._recv_posts.get(out_key)
                if peer_post is None and out_key in self._sends:
                    if fault is not None and self._dead[dst]:
                        # peer died before posting the matching recv:
                        # the sender aborts the rendezvous
                        self._sr_done.pop(out_key, None)
                        self._sr_dur.pop(out_key, None)
                        end = max(self.clock[rank], self._death_at[dst])
                        if end > self.clock[rank]:
                            if self._rec is not None:
                                self._rec.on_fault_span(
                                    rank, f"abort_{name}",
                                    self.clock[rank], end,
                                )
                            self._emit_ev(rank, lane, f"abort_{name}",
                                          self.clock[rank], end,
                                          kind="fault")
                        self.clock[rank] = end
                        self._advance_rank(rank, end)
                        return True
                    return False  # peer's recv not posted yet
            end = self.clock[rank]
            if in_key is not None:
                post, duration = self._sends.pop(in_key)
                if in_key in self._sr_done:
                    self._sr_done[in_key] = max(
                        self._sr_done[in_key],
                        self._recv_posts.get(in_key, post),
                    )
                self._recv_posts.pop(in_key, None)
                self._flow_ids.pop(in_key, None)
                self._recv_seq[(rank, src, rtag)] = seq + 1
                self._publish(("sendpop", in_key))
                end = max(end, post + duration)
            if out_key is not None:
                peer_post = self._recv_posts.get(out_key)
                if in_key is None and peer_post is not None:
                    send_end = max(self._sr_done[out_key], peer_post) + sdur
                else:
                    send_end = self._sr_done[out_key] + sdur
                end = max(end, send_end)
                del self._sr_done[out_key]
                self._sr_dur.pop(out_key, None)
            emitted = end > self.clock[rank]
            if emitted:
                end += self._delay(rank)
            if self._rec is not None:
                self._rec.on_sendrecv_serve(
                    rank, f"wait_{name}", self.clock[rank], end,
                    in_key, out_key, emitted,
                )
            if emitted:
                self._emit_ev(rank, lane, f"wait_{name}",
                              self.clock[rank], end, kind="wait")
            self.clock[rank] = end
            self._advance_rank(rank, end)
            return True
        raise SimulationError(
            f"unknown request {req!r}", phase="simulate", rank=rank
        )

    def _finish_async(self, ckey: tuple, rv: _Rendezvous, name: str):
        """All peers posted (or the missing posters are dead): schedule
        the op on its comm stream (starts after the stream's previous
        op and the last arrival — a dead peer's death time counts as
        its arrival) and record completion for every live peer."""
        stream, pset, _seq = ckey
        chain_key = (stream, pset)
        dead_times = []
        if self._fault is not None:
            dead_times = [
                self._death_at[p] for p in pset
                if p not in rv.arrivals and self._dead[p]
            ]
        start = max(
            max(rv.arrivals.values()), self._async_chain.get(chain_key, 0.0),
            *dead_times,
        )
        dur = rv.duration
        extra = 0.0
        if self._fault is not None:
            dur *= self._fault.comm_scale(stream, pset, start)
            extra = dur - rv.duration
        end = start + dur
        self._async_chain[chain_key] = end
        for peer in pset:
            if self._fault is not None and self._dead[peer]:
                self._async_pending[peer].discard(ckey)
                continue
            pend = end + self._delay(peer)
            self.comm_done[peer] = max(self.comm_done[peer], pend)
            self._async_pending[peer].discard(ckey)
            if not self._async_pending[peer]:
                self._publish(("async", peer))
            if self._rec is not None:
                self._rec.on_async_finish_peer(ckey, chain_key, name,
                                               start, pend, peer, extra)
            self._emit_ev(peer, "comm", name, start, pend, kind="comm")
        if self._rec is not None:
            self._rec.on_async_done(ckey)
        del self._async_rv[ckey]

    # -- diagnostics (reference ``base_struct.py:1415-1474``) --------------
    def _deadlock_dump(self, max_ranks: int = 64):
        lines = ["simulator deadlock — per-rank state:"]
        shown = 0
        for r in range(self.num_ranks):
            if self._done[r] and self.num_ranks > max_ranks:
                continue  # pod-size dumps: list only the stuck ranks
            if shown >= max_ranks:
                blocked_left = sum(
                    1 for q in range(r, self.num_ranks) if not self._done[q]
                )
                lines.append(f"  ... and {blocked_left} more blocked ranks")
                break
            state = "done" if self._done[r] else f"blocked on {self._pending[r]!r}"
            lines.append(f"  rank {r} t={self.clock[r]*1e3:.3f}ms: {state}")
            shown += 1
        if self._waiters:
            keys = sorted(self._waiters, key=repr)[:max_ranks]
            lines.append("  blocked wake keys:")
            for k in keys:
                ranks = sorted(self._waiters[k])
                lines.append(f"    {k!r} <- ranks {ranks[:16]}")
        incomplete = {
            k: dict(v.arrivals)
            for k, v in self._collectives.items()
            if not v.complete
        }
        if incomplete:
            lines.append(f"  incomplete collectives: {incomplete}")
        if self._sends:
            lines.append(f"  unmatched sends: {list(self._sends)[:max_ranks]}")
        pending_async = {
            k: dict(v.arrivals) for k, v in self._async_rv.items()
        }
        if pending_async:
            lines.append(f"  incomplete async collectives: {pending_async}")
        raise DeadlockError("\n".join(lines))

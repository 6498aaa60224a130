"""Rank-local allocated-memory timeline for the event simulator.

Reference: ``simumax/core/simu_memory.py`` (``SimuMemoryTracker``: token
lifetimes with strict size checking, Chrome counter events, snapshot
records, and a ``torch.cuda.memory._snapshot()``-compatible pickle for
the memory-viz web tool, ``simu_memory.py:212-556``). Both exports ship
here: a plain JSON snapshot (schema ``simumax_tpu_torch_memory_snapshot_v1``)
for any plotting tool, and :func:`memory_viz_snapshot` producing the
torch memory-viz trace format (load the pickle at pytorch.org/memory_viz
— each simulated token appears as an alloc/free pair whose stack frame
carries the op path, so the "Active Memory Timeline" view shows
per-op attribution over virtual time).

Copy of the JAX package's ``simulator/memory.py`` with its import paths
changed and the snapshot's schema tag naming this package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from simumax_tpu_torch.core.errors import SimulationError


@dataclass(slots=True)
class MemSample:
    """Slotted: world-scale timelines hold one of these per alloc/free
    event, and the per-instance ``__dict__`` was pure overhead."""

    t: float
    bytes: float
    tag: str = ""


class SimuMemoryTracker:
    """Strict token-based alloc/free tracking (reference
    ``simu_memory.py:65-127``): every cache allocation is a token that
    must be freed exactly once with the same size."""

    def __init__(self, rank: int, static_bytes: float = 0.0,
                 record_events: bool = True, source: str = "simulated"):
        self.rank = rank
        self.static_bytes = static_bytes
        #: which predictor produced this timeline: ``"simulated"`` (the
        #: discrete-event engine) or ``"analytical"`` (the schedule
        #: replay exported by ``observe/memledger.py``) — both ship the
        #: same snapshot schema so the two predictions diff directly
        self.source = source
        #: keep the per-event alloc/free trace for the memory-viz
        #: export; runs that will never export (no save_path) disable
        #: it to skip the dead per-event work
        self.record_events = record_events
        self.cur = static_bytes
        self.peak = static_bytes
        self.peak_time = 0.0
        self.timeline: List[MemSample] = [MemSample(0.0, static_bytes, "static")]
        self._tokens: Dict[str, List[float]] = {}
        #: running live-bytes total per token / anon-tag (kept
        #: incrementally so peak capture is not quadratic)
        self._live: Dict[str, float] = {}
        #: live set captured at the recorded peak — the per-token
        #: attribution the reference's memory-viz pickle carries
        #: (``simu_memory.py:212-556``), as plain data. Copied lazily:
        #: while the peak keeps rising only a flag flips; the O(live)
        #: copy happens once, when the plateau ends.
        self.peak_holders: Dict[str, float] = {}
        self._peak_pending = False
        #: per-event trace for the memory-viz export: ("alloc"|"free",
        #: t, nbytes, key, addr). Addresses come from a virtual bump
        #: allocator so the viz tool can pair alloc/free events.
        self.events: List[tuple] = []
        self._next_addr = 1 << 20
        self._addr_fifo: Dict[str, List[tuple]] = {}
        if static_bytes and record_events:
            self.events.append(("alloc", 0.0, static_bytes, "<static>", 0))

    def _flush_peak(self):
        self.peak_holders = {k: v for k, v in self._live.items() if v}
        self._peak_pending = False

    def alloc(self, t: float, nbytes: float, token: Optional[str] = None,
              tag: str = ""):
        if nbytes == 0:
            return
        assert nbytes > 0, f"negative alloc {nbytes}"
        if token is not None:
            self._tokens.setdefault(token, []).append(nbytes)
            key = token
        else:
            key = f"<{tag or 'anon'}>"
        self._live[key] = self._live.get(key, 0.0) + nbytes
        if self.record_events:
            addr = self._next_addr
            self._next_addr += int(nbytes)
            self._addr_fifo.setdefault(key, []).append((addr, nbytes))
            self.events.append(("alloc", t, nbytes, key, addr))
        self.cur += nbytes
        if self.cur > self.peak:
            self.peak = self.cur
            self.peak_time = t
            self._peak_pending = True
        self.timeline.append(MemSample(t, self.cur, tag))

    def free(self, t: float, nbytes: float = 0.0,
             token: Optional[str] = None, tag: str = ""):
        if self._peak_pending:
            self._flush_peak()  # the live set still equals the peak set
        if token is not None:
            fifo = self._tokens.get(token)
            if not fifo:
                raise SimulationError(
                    f"rank {self.rank}: free of unknown token {token!r}"
                )
            expect = fifo.pop(0)
            if nbytes and abs(expect - nbytes) > 1:
                raise SimulationError(
                    f"rank {self.rank}: token {token!r} size mismatch: "
                    f"allocated {expect}, freeing {nbytes}"
                )
            nbytes = expect
            key = token
        else:
            key = f"<{tag or 'anon'}>"
        self._live[key] = max(self._live.get(key, 0.0) - nbytes, 0.0)
        if nbytes == 0:
            return
        if self.record_events:
            fifo = self._addr_fifo.get(key)
            addr = fifo.pop(0)[0] if fifo else 0
            self.events.append(("free", t, nbytes, key, addr))
        self.cur -= nbytes
        if self.cur < self.static_bytes - 1:
            raise SimulationError(
                f"rank {self.rank}: memory underflow at t={t}: "
                f"{self.cur} < static {self.static_bytes}"
            )
        self.timeline.append(MemSample(t, self.cur, tag))

    def outstanding_tokens(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._tokens.items() if v}

    @staticmethod
    def _category(token: str) -> str:
        """Collapse a live token to its op category: drop the
        ``mb<N>:`` microbatch prefix and the ``#<id>`` uniquifier, so
        the same leaf across microbatches aggregates into one row."""
        cat = token.split(":", 1)[-1] if token.startswith("mb") else token
        return cat.split("#", 1)[0]

    def peak_by_category(self, top: int = 0) -> Dict[str, float]:
        """Who holds the memory at the recorded peak, rolled up by op
        category (plus ``<static>``); sorted descending, optionally
        truncated to the ``top`` largest with a ``<rest>`` remainder."""
        if self._peak_pending:
            self._flush_peak()
        cats: Dict[str, float] = {}
        if self.static_bytes:
            cats["<static>"] = self.static_bytes
        for token, nbytes in self.peak_holders.items():
            key = self._category(token)
            cats[key] = cats.get(key, 0.0) + nbytes
        items = sorted(cats.items(), key=lambda kv: -kv[1])
        if top and len(items) > top:
            rest = sum(v for _, v in items[top:])
            items = items[:top] + [("<rest>", rest)]
        return dict(items)

    def summary(self) -> dict:
        return {
            "rank": self.rank,
            "source": self.source,
            "static_bytes": self.static_bytes,
            "peak_bytes": self.peak,
            "peak_gib": self.peak / 2**30,
            "peak_time_ms": self.peak_time * 1e3,
            "end_bytes": self.cur,
            "samples": len(self.timeline),
            "peak_by_category": self.peak_by_category(top=8),
        }

    def snapshot(self) -> dict:
        if self._peak_pending:
            self._flush_peak()
        return {
            "schema": "simumax_tpu_torch_memory_snapshot_v1",
            "rank": self.rank,
            "source": self.source,
            "static_bytes": self.static_bytes,
            "peak_by_category": self.peak_by_category(),
            "peak_holders": dict(
                sorted(self.peak_holders.items(), key=lambda kv: -kv[1])
            ),
            "timeline": [
                {"t_ms": s.t * 1e3, "bytes": s.bytes, "tag": s.tag}
                for s in self.timeline
            ],
        }


def memory_viz_snapshot(tracker: SimuMemoryTracker) -> dict:
    """Convert a tracker's event trace into the
    ``torch.cuda.memory._snapshot()`` structure the PyTorch memory-viz
    web tool loads (reference parity: ``simu_memory.py:212-556``).

    Each simulated allocation becomes an ``alloc`` /``free_completed``
    pair; the op path (token category) is encoded as the top stack
    frame, phase (fwd/bwd/recompute tags come through the token text)
    as ``filename``, so the Active Memory Timeline colors by op.
    Virtual time (seconds) is exported as integer microseconds.
    """
    trace = []
    for action, t, nbytes, key, addr in tracker.events:
        cat = SimuMemoryTracker._category(key)
        trace.append({
            "action": "alloc" if action == "alloc" else "free_completed",
            "addr": int(addr),
            "size": int(nbytes),
            "stream": 0,
            "time_us": int(t * 1e6),
            "frames": [{
                "name": cat,
                "filename": key,
                "line": 0,
            }],
        })
    return {
        "segments": [],
        "device_traces": [trace],
    }


def export_memory_viz(tracker: SimuMemoryTracker, path: str) -> str:
    """Write the memory-viz pickle (open at pytorch.org/memory_viz)."""
    import pickle

    snap = memory_viz_snapshot(tracker)
    with open(path, "wb") as f:
        pickle.dump(snap, f)
    return path

"""Sweep-cell request coalescing (L13): share in-flight *cells*, not
just byte-identical queries.

The planner's single-flight dedups identical concurrent queries; two
*overlapping* sweep grids (``tp=1,2`` vs ``tp=1,2,4``) still evaluated
their shared cells twice when they raced — each missed the store before
the other finished. Per-cell sweep persistence makes every cell
independently content-addressed, which makes the fix natural: a
process-wide :class:`CellFlightTable` keyed by the cell's store key.

The first sweep to want a missing cell **claims** it (leader) and
evaluates it; any concurrent sweep wanting the same cell becomes a
**follower**: it evaluates only its own claimed cells, then waits for
the leaders' published outcomes instead of re-evaluating. A leader
publishes each cell the moment it settles (the same checkpoint that
writes the journal and the store); a leader that dies abandons its
claims in a ``finally`` so followers *never hang* — an abandoned cell
is re-claimed and evaluated by the next waiter.

Outcomes are the same ``{status, row, error}`` records the store
holds, so a coalesced cell is bit-identical to a cached or evaluated
one; coalescing is serving-dependent accounting (``meta`` /
``/stats`` / ``coalesce_cells_total``), never part of the payload.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class CellFlight:
    """One in-flight cell evaluation followers can wait on."""

    __slots__ = ("event", "outcome")

    def __init__(self):
        self.event = threading.Event()
        #: the settled ``{status, row, error}`` record, or None when
        #: the leader abandoned the claim (follower re-evaluates)
        self.outcome: Optional[dict] = None


class CellFlightTable:
    """Thread-safe claim/publish/abandon table of in-flight sweep
    cells, keyed by the cell's content-addressed store key."""

    def __init__(self, registry=None):
        from simumax_tpu_torch.observe.telemetry import get_registry

        self.registry = registry or get_registry()
        self._lock = threading.Lock()
        self._flights: Dict[str, CellFlight] = {}
        self.counters = {"leads": 0, "follows": 0, "abandoned": 0}

    def _count(self, name: str, role: str):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + 1
        self.registry.counter("coalesce_cells_total", role=role).inc()

    def claim(self, key: str):
        """Claim ``key`` for evaluation. Returns ``(flight, leader)``:
        the leader must eventually :meth:`publish` or :meth:`abandon`
        the key; a follower waits on the flight."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                follower = flight
            else:
                follower = None
                flight = CellFlight()
                self._flights[key] = flight
        if follower is not None:
            self._count("follows", "follower")
            return follower, False
        self._count("leads", "leader")
        return flight, True

    def publish(self, key: str, outcome: dict):
        """Leader: settle ``key`` with its outcome and release the
        claim. Called AFTER the store write, so a late arrival that
        missed the flight finds the entry in the store instead."""
        with self._lock:
            flight = self._flights.pop(key, None)
        if flight is not None:
            flight.outcome = outcome
            flight.event.set()

    def abandon(self, key: str):
        """Leader: release an unsettled claim (the sweep died before
        this cell finished). Followers wake with ``outcome=None`` and
        evaluate the cell themselves — a crashed leader must never
        hang its followers."""
        with self._lock:
            flight = self._flights.pop(key, None)
        if flight is None or flight.event.is_set():
            return
        self._count("abandoned", "abandoned")
        flight.outcome = None
        flight.event.set()

    def wait(self, flight: CellFlight,
             timeout: Optional[float] = None) -> Optional[dict]:
        """Follower: block until the leader settles (or abandons) the
        cell; returns the outcome record, or None when the follower
        must evaluate the cell itself."""
        if not flight.event.wait(timeout):
            return None
        return flight.outcome

    def flight(self, key: str) -> Optional[CellFlight]:
        """The in-flight record of ``key``, or None once it settled —
        the lookup behind the fleet's wire-level wait endpoint
        (``service/node.py``): a remote follower that arrives after
        the publish finds no flight and falls back to the owner's
        store, where the publish already landed."""
        with self._lock:
            return self._flights.get(key)

    def inflight(self) -> int:
        with self._lock:
            return len(self._flights)

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, inflight=len(self._flights))

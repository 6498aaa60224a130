"""Fleet node wiring: wire-level cell coalescing + replica pull (L19).

A fleet node is an ordinary ``serve`` process (planner, optional pool,
warmer, admission) plus three fleet attachments, assembled by
:func:`attach_fleet`:

* a :class:`~simumax_tpu_torch.service.router.Router` — requests this node
  does not own forward to the owner with raw-byte pass-through
  (``service/router.py``);
* a :class:`FleetCellFlightTable` — the pool's per-process
  ``CellFlightTable`` generalized over the wire. Every sweep cell's
  content-addressed store key has one ring owner; the first sweep
  anywhere in the fleet to want a missing cell claims it *at the
  owner* (``POST /ring/cells/claim``) and every other node touching
  the same grid follows (``/ring/cells/wait`` long-poll) instead of
  re-evaluating. A leader publishes through the owner
  (``/ring/cells/publish``), which writes the outcome into the
  owner's store shard *before* releasing the flight — so the cell
  lands exactly where every future claim looks first, and the
  fleet's evaluated-cells total equals the union of demanded cells
  (pinned by the fleet tests). Warm jobs ride the
  same table, so a cell warmed on one node is never re-warmed on
  another;
* a :class:`Replicator` — read-only shard replication under the
  single-writer rule: every node writes only its own store; replicas
  *pull* (``/ring/entries`` manifest + ``/ring/entry`` raw bytes),
  keyed by the store's ``(path, mtime, size)`` stamps, installing
  entries whose ring placement names them owner or successor. The
  wire format is the disk format (header + payload, digest
  re-verified on import), so a replicated entry is byte-identical.

Failure semantics are fail-open everywhere: an unreachable owner means
this node leads the cell itself (claim RPC error), a follower of a
dead leader re-evaluates (lease expiry abandons the claim; abandoning
wakes waiters with ``outcome=None``), and a dead owner's requests
retry down the ring successors (``router.py``) — correctness never
depends on another node being alive, only deduplication does.

L20 makes the degradation *detected and reversible* instead of
silent and permanent: a :class:`FailureDetector` heartbeats every
peer over ``/ring/ping`` on a seeded jittered schedule, walks each
peer through ``up -> suspect -> down`` on consecutive probe misses
(``ring_member_state``), and edits the **live** ring — a down peer is
removed (its arcs, an expected 1/N of the keyspace, remap to
successors; ``ring_epoch`` bumps) and a rejoining peer is added back,
triggering a delta re-replication round (the manifest stamps make a
pull round after a rejoin pull only what changed). The router, this
node's authoritative flight table, and the replicator all share the
one live :class:`~simumax_tpu_torch.service.ring.HashRing` object, so an
epoch bump is observed by every placement decision immediately:
in-flight sweeps publish to the *current* owner (fail-open re-claim),
forwards stop trying the corpse, and ``Replicator._wants`` tracks the
new replica sets. At start, :func:`attach_fleet` also runs the
store's crash-recovery sweep (``store.recover()``) so a torn shard is
quarantined before the first request, then re-pulls what quarantine
removed from the replicas.

Copy of the JAX package's ``service/node.py`` with its import paths
changed. A node runs its kernels where its planner does (the planner's
``device``), so it takes no ``device`` of its own. A node is its own
``serve`` process, started as a fresh interpreter, so it builds its own
CUDA context; this package has no command that starts nodes yet (the
JAX package's ``serve --nodes`` comes with the port of ``cli.py``). The
tests the module names are the JAX package's.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
from typing import Callable, Dict, List, Optional, Tuple

from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.observe.telemetry import get_registry
from simumax_tpu_torch.service.coalesce import CellFlightTable
from simumax_tpu_torch.service.ring import (
    DEFAULT_VNODES,
    HashRing,
    format_ring_spec,
    parse_ring_spec,
)
from simumax_tpu_torch.service.router import Router, route_key

#: control-plane RPC budget (claim / publish / abandon / manifest):
#: these are single dict round-trips; a peer that cannot answer in
#: this window is treated as down and the caller fails open
RPC_TIMEOUT_S = 10.0

#: longest one /ring/cells/wait long-poll blocks server-side; the
#: client re-enters the wait until outcome, abandon, or lease expiry
REMOTE_WAIT_S = 60.0

#: total seconds a follower waits on a remotely-claimed cell before
#: giving up and evaluating it itself — strictly longer than the
#: owner-side lease, so lease expiry (not this deadline) is the normal
#: dead-leader exit
REMOTE_WAIT_TOTAL_S = 300.0

#: seconds the owner holds a claim granted to a *remote* leader before
#: abandoning it (waking all followers to self-evaluate) — the no-hang
#: backstop for a leader whose whole process died mid-sweep
REMOTE_LEASE_S = 240.0

#: replicas per key beyond the owner (owner + 1 successor)
REPLICA_COUNT = 1

#: failure-detector defaults: a probe round lands every
#: ``interval * [1.0, 1.5)`` seconds (seeded jitter — rounds never
#: synchronize fleet-wide), a peer is *suspect* after this many
#: consecutive misses and *down* (removed from the live ring) after
#: ``DOWN_AFTER`` — so membership converges on a dead peer within
#: ``DOWN_AFTER`` probe rounds, the documented convergence bound the
#: chaos oracles (and the CI smoke gate) check against
PROBE_INTERVAL_S = 1.0
PROBE_TIMEOUT_S = 2.0
SUSPECT_AFTER = 2
DOWN_AFTER = 4

RING_CLAIM = "/ring/cells/claim"
RING_PUBLISH = "/ring/cells/publish"
RING_ABANDON = "/ring/cells/abandon"
RING_WAIT = "/ring/cells/wait"
RING_ENTRIES = "/ring/entries"
RING_ENTRY = "/ring/entry"
RING_REPLICATE = "/ring/replicate"
RING_STATE = "/ring/state"
RING_PING = "/ring/ping"


def _rpc(members: Dict[str, Tuple[str, int]], node: str, path: str,
         payload: dict, timeout: float) -> Optional[dict]:
    """One JSON round-trip to a peer's ring surface; None on any
    transport or status failure (callers fail open)."""
    host, port = members[node]
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(payload).encode("utf-8")
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            return None
        out = json.loads(data.decode("utf-8"))
        return out if isinstance(out, dict) else None
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        conn.close()


def _rpc_bytes(members: Dict[str, Tuple[str, int]], node: str,
               path: str, payload: dict,
               timeout: float) -> Optional[bytes]:
    """Like :func:`_rpc` but returns the raw response body (the
    replica-pull entry transfer)."""
    host, port = members[node]
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(payload).encode("utf-8")
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return data if resp.status == 200 else None
    except (OSError, http.client.HTTPException):
        return None
    finally:
        conn.close()


class _RemoteFollow:
    """A cell this process locally leads but fleet-follows: the wire
    flight handle ``FleetCellFlightTable.wait`` resolves. Carries the
    local flight so local followers of this process wake with the
    remote outcome too."""

    __slots__ = ("key", "local_flight", "owner", "outcome")

    def __init__(self, key, local_flight, owner, outcome=None):
        self.key = key
        self.local_flight = local_flight
        self.owner = owner
        #: pre-resolved outcome (the owner's store already held the
        #: cell at claim time) — wait() returns it without an RPC
        self.outcome = outcome


class FleetCellFlightTable:
    """The wire-level :class:`CellFlightTable`: same
    claim/publish/abandon/wait contract the sweep path speaks
    (``search/searcher.py``), coordinating through each cell's ring
    owner.

    ``authoritative=True`` (a node's parent planner): cells this node
    owns are claimed on the embedded local table directly — it IS the
    owner-side table remote peers claim against. ``False`` (a pool
    worker): every claim goes over the wire, including to this
    worker's own parent node — which makes the parent table
    coordinate the node's workers with each other as well as with
    the rest of the fleet."""

    def __init__(self, node_id: str,
                 members: Dict[str, Tuple[str, int]],
                 local: Optional[CellFlightTable] = None,
                 registry=None, authoritative: bool = True,
                 vnodes: int = DEFAULT_VNODES,
                 ring: Optional[HashRing] = None):
        self.node_id = node_id
        self.members = dict(members)
        #: a shared ring (the node's live view) observes failure-
        #: detector epoch bumps: claims and publishes follow ownership
        #: as it moves. A private ring (pool workers) stays at the
        #: fork-time membership — fail-open RPC errors cover the gap.
        self.ring = ring if ring is not None \
            else HashRing(sorted(members), vnodes=vnodes)
        self.registry = registry or get_registry()
        self.local = local if local is not None \
            else CellFlightTable(registry=self.registry)
        self.authoritative = authoritative
        self._lock = threading.Lock()
        #: keys this process fleet-leads at a remote owner — publish
        #: and abandon must also release the owner-side claim
        self._remote_led: set = set()
        self.counters = {"remote_leads": 0, "remote_follows": 0,
                         "remote_abandoned": 0, "rpc_errors": 0}

    def _count(self, name: str):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + 1

    # -- the CellFlightTable contract --------------------------------------
    def claim(self, key: str):
        flight, leader = self.local.claim(key)
        if not leader:
            # another sweep in this process already coordinates this
            # cell (fleet-leading or fleet-following it)
            return flight, False
        owner = self.ring.owner(key)
        if self.authoritative and owner == self.node_id:
            return flight, True
        resp = _rpc(self.members, owner, RING_CLAIM, {"key": key},
                    RPC_TIMEOUT_S)
        if resp is None:
            # owner unreachable: lead locally — dedup degrades, the
            # sweep never blocks on a dead peer
            self._count("rpc_errors")
            return flight, True
        if resp.get("leader"):
            with self._lock:
                self._remote_led.add(key)
            self._count("remote_leads")
            return flight, True
        return _RemoteFollow(key, flight, owner,
                             outcome=resp.get("outcome")), False

    def publish(self, key: str, outcome: dict):
        self.local.publish(key, outcome)
        with self._lock:
            led = key in self._remote_led
            self._remote_led.discard(key)
        if led:
            # owner recomputed at publish time on the live ring: if
            # membership changed mid-flight the outcome lands at the
            # *current* owner (fail-open re-claim — the old owner's
            # lease expiry wakes its own waiters)
            owner = self.ring.owner(key)
            if self.authoritative and owner == self.node_id:
                return  # ownership moved to us; local publish done
            if _rpc(self.members, owner, RING_PUBLISH,
                    {"key": key, "outcome": outcome},
                    RPC_TIMEOUT_S) is None:
                self._count("rpc_errors")

    def abandon(self, key: str):
        self.local.abandon(key)
        with self._lock:
            led = key in self._remote_led
            self._remote_led.discard(key)
        if led:
            owner = self.ring.owner(key)
            if self.authoritative and owner == self.node_id:
                return
            if _rpc(self.members, owner, RING_ABANDON, {"key": key},
                    RPC_TIMEOUT_S) is None:
                self._count("rpc_errors")

    def wait(self, flight, timeout: Optional[float] = None
             ) -> Optional[dict]:
        if not isinstance(flight, _RemoteFollow):
            return self.local.wait(flight, timeout)
        outcome = flight.outcome
        if outcome is None:
            budget = REMOTE_WAIT_TOTAL_S if timeout is None \
                else min(timeout, REMOTE_WAIT_TOTAL_S)
            spent = 0.0
            while spent < budget and outcome is None:
                step = min(REMOTE_WAIT_S, budget - spent)
                resp = _rpc(self.members, flight.owner, RING_WAIT,
                            {"key": flight.key, "timeout": step},
                            step + RPC_TIMEOUT_S)
                if resp is None:
                    self._count("rpc_errors")
                    break
                outcome = resp.get("outcome")
                if outcome is None and not resp.get("pending"):
                    break  # abandoned (or settled as a non-persisted
                    # error) at the owner: evaluate it ourselves
                spent += step
        if outcome is None:
            # wake this process's local followers to self-evaluate —
            # a dead fleet leader must never hang a whole node
            self.local.abandon(flight.key)
            self._count("remote_abandoned")
            return None
        # deliver to local followers BEFORE returning (same
        # publish-then-return order a local leader gives them)
        self.local.publish(flight.key, outcome)
        self._count("remote_follows")
        self.registry.counter("coalesce_remote_follows_total").inc()
        return outcome

    def inflight(self) -> int:
        return self.local.inflight()

    def stats(self) -> dict:
        out = self.local.stats()
        with self._lock:
            out["remote"] = dict(self.counters)
        out["remote"]["node_id"] = self.node_id
        return out


def build_worker_flights(node_id: str, ring_spec: str,
                         registry=None) -> FleetCellFlightTable:
    """The pool-worker constructor (``pool._worker_main``): a
    non-authoritative table that claims every cell over the wire —
    through its own parent node for self-owned cells, so all of a
    node's workers coordinate through the one parent table."""
    return FleetCellFlightTable(
        node_id, parse_ring_spec(ring_spec), registry=registry,
        authoritative=False,
    )


class Replicator:
    """Pull-side shard replication. The single-writer rule holds:
    this node's parent process is the only writer of this node's
    store; it *pulls* raw entries from peers and installs them
    atomically. Freshness is the peer's ``(path, mtime, size)`` stamp
    — re-pull exactly when the peer replaced the file."""

    def __init__(self, node_id: str,
                 members: Dict[str, Tuple[str, int]],
                 ring: HashRing, store, registry=None):
        self.node_id = node_id
        self.members = dict(members)
        self.ring = ring
        self.store = store
        self.registry = registry or get_registry()
        self._lock = threading.Lock()
        #: (peer, namespace, key) -> last-pulled stamp
        self._seen: Dict[tuple, list] = {}
        self.counters = {"rounds": 0, "checked": 0, "pulled": 0,
                         "skipped_same": 0, "peer_errors": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _wants(self, key: str) -> bool:
        """This node replicates the keys whose ring placement names it
        owner or one of the ``REPLICA_COUNT`` successors."""
        return self.node_id in self.ring.successors(
            key, REPLICA_COUNT + 1)

    def pull_once(self) -> dict:
        """One full pull round over every peer; returns the round's
        accounting (the ``POST /ring/replicate`` response)."""
        if self.store is None:
            return {"checked": 0, "pulled": 0, "disabled": True}
        checked = pulled = skipped = 0
        for peer in sorted(self.members):
            if peer == self.node_id:
                continue
            resp = _rpc(self.members, peer, RING_ENTRIES, {},
                        RPC_TIMEOUT_S)
            if resp is None:
                with self._lock:
                    self.counters["peer_errors"] += 1
                continue
            for row in resp.get("entries", ()):
                ns = row.get("namespace")
                key = row.get("key")
                if not ns or not key or not self._wants(key):
                    continue
                checked += 1
                stamp = row.get("stamp")
                seen_key = (peer, ns, key)
                with self._lock:
                    fresh = self._seen.get(seen_key) == stamp
                if fresh:
                    continue
                sha = row.get("sha256")
                if sha and self.store.entry_sha(ns, key) == sha:
                    # we already hold these bytes (evaluated here, or
                    # pulled from another peer): stamp it seen
                    skipped += 1
                    with self._lock:
                        self._seen[seen_key] = stamp
                    continue
                raw = _rpc_bytes(self.members, peer, RING_ENTRY,
                                 {"namespace": ns, "key": key},
                                 RPC_TIMEOUT_S)
                if raw is None:
                    with self._lock:
                        self.counters["peer_errors"] += 1
                    continue
                if self.store.import_entry(ns, key, raw):
                    pulled += 1
                    with self._lock:
                        self._seen[seen_key] = stamp
                    self.registry.counter("replica_pulls_total").inc()
        with self._lock:
            self.counters["rounds"] += 1
            self.counters["checked"] += checked
            self.counters["pulled"] += pulled
            self.counters["skipped_same"] += skipped
        return {"checked": checked, "pulled": pulled,
                "skipped_same": skipped}

    def start(self, interval_s: float):
        """Background pull loop (``serve --replicate-s``); off by
        default — tests and the bench drive rounds synchronously via
        ``POST /ring/replicate``."""
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.pull_once()
                except Exception:
                    with self._lock:
                        self.counters["peer_errors"] += 1

        self._thread = threading.Thread(
            target=loop, daemon=True, name="planner-replicator")
        self._thread.start()

    def close(self):
        self._stop.set()

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, seen=len(self._seen))


class FailureDetector:
    """Deterministic heartbeat prober over the ``/ring/ping`` RPC.

    Each round probes every peer (sorted order) with a small
    timeout; consecutive misses walk a peer ``up -> suspect -> down``
    and a down verdict **removes the peer from the live ring** (epoch
    bump — an expected 1/N of the keyspace remaps to successors). The
    first successful probe of a down peer adds it back (another bump)
    and kicks one background replica-pull round, which the manifest
    stamps turn into a delta: only entries the peer wrote or missed
    while partitioned actually transfer.

    The schedule is seeded: round gaps are
    ``interval * (1 + rng.random()/2)`` off one ``random.Random(seed)``
    stream, so a fleet's probe traffic never phase-locks yet every
    run with the same seed probes at the same relative times — the
    property the chaos harness's serial-reproducibility oracle leans
    on. Tests drive :meth:`probe_once` synchronously instead of
    starting the thread.
    """

    STATE_GAUGE = {"up": 0, "suspect": 1, "down": 2}

    def __init__(self, node: "FleetNode",
                 interval_s: float = PROBE_INTERVAL_S,
                 probe_timeout_s: float = PROBE_TIMEOUT_S,
                 suspect_after: int = SUSPECT_AFTER,
                 down_after: int = DOWN_AFTER,
                 seed: int = 0):
        self.node = node
        self.interval_s = float(interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.suspect_after = int(suspect_after)
        self.down_after = int(down_after)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        peers = [p for p in sorted(node.members)
                 if p != node.node_id]
        self._fails: Dict[str, int] = {p: 0 for p in peers}
        self._state: Dict[str, str] = {p: "up" for p in peers}
        self.counters = {"rounds": 0, "probes": 0, "misses": 0,
                         "removed": 0, "rejoined": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._publish_gauges()

    # -- one probe round ---------------------------------------------------
    def probe_once(self) -> dict:
        """Probe every peer once and apply state transitions; returns
        the round's verdict map (also the forensics view)."""
        transitions: List[dict] = []
        for peer in sorted(self._fails):
            resp = _rpc(self.node.members, peer, RING_PING,
                        {"from": self.node.node_id},
                        self.probe_timeout_s)
            with self._lock:
                self.counters["probes"] += 1
            if resp is not None and resp.get("ok"):
                self._mark_up(peer, transitions)
            else:
                with self._lock:
                    self.counters["misses"] += 1
                self._mark_miss(peer, transitions)
        with self._lock:
            self.counters["rounds"] += 1
        self._publish_gauges()
        return {"states": self.states(), "transitions": transitions,
                "epoch": self.node.ring.epoch}

    def _mark_up(self, peer: str, transitions: List[dict]):
        with self._lock:
            was = self._state[peer]
            self._fails[peer] = 0
            self._state[peer] = "up"
        if was == "down":
            try:
                self.node.ring.add_node(peer)
            except ConfigError:
                pass  # raced another path re-adding it
            with self._lock:
                self.counters["rejoined"] += 1
            transitions.append({"node": peer, "from": was,
                                "to": "up",
                                "epoch": self.node.ring.epoch})
            # delta re-replication: the stamps in _seen make this
            # round pull only what changed while the peer was away
            t = threading.Thread(
                target=self._pull_safely, daemon=True,
                name="planner-rejoin-pull")
            t.start()
        elif was != "up":
            transitions.append({"node": peer, "from": was,
                                "to": "up",
                                "epoch": self.node.ring.epoch})

    def _mark_miss(self, peer: str, transitions: List[dict]):
        with self._lock:
            self._fails[peer] += 1
            fails = self._fails[peer]
            was = self._state[peer]
            if fails >= self.down_after:
                self._state[peer] = "down"
            elif fails >= self.suspect_after:
                self._state[peer] = "suspect"
            now = self._state[peer]
        if now == was:
            return
        if now == "down":
            try:
                self.node.ring.remove_node(peer)
            except ConfigError:
                pass  # already removed
            with self._lock:
                self.counters["removed"] += 1
        transitions.append({"node": peer, "from": was, "to": now,
                            "epoch": self.node.ring.epoch})

    def _pull_safely(self):
        try:
            self.node.replicator.pull_once()
        except Exception:
            # a failed opportunistic pull is re-attempted by the
            # periodic loop; record it on the replicator's counter
            with self.node.replicator._lock:
                self.node.replicator.counters["peer_errors"] += 1

    def _publish_gauges(self):
        reg = self.node.registry
        with self._lock:
            states = dict(self._state)
        for peer, state in sorted(states.items()):
            reg.gauge("ring_member_state", node=peer).set(
                self.STATE_GAUGE[state])
        reg.gauge("ring_epoch").set(self.node.ring.epoch)
        reg.gauge("ring_nodes").set(len(self.node.ring))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        def loop():
            while True:
                gap = self.interval_s * (1.0 + self._rng.random() / 2)
                if self._stop.wait(gap):
                    return
                try:
                    self.probe_once()
                except Exception:
                    # a probe round must never kill the loop; the
                    # miss counter records that something went wrong
                    with self._lock:
                        self.counters["misses"] += 1

        self._thread = threading.Thread(
            target=loop, daemon=True, name="planner-failure-detector")
        self._thread.start()

    def close(self):
        self._stop.set()

    def states(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._state)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["states"] = self.states()
        out["suspect_after"] = self.suspect_after
        out["down_after"] = self.down_after
        out["interval_s"] = self.interval_s
        return out


class FleetNode:
    """One node's fleet state: ring + router + owner-side flight
    surface + replicator, attached to a ``PlannerHTTPServer`` by
    :func:`attach_fleet` (the server dispatches ``/ring/*`` here)."""

    def __init__(self, node_id: str,
                 members: Dict[str, Tuple[str, int]],
                 planner, registry=None,
                 vnodes: int = DEFAULT_VNODES):
        self.node_id = node_id
        self.members = dict(members)
        self.registry = registry or get_registry()
        self.ring = HashRing(sorted(members), vnodes=vnodes)
        self.router = Router(self.ring, node_id, members,
                             registry=self.registry)
        self.planner = planner
        self.store = planner.store if planner.enabled else None
        #: the node's one authoritative flight table: the planner's
        #: existing local table, wrapped for the wire — remote peers
        #: claim against it (handle_ring), local sweeps through the
        #: planner, and the node's pool workers through loopback RPC
        local = getattr(planner.cell_flights, "local",
                        planner.cell_flights)
        self.flights = FleetCellFlightTable(
            node_id, members, local=local, registry=self.registry,
            authoritative=True, vnodes=vnodes, ring=self.ring)
        planner.cell_flights = self.flights
        self.replicator = Replicator(node_id, members, self.ring,
                                     self.store,
                                     registry=self.registry)
        #: heartbeat prober editing the live ring; created idle —
        #: attach_fleet starts the thread when probing is enabled,
        #: tests drive probe_once() synchronously
        self.detector = FailureDetector(self)
        #: owner-side leases on claims granted to remote leaders
        self._leases: Dict[str, threading.Timer] = {}
        self._lease_lock = threading.Lock()
        #: crash-recovery sweep BEFORE the first request: quarantine
        #: anything torn while this node was down, then let the next
        #: replica pull restore the owned keys it removed
        self.recovery = (self.store.recover()
                         if self.store is not None else
                         {"checked": 0, "ok": 0, "quarantined": []})
        self.registry.gauge("ring_nodes").set(len(self.ring))
        self.registry.gauge("ring_epoch").set(self.ring.epoch)

    @property
    def local_flights(self) -> CellFlightTable:
        return self.flights.local

    # -- owner-side lease --------------------------------------------------
    def _arm_lease(self, key: str):
        def expire():
            with self._lease_lock:
                self._leases.pop(key, None)
            # the remote leader never published: wake every waiter
            # (local sweeps, long-polls, this node's workers) to
            # re-evaluate — no follower hangs on a dead leader
            self.local_flights.abandon(key)

        timer = threading.Timer(REMOTE_LEASE_S, expire)
        timer.daemon = True
        with self._lease_lock:
            old = self._leases.pop(key, None)
            self._leases[key] = timer
        if old is not None:
            old.cancel()
        timer.start()

    def _release_lease(self, key: str):
        with self._lease_lock:
            timer = self._leases.pop(key, None)
        if timer is not None:
            timer.cancel()

    # -- the /ring/* surface -----------------------------------------------
    def handle_ring(self, path: str, q: dict):
        """Serve one ring RPC; returns ``(status, payload)`` where
        payload is a JSON-safe dict — or raw bytes for
        ``/ring/entry`` (the wire format is the disk format)."""
        if path == RING_CLAIM:
            return self._claim(q)
        if path == RING_PUBLISH:
            return self._publish(q)
        if path == RING_ABANDON:
            self._release_lease(q["key"])
            self.local_flights.abandon(q["key"])
            return 200, {"ok": True}
        if path == RING_WAIT:
            return self._wait(q)
        if path == RING_ENTRIES:
            if self.store is None:
                return 200, {"entries": []}
            return 200, {"entries":
                         self.store.manifest(q.get("namespace"))}
        if path == RING_ENTRY:
            raw = self.store.export_entry(q["namespace"], q["key"]) \
                if self.store is not None else None
            if raw is None:
                return 404, {"error": "no such entry"}
            return 200, raw
        if path == RING_REPLICATE:
            return 200, self.replicator.pull_once()
        if path == RING_STATE:
            return 200, self.state()
        if path == RING_PING:
            # the heartbeat: proof of life plus this node's membership
            # view, so forensics can line up epoch divergence
            return 200, {"ok": True, "node_id": self.node_id,
                         "epoch": self.ring.epoch,
                         "nodes": list(self.ring.nodes())}
        return 404, {"error": f"unknown ring path {path}"}

    def _claim(self, q: dict):
        key = q["key"]
        # the owner's store is the first authority: a settled cell is
        # served, never re-claimed (this is also how a whole sweep
        # previously evaluated elsewhere in the fleet comes back as
        # pure follows)
        if self.store is not None:
            entry = self.store.get("sweep", key)
            if isinstance(entry, dict) \
                    and entry.get("status") in ("ok", "empty"):
                return 200, {"leader": False, "outcome": entry}
        _flight, leader = self.local_flights.claim(key)
        if leader:
            # remote leader: lease the claim so its death cannot hang
            # the fleet's followers
            self._arm_lease(key)
        return 200, {"leader": leader}

    def _publish(self, q: dict):
        key, outcome = q["key"], q.get("outcome") or {}
        self._release_lease(key)
        # store BEFORE publish (the CellFlightTable contract): a
        # late claim that missed the flight finds the entry in this
        # shard. Error outcomes publish but never persist — same rule
        # as the local sweep path.
        if self.store is not None \
                and outcome.get("status") in ("ok", "empty"):
            try:
                self.store.put("sweep", key, {
                    "status": outcome.get("status"),
                    "row": outcome.get("row"),
                    "error": outcome.get("error"),
                })
            except OSError:
                pass
        self.local_flights.publish(key, outcome)
        return 200, {"ok": True}

    def _wait(self, q: dict):
        key = q["key"]
        timeout = min(float(q.get("timeout") or REMOTE_WAIT_S),
                      REMOTE_WAIT_S)
        flight = self.local_flights.flight(key)
        if flight is None:
            # settled (or never claimed): the store is the answer
            if self.store is not None:
                entry = self.store.get("sweep", key)
                if isinstance(entry, dict) \
                        and entry.get("status") in ("ok", "empty"):
                    return 200, {"outcome": entry, "pending": False}
            return 200, {"outcome": None, "pending": False}
        outcome = self.local_flights.wait(flight, timeout)
        if outcome is None:
            # timed out (still pending — the caller re-polls) or
            # abandoned (event set with no outcome — the caller
            # evaluates)
            pending = not flight.event.is_set()
            return 200, {"outcome": None, "pending": pending}
        return 200, {"outcome": outcome, "pending": False}

    # -- introspection -----------------------------------------------------
    def state(self) -> dict:
        """The ring-state forensics document (``GET /ring/state``)."""
        return {
            "node_id": self.node_id,
            "members": {n: list(a)
                        for n, a in sorted(self.members.items())},
            "ring": self.ring.stats(),
            "router": self.router.stats(),
            "flights": self.flights.stats(),
            "replicator": self.replicator.stats(),
            "detector": self.detector.stats(),
            "recovery": self.recovery,
            "quarantine": (self.store.quarantined()
                           if self.store is not None else []),
            "leases": len(self._leases),
        }

    def close(self):
        self.detector.close()
        self.replicator.close()
        self.router.close()
        with self._lease_lock:
            timers = list(self._leases.values())
            self._leases.clear()
        for t in timers:
            t.cancel()


def warm_route_filter(node: FleetNode) -> Callable[[dict], bool]:
    """Warmer gate: only warm the sweeps this node owns — the owner's
    warmer warms them into the right shard, and two nodes never race
    to warm the same neighborhood (``service/warmer.py``)."""
    def owns(search_body: dict) -> bool:
        return node.ring.owner(
            route_key("/v1/search", search_body)) == node.node_id

    return owns


def attach_fleet(server, node_id: str, ring_spec: str,
                 replicate_s: float = 0.0,
                 vnodes: int = DEFAULT_VNODES,
                 probe_s: float = 0.0,
                 probe_seed: int = 0) -> FleetNode:
    """Turn one built ``PlannerHTTPServer`` into a fleet node: parse
    the membership spec, wrap the planner's flight table for the
    wire, mount the router and the ``/ring/*`` surface, gate the
    warmer to owned sweeps, run the store's crash-recovery sweep, and
    (optionally) start the background replica pull and the failure
    detector (``--probe-s``). Returns the :class:`FleetNode` (also at
    ``server.fleet``)."""
    members = parse_ring_spec(ring_spec)
    if node_id not in members:
        raise ConfigError(
            f"--join {node_id!r} is not a member of the ring "
            f"({format_ring_spec(members)})")
    node = FleetNode(node_id, members, server.planner,
                     registry=server.registry, vnodes=vnodes)
    server.fleet = node
    server.router = node.router
    if server.warmer is not None:
        server.warmer.route_filter = warm_route_filter(node)
        server.warmer.degraded = lambda: any(
            s == "down" for s in node.detector.states().values())
    if replicate_s > 0:
        node.replicator.start(replicate_s)
    # bench-only fault injection: no-op unless SIMUMAX_CHAOS_NET is
    # exported (the chaos harness sets it before forking fleet nodes)
    from simumax_tpu_torch.service.chaos import maybe_install_net_chaos
    maybe_install_net_chaos(node.router)
    if probe_s > 0:
        node.detector.interval_s = float(probe_s)
        node.detector._rng = random.Random(probe_seed)
        node.detector.start()
    if node.recovery.get("quarantined"):
        # recovery removed entries this node serves: pull them back
        # from the replicas as soon as peers answer (one-shot,
        # fail-open — the periodic pull and the detector's rejoin
        # pull retry later if peers are still starting)
        threading.Thread(
            target=node.detector._pull_safely, daemon=True,
            name="planner-recovery-pull").start()
    return node

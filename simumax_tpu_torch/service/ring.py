"""Consistent-hash ring over planner nodes (L19).

One planner node maxed out at ``results/bench_service_siege_baseline
.json``; the fleet shards the content-addressed store across N nodes.
The store's sha256 keys are uniform, so the classic consistent-hash
construction applies directly: every node projects ``vnodes`` virtual
points onto a 64-bit circle (the first 8 bytes of
``sha256(f"{node_id}#{i}")``), and a key is owned by the first point
clockwise of ``sha256(key)``. Virtual points keep per-node load within
a few percent of 1/N; adding or removing one node remaps only the arcs
that node's points covered — an expected ``1/N`` of the keyspace —
so a membership change never invalidates the whole fleet's cache
(the fleet tests pin both properties).

Everything here is a pure function of the membership list: no wall
clock, no global randomness, no dict/set iteration order — the same
ring spec places every key identically in every process (router,
node, bench client), which is what makes client-side affinity routing
and server-side forwarding agree.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from simumax_tpu_torch.core.errors import ConfigError

#: virtual points per node. 64 keeps the max/mean shard imbalance
#: under ~1.25 for small fleets (pinned by the balance test) while the
#: whole ring stays a few-KB sorted list rebuilt in microseconds.
DEFAULT_VNODES = 64


def _point(label: str) -> int:
    """64-bit circle position of one virtual-node label."""
    return int.from_bytes(
        hashlib.sha256(label.encode("utf-8")).digest()[:8], "big")


def key_point(key: str) -> int:
    """Circle position of a store/route key (same hash family as the
    node points, so placement is uniform for sha256-hex keys and for
    arbitrary identity strings alike)."""
    return _point(key)


class HashRing:
    """Deterministic consistent-hash ring over node ids.

    The ring is rebuilt from scratch on membership change (sorted
    points over ``nodes x vnodes`` labels) — O(N·V·log(N·V)) on a
    change that happens ~never per request, buying a lookup that is
    one sha256 + one bisect.

    Membership is *live* (L20): the failure detector removes a down
    member and re-adds it on rejoin while routers and flight tables
    keep placing keys. Lookups therefore read one immutable
    ``(nodes, points, owners)`` table snapshot, swapped atomically
    under ``_lock`` on every change, and every post-construction
    change bumps ``epoch`` — observers compare epochs instead of
    diffing membership lists.
    """

    def __init__(self, nodes: Sequence[str] = (),
                 vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ConfigError(
                f"ring vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._lock = threading.Lock()
        # one immutable snapshot; readers bind it to a local so a
        # concurrent swap can never mix points from one membership
        # with owners from another
        self._table: Tuple[Tuple[str, ...], Tuple[int, ...],
                           Tuple[str, ...]] = ((), (), ())
        for n in nodes:
            self.add_node(n)
        #: membership version. 0 is the as-constructed ring; every
        #: later add/remove bumps it by one.
        self.epoch = 0

    # -- membership --------------------------------------------------------
    def add_node(self, node_id: str):
        if not node_id:
            raise ConfigError("ring node id must be non-empty")
        with self._lock:
            nodes = self._table[0]
            if node_id in nodes:
                raise ConfigError(f"ring already has node {node_id!r}")
            self._swap(sorted(nodes + (node_id,)))

    def remove_node(self, node_id: str):
        with self._lock:
            nodes = self._table[0]
            if node_id not in nodes:
                raise ConfigError(f"ring has no node {node_id!r}")
            self._swap([n for n in nodes if n != node_id])

    def _swap(self, nodes: Sequence[str]):
        """Rebuild and atomically publish the lookup table (callers
        hold ``_lock``)."""
        pairs: List[Tuple[int, str]] = []
        for node_id in nodes:
            for i in range(self.vnodes):
                pairs.append((_point(f"{node_id}#{i}"), node_id))
        # ties (astronomically unlikely 64-bit collisions) break on the
        # node id so every process agrees
        pairs.sort()
        self._table = (tuple(nodes),
                       tuple(p for p, _ in pairs),
                       tuple(n for _, n in pairs))
        if hasattr(self, "epoch"):
            self.epoch += 1

    def nodes(self) -> Tuple[str, ...]:
        return self._table[0]

    def __len__(self) -> int:
        return len(self._table[0])

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._table[0]

    # -- placement ---------------------------------------------------------
    def owner(self, key: str) -> str:
        """The node owning ``key`` (first virtual point clockwise)."""
        nodes, points, owners = self._table
        if not nodes:
            raise ConfigError("ring is empty: no nodes to own keys")
        i = bisect.bisect_right(points, key_point(key))
        if i == len(points):
            i = 0
        return owners[i]

    def successors(self, key: str, count: Optional[int] = None
                   ) -> List[str]:
        """Distinct nodes in ring order starting at the owner — the
        owner first, then each next-distinct point clockwise. This is
        both the replica set (owner + the next ``R`` entries) and the
        router's retry order when the owner is unreachable."""
        nodes, points, owners = self._table
        if not nodes:
            raise ConfigError("ring is empty: no nodes to own keys")
        want = len(nodes) if count is None \
            else min(int(count), len(nodes))
        start = bisect.bisect_right(points, key_point(key))
        out: List[str] = []
        for step in range(len(points)):
            node = owners[(start + step) % len(points)]
            if node not in out:
                out.append(node)
                if len(out) >= want:
                    break
        return out

    # -- introspection -----------------------------------------------------
    def balance(self, samples: int = 4096) -> Dict[str, float]:
        """Fraction of a uniform keyspace owned per node, estimated by
        placing ``samples`` deterministic probe keys — the forensics
        view behind ``/ring/state`` (and the balance test)."""
        nodes = self._table[0]
        counts: Dict[str, int] = {n: 0 for n in nodes}
        for i in range(samples):
            probe = self.owner(f"balance-probe-{i}")
            counts[probe] = counts.get(probe, 0) + 1
        return {n: counts.get(n, 0) / float(samples) for n in nodes}

    def stats(self) -> dict:
        nodes, points, _ = self._table
        return {
            "nodes": list(nodes),
            "epoch": self.epoch,
            "vnodes": self.vnodes,
            "points": len(points),
            "balance": self.balance(),
        }


def parse_ring_spec(spec: str) -> Dict[str, Tuple[str, int]]:
    """Parse ``"a=127.0.0.1:9001,b=127.0.0.1:9002"`` into an ordered
    ``{node_id: (host, port)}`` map — the one membership format the
    CLI, the bench, and forked node processes all share."""
    members: Dict[str, Tuple[str, int]] = {}
    for part in [p.strip() for p in spec.split(",") if p.strip()]:
        node_id, sep, addr = part.partition("=")
        host, hsep, port = addr.partition(":")
        if not sep or not hsep or not node_id or not host:
            raise ConfigError(
                f"bad ring member {part!r}: expected id=host:port")
        try:
            port_n = int(port)
        except ValueError:
            raise ConfigError(
                f"bad ring member {part!r}: port {port!r} is not an "
                f"integer") from None
        if node_id in members:
            raise ConfigError(
                f"duplicate ring node id {node_id!r} in {spec!r}")
        members[node_id] = (host, port_n)
    if not members:
        raise ConfigError(f"ring spec {spec!r} names no members")
    return members


def format_ring_spec(members: Dict[str, Tuple[str, int]]) -> str:
    return ",".join(f"{n}={h}:{p}"
                    for n, (h, p) in sorted(members.items()))

"""Affinity routing across the planner fleet (L19).

The worker pool routes each search to a worker by an affinity hash
(``pool.search_affinity``); the fleet applies the same idea one level
up: every ``/v1/*`` request has a deterministic **route key** — the
canonical JSON of its identity fields, the same fields that prefix its
content-addressed store key — and the consistent-hash ring
(``service/ring.py``) maps that key to the one node that owns the
request's store shard. A node receiving a request it does not own
forwards the raw request bytes to the owner and streams the owner's
raw response bytes back — no re-parse, no re-serialize — so a routed
response is bit-identical to asking the owner (or a cache-off planner)
directly.

Sweep grids route on their run identity *minus the grid dimensions*:
two overlapping grids (``tp=1,2`` vs ``tp=1,2,4``) land on the same
owner, where the node-local ``CellFlightTable`` coalesces their shared
cells; clients that hit arbitrary nodes instead are coalesced by the
wire-level flight table (``service/node.py``).

Failure semantics: forwarding retries down ``ring.successors(key)``
on connection-level errors (refused / reset / timeout before any
response byte), so a dead owner degrades to its successor — which can
always evaluate (every node holds the full config registries; the
shard only decides where results are *cached*) and may already hold a
replica (``service/node.py`` replica pull). Once response bytes have
been relayed the request is never retried (no double-answer); a
forwarded 429 passes through verbatim, so admission composes across
the router hop and the owner's pool.

L20 adds deadline budgets and hedging on top: an
``X-SimuMax-Deadline`` millisecond budget (client-supplied or derived
from the hop timeout) shrinks across hops — each hop's connect+read
deadline is ``min(FORWARD_TIMEOUT_S, remaining)`` and the peer
receives the *remaining* budget, so a wedged peer that accepts the
connection and then goes silent costs one bounded hop
(``router_hop_timeouts_total``), never a full client timeout. For
idempotent read forwards the router also **hedges**: if the owner has
not produced its first response byte within a p99-derived delay, the
same request is sent to the next successor and whichever connection
turns readable first is relayed — the loser is torn down unread
(``hedged_requests_total{outcome}``). Writes (``/v1/search`` sweeps,
anything that populates the owner's shard) are never hedged: the
single-writer discipline of the store is worth more than its tail.
"""

from __future__ import annotations

import collections
import http.client
import select
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from simumax_tpu_torch.observe.telemetry import get_registry, get_tracer
from simumax_tpu_torch.service.ring import HashRing
from simumax_tpu_torch.service.store import content_key

#: request-body fields that never change which store shard a request
#: belongs to: sweep grid dimensions (overlapping grids must share an
#: owner for cell coalescing) and pure serving knobs
SEARCH_VOLATILE_FIELDS = frozenset({
    "tp", "pp", "ep", "cp", "zero", "recompute",
    "topk", "verify_topk", "stream", "search_mode", "prune",
})

#: seconds a forwarded request may wait on the owner before the router
#: gives up on that hop and tries the successor (covers connect +
#: response head; generous — owners under load answer via admission
#: control, not silence)
FORWARD_TIMEOUT_S = 120.0

#: response headers relayed verbatim from the owner — the serving
#: metadata contract of docs/service.md (cache/key/served/cells ride
#: headers, never the body) plus transport framing
RELAY_HEADERS = (
    "Content-Type", "Content-Encoding", "Retry-After",
    "X-SimuMax-Cache", "X-SimuMax-Key", "X-SimuMax-Served",
    "X-SimuMax-Cells", "X-SimuMax-Trace",
)

#: request headers relayed to the owner: body framing, priority (the
#: owner's admission classes the request exactly as the client sent
#: it), trace id (one span tree across the hop), and the client's
#: transport-encoding opt-in
FORWARD_REQ_HEADERS = (
    "Content-Type", "Accept-Encoding",
    "X-SimuMax-Priority", "X-SimuMax-Trace",
)

#: loop guard: a request that already took one router hop is served
#: where it lands — two nodes with momentarily different ring views
#: must never bounce a request between each other
FORWARDED_HEADER = "X-SimuMax-Forwarded"

#: per-request deadline budget in integer milliseconds. The client
#: (or the first node) sets it; every hop forwards the *remaining*
#: budget and bounds its own connect+read wait by it, so the budget
#: is a fleet-wide contract, not a per-socket knob.
DEADLINE_HEADER = "X-SimuMax-Deadline"

#: below this many observed forward latencies the hedge delay is
#: undefined and hedging stays off — a p99 of three samples is noise
HEDGE_MIN_SAMPLES = 32

#: forward-latency window the hedge delay is derived from (response
#: head seen, i.e. what first-byte-wins races against)
HEDGE_WINDOW = 512

#: hedging never fires faster than this, whatever the p99 says — a
#: warm cache answers in microseconds and hedging those would double
#: fleet traffic for nothing
HEDGE_MIN_DELAY_S = 0.05

#: leftover budget below which another hop attempt is pointless (the
#: peer could not even parse the request before the client gives up)
MIN_HOP_BUDGET_S = 0.01


def route_key(endpoint: str, q: dict) -> str:
    """Deterministic route key of one request: the sha256 of the
    canonical JSON of the endpoint + its shard-identity fields — the
    same hash family (and for estimate/explain, the same identity
    fields) that prefixes the request's content-addressed store key.
    Every process (bench client, router, node) computes the same key
    for the same request."""
    if endpoint == "/v1/search":
        ident = {k: v for k, v in q.items()
                 if k not in SEARCH_VOLATILE_FIELDS}
    else:
        ident = q
    return content_key({"endpoint": endpoint, "q": ident})


class Forwarded:
    """One relayed upstream response: status + header subset + the
    live ``http.client`` response (the caller streams ``response`` and
    then returns the connection via :meth:`Router.finish`)."""

    __slots__ = ("status", "headers", "response", "conn", "node",
                 "chunked")

    def __init__(self, status, headers, response, conn, node, chunked):
        self.status = status
        self.headers = headers
        self.response = response
        self.conn = conn
        self.node = node
        self.chunked = chunked


class Router:
    """Forwarding tier of one fleet node (every node embeds one).

    Holds the ring, this node's identity, and a per-peer pool of
    keep-alive connections. Thread-safe: the ThreadingHTTPServer
    forwards from many handler threads at once.
    """

    def __init__(self, ring: HashRing, node_id: str,
                 members: Dict[str, Tuple[str, int]],
                 registry=None):
        self.ring = ring
        self.node_id = node_id
        self.members = dict(members)
        self.registry = registry or get_registry()
        self._lock = threading.Lock()
        self._conns: Dict[str, List[http.client.HTTPConnection]] = {}
        self.counters = {"forwards": 0, "local": 0, "retries": 0,
                         "failed": 0, "hop_timeouts": 0, "hedges": 0}
        #: recent forward latencies (request sent -> response head
        #: readable), the sample the hedge delay's p99 is cut from
        self._lat: Deque[float] = collections.deque(maxlen=HEDGE_WINDOW)
        self.registry.gauge("ring_nodes").set(len(ring))

    # -- hedging ------------------------------------------------------------
    def _record_latency(self, dt: float):
        with self._lock:
            self._lat.append(dt)

    def hedge_delay_s(self) -> Optional[float]:
        """The p99 of recent forward latencies — how long a read
        forward waits for the owner's first byte before racing a
        successor. None (hedging off) until enough samples exist."""
        with self._lock:
            if len(self._lat) < HEDGE_MIN_SAMPLES:
                return None
            lat = sorted(self._lat)
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        return max(p99, HEDGE_MIN_DELAY_S)

    # -- placement ---------------------------------------------------------
    def owner_for(self, endpoint: str, q: dict) -> str:
        return self.ring.owner(route_key(endpoint, q))

    def is_local(self, endpoint: str, q: dict) -> bool:
        """True when this node owns the request (or is the only node).
        Counted: the local/forward split is the fleet's routing
        efficiency signal (``router_local_hits_total``)."""
        local = self.owner_for(endpoint, q) == self.node_id
        if local:
            with self._lock:
                self.counters["local"] += 1
            self.registry.counter("router_local_hits_total").inc()
        return local

    def candidates(self, endpoint: str, q: dict) -> List[str]:
        """Forwarding order: the owner, then its distinct successors —
        this node excluded (it is the caller; ending up here again
        means serving locally, not another hop)."""
        order = self.ring.successors(route_key(endpoint, q))
        return [n for n in order if n != self.node_id]

    # -- connection pool ---------------------------------------------------
    def _checkout(self, node: str) -> http.client.HTTPConnection:
        with self._lock:
            pool = self._conns.get(node)
            if pool:
                return pool.pop()
        host, port = self.members[node]
        return http.client.HTTPConnection(
            host, port, timeout=FORWARD_TIMEOUT_S)

    def finish(self, fwd: Forwarded, reuse: bool):
        """Return a relayed connection to the pool (fully-read
        response, keep-alive) or close it."""
        if not reuse or fwd.response.will_close:
            fwd.conn.close()
            return
        with self._lock:
            self._conns.setdefault(fwd.node, []).append(fwd.conn)

    def close(self):
        with self._lock:
            conns = [c for pool in self._conns.values() for c in pool]
            self._conns.clear()
        for c in conns:
            c.close()

    # -- forwarding --------------------------------------------------------
    def _send(self, node: str, endpoint: str, raw_body: bytes,
              headers: dict, hop_timeout: float
              ) -> Optional[http.client.HTTPConnection]:
        """Issue one request and return the connection with its read
        deadline armed, or None on a connection-level send failure
        (counted as a retry by the caller)."""
        conn = self._checkout(node)
        conn.timeout = hop_timeout  # bounds a fresh connect
        try:
            conn.request("POST", endpoint, body=raw_body,
                         headers=headers)
            if conn.sock is not None:
                conn.sock.settimeout(hop_timeout)
        except (OSError, http.client.HTTPException):
            conn.close()
            return None
        return conn

    @staticmethod
    def _first_readable(pending: list, wait_s: float) -> Optional[int]:
        """Index of the first in-flight connection with response bytes
        (or a hangup) to read — the literal first-byte-wins arbiter —
        or None when ``wait_s`` elapses with every peer silent."""
        socks = [c.sock for c, _node, _role, _t in pending]
        if any(s is None for s in socks):
            return next(i for i, s in enumerate(socks) if s is None)
        try:
            readable, _w, _x = select.select(socks, [], [], wait_s)
        except (OSError, ValueError):
            return 0  # a socket died mid-wait; surface via getresponse
        if not readable:
            return None
        for i, s in enumerate(socks):
            if s in readable:
                return i
        return None

    def _hop_timed_out(self, node: str):
        with self._lock:
            self.counters["hop_timeouts"] += 1
        self.registry.counter("router_hop_timeouts_total",
                              node=node).inc()

    def forward(self, endpoint: str, raw_body: bytes,
                req_headers, q: Optional[dict] = None,
                deadline_s: Optional[float] = None,
                hedge: bool = False) -> Optional[Forwarded]:
        """Relay one request to the first candidate node that answers.

        Returns the open :class:`Forwarded` (the caller relays
        ``response`` and calls :meth:`finish`), or None when every
        candidate is unreachable or the deadline budget ran out — the
        caller serves locally (any node can evaluate; the shard only
        places the cache).

        ``deadline_s`` is the remaining request budget: each hop's
        connect+read wait is bounded by it, and the peer receives what
        is left via ``X-SimuMax-Deadline``. A peer that accepts the
        connection and then stalls past its hop deadline is abandoned
        and counted (``router_hop_timeouts_total``) — the successor is
        tried with the remaining budget.

        ``hedge=True`` (read-only endpoints) arms first-byte-wins
        hedging: once the first peer is ``hedge_delay_s()`` quiet, the
        same bytes go to the next successor and both race; the loser
        is closed unread."""
        headers = {FORWARDED_HEADER: self.node_id}
        for name in FORWARD_REQ_HEADERS:
            value = req_headers.get(name)
            if value:
                headers[name] = value
        headers["Content-Length"] = str(len(raw_body))
        tracer = get_tracer()
        if "X-SimuMax-Trace" not in headers:
            # the client sent no trace id: propagate THIS hop's active
            # request trace so the owner's spans (and its pool
            # worker's) join one fleet-wide span tree
            tid = tracer.current_trace_id()
            if tid:
                headers["X-SimuMax-Trace"] = tid
        body = q if q is not None else json_loads_safe(raw_body)
        cands = self.candidates(endpoint, body)
        deadline_end = (None if deadline_s is None
                        else time.monotonic() + deadline_s)
        delay = self.hedge_delay_s() if hedge else None
        #: in-flight legs: (conn, node, role, sent_at)
        pending: List[tuple] = []
        next_i = 0
        attempt = 0
        hedged = False
        while True:
            remaining = (None if deadline_end is None
                         else deadline_end - time.monotonic())
            if remaining is not None and remaining <= MIN_HOP_BUDGET_S:
                # budget exhausted: whatever is in flight has already
                # eaten its read deadline without a byte
                for conn, node, _role, _t in pending:
                    self._hop_timed_out(node)
                    conn.close()
                pending = []
                break
            hop_timeout = (FORWARD_TIMEOUT_S if remaining is None
                           else min(FORWARD_TIMEOUT_S, remaining))
            if not pending:
                if next_i >= len(cands):
                    break
                node = cands[next_i]
                next_i += 1
                hdrs = dict(headers)
                if remaining is not None:
                    hdrs[DEADLINE_HEADER] = str(
                        max(1, int(remaining * 1000)))
                with tracer.span("router_forward", node=node,
                                 endpoint=endpoint, attempt=attempt):
                    conn = self._send(node, endpoint, raw_body, hdrs,
                                      hop_timeout)
                attempt += 1
                if conn is None:
                    # connection-level failure before any response
                    # byte: safe to retry on the successor
                    with self._lock:
                        self.counters["retries"] += 1
                    continue
                pending.append((conn, node, "primary",
                                time.monotonic()))
            # hedge only while exactly the primary leg is in flight,
            # a successor remains, and the delay beats the hop budget
            can_hedge = (delay is not None and len(pending) == 1
                         and pending[0][2] == "primary" and not hedged
                         and next_i < len(cands)
                         and delay < hop_timeout)
            wait_s = delay if can_hedge else hop_timeout
            idx = self._first_readable(pending, wait_s)
            if idx is None:
                if can_hedge:
                    # primary is p99-slow: race the next successor
                    node = cands[next_i]
                    next_i += 1
                    hdrs = dict(headers)
                    if remaining is not None:
                        hdrs[DEADLINE_HEADER] = str(
                            max(1, int(remaining * 1000)))
                    with tracer.span("router_hedge", node=node,
                                     endpoint=endpoint,
                                     attempt=attempt):
                        conn = self._send(node, endpoint, raw_body,
                                          hdrs, hop_timeout)
                    attempt += 1
                    hedged = True
                    with self._lock:
                        self.counters["hedges"] += 1
                    if conn is None:
                        self.registry.counter(
                            "hedged_requests_total",
                            outcome="failed").inc()
                    else:
                        pending.append((conn, node, "hedge",
                                        time.monotonic()))
                    continue
                # per-hop read deadline: every in-flight peer accepted
                # the connection and then stalled — abandon and move on
                for conn, node, _role, _t in pending:
                    self._hop_timed_out(node)
                    conn.close()
                pending = []
                continue
            conn, node, role, sent_at = pending.pop(idx)
            try:
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException):
                conn.close()
                with self._lock:
                    self.counters["retries"] += 1
                continue  # the other leg (if any) or the successor
            self._record_latency(time.monotonic() - sent_at)
            for loser_conn, _n, _r, _t in pending:
                loser_conn.close()  # torn down unread
            pending = []
            if hedged:
                self.registry.counter(
                    "hedged_requests_total",
                    outcome="won" if role == "hedge" else "lost"
                ).inc()
            with self._lock:
                self.counters["forwards"] += 1
            self.registry.counter("router_forwards_total",
                                  node=node).inc()
            relay = {}
            for name in RELAY_HEADERS:
                value = resp.headers.get(name)
                if value is not None:
                    relay[name] = value
            chunked = "chunked" in \
                (resp.headers.get("Transfer-Encoding") or "").lower()
            return Forwarded(resp.status, relay, resp, conn, node,
                             chunked)
        if hedged:
            self.registry.counter("hedged_requests_total",
                                  outcome="failed").inc()
        with self._lock:
            self.counters["failed"] += 1
        return None

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["node_id"] = self.node_id
        out["ring"] = {"nodes": list(self.ring.nodes()),
                       "epoch": self.ring.epoch,
                       "vnodes": self.ring.vnodes}
        out["hedge_delay_s"] = self.hedge_delay_s()
        return out


def json_loads_safe(raw: bytes) -> dict:
    """Parse a request body for routing; malformed bodies route as
    empty identity (the owner answers the 400 — same node every
    time, so even errors stay sticky)."""
    import json

    try:
        q = json.loads(raw.decode("utf-8") or "{}")
    except (ValueError, UnicodeDecodeError):
        return {}
    return q if isinstance(q, dict) else {}

"""The port's self-healing fleet (``service/chaos.py``, ``node.py``,
``router.py``) held against the JAX package's.

Mirrors ``tests/test_service_chaos.py`` (its ``serve --nodes`` SIGTERM
case drives the CLI and waits for the port's ``cli.py``): the chaos
scenario schema and seeded injection determinism, whose injections are
also held against the JAX package's; ring epoch accounting; the failure
detector's walk (up -> suspect -> down -> rejoin) with live ring
reconfiguration; per-hop read deadlines against a wedged peer; hedging
(reads only); and the store's quarantine -> re-pull round trip. Every
node's planner runs with ``device="cpu"`` (the kernels' plain
versions); every server, thread and request waits with a bounded
deadline.

Tolerance: ``==`` on schedules, corrupted-entry choices and wire bytes.
"""

import http.client
import json
import os
import socket
import threading
import time

import pytest

pytest.importorskip("torch")

from simumax_tpu.service import chaos as jax_chaos  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError  # noqa: E402
from simumax_tpu_torch.service import server as server_mod  # noqa: E402
from simumax_tpu_torch.service.chaos import (  # noqa: E402
    ChaosScenario,
    NetChaos,
    corrupt_store_entries,
    load_scenario,
    parse_net_env,
)
from simumax_tpu_torch.service.node import (  # noqa: E402
    DOWN_AFTER,
    SUSPECT_AFTER,
    attach_fleet,
)
from simumax_tpu_torch.service.planner import Planner as PortPlanner  # noqa: E402
from simumax_tpu_torch.service.ring import HashRing, format_ring_spec  # noqa: E402
from simumax_tpu_torch.service.router import (  # noqa: E402
    HEDGE_MIN_SAMPLES,
    Router,
    route_key,
)
from simumax_tpu_torch.service.server import make_server  # noqa: E402


def Planner(*args, **kw):
    """The port's planner on the CPU (the kernels' plain versions)."""
    kw.setdefault("device", "cpu")
    return PortPlanner(*args, **kw)


MODEL, SYS = "llama3-8b", "tpu_v5e_256"
EST = {"model": MODEL, "strategy": "tp1_pp2_dp4_mbs1", "system": SYS}


# --------------------------------------------------------------------------
# Scenario schema + seeded injection determinism
# --------------------------------------------------------------------------


def test_shipped_scenario_loads_sorted():
    s = load_scenario("service_chaos_killrejoin")
    assert s.probe_s > 0 and s.events
    assert [e["at_s"] for e in s.events] == \
        sorted(e["at_s"] for e in s.events)
    assert s.killed_nodes == [2]
    assert "drop_every=" in s.net_env()


def test_scenario_validation_errors():
    with pytest.raises(ConfigError):
        ChaosScenario({"schema": "nope"})
    base = {"schema": "simumax-service-chaos-v1"}
    with pytest.raises(ConfigError):
        ChaosScenario({**base, "events": [
            {"kind": "nuke", "at_s": 1, "node": 0}]})
    with pytest.raises(ConfigError):
        ChaosScenario({**base, "events": [{"kind": "kill", "node": 0}]})
    with pytest.raises(ConfigError):
        ChaosScenario({**base, "events": [
            {"kind": "kill", "at_s": 1, "node": "n0"}]})
    with pytest.raises(ConfigError):
        load_scenario("no-such-scenario")
    # no faults is a valid (null) scenario
    assert ChaosScenario(base).net_env() is None


def _fill_store(root, n=6):
    from simumax_tpu_torch.service.store import ContentStore

    store = ContentStore(str(root))
    for i in range(n):
        store.put("estimate", f"{'%02x' % i}beef{i:04d}",
                  {"i": i, "payload": "x" * 64})
    return store


def test_corrupt_entries_seeded_deterministic(tmp_path):
    s1 = _fill_store(tmp_path / "a")
    s2 = _fill_store(tmp_path / "b")
    c1 = corrupt_store_entries(s1.root, 3, seed=7)
    c2 = corrupt_store_entries(s2.root, 3, seed=7)
    rel = [os.path.relpath(p, s1.root) for p in c1]
    assert rel == [os.path.relpath(p, s2.root) for p in c2]
    assert len(rel) == 3
    # a different seed picks a different set
    s3 = _fill_store(tmp_path / "c")
    c3 = corrupt_store_entries(s3.root, 3, seed=8)
    assert [os.path.relpath(p, s3.root) for p in c3] != rel

    # the read path detects every corrupted entry and quarantines it
    for path in c1:
        key = os.path.basename(path)[:-len(".entry")]
        assert s1.get("estimate", key) is None
    listing = s1.quarantined()
    assert sorted(e["key"] for e in listing) == sorted(
        os.path.basename(p)[:-len(".entry")] for p in c1)

    # recover() quarantines the same set on an unread store
    rep = s2.recover()
    assert rep["checked"] == 6 and rep["ok"] == 3
    assert sorted(r["key"] for r in rep["quarantined"]) == sorted(
        os.path.basename(p)[:-len(".entry")] for p in c2)


def test_net_chaos_schedule_deterministic():
    a = NetChaos(drop_every=3, delay_every=0, seed=1)
    b = NetChaos(drop_every=3, delay_every=0, seed=1)

    def schedule(nc, n=9):
        out = []
        for _ in range(n):
            try:
                nc.before_send()
                out.append("ok")
            except ConnectionResetError:
                out.append("drop")
        return out

    sa, sb = schedule(a), schedule(b)
    assert sa == sb
    assert sa.count("drop") == 3 and sa[2] == "drop"
    assert a.counters["drops"] == 3

    class FakeRouter:
        def _send(self, node, endpoint, raw_body, headers,
                  hop_timeout):
            return "sent"

    r = FakeRouter()
    NetChaos(drop_every=2, seed=0).install(r)
    # wrapped send: dropped legs surface as the None the router's own
    # retry path already handles
    results = [r._send("w", "/v1/estimate", b"", {}, 1.0)
               for _ in range(4)]
    assert results == ["sent", None, "sent", None]


def test_parse_net_env():
    assert parse_net_env("drop_every=5,delay_every=2,delay_ms=40,"
                         "seed=3") == {
        "drop_every": 5, "delay_every": 2, "delay_ms": 40, "seed": 3}
    assert parse_net_env("junk,drop_every=bad,delay_ms=1") == {
        "delay_ms": 1}


# --------------------------------------------------------------------------
# Ring epochs: live reconfiguration accounting
# --------------------------------------------------------------------------


def test_ring_epoch_and_remap_accounting():
    ring = HashRing([f"n{i}" for i in range(4)])
    assert ring.epoch == 0  # construction is epoch 0, not 4 bumps
    keys = [f"key-{i}" for i in range(2000)]
    before = {k: ring.owner(k) for k in keys}

    ring.remove_node("n2")
    assert ring.epoch == 1
    after = {k: ring.owner(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    # only the departed member's keys remap (to successors), and the
    # remapped share is ~1/N (2x bound absorbs vnode variance)
    assert all(before[k] == "n2" for k in moved)
    assert len(moved) / len(keys) < 2.0 / 4

    ring.add_node("n2")
    assert ring.epoch == 2
    assert {k: ring.owner(k) for k in keys} == before
    assert ring.stats()["epoch"] == 2


# --------------------------------------------------------------------------
# Failure detector: state walk + live ring reconfiguration + rejoin
# --------------------------------------------------------------------------


def _start_node(tmp_path, name, port, spec):
    srv = make_server(Planner(cache_dir=str(tmp_path / name)),
                      "127.0.0.1", port)
    node = attach_fleet(srv, name, spec)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, node


def test_detector_walks_down_and_rejoins(tmp_path):
    # three members; n2's server is shut down after start so its port
    # is a real dead peer (connection refused, the post-SIGKILL shape)
    servers = [make_server(Planner(cache_dir=str(tmp_path / f"n{i}")),
                           "127.0.0.1", 0) for i in range(3)]
    members = {f"n{i}": ("127.0.0.1", s.server_address[1])
               for i, s in enumerate(servers)}
    spec = format_ring_spec(members)
    nodes = []
    for i in (0, 1):
        nodes.append(attach_fleet(servers[i], f"n{i}", spec))
        threading.Thread(target=servers[i].serve_forever,
                         daemon=True).start()
    dead_port = servers[2].server_address[1]
    servers[2].server_close()  # never served: n2 is down from birth

    det = nodes[0].detector
    det.probe_timeout_s = 0.5
    try:
        walk = []
        for _ in range(DOWN_AFTER):
            out = det.probe_once()
            walk.append(out["states"]["n2"])
            assert out["states"]["n1"] == "up"
        # deterministic walk: up until SUSPECT_AFTER, then suspect,
        # down exactly at DOWN_AFTER — the convergence bound the
        # chaos gate holds the fleet to
        assert walk[SUSPECT_AFTER - 1] in ("up", "suspect")
        assert walk[SUSPECT_AFTER] == "suspect"
        assert walk[-1] == "down"
        assert "n2" not in nodes[0].ring.nodes()
        assert nodes[0].ring.epoch == 1
        assert det.counters["removed"] == 1

        # keys owned by the departed member remap to the survivors;
        # the rest stay put (<= ~1/N churn)
        full = HashRing(sorted(members))
        keys = [f"key-{i}" for i in range(500)]
        moved = [k for k in keys
                 if nodes[0].ring.owner(k) != full.owner(k)]
        assert moved and all(full.owner(k) == "n2" for k in moved)
        assert len(moved) / len(keys) < 2.0 / 3

        # rejoin: bring a real n2 up on the same port; one good probe
        # re-adds it and bumps the epoch again
        srv2, node2 = _start_node(tmp_path, "n2", dead_port, spec)
        try:
            out = det.probe_once()
            assert out["states"]["n2"] == "up"
            assert "n2" in nodes[0].ring.nodes()
            assert nodes[0].ring.epoch == 2
            assert det.counters["rejoined"] == 1
        finally:
            srv2.shutdown()
            srv2.server_close()
            node2.close()
    finally:
        for i in (0, 1):
            servers[i].shutdown()
            servers[i].server_close()
        for n in nodes:
            n.close()


# --------------------------------------------------------------------------
# Per-hop deadlines + hedging against a wedged peer
# --------------------------------------------------------------------------


def _wedged_server():
    """A peer that accepts and reads but never answers — the
    SIGSTOPped-process shape a read deadline must bound."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    stop = threading.Event()
    held = []

    def loop():
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            held.append(conn)  # read nothing, answer nothing

    threading.Thread(target=loop, daemon=True).start()

    def close():
        stop.set()
        lsock.close()
        for c in held:
            try:
                c.close()
            except OSError:
                pass

    return lsock.getsockname()[1], close


def _owned_by(ring, node):
    """An estimate body whose route key the given member owns."""
    for seq in range(64):
        body = dict(EST, seq_len=2048 + seq)
        if ring.owner(route_key("/v1/estimate", body)) == node:
            return body
    raise AssertionError(f"no probe body owned by {node}")


def test_hop_deadline_bounds_wedged_peer(tmp_path):
    wport, wclose = _wedged_server()
    try:
        members = {"w": ("127.0.0.1", wport)}
        ring = HashRing(["w"])
        router = Router(ring, "me", members)
        body = dict(EST)
        t0 = time.monotonic()
        fwd = router.forward(
            "/v1/estimate", json.dumps(body).encode(), {}, q=body,
            deadline_s=0.6)
        elapsed = time.monotonic() - t0
        # the budget bounds the hop: no 120 s FORWARD_TIMEOUT stall
        assert fwd is None and elapsed < 5.0
        assert router.counters["hop_timeouts"] >= 1
        assert router.counters["hedges"] == 0
    finally:
        router.close()
        wclose()


def test_hedge_races_successor_for_reads_only(tmp_path):
    wport, wclose = _wedged_server()
    srv = make_server(Planner(cache_dir=str(tmp_path / "live")),
                      "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        members = {"w": ("127.0.0.1", wport),
                   "live": ("127.0.0.1", srv.server_address[1])}
        ring = HashRing(sorted(members))
        router = Router(ring, "me", members)
        # prime the latency window so hedge_delay_s() is armed (p99 of
        # fast forwards, floored at HEDGE_MIN_DELAY_S)
        for _ in range(HEDGE_MIN_SAMPLES):
            router._record_latency(0.01)
        assert router.hedge_delay_s() is not None
        body = _owned_by(ring, "w")
        raw = json.dumps(body).encode()

        # read path, hedge armed: the wedged owner never answers, the
        # hedged second request wins from the successor
        fwd = router.forward("/v1/estimate", raw, {}, q=body,
                             deadline_s=10.0, hedge=True)
        assert fwd is not None and fwd.node == "live"
        assert fwd.status == 200
        assert json.loads(fwd.response.read())
        router.finish(fwd, reuse=False)
        assert router.counters["hedges"] == 1

        # write path (the server never passes hedge=True for
        # /v1/search): same wedged owner, no second request — the
        # budget runs out instead
        before = router.counters["hedges"]
        fwd = router.forward("/v1/search", raw, {}, q=body,
                             deadline_s=0.6, hedge=False)
        assert fwd is None
        assert router.counters["hedges"] == before
    finally:
        router.close()
        srv.shutdown()
        srv.server_close()
        wclose()


def test_search_is_never_hedge_safe():
    # the server-side allowlist is the write-path guard: /v1/search
    # mutates the sweep flight plane, so it must never be hedged —
    # pinned here so a future endpoint addition has to think about it
    safe = server_mod._Handler.HEDGE_SAFE_ENDPOINTS
    assert "/v1/search" not in safe
    assert {"/v1/estimate", "/v1/explain"} <= set(safe)


# --------------------------------------------------------------------------
# Quarantine -> re-pull round trip (crash-consistent recovery)
# --------------------------------------------------------------------------


def test_quarantine_then_repull_round_trip(tmp_path):
    servers, nodes = [], []
    for i in range(2):
        servers.append(make_server(
            Planner(cache_dir=str(tmp_path / f"n{i}")),
            "127.0.0.1", 0))
    spec = format_ring_spec({
        f"n{i}": ("127.0.0.1", s.server_address[1])
        for i, s in enumerate(servers)})
    for i, s in enumerate(servers):
        nodes.append(attach_fleet(s, f"n{i}", spec))
        threading.Thread(target=s.serve_forever, daemon=True).start()
    try:
        owner = nodes[0].ring.owner(route_key("/v1/estimate", EST))
        owner_n = nodes[int(owner[1:])]
        other_n = nodes[1 - int(owner[1:])]
        conn = http.client.HTTPConnection(
            "127.0.0.1", servers[0].server_address[1], timeout=300)
        conn.request("POST", "/v1/estimate", json.dumps(EST),
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 200
        conn.close()
        manifest = owner_n.store.manifest("estimate")
        assert len(manifest) == 1
        key = manifest[0]["key"]
        good = owner_n.store.get("estimate", key)
        assert good is not None

        # replicate to the peer, then corrupt the owner's only copy
        assert other_n.replicator.pull_once()["pulled"] == 1
        assert corrupt_store_entries(owner_n.store.root, 1, seed=0)
        report = owner_n.store.recover()
        assert [r["key"] for r in report["quarantined"]] == [key]
        assert owner_n.store.get("estimate", key) is None
        assert owner_n.store.quarantined()[0]["key"] == key

        # the re-pull restores exactly the quarantined key, and the
        # bytes round-trip bit-identically
        assert owner_n.replicator.pull_once()["pulled"] == 1
        assert owner_n.store.get("estimate", key) == good
        assert owner_n.store.counters["quarantined"] == 1
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for n in nodes:
            n.close()


def test_scenarios_and_injections_are_the_jax_packages(tmp_path):
    """The shipped scenario loads as the JAX package loads it, and the
    same seed corrupts the same entries and parses the same net chaos."""
    from simumax_tpu_torch.service.store import ContentStore, content_key

    port, ref = load_scenario("service_chaos_killrejoin"), \
        jax_chaos.load_scenario("service_chaos_killrejoin")
    assert port.events == ref.events and port.seed == ref.seed
    value = "drop_every=3,delay_every=5,delay_ms=20,seed=4"
    assert parse_net_env(value) == jax_chaos.parse_net_env(value)
    roots = []
    for name in ("port", "jax"):
        store = ContentStore(str(tmp_path / name))
        for i in range(12):
            store.put("estimate", content_key(i), {"i": i})
        roots.append(store.root)
    got = corrupt_store_entries(roots[0], 4, 11)
    want = jax_chaos.corrupt_store_entries(roots[1], 4, 11)
    assert [os.path.relpath(p, roots[0]) for p in got] \
        == [os.path.relpath(p, roots[1]) for p in want]

"""The port's planner fleet (``service/ring.py``, ``router.py``,
``node.py``) held against the JAX package's.

Mirrors ``tests/test_service_fleet.py``: the consistent-hash ring's
stability and balance, whose placements are also held against the JAX
package's ring key by key; routed-vs-direct byte identity over HTTP,
fleet-wide sweep-cell coalescing accounting, node-death recovery, one
trace across the fleet, and stamp-keyed replica pull. The oracle of a
served answer is the JAX package's cache-off planner. Every node's
planner runs with ``device="cpu"`` (the kernels' plain versions), and
``FleetNode`` takes the device of the planner it wraps.

Tolerance: ``==`` on the wire bytes and on placements.
"""

import http.client
import json
import threading
import time

import pytest

pytest.importorskip("torch")

from simumax_tpu.service.planner import Planner as JaxPlanner  # noqa: E402
from simumax_tpu.service.ring import HashRing as JaxHashRing  # noqa: E402
from simumax_tpu.service.router import route_key as jax_route_key  # noqa: E402
from simumax_tpu.service.server import response_bytes as jax_response_bytes  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError  # noqa: E402
from simumax_tpu_torch.observe.telemetry import get_tracer  # noqa: E402
from simumax_tpu_torch.service.node import FleetNode, attach_fleet  # noqa: E402
from simumax_tpu_torch.service.planner import Planner as PortPlanner  # noqa: E402
from simumax_tpu_torch.service.ring import (  # noqa: E402
    HashRing,
    format_ring_spec,
    parse_ring_spec,
)
from simumax_tpu_torch.service.router import route_key  # noqa: E402
from simumax_tpu_torch.service.server import make_server  # noqa: E402


def Planner(*args, **kw):
    """The port's planner on the CPU (the kernels' plain versions)."""
    kw.setdefault("device", "cpu")
    return PortPlanner(*args, **kw)


MODEL, SYS = "llama3-8b", "tpu_v5e_256"
EST = {"model": MODEL, "strategy": "tp1_pp2_dp4_mbs1", "system": SYS}
SEARCH = {"model": MODEL, "system": "tpu_v5p_256", "gbs": 32,
          "world": 32, "pp": "1", "zero": "1"}


# --------------------------------------------------------------------------
# Ring unit tests
# --------------------------------------------------------------------------


def test_ring_placement_is_deterministic():
    r1 = HashRing(["a", "b", "c"])
    r2 = HashRing(["c", "a", "b"])  # insertion order must not matter
    keys = [f"key-{i}" for i in range(512)]
    assert [r1.owner(k) for k in keys] == [r2.owner(k) for k in keys]
    # successors start at the owner and cover every distinct node
    for k in keys[:16]:
        succ = r1.successors(k)
        assert succ[0] == r1.owner(k)
        assert sorted(succ) == ["a", "b", "c"]
        assert r1.successors(k, 2) == succ[:2]


def test_ring_balance_within_bound():
    ring = HashRing([f"n{i}" for i in range(4)])
    bal = ring.balance()
    assert abs(sum(bal.values()) - 1.0) < 1e-9
    # 64 vnodes: every shard within ~25% of the ideal 1/N
    for frac in bal.values():
        assert 0.25 / 1.6 < frac < 0.25 * 1.6


@pytest.mark.parametrize("n", [3, 5])
def test_ring_add_remove_remaps_about_one_nth(n):
    nodes = [f"n{i}" for i in range(n)]
    ring = HashRing(nodes)
    keys = [f"key-{i}" for i in range(2000)]
    before = {k: ring.owner(k) for k in keys}

    ring.add_node("new")
    after_add = {k: ring.owner(k) for k in keys}
    moved = sum(1 for k in keys if before[k] != after_add[k])
    # expected 1/(N+1); bound at 2x to absorb vnode variance
    assert moved / len(keys) < 2.0 / (n + 1)
    # every moved key moved TO the new node, never between old nodes
    assert all(after_add[k] == "new"
               for k in keys if before[k] != after_add[k])

    ring.remove_node("new")
    assert {k: ring.owner(k) for k in keys} == before


def test_ring_membership_errors():
    ring = HashRing(["a"])
    with pytest.raises(ConfigError):
        ring.add_node("a")
    with pytest.raises(ConfigError):
        ring.remove_node("zz")
    ring.remove_node("a")
    with pytest.raises(ConfigError):
        ring.owner("k")
    with pytest.raises(ConfigError):
        HashRing(["a"], vnodes=0)


def test_ring_spec_round_trip_and_errors():
    members = parse_ring_spec("b=127.0.0.1:9002, a=127.0.0.1:9001")
    assert members == {"b": ("127.0.0.1", 9002),
                       "a": ("127.0.0.1", 9001)}
    assert format_ring_spec(members) == \
        "a=127.0.0.1:9001,b=127.0.0.1:9002"
    for bad in ("", "a=127.0.0.1", "a=host:xy",
                "a=h:1,a=h:2", "=h:1"):
        with pytest.raises(ConfigError):
            parse_ring_spec(bad)


def test_route_key_ignores_grid_and_serving_knobs():
    base = dict(SEARCH)
    k = route_key("/v1/search", base)
    # overlapping grids and serving knobs share one owner shard
    assert route_key("/v1/search",
                     {**base, "tp": "1,2,4", "stream": True,
                      "topk": 3}) == k
    # real identity fields do change the shard
    assert route_key("/v1/search", {**base, "gbs": 64}) != k
    assert route_key("/v1/estimate", EST) != k


# --------------------------------------------------------------------------
# Multi-node fleet (in-process nodes on localhost ports)
# --------------------------------------------------------------------------


def _start_fleet(tmp_path, n=3):
    servers, nodes = [], []
    # bind ephemeral first so the spec can name every port before any
    # node starts serving
    for i in range(n):
        srv = make_server(
            Planner(cache_dir=str(tmp_path / f"shard-n{i}")),
            "127.0.0.1", 0)
        servers.append(srv)
    spec = format_ring_spec({
        f"n{i}": ("127.0.0.1", srv.server_address[1])
        for i, srv in enumerate(servers)})
    for i, srv in enumerate(servers):
        nodes.append(attach_fleet(srv, f"n{i}", spec))
        threading.Thread(target=srv.serve_forever,
                         daemon=True).start()
    return servers, nodes, spec


@pytest.fixture()
def fleet(tmp_path):
    servers, nodes, spec = _start_fleet(tmp_path)
    yield servers, nodes, spec
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _req(port, method, path, body=None, headers=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout)
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    conn.request(method, path,
                 json.dumps(body) if body is not None else None, h)
    resp = conn.getresponse()
    data = resp.read()
    hd = dict(resp.getheaders())
    conn.close()
    return resp.status, hd, data


def _ports(servers):
    return [srv.server_address[1] for srv in servers]


def test_forwarded_request_bit_identical_to_direct(fleet):
    servers, nodes, _spec = fleet
    ports = _ports(servers)
    owner = nodes[0].ring.owner(route_key("/v1/estimate", EST))
    non_owner = next(i for i in range(3) if f"n{i}" != owner)
    owner_i = next(i for i in range(3) if f"n{i}" == owner)

    status, h1, d1 = _req(ports[non_owner], "POST", "/v1/estimate",
                          EST)
    assert status == 200 and h1["X-SimuMax-Cache"] == "miss"
    direct = jax_response_bytes(
        JaxPlanner(enabled=False).estimate(MODEL, EST["strategy"], SYS))
    assert d1 == direct

    # the owner served it: a repeat AT the owner is a store hit, and
    # a repeat through the other non-owner relays the hit verbatim
    status, h2, d2 = _req(ports[owner_i], "POST", "/v1/estimate", EST)
    assert h2["X-SimuMax-Cache"] == "hit" and d2 == direct
    other = next(i for i in range(3)
                 if i not in (owner_i, non_owner))
    status, h3, d3 = _req(ports[other], "POST", "/v1/estimate", EST)
    assert h3["X-SimuMax-Cache"] == "hit" and d3 == direct
    assert h3["X-SimuMax-Key"] == h2["X-SimuMax-Key"]
    assert nodes[non_owner].router.counters["forwards"] >= 1

    # loop guard: a pre-forwarded request is served where it lands
    # (cache-off identity bytes, no second hop)
    before = nodes[other].router.counters["forwards"]
    status, _h, d4 = _req(ports[other], "POST", "/v1/estimate", EST,
                          headers={"X-SimuMax-Forwarded": "test"})
    assert status == 200 and d4 == direct
    assert nodes[other].router.counters["forwards"] == before


def test_ring_state_endpoint(fleet):
    servers, _nodes, _spec = fleet
    status, _h, data = _req(_ports(servers)[1], "GET", "/ring/state")
    assert status == 200
    state = json.loads(data)
    assert state["node_id"] == "n1"
    assert state["members"]["n1"]
    assert sorted(state["ring"]["nodes"]) == ["n0", "n1", "n2"]
    for key in ("router", "flights", "replicator"):
        assert key in state


def test_fleet_coalescing_sums_to_union(fleet):
    """Two overlapping grids, each evaluated on a DIFFERENT node (the
    loop-guard header pins them where they land, as after a ring
    change): the wire-level flight table must make the fleet evaluate
    exactly the union of cells, never a shared cell twice."""
    servers, nodes, _spec = fleet
    ports = _ports(servers)
    q1 = {**SEARCH, "tp": "1,2"}       # 6 cells
    q2 = {**SEARCH, "tp": "1,2,4"}     # 9 cells (superset)
    results = {}

    def run(tag, port, q):
        results[tag] = _req(
            port, "POST", "/v1/search", q,
            headers={"X-SimuMax-Forwarded": "pin"})

    threads = [
        threading.Thread(target=run, args=("a", ports[1], q1)),
        threading.Thread(target=run, args=("b", ports[2], q2)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)

    def cells(headers):
        out = {"cached": 0, "evaluated": 0, "coalesced": 0}
        for part in headers["X-SimuMax-Cells"].split():
            k, v = part.split("=")
            out[k] = int(v)
        return out

    sa, ha, da = results["a"]
    sb, hb, db = results["b"]
    assert sa == 200 and sb == 200
    ca, cb = cells(ha), cells(hb)
    # each response accounts for its own full grid...
    assert sum(ca.values()) == 6 and sum(cb.values()) == 9
    # ...and the FLEET evaluated exactly the union, once
    assert ca["evaluated"] + cb["evaluated"] == 9
    assert ca["coalesced"] + cb["coalesced"] == 6
    # coalesced/cached cells are bit-identical to evaluated ones
    direct = jax_response_bytes(JaxPlanner(enabled=False).search(
        MODEL, "tpu_v5p_256", 32, world=32, tp_list=(1, 2, 4),
        pp_list=(1,), zero_list=(1,), topk=5))
    assert db == direct
    follows = sum(
        n.flights.stats()["remote"]["remote_follows"] for n in nodes)
    assert follows >= 1


def test_node_death_recovery(tmp_path):
    """Kill the owner of a key: a request through a surviving node
    must be answered by the successor (or locally), never hang."""
    servers, nodes, _spec = _start_fleet(tmp_path)
    owner = nodes[0].ring.owner(route_key("/v1/estimate", EST))
    owner_i = int(owner[1:])
    try:
        ports = _ports(servers)
        victim = servers[owner_i]
        victim.shutdown()
        victim.server_close()

        alive = next(i for i in range(3) if i != owner_i)
        t0 = time.monotonic()
        status, _h, data = _req(ports[alive], "POST", "/v1/estimate",
                                EST, timeout=120)
        elapsed = time.monotonic() - t0
        assert status == 200
        assert data == jax_response_bytes(JaxPlanner(enabled=False).estimate(
            MODEL, EST["strategy"], SYS))
        assert elapsed < 60.0
        stats = nodes[alive].router.stats()
        assert stats["retries"] >= 1 or stats["forwards"] >= 1
    finally:
        for i, srv in enumerate(servers):
            if f"n{i}" != owner:
                srv.shutdown()
                srv.server_close()


def test_single_trace_spans_whole_fleet(fleet):
    """One routed request = one trace id across the router hop and the
    owner node (satellite: X-SimuMax-Trace propagation)."""
    servers, nodes, _spec = fleet
    ports = _ports(servers)
    tracer = get_tracer()
    tracer.configure(enabled=True)
    try:
        q = {**EST, "strategy": "tp1_pp1_dp8_mbs1"}
        owner = nodes[0].ring.owner(route_key("/v1/estimate", q))
        non_owner = next(i for i in range(3) if f"n{i}" != owner)
        status, h, _d = _req(ports[non_owner], "POST",
                             "/v1/estimate", q)
        assert status == 200
        tid = h["X-SimuMax-Trace"]
        spans = tracer.pop_trace(tid)
        names = [s.name for s in spans]
        # relaying node's request span, its forward hop, and the
        # owner's request span all share the one trace
        assert names.count("POST /v1/estimate") >= 2
        assert "router_forward" in names
        assert all(s.trace_id == tid for s in spans)
    finally:
        tracer.configure(enabled=False)


def test_replica_pull_is_stamp_keyed(fleet):
    servers, nodes, _spec = fleet
    ports = _ports(servers)
    # seed every shard: estimates land on their owners via routing
    for i, strat in enumerate(("tp1_pp2_dp4_mbs1", "tp2_pp1_dp4_mbs1",
                               "tp1_pp1_dp8_mbs1", "tp4_pp1_dp2_mbs1")):
        q = {**EST, "strategy": strat}
        status, _h, _d = _req(ports[i % 3], "POST", "/v1/estimate", q)
        assert status == 200
    status, _h, data = _req(ports[0], "POST", "/ring/replicate", {})
    assert status == 200
    first = json.loads(data)
    assert first["checked"] >= 1
    # a second round re-checks but pulls nothing: freshness is the
    # peer's (path, mtime, size) stamp
    status, _h, data = _req(ports[0], "POST", "/ring/replicate", {})
    second = json.loads(data)
    assert second["pulled"] == 0
    if first["pulled"]:
        assert nodes[0].replicator.counters["pulled"] == \
            first["pulled"]


def test_ring_rpc_on_non_fleet_server(tmp_path):
    srv = make_server(Planner(cache_dir=str(tmp_path / "solo")),
                      "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        status, _h, data = _req(srv.server_address[1], "POST",
                                "/ring/cells/claim", {"key": "k"})
        assert status == 404 and "error" in json.loads(data)
    finally:
        srv.shutdown()
        srv.server_close()


def test_warm_route_filter_skips_remote_sweeps(fleet):
    from simumax_tpu_torch.service.node import warm_route_filter
    from simumax_tpu_torch.service.warmer import Warmer

    _servers, nodes, _spec = fleet
    owner = nodes[0].ring.owner(route_key("/v1/search", SEARCH))
    owner_node = next(n for n in nodes if n.node_id == owner)
    other_node = next(n for n in nodes if n.node_id != owner)

    warmer = Warmer(lambda spec: 0, max_jobs=2)
    warmer.route_filter = warm_route_filter(other_node)
    try:
        warmer.offer({**SEARCH, "tp": "1,2"})
        assert warmer.counters["skipped_remote"] == 1
        warmer.route_filter = warm_route_filter(owner_node)
        warmer.offer({**SEARCH, "tp": "1,2"})
        assert warmer.counters["skipped_remote"] == 1
        assert warmer.counters["offered"] >= 1
    finally:
        warmer.close()


def test_ring_placements_are_the_jax_packages():
    keys = [f"key-{i}" for i in range(512)]
    for nodes in (["a", "b", "c"], [f"n{i}" for i in range(5)]):
        port, ref = HashRing(nodes), JaxHashRing(nodes)
        assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
        assert [port.successors(k) for k in keys[:32]] == [ref.successors(k) for k in keys[:32]]
        assert port.balance() == ref.balance()
    bodies = [("/v1/estimate", EST), ("/v1/search", SEARCH),
              ("/v1/search", {**SEARCH, "gbs": 64})]
    assert [route_key(p, b) for p, b in bodies] == [jax_route_key(p, b) for p, b in bodies]


def test_fleet_node_shares_its_planners_flights(tmp_path):
    members = {"n0": ("127.0.0.1", 1)}
    planner = Planner(cache_dir=str(tmp_path / "solo"))
    node = FleetNode("n0", members, planner)
    assert planner.cell_flights is node.flights and node.store is planner.store

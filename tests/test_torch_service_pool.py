"""The port's production serving path (``service/pool.py``,
``coalesce.py``, ``warmer.py``, the server's admission control) held
against the JAX package's answers.

Mirrors ``tests/test_service_pool.py``: pooled-vs-threaded identity,
exact cell-coalescing accounting under an 8-client overlapping-grid
hammer, warmer eviction safety, admission-control shedding (429 +
Retry-After, admitted never dropped), and worker-death recovery. Where
the JAX test holds an answer against its own package's cache-off
planner, the oracle here is the JAX package's cache-off planner.

Every planner and pool of the port runs with ``device="cpu"`` (the
kernels' plain versions); the pool's workers fork, as this process has
not initialised CUDA. Every request, pool and thread waits with a bounded
deadline.

Tolerance: ``==`` on the wire bytes and on canonical JSON.
"""

import http.client
import json
import os
import signal
import threading
import time

import pytest

pytest.importorskip("torch")

from simumax_tpu.service.planner import Planner as JaxPlanner  # noqa: E402
from simumax_tpu.service.pool import evaluate_query as jax_evaluate_query  # noqa: E402
from simumax_tpu.service.server import response_bytes as jax_response_bytes  # noqa: E402
from simumax_tpu_torch.observe.telemetry import MetricsRegistry  # noqa: E402
from simumax_tpu_torch.service.coalesce import CellFlightTable  # noqa: E402
from simumax_tpu_torch.service.planner import Planner as PortPlanner  # noqa: E402
from simumax_tpu_torch.service.pool import WorkerPool as PortWorkerPool  # noqa: E402
from simumax_tpu_torch.service.server import (  # noqa: E402
    AdmissionController,
    make_server,
)
from simumax_tpu_torch.service.store import ContentStore  # noqa: E402
from simumax_tpu_torch.service.warmer import HEADROOM_FRACTION, Warmer  # noqa: E402

MODEL, STRAT, SYS = "llama3-8b", "tp1_pp2_dp4_mbs1", "tpu_v5e_256"
EST = {"model": MODEL, "strategy": STRAT, "system": SYS}
#: the known-evaluable probe grid (llama3-8b fits on v5p, nothing
#: prunes)
SEARCH = {"model": MODEL, "system": "tpu_v5p_256", "gbs": 32,
          "world": 32, "tp": "1,2", "pp": "1", "zero": "1", "topk": 3}


def Planner(*args, **kw):
    """The port's planner on the CPU (the kernels' plain versions)."""
    kw.setdefault("device", "cpu")
    return PortPlanner(*args, **kw)


def WorkerPool(*args, **kw):
    """The port's pool, its workers' planners on the CPU."""
    kw.setdefault("device", "cpu")
    return PortWorkerPool(*args, **kw)


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    conn.request("POST", path, json.dumps(body), hdrs)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()


# --------------------------------------------------------------------------
# pooled vs threaded bit-identity
# --------------------------------------------------------------------------


def test_pooled_vs_threaded_bit_identity(tmp_path):
    registry = MetricsRegistry()
    pool = WorkerPool(cache_dir=str(tmp_path / "pooled"), workers=2,
                      registry=registry)
    pooled = make_server(Planner(store=pool.store), "127.0.0.1", 0,
                         pool=pool)
    threaded = make_server(
        Planner(cache_dir=str(tmp_path / "threaded")), "127.0.0.1", 0)
    _serve(pooled)
    _serve(threaded)
    try:
        pport = pooled.server_address[1]
        tport = threaded.server_address[1]
        off = JaxPlanner(enabled=False)
        cases = [
            ("/v1/estimate", EST,
             lambda: off.estimate(MODEL, STRAT, SYS)),
            ("/v1/explain", EST,
             lambda: off.explain(MODEL, STRAT, SYS)),
            ("/v1/search", SEARCH,
             lambda: off.search(
                 MODEL, "tpu_v5p_256", 32, world=32, tp_list=(1, 2),
                 pp_list=(1,), zero_list=(1,), topk=3)),
        ]
        for ep, body, direct in cases:
            ps, _ph, pd = _post(pport, ep, body)
            ts, _th, td = _post(tport, ep, body)
            assert ps == ts == 200, ep
            assert pd == td == jax_response_bytes(direct()), ep
            # the hot path: a repeat is served from the pool's
            # response memory cache, byte-identical
            ps2, ph2, pd2 = _post(pport, ep, body)
            assert ps2 == 200 and pd2 == pd, ep
            assert ph2.get("X-SimuMax-Cache") == "hit", ep
        assert pool.memcache.stats()["hits"] >= len(cases)
    finally:
        pooled.shutdown()
        pooled.server_close()
        threaded.shutdown()
        threaded.server_close()


# --------------------------------------------------------------------------
# cell coalescing
# --------------------------------------------------------------------------


def test_cell_flight_table_claim_publish_abandon():
    table = CellFlightTable(registry=MetricsRegistry())
    flight, leader = table.claim("cell-a")
    assert leader
    follower, lead2 = table.claim("cell-a")
    assert not lead2 and follower is flight
    outcome = {"status": "ok", "row": {"mfu": 1.0}, "error": None}
    table.publish("cell-a", outcome)
    assert table.wait(follower) == outcome
    # abandoned claims wake followers with None (they re-evaluate)
    f2, leader = table.claim("cell-b")
    assert leader
    w2, _ = table.claim("cell-b")
    table.abandon("cell-b")
    assert table.wait(w2, timeout=5.0) is None
    assert table.inflight() == 0
    assert table.counters == {"leads": 2, "follows": 2, "abandoned": 1}


def test_coalescing_counters_exact_under_overlapping_hammer(tmp_path):
    """8 concurrent clients sweep overlapping grids through one
    planner: every demanded cell is evaluated exactly once across the
    whole hammer, each client's serving accounting is exact, and the
    flight-table counters balance."""
    planner = Planner(cache_dir=str(tmp_path / "store"),
                      registry=MetricsRegistry())
    narrow = dict(tp_list=(1, 2), pp_list=(1,), zero_list=(1,))
    wide = dict(tp_list=(1, 2, 4), pp_list=(1,), zero_list=(1,))
    barrier = threading.Barrier(8)
    results = [None] * 8
    errors = []

    def client(i):
        grid = narrow if i % 2 else wide
        barrier.wait(timeout=60)
        try:
            # distinct topk per client: byte-distinct queries, so only
            # the CELL layer can dedup the overlap
            results[i] = planner.search(
                MODEL, "tpu_v5p_256", 32, world=32, topk=i + 1,
                **grid, with_meta=True)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert not errors
    assert all(r is not None for r in results)

    # revisits: both grids are now fully store-served, and the cached
    # count of a revisit IS the grid's demanded-cell count
    demanded = {}
    for name, grid in (("narrow", narrow), ("wide", wide)):
        _payload, meta = planner.search(
            MODEL, "tpu_v5p_256", 32, world=32, topk=9,
            **grid, with_meta=True)
        assert meta["cells_evaluated"] == 0, name
        assert meta["cells_coalesced"] == 0, name
        demanded[name] = meta["cells_cached"]
    assert 0 < demanded["narrow"] < demanded["wide"]

    total_evaluated = total_coalesced = 0
    for i, (_payload, meta) in enumerate(results):
        want = demanded["narrow"] if i % 2 else demanded["wide"]
        got = (meta["cells_evaluated"] + meta["cells_cached"]
               + meta["cells_coalesced"])
        assert got == want, f"client {i}: {meta}"
        total_evaluated += meta["cells_evaluated"]
        total_coalesced += meta["cells_coalesced"]
    # exactly-once evaluation: the union of both grids is the wide one
    assert total_evaluated == demanded["wide"]
    counters = planner.cell_flights.stats()
    assert counters["follows"] == total_coalesced
    assert counters["abandoned"] == 0
    assert counters["inflight"] == 0
    # the hammer genuinely overlapped (8 clients, a barrier, and
    # multi-second evaluations: claims land together)
    assert total_coalesced > 0

    # bit-identity: coalesced/cached serving never leaks into payloads
    off = JaxPlanner(enabled=False)
    for name, grid in (("narrow", narrow), ("wide", wide)):
        direct = off.search(MODEL, "tpu_v5p_256", 32, world=32,
                            topk=3, **grid)
        for i, (payload, _meta) in enumerate(results):
            if (narrow if i % 2 else wide) is grid and i + 1 == 3:
                assert json.dumps(payload, sort_keys=True) \
                    == json.dumps(direct, sort_keys=True), name


# --------------------------------------------------------------------------
# speculative warmer
# --------------------------------------------------------------------------


def test_warmer_end_to_end_precomputes_neighbor_cells(tmp_path):
    """A served tp=[1] sweep warms its neighbor cells; the follow-up
    tp=[1,2] sweep is then fully store-served (0 evaluations)."""
    planner = Planner(cache_dir=str(tmp_path / "store"),
                      registry=MetricsRegistry())
    body = {"model": MODEL, "system": "tpu_v5p_256", "gbs": 32,
            "world": 32, "tp": "1", "cp": "1", "ep": "1", "pp": "1",
            "zero": "1", "topk": 3}
    planner.search(MODEL, "tpu_v5p_256", 32, world=32, tp_list=(1,),
                   cp_list=(1,), ep_list=(1,), pp_list=(1,),
                   zero_list=(1,), topk=3)
    from simumax_tpu_torch.service.warmer import warm_cells

    warmer = Warmer(runner=lambda spec: warm_cells(planner, spec),
                    store=planner.store, registry=MetricsRegistry())
    try:
        warmer.offer(body)
        assert warmer.drain(timeout=300.0)
        stats = warmer.stats()
        assert stats["warmed_jobs"] == 1 and stats["errors"] == 0
        assert stats["warmed_cells"] > 0
        # duplicate offers of the same spec are dropped, not re-warmed
        warmer.offer(body)
        assert warmer.drain(timeout=30.0)
        assert warmer.stats()["duplicate"] == 1
    finally:
        warmer.close()
    _payload, meta = planner.search(
        MODEL, "tpu_v5p_256", 32, world=32, tp_list=(1, 2),
        cp_list=(1,), ep_list=(1,), pp_list=(1,), zero_list=(1,),
        topk=3, with_meta=True)
    assert meta["cells_evaluated"] == 0
    assert meta["cache"] == "hit"


def test_warmer_never_evicts_hot_entries(tmp_path):
    """A store above its headroom fraction is never warmed into: the
    job is skipped (counted) and every hot entry survives."""
    store = ContentStore(str(tmp_path / "store"), max_bytes=8192,
                         registry=MetricsRegistry())
    hot = {}
    i = 0
    while store.stats()["total_bytes"] \
            <= HEADROOM_FRACTION * store.max_bytes:
        key = f"hot-{i}"
        hot[key] = {"payload": "x" * 64, "i": i}
        store.put("bench", key, hot[key])
        i += 1
    ran = []
    warmer = Warmer(runner=lambda spec: ran.append(spec) or 1,
                    store=store, registry=MetricsRegistry())
    try:
        warmer.offer(dict(SEARCH))
        assert warmer.drain(timeout=30.0)
        stats = warmer.stats()
        assert stats["skipped_headroom"] == 1
        assert stats["warmed_jobs"] == 0 and not ran
        for key, payload in hot.items():
            assert store.get("bench", key) == payload
    finally:
        warmer.close()


# --------------------------------------------------------------------------
# admission control
# --------------------------------------------------------------------------


def test_admission_priority_headroom_exact():
    adm = AdmissionController(2, registry=MetricsRegistry())
    assert adm.try_admit("normal") and adm.try_admit("normal")
    assert not adm.try_admit("normal")   # at budget
    assert not adm.try_admit("low")      # low sheds at half budget
    assert adm.try_admit("high")         # high rides 1.5x headroom
    assert adm.stats()["admitted"] == 3
    assert adm.stats()["rejected"] == 2
    for _ in range(3):
        adm.release()
    assert adm.load() == 0
    assert adm.retry_after_s() >= 1


def test_admission_sheds_429_and_never_drops_admitted(tmp_path):
    adm = AdmissionController(1, registry=MetricsRegistry())
    srv = make_server(Planner(cache_dir=str(tmp_path / "store")),
                      "127.0.0.1", 0, admission=adm)
    _serve(srv)
    try:
        port = srv.server_address[1]
        statuses = []
        lock = threading.Lock()
        barrier = threading.Barrier(12)

        def client(i):
            # distinct cold bodies: nothing is served from cache, so
            # the single admitted slot stays busy and shedding engages
            body = {"model": MODEL, "system": SYS,
                    "strategy": {**json.loads(json.dumps(
                        _strategy_dict())), "micro_batch_num": 2 + i}}
            barrier.wait(timeout=60)
            status, headers, data = _post(port, "/v1/estimate", body)
            with lock:
                statuses.append((status, headers, data))

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        codes = [s for s, _h, _d in statuses]
        # the admission contract: every request answered, nothing hung
        assert len(codes) == 12 and set(codes) <= {200, 429}
        assert codes.count(200) >= 1 and codes.count(429) >= 1
        for status, headers, data in statuses:
            if status == 429:
                assert int(headers["Retry-After"]) >= 1
                assert "overloaded" in json.loads(data)["error"]
        stats = adm.stats()
        assert stats["admitted"] == codes.count(200)
        assert stats["rejected"] == codes.count(429)
        assert stats["load"] == 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_shed_429_keeps_keepalive_connection_clean(tmp_path):
    """Regression: a shed must drain the unread request body, or the
    next request on the keep-alive connection is parsed out of the
    leftover bytes (a spurious 400)."""
    srv = make_server(Planner(cache_dir=str(tmp_path / "store")),
                      "127.0.0.1", 0,
                      admission=AdmissionController(
                          0, registry=MetricsRegistry()))
    _serve(srv)
    try:
        port = srv.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=60)
        for _ in range(3):
            conn.request("POST", "/v1/estimate", json.dumps(EST),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == 429
            assert "overloaded" in json.loads(body)["error"]
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()


def _strategy_dict():
    from simumax_tpu_torch.core.config import get_strategy_config

    return get_strategy_config(STRAT).to_dict()


# --------------------------------------------------------------------------
# worker-death recovery
# --------------------------------------------------------------------------


def test_worker_death_recovery_retries_not_hangs(tmp_path):
    """SIGKILL a worker mid-query: the request is retried once on a
    respawned worker and answers bit-identically — never hung."""
    pool = WorkerPool(cache_dir=str(tmp_path / "store"), workers=2,
                      registry=MetricsRegistry())
    try:
        body = {"model": MODEL, "system": "tpu_v5p_256", "gbs": 32,
                "world": 32, "tp": "1,2,4", "pp": "1,2", "zero": "1",
                "topk": 3}
        future = pool.submit("/v1/search", body)
        victim = None
        deadline = time.monotonic() + 60.0
        while victim is None and time.monotonic() < deadline:
            for w in pool._workers:
                if w.inflight is not None:
                    victim = w.process.pid
                    break
            else:
                time.sleep(0.001)
        assert victim is not None, "query never reached a worker"
        os.kill(victim, signal.SIGKILL)
        assert future.wait(timeout=300.0), "retried request hung"
        assert future.status == 200
        stats = pool.stats()
        assert stats["restarts"] >= 1
        assert stats["retries"] == 1
        direct_status, direct_payload, _meta = jax_evaluate_query(
            JaxPlanner(enabled=False), "/v1/search", body)
        assert direct_status == 200
        assert future.payload == direct_payload
        # the pool stays healthy: a fresh query round-trips
        status, payload, _meta = pool.serve("/v1/estimate", EST,
                                            timeout=300.0)
        assert status == 200
        assert payload == jax_response_bytes(
            JaxPlanner(enabled=False).estimate(MODEL, STRAT, SYS))
    finally:
        pool.close()


def test_pool_workers_replay_on_the_pools_device(tmp_path):
    """A pooled ``/v1/faults`` replays where the pool was told to (the
    kernel's plain version here) and answers as the JAX package's scalar
    engine; the same pool asked for the card refuses the query on a
    machine without one, instead of replaying on the CPU."""
    import torch

    from simumax_tpu.perf import PerfLLM as JaxPerfLLM
    from simumax_tpu.service.store import normalized as jax_normalized
    from simumax_tpu.simulator.faults import ReplayOptions as JaxReplayOptions

    q = {**EST, "monte_carlo": 3, "seed": 5, "horizon": 10}
    ref = JaxPerfLLM().configure(STRAT, MODEL, SYS)
    ref.run_estimate()
    want = jax_response_bytes(jax_normalized(ref.analyze_faults(
        n_scenarios=3, seed=5, horizon_steps=10,
        options=JaxReplayOptions(replay_backend="numpy"))))
    devices = ["cpu"] if torch.cuda.is_available() else ["cpu", "cuda"]
    for device in devices:
        pool = PortWorkerPool(cache_dir=str(tmp_path / device), workers=1, device=device,
                              registry=MetricsRegistry())
        try:
            assert pool.device == device
            status, payload, _meta = pool.serve("/v1/faults", q, timeout=300.0)
        finally:
            pool.close()
        if device == "cpu":
            assert status == 200 and payload == want
        else:
            assert status == 500 and b"cuda" in payload.lower()

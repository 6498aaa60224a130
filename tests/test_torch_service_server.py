"""The port's HTTP planning server (``service/server.py``) held against
the JAX package's answers.

Mirrors ``tests/test_service_server.py`` (its CLI-driven cases are
mirrored in ``tests/test_torch_cli.py``; its ``bench_service.py`` smoke
times the JAX package, which the port does not bench): every endpoint over the
wire, NDJSON streaming, concurrent single-flight, ``/healthz``,
``/stats`` and ``/metrics``. Each endpoint's body is held against the
JAX package's cache-off answer; ``/v1/faults`` against the JAX
package's analysis on its scalar engine (its jax backend answers 500 in
some sandboxes, ROADMAP queue C); ``/v1/search`` with the batched engine
against the JAX package's numpy fold. The server's planner runs with
``device="cpu"``: the replay and fold kernels' plain versions.

Tolerance: ``==`` on the wire bytes (``response_bytes``).
"""

import http.client
import json
import threading
import time

import pytest

pytest.importorskip("torch")

from simumax_tpu.perf import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.search import batched as jax_batched  # noqa: E402
from simumax_tpu.service.planner import Planner as JaxPlanner  # noqa: E402
from simumax_tpu.service.server import response_bytes as jax_response_bytes  # noqa: E402
from simumax_tpu.service.store import normalized as jax_normalized  # noqa: E402
from simumax_tpu.simulator.faults import ReplayOptions as JaxReplayOptions  # noqa: E402
from simumax_tpu_torch.service.planner import Planner  # noqa: E402
from simumax_tpu_torch.service.server import make_server, response_bytes  # noqa: E402

MODEL, STRAT, SYS = "llama3-8b", "tp1_pp2_dp4_mbs1", "tpu_v5e_256"
EST = {"model": MODEL, "strategy": STRAT, "system": SYS}


@pytest.fixture()
def server(tmp_path):
    srv = make_server(Planner(cache_dir=str(tmp_path / "srv-store"), device="cpu"),
                      "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def _req(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=300)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, headers, data


def test_healthz_and_404(server):
    status, _h, data = _req(server, "GET", "/healthz")
    assert status == 200 and json.loads(data)["status"] == "ok"
    status, _h, data = _req(server, "GET", "/nope")
    assert status == 404 and "error" in json.loads(data)


def test_estimate_bit_identical_and_cache_headers(server):
    status, h1, d1 = _req(server, "POST", "/v1/estimate", EST)
    assert status == 200 and h1["X-SimuMax-Cache"] == "miss"
    status, h2, d2 = _req(server, "POST", "/v1/estimate", EST)
    assert status == 200 and h2["X-SimuMax-Cache"] == "hit"
    assert d1 == d2 and h1["X-SimuMax-Key"] == h2["X-SimuMax-Key"]
    assert d1 == jax_response_bytes(JaxPlanner(enabled=False).estimate(MODEL, STRAT, SYS))


def test_explain_and_simulate_endpoints(server):
    status, _h, data = _req(server, "POST", "/v1/explain", EST)
    assert status == 200
    assert data == jax_response_bytes(JaxPlanner(enabled=False).explain(MODEL, STRAT, SYS))
    status, _h, data = _req(server, "POST", "/v1/simulate", {**EST, "granularity": "chunk"})
    assert status == 200
    assert json.loads(data)["end_time_ms"] > 0
    assert data == jax_response_bytes(
        JaxPlanner(enabled=False).simulate(MODEL, STRAT, SYS, granularity="chunk",
                                           track_memory=False))


def test_faults_endpoint_seeded(server):
    q = {**EST, "monte_carlo": 3, "seed": 5, "horizon": 10}
    status, h1, d1 = _req(server, "POST", "/v1/faults", q)
    assert status == 200 and h1["X-SimuMax-Cache"] == "miss"
    status, h2, d2 = _req(server, "POST", "/v1/faults", q)
    assert d1 == d2 and h2["X-SimuMax-Cache"] == "hit"
    ref = JaxPerfLLM().configure(STRAT, MODEL, SYS)
    ref.run_estimate()
    assert d1 == jax_response_bytes(jax_normalized(ref.analyze_faults(
        n_scenarios=3, seed=5, horizon_steps=10,
        options=JaxReplayOptions(replay_backend="numpy"))))


def test_bad_requests_return_400_family(server):
    status, _h, data = _req(server, "POST", "/v1/estimate",
                            {"model": "no-such-model", "strategy": STRAT, "system": SYS})
    assert status == 400 and "error" in json.loads(data)
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    conn.request("POST", "/v1/estimate", "{not json", {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()
    conn.close()


def test_search_stream_ndjson(server):
    q = {"model": MODEL, "system": "tpu_v5p_256", "gbs": 32, "world": 32, "tp": "1,2",
         "pp": "1", "zero": "1", "stream": True}
    status, headers, data = _req(server, "POST", "/v1/search", q)
    assert status == 200
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in data.decode().strip().splitlines()]
    assert len([ln for ln in lines if "cell" in ln]) == 6
    result = lines[-2]["result"]
    assert lines[-1]["serving"]["cells_evaluated"] == 6
    status, _h, data2 = _req(server, "POST", "/v1/search", q)
    parsed2 = [json.loads(ln) for ln in data2.decode().strip().splitlines()]
    assert parsed2[-1]["serving"]["cells_cached"] == 6
    assert parsed2[-2]["result"] == result
    q2 = {k: v for k, v in q.items() if k != "stream"}
    _s, h3, body_warm = _req(server, "POST", "/v1/search", q2)
    assert h3["X-SimuMax-Cache"] == "hit"
    assert "cached=6" in h3["X-SimuMax-Cells"]
    assert body_warm == jax_response_bytes(JaxPlanner(enabled=False).search(
        MODEL, "tpu_v5p_256", 32, world=32, tp_list=(1, 2), pp_list=(1,), zero_list=(1,),
        topk=5))


@pytest.mark.parametrize("fold_backend", ["auto", "cuda"])
def test_batched_search_endpoint_equals_the_jax_packages(server, monkeypatch, fold_backend):
    """``"engine": "batched"`` answers as the JAX package's numpy fold,
    with the scorer's default fold backend (``auto``: a grid sweep's
    candidate groups stay below the kernel's dispatch floor and fold on
    numpy) and with every pipeline fold sent to the kernel (``cuda``:
    its plain version here)."""
    from simumax_tpu_torch.search import batched as port_batched
    from simumax_tpu_torch.search import executor as port_executor

    monkeypatch.setattr(jax_batched, "jax_available", lambda: False)
    monkeypatch.setattr(port_executor, "_SCORERS", {})
    monkeypatch.setattr(port_executor, "_batched_scorer",
                        lambda m, s, device="cuda": port_batched.BatchedScorer(
                            m, s, backend=fold_backend, device=device))
    folded = []
    real = port_batched._fold_members_cuda

    def counting(members, *args, **kw):
        folded.append(len(members))
        return real(members, *args, **kw)

    monkeypatch.setattr(port_batched, "_fold_members_cuda", counting)
    q = {"model": MODEL, "system": "tpu_v5p_256", "gbs": 64, "world": 64, "tp": "1,2",
         "pp": "2,4", "zero": "1", "topk": 3, "engine": "batched"}
    status, h1, d1 = _req(server, "POST", "/v1/search", q)
    assert status == 200
    assert bool(folded) == (fold_backend == "cuda")
    status, h2, d2 = _req(server, "POST", "/v1/search", q)
    assert status == 200 and h2["X-SimuMax-Cache"] == "hit" and d1 == d2
    assert d1 == jax_response_bytes(JaxPlanner(enabled=False).search(
        MODEL, "tpu_v5p_256", 64, world=64, tp_list=(1, 2), pp_list=(2, 4), zero_list=(1,),
        topk=3, engine="batched"))


def test_concurrent_identical_queries_single_evaluation(server, monkeypatch):
    """N concurrent identical requests: the leader's evaluation is held
    until the other N - 1 have joined its flight, so the count is exact
    however the handler threads are scheduled."""
    from simumax_tpu_torch import perf as port_perf

    n = 6
    planner = server.planner
    real = port_perf.PerfLLM.run_estimate

    def held(self, *args, **kw):
        deadline = time.monotonic() + 60.0
        while planner.counters["singleflight_waits"] < n - 1:
            assert time.monotonic() < deadline, "the followers never joined the flight"
            time.sleep(0.001)
        return real(self, *args, **kw)

    monkeypatch.setattr(port_perf.PerfLLM, "run_estimate", held)
    out = [None] * n

    def hit(i):
        out[i] = _req(server, "POST", "/v1/estimate", EST)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None and r[0] == 200 for r in out)
    assert len({d for _s, _h, d in out}) == 1
    _s, _h, data = _req(server, "GET", "/stats")
    stats = json.loads(data)
    assert stats["planner"]["evaluations"] == 1
    assert stats["requests"]["/v1/estimate"] == n


def test_stats_shape(server):
    _req(server, "POST", "/v1/estimate", EST)
    _s, _h, data = _req(server, "GET", "/stats")
    stats = json.loads(data)
    assert stats["requests_total"] >= 1 and stats["qps"] > 0
    assert "/v1/estimate" in stats["latency"]
    lat = stats["latency"]["/v1/estimate"]
    assert lat["p99_ms"] >= lat["p50_ms"] >= 0
    assert stats["store"]["counters"]["puts"] >= 1
    assert stats["enabled"] is True


def test_metrics_render_the_replay_cache_gauges(server):
    _req(server, "POST", "/v1/estimate", EST)
    status, headers, data = _req(server, "GET", "/metrics")
    assert status == 200
    body = data.decode()
    for name in ("replay_compile_cache_shapes", "replay_compile_cache_capacity",
                 "http_requests_total", "planner_ops_total"):
        assert name in body, name


def test_make_server_builds_its_planner_for_the_device(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMUMAX_TPU_CACHE_DIR", str(tmp_path / "default-store"))
    srv = make_server(port=0, device="cpu")
    try:
        assert srv.planner.device == "cpu"
    finally:
        srv.server_close()
    assert response_bytes({"b": 1, "a": [1.5]}) == jax_response_bytes({"b": 1, "a": [1.5]})

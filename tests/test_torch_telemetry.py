"""The port's telemetry (``observe/telemetry.py``) and the surfaces that
mirror into it: ``Diagnostics`` counters, the simulator's ``des_*``
progress gauges, the reporter's trace ids, the fault replay's
counters; and its closed metric catalogue, held against the metric
names the port's sources use. The gauges are compared with the JAX
package's after the same runs (equal values)."""

import io
import json
import os
import re

import pytest

pytest.importorskip("torch")

from simumax_tpu.observe.telemetry import get_registry as jax_registry  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError  # noqa: E402
from simumax_tpu_torch.core.records import Diagnostics  # noqa: E402
from simumax_tpu_torch.observe import telemetry as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "simumax_tpu_torch")
METRIC_CALL = re.compile(r'\.(counter|gauge|histogram)\(\s*"([a-z_]+)"')


@pytest.fixture()
def tracer():
    t = T.Tracer(registry=T.MetricsRegistry())
    t.enabled = True
    return t


def test_the_catalogue_is_closed_over_the_ports_sources():
    """Every literal metric name the package uses is declared with its
    type, and every declared name is used."""
    used = {}
    for dirpath, _dirs, files in os.walk(PACKAGE):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    for kind, name in METRIC_CALL.findall(f.read()):
                        used.setdefault(name, set()).add(kind)
    assert sorted(used) == sorted(T.METRICS)
    for name, kinds in used.items():
        assert kinds == {T.METRICS[name]["type"]}, name
        assert T.METRICS[name]["help"]
    with pytest.raises(ConfigError, match="unknown metric name"):
        T.MetricsRegistry().counter("http_requests_total")


def test_diagnostics_counters_mirror_to_a_gauge():
    diag = Diagnostics()
    diag.counters["sweep_cells_total"] = 42
    gauge = T.get_registry().gauge("diag_counter", name="sweep_cells_total")
    assert gauge.value == 42.0
    diag.counters["sweep_cells_total"] = 43
    assert gauge.value == 43.0
    assert dict(diag.counters) == {"sweep_cells_total": 43}


def test_des_heartbeat_gauges_match_jax():
    from simumax_tpu import PerfLLM as JaxPerfLLM
    from simumax_tpu_torch import PerfLLM

    gauges = ("des_events_served", "des_blocked_ranks", "des_clock_seconds")
    values = {}
    for name, perf_cls, reg in (("jax", JaxPerfLLM, jax_registry()),
                                ("port", PerfLLM, T.get_registry())):
        perf = perf_cls().configure("tp1_pp2_dp4_mbs1", "llama3-8b", "tpu_v5e_256")
        perf.run_estimate()
        for g in gauges:
            reg.gauge(g).set(0)
        perf.simulate(None, track_memory=False, progress_every=50)
        values[name] = [reg.gauge(g).value for g in gauges]
    assert values["port"] == values["jax"]
    assert values["port"][0] > 0 and values["port"][2] > 0


def test_reporter_json_lines_carry_the_trace_ids(tracer, monkeypatch):
    from simumax_tpu_torch.observe.report import configure_reporter, get_reporter

    monkeypatch.setattr(T, "_TRACER", tracer)
    buf = io.StringIO()
    configure_reporter(level="info", json_lines=True, stream=buf)
    try:
        with tracer.trace("root") as tid:
            with tracer.span("child"):
                get_reporter().info("inside", event="x")
        get_reporter().info("outside", event="y")
    finally:
        configure_reporter(level="info", json_lines=False)
        get_reporter().stream = None
    inside, outside = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert inside["trace_id"] == tid and inside["span_id"]
    assert "trace_id" not in outside


def test_span_tree_and_chrome_trace_of_a_fault_analysis(tracer, monkeypatch):
    """``analyze_faults`` and each ``predict_goodput`` open spans under
    the caller's trace; the tree and the Chrome export carry them."""
    from simumax_tpu_torch import PerfLLM
    from simumax_tpu_torch.simulator.faults import ReplayOptions

    monkeypatch.setattr(T, "_TRACER", tracer)
    perf = PerfLLM().configure("tp1_pp2_dp4_mbs1", "llama3-8b", "tpu_v5e_256")
    perf.run_estimate()
    with tracer.trace("root"):
        perf.analyze_faults(n_scenarios=2, horizon_steps=4,
                            options=ReplayOptions(replay_backend="numpy"))
    spans = tracer.drain()
    (root,) = T.span_tree(spans)
    (analysis,) = root["children"]
    assert analysis["name"] == "analyze_faults"
    assert {c["name"] for c in analysis["children"]} == {"predict_goodput"}
    xs = [e for e in T.chrome_trace(spans)["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(spans) and all("trace_id" in e["args"] for e in xs)


def test_fault_replay_counters_count_the_analysis():
    from simumax_tpu_torch import PerfLLM
    from simumax_tpu_torch.simulator.faults import ReplayContext, ReplayOptions

    reg = T.get_registry()
    perf = PerfLLM().configure("tp1_pp2_dp4_mbs1", "llama3-8b", "tpu_v5e_256")
    perf.run_estimate()
    before = reg.counter("faults_scenarios_total").value
    batched = reg.counter("replay_batched_total", backend="cuda").value
    ctx = ReplayContext(perf, options=ReplayOptions(replay_backend="cuda", device="cpu"))
    perf.analyze_faults(n_scenarios=3, horizon_steps=4, _ctx=ctx)
    assert reg.counter("faults_scenarios_total").value - before == ctx.stats["scenarios"]
    assert reg.counter("replay_batched_total", backend="cuda").value - batched == \
        ctx.stats["batched"]

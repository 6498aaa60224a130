"""The port's fleet goodput ledger (``observe/fleetledger.py``) held
against the JAX package's.

Mirrors ``tests/test_fleetledger.py`` (its two CLI-driven cases are
mirrored in ``tests/test_torch_cli.py``): the ledger's conservation and byte-identity
invariants over the fleet chaos grid (the base and churn traces, elastic
on and off), causality ids, the explain payload's field set, the SLO
counterfactual probes, the fleet Chrome trace, the renderings and the
planner's and server's explain surfaces, and the port's
``compile_cache_info``. Every explain payload of the grid is also held
against the JAX package's.

Backends: the port replays with the kernel's plain version
(``replay_backend="cuda", device="cpu"``), the JAX package with its
scalar engine (``replay_backend="numpy"``).

Tolerance: ``==`` on canonical JSON; the invariants keep the JAX
tests' 1e-6.
"""

import copy
import http.client
import json
import threading

import pytest

pytest.importorskip("torch")

from simumax_tpu.observe.fleetledger import diff_fleet_reports as jax_diff  # noqa: E402
from simumax_tpu.observe.fleetledger import fleet_explain_lines as jax_explain_lines  # noqa: E402
from simumax_tpu.observe.fleetledger import format_fleet_diff_lines as jax_diff_lines  # noqa: E402
from simumax_tpu.service.store import canonical_bytes as jax_canonical  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError  # noqa: E402
from simumax_tpu_torch.fleet import FleetSimulator, fleet_decision_lines  # noqa: E402
from simumax_tpu_torch.observe.fleetledger import (  # noqa: E402
    FLEET_LEDGER_ORDER,
    build_fleet_explain,
    diff_fleet_reports,
    fleet_chrome_trace,
    fleet_explain_lines,
    format_fleet_diff_lines,
)
from simumax_tpu_torch.service.store import canonical_bytes  # noqa: E402
from simumax_tpu_torch.simulator.faults import ReplayOptions  # noqa: E402

from test_fleet import base_trace, churn_trace  # noqa: E402
from test_torch_fleet import jax_fleet, port_fleet  # noqa: E402
from test_trace_validity import check_chrome_trace  # noqa: E402

TOL = 1e-6
GRID = [("base", False), ("base", True), ("churn", False), ("churn", True)]
_walks = {}


def grid_trace(name):
    return base_trace() if name == "base" else churn_trace()


def explained(name, side="port", **kw):
    """The memoised explain walk of a grid trace (read only)."""
    key = (name, side, tuple(sorted(kw.items())))
    if key not in _walks:
        run = port_fleet if side == "port" else jax_fleet
        _walks[key] = run(grid_trace(name), explain=True, **kw)
    return _walks[key]


# --------------------------------------------------------------------------
# Conservation + byte identity
# --------------------------------------------------------------------------


class TestLedgerInvariants:
    @pytest.mark.parametrize("name,elastic", GRID)
    def test_explain_equals_the_jax_packages(self, name, elastic):
        assert canonical_bytes(explained(name, elastic=elastic)) \
            == jax_canonical(explained(name, "jax", elastic=elastic))

    @pytest.mark.parametrize("name,elastic", GRID)
    def test_explain_on_equals_explain_off(self, name, elastic):
        plain = port_fleet(grid_trace(name), elastic=elastic)
        rich = explained(name, elastic=elastic)
        assert set(rich) - set(plain) == {"explain"}
        stripped = {k: v for k, v in rich.items() if k != "explain"}
        assert json.dumps(stripped, sort_keys=True) == json.dumps(plain, sort_keys=True)

    @pytest.mark.parametrize("name,elastic", GRID)
    def test_buckets_sum_to_wall(self, name, elastic):
        ledger = explained(name, elastic=elastic)["explain"]["ledger"]
        for rec in ledger["per_job"]:
            if rec["state"] != "done":
                continue
            assert sum(rec["buckets"].values()) == pytest.approx(rec["wall_time_s"], abs=TOL)
        assert sum(ledger["buckets"].values()) == pytest.approx(ledger["total_chip_s"], rel=TOL)
        for tpl in ledger["per_template"].values():
            assert sum(tpl["buckets"].values()) == pytest.approx(tpl["chip_s"], rel=TOL)

    @pytest.mark.parametrize("name,elastic", GRID)
    def test_cause_ids_resolve(self, name, elastic):
        ex = explained(name, elastic=elastic)["explain"]
        events = ex["events"]
        for row in ex["ledger"]["causes"]:
            assert row["cause"] in events, row["cause"]
            assert row["event"]["kind"] != "unknown"
            assert set(row["buckets"]) <= set(FLEET_LEDGER_ORDER)
        for rec in ex["ledger"]["per_job"]:
            for row in rec["causes"]:
                assert row["cause"] in events, row["cause"]

    def test_golden_explain_field_set(self):
        report = explained("churn")
        ex = report["explain"]
        assert ex["schema"] == "simumax-fleet-explain-v1"
        assert set(ex) == {"schema", "ledger", "probes", "events"}
        ledger = ex["ledger"]
        assert set(ledger) == {"order", "buckets", "total_chip_s", "makespan_s", "per_job",
                               "per_template", "per_pod", "causes"}
        assert ledger["order"] == list(FLEET_LEDGER_ORDER)
        assert set(ledger["buckets"]) == set(FLEET_LEDGER_ORDER)
        done = [r for r in ledger["per_job"] if r["state"] == "done"]
        assert done
        for rec in done:
            assert {"name", "template", "state", "chips", "start_s", "wall_time_s",
                    "queue_wait_s", "goodput", "buckets", "causes", "spans"} <= set(rec)
        back = json.loads(json.dumps(report, sort_keys=True))
        assert json.dumps(back, sort_keys=True) == json.dumps(report, sort_keys=True)

    def test_explain_deterministic(self):
        a = port_fleet(churn_trace(), explain=True)
        assert json.dumps(a, sort_keys=True) == json.dumps(explained("churn"), sort_keys=True)


# --------------------------------------------------------------------------
# SLO counterfactual probes
# --------------------------------------------------------------------------


class TestProbes:
    def test_recovering_probe_provably_recovers(self):
        d = base_trace()
        report = explained("base")
        fix = next(p for p in report["explain"]["probes"]
                   if p.get("cheapest_fix") and p["job"] == "a")
        assert fix["change"] == "checkpoint=young-daly"
        assert fix["recovers"] is True
        yd = int(fix["detail"].split("-> ")[1].split()[0])
        d2 = copy.deepcopy(d)
        d2["jobs"][0]["checkpoint"]["interval_steps"] = yd
        rerun = port_fleet(d2)
        job_a = next(j for j in rerun["jobs"] if j["name"] == "a")
        assert job_a["report"]["goodput"] >= fix["slo"]
        assert job_a["report"]["goodput"] == pytest.approx(fix["goodput"], abs=TOL)

    def test_probe_rows_for_every_missed_slo_job(self):
        report = explained("churn")
        missed = {j["name"] for j in report["jobs"] if j.get("slo_attained") is False}
        assert missed
        assert missed <= {p["job"] for p in report["explain"]["probes"]}

    def test_bound_pruned_probes_are_provably_non_recovering(self):
        for p in explained("churn")["explain"]["probes"]:
            if "goodput_bound" in p:
                assert p["recovers"] is False
                assert "goodput" not in p
                assert p["goodput_bound"] < p["slo"]

    def test_cheapest_fix_is_first_recovering_probe(self):
        by_job = {}
        for p in explained("churn")["explain"]["probes"]:
            by_job.setdefault(p["job"], []).append(p)
        for job_rows in by_job.values():
            recovering = [p for p in job_rows if p.get("recovers")]
            if recovering:
                assert recovering[0].get("cheapest_fix") is True
                assert job_rows[-1] is recovering[0]


# --------------------------------------------------------------------------
# Chrome-trace export
# --------------------------------------------------------------------------


class TestFleetTrace:
    @pytest.mark.parametrize("name,elastic", GRID)
    def test_trace_structurally_valid(self, name, elastic):
        check_chrome_trace(fleet_chrome_trace(explained(name, elastic=elastic)))

    def test_trace_has_job_lanes_flows_counters(self):
        events = fleet_chrome_trace(explained("churn"))["traceEvents"]
        lanes = {e["args"]["name"] for e in events
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert {"job a", "job b", "job hi"} <= lanes
        assert any(e["ph"] == "s" for e in events)
        counters = {e["name"] for e in events if e["ph"] == "C"}
        assert "fleet_goodput_pct" in counters and "used_chips" in counters

    def test_write_fleet_trace(self, tmp_path):
        from simumax_tpu_torch.observe.fleetledger import write_fleet_trace

        path = write_fleet_trace(explained("base"), str(tmp_path / "fleet_trace.json"))
        with open(path) as f:
            check_chrome_trace(json.load(f))

    def test_trace_requires_explain(self):
        with pytest.raises(ConfigError):
            fleet_chrome_trace(port_fleet(base_trace()))


# --------------------------------------------------------------------------
# Renderings
# --------------------------------------------------------------------------


class TestRenderings:
    def test_explain_lines_are_the_jax_packages(self):
        lines = fleet_explain_lines(explained("churn"))
        out = "\n".join(lines)
        assert "fleet goodput waterfall" in out
        assert "top loss causes" in out
        assert "SLO counterfactual probes" in out
        assert lines == jax_explain_lines(explained("churn", "jax"))

    def test_decision_lines_group_and_annotate(self):
        from simumax_tpu_torch.fleet import fleet_report_lines

        out = "\n".join(fleet_decision_lines(explained("churn")))
        assert "chip-s goodput loss attributed" in out
        assert "[preempt:hi:" in out
        assert "decisions" in "\n".join(fleet_report_lines(port_fleet(churn_trace())))

    def test_diff_fleet_reports_is_the_jax_packages(self):
        diff = diff_fleet_reports(explained("base"), explained("churn"))
        assert "fleet_goodput" in diff["headline"]
        lines = format_fleet_diff_lines(diff)
        out = "\n".join(lines)
        assert "fleet goodput" in out and "only in B: hi" in out
        ref = jax_diff(explained("base", "jax"), explained("churn", "jax"))
        assert canonical_bytes(diff) == jax_canonical(ref)
        assert lines == jax_diff_lines(ref)

    def test_diff_rejects_non_fleet_payload(self):
        with pytest.raises(ConfigError):
            diff_fleet_reports({"schema": "nope"}, explained("base"))


# --------------------------------------------------------------------------
# Service + telemetry surfaces
# --------------------------------------------------------------------------


class TestExplainSurfaces:
    def test_planner_explain_is_part_of_identity(self, tmp_path):
        from simumax_tpu_torch.service.planner import Planner

        planner = Planner(cache_dir=str(tmp_path / "store"), device="cpu")
        d = base_trace()
        p1, m1 = planner.fleet(copy.deepcopy(d), with_meta=True)
        p2, m2 = planner.fleet(copy.deepcopy(d), explain=True, with_meta=True)
        assert m2["key"] != m1["key"]
        assert "explain" in p2 and "explain" not in p1
        assert {k: v for k, v in p2.items() if k != "explain"} == p1
        _p3, m3 = planner.fleet(copy.deepcopy(d), explain=True, with_meta=True)
        assert m3["cache"] == "hit" and m3["key"] == m2["key"]
        assert canonical_bytes(p2) == jax_canonical(explained("base", "jax"))

    def test_server_fleet_explain_param(self, tmp_path):
        from simumax_tpu_torch.service.planner import Planner
        from simumax_tpu_torch.service.server import make_server

        srv = make_server(Planner(cache_dir=str(tmp_path / "srv-store"), device="cpu"),
                          "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            port = srv.server_address[1]

            def post(body):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                conn.request("POST", "/v1/fleet", json.dumps(body),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                conn.close()
                return resp.status, data

            status, plain = post({"trace": base_trace()})
            assert status == 200
            status, rich = post({"trace": base_trace(), "explain": True})
            assert status == 200
            rep = json.loads(rich)
            assert rep["explain"]["schema"] == "simumax-fleet-explain-v1"
            assert {k: v for k, v in rep.items() if k != "explain"} == json.loads(plain)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", "/metrics")
            body = conn.getresponse().read().decode()
            conn.close()
            assert "replay_compile_cache_shapes" in body
            assert "replay_compile_cache_capacity" in body
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)

    def test_compile_cache_info_counts_the_level_schedules(self):
        """The port's counterpart of the XLA compile-cache report: the
        level schedules held and the LRU's bound, on both gauges."""
        from simumax_tpu_torch.observe.telemetry import METRICS, MetricsRegistry, get_registry
        from simumax_tpu_torch.simulator import batched_replay as br

        assert METRICS["replay_compile_cache_shapes"]["type"] == "gauge"
        assert METRICS["replay_compile_cache_capacity"]["type"] == "gauge"
        br._SCHEDULES.clear()
        assert br.compile_cache_info() == {"compiled_shapes": 0,
                                           "capacity": br.SCHEDULES_KEPT}
        from torch_fault_cells import synthetic_family

        for repeat in (1, 2):  # two op tables, two schedules
            br.level_schedule(br.lower_family(*synthetic_family(repeat)))
        held = len(br._SCHEDULES)
        assert held == 2
        reg = MetricsRegistry()
        info = br.compile_cache_info(reg)
        assert info == {"compiled_shapes": held, "capacity": br.SCHEDULES_KEPT}
        assert reg.gauge("replay_compile_cache_shapes").value == held
        assert reg.gauge("replay_compile_cache_capacity").value == br.SCHEDULES_KEPT
        br.compile_cache_info()
        assert get_registry().gauge("replay_compile_cache_shapes").value == held

    def test_explain_metrics_cataloged(self):
        from simumax_tpu_torch.observe.telemetry import METRICS, get_registry

        assert METRICS["fleet_explain_jobs_total"]["type"] == "counter"
        assert METRICS["fleet_probes_total"]["type"] == "counter"
        port_fleet(base_trace(), explain=True)
        assert get_registry().snapshot()["fleet_explain_jobs_total"][0]["value"] > 0

    def test_build_fleet_explain_needs_finished_walk(self):
        sim = FleetSimulator(base_trace(), options=ReplayOptions(device="cpu"))
        with pytest.raises(ConfigError):
            build_fleet_explain(sim)

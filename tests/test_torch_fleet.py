"""The port's fleet simulator (``fleet/``) held against the JAX package's.

Mirrors ``tests/test_fleet.py`` (its CLI case and the walk equivalence
its ``bench_fleet.py`` smoke gates are mirrored through the port's
command line in ``tests/test_torch_cli.py``): the trace schema and its validation errors,
multi-rank fault events, the walk's equivalences (one job ==
``predict_goodput``, shared == naive, serial == ``jobs=2``, reshape off
== rollback-restart), the orbit cache, the reshape helpers, and the
planner's and server's fleet surfaces. Where the JAX test holds the
package against itself, the port's answer is also held against the JAX
package's. And the JAX package's reference trace
(``configs/fleet/v5p512_reference.json``: 120 jobs, 4 templates, 512
chips) walks in the port with elastic on and off, with and without
``explain``, serially and with ``jobs=2``; the port's H100 copy of it
(``simumax_tpu_torch/configs/fleet/h100_512_reference.json``) validates
and walks.

Backends: the port replays through its batched replay on the CPU
(``replay_backend="cuda", device="cpu"``: the kernel's plain version,
``PLAIN``) or through its scalar engine (``"numpy"``); the JAX package
through its scalar engine (``replay_backend="numpy"``), since its jax
backend fails in some sandboxes (ROADMAP queue C).

Tolerance: ``==`` on canonical JSON (``service.store.canonical_bytes``):
the copies do the same float64 arithmetic in the same order, and the
plain replay is bit for bit the scalar engine.
"""

import copy
import http.client
import json
import os
import threading

import pytest

pytest.importorskip("torch")

from simumax_tpu.fleet import fleet_report_lines as jax_report_lines  # noqa: E402
from simumax_tpu.fleet import simulate_fleet as jax_simulate_fleet  # noqa: E402
from simumax_tpu.fleet.trace import FleetTrace as JaxFleetTrace  # noqa: E402
from simumax_tpu.perf import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.service.server import response_bytes as jax_response_bytes  # noqa: E402
from simumax_tpu.service.store import canonical_bytes as jax_canonical  # noqa: E402
from simumax_tpu.simulator import faults as jf  # noqa: E402
from simumax_tpu_torch.core.config import get_model_config, get_strategy_config  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError, FeasibilityError  # noqa: E402
from simumax_tpu_torch.fleet import (  # noqa: E402
    FleetSimulator,
    FleetTrace,
    fleet_report_lines,
    simulate_fleet,
)
from simumax_tpu_torch.perf import PerfLLM  # noqa: E402
from simumax_tpu_torch.service.store import canonical_bytes  # noqa: E402
from simumax_tpu_torch.simulator.faults import (  # noqa: E402
    FaultEvent,
    FaultScenario,
    ReplayContext,
    ReplayOptions,
    predict_goodput,
)

from test_fleet import base_trace, churn_trace, tiny_template  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "configs", "fleet", "v5p512_reference.json")
H100 = os.path.join(REPO, "simumax_tpu_torch", "configs", "fleet",
                    "h100_512_reference.json")
BACKENDS = {"plain": dict(replay_backend="cuda", device="cpu"),
            "numpy": dict(replay_backend="numpy")}
TOL = 1e-6


def PLAIN():
    return ReplayOptions(**BACKENDS["plain"])


def port_fleet(trace, backend="plain", **kw):
    return simulate_fleet(copy.deepcopy(trace), options=ReplayOptions(**BACKENDS[backend]),
                          **kw)


def jax_fleet(trace, **kw):
    return jax_simulate_fleet(copy.deepcopy(trace),
                              options=jf.ReplayOptions(replay_backend="numpy"), **kw)


def assert_same(port, jax):
    assert canonical_bytes(port) == jax_canonical(jax)


_walks = {}


def walked(side, trace_name, **kw):
    """One memoised walk (the walks are deterministic): ``side`` is
    ``"jax"`` or a port backend, ``trace_name`` a trace of
    :data:`TRACES`. Callers only read the report."""
    key = (side, trace_name, tuple(sorted(kw.items())))
    if key not in _walks:
        trace = TRACES[trace_name]()
        _walks[key] = jax_fleet(trace, **kw) if side == "jax" else port_fleet(trace, side, **kw)
    return _walks[key]


TRACES = {"base": base_trace, "churn": churn_trace, "reference": lambda: REFERENCE,
          "h100": lambda: H100}


def tiny_perf(cls=PerfLLM, get_strategy=get_strategy_config, world=16, mbc=8, tp=1, pp=2):
    st = get_strategy("tp1_pp2_dp4_mbs1")
    st.tp_size = tp
    st.pp_size = pp
    st.world_size = world
    st.micro_batch_num = mbc
    st.__post_init__()
    p = cls().configure(st, "llama2-tiny", "tpu_v5e_256")
    p.run_estimate()
    return p


# --------------------------------------------------------------------------
# Trace schema
# --------------------------------------------------------------------------


class TestTraceSchema:
    def test_round_trip(self, tmp_path):
        d = base_trace(
            maintenance=[{"pod": "p1", "start_s": 2.0, "duration_s": 1.0}],
            link_degradations=[{"pod": "p0", "dim": "tp", "multiplier": 2.0,
                                "start_s": 1.0, "duration_s": 3.0}],
            spot_reclaims=[{"pod": "p0", "start_s": 5.0, "chips": 4}],
        )
        tr = FleetTrace.load(copy.deepcopy(d))
        path = tmp_path / "trace.json"
        tr.save(str(path))
        back = FleetTrace.load(str(path))
        assert back.to_dict() == tr.to_dict()
        assert tr.to_dict() == JaxFleetTrace.load(d).to_dict()

    @pytest.mark.parametrize(
        "mutate,match",
        [
            (lambda d: d["fleet"].pop("pods"), "at least one pod"),
            (lambda d: d["fleet"]["pods"].append({"name": "p0", "chips": 8}), "duplicate pod"),
            (lambda d: d["fleet"].update(scheduler={"policy": "lottery"}), "policy"),
            (lambda d: d["jobs"].__setitem__(0, dict(d["jobs"][0], template="nope")),
             "unknown template"),
            (lambda d: d["jobs"].append(dict(d["jobs"][0])), "duplicate job"),
            (lambda d: d["jobs"].__setitem__(0, dict(d["jobs"][0], slo_goodput=1.5)),
             "slo_goodput"),
            (lambda d: d["fleet"].update(scheduler={"policy": "fifo", "frobnicate": 1}),
             "unknown scheduler"),
            (lambda d: d["fleet"].update(maintenance=[
                {"pod": "p9", "start_s": 0.0, "duration_s": 1.0}]), "unknown pod"),
        ],
    )
    def test_validation_rejects_as_the_jax_package_does(self, mutate, match):
        d = base_trace()
        mutate(d)
        with pytest.raises(ConfigError, match=match) as port:
            FleetTrace.load(copy.deepcopy(d))
        with pytest.raises(Exception, match=match) as jax:
            JaxFleetTrace.load(d)
        assert str(port.value) == str(jax.value)

    def test_priority_names(self):
        d = base_trace()
        d["jobs"][0]["priority"] = "high"
        d["jobs"][1]["priority"] = 0
        tr = FleetTrace.load(d)
        assert tr.jobs[0].priority == 2
        assert tr.jobs[1].priority == 0

    def test_spot_process_deterministic_and_the_jax_packages(self):
        d = base_trace()
        d["fleet"]["spot"] = {"rate_per_hour": 600.0, "horizon_s": 120.0, "chips": 4,
                              "seed": 7}
        a = FleetTrace.load(copy.deepcopy(d)).fleet.materialize_spot()
        b = FleetTrace.load(copy.deepcopy(d)).fleet.materialize_spot()
        ref = JaxFleetTrace.load(copy.deepcopy(d)).fleet.materialize_spot()
        assert [r.to_dict() for r in a] == [r.to_dict() for r in b] \
            == [r.to_dict() for r in ref]
        assert a and all(0 <= r.start_s < 120.0 for r in a)
        assert a == sorted(a, key=lambda r: (r.start_s, r.pod, r.chips))


class TestH100Trace:
    def test_validates_and_differs_from_the_reference_only_in_system(self):
        with open(REFERENCE) as f:
            ref = json.load(f)
        with open(H100) as f:
            h100 = json.load(f)
        FleetTrace.load(copy.deepcopy(h100))
        assert {t["system"] for t in h100["templates"].values()} == {"h100_sxm_256"}
        for t in h100["templates"].values():
            t["system"] = "tpu_v5e_256"
        assert h100 == ref

    def test_walks_equal_on_the_plain_replay_and_the_scalar_engine(self):
        got = walked("plain", "h100")
        assert canonical_bytes(got) == canonical_bytes(walked("numpy", "h100"))
        assert got["n_jobs"] == 120 and got["total_chips"] == 512
        assert 0.0 < got["fleet_goodput"] <= 1.0


# --------------------------------------------------------------------------
# Multi-rank fault events
# --------------------------------------------------------------------------


class TestMultiRankEvents:
    @pytest.fixture(scope="class")
    def perf(self):
        return tiny_perf()

    def test_ranks_list_bit_identical_to_expansion(self, perf):
        def scenarios(E, S):
            multi = S(events=[
                E("preemption", start_ms=100.0, duration_ms=300.0, ranks=[4, 5, 6, 7]),
                E("slowdown", start_ms=800.0, duration_ms=200.0, ranks=[0, 8],
                  multiplier=2.0),
            ], horizon_steps=16, checkpoint={"interval_steps": 8})
            single = S(events=(
                [E("preemption", start_ms=100.0, duration_ms=300.0, rank=r)
                 for r in (4, 5, 6, 7)]
                + [E("slowdown", start_ms=800.0, duration_ms=200.0, rank=r, multiplier=2.0)
                   for r in (0, 8)]
            ), horizon_steps=16, checkpoint={"interval_steps": 8})
            return multi, single

        multi, single = scenarios(FaultEvent, FaultScenario)
        rm = predict_goodput(perf, multi, options=PLAIN())
        rs = predict_goodput(perf, single, options=PLAIN())
        assert rm.to_dict() == rs.to_dict()
        exact = predict_goodput(perf, copy.deepcopy(multi), incremental=False)
        assert rm.to_dict() == exact.to_dict()
        ref = jf.predict_goodput(tiny_perf(JaxPerfLLM, jf_strategy()),
                                 scenarios(jf.FaultEvent, jf.FaultScenario)[0],
                                 options=jf.ReplayOptions(replay_backend="numpy"))
        assert canonical_bytes(rm.to_dict()) == jax_canonical(ref.to_dict())

    def test_ranks_list_death(self, perf):
        multi = FaultScenario(events=[FaultEvent("rank_death", start_ms=500.0, ranks=[3, 9])],
                              horizon_steps=8)
        single = FaultScenario(events=[FaultEvent("rank_death", start_ms=500.0, rank=3),
                                       FaultEvent("rank_death", start_ms=500.0, rank=9)],
                               horizon_steps=8)
        assert predict_goodput(perf, multi, options=PLAIN()).to_dict() \
            == predict_goodput(perf, single, options=PLAIN()).to_dict()

    @pytest.mark.parametrize(
        "event,match",
        [
            (FaultEvent("preemption", duration_ms=1.0), "target rank"),
            (FaultEvent("preemption", duration_ms=1.0, rank=0, ranks=[1]),
             "mutually exclusive"),
            (FaultEvent("slowdown", duration_ms=1.0, ranks=[3, 99], multiplier=2.0),
             "outside world"),
        ],
    )
    def test_ranks_validation(self, event, match):
        with pytest.raises(ConfigError, match=match):
            FaultScenario([event]).validate(16)

    def test_consumed_set_death_regression(self):
        """A rank death at the instant an all-rank freeze starts, in the
        optimizer tail: the exact and incremental paths complete and
        agree to the bit, and equal the JAX package's."""
        def run(cls, get_model, get_strategy, E, S, **kw):
            st = get_strategy("tp1_pp2_dp4_mbs1")
            st.tp_size = 2
            st.pp_size = 2
            st.world_size = 64
            st.micro_batch_num = 8
            st.__post_init__()
            m = copy.deepcopy(get_model("deepseekv2-lite"))
            m.layer_num = 8
            p = cls().configure(st, m, "tpu_v5e_256")
            p.run_estimate()
            t = 7246.954394342879
            sc = S(events=[E("preemption", start_ms=t, duration_ms=42802.57834004669,
                             ranks=list(range(64))),
                           E("rank_death", start_ms=t, rank=0)],
                   horizon_steps=50, checkpoint={"interval_steps": 20})
            return p, sc, kw

        p, sc, _ = run(PerfLLM, get_model_config, get_strategy_config, FaultEvent,
                       FaultScenario)
        inc = predict_goodput(p, copy.deepcopy(sc), granularity="leaf", options=PLAIN())
        exact = predict_goodput(p, copy.deepcopy(sc), granularity="leaf", incremental=False)
        assert inc.to_dict() == exact.to_dict()
        assert inc.n_restarts >= 1
        from simumax_tpu.core.config import get_model_config as jm

        jp, jsc, _ = run(JaxPerfLLM, jm, jf_strategy(), jf.FaultEvent, jf.FaultScenario)
        ref = jf.predict_goodput(jp, jsc, granularity="leaf",
                                 options=jf.ReplayOptions(replay_backend="numpy"))
        assert canonical_bytes(inc.to_dict()) == jax_canonical(ref.to_dict())

    def test_validate_hoist_and_spec_memo(self):
        perf = tiny_perf()
        ctx = ReplayContext(perf, options=PLAIN())
        bad = FaultScenario(events=[FaultEvent("preemption", start_ms=1.0, duration_ms=1.0,
                                               rank=99)], horizon_steps=4)
        with pytest.raises(ConfigError, match="outside world"):
            predict_goodput(perf, bad, _ctx=ctx)
        s1 = FaultScenario(events=[], horizon_steps=4, checkpoint={"interval_steps": 2})
        s2 = FaultScenario(events=[], horizon_steps=8, checkpoint={"interval_steps": 2})
        assert ctx.resolve_spec(s1) is ctx.resolve_spec(s2)
        assert ctx.resolve_spec(s1).interval_steps == 2


def jf_strategy():
    from simumax_tpu.core.config import get_strategy_config as js

    return js


# --------------------------------------------------------------------------
# Fleet walk equivalences
# --------------------------------------------------------------------------


class TestFleetEquivalence:
    def test_one_job_equals_predict_goodput(self):
        d = base_trace()
        d["jobs"] = [d["jobs"][0]]
        rep = port_fleet(d)
        direct = tiny_perf().predict_goodput(FaultScenario(
            events=[], horizon_steps=30, checkpoint={"interval_steps": 10}), options=PLAIN())
        assert rep["jobs"][0]["report"] == direct.to_dict()
        assert rep["n_jobs"] == 1
        assert rep["jobs"][0]["slo_attained"] == (direct.goodput >= 0.9)
        assert_same(rep, jax_fleet(d))

    def test_shared_equals_naive_bit_for_bit(self):
        shared = walked("plain", "churn", elastic=False)
        naive = port_fleet(churn_trace(), elastic=False, naive=True)
        assert shared == naive
        assert_same(naive, walked("jax", "churn", elastic=False))

    def test_serial_equals_parallel_bit_for_bit(self):
        parallel = port_fleet(churn_trace(), elastic=False, jobs=2)
        assert walked("plain", "churn", elastic=False) == parallel

    def test_reshape_off_is_rollback_restart(self):
        el = walked("plain", "churn")
        rb = walked("plain", "churn", elastic=False)
        assert_same(el, walked("jax", "churn"))
        el_a = next(j for j in el["jobs"] if j["reshapes"] >= 1)
        rb_a = next(j for j in rb["jobs"] if j["name"] == el_a["name"])
        assert el_a["reshapes"] >= 1
        assert el_a["report"]["n_restarts"] == 0
        assert el_a["report"]["buckets"]["reshape"] > 0.0
        assert el_a["chips_final"] < el_a["chips"]
        assert rb_a["reshapes"] == 0
        assert rb_a["report"]["n_restarts"] >= 1
        assert rb_a["report"]["buckets"]["reshape"] == 0.0

    @pytest.mark.parametrize("elastic", [True, False])
    def test_buckets_sum_to_wall(self, elastic):
        rep = walked("plain", "churn", elastic=elastic)
        for j in rep["jobs"]:
            if j["report"] is None:
                continue
            b = j["report"]["buckets"]
            assert abs(sum(b.values()) - j["report"]["wall_time_s"]) < TOL, j["name"]

    def test_priority_preemption_timeline(self):
        rep = walked("plain", "churn", elastic=False)
        events = [d["event"] for d in rep["decisions"]]
        assert "preempted" in events and "resumed" in events
        victim = next(j for j in rep["jobs"] if j["suspensions"] >= 1)
        assert victim["report"]["wall_time_s"] > 0

    def test_slo_accounting(self):
        rep = walked("plain", "churn", elastic=False)
        flags = [j["slo_attained"] for j in rep["jobs"] if "slo_attained" in j]
        assert rep["slo"]["total"] == len(flags)
        assert rep["slo"]["attained"] == sum(flags)
        assert rep["slo"]["fraction"] == pytest.approx(sum(flags) / len(flags))

    def test_starved_job_reported(self):
        d = base_trace()
        d["fleet"]["pods"] = [{"name": "p0", "chips": 16}]
        d["fleet"]["spot_reclaims"] = [{"pod": "p0", "start_s": 0.1, "chips": 8}]
        d["jobs"] = [dict(d["jobs"][0], spot=True)]
        rep = port_fleet(d, elastic=False)
        assert rep["jobs"][0]["state"] != "done"
        assert any(x["event"] == "starved" for x in rep["decisions"])
        assert rep["slo"]["attained"] == 0
        assert_same(rep, jax_fleet(d, elastic=False))

    def test_elastic_infeasible_falls_back(self):
        d = churn_trace()
        d["templates"]["t"] = tiny_template(mbc=8)
        rep = port_fleet(d)
        events = [x["event"] for x in rep["decisions"]]
        assert "reshaped" not in events
        assert ("restarted" in events) or ("frozen" in events)
        assert_same(rep, jax_fleet(d))

    def test_naive_elastic_rejected(self):
        with pytest.raises(ConfigError, match="naive"):
            FleetSimulator(churn_trace(), naive=True, options=PLAIN())

    def test_report_lines_render_as_the_jax_packages(self):
        rep = walked("plain", "churn")
        lines = fleet_report_lines(rep)
        assert any("fleet goodput" in ln for ln in lines)
        assert any("SLO" in ln for ln in lines)
        assert lines == jax_report_lines(walked("jax", "churn"))

    def test_the_default_options_run_on_the_card(self):
        """Asked nothing, a walk replays on the card: without one it
        refuses to start (no fallback to the CPU)."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default walk would launch the kernel")
        with pytest.raises(Exception, match="cuda|card|CUDA"):
            simulate_fleet(base_trace())


class TestOrbitCacheLiveness:
    def test_placement_shifted_kill_shares_one_replay(self):
        perf = tiny_perf(world=16, mbc=8)
        ctx = ReplayContext(perf, options=PLAIN())

        def job(rank):
            return FaultScenario(
                events=[FaultEvent("rank_death", start_ms=250.0, rank=rank)],
                horizon_steps=12, checkpoint={"interval_steps": 6})

        from simumax_tpu_torch.simulator.reduce import build_reduction, orbit_of

        plan = build_reduction(perf.strategy, {})
        assert orbit_of(plan, 2) == orbit_of(plan, 3)
        r1 = predict_goodput(perf, job(2), _ctx=ctx)
        sims_after_first = ctx.stats["sims"]
        canon_before = ctx.stats["canon_hits"]
        r2 = predict_goodput(perf, job(3), _ctx=ctx)
        assert ctx.stats["sims"] == sims_after_first
        assert ctx.stats["canon_hits"] > canon_before
        assert r1.to_dict() == r2.to_dict()

    def test_fleet_decisions_annotate_orbits(self):
        rep = walked("plain", "churn")
        assert [d["orbit"] for d in rep["decisions"] if "orbit" in d]


class TestReshapeHelpers:
    def test_shrink_strategy(self):
        from simumax_tpu_torch.search.prune import shrink_strategy

        st = get_strategy_config("tp1_pp2_dp4_mbs1")
        st.world_size = 16
        st.micro_batch_num = 6
        st.__post_init__()
        shrunk = shrink_strategy(st, 2)
        assert shrunk.world_size == 16 - 2 * (1 * 1 * 2)
        assert shrunk.micro_batch_num == 8
        assert shrunk.global_batch_size == st.global_batch_size
        with pytest.raises(FeasibilityError, match="does not split"):
            shrink_strategy(st, 1)
        with pytest.raises(FeasibilityError, match="no survivors"):
            shrink_strategy(st, 8)

    def test_rebatched_iter_time_equals_the_jax_packages(self):
        perf = tiny_perf(mbc=4)
        base = perf.analysis_cost()["iter_time"]
        doubled = perf.rebatched_iter_time(8)
        assert doubled > base
        assert perf.strategy.micro_batch_num == 8
        assert perf.analysis_cost()["iter_time"] == doubled
        ref = tiny_perf(JaxPerfLLM, jf_strategy(), mbc=4)
        assert ref.rebatched_iter_time(8) == doubled

    def test_reshape_bucket_in_waterfall(self):
        from simumax_tpu_torch.observe.ledger import (
            GOODPUT_WATERFALL_ORDER,
            build_goodput_waterfall,
        )

        assert "reshape" in GOODPUT_WATERFALL_ORDER
        legacy = {
            "wall_time_s": 10.0, "goodput": 0.9, "horizon_steps": 5, "n_restarts": 0,
            "n_checkpoints": 1,
            "buckets": {k: 0.0 for k in GOODPUT_WATERFALL_ORDER if k != "reshape"},
        }
        assert build_goodput_waterfall(legacy)["buckets"]["reshape"] == 0.0


# --------------------------------------------------------------------------
# The reference trace (120 jobs, 4 templates, 512 chips)
# --------------------------------------------------------------------------


class TestReferenceTrace:
    @pytest.mark.parametrize("backend", ["plain", "numpy"])
    @pytest.mark.parametrize("explain", [False, True])
    def test_equals_the_jax_package(self, backend, explain):
        got = walked(backend, "reference", explain=explain)
        assert_same(got, walked("jax", "reference", explain=explain))
        assert got["n_jobs"] == 120 and got["n_templates"] == 4
        assert ("explain" in got) == explain

    def test_elastic_off_equals_the_jax_package(self):
        assert_same(walked("plain", "reference", elastic=False),
                    walked("jax", "reference", elastic=False))

    def test_two_workers_equal_one(self):
        assert port_fleet(REFERENCE, jobs=2) == walked("plain", "reference")

    def test_spawned_workers_equal_one(self, monkeypatch):
        """The start method a process that has initialised CUDA takes:
        each spawned worker rebuilds its templates' estimates and replay
        contexts from the pickled configs."""
        monkeypatch.setenv("SIMUMAX_MP_START", "spawn")
        from simumax_tpu_torch.simulator.faults import _mc_context

        assert _mc_context().get_start_method() == "spawn"
        assert port_fleet(churn_trace(), elastic=False, jobs=2) \
            == walked("plain", "churn", elastic=False)

    def test_the_walk_goes_through_the_batched_replay(self):
        """The lockstep costing sends its misses to the batched replay:
        families lowered, scenarios solved, none refused for want of a
        card."""
        from simumax_tpu_torch.observe.telemetry import get_registry

        reg = get_registry()
        before = reg.counter("replay_batched_total", backend="cuda").value
        port_fleet(REFERENCE, elastic=False)
        assert reg.counter("replay_batched_total", backend="cuda").value > before


# --------------------------------------------------------------------------
# Service surfaces
# --------------------------------------------------------------------------


class TestFleetService:
    def test_planner_fleet_cache(self, tmp_path):
        from simumax_tpu_torch.service.planner import Planner

        planner = Planner(cache_dir=str(tmp_path / "store"), device="cpu")
        d = base_trace()
        p1, m1 = planner.fleet(copy.deepcopy(d), with_meta=True)
        assert m1["cache"] == "miss"
        p2, m2 = planner.fleet(copy.deepcopy(d), with_meta=True)
        assert m2["cache"] == "hit" and m2["key"] == m1["key"]
        assert p1 == p2
        p3, m3 = planner.fleet(copy.deepcopy(d), jobs=2, with_meta=True)
        assert m3["cache"] == "hit" and p3 == p1
        _p4, m4 = planner.fleet(copy.deepcopy(d), elastic=True, with_meta=True)
        assert m4["key"] != m1["key"]
        assert_same(p1, jax_fleet(d))

    def test_server_endpoint(self, tmp_path):
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
                headers = dict(resp.getheaders())
                conn.close()
                return resp.status, headers, data

            status, h1, d1 = post({"trace": base_trace()})
            assert status == 200 and h1["X-SimuMax-Cache"] == "miss"
            rep = json.loads(d1)
            assert rep["schema"] == "simumax-fleet-v1" and rep["n_jobs"] == 2
            assert d1 == jax_response_bytes(jax_fleet(base_trace()))
            status, h2, d2 = post({"trace": base_trace()})
            assert status == 200 and h2["X-SimuMax-Cache"] == "hit" and d1 == d2
            status, _h, data = post({"trace": {"schema": "nope"}})
            assert status == 400 and "error" in json.loads(data)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)

    def test_fleet_metrics_cataloged(self):
        from simumax_tpu_torch.observe.telemetry import METRICS

        assert METRICS["fleet_jobs_total"]["type"] == "counter"
        assert METRICS["fleet_template_ctx_total"]["type"] == "counter"
        assert METRICS["fleet_slo_attainment"]["type"] == "gauge"

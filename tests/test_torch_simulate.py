"""The port's ledgers and discrete-event simulator (``observe/ledger.py``,
``observe/memledger.py``, ``observe/trace.py``, ``simulator/``,
``parallel/mesh.py``, copied with their import paths changed) against
the JAX package's, through ``PerfLLM.ledger``, ``memory_ledger``,
``memory_crosscheck`` and ``simulate``.

The copies are plain Python, so on a TPU system config they must give
the JAX package's numbers to rel 1e-12 (they are equal here): the cost
ledger and the memory ledger whole, the cross-check, the simulated
makespan, per-rank ends and per-stage memory peaks, and the Chrome
trace's events. The cases are ``tests/test_torch_perf.py``'s (dense,
MoE, MLA; pp 1 and 2; recompute; the bench rows with math and flash
attention), a dense pp 4 and an interleaved pp 4 x vp 2 schedule, and
every world rank simulated with a straggler. As in the JAX package's
own tests, each waterfall's buckets sum to the predicted iteration time
and to the predicted peak within 1e-6.
"""

import json
import math
import os
import re

import pytest

pytest.importorskip("torch")

from simumax_tpu import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.core.config import StrategyConfig as JaxStrategy  # noqa: E402
from simumax_tpu.core.config import get_model_config as jax_model  # noqa: E402
from simumax_tpu.core.config import get_strategy_config as jax_strategy  # noqa: E402
from simumax_tpu_torch import PerfLLM, StrategyConfig  # noqa: E402
from simumax_tpu_torch.core.config import get_model_config, get_strategy_config  # noqa: E402
from simumax_tpu_torch.observe.ledger import build_waterfall  # noqa: E402
from simumax_tpu_torch.observe.memledger import build_memory_waterfall  # noqa: E402

from test_torch_perf import BACKENDS, CASES as PERF_CASES, _bench_strategy  # noqa: E402

#: (id, strategy, model, strategy overrides, model overrides)
CASES = [
    (cid, strategy, model, {}, {}, backend)
    for cid, (strategy, model, backend) in zip(
        ["llama3-8b", "llama3-70b", "bench-math", "bench-flash", "mixtral-8x1b",
         "mixtral-8x7b-ep4", "mixtral-8x7b-ep4-recompute", "deepseekv2-lite-mla"],
        PERF_CASES)
] + [
    ("llama3-8b-pp4", "tp1_pp2_dp4_mbs1", "llama3-8b", dict(pp_size=4, world_size=8),
     dict(layer_num=8), None),
    ("llama3-8b-pp4-vp2", "tp1_pp4_vp2_sync_mbs1_mbc8_no_ckpt", "llama3-8b", {}, {}, None),
]
IDS = [c[0] for c in CASES]


def _pair(strategy, model, overrides, tweak, backend):
    """The same estimate in both packages, on ``tpu_v5e_256``."""
    perfs = []
    for perf_cls, strategy_cls, get_strategy, get_model in (
            (JaxPerfLLM, JaxStrategy, jax_strategy, jax_model),
            (PerfLLM, StrategyConfig, get_strategy_config, get_model_config)):
        if strategy == "bench":
            mapped = backend if perf_cls is JaxPerfLLM else BACKENDS[backend]
            st = _bench_strategy(strategy_cls, mapped, backend == "pallas")
        else:
            st = get_strategy(strategy)
        for k, v in overrides.items():
            setattr(st, k, v)
        st.__post_init__()
        mc = get_model(model)
        for k, v in tweak.items():
            setattr(mc, k, v)
        perf = perf_cls().configure(st, mc, "tpu_v5e_256")
        perf.run_estimate()
        perfs.append(perf)
    return perfs


def _mapped(x):
    """JAX's values with its attention backend and package name mapped to
    the port's."""
    if isinstance(x, str):
        return x.replace("backend=pallas", "backend=cuda").replace(
            "simumax_tpu analytical", "simumax_tpu_torch analytical").replace(
            "simumax_tpu_memory_snapshot", "simumax_tpu_torch_memory_snapshot")
    if isinstance(x, dict):
        return {_mapped(k): _mapped(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_mapped(v) for v in x]
    return x


def _without_ids(x):
    """A snapshot with the ``#<id()>`` suffixes of its activation tokens
    dropped: they name Python objects, which differ from run to run."""
    if isinstance(x, str):
        return re.sub(r"#\d+", "", x)
    if isinstance(x, dict):
        return {_without_ids(k): _without_ids(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_without_ids(v) for v in x]
    return x


def _assert_same(ref, got, where="$"):
    """Equal structure and strings; numbers within rel 1e-12."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(ref) == sorted(got), where
        for k in ref:
            _assert_same(ref[k], got[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(ref) == len(got), where
        for i, (r, g) in enumerate(zip(ref, got)):
            _assert_same(r, g, f"{where}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert (math.isnan(ref) and math.isnan(got)) or got == pytest.approx(
            ref, rel=1e-12, abs=0), (where, ref, got)
    else:
        assert ref == got, (where, ref, got)


def _json(x):
    return json.loads(json.dumps(x, default=str))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ledger_matches_jax_and_sums_to_the_step(case):
    _cid, strategy, model, overrides, tweak, backend = case
    ref, got = _pair(strategy, model, overrides, tweak, backend)
    _assert_same(_mapped(_json(ref.ledger().to_dict())), _json(got.ledger().to_dict()))
    wf = build_waterfall(got)
    assert sum(wf["buckets"].values()) == pytest.approx(wf["total"], rel=1e-6)
    assert wf["total"] == got.analysis_cost()["iter_time"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_memory_ledger_matches_jax_and_sums_to_the_peak(case):
    _cid, strategy, model, overrides, tweak, backend = case
    ref, got = _pair(strategy, model, overrides, tweak, backend)
    _assert_same(_mapped(_json(ref.memory_ledger().to_dict())),
                 _json(got.memory_ledger().to_dict()))
    wf = build_memory_waterfall(got)
    peak = got.analysis_mem()["max_peak_bytes"]
    assert sum(wf["buckets"].values()) == pytest.approx(peak, rel=1e-6)
    assert wf["total"] == peak


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_memory_crosscheck_matches_jax(case):
    _cid, strategy, model, overrides, tweak, backend = case
    ref, got = _pair(strategy, model, overrides, tweak, backend)
    _assert_same(_mapped(_json(ref.memory_crosscheck())), _json(got.memory_crosscheck()))


def _trace_events(path):
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_simulate_matches_jax(case, tmp_path):
    _cid, strategy, model, overrides, tweak, backend = case
    ref, got = _pair(strategy, model, overrides, tweak, backend)
    res = {}
    for name, perf in (("jax", ref), ("port", got)):
        res[name] = perf.simulate(str(tmp_path / name))
    r, g = res["jax"], res["port"]
    for key in ("end_time", "per_rank_end_ms", "num_events", "num_comm_events",
                "straggle_ratio", "memory"):
        _assert_same(_mapped(_json(r[key])), _json(g[key]))
    assert g["end_time"] > 0 and len(g["memory"]) == got.strategy.pp_size
    _assert_same(_mapped(_trace_events(r["trace_path"])), _trace_events(g["trace_path"]))
    with open(tmp_path / "jax" / "simu_memory_snapshot.json") as f_ref, \
            open(tmp_path / "port" / "simu_memory_snapshot.json") as f_got:
        _assert_same(_without_ids(_mapped(json.load(f_ref))), _without_ids(json.load(f_got)))
    assert os.path.exists(tmp_path / "port" / "simu_result.json")


@pytest.mark.parametrize("reduce", [True, False], ids=["reduced", "every-rank"])
def test_world_ranks_with_a_straggler_match_jax(reduce):
    ref, got = _pair("tp1_pp2_dp4_mbs1", "llama3-8b", {}, {}, None)
    kw = dict(world_ranks=True, perturbation={1: 1.3, 6: 1.1}, reduce=reduce,
              granularity="chunk")
    r, g = ref.simulate(None, **kw), got.simulate(None, **kw)
    assert sorted(r) == sorted(g)
    _assert_same(_json(r), _json(g))
    base = got.simulate(None, world_ranks=True, reduce=reduce, granularity="chunk")
    assert g["end_time"] > base["end_time"]


def test_unported_simulate_options_name_their_roadmap_item():
    """``critical_path=True`` and ``faults=`` raised NotImplementedError
    naming ROADMAP queue A item 4 until the critical-path engine and the
    fault model were ported: both now run and match the JAX package (an
    empty scenario is dropped, so it equals the healthy run)."""
    ref, got = _pair("tp1_pp2_dp4_mbs1", "llama3-8b", {}, {}, None)
    from simumax_tpu.simulator.faults import FaultScenario as JaxScenario
    from simumax_tpu_torch.simulator.faults import FaultScenario

    results = []
    for kw_ref, kw in ((dict(critical_path=True), dict(critical_path=True)),
                       (dict(world_ranks=True, faults=JaxScenario([])),
                        dict(world_ranks=True, faults=FaultScenario([])))):
        r, g = ref.simulate(None, **kw_ref), got.simulate(None, **kw)
        _assert_same(_mapped(_json(r)), _json(g))
        results.append(g)
    assert results[0]["critical_path"]["schema"] == "simumax-critpath-v1"
    assert "faults" not in results[1]

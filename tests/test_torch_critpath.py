"""The port's critical-path engine (``observe/critpath.py``), DualPipe
projection (``parallel/dualpp.py``) and rebatch re-costing
(``search/prune.py``) against the JAX package's, through
``PerfLLM.critical_path``, ``simulate(critical_path=True)``,
``analysis_dualpp`` and ``rebatched_iter_time``.

Cells: the three of ``tests/torch_fault_cells.py`` (dense pp 2, MoE pp
4, MLA pp 2) and the blocking-send, overlapped-reduce dense cell. The
copies are plain Python doing the same float64 arithmetic in the same
order, so the tolerance is equality as JSON (``json.dumps(...,
sort_keys=True)``, byte for byte); the trace events, whose strings name
the attention backend, compare after ``test_torch_simulate._mapped``.
"""

import json
import os

import pytest

pytest.importorskip("torch")

from simumax_tpu import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.core.config import get_model_config as jax_model  # noqa: E402
from simumax_tpu.core.config import get_strategy_config as jax_strategy  # noqa: E402
from simumax_tpu.observe import critpath as jc  # noqa: E402
from simumax_tpu.simulator import faults as jf  # noqa: E402
from simumax_tpu_torch import PerfLLM  # noqa: E402
from simumax_tpu_torch.core.config import get_model_config, get_strategy_config  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError  # noqa: E402
from simumax_tpu_torch.observe import critpath as tc  # noqa: E402
from simumax_tpu_torch.simulator import faults as tf  # noqa: E402

from test_torch_simulate import _mapped, _trace_events  # noqa: E402
from torch_fault_cells import CELLS, SYNC_CELL, build_perf, mixed  # noqa: E402

ALL = {**CELLS, "dense-pp2-sync": SYNC_CELL}
IDS = sorted(ALL)
WORLD = dict(world_ranks=True, granularity="chunk", track_memory=False)


def _pair(key):
    return (build_perf(JaxPerfLLM, jax_model, jax_strategy, **ALL[key]),
            build_perf(PerfLLM, get_model_config, get_strategy_config, **ALL[key]))


def _bytes(x):
    return json.dumps(x, sort_keys=True, default=str)


@pytest.mark.parametrize("key", IDS)
def test_critical_path_matches_jax(key):
    ref, got = _pair(key)
    for kw in (dict(track_memory=False), WORLD):
        want, rep = ref.critical_path(**kw), got.critical_path(**kw)
        assert _bytes(rep) == _bytes(want), (key, kw)
    assert rep["schema"] == tc.CRITPATH_SCHEMA and rep["path"] and rep["divergence"]
    buckets = rep["waterfall"]["buckets"]
    assert sum(buckets.values()) * 1e3 == pytest.approx(rep["makespan_ms"], rel=1e-6)


@pytest.mark.parametrize("key", ["dense-pp2", "moe-pp4"])
def test_faulted_critical_path_and_its_diff_match_jax(key):
    ref, got = _pair(key)
    h = got.simulate(None, **WORLD)["end_time_ms"]
    reports = {}
    for name, perf, fm in (("jax", ref, jf), ("port", got, tf)):
        healthy = perf.critical_path(**WORLD)
        faulted = perf.critical_path(faults=mixed(fm.FaultEvent, fm.FaultScenario, h * 0.3,
                                                  death=False), **WORLD)
        diff = (jc if name == "jax" else tc).diff_critpath(healthy, faulted)
        reports[name] = (faulted, diff)
    assert _bytes(reports["port"]) == _bytes(reports["jax"])
    faulted, diff = reports["port"]
    assert faulted["meta"]["faulted"] and not diff["identical"]


def test_simulate_writes_the_report_and_annotates_the_trace(tmp_path):
    ref, got = _pair("dense-pp2")
    res = {name: perf.simulate(str(tmp_path / name), critical_path=True)
           for name, perf in (("jax", ref), ("port", got))}
    with open(res["jax"]["critical_path_path"]) as f_ref, \
            open(res["port"]["critical_path_path"]) as f_got:
        assert _bytes(json.load(f_got)) == _bytes(json.load(f_ref))
    assert os.path.basename(res["port"]["critical_path_path"]) == "critpath.json"
    events = _trace_events(res["port"]["trace_path"])
    assert _mapped(_trace_events(res["jax"]["trace_path"])) == events
    xs = [e for e in events if e.get("ph") == "X"]
    assert xs and all("on_critical_path" in e["args"] for e in xs)
    assert any(e["args"]["on_critical_path"] for e in xs)
    loaded = tc.load_report(res["port"]["critical_path_path"])
    assert tc.diff_critpath(loaded, loaded)["identical"]
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "other"}')
    with pytest.raises(ConfigError, match="not a simumax critical-path report"):
        tc.load_report(str(bad))


@pytest.mark.parametrize("key", IDS)
def test_analysis_dualpp_matches_jax(key):
    ref, got = _pair(key)
    want, rep = ref.analysis_dualpp(), got.analysis_dualpp()
    assert _bytes(rep) == _bytes(want)
    assert rep["dualpp_iter_time"] > 0 and len(rep["ranks"]) == got.strategy.pp_size


@pytest.mark.parametrize("key", IDS)
def test_rebatched_iter_time_matches_jax(key):
    ref, got = _pair(key)
    for mbc in (2, 8, 1):
        assert got.rebatched_iter_time(mbc) == ref.rebatched_iter_time(mbc), (key, mbc)
        assert got.strategy.micro_batch_num == mbc
        assert _bytes(got.analysis_cost()) == _bytes(ref.analysis_cost())

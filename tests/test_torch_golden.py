"""The port's ``PerfLLM`` against the committed golden results, and the
port's comparison helpers (``simumax_tpu_torch/testing.py``).

Mirrors ``tests/test_golden.py``: every case of
``tests/golden_results.json`` (the JAX package's TPU configs, read as
data) is estimated by the port and checked by the port's
``testing.ResultCheck`` at the JAX test's rtol 1e-6. The port's
``RelDiffComparator`` and ``ResultCheck`` are checked as the JAX file
checks its own, and held to the JAX package's on the same inputs
(equal verdicts and mismatch paths).
"""

import json
import os

import pytest

pytest.importorskip("torch")

from simumax_tpu import testing as jax_testing  # noqa: E402
from simumax_tpu_torch import PerfLLM  # noqa: E402
from simumax_tpu_torch.core.config import get_model_config, get_strategy_config  # noqa: E402
from simumax_tpu_torch.testing import RelDiffComparator, ResultCheck  # noqa: E402

from test_golden import CASES  # noqa: E402

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden_results.json")))


def run(strategy, model, system, **overrides):
    st = get_strategy_config(strategy)
    for k, v in overrides.items():
        setattr(st, k, v)
    st.__post_init__()
    perf = PerfLLM()
    perf.configure(st, model, system)
    perf.run_estimate()
    return perf


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden(case):
    strat, model, system, tweak, *rest = CASES[case]
    m = get_model_config(model)
    for k, v in (tweak or {}).items():
        setattr(m, k, v)
    p = run(strat, m, system, **(rest[0] if rest and rest[0] else {}))
    c, mm = p.analysis_cost(), p.analysis_mem()
    got = {
        "mfu": c["mfu"],
        "iter_time_ms": c["iter_time_ms"],
        "bubble_time_ms": c["bubble_time"] * 1e3,
        "optim_time_ms": c["optim_time"] * 1e3,
        "tgs": c["tgs"],
        "max_peak_gib": mm["max_peak_gib"],
        "stage_peaks_gib": [s["peak_gib"] for s in mm["stages"]],
        "stage_model_gib": [s["model_bytes"] / 2**30 for s in mm["stages"]],
    }
    rc = ResultCheck(rtol=1e-6)
    rc.check(got, GOLDEN[case])
    assert not rc.mismatches, "golden drift:\n" + rc.report()


def test_every_golden_case_is_known():
    assert sorted(GOLDEN) == sorted(CASES)


class TestComparators:
    def test_rel_diff(self):
        c = RelDiffComparator(rtol=0.01)
        assert c.check(100.4, 100.0)
        assert not c.check(102.0, 100.0)

    def test_result_check_collects_paths(self):
        rc = ResultCheck(rtol=0.01)
        rc.check({"a": 1.0, "b": {"c": [1, 2]}}, {"a": 2.0, "b": {"c": [1, 3]}})
        assert any("$.a" in m for m in rc.mismatches)
        assert any("$.b.c[1]" in m for m in rc.mismatches)

    @pytest.mark.parametrize("got,expect", [
        (0.0, 0.0), (1e-10, 0.0), (1e-8, 0.0), (100.09, 100.0), (100.2, 100.0),
        (-5.0, -5.004), (float("inf"), float("inf")), (3, 3.0),
    ])
    def test_rel_diff_agrees_with_the_jax_packages(self, got, expect):
        for rtol, atol in ((1e-3, 1e-9), (1e-2, 1e-6)):
            assert RelDiffComparator(rtol, atol).check(got, expect) == \
                jax_testing.RelDiffComparator(rtol, atol).check(got, expect)

    @pytest.mark.parametrize("got,expect", [
        ({"a": 1.0, "b": [1, 2, {"c": "x"}], "d": None, "e": True},
         {"a": 1.0005, "b": [1, 2, {"c": "y"}], "d": None, "e": False}),
        ({"a": [1, 2]}, {"a": [1, 2, 3]}),
        ({"a": 1}, {"a": {"b": 1}}),
        ({}, {"missing": 1, "skip": 2}),
        ([1.0, (2, 3)], [1.0, (2, 4)]),
    ])
    def test_result_check_agrees_with_the_jax_packages(self, got, expect):
        ours = ResultCheck(rtol=1e-3, ignore_keys=("skip",))
        theirs = jax_testing.ResultCheck(rtol=1e-3, ignore_keys=("skip",))
        assert ours.check(got, expect) == theirs.check(got, expect)
        assert ours.mismatches == theirs.mismatches
        assert ours.report() == theirs.report()

"""The harness at a tiny size on the card, through the port's CUDA
kernels: each cell's path is correct against its plain reference, and
each cell's control and faults are caught. Run on the card:
``python -m pytest -m cuda portbench/tests``."""

import pytest

from portbench import compare, faults, readings, run
from portbench.tests.tiny import CELLS, tiny_spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_on_the_card_is_correct(card, workload):
    spec = tiny_spec(workload)
    result = run.run_cell(spec, 3000000123, 0.2, True, device=card)
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert set(result["metrics"]) == set(spec.per_layer)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_the_faults_fail_on_the_card(card, workload):
    spec = tiny_spec(workload)
    for seed in (1, 2, 3):
        nums = readings.compare_seed(spec, seed, ["control", "half_batch"], card)
        for kind, (found, _side, _ref, _s) in nums.items():
            ok, compared = compare.judge(found, spec.cell["limits"])
            assert not ok, (kind, compared)
    result = run.run_cell(tiny_spec(workload), 5, 0.1, False, device=card,
                          wrap_step=faults.unchanged)
    assert not result["correct"]

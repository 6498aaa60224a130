"""The harness end to end at a tiny size on the CPU, through the port's
plain kernel versions: each cell's path held to its plain reference, the
faults a training cell can have caught, no JAX loaded, and a reference
that imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import compare, faults, manifest, readings, run
from portbench.tests.tiny import CELLS, tiny_spec

#: limits for the tiny sizes, set as the cells' own are (between the
#: sound runs' largest reading and the control's or a fault's smallest)
#: from CPU readings at these sizes: seeds 1-12 sound, 1-4 control and
#: half batch. Sound / control / half batch: bf16 loss 3.7e-4 / 7.5e-4 /
#: 9.1e-3, grad1 1.6e-3 / 9.8e-3 / 0.40, change 2.3e-3 / 3.4e-3 / 0.22;
#: int8 loss 2.5e-3 / 6.9e-3 / 9.9e-3, grad1 1.3e-2 / 0.10 / 0.40, change
#: 7.5e-3 / 0.29 / 0.22; MoE (the control's router in int8 too) loss 6.7e-5 /
#: 8.3e-5 / 3.0e-3, grad1 1.5e-2 / 7.0e-2 / 0.41, change 1.5e-3 / 2.0e-2 / 0.22
TINY_LIMITS = {
    "aquila2-7b.bf16-flash-s2048x4": {"loss_gap": 2e-3, "grad1_gap": 5e-3, "change_gap": 0.02},
    "aquila2-7b.int8-flash-s2048x4": {"loss_gap": 8e-3, "grad1_gap": 0.04, "change_gap": 0.05},
    "mixtral-8x7b.bf16-s4096x2": {"loss_gap": 1e-3, "grad1_gap": 0.04, "change_gap": 8e-3},
}


def _spec(workload):
    spec = tiny_spec(workload)
    spec.cell["limits"] = dict(TINY_LIMITS[workload])
    return spec


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_is_correct(workload):
    result = run.run_cell(_spec(workload), 3000000123, 0.2, False, device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"tokens_per_s", "step_ms_p90", "setup_s"}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_under_the_timed_path_is_caught(workload, fault):
    result = run.run_cell(_spec(workload), 7, 0.1, False, device="cpu",
                          wrap_step=faults.FAULTS[fault])
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(workload):
    for seed in (1, 2, 3):
        nums = readings.compare_seed(_spec(workload), seed, ["control"], "cpu")["control"][0]
        ok, compared = compare.judge(nums, TINY_LIMITS[workload])
        assert not ok, compared


def test_no_jax_after_a_run():
    code = ("import sys; from portbench import run; from portbench.tests.tiny import tiny_spec; "
            "r = run.run_cell(tiny_spec('aquila2-7b.int8-flash-s2048x4'), 1, 0.1, False, "
            "device='cpu'); print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "simumax_tpu_torch_fake", object())
    assert "simumax_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "simumax_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert {"simumax_tpu.fake", "jaxlib.fake"} <= set(run.forbidden_modules())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py"):
        mods = set(_imports(os.path.join(manifest.BENCH_DIR, name)))
        assert mods <= {"__future__", "dataclasses", "math", "typing", "torch",
                        "torch.nn.functional", "torch.utils.checkpoint", "portbench.weights"}
    code = "import sys, portbench.reference; print(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "simumax_tpu_torch" not in out.stdout and "'jax'" not in out.stdout


def test_the_command_fails_without_a_card_or_without_the_program(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    # a directory that holds only BENCHMARK.json and the harness
    import shutil

    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""

"""The harness end to end at a tiny size on the CPU, through the port's
plain kernel versions: each cell's path held to its plain reference at its
kind's tiny limits (``portbench/tests/kinds/<kind>.py``), the faults a
training cell can have caught, no JAX loaded, and a reference that imports
nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from portbench import compare, faults, manifest, readings, run
from portbench.tests.tiny import CELLS, tiny_spec


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_is_correct(workload):
    result = run.run_cell(tiny_spec(workload), 3000000123, 0.2, False, device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"tokens_per_s", "step_ms_p90", "setup_s"}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_under_the_timed_path_is_caught(workload, fault):
    result = run.run_cell(tiny_spec(workload), 7, 0.1, False, device="cpu",
                          wrap_step=faults.FAULTS[fault])
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(workload):
    spec = tiny_spec(workload)
    for seed in (1, 2, 3):
        nums = readings.compare_seed(spec, seed, ["control"], "cpu")["control"][0]
        ok, compared = compare.judge(nums, spec.cell["limits"])
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


#: what reference.py and weights.py may import, at any depth: torch, the
#: weights and the manifest, which loads the kinds
REFERENCE_IMPORTS = {"__future__", "dataclasses", "math", "typing", "torch", "torch.nn.functional",
                     "torch.utils.checkpoint", "portbench.weights", "portbench.manifest"}
#: what a kind module may import at module level: the reference's list, and
#: the harness's modules that import nothing of the program at module level
#: (``program`` imports the port inside ``build``, which a kind calls from
#: its own ``build``)
KIND_IMPORTS = REFERENCE_IMPORTS | {"portbench.reference", "portbench.work",
                                    "portbench.program"}
#: a tiny run of every kind's reference loss, then the top-level names of
#: every module loaded
REFERENCE_ONLY = """
import glob, json, os, sys
from portbench import manifest, reference, weights
from portbench.tests.tiny import tiny_config
for path in sorted(glob.glob(os.path.join(manifest.BENCH_DIR, "configs", "*.json"))):
    config = tiny_config(manifest.read_json(path))
    m = weights.Model.from_config(config)
    batches = weights.make_batches(5, 1, 2, 16, m.vocab, "cpu")
    reference.follow(m, config["optimizer"], 5, batches, 1, None, "cpu")
for path in glob.glob(os.path.join(manifest.BENCH_DIR, "kinds", "*.py")):
    manifest.load_kind(os.path.basename(path)[:-3])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _imports(path, top_level=False):
    """The modules a file imports (``portbench.<name>`` for ``from
    portbench import <name>``), at module level only if ``top_level``."""
    tree = ast.parse(open(path).read())
    for node in tree.body if top_level else ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module == "portbench":
            yield from (f"portbench.{a.name}" for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    """reference.py and weights.py anywhere, each kind module at module level
    (its ``build`` imports the port when called), and every kind's reference
    run in a process of its own."""
    for name in ("reference.py", "weights.py"):
        mods = set(_imports(os.path.join(manifest.BENCH_DIR, name)))
        assert mods <= REFERENCE_IMPORTS, (name, sorted(mods - REFERENCE_IMPORTS))
    kinds = sorted(glob.glob(os.path.join(manifest.BENCH_DIR, "kinds", "*.py")))
    assert {os.path.basename(k) for k in kinds} >= {"dense.py", "moe.py"}
    for path in kinds:
        mods = set(_imports(path, top_level=True))
        assert mods <= KIND_IMPORTS, (path, sorted(mods - KIND_IMPORTS))
    out = subprocess.run([sys.executable, "-c", REFERENCE_ONLY], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded and not loaded & {"simumax_tpu_torch", "simumax_tpu", "jax"}


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

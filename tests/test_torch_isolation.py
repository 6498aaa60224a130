"""The port stands alone: no module of ``simumax_tpu_torch``, and not
``chip_smoke.py``, imports jax or the JAX package, and the card-only
entry points refuse to run without a card.

The import check runs in a fresh interpreter where ``jax`` and
``simumax_tpu`` cannot be imported at all (``sys.modules[...] = None``).
The source scan reads every ``.py`` and ``.cu`` file of the package for
an ``import jax`` and for any ``simumax_tpu`` not followed by
``_torch``; ``chip_smoke.py`` names the JAX package's kernel files in
its report (as data), so there only its import statements are checked.
"""

import ast
import os
import re
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "simumax_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
FORBIDDEN_TEXT = re.compile(r"\bimport jax\b|\bfrom jax\b|simumax_tpu(?!_torch)")


def _sources(exts=(".py", ".cu")):
    for dirpath, dirnames, filenames in os.walk(PACKAGE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(exts):
                yield os.path.join(dirpath, fn)


def _modules():
    for path in _sources((".py",)):
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        yield rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


#: the fleet and service modules, which the module walk must reach
FLEET_AND_SERVICE = [f"simumax_tpu_torch.fleet.{m}" for m in ("trace", "sim", "report")] + [
    "simumax_tpu_torch.fleet", "simumax_tpu_torch.observe.fleetledger",
    "simumax_tpu_torch.service"] + [
    f"simumax_tpu_torch.service.{m}" for m in (
        "store", "coalesce", "ring", "router", "planner", "warmer", "pool", "node", "chaos",
        "server")]
#: the command line, its entry point and the golden-comparison helpers
COMMAND_LINE = [f"simumax_tpu_torch.{m}" for m in ("cli", "__main__", "testing")]
#: the dp x tp step, context parallelism, the collective and memory
#: readers, the entry points and the streamlit app
LAST_MODULES = [f"simumax_tpu_torch.{m}" for m in (
    "torchref.model", "torchref.context_parallel", "calibration.validate", "entry", "app",
    "app.streamlit_app")]


def test_every_port_module_imports_without_jax_or_the_jax_package():
    mods = sorted(_modules())
    assert "simumax_tpu_torch.torchref.kernels" in mods and len(mods) >= 20
    assert set(FLEET_AND_SERVICE) <= set(mods)
    assert set(COMMAND_LINE) <= set(mods)
    assert set(LAST_MODULES) <= set(mods)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['simumax_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'simumax_tpu' or m.startswith('simumax_tpu.'))\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_the_command_line_runs_without_jax_or_the_jax_package():
    """``python -m simumax_tpu_torch`` in an interpreter where ``jax`` and
    ``simumax_tpu`` cannot be imported: ``--help`` and ``list`` run, and
    an estimate on the CPU runs to its end."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['simumax_tpu'] = None\n"
        "sys.argv = ['simumax_tpu_torch'] + sys.argv[1:]\n"
        "runpy.run_module('simumax_tpu_torch', run_name='__main__', alter_sys=True)\n"
    )
    for args in (["--help"], ["list"],
                 ["perf", "--model", "llama2-tiny", "--strategy", "tp1_pp2_dp4_mbs1",
                  "--system", "tpu_v5e_256", "--device", "cpu", "--no-cache"]):
        proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout


def test_port_sources_never_name_jax_imports_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if FORBIDDEN_TEXT.search(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    with open(SMOKE) as f:
        src = f.read()
    assert not re.search(r"\bimport jax\b|\bfrom jax\b", src)
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "simumax_tpu"), name


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [subprocess.run([sys.executable, SMOKE], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)  # a directory with the script and nothing else
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                               capture_output=True, text=True, timeout=120))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_every_public_device_parameter_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU: a
    public function or method of the port with a ``device`` parameter
    gives it no default or the default ``"cuda"``."""
    import importlib
    import inspect

    def public_functions(mod):
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield name, obj
            elif inspect.isclass(obj):
                for attr, fn in vars(obj).items():
                    fn = getattr(fn, "__func__", fn)  # staticmethod, classmethod
                    if not attr.startswith("_") and inspect.isfunction(fn):
                        yield f"{name}.{attr}", fn

    seen, wrong = [], []
    for modname in sorted(_modules()):
        mod = importlib.import_module(modname)
        for name, fn in public_functions(mod):
            param = inspect.signature(fn).parameters.get("device")
            if param is None:
                continue
            seen.append(f"{modname}.{name}")
            if param.default is not inspect.Parameter.empty and param.default != "cuda":
                wrong.append(f"{modname}.{name}: device={param.default!r}")
    assert "simumax_tpu_torch.torchref.parallel.run_pp_steps" in seen and len(seen) >= 10
    assert not wrong, "\n".join(wrong)


def test_the_serving_entry_points_take_the_card_by_default():
    """The planner, the server and the worker pool run the kernels on
    the card unless told ``device="cpu"``; a fleet node runs them where
    its planner does."""
    import inspect

    from simumax_tpu_torch.service.planner import Planner
    from simumax_tpu_torch.service.pool import WorkerPool
    from simumax_tpu_torch.service.server import make_server

    for fn in (Planner.__init__, make_server, WorkerPool.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__

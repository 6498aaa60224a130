"""What a run is told by name: the cell, its configuration and its metrics.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``) and the metrics; each cell's traffic is
``portbench/cells/<cell>.json``, each configuration
``portbench/configs/<config>.json`` and each metric a reader of its own,
``portbench/metrics/<metric>.py``. A configuration's ``model`` names its
kind, ``portbench/kinds/<kind>.py``: the model's sizes, weights, port
step, plain reference and work counts. A later change adds a cell, a
configuration, a metric or a model kind by adding files and entries,
without editing one that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: what a model kind's module gives: its sizes (``sizes(config)``, the
#: run's ``weights.Model``), its leaves, the port's step, the plain
#: reference's loss and the work counts
KIND_API = ("sizes", "leaf_specs", "build", "loss", "linear_shapes", "attention_ops",
            "attention_elements", "param_count", "touched_params")


@dataclasses.dataclass
class Spec:
    """One cell as a run takes it."""

    workload: str
    chips: int
    cell: Dict
    config: Dict
    #: readers of the cell's end-to-end and per-layer metrics, by name
    end_to_end: Dict[str, ModuleType]
    per_layer: Dict[str, ModuleType]


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The reader module ``metrics/<name>.py`` (loaded from its file, so a
    name may hold a dot)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_kind(name: str) -> ModuleType:
    """The model kind ``kinds/<name>.py``, loaded from its file once a
    process (registered before it runs, so its dataclasses resolve)."""
    key = f"portbench_kind_{name}"
    if key not in sys.modules:
        path = os.path.join(BENCH_DIR, "kinds", f"{name}.py")
        if not NAME.match(name) or not os.path.exists(path):
            raise FileNotFoundError(f"no model kind {name!r} at {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
            missing = [attr for attr in KIND_API if not hasattr(module, attr)]
            if missing:
                raise AttributeError(f"model kind {name!r} lacks {missing}")
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, manifest: Optional[Dict] = None, root: str = ROOT) -> Spec:
    """The :class:`Spec` of ``workload`` from ``BENCHMARK.json`` (or the
    ``manifest`` given) and the files it names."""
    manifest = manifest or read_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in manifest["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    bench_dir = os.path.join(root, "portbench")
    cell = read_json(os.path.join(bench_dir, "cells", f"{workload}.json"))
    config = read_json(os.path.join(bench_dir, "configs", f"{entry['config']}.json"))
    if cell["config"] != entry["config"]:
        raise ValueError(f"cell {workload!r} names config {cell['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")

    def readers(kind: str) -> Dict[str, ModuleType]:
        return {m["name"]: load_reader(m["name"], bench_dir)
                for m in manifest[kind] if _applies(m, workload)}

    return Spec(workload, int(entry["chips"]), cell, config, readers("end_to_end"),
                readers("per_layer"))


def metric_entries(manifest: Dict) -> List[Dict]:
    return list(manifest["end_to_end"]) + list(manifest["per_layer"])

"""Tiny versions of the benchmark's cells, for the tests: every cell of
``BENCHMARK.json``, its own files with the configuration cut to its kind's
tiny sizes (a few hundred thousand parameters), the traffic to 2 x 64
tokens and the limits to the kind's tiny limits for the cell's linear type.
A kind's tiny sizes (``SIZES``) and limits (``LIMITS``, by ``linear``) are
``kinds/<kind>.py`` beside this file."""

import copy
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict

from portbench import manifest

TINY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kinds")


def read_manifest():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = tuple(w["name"] for w in read_manifest()["workloads"])


def tiny_kind(kind: str) -> ModuleType:
    """The tests' ``kinds/<kind>.py``: the kind's tiny sizes and limits."""
    path = os.path.join(TINY_DIR, f"{kind}.py")
    if not manifest.NAME.match(kind) or not os.path.exists(path):
        raise FileNotFoundError(f"no tiny sizes for model kind {kind!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_tiny_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_config(config: Dict) -> Dict:
    """A configuration cut to its kind's tiny sizes."""
    return dict(copy.deepcopy(config), **tiny_kind(config["model"]).SIZES)


def tiny_spec(workload: str, seq: int = 64, mbs: int = 2) -> manifest.Spec:
    """The cell's :class:`manifest.Spec` at the tiny sizes, with its own
    readers."""
    spec = manifest.load(workload)
    limits = tiny_kind(spec.config["model"]).LIMITS[spec.cell["linear"]]
    cell = dict(spec.cell, seq=seq, mbs=mbs, batches=6, limits=dict(limits))
    return manifest.Spec(workload, 1, cell, tiny_config(spec.config), spec.end_to_end,
                         spec.per_layer)

"""BENCHMARK.json, the cell, configuration and metric files: their schema,
and the characters of every name and unit."""

import json
import os
import re

import pytest

from portbench import compare, manifest
from portbench.tests.tiny import read_manifest

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
LINE = re.compile(r"^[^\t\n]{1,200}$")
#: keys that name a width, which ``reduced`` may never name
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|projection|head_size|"
                   r"expansion|experts_per_tok|_dim$|_rank$)")


@pytest.fixture(scope="module")
def bench():
    return read_manifest()


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path) and ".." not in path
        assert os.path.isdir(os.path.join(manifest.ROOT, path))
        assert not path.endswith("_torch")
    named = [w for w in bench["command"] if os.path.exists(os.path.join(manifest.ROOT, w))]
    assert all(any(w.startswith(p + "/") for p in bench["paths"]) for w in named)
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells(bench):
    seconds = bench["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in manifest.metric_entries(bench)]
    assert all(manifest.NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    metrics = manifest.metric_entries(bench)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert manifest.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_configs_and_cells(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["name"] in used and LINE.match(c["source"]) and LINE.match(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        config = manifest.read_json(os.path.join(manifest.ROOT, c["file"]))
        assert config["name"] == c["name"] and config["source"] == c["source"]
        kind = manifest.load_kind(config["model"])
        assert os.path.dirname(kind.__file__) == os.path.join(manifest.BENCH_DIR, "kinds")
        assert len(c["reduced"]) <= 16 and set(c["reduced"]) == set(config["reduced"])
        for key in c["reduced"]:
            assert manifest.NAME.match(key) and not WIDTH.search(key)
            assert config["published"][key] != config[key]
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert manifest.NAME.match(w["traffic"]) and manifest.NAME.match(w["config"])
        spec = manifest.load(w["name"])
        assert spec.cell["why"] == w["why"]
        assert spec.cell["limits"] and set(spec.cell["limits"]) <= set(compare.NUMBERS)
        assert spec.cell["control"]["kind"] in ("program", "reference")
        assert spec.cell["linear"] in ("bf16", "int8")
        assert spec.cell["attention"] in ("flash", "math")
        assert spec.cell["batches"] >= 4
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(pairs) // 4)


def test_every_metric_has_a_reader_that_declares_it(bench):
    for m in bench["end_to_end"]:
        assert manifest.load_reader(m["name"]).UNIT == m["unit"]
    for m in bench["per_layer"]:
        reader = manifest.load_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
    for w in bench["workloads"]:
        spec = manifest.load(w["name"])
        assert "setup_s" in spec.end_to_end and len(spec.end_to_end) >= 2
        assert spec.per_layer


def test_every_file_is_named_from_the_characters_of_a_name():
    for dirpath, _dirs, files in os.walk(manifest.BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(dirpath, manifest.ROOT)
        for name in files:
            assert re.match(r"^[A-Za-z0-9_./-]+$", os.path.join(rel, name))


def test_the_manifest_is_plain_json():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        json.loads(f.read(), parse_constant=lambda c: pytest.fail(f"non-JSON constant {c}"))

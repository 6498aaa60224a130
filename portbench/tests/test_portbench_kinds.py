"""The model kinds (``portbench/kinds/<kind>.py``): the dense and MoE kinds
give the bits, losses and counts the harness gave before they had files of
their own, and a third kind comes in by new files alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import manifest, reference, weights, work
from portbench.tests.tiny import tiny_config

SEED = 2147483653
#: what the harness gave before the kinds had files of their own, at the
#: kind's tiny sizes on the CPU: a digest of make_params' bits (each leaf's
#: path and its bf16 bits, in order), the reference's three losses in
#: float32 and at the int8 rule (router too), the sums of its first
#: gradients' and changes' leaf norms, and a digest of every work count at
#: the tiny and the published sizes (one CPU thread)
PINNED = {
    "aquila2-7b": {
        "params": "7b271c44e1d102d6dc796c58c89752fc705521d141b3f178a1fc94074d682fa7",
        "losses": {None: [5.941551685333252, 6.218437671661377, 6.14183235168457],
                   127: [5.945962429046631, 6.21541690826416, 6.142141342163086]},
        "grad1": {None: 20.8319246545434, 127: 20.86749704927206},
        "change": {None: 0.20677059143781662, 127: 0.20662811305373907},
        "counts": "30d2c0fca7db6388266c53736dfab4b3022e3b7834b0f010f7cc76eb6d85a20e",
        "param_count": (295552, 2438336512),
    },
    "mixtral-8x7b": {
        "params": "51b1670969f47f8c89da3ea26b055950784ecde5d0bfdb1585b8412be6919419",
        "losses": {None: [5.575850486755371, 5.593106746673584, 5.552371501922607],
                   127: [5.576304912567139, 5.592761993408203, 5.551438808441162]},
        "grad1": {None: 5.490095665911213, 127: 5.644234778359532},
        "change": {None: 0.3838523109443486, 127: 0.3840103102847934},
        "counts": "50c424041548504f47363213adf7fff7d24cbb46fc3fbe787754128ed027eb94",
        "param_count": (362112, 3164688384),
    },
}


def _config(name, tiny):
    config = manifest.read_json(os.path.join(manifest.BENCH_DIR, "configs", f"{name}.json"))
    return tiny_config(config) if tiny else config


def _counts(m):
    return {"linear_shapes": work.linear_shapes(m), "param_count": work.param_count(m),
            "touched": work.touched_params(m), "attention_ops": work.attention_ops(m, 2, 64),
            "attention_ideal_s": work.attention_ideal_s(m, 8, 1024),
            "gemm_bf16": work.gemm_ideal_s(m, 8192, "bf16"),
            "gemm_int8": work.gemm_ideal_s(m, 8192, "int8"),
            "model_ideal_s": work.model_ideal_s(m, 4, 2048, "bf16"),
            "optimizer_bytes": work.optimizer_bytes(m),
            "optimizer_ideal_s": work.optimizer_ideal_s(m), "paths": len(weights.paths(m))}


@pytest.fixture
def one_thread():
    """One CPU thread: the reference's norms are sums whose order the
    thread count sets."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_a_kind_gives_the_pinned_bits_losses_and_counts(name, one_thread):
    pinned = PINNED[name]
    config = _config(name, tiny=True)
    m = weights.Model.from_config(config)
    digest = hashlib.sha256()
    for path, t in weights.leaf_stream(m, SEED, "cpu"):
        digest.update(repr(path).encode())
        digest.update(t.view(torch.int16).numpy().tobytes())
    assert digest.hexdigest() == pinned["params"]
    batches = weights.make_batches(SEED, 3, 2, 64, m.vocab, "cpu")
    for levels in (None, 127):
        ref = reference.follow(m, config["optimizer"], SEED, batches, 3, levels, "cpu", levels)
        assert ref["loss"] == pinned["losses"][levels]
        assert sum(ref["grad1"].values()) == pinned["grad1"][levels]
        assert sum(ref["change"].values()) == pinned["change"][levels]
    full = weights.Model.from_config(_config(name, tiny=False))
    counts = {"tiny": _counts(m), "full": _counts(full)}
    assert (counts["tiny"]["param_count"], counts["full"]["param_count"]) == pinned["param_count"]
    text = json.dumps(counts, sort_keys=True)
    assert hashlib.sha256(text.encode()).hexdigest() == pinned["counts"]


#: a third kind, multi-query attention with GPT-2's names for its sizes; its
#: step and reference are the dense kind's, which runs one kv head as GQA
THIRD_KIND = '''
"""Multi-query attention (one kv head) in the dense block."""

from portbench.manifest import load_kind
from portbench.weights import Model

DENSE = load_kind("dense")


def sizes(cfg):
    return Model(kind=cfg["model"], vocab=int(cfg["vocab_size"]), hidden=int(cfg["n_embd"]),
                 heads=int(cfg["n_head"]), kv_heads=1,
                 head_dim=int(cfg["n_embd"]) // int(cfg["n_head"]),
                 layers=int(cfg["n_layer"]), ffn=int(cfg["n_inner"]),
                 rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]))


leaf_specs = DENSE.leaf_specs
build = DENSE.build
loss = DENSE.loss
linear_shapes = DENSE.linear_shapes
attention_ops = DENSE.attention_ops
attention_elements = DENSE.attention_elements
param_count = DENSE.param_count
touched_params = DENSE.touched_params
'''
#: the third kind's tiny sizes and limits for the tests, beside the dense
#: kind's
THIRD_TINY = '''
SIZES = {"n_embd": 128, "n_inner": 128, "n_head": 2, "n_layer": 2, "vocab_size": 256}
LIMITS = {"bf16": {"loss_gap": 2e-3, "grad1_gap": 5e-3, "change_gap": 0.02}}
'''
THIRD_RUN = """
import json, sys
from portbench import run, weights, work
from portbench.tests.tiny import CELLS, tiny_spec
spec = tiny_spec("mqa-7b.bf16-flash-s2048x4")
m = weights.Model.from_config(spec.config)
result = run.run_cell(spec, 3000000123, 0.2, False, device="cpu")
leaves = sum(t.numel() for _p, t in weights.leaf_stream(m, 1, "cpu"))
print(json.dumps({"cells": CELLS, "correct": result["correct"], "compared": result["compared"],
                  "kv_heads": m.kv_heads, "params": [work.param_count(m), leaves],
                  "kind_loaded": "portbench_kind_mqa" in sys.modules}))
"""


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_third_kind_runs_correct_from_new_files_alone(tmp_path):
    """A copy of the harness takes a new kind by a kind module, its tiny
    sizes for the tests, a configuration, a cell and a ``workloads`` entry,
    and runs its tiny cell correct on the CPU with no file that was there
    changed."""
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    assert before == _digests(manifest.BENCH_DIR)
    bench = manifest.read_json(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    cell_name = "mqa-7b.bf16-flash-s2048x4"
    bench["workloads"].append({"name": cell_name, "config": "mqa-7b",
                               "traffic": "bf16-flash-s2048x4", "chips": 1,
                               "why": "a dense step with one kv head"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (tmp_path / "portbench" / "kinds" / "mqa.py").write_text(THIRD_KIND)
    (tmp_path / "portbench" / "tests" / "kinds" / "mqa.py").write_text(THIRD_TINY)
    config = _config("aquila2-7b", tiny=False)
    config = {"name": "mqa-7b", "model": "mqa", "n_embd": config["hidden_size"],
              "n_inner": config["intermediate_size"], "n_head": config["num_attention_heads"],
              "n_layer": config["num_hidden_layers"], "vocab_size": config["vocab_size"],
              "rope_theta": config["rope_theta"], "rms_norm_eps": config["rms_norm_eps"],
              "optimizer": config["optimizer"]}
    (tmp_path / "portbench" / "configs" / "mqa-7b.json").write_text(json.dumps(config))
    cell = manifest.read_json(os.path.join(manifest.BENCH_DIR, "cells",
                                           "aquila2-7b.bf16-flash-s2048x4.json"))
    cell["config"] = "mqa-7b"
    (tmp_path / "portbench" / "cells" / f"{cell_name}.json").write_text(json.dumps(cell))

    out = subprocess.run([sys.executable, "-c", THIRD_RUN], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{manifest.ROOT}"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["kind_loaded"] and got["kv_heads"] == 1 and cell_name in got["cells"]
    assert got["correct"], got["compared"]
    assert got["params"][0] == got["params"][1]
    after = _digests(tmp_path / "portbench")
    added = {os.path.join("kinds", "mqa.py"), os.path.join("tests", "kinds", "mqa.py"),
             os.path.join("configs", "mqa-7b.json"),
             os.path.join("cells", f"{cell_name}.json")}
    assert set(after) - set(before) == added
    assert {k: after[k] for k in before} == before

"""Tiny versions of the benchmark's cells, for the tests: the cells'
own files with the configuration cut to a few hundred thousand
parameters and the traffic to 2 x 64 tokens."""

import copy
import json
import os

from portbench import manifest

CELLS = ("aquila2-7b.bf16-flash-s2048x4", "aquila2-7b.int8-flash-s2048x4",
         "mixtral-8x7b.bf16-s4096x2")
#: the tiny sizes; head_dim 64 and a sequence of 64 let the flash path run
TINY = {"hidden_size": 128, "intermediate_size": 128, "num_attention_heads": 2, "head_dim": 64,
        "num_hidden_layers": 2, "vocab_size": 256}


def tiny_spec(workload: str, seq: int = 64, mbs: int = 2) -> manifest.Spec:
    """The cell's :class:`manifest.Spec` at the tiny sizes, with its own
    readers."""
    spec = manifest.load(workload)
    config = copy.deepcopy(spec.config)
    config.update(TINY)
    if config["model"] == "moe":
        config.update(num_key_value_heads=1, num_local_experts=4, intermediate_size=64)
    else:
        config.update(num_key_value_heads=2)
    cell = dict(spec.cell, seq=seq, mbs=mbs, batches=6)
    return manifest.Spec(workload, 1, cell, config, spec.end_to_end, spec.per_layer)


def read_manifest():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)

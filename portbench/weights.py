"""The model's shapes, its weights and its token batches, made from the run's seed.

Both sides of a run take what is made here: the program under test gets the
weights as its parameter tree and the batches as its feed; the plain
reference makes the same weights again from the same seed. Everything is
made on the device by seeded ``torch.Generator`` calls, one call a leaf,
in the type the weights are served in (bf16), so the same seed on the same
device gives the same bits. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch

#: offset of the batch generator's seed from the weights' (both generators
#: take any seed the benchmark is given; this keeps their streams apart)
BATCH_SEED_OFFSET = 1 << 40


@dataclasses.dataclass(frozen=True)
class Model:
    """A configuration file's run sizes, in the names the harness uses."""

    kind: str  # "dense" or "moe"
    vocab: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    layers: int
    ffn: int  # the dense intermediate size, or one expert's
    rope_theta: float
    eps: float
    experts: int = 0
    topk: int = 0
    capacity_factor: float = 0.0

    @classmethod
    def from_config(cls, cfg: Dict) -> "Model":
        moe = cfg["model"] == "moe"
        return cls(
            kind=cfg["model"],
            vocab=int(cfg["vocab_size"]),
            hidden=int(cfg["hidden_size"]),
            heads=int(cfg["num_attention_heads"]),
            kv_heads=int(cfg["num_key_value_heads"]),
            head_dim=int(cfg["head_dim"]),
            layers=int(cfg["num_hidden_layers"]),
            ffn=int(cfg["intermediate_size"]),
            rope_theta=float(cfg["rope_theta"]),
            eps=float(cfg["rms_norm_eps"]),
            experts=int(cfg["num_local_experts"]) if moe else 0,
            topk=int(cfg["num_experts_per_tok"]) if moe else 0,
            capacity_factor=float(cfg["capacity_factor"]) if moe else 0.0,
        )


Path = Tuple  # ("layers", 3, "qkv") and the like


def leaf_specs(m: Model) -> List[Tuple[Path, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter in the program's layout,
    in the order they are made; scale 0 marks a norm weight (ones). The
    scales are the program's own initialisers': the dense model's
    1 / sqrt(fan in) (0.02 for the embedding), the MoE model's 0.02."""
    h, d = m.hidden, m.head_dim
    qkv = (h, (m.heads + 2 * m.kv_heads) * d)
    if m.kind == "dense":
        specs = [(("embedding",), (m.vocab, h), 0.02)]
        for i in range(m.layers):
            specs += [
                (("layers", i, "input_norm"), (h,), 0.0),
                (("layers", i, "qkv"), qkv, h ** -0.5),
                (("layers", i, "out"), (m.heads * d, h), (m.heads * d) ** -0.5),
                (("layers", i, "pre_mlp_norm"), (h,), 0.0),
                (("layers", i, "up"), (h, 2 * m.ffn), h ** -0.5),
                (("layers", i, "down"), (m.ffn, h), m.ffn ** -0.5),
            ]
        return specs + [(("final_norm",), (h,), 0.0), (("lm_head",), (h, m.vocab), h ** -0.5)]
    if m.kind != "moe":
        raise ValueError(f"unknown model kind {m.kind!r}")
    e = m.experts
    specs = [(("embedding",), (m.vocab, h), 0.02)]
    for i in range(m.layers):
        specs += [
            (("layers", i, "input_norm"), (h,), 0.0),
            (("layers", i, "qkv"), qkv, 0.02),
            (("layers", i, "out"), (m.heads * d, h), 0.02),
            (("layers", i, "pre_mlp_norm"), (h,), 0.0),
            (("layers", i, "gate"), (h, e), 0.02),
            (("layers", i, "moe_up"), (e, h, 2 * m.ffn), 0.02),
            (("layers", i, "moe_down"), (e, m.ffn, h), 0.02),
        ]
    return specs + [(("final_norm",), (h,), 0.0), (("lm_head",), (h, m.vocab), 0.02)]


def leaf_stream(m: Model, seed: int, device) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, bf16 tensor) of every parameter, made in :func:`leaf_specs`'
    order by one generator seeded with ``seed``: the same bits each time
    it is walked on one device, so a leaf can be made again, one at a
    time, long after the program has changed its copy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, shape, scale in leaf_specs(m):
        if scale == 0.0:
            yield path, torch.ones(shape, dtype=torch.bfloat16, device=device)
        else:
            w = torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=device)
            yield path, w.mul_(scale)


def set_path(tree: Dict, path: Path, value) -> None:
    """Put ``value`` at ``path``: ``(name,)`` or ``("layers", i, name)``."""
    if len(path) == 1:
        tree[path[0]] = value
        return
    _layers, i, name = path
    layers = tree.setdefault("layers", [])
    while len(layers) <= i:
        layers.append({})
    layers[i][name] = value


def get_path(tree, path: Path):
    for key in path:
        tree = tree[key]
    return tree


def make_params(m: Model, seed: int, device) -> Dict:
    """The parameter tree in the program's layout (``embedding``,
    ``layers`` [...], ``final_norm``, ``lm_head``), bf16, each leaf
    requiring its gradient."""
    params: Dict = {}
    for path, t in leaf_stream(m, seed, device):
        set_path(params, path, t.requires_grad_(True))
    return params


def paths(m: Model) -> List[Path]:
    return [path for path, _shape, _scale in leaf_specs(m)]


def make_batches(seed: int, count: int, mbs: int, seq: int, vocab: int, device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` batches of (ids, targets), each [mbs, seq] int64 on the
    device, the targets the ids shifted by one: uniform token ids from a
    generator seeded apart from the weights'. Every row of every batch is
    drawn afresh, so no two steps see the same rows."""
    gen = torch.Generator(device=device).manual_seed(seed + BATCH_SEED_OFFSET)
    ids = torch.randint(0, vocab, (count, mbs, seq + 1), generator=gen, device=device)
    return [(ids[i, :, :-1].contiguous(), ids[i, :, 1:].contiguous()) for i in range(count)]


def change_norms(m: Model, seed: int, current: Dict, device) -> Dict[Path, float]:
    """Each leaf's norm of (current - initial), in float32, the initial
    weights made again from the seed one leaf at a time."""
    out = {}
    with torch.no_grad():
        for path, p0 in leaf_stream(m, seed, device):
            out[path] = float(torch.linalg.vector_norm(get_path(current, path).float()
                                                       - p0.float()))
    return out

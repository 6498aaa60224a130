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
from typing import Any, Dict, Iterator, List, Tuple

import torch

from portbench.manifest import load_kind

#: offset of the batch generator's seed from the weights' (both generators
#: take any seed the benchmark is given; this keeps their streams apart)
BATCH_SEED_OFFSET = 1 << 40


@dataclasses.dataclass(frozen=True)
class Model:
    """A configuration file's run sizes, in the names the harness uses: the
    sizes every kind has, and in ``own`` those only its kind uses."""

    kind: str  # the configuration's ``model``: portbench/kinds/<kind>.py
    vocab: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    layers: int
    ffn: int  # the dense intermediate size, or one expert's
    rope_theta: float
    eps: float
    own: Any = None  # the kind's own sizes, as its module defines them

    @classmethod
    def from_config(cls, cfg: Dict) -> "Model":
        """The sizes of ``cfg``, as its kind reads them."""
        return load_kind(cfg["model"]).sizes(cfg)

    @classmethod
    def common(cls, cfg: Dict, own: Any = None) -> "Model":
        """The sizes every kind reads from the same keys, with the kind's
        ``own``."""
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
            own=own,
        )


Path = Tuple  # ("layers", 3, "qkv") and the like


def leaf_specs(m: Model) -> List[Tuple[Path, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter in the program's layout,
    in the order they are made, as the kind gives them; scale 0 marks a
    norm weight (ones)."""
    return load_kind(m.kind).leaf_specs(m)


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

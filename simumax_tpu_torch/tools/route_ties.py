"""The MoE row's route kernels against the eager route they replace, on
the row's own gate logits.

Builds the MoE row's model (``bench_moe_0p4b``, 4 layers, seq 2048, mbs
1, weights and token ids from seed 0, as ``torchref.rows.make_row_step``
does) and runs its first forward with ``kernels.moe_route``; at each
layer it also routes the same logits as the port did before the route
kernels (``torch.softmax``, ``torch.topk``, the renormalisation) and
counts the tokens whose experts differ, how many of them hold two equal
logits among their k + 1 largest (a tie, which ``kernels.moe_route``
gives the lower index as ``jax.lax.top_k`` does, and ``torch.topk`` need
not), and how far ``topw`` moves in ulps of its dtype where the experts
agree. Then the first loss through each route. On the card::

    python -m simumax_tpu_torch.tools.route_ties

Prints one JSON object.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from simumax_tpu_torch.torchref import kernels
from simumax_tpu_torch.torchref import moe_model as M
from simumax_tpu_torch.torchref import rows
from simumax_tpu_torch.torchref.model import resolve_device


def eager_route(logits, k: int):
    """The route the MoE model ran before its kernels: (topw, topi)."""
    probs = torch.softmax(logits.float(), -1)
    topv, topi = torch.topk(probs, k, dim=-1)
    return (topv / (topv.sum(-1, keepdim=True) + 1e-9)).to(logits.dtype), topi


def compare(logits, k: int) -> dict:
    """One layer's logits [T, e] through both routes."""
    w, i = kernels.moe_route(logits, k)
    old_w, old_i = eager_route(logits, k)
    a = old_w.abs()
    ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).float()
    differ = (i != old_i).any(-1)
    top = logits.float().topk(k + 1, -1).values
    tied = (top[:, 1:] == top[:, :-1]).any(-1)
    same = ~differ
    return {"tokens": int(i.shape[0]), "tokens_topi_differ": int(differ.sum()),
            "of_them_tied_logits": int((differ & tied).sum()), "tokens_tied": int(tied.sum()),
            "topw_max_ulps_same_topi": float(((w.float() - old_w.float()).abs() / ulp)[same].max()),
            "topw_elements_differ_same_topi": int((w != old_w)[same].sum())}


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = M.MoeConfig.from_model_config(rows.build_moe_model(), layer_num=4)
    params = M.init_params(cfg, seed=0, device=dev)
    ids = torch.tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 2048)),
                       dtype=torch.long, device=dev)
    layers = []

    def route(logits, k):
        layers.append(compare(logits, k))
        return kernels.moe_route(logits, k)

    with torch.no_grad():
        try:
            M.moe_route = route
            loss = float(M.loss_fn(params, (ids, ids), cfg))
            M.moe_route = eager_route
            loss_eager = float(M.loss_fn(params, (ids, ids), cfg))
        finally:
            M.moe_route = kernels.moe_route
    out = {"layers": layers, "first_loss": loss, "first_loss_eager_route": loss_eager}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

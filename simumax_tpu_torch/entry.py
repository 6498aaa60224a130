"""Entry points of the port: a forward on one device and a multi-rank dry run.

Port of the JAX package's ``__graft_entry__.py``. :func:`entry` returns
the forward of the flagship reference Llama (``torchref/model.py``) on a
tiny config with its example arguments; :func:`dryrun_multichip` takes
one training step of each multi-rank path on ``n`` ranks, with the JAX
function's config, passes, rules for picking the layout from ``n`` and
printed lines:

1. the dp x tp step on DTensor: sequence parallelism over tp (when tp >
   1) and FSDP parameter sharding over dp, fwd + bwd + Adam;
2. the fully manual pp x ep x tp x dp step of ``torchref/parallel.py``
   (``run_pp_dryrun``'s pass);
3. context parallelism: one step each through ring attention and
   Ulysses (``torchref/context_parallel.py``), when cp > 1.

Differences from the JAX module: both take ``device`` (the card unless
the caller asks for the CPU); the ranks are spawned processes (NCCL with
a card each, or gloo with ``device="cpu"``), all three passes in one
process group; without as many cards as ranks it raises
``CardRequiredError`` instead of going on on CPU devices; the
parameters are drawn from a seeded ``torch.Generator`` (JAX's scales,
not its numbers); :func:`dryrun_multichip` returns the passes' losses
besides printing them. Run as ``python -m simumax_tpu_torch.entry [n]
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from simumax_tpu_torch.torchref import context_parallel as CP
from simumax_tpu_torch.torchref import model as M
from simumax_tpu_torch.torchref import parallel as P


def _tiny_cfg(layers: int = 2) -> M.LlamaConfig:
    return M.LlamaConfig(
        vocab_size=2048,
        hidden_size=256,
        head_num=8,
        kv_head_num=4,
        head_size=32,
        intermediate_size=688,
        layer_num=layers,
    )


def entry(device="cuda"):
    """(fn, example_args): the forward of the flagship model (bf16, 4
    layers) and its params and token ids [2, 256] on ``device``."""
    dev = M.resolve_device(device)
    cfg = _tiny_cfg(layers=4)
    params = M.init_params(cfg, seed=0, device=dev)
    ids = torch.tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 256), np.int32),
                       dtype=torch.long, device=dev)

    def fn(params, ids):
        return M.forward(params, ids, cfg)

    return fn, (params, ids)


def layouts(n_devices: int) -> Dict[str, int]:
    """The JAX function's rules for each pass's layout from n."""
    tp = 2 if n_devices % 2 == 0 else 1
    pp = 2 if n_devices % 4 == 0 else 1
    rest = n_devices // pp
    ep = 2 if rest % 4 == 0 else 1
    tp2 = 2 if (rest // ep) % 2 == 0 else 1
    cp = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    return {"tp": tp, "dp": n_devices // tp, "pp": pp, "ep": ep, "tp2": tp2,
            "dp2": n_devices // (pp * ep * tp2), "cp": cp}


def _sharded_pass(n_devices: int, tp: int, device) -> float:
    """Pass 1 on this rank: one dp x tp step, SP when tp > 1, FSDP on."""
    cfg = _tiny_cfg(layers=2)
    mesh = M.make_mesh(n_devices, tp=tp, device=device)
    params = M.init_params(cfg, seed=0, device=P.mesh_device(mesh))
    params = M.place_params(params, mesh, M.param_shardings(cfg, mesh, fsdp=True))
    init_opt, train_step = M.make_train_step(cfg, sp=tp > 1, mesh=mesh)
    opt_state = init_opt(params)
    batch_size, seq = max(n_devices // tp, 2), 128
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch_size, seq), np.int32)
    _params, _opt, loss = train_step(params, opt_state, M.shard_batch((ids, ids), mesh))
    return float(loss)


def _passes_on_rank(n_devices: int, lay: Dict[str, int], device) -> Optional[dict]:
    losses = {"dp_tp": _sharded_pass(n_devices, lay["tp"], device),
              "manual": P._dryrun_on_rank(n_devices, lay["pp"], lay["tp2"], lay["ep"], device,
                                          "a2a" if lay["ep"] > 1 else "psum")}
    if lay["cp"] > 1:
        for mech in ("ring", "ulysses"):
            losses[mech] = CP._cp_dryrun_on_rank(n_devices, lay["cp"], mech, 256, 256, 8,
                                                 device)
    return losses if dist.get_rank() == 0 else None


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, float]:
    """One training step of each pass (module docstring) on
    ``n_devices`` ranks; prints one line a pass, as the JAX function
    does, and returns the losses by pass ("dp_tp", "manual", and "ring"
    and "ulysses" when cp > 1). Raises when a loss is not finite."""
    P.require_cards(n_devices, device, "dryrun_multichip")
    lay = layouts(n_devices)
    if n_devices > 1:
        losses = P.spawn(n_devices, device, _passes_on_rank, n_devices, lay, str(device))[0]
    elif dist.is_initialized():
        losses = _passes_on_rank(n_devices, lay, str(device))
    else:
        with P.process_group(device):
            losses = _passes_on_rank(n_devices, lay, str(device))
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if bad:
        raise FloatingPointError(f"dryrun_multichip: non-finite losses {bad}")
    tp, dp = lay["tp"], lay["dp"]
    print(f"dryrun_multichip: mesh dp={dp} x tp={tp} (sp={'on' if tp > 1 else 'off'}, "
          f"fsdp=on) step ok, loss={losses['dp_tp']:.4f}")
    dispatch = "a2a" if lay["ep"] > 1 else "psum"
    print(f"dryrun_multichip: manual spmd pp={lay['pp']} x ep={lay['ep']} x tp={lay['tp2']} x "
          f"dp={lay['dp2']} (sp=on, ep_dispatch={dispatch}) step ok, "
          f"loss={losses['manual']:.4f}")
    for mech in ("ring", "ulysses"):
        if mech in losses:
            print(f"dryrun_multichip: cp={lay['cp']} x dp={n_devices // lay['cp']} "
                  f"({mech} attention) step ok, loss={losses[mech]:.4f}")
    return losses


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m simumax_tpu_torch.entry")
    parser.add_argument("n", nargs="?", type=int, default=8)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    fn, fn_args = entry(args.device)
    with torch.no_grad():
        out = fn(*fn_args)
    print("entry forward ok:", tuple(out.shape), out.dtype)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()

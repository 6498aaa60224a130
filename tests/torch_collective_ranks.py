"""Rank-side bodies of ``tests/test_torch_collective_bench.py``: run in
processes that :func:`simumax_tpu_torch.torchref.parallel.spawn` starts,
so they import no jax."""

import torch
import torch.distributed as dist

from simumax_tpu_torch.calibration import collective_bench as CB

#: the sweep's sizes on gloo ranks: small, so a spawn takes seconds
SIZES_MB = (1 / 64, 1 / 16, 1 / 4)


def rank_values(n: int, elems: int, rank: int) -> torch.Tensor:
    """What rank ``rank`` of ``n`` holds: distinct exact values."""
    return (torch.arange(elems, dtype=torch.float64) + 1000.0 * rank).to(torch.float32)


def ops_and_sweep(nbytes: float):
    """Every op once on distinct values, and a sweep over every op: the
    rank's (inputs, outputs) by op, and the sweep dict."""
    n, rank = dist.get_world_size(), dist.get_rank()
    got = {}
    for op in CB._OPS:
        x = rank_values(n, CB.input_elems(op, nbytes, n, 4), rank)
        got[op] = (x.numpy(), CB.run_collective(op, x).numpy())
    sweep = CB.sweep_axis(None, sizes_mb=SIZES_MB, dtype=torch.float32)
    return rank, got, sweep

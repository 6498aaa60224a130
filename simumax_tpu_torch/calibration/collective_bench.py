"""Collective microbenchmarks and alpha-beta fits on ``torch.distributed``.

Port of the JAX package's ``calibration/collective_bench.py`` (after the
reference's ``simu_tools/efficency_test/nccl_fit.py``: time = a * bytes
+ b, fitted over a sweep of sizes): all-reduce, all-gather,
reduce-scatter, all-to-all and a ring of point-to-point sends are timed
over a process group, which takes the mesh axis's place, fitted to the
same linear model, and written back as per-op ``efficient_factor`` and
``latency_us`` against the system config's theoretical span bandwidth.

* The ops are ``dist.all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single`` and a ring of
  ``batch_isend_irecv`` (each rank sends to the next and receives from
  the previous, as the JAX module's ``ppermute`` does).
* Timing uses CUDA events on NCCL and the host clock on gloo; a sample
  is the slowest rank's mean over the timed calls, so every rank
  returns the same number.
* Each op moves what :meth:`SystemConfig.compute_net_op_time` costs for
  ``nbytes``: all-reduce and reduce-scatter take ``nbytes`` on each
  rank, all-gather and all-to-all ``nbytes / n``, a point-to-point send
  ``nbytes``. The JAX function shards one vector of ``nbytes`` over the
  axis for every op, so its all-reduce, reduce-scatter and ``ppermute``
  move 1/n of the bytes the model costs.
* The write-back goes into the op table of the outermost span of
  ``place_group("_cal", 1, extent)``: ``ici.op`` on a TPU slice, as the
  JAX function writes, ``nvlink.op`` within one NVSwitch node and
  ``ib.op`` for a group that spans nodes (the slower fabric's).

A gloo group on the CPU runs every op (the tests' ranks); the fit of
NVLink or InfiniBand needs NCCL ranks on as many GPUs.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from simumax_tpu_torch.core.config import NetOpSpec
from simumax_tpu_torch.core.errors import CalibrationError

_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all2all", "p2p")
#: ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` under the
#: names newer PyTorch gives them
_all_gather_base = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def input_elems(op: str, nbytes: float, n: int, itemsize: int) -> int:
    """Elements of the tensor each rank holds for ``op`` of ``nbytes``
    full logical tensor bytes over ``n`` ranks (a multiple of ``n``,
    at least ``n``)."""
    if op not in _OPS:
        raise CalibrationError(f"no collective benchmark for op {op!r}", op=op)
    elems = max(int(nbytes / itemsize), n * n)
    elems -= elems % (n * n)
    return elems // n if op in ("all_gather", "all2all") else elems


def run_collective(op: str, x: torch.Tensor, group=None) -> torch.Tensor:
    """One collective ``op`` over ``group`` on this rank's 1-D tensor
    ``x``; returns what the rank receives."""
    n = dist.get_world_size(group)
    if op == "all_reduce":
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out
    if op == "all_gather":
        out = x.new_empty(n * x.numel())
        _all_gather_base(out, x, group=group)
        return out
    if op == "reduce_scatter":
        out = x.new_empty(x.numel() // n)
        _reduce_scatter_base(out, x, group=group)
        return out
    if op == "all2all":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    if op == "p2p":
        out = torch.empty_like(x)
        if n == 1:
            out.copy_(x)
            return out
        me = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        ops = [dist.P2POp(dist.isend, x, ranks[(me + 1) % n], group),
               dist.P2POp(dist.irecv, out, ranks[(me - 1) % n], group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out
    raise CalibrationError(f"no collective benchmark for op {op!r}", op=op)


def measure_collective(group, op: str, nbytes: float, dtype=torch.bfloat16,
                       warmup: int = 2, reps: int = 5) -> float:
    """Seconds of one collective of ``nbytes`` *full logical tensor*
    bytes over ``group`` (``None``: every rank), in the semantics of
    ``compute_net_op_time``: the slowest rank's mean over ``reps`` calls
    after ``warmup``. Every rank of the group calls it."""
    n = dist.get_world_size(group)
    device = _device(group)
    x = torch.ones(input_elems(op, nbytes, n, torch.tensor([], dtype=dtype).element_size()),
                   dtype=dtype, device=device)
    for _ in range(warmup):
        run_collective(op, x, group)
    dist.barrier(group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run_collective(op, x, group)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) * 1e-3 / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            run_collective(op, x, group)
        seconds = (time.perf_counter() - t0) / reps
    slowest = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
    return float(slowest.item())


def fit_alpha_beta(sizes, times) -> Tuple[float, float]:
    """Least-squares fit time = bytes/bw + alpha -> (bw_bytes_per_s,
    alpha_seconds). Reference ``nccl_fit.py:27-60``."""
    A = np.vstack([sizes, np.ones(len(sizes))]).T
    slope, alpha = np.linalg.lstsq(A, np.array(times), rcond=None)[0]
    bw = 1.0 / slope if slope > 0 else float("inf")
    return bw, max(alpha, 0.0)


def sweep_axis(group=None, ops: Tuple[str, ...] = _OPS,
               sizes_mb: Tuple[float, ...] = (1, 4, 16, 64), dtype=torch.bfloat16,
               ) -> Dict[str, dict]:
    """Measure and fit every collective op over ``group``: ``{op:
    {"fitted_bw_gbps", "fitted_latency_us", "samples": [(MiB, s), ...]}}``,
    the JAX function's structure."""
    out = {}
    for op in ops:
        sizes, times = [], []
        for mb in sizes_mb:
            nbytes = mb * 2**20
            times.append(measure_collective(group, op, nbytes, dtype))
            sizes.append(nbytes)
        bw, alpha = fit_alpha_beta(sizes, times)
        out[op] = {
            "fitted_bw_gbps": bw / 1e9,
            "fitted_latency_us": alpha * 1e6,
            "samples": list(zip([s / 2**20 for s in sizes], times)),
        }
    return out


def update_system_from_sweep(system, axis_extent: int, sweep: Dict[str, dict]):
    """Write fitted per-op efficiencies back into the op table of the
    outermost span of the path a group of ``axis_extent`` is placed on,
    against the theoretical span bandwidth (the write-back step of the
    reference's one-click pipeline)."""
    path = system.place_group("_cal", 1, axis_extent)
    if not path.spans:
        raise CalibrationError(f"a sweep over {axis_extent} rank(s) measures no network")
    table = system.net_config(path.spans[-1].kind).op
    for op, fit in sweep.items():
        # theoretical time for 64 MiB at eff=1.0
        probe = 64 * 2**20
        spec = table.setdefault(op, NetOpSpec())
        spec.efficient_factor = 1.0
        theory = system.compute_net_op_time(op, probe, path)
        slope_time = probe / (fit["fitted_bw_gbps"] * 1e9)
        if theory > 0 and slope_time > 0:
            spec.efficient_factor = min(theory / slope_time, 1.0)
        spec.latency_us = fit["fitted_latency_us"]
    return system

"""Sweep-engine micro-benchmark: cells/sec of the port's strategy-search
engine on a fixed synthetic grid, and the throughput of its batched
scorer with the pipeline-schedule fold kernel on the card.

The port's counterpart of the JAX package's ``bench_sweep.py``, with the
same grids, the same JSON line and ``--kernel-bench N``. What differs:
the batched engine's folds run where ``--device`` says (``cuda``, the
default: the fold kernel; ``cpu``: its plain version), the kernel bench's
jitted-JAX column is the CUDA kernel's (``kernel_cuda_cands_per_sec``),
and on the card it also reports the plain version's candidates/s on the
card, the kernel's device ms a call (CUDA events, each call queued
behind a spin kernel so that the host's wrapper is not timed), the host
ms a call in its parts (packing, the copy to the card, the launch, the
wait and the copy back), the kernel's time by batch size and the group
size above which the kernel's fold beats the numpy fold (the ``auto``
crossover). Results are not appended to a bench history.

Prints exactly ONE JSON line::

    {"metric": "sweep_cells_per_sec", "value": ..., "unit": "cells/s",
     "engine": ..., "cells": ..., "jobs": ..., "elapsed_s": ...,
     "pruned_cells": ..., "prune_rate": ..., ...}

Usage (``--engine batched`` needs the card unless ``--device cpu``)::

    python -m simumax_tpu_torch.tools.bench_sweep        # serial scalar
    python -m simumax_tpu_torch.tools.bench_sweep --engine batched --grid wide \\
        --kernel-bench 4096
    python -m simumax_tpu_torch.tools.bench_sweep --jobs 4
    python -m simumax_tpu_torch.tools.bench_sweep --engine batched --grid wide \\
        --baseline base.json --max-regression 0.7   # regression gate (exit 1)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
import warnings

warnings.filterwarnings("ignore")

from simumax_tpu_torch.core.config import (  # noqa: E402
    get_model_config,
    get_strategy_config,
    get_system_config,
)
from simumax_tpu_torch.core.records import Diagnostics  # noqa: E402
from simumax_tpu_torch.search import search_best_parallel_strategy  # noqa: E402

# the first sweep in a process otherwise pays the lazy observe-layer
# imports inside the timed region (module import time is not sweep
# throughput)
import simumax_tpu_torch.observe.report
import simumax_tpu_torch.observe.ledger
import simumax_tpu_torch.observe.memledger

#: fixed synthetic grids (the JAX package's bench_sweep.py:77-91):
#: "standard" measures raw sweep throughput on a big-chip system where
#: most cells evaluate; "oversubscribed" puts an 8B model on 16 GiB chips
#: with replication-heavy ZeRO levels so the closed-form memory bound
#: prunes a large share of cells up front; "wide" is the batched
#: engine's target workload, the full tp x pp x ZeRO grid
GRIDS = {
    "standard": dict(
        model="llama3-8b", system="tpu_v5p_256", world=64, gbs=64,
        tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4), zero_list=(1,),
    ),
    "oversubscribed": dict(
        model="llama3-8b", system="tpu_v5e_256", world=64, gbs=64,
        tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4), zero_list=(0, 1, 3),
    ),
    "wide": dict(
        model="llama3-8b", system="tpu_v5p_256", world=64, gbs=64,
        tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4, 8),
        zero_list=(0, 1, 2, 3),
    ),
}
#: group sizes of the kernel's batch sweep and of the crossover search
KERNEL_BATCHES = (256, 1024, 4096, 16384, 65536)
CROSSOVER_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
#: full-size scores timed per backend in the kernel bench (the median)
BENCH_REPS = 3
#: clock cycles of the spin kernel a timed call waits behind (about 1 ms)
SPIN_CYCLES = 2 * 10 ** 6


def run_sweep(spec, jobs, prune, engine="scalar", verify_topk=None,
              device="cuda"):
    model = get_model_config(spec["model"])
    system = get_system_config(spec["system"])
    base = get_strategy_config("tp1_pp1_dp8_mbs1")
    base.world_size = spec["world"]
    diag = Diagnostics()
    t0 = time.perf_counter()
    rows = search_best_parallel_strategy(
        base, model, system, spec["gbs"],
        tp_list=spec["tp_list"], pp_list=spec["pp_list"],
        zero_list=spec["zero_list"], topk=5,
        jobs=jobs, prune=prune, diagnostics=diag,
        engine=engine, verify_topk=verify_topk, device=device,
    )
    elapsed = time.perf_counter() - t0
    c = diag.counters
    total = int(c.get("sweep_cells_total", 0))
    pruned = int(c.get("sweep_cells_pruned", 0))
    prefix = "sweep_batched_fallback["
    return {
        "rows": rows,
        "elapsed_s": elapsed,
        "cells": total,
        "pruned": pruned,
        "deduped": int(c.get("sweep_cells_deduped", 0)),
        "evaluated": int(c.get("sweep_cells_evaluated", 0)),
        "batched_cells": int(c.get("sweep_cells_batched", 0)),
        "max_score_batch": int(c.get("sweep_batched_max_batch", 0)),
        "candidates_scored": int(
            c.get("sweep_batched_candidates_scored", 0)),
        "verified_rows": int(c.get("sweep_rows_verified", 0)),
        "fallback_cells": int(c.get("sweep_batched_fallbacks", 0)),
        "batched_fallbacks": {
            k[len(prefix):-1]: int(v)
            for k, v in sorted(c.items()) if k.startswith(prefix)
        },
        # throughput counts every *dispatched* grid cell: pruning a cell
        # in O(closed-form) instead of O(model build) is the point
        "cells_per_sec": total / elapsed if elapsed > 0 else 0.0,
    }


def bench_family(spec, n_cands, device="cuda"):
    """The kernel bench's family (the JAX package's bench_sweep.py:147-
    156): tp2 pp4 with full-block recompute on the grid's model and
    system, and ``n_cands`` candidates cycling through its (mbs, mbc)
    splits and five recompute layer counts. Returns ``(kernel, mbs,
    mbc, nrc)``."""
    from simumax_tpu_torch.search.batched import BatchedScorer

    model = get_model_config(spec["model"])
    system = get_system_config(spec["system"])
    st = get_strategy_config("tp1_pp1_dp8_mbs1")
    st.world_size = spec["world"]
    st.tp_size, st.pp_size = 2, 4
    st.enable_recompute = True
    st.recompute_granularity = "full_block"
    st.recompute_layer_num = 2
    st.__post_init__()
    kern = BatchedScorer(model, system, device=device).kernel_for(st)
    per_dp = spec["gbs"] // st.dp_size
    splits = [(m, per_dp // m) for m in range(1, per_dp + 1)
              if per_dp % m == 0]
    mbs = [splits[i % len(splits)][0] for i in range(n_cands)]
    mbc = [splits[i % len(splits)][1] for i in range(n_cands)]
    nrc = [i % 5 for i in range(n_cands)]
    return kern, mbs, mbc, nrc


def event_ms(fn, reps=3):
    """Median device ms of ``fn`` between two CUDA events, after one
    warm-up call, each sample queued behind a spin kernel."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def recorded_folds():
    """Record every ``fold_schedule`` call while the block runs: a list
    of ``(ops, fwd, bwd, p2p, blocking, out)``, the inputs as the
    wrapper got them and its result."""
    from simumax_tpu_torch.torchref import kernels as K

    calls, orig = [], K.fold_schedule

    def record(ops, fwd, bwd, p2p, blocking):
        out = orig(ops, fwd, bwd, p2p, blocking)
        calls.append((ops, fwd, bwd, p2p, blocking, out))
        return out

    K.fold_schedule = record
    try:
        yield calls
    finally:
        K.fold_schedule = orig


@contextlib.contextmanager
def plain_on_card():
    """Run ``fold_schedule``'s plain version on the card's tensors while
    the block runs, where the wrapper would launch the kernel."""
    from simumax_tpu_torch.torchref import kernels as K

    orig = K.fold_schedule
    K.fold_schedule = K.fold_schedule_plain
    try:
        yield
    finally:
        K.fold_schedule = orig


def fold_bound(ops, fwd, out):
    """Least time of one fold call on the card (datasheet rates): its
    bytes (the op table, fwd, bwd, p2p and blocking read once, the ends
    and totals written once) over 3.35 TB/s, or its float64 operations
    (per op and candidate: the wait's addition and comparison where it
    waits, the addition, the blocking addition where it blocks; the
    total's pp - 1 comparisons) over 34 TFLOP/s, whichever is larger.
    Returns (seconds, "bytes" | "operations")."""
    pp, vp, n = fwd.shape
    table = ops.cpu()
    per_cand = (2 * int((table[:, 3] >= 0).sum()) + table.shape[0]
                + int(((table[:, 0] >> 8) & 1).sum()) + pp - 1)
    nbytes = table.numel() * 4 + (2 * pp * vp + 2) * n * 8 + out.numel() * 8
    t_bytes, t_ops = nbytes / 3.35e12, per_cand * n / 34e12
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


#: the latency floor of one fold level: a shared-memory round trip, about
#: 30 clocks on Hopper (published microbenchmarks), at the H100 SXM's
#: 1.98 GHz boost clock (data sheet)
SMEM_ROUND_TRIP_S = 30 / 1.98e9


def fold_floor(levels, launch_ms):
    """Latency floor of one fold call (ms): its levels, each at least one
    shared-memory round trip, and one launch (``launch_ms``, an empty
    kernel's time measured as the fold's is)."""
    return levels * SMEM_ROUND_TRIP_S * 1e3 + launch_ms


def host_split(members, pp, vp, mbc, group):
    """Host ms of one kernel fold of a shape group, in its parts:
    packing the buffer, the copy to the card, the launch (the wrapper's
    host time) and the wait with the copy back."""
    import torch

    from simumax_tpu_torch.search import batched as B
    from simumax_tpu_torch.torchref import kernels as K

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, _ = B._pack_members(members, pp, vp)
    t1 = time.perf_counter()
    x = torch.from_numpy(host).to("cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = K.fold_schedule(B._fold_ops(pp, vp, mbc, group, "cuda"),
                          *B.fold_views(x, pp, vp))
    t3 = time.perf_counter()
    out.cpu()
    t4 = time.perf_counter()
    return {"pack": (t1 - t0) * 1e3, "copy": (t2 - t1) * 1e3,
            "launch": (t3 - t2) * 1e3, "wait_and_back": (t4 - t3) * 1e3}


def fold_job(kern, n, mbc, device):
    """A ``_FoldJob`` of ``n`` candidates of one (mbs 1, ``mbc``) shape
    of ``kern``'s family, without its fold run."""
    from simumax_tpu_torch.search.batched import FoldBatch

    fb = FoldBatch()
    kern.score([1] * n, [mbc] * n, nrc=[i % 5 for i in range(n)],
               fold_batch=fb, device=device)
    return fb._jobs[0]


def crossover(kern, mbc, reps=3):
    """The fold alone of one shape group of each size in
    ``CROSSOVER_BATCHES`` (``_fold_job``: the numpy fold against the
    kernel with its packing and copies), median host ms of ``reps``;
    and the least size from which the kernel is faster at every larger
    size measured (None if it never is)."""
    import torch

    from simumax_tpu_torch.search.batched import _fold_job

    rows = {}
    for n in CROSSOVER_BATCHES:
        job = fold_job(kern, n, mbc, "cuda")
        times = {}
        for backend in ("numpy", "cuda"):
            samples = []
            for _ in range(reps + 1):
                t0 = time.perf_counter()
                _fold_job(job, backend, "cuda")
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            times[backend] = statistics.median(samples[1:])
        rows[n] = times
    at = None
    for n in reversed(CROSSOVER_BATCHES):
        if rows[n]["cuda"] >= rows[n]["numpy"]:
            break
        at = n
    return {"fold_ms": rows, "crossover": at}


def run_kernel_bench(spec, n_cands, device="cuda"):
    """Raw kernel scoring throughput (candidates/s, the median of
    ``BENCH_REPS`` warm runs) on the bench family: the same candidate
    batch through the numpy fold and the CUDA kernel (``device="cpu"``:
    its plain version), results bit-identical (the
    port's tests pin it; here only speed). On the card also the plain
    version on the card, the kernel's device ms a call and host ms a
    call in parts, the kernel by batch size and the crossover. Every
    kernel call is held bit for bit against the plain version on the
    card; ``calls`` holds them for the caller."""
    kern, mbs, mbc, nrc = bench_family(spec, n_cands, device)
    sync = None
    if device == "cuda":
        import torch

        sync = torch.cuda.synchronize

    def timed(backend, reps=BENCH_REPS):
        """Candidates/s of the median of ``reps`` full-size scores,
        after one more as warm-up (caches, the kernel's build and op
        tables, the card's lazily loaded modules: set-up)."""
        samples = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            kern.score(mbs, mbc, nrc=nrc, backend=backend, device=device)
            if sync:
                sync()
            samples.append(time.perf_counter() - t0)
        return n_cands / statistics.median(samples[1:])

    out = {"numpy_cands_per_sec": timed("numpy"),
           "cuda_cands_per_sec": timed("cuda")}
    if device != "cuda":
        return out
    import torch

    from simumax_tpu_torch.search import batched as B
    from simumax_tpu_torch.torchref import kernels as K

    with plain_on_card():
        out["plain_cuda_cands_per_sec"] = timed("cuda")
    groups = []
    orig = B._fold_members_cuda

    def grab(members, pp, vp, mbc_i, group, dev):
        groups.append((list(members), pp, vp, mbc_i, group))
        return orig(members, pp, vp, mbc_i, group, dev)

    B._fold_members_cuda = grab
    try:
        with recorded_folds() as calls:
            kern.score(mbs, mbc, nrc=nrc, backend="cuda", device="cuda")
    finally:
        B._fold_members_cuda = orig
    per_call = []
    launch_ms = event_ms(lambda: torch.cuda._sleep(0))
    for ops, fwd, bwd, p2p, blk, res in calls:
        ms = event_ms(lambda: K.fold_schedule(ops, fwd, bwd, p2p, blk))
        plain_ms = event_ms(
            lambda: K.fold_schedule_plain(ops, fwd, bwd, p2p, blk), reps=1)
        bound_s, bound_by = fold_bound(ops, fwd, res)
        levels = len(K.fold_level_spans(ops))
        per_call.append({"n": fwd.shape[2], "n_ops": ops.shape[0], "levels": levels,
                         "ms": ms, "us_per_level": ms / levels * 1e3,
                         "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                         "bound_by": bound_by,
                         "floor_ms": fold_floor(levels, launch_ms)})
    out["launch_ms"] = launch_ms
    splits = [host_split(*g) for g in groups]
    out["kernel_calls"] = per_call
    out["kernel_ms_per_call"] = statistics.mean(c["ms"] for c in per_call)
    out["host_ms_per_call"] = {
        k: statistics.mean(s[k] for s in splits) for k in splits[0]}
    # the kernel at the family's deepest split, one group of each size
    deep = max(mbc)
    by_batch = {}
    for n in KERNEL_BATCHES:
        job = fold_job(kern, n, deep, "cuda")
        members = [(job, i) for i in range(n)]
        host, _ = B._pack_members(members, 4, 1)
        x = torch.from_numpy(host).to("cuda")
        ops = B._fold_ops(4, 1, deep, 0, "cuda")
        views = B.fold_views(x, 4, 1)
        with recorded_folds() as grabbed:
            K.fold_schedule(ops, *views)
        calls.extend(grabbed)
        by_batch[n] = event_ms(lambda: K.fold_schedule(ops, *views))
    out["kernel_ms_by_batch"] = by_batch
    out.update(crossover(kern, deep))
    out["calls"] = calls
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=1,
                    help="pool width for the measured run (1 = serial)")
    ap.add_argument("--grid", choices=sorted(GRIDS), default="standard")
    ap.add_argument(
        "--engine", choices=("scalar", "batched"), default="scalar",
        help="candidate scoring engine (batched = vectorized cost "
             "kernel + scalar re-verification of the top-k rows)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the batched engine folds schedules (cpu: the fold "
             "kernel's plain version)",
    )
    ap.add_argument(
        "--verify-topk", type=int, default=None, metavar="K",
        help="with --engine batched: ranked rows re-verified with the "
             "scalar oracle (default: topk = 5); recorded in the JSON",
    )
    ap.add_argument("--no-prune", action="store_true")
    ap.add_argument(
        "--kernel-bench", type=int, default=0, metavar="N",
        help="with --engine batched: also measure raw kernel scoring "
             "throughput on an N-candidate batch (numpy fold, the CUDA "
             "kernel and, on the card, its plain version)",
    )
    ap.add_argument(
        "--max-fallback-cells", type=int, default=None, metavar="N",
        help="with --engine batched: fail (exit 1) when more than N "
             "cells fell back to the scalar path",
    )
    ap.add_argument(
        "--baseline", metavar="JSON",
        help="previously saved bench JSON line to gate against "
             "(compares cells/sec at the same grid)",
    )
    ap.add_argument(
        "--max-regression", type=float, default=0.05, metavar="FRAC",
        help="fail (exit 1) when cells/sec drops more than this "
             "fraction below the baseline (default 0.05)",
    )
    args = ap.parse_args(argv)
    spec = GRIDS[args.grid]
    prune = not args.no_prune

    measured = run_sweep(spec, jobs=args.jobs, prune=prune,
                         engine=args.engine,
                         verify_topk=args.verify_topk, device=args.device)
    result = {
        "metric": "sweep_cells_per_sec",
        "value": round(measured["cells_per_sec"], 2),
        "unit": "cells/s",
        "ledger": "off",
        "engine": args.engine,
        "grid": args.grid,
        "cells": measured["cells"],
        "evaluated_cells": measured["evaluated"],
        "pruned_cells": measured["pruned"],
        "deduped_cells": measured["deduped"],
        "prune_rate": round(
            measured["pruned"] / measured["cells"], 3
        ) if measured["cells"] else 0.0,
        "jobs": args.jobs,
        "prune": prune,
        "elapsed_s": round(measured["elapsed_s"], 3),
    }
    if args.engine == "batched":
        result["device"] = args.device
        result["batched_cells"] = measured["batched_cells"]
        result["fallback_cells"] = measured["fallback_cells"]
        result["batched_fallbacks"] = measured["batched_fallbacks"]
        result["max_score_batch"] = measured["max_score_batch"]
        result["candidates_scored"] = measured["candidates_scored"]
        result["verify_topk"] = (
            args.verify_topk if args.verify_topk is not None else 5
        )
        result["verified_rows"] = measured["verified_rows"]
    if args.jobs > 1:
        serial = run_sweep(spec, jobs=1, prune=prune,
                           engine=args.engine,
                           verify_topk=args.verify_topk, device=args.device)
        result["serial_cells_per_sec"] = round(serial["cells_per_sec"], 2)
        result["serial_elapsed_s"] = round(serial["elapsed_s"], 3)
        result["speedup"] = round(
            measured["cells_per_sec"] / serial["cells_per_sec"], 2
        ) if serial["cells_per_sec"] else 0.0
        result["topk_matches_serial"] = [
            (r["tp"], r["pp"], r["zero"], r["mbs"], r["mbc"],
             r["recompute"]) for r in measured["rows"]
        ] == [
            (r["tp"], r["pp"], r["zero"], r["mbs"], r["mbc"],
             r["recompute"]) for r in serial["rows"]
        ]
    ok = True
    if args.max_fallback_cells is not None and args.engine == "batched":
        fb_ok = measured["fallback_cells"] <= args.max_fallback_cells
        result["fallback_ok"] = fb_ok
        ok = ok and fb_ok
    if args.kernel_bench and args.engine == "batched":
        kernel = run_kernel_bench(spec, args.kernel_bench, args.device)
        if args.device == "cuda":
            import torch

            from simumax_tpu_torch.torchref import kernels as K

            for ops, fwd, bwd, p2p, blk, res in kernel.pop("calls"):
                plain = K.fold_schedule_plain(ops, fwd, bwd, p2p, blk)
                if not torch.equal(plain, res):
                    raise AssertionError(
                        "fold_schedule differs from its plain version on "
                        f"the card (pp {fwd.shape[0]}, vp {fwd.shape[1]}, "
                        f"n {fwd.shape[2]}, {ops.shape[0]} ops)")
            result["card"] = torch.cuda.get_device_name(0)
        result["kernel_bench_candidates"] = args.kernel_bench
        result.update({f"kernel_{k}": v for k, v in kernel.items()})
    if args.baseline:
        with open(args.baseline) as f:
            base = json.load(f)
        if not isinstance(base.get("value"), (int, float)):
            print(json.dumps({
                "error": f"baseline {args.baseline} has no numeric "
                         f"'value' field; re-record it with a plain "
                         f"bench run",
            }))
            return 2
        verify_resolved = (
            (args.verify_topk if args.verify_topk is not None else 5)
            if args.engine == "batched" else None
        )
        for key, ours in (("grid", args.grid), ("jobs", args.jobs),
                          ("prune", prune), ("engine", args.engine),
                          ("verify_topk", verify_resolved)):
            theirs = base.get(key, ours)
            if theirs != ours:
                print(json.dumps({
                    "error": f"baseline {key} {theirs!r} != this run's "
                             f"{ours!r}; not comparable — re-record the "
                             f"baseline with matching flags",
                }))
                return 2
        floor = base["value"] * (1.0 - args.max_regression)
        result["baseline_value"] = base["value"]
        result["regression"] = (
            round(1.0 - measured["cells_per_sec"] / base["value"], 4)
            if base["value"] else 0.0
        )
        reg_ok = measured["cells_per_sec"] >= floor
        result["regression_ok"] = reg_ok
        ok = ok and reg_ok
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

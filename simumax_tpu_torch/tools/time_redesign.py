"""The redesigned fp32 flash-attention forward and pipeline-schedule fold
against another commit's kernels, on the same calls.

The baseline is the sources ``csrc/flash_attn.cu`` and ``csrc/fold.cu`` of
another commit, built here with the port's nvcc flags into
``build/baseline/`` and loaded beside the current kernels. Their entry
points are the earlier ones: ``flash_fwd`` without the kv split (dtype,
d, q, k, v, o, lse, b*h, sq, skv, scale, causal, stream) and
``fold_schedule`` with its float64 state scratch ``[n_ops, n]`` (n_ops,
pp, vp, n, ops, fwd, bwd, p2p, blocking, state, out, stream), which walks
a table in its order, so it takes the level-ordered tables as they are.

Calls, each timed in turns (current, baseline, baseline, current; device
ms between CUDA events, each the median of 5 calls after a warm-up, each
queued behind a spin kernel so that the host's wrapper is not timed):

* the fp32 forward at ``chip_smoke.py``'s two fp32 cases (b 1, s 1024, h
  2, d 64, causal; b 1, s 2048, h 16, d 128, causal), on the same ``[b*h,
  s, d]`` operands, the current kernel with the kv split
  ``kernels.flash_fwd_kv_chunk`` picks: outputs within ``RTOL`` (1e-4 *
  (|baseline| + rms(baseline))) of each other;
* every fold call of ``chip_smoke.py`` phase 10d's guided Mixtral-8x7B
  sweep and VPP families, and the kernel bench's calls (4096 candidates
  of tp2 pp4 full-block): outputs equal bit for bit.

Usage. Write the baseline's sources where git is (the card's machine has
no repository), then run on the card::

    python -m simumax_tpu_torch.tools.time_redesign --extract 840738e
    python -m simumax_tpu_torch.tools.time_redesign --baseline build/baseline/840738e

Prints one JSON object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import os
import statistics
import subprocess

import torch

from simumax_tpu_torch.torchref import kernels as K

SOURCES = ("flash_attn.cu", "fold.cu")
FP32_CASES = {"fp32, 16 kv blocks": dict(b=1, s=1024, h=2, d=64, causal=True),
              "fp32 full width": dict(b=1, s=2048, h=16, d=128, causal=True)}
RTOL = 1e-4
SPIN_CYCLES = 2 * 10 ** 6
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def extract(commit: str) -> str:
    """Write ``commit``'s kernel sources into ``build/baseline/<commit>``
    (needs git and the repository); returns the directory."""
    out = os.path.join(os.path.dirname(K.build_dir()), "baseline", commit)
    os.makedirs(out, exist_ok=True)
    for name in SOURCES:
        src = subprocess.run(["git", "show", f"{commit}:simumax_tpu_torch/csrc/{name}"],
                             capture_output=True, text=True, check=True).stdout
        with open(os.path.join(out, name), "w") as f:
            f.write(src)
    return out


def build_baseline(directory: str) -> dict:
    """The baseline's two libraries, built with the port's nvcc flags,
    with their entry points' argument types."""
    procs = {}
    for name in SOURCES:
        lib = os.path.join(directory, name.replace(".cu", ".so"))
        procs[name] = (subprocess.Popen([K._nvcc(), *K.NVCC_FLAGS, "-o", lib,
                                         os.path.join(directory, name)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"baseline {name}: nvcc exited {proc.returncode}\n{out}")
        libs[name] = ctypes.CDLL(lib)
    libs["flash_attn.cu"].flash_fwd.argtypes = [_I, _I] + [_P] * 5 + [_I] * 3 + [_F, _I, _P]
    libs["fold.cu"].fold_schedule.argtypes = [_I] * 4 + [_P] * 8
    for lib in libs.values():
        for fn in ("flash_fwd", "fold_schedule"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
    return libs


def device_ms(fn, reps: int = 5) -> float:
    """Median device ms of ``fn`` between two CUDA events, each sample
    queued behind a spin kernel, after a warm-up call."""
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


def turns(new, old) -> dict:
    t = [device_ms(new), device_ms(old), device_ms(old), device_ms(new)]
    return {"new_ms": (t[0] + t[3]) / 2, "baseline_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def flash_rows(lib) -> dict:
    """The fp32 forward at both cases, the current kernel against the
    baseline's, on the same operands."""
    rows = {}
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, c in FP32_CASES.items():
        bh, s, d = c["b"] * c["h"], c["s"], c["d"]
        gen = torch.Generator(device="cuda").manual_seed(1234)
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda") for _ in range(3))
        outs = {w: (torch.empty_like(q), torch.empty(bh, s, device="cuda")) for w in "nb"}
        chunk = K.flash_fwd_kv_chunk(bh, s, s, sms)
        part = torch.empty(-(-s // chunk) * bh * s * (d + 2), device="cuda") if chunk else None
        new_lib = K._lib("flash_attn")

        def new():
            o, lse = outs["n"]
            rc = new_lib.flash_fwd(0, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   lse.data_ptr(), bh, s, s, d ** -0.5, int(c["causal"]),
                                   chunk, 0 if part is None else part.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"flash_fwd returned cudaError {rc}")

        def old():
            o, lse = outs["b"]
            rc = lib.flash_fwd(0, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse.data_ptr(), bh, s, s, d ** -0.5, int(c["causal"]), stream)
            if rc:
                raise RuntimeError(f"baseline flash_fwd returned cudaError {rc}")

        new()
        old()
        torch.cuda.synchronize()
        ratio = 0.0
        for got, ref in zip(outs["n"], outs["b"]):
            limit = RTOL * (ref.abs() + ref.square().mean().sqrt())
            ratio = max(ratio, float(((got - ref).abs() / limit).max()))
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: the kernels differ by {ratio:.4g} times RTOL")
        rows[label] = {**c, "kv_chunk": chunk, "worst_share_of_rtol": ratio, **turns(new, old)}
    return rows


def fold_calls():
    """Phase 10d's fold calls: the guided Mixtral sweep, the VPP
    families and the kernel bench's batch, as recorded."""
    from simumax_tpu_torch.core import config as C
    from simumax_tpu_torch.search import batched as B
    from simumax_tpu_torch.search import search_best_parallel_strategy
    from simumax_tpu_torch.tools import bench_sweep as BS

    def inputs(model, strategy, world):
        base = C.get_strategy_config(strategy)
        base.world_size = world
        base.__post_init__()
        return base, C.get_model_config(model), C.get_system_config("tpu_v5p_256")

    calls = {}
    base, model, system = inputs("mixtral-8x7b", "ep4_pp2_dp4_mbs1", 64)
    with BS.recorded_folds() as calls["guided"]:
        search_best_parallel_strategy(copy.deepcopy(base), model, system, 64, topk=5,
                                      engine="batched", search_mode="guided",
                                      tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4, 8),
                                      ep_list=(1, 2, 4, 8), zero_list=(0, 1, 2, 3))
    with BS.recorded_folds() as calls["vpp"]:
        for spec in (dict(pp_size=2, interleaving_size=2), dict(pp_size=2, interleaving_size=4),
                     dict(pp_size=4, tp_size=2, interleaving_size=2),
                     dict(pp_size=2, interleaving_size=2, pp_comm_async=False)):
            st, model, system = inputs("llama3-8b", "tp1_pp1_dp8_mbs1", 16)
            for key, value in spec.items():
                setattr(st, key, value)
            st.__post_init__()
            mbc = list(range(st.vpp_group_size, 65, st.vpp_group_size))
            B.BatchedScorer(model, system, backend="cuda").kernel_for(st).score(
                [1] * len(mbc), mbc, backend="cuda")
    kern, mbs, mbc, nrc = BS.bench_family(BS.GRIDS["wide"], 4096, "cuda")
    with BS.recorded_folds() as calls["bench"]:
        kern.score(mbs, mbc, nrc=nrc, backend="cuda", device="cuda")
    return calls


def fold_rows(lib) -> dict:
    """Every recorded fold call, the current kernel against the
    baseline's, outputs equal bit for bit."""
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for path, calls in fold_calls().items():
        rows[path] = []
        for ops, fwd, bwd, p2p, blk, out in calls:
            pp, vp, n = fwd.shape
            n_ops = ops.shape[0]
            state = torch.empty((n_ops, n), dtype=torch.float64, device="cuda")
            base_out = torch.empty_like(out)

            def old():
                rc = lib.fold_schedule(n_ops, pp, vp, n, ops.data_ptr(), fwd.data_ptr(),
                                       bwd.data_ptr(), p2p.data_ptr(), blk.data_ptr(),
                                       state.data_ptr(), base_out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"baseline fold_schedule returned cudaError {rc}")

            old()
            torch.cuda.synchronize()
            if not torch.equal(out, base_out):
                raise AssertionError(f"fold pp {pp} vp {vp} n {n}: the kernels differ")
            levels = len(K.fold_level_spans(ops))
            t = turns(lambda: K.fold_schedule(ops, fwd, bwd, p2p, blk), old)
            rows[path].append({"pp": pp, "vp": vp, "n": n, "n_ops": n_ops, "levels": levels,
                               "new_us_per_level": t["new_ms"] / levels * 1e3, **t})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extract", metavar="COMMIT",
                    help="write COMMIT's kernel sources into build/baseline/COMMIT and stop")
    ap.add_argument("--baseline", help="directory holding the baseline's flash_attn.cu and "
                                       "fold.cu")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.extract:
        print(extract(args.extract))
        return {}
    if not args.baseline:
        raise SystemExit("time_redesign: give --baseline DIR (or --extract COMMIT first)")
    if not torch.cuda.is_available():
        raise SystemExit("time_redesign: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    libs = build_baseline(args.baseline)
    K.build()
    result = {"card": card.strip(), "baseline": os.path.abspath(args.baseline),
              "flash_fp32_fwd": flash_rows(libs["flash_attn.cu"]),
              "fold": fold_rows(libs["fold.cu"])}
    summary = {"card": result["card"], "flash_fp32_fwd": result["flash_fp32_fwd"], "fold": {}}
    for path, rows in result["fold"].items():
        big = max(rows, key=lambda r: (r["n_ops"], r["n"]))
        summary["fold"][path] = {
            "calls": len(rows), "new_ms_total": sum(r["new_ms"] for r in rows),
            "baseline_ms_total": sum(r["baseline_ms"] for r in rows), "largest": big}
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

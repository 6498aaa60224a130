"""The fp32 flash-attention kernels, the ragged int8 quantize, the rms
norm's backward or the MoE route's forward, backward and index against
another commit's, on the same calls.

The baseline is the source ``csrc/flash_attn.cu`` (``--kernels flash``,
the default), ``csrc/quant8.cu`` (``--kernels q8``),
``csrc/rms_norm.cu`` (``--kernels norm``) or ``csrc/moe_route.cu``
(``--kernels route``) of another commit, built here with the port's nvcc
flags into ``build/baseline/`` and loaded beside the current kernels.

Flash: the baseline's entry points are those of commit 2f9d7b8:
``flash_fwd`` with the kv split (dtype, d, q, k, v, o, lse, b*h, sq, skv,
scale, causal, kv_chunk, part, stream), as now, and ``flash_bwd_dq`` and
``flash_bwd_dkv`` without a split (dtype, d, q, k, v, dO, lse, delta, dq
or dk and dv, b*h, sq, skv, scale, causal, stream).

At ``chip_smoke.py``'s two fp32 cases (b 1, s 1024, h 2, d 64, causal;
b 1, s 2048, h 16, d 128, causal), on the same ``[b*h, s, d]`` operands,
the forward, dq and dk/dv are each timed in turns (current, baseline,
baseline, current; device ms between CUDA events, each the median of 5
calls after a warm-up, each queued behind a spin kernel so that the
host's wrapper is not timed), the current kernels with the splits
``kernels.flash_fwd_kv_chunk`` and ``flash_bwd_chunks`` pick (both
forwards take the same split: where the forward did not change, its row
is the method's own spread), and their outputs held within ``RTOL``
(1e-4 * (|baseline| + rms(baseline))) of the baseline's.

q8: the baseline's ``q8_quantize`` entry point is the current one's (that
of commit f51bffb), whose kernel 1 was the tiled column-major kernel
(``q8_quantize_cols_kernel``) and is now ``q8_quantize_ragged_kernel``.
At ``Q8_CASES`` (Aquila2's LM head [2048, 100008] in bf16 and fp32, and
[2048, 32000] in bf16, a shape the route gives the TMA kernels, forced
here through kernel 1), on the same x and amax, the column-major quantize
(the current kernel 1 against the baseline's) and both orders (the
current kernel 1 in its both mode, one launch, against the baseline's
row-major kernel and then its kernel 1) are timed in the same turns, and
their outputs must be equal bit for bit.

norm: the baseline's ``rms_norm_bwd`` entry point is the current one's
(that of commit fd7ecb3, whose backward walked each block's rows one at
a time with two block barriers a row, and summed dw over its
min(rows, 256) blocks' partials with one thread a column). At
``NORM_CASES`` (``chip_smoke.py``'s timed norm cases: [2048, 2048],
[2048, 1024], [2048, 4096] and [2048, 8192] in bf16, [2048, 1024] in
fp32), on the same x, w, rstd and dy, each backward (both its launches)
is timed in the same turns, ``NORM_CALLS`` calls a sample, its x and dy
rotated through copies that exceed twice the L2 cache, as a step finds
them; dx and dw must agree
with the baseline's within ``RTOL_NORM`` * (|baseline| + rms(baseline))
(1e-6: the two sum in other orders), plus in bf16 one bf16 ulp of the
larger of the two (each rounds its fp32 result once); each difference's
largest share of that limit, in bf16 ulps and absolute, is reported.
Each row reports both shares of the bound (x and dy read, dx written, w,
rstd and dw besides, over 3.35 TB/s) and their ratio.

route: the baseline's ``moe_route_fwd``, ``moe_route_bwd`` and
``moe_index`` entry points are the current ones (those of commit
44a39a0, whose index ran on one block and whose route summed through
shuffles, or of 35c6504, whose route backward ran one warp a token and
summed through shuffles). At ``ROUTE_CASES`` (the MoE row's [2048, 8]
top-2, [4096, 256] and [4096, 384] top-8 and [1024, 400] top-8, bf16)
the route's forward and backward (on the forward's probs and topi, with
a random d_topw), and the index over each route case's assignments and
at ``INDEX_RUNS_CASE`` (the manual step's ep 4 dispatch: 4096 keys over 4
destinations with their runs of expert ids), are timed in the same turns
from CUDA graph replays (``calibration.timing.time_graph``), each
captured call taking the next of copies of its inputs that exceed twice
the L2 cache, as ``chip_smoke.py``'s phase 3f times them; every output
must equal the baseline's bit for bit. Each row reports its bound (bytes
over 3.35 TB/s, or fp32 operations over 67 TFLOP/s for the route, the
larger), both shares of it, and for the index ``torch.sort(stable=True)``
of the same keys, timed the same way.

Usage. Write the baseline's source where git is (the card's machine has
no repository), then run on the card::

    python -m simumax_tpu_torch.tools.time_redesign --extract 2f9d7b8
    python -m simumax_tpu_torch.tools.time_redesign --baseline build/baseline/2f9d7b8
    python -m simumax_tpu_torch.tools.time_redesign --kernels q8 --extract f51bffb
    python -m simumax_tpu_torch.tools.time_redesign --kernels q8 \\
        --baseline build/baseline/f51bffb
    python -m simumax_tpu_torch.tools.time_redesign --kernels norm --extract fd7ecb3
    python -m simumax_tpu_torch.tools.time_redesign --kernels norm \\
        --baseline build/baseline/fd7ecb3
    python -m simumax_tpu_torch.tools.time_redesign --kernels route --extract 44a39a0
    python -m simumax_tpu_torch.tools.time_redesign --kernels route \\
        --baseline build/baseline/44a39a0
    python -m simumax_tpu_torch.tools.time_redesign --kernels route --extract 35c6504
    python -m simumax_tpu_torch.tools.time_redesign --kernels route \\
        --baseline build/baseline/35c6504

Prints one JSON object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

import torch

from simumax_tpu_torch.torchref import kernels as K

SOURCES = {"flash": "flash_attn.cu", "q8": "quant8.cu", "norm": "rms_norm.cu",
           "route": "moe_route.cu"}
FP32_CASES = {"fp32, 16 kv blocks": dict(b=1, s=1024, h=2, d=64, causal=True),
              "fp32 full width": dict(b=1, s=2048, h=16, d=128, causal=True)}
RTOL = 1e-4
SPIN_CYCLES = 2 * 10 ** 6
#: (case, rows, cols, dtype) of the q8 rows
Q8_CASES = [("Aquila2 LM head", 2048, 100008, torch.bfloat16),
            ("Aquila2 LM head", 2048, 100008, torch.float32),
            ("LM head", 2048, 32000, torch.bfloat16)]
#: (case, rows, h, dtype) of the norm rows
NORM_CASES = [("dense rows", 2048, 2048, torch.bfloat16),
              ("MoE row", 2048, 1024, torch.bfloat16),
              ("MoE row fp32", 2048, 1024, torch.float32),
              ("Llama3-8B width", 2048, 4096, torch.bfloat16),
              ("Llama3-70B width", 2048, 8192, torch.bfloat16)]
RTOL_NORM = 1e-6
#: (case, tokens, experts, k) of the route rows, bf16 logits
ROUTE_CASES = [("MoE row", 2048, 8, 2), ("top-8 of 256", 4096, 256, 8),
               ("top-8 of 384", 4096, 384, 8), ("top-8 of 400", 1024, 400, 8)]
#: (case, keys, destinations) of the index row with runs of expert ids:
#: the manual step's ep 4 dispatch (seq 2048 top-2 over 8 experts)
INDEX_RUNS_CASE = ("ep 4", 4096, 4)
PEAK_FP32_FLOPS = 67e12  # H100 SXM datasheet, outside the tensor cores
#: fp32 operations a token-expert pair of the route's forward and backward
#: (as ``chip_smoke.ROUTE_FLOPS``)
ROUTE_FWD_FLOPS = 4
ROUTE_BWD_FLOPS = 2
#: backwards a norm sample times back to back (each launch's own start
#: amortised, as in a step and in ``chip_smoke.py``'s graph timings)
NORM_CALLS = 10
L2_BYTES = 50 * 2 ** 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: the baseline's entry points: the flash kernels' of 2f9d7b8, the
#: quantize's of f51bffb, the norm's of fd7ecb3, the route's of 44a39a0
#: and 35c6504 (the backward's entry point has not changed since 44a39a0)
BASELINE_ARGTYPES = {
    "flash": {
        "flash_fwd": [_I, _I] + [_P] * 5 + [_I] * 3 + [_F, _I, _I, _P, _P],
        "flash_bwd_dq": [_I, _I] + [_P] * 7 + [_I] * 3 + [_F, _I, _P],
        "flash_bwd_dkv": [_I, _I] + [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    },
    "q8": {"q8_quantize": [_I, _P, _P, _P, _P, _P, _L, _L, _I, _P]},
    "norm": {"rms_norm_bwd": [_I] + [_P] * 7 + [_L, _I, _I, _P]},
    "route": {"moe_route_fwd": [_I] + [_P] * 4 + [_L, _I, _I, _P],
              "moe_route_bwd": [_I] + [_P] * 4 + [_L, _I, _I, _P],
              "moe_index": [_P] * 6 + [_L, _I, _I, _P]},
}


def extract(commit: str, kernels: str = "flash") -> str:
    """Write ``commit``'s source of ``kernels`` (a key of :data:`SOURCES`)
    into ``build/baseline/<commit>`` (needs git and the repository);
    returns the directory."""
    source = SOURCES[kernels]
    out = os.path.join(os.path.dirname(K.build_dir()), "baseline", commit)
    os.makedirs(out, exist_ok=True)
    src = subprocess.run(["git", "show", f"{commit}:simumax_tpu_torch/csrc/{source}"],
                         capture_output=True, text=True, check=True).stdout
    with open(os.path.join(out, source), "w") as f:
        f.write(src)
    return out


def build_baseline(directory: str, kernels: str = "flash") -> ctypes.CDLL:
    """The baseline's library of ``kernels``, built with the port's nvcc
    flags, with its entry points' argument types."""
    source = SOURCES[kernels]
    lib = os.path.join(directory, source.replace(".cu", ".so"))
    proc = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", lib, os.path.join(directory, source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"baseline {source}: nvcc exited {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(lib)
    for fn, argtypes in BASELINE_ARGTYPES[kernels].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def device_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Median device ms of a call of ``fn``: ``calls`` calls between two
    CUDA events, each sample queued behind a spin kernel, after a warm-up
    call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def turns(new, old, reps: int = 5, calls: int = 1) -> dict:
    t = [device_ms(new, reps, calls), device_ms(old, reps, calls), device_ms(old, reps, calls),
         device_ms(new, reps, calls)]
    return {"new_ms": (t[0] + t[3]) / 2, "baseline_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def checked(name, rc):
    if rc:
        raise RuntimeError(f"{name} returned cudaError {rc}")


def worst_share(got, ref, rtol: float = RTOL) -> float:
    """Largest |got - ref| over its limit rtol * (|ref| + rms(ref)),
    across the output tensors."""
    ratio = 0.0
    for g, r in zip(got, ref):
        limit = rtol * (r.abs() + r.square().mean().sqrt())
        ratio = max(ratio, float(((g - r).abs() / limit).max()))
    return ratio


def flash_rows(lib) -> dict:
    """The fp32 forward, dq and dk/dv at both cases, the current kernels
    against the baseline's, on the same operands."""
    rows = {}
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    new_lib = K._lib("flash_attn")
    for label, c in FP32_CASES.items():
        bh, s, d, causal = c["b"] * c["h"], c["s"], c["d"], int(c["causal"])
        scale = d ** -0.5
        gen = torch.Generator(device="cuda").manual_seed(1234)
        q, k, v, g = (torch.randn(bh, s, d, generator=gen, device="cuda") for _ in range(4))
        lse = torch.empty(bh, s, device="cuda")
        o = torch.empty_like(q)
        fwd_chunk = K.flash_fwd_kv_chunk(bh, s, s, sms)
        dq_chunk, dkv_chunk = K.flash_bwd_chunks(bh, s, s, sms)
        part = torch.empty(max(-(-s // fwd_chunk) * bh * s * (d + 2) if fwd_chunk else 0,
                               -(-s // dq_chunk) * bh * s * d if dq_chunk else 0,
                               -(-s // dkv_chunk) * 2 * bh * s * d if dkv_chunk else 0, 1),
                           device="cuda")
        checked("flash_fwd", new_lib.flash_fwd(0, d, d, q.data_ptr(), k.data_ptr(),
                                               v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh,
                                               s, s, scale, causal, 0, 0, stream))
        delta = (o * g).sum(-1)
        outs = {w: {"fwd": (torch.empty_like(q), torch.empty_like(lse)),
                    "dq": (torch.empty_like(q),),
                    "dkv": (torch.empty_like(q), torch.empty_like(q))} for w in "nb"}
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
        bwd_in = ptrs + [g.data_ptr(), lse.data_ptr(), delta.data_ptr()]

        def call(which, kernel):
            out = [t.data_ptr() for t in outs[which][kernel]]
            lib_, split = (new_lib, True) if which == "n" else (lib, False)
            # the current entry points take the v heads' width after d's
            widths = [d, d] if split else [d]
            if kernel == "fwd":  # the same split on both sides
                return lib_.flash_fwd(0, *widths, *ptrs, *out, bh, s, s, scale, causal,
                                      fwd_chunk, part.data_ptr(), stream)
            tail = [dq_chunk if kernel == "dq" else dkv_chunk, part.data_ptr()] if split else []
            entry = lib_.flash_bwd_dq if kernel == "dq" else lib_.flash_bwd_dkv
            return entry(0, *widths, *bwd_in, *out, bh, s, s, scale, causal, *tail, stream)

        chunks = {"fwd": fwd_chunk, "dq": dq_chunk, "dkv": dkv_chunk}
        for kernel in ("fwd", "dq", "dkv"):
            def new(kernel=kernel):
                checked(f"current {kernel}", call("n", kernel))

            def old(kernel=kernel):
                checked(f"baseline {kernel}", call("b", kernel))

            new()
            old()
            torch.cuda.synchronize()
            ratio = worst_share(outs["n"][kernel], outs["b"][kernel])
            if not ratio <= 1.0:
                raise AssertionError(f"{label} {kernel}: the kernels differ by {ratio:.4g} "
                                     f"times RTOL")
            rows[f"{label}: {kernel}"] = {**c, "chunk": chunks[kernel],
                                          "worst_share_of_rtol": ratio, **turns(new, old)}
    return rows


def q8_rows(lib) -> dict:
    """The column-major and both-order quantize at :data:`Q8_CASES`, the
    current kernel 1 against the baseline's (and, for both orders, the
    baseline's row-major kernel and its kernel 1), on the same x and
    amax."""
    rows_out = {}
    stream = torch.cuda.current_stream().cuda_stream
    new_lib = K._lib("quant8")
    for label, rows, cols, dtype in Q8_CASES:
        gen = torch.Generator(device="cuda").manual_seed(99)
        x = (torch.randn(rows, cols, generator=gen, device="cuda") * 2).to(dtype)
        amax = K.q8_amax(x)
        code = K._DTYPE_CODES[dtype]
        outs = {w: (torch.empty(rows, cols, dtype=torch.int8, device="cuda"),
                    torch.empty(cols, rows, dtype=torch.int8, device="cuda"),
                    torch.empty((), device="cuda")) for w in "nb"}

        def launch(which, kernel, q_rows):
            qr, qc, scale = outs[which]
            lib_ = new_lib if which == "n" else lib
            checked(f"{which} kernel {kernel}", lib_.q8_quantize(
                code, x.data_ptr(), amax.data_ptr(), qr.data_ptr() if q_rows else None,
                qc.data_ptr(), scale.data_ptr(), rows, cols, kernel, stream))

        calls = {"column-major": (lambda: launch("n", 1, False), lambda: launch("b", 1, False)),
                 "both": (lambda: launch("n", 1, True),
                          lambda: (launch("b", 0, True), launch("b", 1, False)))}
        n = rows * cols
        for order, (new, old) in calls.items():
            for w in "nb":
                for t in outs[w]:
                    t.fill_(0)
            new()
            old()
            torch.cuda.synchronize()
            compared = outs["n"][1:] + ((outs["n"][0],) if order == "both" else ())
            against = outs["b"][1:] + ((outs["b"][0],) if order == "both" else ())
            if not all(torch.equal(a, b) for a, b in zip(compared, against)):
                raise AssertionError(f"{label} {dtype} {order}: the kernels' outputs differ")
            nbytes = n * x.element_size() + 4 + n * (2 if order == "both" else 1) + 4
            rec = {"rows": rows, "cols": cols, "dtype": str(dtype).replace("torch.", ""),
                   "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   **turns(new, old)}
            rec.update(new_share=rec["bound_ms"] / rec["new_ms"],
                       baseline_share=rec["bound_ms"] / rec["baseline_ms"])
            rows_out[f"{label} {rec['dtype']}: {order}"] = rec
        del x, outs
        torch.cuda.empty_cache()
    return rows_out


def within(got, ref, dtype) -> float:
    """Largest |got - ref| over its limit: RTOL_NORM * (|ref| + rms(ref)),
    and in bf16 one bf16 ulp of the larger of |got| and |ref| besides
    (the two round fp32 values that differ by their sums' orders)."""
    g, r = got.float(), ref.float()
    limit = RTOL_NORM * (r.abs() + r.square().mean().sqrt())
    if dtype == torch.bfloat16:
        big = torch.maximum(g.abs(), r.abs())
        limit = limit + torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return float(((g - r).abs() / limit).max())


def bf16_ulps(got, ref) -> float:
    """Largest |got - ref| in bf16 ulps of the larger of |got| and |ref|."""
    big = torch.maximum(got.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    ulp = torch.where(big > 0, ulp, torch.ones_like(big))
    return float(((got.float() - ref.float()).abs() / ulp).max())


def norm_rows(lib) -> dict:
    """The rms norm's backward at :data:`NORM_CASES`, the current kernels
    against the baseline's, on the same inputs."""
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    new_lib = K._lib("rms_norm")
    for label, rows, h, dtype in NORM_CASES:
        gen = torch.Generator(device="cuda").manual_seed(2024)
        el = torch.finfo(dtype).bits // 8
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
        copies = [tuple((torch.randn(rows, h, generator=gen, device="cuda") * s).to(dtype)
                        for s in (2, 1))
                  for _ in range(max(2, -(-2 * L2_BYTES // (2 * rows * h * el))))]
        rstds = [K.rms_norm_fwd(x, w)[1] for x, _dy in copies]
        code = K._DTYPE_CODES[dtype]
        blocks = {"n": K.rms_norm_bwd_layout(rows, h, dtype)[1], "b": min(rows, 256)}
        outs = {k: (torch.empty(rows, h, dtype=dtype, device="cuda"),
                    torch.empty(h, dtype=dtype, device="cuda"),
                    torch.empty(b, h, device="cuda")) for k, b in blocks.items()}
        turn = {"i": 0}

        def launch(which, i):
            x, dy = copies[i]
            dx, dw, part = outs[which]
            lib_ = new_lib if which == "n" else lib
            checked(f"{which} rms_norm_bwd", lib_.rms_norm_bwd(
                code, x.data_ptr(), w.data_ptr(), rstds[i].data_ptr(), dy.data_ptr(),
                dx.data_ptr(), dw.data_ptr(), part.data_ptr(), rows, h, blocks[which], stream))

        def rotated(which):
            def call():
                turn["i"] = (turn["i"] + 1) % len(copies)
                launch(which, turn["i"])
            return call

        launch("n", 0)
        launch("b", 0)
        torch.cuda.synchronize()
        err = {name: {"share_of_limit": within(outs["n"][i], outs["b"][i], dtype),
                      "bf16_ulps": bf16_ulps(outs["n"][i], outs["b"][i]),
                      "max_abs": float((outs["n"][i].float() - outs["b"][i].float()).abs().max())}
               for i, name in enumerate(("dx", "dw"))}
        if not all(e["share_of_limit"] <= 1.0 for e in err.values()):
            raise AssertionError(f"{label}: the backwards differ: {err}")
        nbytes = 3 * rows * h * el + 2 * h * el + rows * 4
        rec = {"rows": rows, "h": h, "dtype": str(dtype).replace("torch.", ""),
               "blocks": blocks["n"], "baseline_blocks": blocks["b"], "differences": err,
               "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               **turns(rotated("n"), rotated("b"), reps=11, calls=NORM_CALLS)}
        rec.update(new_share=rec["bound_ms"] / rec["new_ms"],
                   baseline_share=rec["bound_ms"] / rec["baseline_ms"],
                   speedup=rec["baseline_ms"] / rec["new_ms"])
        out[label] = rec
        del copies, rstds, outs
        torch.cuda.empty_cache()
    return out


def graph_turns(new, old) -> dict:
    """``turns`` of two calls from CUDA graph replays (``time_graph``)."""
    from simumax_tpu_torch.calibration.timing import time_graph

    def ms(fn):
        return time_graph(fn) * 1e3

    t = [ms(new), ms(old), ms(old), ms(new)]
    return {"new_ms": (t[0] + t[3]) / 2, "baseline_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def rotated_copies(t) -> list:
    """Copies of t exceeding twice the L2 cache."""
    return [t.clone() for _ in range(max(1, -(-2 * L2_BYTES // (t.numel() * t.element_size()))))]


def cycle(copies):
    """A call that returns the next of ``copies`` each time."""
    state = {"i": 0}

    def pick():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]

    return pick


def _shares(rec: dict, nbytes: int, ops: int) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    rec.update(bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    rec.update(new_share=rec["bound_ms"] / rec["new_ms"],
               baseline_share=rec["bound_ms"] / rec["baseline_ms"],
               speedup=rec["baseline_ms"] / rec["new_ms"])
    return rec


def route_rows(lib) -> dict:
    """The route's forward and backward at :data:`ROUTE_CASES` and the
    index over their assignments and at :data:`INDEX_RUNS_CASE`, the
    current kernels against the baseline's, on the same inputs."""
    from simumax_tpu_torch.calibration.timing import time_graph

    out = {}
    new_lib = K._lib("moe_route")
    gen = torch.Generator(device="cuda").manual_seed(2026)

    def stream():  # the capturing stream inside a capture
        return torch.cuda.current_stream().cuda_stream

    def index_row(label, keys, values, e, cap):
        n = keys.numel()
        bufs = {w: (torch.empty(n, dtype=torch.int64, device="cuda"),
                    torch.empty(n, dtype=torch.int64, device="cuda"),
                    torch.empty(e + 1, dtype=torch.int64, device="cuda"),
                    None if values is None else
                    torch.empty(e, cap, dtype=torch.int32, device="cuda")) for w in "nb"}
        rk = cycle(rotated_copies(keys))
        rv = cycle(rotated_copies(values)) if values is not None else (lambda: None)

        def call(which, k_, v_):
            order, inv, seg, runs = bufs[which]
            lib_ = new_lib if which == "n" else lib
            checked(f"{which} moe_index", lib_.moe_index(
                k_.data_ptr(), K._ptr(v_), order.data_ptr(), inv.data_ptr(), seg.data_ptr(),
                K._ptr(runs), n, e, cap, stream()))

        call("n", keys, values)
        call("b", keys, values)
        torch.cuda.synchronize()
        if not all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(bufs["n"], bufs["b"])):
            raise AssertionError(f"moe_index [{label}]: the kernels' outputs differ")
        rec = {"keys": n, "experts": e, "runs": values is not None,
               **graph_turns(lambda: call("n", rk(), rv()), lambda: call("b", rk(), rv())),
               "torch_sort_ms": time_graph(lambda: torch.sort(rk(), stable=True)) * 1e3}
        nbytes = n * 8 * 3 + (e + 1) * 8 + (n * 8 + e * cap * 4 if values is not None else 0)
        out[f"moe_index [{label}]"] = _shares(rec, nbytes, 0)

    for label, tokens, e, k in ROUTE_CASES:
        x = torch.randn(tokens, e, generator=gen, device="cuda").to(torch.bfloat16)
        bufs = {w: (torch.empty(tokens, k, dtype=torch.bfloat16, device="cuda"),
                    torch.empty(tokens, k, dtype=torch.int64, device="cuda"),
                    torch.empty(tokens, e, device="cuda")) for w in "nb"}
        rx = cycle(rotated_copies(x))

        def route(which, x_, k=k, bufs=bufs):
            topw, topi, probs = bufs[which]
            lib_ = new_lib if which == "n" else lib
            checked(f"{which} moe_route_fwd", lib_.moe_route_fwd(
                1, x_.data_ptr(), topw.data_ptr(), topi.data_ptr(), probs.data_ptr(),
                x_.shape[0], x_.shape[1], k, stream()))

        route("n", x)
        route("b", x)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(bufs["n"], bufs["b"])):
            raise AssertionError(f"moe_route_fwd [{label}]: the kernels' outputs differ")
        rec = {"tokens": tokens, "experts": e, "k": k, "dtype": "bfloat16",
               **graph_turns(lambda: route("n", rx()), lambda: route("b", rx()))}
        nbytes = tokens * e * 2 + tokens * k * (2 + 8) + tokens * e * 4
        out[f"moe_route_fwd [{label}]"] = _shares(rec, nbytes, ROUTE_FWD_FLOPS * tokens * e)
        out.update(route_bwd_rows(label, lib, new_lib, bufs["n"], gen, stream))
        keys = bufs["n"][1].reshape(-1).clone()
        index_row(label, keys, None, e, int(2.0 * tokens * k / e))
        del x, bufs, rx, keys
        torch.cuda.empty_cache()
    label, n, ep = INDEX_RUNS_CASE
    flat_e = torch.randint(0, 8, (n,), generator=gen, device="cuda")
    index_row(label, flat_e // (8 // ep), flat_e, ep, n)
    return out


def route_bwd_rows(label, lib, new_lib, fwd, gen, stream) -> dict:
    """The route's backward on one case's forward outputs ``fwd`` (topw,
    topi, probs) and a random d_topw: the current kernel against the
    baseline's, every output bit equal."""
    _topw, topi, probs = fwd
    tokens, e = probs.shape
    k = topi.shape[1]
    g = torch.randn(tokens, k, generator=gen, device="cuda").to(torch.bfloat16)
    libs = {"n": new_lib, "b": lib}
    outs = {w: torch.empty(tokens, e, dtype=torch.bfloat16, device="cuda") for w in libs}
    rg, rp = cycle(rotated_copies(g)), cycle(rotated_copies(probs))

    def bwd(which, g_, p_):
        checked(f"{which} moe_route_bwd", libs[which].moe_route_bwd(
            1, g_.data_ptr(), p_.data_ptr(), topi.data_ptr(), outs[which].data_ptr(), tokens, e,
            k, stream()))

    for w in libs:
        bwd(w, g, probs)
    torch.cuda.synchronize()
    if not torch.equal(outs["n"], outs["b"]):
        raise AssertionError(f"moe_route_bwd [{label}]: the kernels' outputs differ")
    nbytes = tokens * k * (2 + 8) + tokens * e * 4 + tokens * e * 2
    return {f"moe_route_bwd [{label}]": _shares(
        {"tokens": tokens, "experts": e, "k": k, "dtype": "bfloat16",
         **graph_turns(lambda: bwd("n", rg(), rp()), lambda: bwd("b", rg(), rp()))},
        nbytes, ROUTE_BWD_FLOPS * tokens * e)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", choices=sorted(SOURCES), default="flash",
                    help="which kernels to hold against the baseline's")
    ap.add_argument("--extract", metavar="COMMIT",
                    help="write COMMIT's source of --kernels into build/baseline/COMMIT and stop")
    ap.add_argument("--baseline", help="directory holding the baseline's source")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.extract:
        print(extract(args.extract, args.kernels))
        return {}
    if not args.baseline:
        raise SystemExit("time_redesign: give --baseline DIR (or --extract COMMIT first)")
    if not torch.cuda.is_available():
        raise SystemExit("time_redesign: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    lib = build_baseline(args.baseline, args.kernels)
    K.build()
    result = {"card": card.strip(), "baseline": os.path.abspath(args.baseline)}
    if args.kernels == "flash":
        result["flash_fp32"] = flash_rows(lib)
    elif args.kernels == "q8":
        result["q8"] = q8_rows(lib)
    elif args.kernels == "norm":
        result["norm"] = norm_rows(lib)
    else:
        result["route"] = route_rows(lib)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

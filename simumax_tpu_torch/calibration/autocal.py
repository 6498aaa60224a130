"""Self-calibration on the CUDA card.

Port of the JAX package's ``calibration/autocal.py``.
:func:`calibrate_for_perf` reads the exact shape keys a ``PerfLLM``
estimate *missed* in the efficiency tables, measures precisely those
GEMM / grouped-GEMM / int8-GEMM / attention shapes with PyTorch on the
local card, measures the Adam update the reference step runs, and writes
the efficiencies back into the live system config.
:func:`calibrate_bandwidth_classes` measures the HBM bandwidth classes
(``default``, ``permute_fwd``, ``permute_bwd``, ``ce``, ``fused_adam``;
``ce_fusion`` keeps its prior, as in JAX), and :func:`calibrate_system`
calibrates, re-estimates and writes the system JSON with a provenance
stamp that names the card and its power limit.

Every microbenchmark is timed as the replay of a captured CUDA graph
(``timing.time_graph``), the counterpart of the reference's
``_chain_scan`` + ``_time_op``: a replay launches ``n`` calls of the op
without the host, and ``n`` grows until one replay lasts at least
``timing.MIN_SAMPLE_S``. The reference's anti-folding devices (the scalar
carry threaded into each input, the final reductions) are gone: eager
PyTorch folds nothing. The ``default`` class times one streaming
reduction that moves exactly its counted bytes, as the reference's fused
one does: it prices every memory-bound op the model does not price
otherwise, so it is the card's streaming rate, not one eager op's. Each
other benchmark runs what the port's own step runs for its function (its
eager ops; for the Adam update the CUDA kernel of ``csrc/adam.cu``; for
the permute classes the MoE dispatch and combine kernels at the MoE
row's layer, against the bytes the model charges them there), so
where eager PyTorch moves more bytes than the model's traffic count (the
cross-entropy's fp32 copy), the efficiency reads lower. :func:`with_retries` retries only a
device OOM, where the reference retried every error: a failed kernel
build, launch or capture propagates. Every measurement runs on the card;
without one it raises.
"""

from __future__ import annotations

import contextlib
import json
import math
import signal
import statistics
import subprocess
import time as _time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from simumax_tpu_torch.calibration.timing import time_graph
from simumax_tpu_torch.core.config import BandwidthSpec
from simumax_tpu_torch.core.errors import CalibrationError, CardRequiredError
from simumax_tpu_torch.core.records import Diagnostics
from simumax_tpu_torch.core.utils import cuda_flash_supported
from simumax_tpu_torch.observe.report import get_reporter
from simumax_tpu_torch.torchref.kernels import (
    flash_attention,
    math_attention,
    moe_combine_bwd,
    moe_combine_fwd,
    moe_index,
    moe_permute_bwd,
    moe_permute_fwd,
    moe_route_fwd,
)
from simumax_tpu_torch.torchref.model import adam_update, resolve_device
from simumax_tpu_torch.torchref.quantized import OPERAND_ORDERS
from simumax_tpu_torch.torchref.quantized import _mm as int8_mm

_DTYPES = {
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "fp32": torch.float32,
}

#: measured efficiencies must land in (0, EFF_MAX] — a couple of percent
#: above 1.0 is plausible clock/peak-spec slack, more means the
#: benchmark (or its FLOPs/traffic convention) is wrong
EFF_MAX = 1.05


def validate_efficiency(eff: float, op_key: str = "",
                        shape_key: str = "") -> float:
    """Guard a measured efficiency before it is written back into the
    system tables: must be finite and in ``(0, EFF_MAX]``."""
    if not isinstance(eff, (int, float)) or not math.isfinite(eff):
        raise CalibrationError(
            f"measured efficiency for {op_key}[{shape_key}] is not finite: "
            f"{eff!r}",
            phase="calibrate", op_key=op_key, shape_key=shape_key,
        )
    if not 0.0 < eff <= EFF_MAX:
        raise CalibrationError(
            f"measured efficiency {eff:.4f} for {op_key}[{shape_key}] is "
            f"outside (0, {EFF_MAX}] — benchmark or peak spec is wrong; "
            f"refusing to write it back",
            phase="calibrate", op_key=op_key, shape_key=shape_key,
            efficiency=eff,
        )
    return float(eff)


def with_retries(fn, *args, attempts: int = 3, backoff: float = 0.25,
                 label: str = "", **kwargs):
    """Run ``fn`` with bounded retry + exponential backoff.

    Only a transient device OOM (memory held by a neighbour) is retried;
    after ``attempts`` of them the last is wrapped in a
    :class:`CalibrationError` so callers can skip the key and continue.
    Every other error propagates as it is: a failed kernel build or
    launch must stop the calibration, not turn into a skipped key."""
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except torch.cuda.OutOfMemoryError as exc:
            last = exc
            torch.cuda.empty_cache()
            if attempt < attempts - 1:
                _time.sleep(backoff * (2 ** attempt))
    raise CalibrationError(
        f"microbenchmark {label or getattr(fn, '__name__', fn)!s} ran out of "
        f"device memory {attempts} times: {last}",
        phase="calibrate", attempts=attempts, last_error=repr(last),
    ) from last


def _parse_key(key: str) -> Dict[str, str]:
    out = {}
    for part in key.split(","):
        part = part.strip()
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _peak_tflops(system, op_key: str) -> float:
    spec = system.accelerator.op.get(op_key) or system.accelerator.op["default"]
    return spec.tflops


def _card(device) -> torch.device:
    """The CUDA device a measurement runs on; anything else raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise CardRequiredError(f"calibration measures on the CUDA card, not on {dev}")
    return dev


def _test_array(shape, dt, device):
    """Benchmark operand with non-trivial values (not all ones)."""
    n = math.prod(shape)
    x = (torch.arange(n, dtype=torch.float32, device=device) % 251) * 0.01
    return x.reshape(shape).to(dt)


# -- GEMM ---------------------------------------------------------------------


def measure_gemm_efficiency(
    m: int, k: int, n: int, dtype: str, out_dtype: str, peak_tflops: float,
    batch: int = 1, groups: int = 1, layout: str = "NN", device="cuda",
) -> float:
    """Measured tensor-core efficiency of a ``[m,k] x [k,n]`` matmul in
    the given operand layout (NN fwd, NT dgrad, TN wgrad — the operand
    transposition each backprop stage hands the GEMM), per group when
    ``groups > 1`` (balanced grouped GEMM, as ``bmm``). The product's
    type is its operands' (``out_dtype`` is part of the key only).
    ``dtype="int8"`` times the int8 path's own product
    (``torchref.quantized._mm``: ``kernels.int8_gemm``, int32 results) on
    operands in the memory order the path's quantizer writes for that
    layout (``torchref.quantized.OPERAND_ORDERS``)."""
    dev = _card(device)
    dt = _DTYPES.get(dtype, torch.bfloat16)
    if dtype == "int8":
        if batch != 1 or groups != 1:
            raise ValueError("the int8 path multiplies 2-D operands")
        shapes = {"NN": ((m, k), (k, n)), "NT": ((m, k), (n, k)), "TN": ((k, m), (k, n))}
        a, b = (_test_array(shape[::-1], torch.int8, dev).t() if cols else
                _test_array(shape, torch.int8, dev)
                for shape, cols in zip(shapes[layout], OPERAND_ORDERS[layout]))

        def op():
            return int8_mm(a, b, ta=layout == "TN", tb=layout == "NT")

        flops = 2.0 * m * k * n
    elif groups > 1:
        mg = max(m // groups, 1)
        a = _test_array((groups, mg, k), dt, dev)
        b = _test_array((groups, k, n), dt, dev)

        def op():
            return torch.bmm(a, b)

        flops = 2.0 * groups * mg * k * n
    else:
        lead = (batch,) if batch > 1 else ()
        if layout == "NT":
            a = _test_array(lead + (m, k), dt, dev)
            b = _test_array((n, k), dt, dev)

            def op():
                return a @ b.t()
        elif layout == "TN":
            a = _test_array(lead + (k, m), dt, dev)
            b = _test_array((k, n), dt, dev)

            def op():
                return a.transpose(-1, -2) @ b
        else:  # NN
            a = _test_array(lead + (m, k), dt, dev)
            b = _test_array((k, n), dt, dev)

            def op():
                return a @ b

        flops = 2.0 * batch * m * k * n
    with torch.no_grad():
        t = time_graph(op)
    return min(flops / t / (peak_tflops * 1e12), 1.0)


# -- attention ----------------------------------------------------------------


def measure_sdp_efficiency(
    b: int, sq: int, skv: int, hn: int, kv_hn: int, hd: int, hd_v: int,
    causal: bool, dtype: str, peak_tflops: float, backward: bool = False,
    sparse_ratio: float = 0.5, backend: str = "torch", flash: bool = True,
    device="cuda",
) -> Optional[float]:
    """Attention efficiency for the given backend: "torch" times the
    model's eager math attention (:func:`math_attention`), "cuda" the
    hand-written flash kernels (:func:`flash_attention`, MHA layout —
    GQA kv heads repeated upstream, as the kernels require). Returns
    None if the backend cannot run the shape."""
    dev = _card(device)
    dt = _DTYPES.get(dtype, torch.bfloat16)
    q = _test_array((b, sq, hn, hd), dt, dev)
    k = _test_array((b, skv, kv_hn, hd), dt, dev)
    v = _test_array((b, skv, kv_hn, hd_v), dt, dev)
    if backend == "cuda":
        if hd != hd_v:
            return None  # the kernels assume one head dim
        if not cuda_flash_supported(sq, skv, hd):
            return None  # runtime would fall back to math (shared gate)
        if kv_hn != hn:
            k = k.repeat_interleave(hn // kv_hn, dim=2)
            v = v.repeat_interleave(hn // kv_hn, dim=2)

        def attn(qq, kk, vv):
            return flash_attention(qq, kk, vv, causal)
    else:
        def attn(qq, kk, vv):
            return math_attention(qq, kk, vv, causal)

    with torch.no_grad():
        t_f = time_graph(attn, q, k, v)
    if backward:
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        go = torch.ones((b, sq, hn, hd_v), dtype=dt, device=dev)

        def fwd_bwd():
            # differentiate wrt q, k AND v — a dQ-only backward would
            # omit the dK/dV matmuls the bwd-FLOPs convention counts
            return torch.autograd.grad(attn(qg, kg, vg), (qg, kg, vg), go)

        t = time_graph(fwd_bwd)
        # grad timing includes the forward pass; subtract it
        t = max(t - t_f, t_f * 0.5)
        # MUST match the model's bwd-FLOPs convention for this path
        # (CoreAttention.op_flops: 2.5x fwd for flash, 2.0x for math)
        mult = 2.5 if flash else 2.0
    else:
        t = t_f
        mult = 1.0
    flops = 2.0 * b * hn * sq * skv * (hd + hd_v) * mult
    if causal:
        flops *= 1.0 - sparse_ratio
    return min(flops / t / (peak_tflops * 1e12), 1.0)


# -- HBM bandwidth classes ----------------------------------------------------


def measure_bandwidth_efficiency(
    kind: str, peak_gbps: float, nbytes: float = 256 * 2**20,
    vocab: int = 32000, device="cuda",
) -> float:
    """Measured HBM efficiency of a bandwidth class, against the JAX
    package's traffic count for it: 'default' a streaming reduction of
    bf16 elements in fp32 (``elems * 2`` bytes; one kernel that reads
    each element once, as XLA's fused upcast and sum: the class prices
    every memory-bound op the model prices no other way), 'ce' a
    log-softmax cross-entropy over bf16 logits (``tokens * vocab * 4``,
    two passes over the logits, as ``ParallelCE.op_accessed`` charges),
    'fused_adam' the Adam update (:func:`_measure_fused_adam`), the
    others the ops the port's step runs for that function: the loss of
    ``torchref/model.py``. 'permute_fwd' and 'permute_bwd' price the
    MoE dispatch and combine of each phase, and time the kernels the
    step runs for them at the MoE row's layer against the bytes the
    model charges them there (:func:`_measure_permute`; ``nbytes`` does
    not apply)."""
    if kind == "ce_fusion":
        raise CalibrationError(
            "ce_fusion is not measurable with the unfused CE benchmark "
            "(a fused kernel avoids its fp32 materialization); keep the "
            "configured prior or calibrate against a real fused kernel"
        )
    if kind == "fused_adam":
        return _measure_fused_adam(peak_gbps, nbytes, device=device)
    if kind.startswith("permute"):
        return _measure_permute(kind, peak_gbps, device=device)
    dev = _card(device)
    if kind.startswith("ce"):
        tokens = max(int(nbytes // (vocab * 2)), 8)
        logits = _test_array((tokens, vocab), torch.bfloat16, dev)
        targets = torch.zeros((tokens, 1), dtype=torch.long, device=dev)

        def op():
            logp = torch.log_softmax(logits.float(), dim=-1)
            return -torch.gather(logp, -1, targets).mean()

        traffic = tokens * vocab * 4
    else:
        elems = max(int(nbytes // 2), 1024)
        x = _test_array((elems,), torch.bfloat16, dev)

        def op():
            return x.sum(dtype=torch.float32)

        traffic = elems * 2
    with torch.no_grad():
        t = time_graph(op)
    return min(traffic / t / (peak_gbps * 1e9), 1.0)


#: the card's L2 cache (an H100's 50 MB), which the permute classes'
#: inputs are rotated through twice over
_L2_BYTES = 50 * 2**20
#: the layer the permute classes are timed at: the MoE row's
#: (``bench_moe_0p4b``, seq 2048, mbs 1: 2048 tokens of hidden 1024, 8
#: experts top-2, capacity factor 2, bf16)
PERMUTE_LAYER = dict(tokens=2048, hidden=1024, experts=8, topk=2, capacity_factor=2.0)


def permute_traffic() -> int:
    """The bytes the analytical model charges one phase (forward, or the
    activations' backward) of :data:`PERMUTE_LAYER`'s dispatch and
    combine, both priced by the permute classes (``models/moe.py``:
    ``Permutation`` twice its [tokens * topk * cf, hidden] output,
    ``UnPermutation`` that input and its [tokens, hidden] output), in
    bf16."""
    layer = PERMUTE_LAYER
    tokens, hidden = layer["tokens"], layer["hidden"]
    permuted = int(tokens * layer["topk"] * layer["capacity_factor"]) * hidden * 2
    return 2 * permuted + permuted + tokens * hidden * 2


def _measure_permute(kind: str, peak_gbps: float, device="cuda") -> float:
    """Measured efficiency of a permute class: the MoE dispatch and combine
    kernels of one phase (``kernels.moe_permute_fwd`` and
    ``moe_combine_fwd``, or ``moe_permute_bwd`` and ``moe_combine_bwd``:
    what the MoE step launches for the ops the class prices) at
    :data:`PERMUTE_LAYER`, routed by the port's route and index on
    seeded logits, against :func:`permute_traffic`. Successive calls
    take successive copies of the inputs, more of them than the L2 cache
    holds twice, so each call reads them from device memory as the step
    does (a product wrote them). The kernels move less than the model
    charges (the permute reads the kept token rows once, not the whole
    buffer), so the reading may exceed 1 and is clipped there."""
    dev = _card(device)
    t, h, e, k = (PERMUTE_LAYER[key] for key in ("tokens", "hidden", "experts", "topk"))
    cap = int(PERMUTE_LAYER["capacity_factor"] * t * k / e)
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn(t, e, generator=gen, device=dev).to(torch.bfloat16)
    w, topi = moe_route_fwd(logits, k)[:2]
    idx = moe_index(topi.reshape(t * k), e, cap, k)
    w = w.reshape(t * k)
    copies = math.ceil(2 * _L2_BYTES / ((t + e * cap) * h * 2))
    inputs = [(_test_array((t, h), torch.bfloat16, dev),
               _test_array((e, cap, h), torch.bfloat16, dev)) for _ in range(copies)]
    turn = [0]

    def take():
        turn[0] = (turn[0] + 1) % copies
        return inputs[turn[0]]

    if kind == "permute_bwd":
        def op():
            rows, buf = take()
            moe_permute_bwd(buf, None, idx)
            return moe_combine_bwd(rows, buf, w, idx)
    else:
        def op():
            rows, buf = take()
            moe_permute_fwd(rows, None, idx)
            return moe_combine_fwd(buf, w, idx)
    with torch.no_grad():
        t_op = time_graph(op)
    return min(permute_traffic() / t_op / (peak_gbps * 1e9), 1.0)


def _measure_fused_adam(peak_gbps: float, nbytes: float = 256 * 2**20,
                        device="cuda") -> float:
    """Measured HBM efficiency of the very update the reference train
    step runs (``torchref.model.adam_update``): bf16 param + grad, fp32
    moments, against the 22 B/param the analytical "functional"
    optimizer charges. On the card that update is one launch of
    ``csrc/adam.cu``'s kernel, which moves those 22 B a parameter and
    no more, plus the step's bias corrections (a few scalar launches),
    so the efficiency is the kernel's share of HBM's rate. The graph
    timer's eager warm-up calls make the kernel's leaf table before it
    captures."""
    dev = _card(device)
    numel = max(int(nbytes // 22), 1024)
    g = _test_array((numel,), torch.bfloat16, dev)
    p = _test_array((numel,), torch.bfloat16, dev)
    mu = _test_array((numel,), torch.float32, dev)
    nu = _test_array((numel,), torch.float32, dev)

    count = torch.ones((), dtype=torch.int32, device=dev)

    def step():
        adam_update([p], [g], [mu], [nu], step=count)

    t = time_graph(step)
    return min(numel * 22 / t / (peak_gbps * 1e9), 1.0)


def calibrate_bandwidth_classes(system, verbose: bool = False,
                                nbytes: float = 256 * 2**20,
                                vocab: int = 32000, device="cuda",
                                classes: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Measure the HBM bandwidth classes in the system config (or only
    ``classes`` of them) and write the efficiencies back; returns
    {class: efficiency}. A ``fused_adam`` class (the same HBM as
    ``default``) is added when missing.
    ``ce_fusion`` is skipped: a fused CE kernel avoids exactly the fp32
    materialization the unfused benchmark performs, so its prior stays.
    Each class retries a device OOM (:func:`with_retries`) and must pass
    :func:`validate_efficiency`."""
    _card(device)
    out = {}
    bw = system.accelerator.bandwidth
    if "fused_adam" not in bw:
        base = bw["default"]
        bw["fused_adam"] = BandwidthSpec(
            gbps=base.gbps, efficient_factor=base.efficient_factor,
            latency_us=base.latency_us,
        )
    if classes is not None and not set(classes) <= set(bw) - {"ce_fusion"}:
        raise CalibrationError(f"no measurable bandwidth class among {sorted(classes)}: the "
                               f"config has {sorted(bw)} (ce_fusion keeps its prior)")
    for key, spec in bw.items():
        if key == "ce_fusion" or (classes is not None and key not in classes):
            continue
        eff = validate_efficiency(
            with_retries(measure_bandwidth_efficiency, key, spec.gbps, nbytes, vocab,
                         device=device, label=f"bandwidth[{key}]"),
            "bandwidth", key,
        )
        spec.efficient_factor = eff
        out[key] = eff
        if verbose:
            get_reporter().info(f"[cal] bandwidth {key}: eff {eff:.3f}",
                                event="calibrate_bw", key=key, eff=eff)
    return out


# -- miss-driven loop ---------------------------------------------------------


def calibrate_key(op_key: str, shape_key: str, system,
                  sparse_ratio: float = 0.5, attempts: int = 3,
                  device="cuda") -> Optional[float]:
    """Measure one (op table, shape key) pair; None if unsupported (a
    malformed key, or an ``int8_matmul`` key with ``b > 1``, which the
    int8 path never multiplies, is skipped). ``int8_group_matmul`` keys
    take the grouped path with the key's dtype (default bf16), as in the
    JAX package.

    Each microbenchmark runs under :func:`with_retries`; a key that keeps
    running out of memory raises :class:`CalibrationError` so the caller
    can quarantine it. Any other failure of the measurement propagates."""
    kv = _parse_key(shape_key)
    peak = _peak_tflops(system, op_key)
    label = f"{op_key}[{shape_key}]"
    try:
        if op_key.endswith("group_matmul"):
            fn, kwargs = measure_gemm_efficiency, dict(
                m=int(kv["M"]), k=int(kv["K"]), n=int(kv["N"]),
                dtype=kv.get("dtype", "bf16"),
                out_dtype="fp32" if kv.get("accumulate") == "True" else kv.get("dtype", "bf16"),
                peak_tflops=peak, groups=int(kv["ng"]),
            )
        elif op_key.endswith("matmul"):
            int8 = op_key.startswith("int8")
            if int8 and int(kv.get("b", 1)) != 1:
                return None
            fn, kwargs = measure_gemm_efficiency, dict(
                m=int(kv["m"]), k=int(kv["k"]), n=int(kv["n"]),
                dtype="int8" if int8 else "bf16", out_dtype=kv.get("out_dtype", "bf16"),
                peak_tflops=peak, batch=int(kv.get("b", 1)),
                layout=kv.get("layout", "NN"),
            )
        elif op_key in ("sdp_fwd", "sdp_bwd"):
            fn, kwargs = measure_sdp_efficiency, dict(
                b=int(kv["b"]), sq=int(kv["sq"]), skv=int(kv["skv"]),
                hn=int(kv["hn"]), kv_hn=int(kv["kv_hn"]), hd=int(kv["hd"]),
                hd_v=int(kv.get("hd_v", kv["hd"])),
                causal=kv.get("causal") == "True",
                dtype=kv.get("dtype", "bf16"), peak_tflops=peak,
                backward=op_key == "sdp_bwd", sparse_ratio=sparse_ratio,
                backend=kv.get("backend", "torch"),
                flash=kv.get("flash", "True") == "True",
            )
        else:
            return None
    except (KeyError, ValueError):
        # malformed shape key for this op family: unsupported, not an
        # error worth retrying
        return None
    return with_retries(fn, device=device, attempts=attempts, label=label, **kwargs)


def calibrate_for_perf(perf, max_keys: Optional[int] = None,
                       verbose: bool = False,
                       diagnostics: Optional[Diagnostics] = None,
                       device="cuda") -> Dict[str, Dict[str, float]]:
    """Measure every efficiency-table miss recorded by the last
    ``run_estimate()`` and write the results into the live SystemConfig.
    Returns {op_key: {shape_key: efficiency}}.

    Hardened: each key's benchmark retries a device OOM
    (:func:`with_retries`) and its result must pass
    :func:`validate_efficiency` before write-back; keys that still fail
    those are skipped and recorded in ``diagnostics``. A failed kernel
    build or launch aborts the pass."""
    _card(device)
    system = perf.system
    sparse = perf.strategy.attention_sparse_ratio
    measured: Dict[str, Dict[str, float]] = {}
    count = 0
    for op_key, keys in list(system.miss_efficiency.items()):
        spec = system.accelerator.op.get(op_key)
        if spec is None:
            continue
        for shape_key in keys:
            if max_keys is not None and count >= max_keys:
                break
            try:
                eff = calibrate_key(op_key, shape_key, system, sparse,
                                    device=device)
                if eff is None:
                    continue
                eff = validate_efficiency(eff, op_key, shape_key)
            except CalibrationError as exc:
                if diagnostics is not None:
                    diagnostics.record_exception(
                        exc, category="calibration",
                        op_key=op_key, shape_key=shape_key,
                    )
                if verbose:
                    get_reporter().info(
                        f"[cal] SKIP {op_key}: {shape_key} ({exc})",
                        event="calibrate_skip", op_key=op_key,
                        shape_key=shape_key,
                    )
                continue
            spec.accurate_efficient_factor[shape_key] = eff
            measured.setdefault(op_key, {})[shape_key] = eff
            count += 1
            if verbose:
                get_reporter().info(
                    f"[cal] {op_key}: {shape_key} -> {eff:.3f}",
                    event="calibrate_key", op_key=op_key,
                    shape_key=shape_key, eff=eff,
                )
    # the functional optimizer is a large share of a single-card step:
    # measure its update bandwidth class whenever the estimate relies on
    # an unmeasured fallback (miss-driven, same as the shape keys)
    if (perf.strategy.optimizer_style == "functional"
            and "fused_adam" not in system.accelerator.bandwidth):
        base = system.accelerator.bandwidth["default"]
        try:
            eff = validate_efficiency(
                with_retries(_measure_fused_adam, base.gbps, device=device,
                             label="bandwidth[fused_adam]"),
                "bandwidth", "fused_adam",
            )
        except CalibrationError as exc:
            if diagnostics is not None:
                diagnostics.record_exception(
                    exc, category="calibration", op_key="bandwidth",
                    shape_key="fused_adam",
                )
            if verbose:
                get_reporter().info(
                    f"[cal] SKIP bandwidth fused_adam ({exc})",
                    event="calibrate_skip", op_key="bandwidth",
                    shape_key="fused_adam",
                )
            eff = None
        if eff is not None:
            system.accelerator.bandwidth["fused_adam"] = BandwidthSpec(
                gbps=base.gbps, efficient_factor=eff,
                latency_us=base.latency_us,
            )
            measured.setdefault("bandwidth", {})["fused_adam"] = eff
            if verbose:
                get_reporter().info(
                    f"[cal] bandwidth fused_adam -> {eff:.3f}",
                    event="calibrate_bw", key="fused_adam", eff=eff,
                )
    return measured


def card_identity(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (for example ``NVIDIA H100 80GB HBM3, 700.00 W``): a card may be set
    below its maximum power and then runs slower under load."""
    dev = _card(device)
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return lines[dev.index or 0].strip()


@contextlib.contextmanager
def sm_clock_samples(device="cuda", every_ms: int = 100) -> Iterator[List[int]]:
    """The card's SM clock in MHz, sampled by ``nvidia-smi`` every
    ``every_ms`` while the block runs, into the list it yields (filled
    when the block ends; the sampling process is stopped there). Under a
    power cap the clock, and with it a GEMM's efficiency, moves with the
    load."""
    dev = _card(device)
    proc = subprocess.Popen(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", f"--loop-ms={every_ms}"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples: List[int] = []
    try:
        yield samples
    finally:
        proc.send_signal(signal.SIGINT)  # nvidia-smi ends its loop cleanly on ^C
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        samples.extend(int(line) for line in out.split() if line.strip().isdigit())


def clock_summary(samples: List[int]) -> Dict[str, float]:
    """Median, least and most of SM clock samples (MHz), and their count."""
    if not samples:
        return {"samples": 0}
    return {"median_mhz": statistics.median(samples), "min_mhz": min(samples),
            "max_mhz": max(samples), "samples": len(samples)}


def card_max_sm_clock(device="cuda") -> int:
    """The card's highest SM clock in MHz (``clocks.max.sm``)."""
    dev = _card(device)
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()
    return int(lines[dev.index or 0])


def save_system(system, path: str, device="cuda", extra: Optional[Dict] = None) -> Dict:
    """Stamp ``system``'s provenance (its hardware fingerprint, the date,
    the version, :func:`card_identity` and any ``extra`` entries) and
    write it as JSON to ``path``; returns the stamp. A config loaded
    against other hardware then warns instead of silently skewing
    estimates."""
    card = card_identity(device)
    stamp = system.stamp_provenance()
    stamp["card"] = card
    stamp.update(extra or {})
    with open(path, "w") as f:
        json.dump(system.to_dict(), f, indent=2, default=lambda o: vars(o))
    return stamp


def calibrate_system(perf, save_path: Optional[str] = None, device="cuda",
                     **kwargs) -> Dict[str, Dict[str, float]]:
    """:func:`calibrate_for_perf` + re-estimate + optional write-back of
    the updated system config JSON (:func:`save_system`). Returns what
    :func:`calibrate_for_perf` measured."""
    measured = calibrate_for_perf(perf, device=device, **kwargs)
    perf.run_estimate()  # re-run with calibrated tables
    if save_path:
        save_system(perf.system, save_path, device)
    return measured

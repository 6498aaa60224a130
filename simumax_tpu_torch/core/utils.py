"""Formatting / small helpers (reference ``simumax/core/utils.py``).

Copy of the JAX package's ``core/utils.py``; the Pallas shape gate
``pallas_attention_supported`` became :func:`cuda_flash_supported`,
the gate of the CUDA flash kernels."""

from __future__ import annotations

from typing import Any, List


def dp_comm_buckets(numel: float, group_size: int) -> List[float]:
    """Megatron DDP gradient-bucket sizes (elements): buckets of
    ``max(40M, 1M x group)`` elements, last bucket partial (reference
    bucketing in ``perf_llm.py:1513-1597``). Shared *sizing* between the
    analytical path and the event simulator — the overlap/schedule logic
    on top is deliberately independent in each."""
    cap = float(max(40_000_000, 1_000_000 * group_size))
    out: List[float] = []
    remaining = float(numel)
    while remaining > 1e-9:
        take = min(remaining, cap)
        out.append(take)
        remaining -= take
    return out


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"


def human_time(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.3f} s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.3f} ms"
    return f"{seconds * 1e6:.2f} us"


def humanize_result(d: Any) -> Any:
    """Recursively prettify keys ending in _bytes/_time (reference
    ``convert_final_result_to_human_format`` core/utils.py:146-170)."""
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            if isinstance(v, (int, float)) and k.endswith("_bytes"):
                out[k.replace("_bytes", "")] = human_bytes(v)
            elif isinstance(v, (int, float)) and k.endswith("_time"):
                out[k.replace("_time", "")] = human_time(v)
            else:
                out[k] = humanize_result(v)
        return out
    if isinstance(d, list):
        return [humanize_result(x) for x in d]
    return d


#: tile edge of the CUDA flash kernels (``csrc/flash_attn.cu``): each
#: block owns 64 query (or key) rows and streams 64-row tiles of the
#: other operand through shared memory
CUDA_FLASH_BLOCK = 64
#: head sizes the CUDA flash kernels are instantiated for
CUDA_FLASH_HEAD_SIZES = (64, 128)


def cuda_flash_supported(sq: int, skv: int, d: int) -> bool:
    """Shape gate of the hand-written CUDA flash kernels, shared by the
    runtime dispatcher (``torchref.kernels.attention``), the calibration
    sweep, and the analytical ``sdp_backend="cuda"`` sanity check —
    one predicate so prediction and measurement cannot silently pick
    different backends. It admits exactly the shapes the kernels take:
    sequence lengths that tile into whole 64-row blocks (the kernels
    mask no ragged edge) and the head sizes they are compiled for."""
    return (
        sq > 0 and skv > 0
        and sq % CUDA_FLASH_BLOCK == 0 and skv % CUDA_FLASH_BLOCK == 0
        and d in CUDA_FLASH_HEAD_SIZES
    )

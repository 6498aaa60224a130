"""Pipeline schedule orders shared by the analytical replay
(``PerfLLM.calculate_1f1b_bubble``) and the event simulator
(``simulator.schedule.StageProcess``) — a single source of truth so the
perf-vs-simulator cross-check can never desynchronize on the op order.

Reference: Megatron non-interleaved 1F1B
(``pipeline_schedule.py:717-959``) and interleaved VPP warmup formula
(``pipeline_schedule.py:124-135``).
"""

from __future__ import annotations

from typing import List, Tuple


def one_f_one_b_order(pp: int, stage: int, mbc: int) -> List[Tuple[str, int]]:
    """Non-interleaved 1F1B op order for one stage: warmup forwards,
    steady 1F1B pairs, cooldown backwards."""
    w = min(mbc, pp - stage - 1)
    ops = [("F", i) for i in range(w)]
    f, b = w, 0
    while f < mbc or b < mbc:
        if f < mbc:
            ops.append(("F", f))
            f += 1
        if b < mbc:
            ops.append(("B", b))
            b += 1
    return ops


def single_stage_order(mbc: int) -> List[Tuple[str, int]]:
    """Degenerate pp=1 "schedule": each microbatch's backward follows
    its forward immediately (no inter-stage dependencies, so 1F1B
    reduces to F0 B0 F1 B1 ...). Shared by the analytical-trace export
    and the pp=1 fast path of ``PerfLLM.calculate_1f1b_bubble`` so the
    trace lays out exactly the op stream the estimate charged."""
    ops: List[Tuple[str, int]] = []
    for i in range(mbc):
        ops.append(("F", i))
        ops.append(("B", i))
    return ops


def interleaved_order(
    pp: int, stage: int, mbc: int, vp: int, group_size: int = 0
) -> List[Tuple[str, int, int]]:
    """Interleaved (VPP) schedule: ops are (kind, chunk_idx, microbatch).

    Megatron interleaved 1F1B: microbatches are processed in groups of
    ``group_size`` (default pp) per virtual chunk; warmup =
    ``(pp - stage - 1) * 2 + (vp - 1) * group_size`` forwards
    (reference ``pipeline_schedule.py:124-135``).
    """
    group = group_size or pp
    total = mbc * vp  # virtual microbatch slots per stage
    assert mbc % group == 0, (
        f"interleaved schedule requires micro_batch_num {mbc} divisible "
        f"by microbatch group size {group}"
    )

    def slot_to_op(slot: int) -> Tuple[int, int]:
        # slot ordering: chunks advance every `group` microbatches
        g, r = divmod(slot, group * vp)
        chunk, mb_in_group = divmod(r, group)
        return chunk, g * group + mb_in_group

    warmup = min((pp - stage - 1) * 2 + (vp - 1) * group, total)
    ops: List[Tuple[str, int, int]] = []
    f = b = 0
    for _ in range(warmup):
        c, m = slot_to_op(f)
        ops.append(("F", c, m))
        f += 1
    while f < total or b < total:
        if f < total:
            c, m = slot_to_op(f)
            ops.append(("F", c, m))
            f += 1
        if b < total:
            c, m = slot_to_op(b)
            # backward consumes chunks in reverse order
            ops.append(("B", vp - 1 - c, m))
            b += 1
    return ops

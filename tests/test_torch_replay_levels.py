"""The level schedule of the batched scenario replay
(``simulator/batched_replay.py``: ``level_schedule``, ``build_tables``,
``pack_scenarios``), which ``csrc/replay.cu`` replays a level at a time.

Cases: the chaos grid's cells (``tests/torch_fault_cells.py``: dense pp 2,
MoE pp 4, MLA pp 2, and dense pp 2 with blocking sends and an overlapped
gradient reduce), each family a walk of seeded scenarios lowers, with
the scenarios the walk hands the replay; and the synthetic family that
holds every op kind, under its fault models.

Checks: the schedule is a permutation whose offsets cover it; every
dependence through a state slot (``clock``, ``cd``, ``v2``, ``v``; read
after write, write after read, write after write) lies in a strictly
earlier level, derived here op by op; and the plain version run over
the program in level order, with each level's ops forward, reversed and
in two seeded shuffles, gives the lowered order's makespans and the
scalar engine's (the port's ``SimuEngine``, and for the synthetic family
the JAX package's too). The JAX package's jax backend is no oracle here
(it fails without ``jax.experimental.enable_x64``).

Tolerance: none. Every order replays the same float64 operations on the
same values, so the makespans are equal with ``==``.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from simumax_tpu.simulator import faults as jf  # noqa: E402
from simumax_tpu.simulator.engine import ReplayProc as JaxReplayProc  # noqa: E402
from simumax_tpu.simulator.engine import SimuEngine as JaxSimuEngine  # noqa: E402
from simumax_tpu_torch import PerfLLM  # noqa: E402
from simumax_tpu_torch.core.config import get_model_config, get_strategy_config  # noqa: E402
from simumax_tpu_torch.simulator import batched_replay as br  # noqa: E402
from simumax_tpu_torch.simulator import faults as tf  # noqa: E402
from simumax_tpu_torch.simulator.engine import ReplayProc, SimuEngine  # noqa: E402
from simumax_tpu_torch.torchref import kernels as K  # noqa: E402

from torch_fault_cells import (  # noqa: E402
    CELLS,
    SYNC_CELL,
    build_perf,
    mixed,
    sampled,
    synthetic_family,
    synthetic_models,
)

CASES = ["dense-pp2", "moe-pp4", "mla-pp2", "dense-pp2-sync", "synthetic"]
ORDERS = ["forward", "reversed", "shuffle0", "shuffle1"]


@functools.lru_cache(maxsize=None)
def _families(case):
    """[(program, [fault model], [scalar engine makespan])] of a case,
    one entry a lowered family with every scenario the walk gave it."""
    if case == "synthetic":
        streams, plan = synthetic_family()
        prog = br.lower_family(streams, plan)
        models = synthetic_models(tf, plan)
        want = []
        for m in models:
            eng = SimuEngine(plan.n_classes, drop_events=True)
            for i in range(plan.n_classes):
                eng.add_rank(i, ReplayProc(streams[i]))
            eng._fault = m
            eng.run_incremental()
            want.append(max(eng.clock))
        return [(prog, models, want)]
    cell = SYNC_CELL if case == "dense-pp2-sync" else CELLS[case]
    perf = build_perf(PerfLLM, get_model_config, get_strategy_config, **cell)
    h = perf.simulate(None, world_ranks=True, granularity="chunk",
                      track_memory=False)["end_time_ms"]
    ctx = tf.ReplayContext(perf, options=tf.ReplayOptions(replay_backend="cuda", device="cpu"))
    seen = {}
    orig = ctx._solve_groups

    def solve_groups(grp, outs):
        for fam, prog, members in grp.values():
            got = seen.setdefault(id(prog), (prog, [], []))
            for it, m in members:
                got[1].append(m)
                got[2].append(ctx._replay(it[1], fam)[2])
        return orig(grp, outs)

    ctx._solve_groups = solve_groups
    scs = sampled(tf.sample_scenario, case, perf.strategy.world_size, h, n=4) + [
        mixed(tf.FaultEvent, tf.FaultScenario, h, death=False)]
    tf._predict_goodput_batch(ctx, [(s, tf.CheckpointSpec(interval_steps=2)) for s in scs])
    assert seen, case
    return list(seen.values())


def _levels(prog):
    order, offsets = br.level_schedule(prog)
    level = np.empty(prog.n_ops, dtype=np.int64)
    for lv in range(len(offsets) - 1):
        level[order[offsets[lv]:offsets[lv + 1]]] = lv
    return order, offsets, level


def _accesses(prog, i):
    """(slots op i reads, slots it writes), as the replay's state is
    touched by ``replay_solve_plain`` (``v[i]`` of a collective and a
    finish is never read, and left out)."""
    n = prog.n_ops
    op, r, a = int(prog.kind[i]), int(prog.rank[i]), int(prog.aux[i])
    members = np.flatnonzero(prog.mask[i]).tolist()
    if op == br.OP_COLL:
        clocks = {("clock", x) for x in members}
        return clocks, clocks
    if op == br.OP_ASYNC_FINISH:
        state = {("cd", x) for x in members} | {("v2", a)}
        posts = {("v", int(j)) for j in prog.refs[i] if j < n}
        return state | posts, state
    reads, writes = {("clock", r)}, {("v", i)}
    if op not in (br.OP_SEND, br.OP_ASYNC_POST, br.OP_NOOP):
        writes.add(("clock", r))
    if op == br.OP_WAIT_COMM:
        reads.add(("cd", r))
    elif op == br.OP_RECV:
        reads.add(("v", a))
    elif op == br.OP_SEND_SYNC:
        reads.add(("clock", a))
    return reads, writes


@pytest.mark.parametrize("case", CASES)
def test_level_schedule_is_a_permutation_with_covering_offsets(case):
    for prog, _models, _want in _families(case):
        order, offsets, level = _levels(prog)
        assert sorted(order.tolist()) == list(range(prog.n_ops))
        assert offsets[0] == 0 and offsets[-1] == prog.n_ops
        assert (np.diff(offsets) > 0).all()  # no level is empty
        for lv in range(len(offsets) - 1):  # stable: each level in the lowered order
            ops = order[offsets[lv]:offsets[lv + 1]]
            assert (np.diff(ops) > 0).all()
        assert len(offsets) - 1 < prog.n_ops or prog.n_ops <= 1


@pytest.mark.parametrize("case", CASES)
def test_every_dependence_lies_in_an_earlier_level(case):
    """For every slot, in the lowered order: a read's level is above
    every earlier write's, a write's above every earlier read's and
    write's. So no two ops of a level touch a slot one of them writes."""
    for prog, _models, _want in _families(case):
        _order, _offsets, level = _levels(prog)
        last_write, last_read = {}, {}
        for i in range(prog.n_ops):
            reads, writes = _accesses(prog, i)
            for slot in reads:
                assert level[i] > last_write.get(slot, -1), (case, i, slot)
            for slot in writes:
                assert level[i] > max(last_write.get(slot, -1), last_read.get(slot, -1)), \
                    (case, i, slot)
            for slot in reads:
                last_read[slot] = max(last_read.get(slot, -1), level[i])
            for slot in writes:
                last_write[slot] = level[i]


@pytest.mark.parametrize("order_kind", ORDERS)
@pytest.mark.parametrize("case", CASES)
def test_level_order_replays_bit_for_bit(case, order_kind):
    """The plain version over the program in level order, each level's
    ops forward, reversed or shuffled: the lowered order's makespans and
    the scalar engine's."""
    for prog, models, want in _families(case):
        order, offsets, _level = _levels(prog)
        order = order.copy()
        rng = np.random.default_rng(int(order_kind[-1]) if order_kind.startswith("shuffle") else 0)
        for lv in range(len(offsets) - 1):
            part = order[offsets[lv]:offsets[lv + 1]]
            if order_kind == "reversed":
                part[:] = part[::-1].copy()
            elif order_kind.startswith("shuffle"):
                rng.shuffle(part)
        lowered = br.replay_solve_plain(br.pack_batch(prog, models, "cpu")).tolist()
        levelled = br.replay_solve_plain(
            br.pack_batch(br.permute_program(prog, order), models, "cpu")).tolist()
        assert lowered == want, (case, prog.n_ops)
        assert levelled == want, (case, order_kind, prog.n_ops)


@pytest.mark.parametrize("case", CASES)
def test_tables_and_scenario_pack_replay_as_the_lowered_order(case):
    """The family's tables (collectives first in each step, group rows
    and records as the kernel reads them) and the scenarios packed into
    one buffer: ``replay_levels`` on the CPU (the plain version over the
    table) gives the scalar engine's makespans."""
    for prog, models, want in _families(case):
        tables = br.replay_tables(prog, "cpu")
        assert br.replay_tables(prog, "cpu") is tables  # kept with the program
        order, offsets = br.level_schedule(prog)
        assert tables.n_levels == len(offsets) - 1 == tables.n_steps
        steps = tables.steps.numpy()
        rec = tables.ops.numpy().view(br.OP_RECORD)
        kind = rec["kr"] & 0xFF
        assert (kind == prog.kind[tables.order]).all()
        for s in range(tables.n_steps):
            lo, n_coll, row, _ = steps[s]
            hi = steps[s + 1, 0]
            assert sorted(tables.order[lo:hi].tolist()) == \
                sorted(order[offsets[s]:offsets[s + 1]].tolist())
            assert (kind[lo:lo + n_coll] == br.OP_COLL).all()
            assert (kind[lo + n_coll:hi] != br.OP_COLL).all()
            grouped = np.flatnonzero((kind[lo:hi] == br.OP_COLL)
                                     | (kind[lo:hi] == br.OP_ASYNC_FINISH))
            assert ((rec["kr"][lo + grouped] >> 8) == np.arange(len(grouped))).all()
            assert steps[s + 1, 2] - row == len(grouped)
        assert (steps[tables.n_steps:, 0] == prog.n_ops).all()  # the sentinels
        scen = br.pack_scenarios(tables, models)
        assert scen.app_bits.shape == (len(models), tables.app_stride)
        assert K.replay_levels(tables, scen).tolist() == want, (case, prog.n_ops)


def test_synthetic_family_matches_the_jax_scalar_engine():
    """The same streams and faults through the JAX package's scalar
    engine: the port's plain version over the level-ordered tables gives
    its makespans."""
    streams, plan = synthetic_family()
    prog = br.lower_family(streams, plan)
    tables = br.replay_tables(prog, "cpu")
    got = K.replay_levels(tables, br.pack_scenarios(tables, synthetic_models(tf, plan)))
    want = []
    for m in synthetic_models(jf, plan):
        eng = JaxSimuEngine(plan.n_classes, drop_events=True)
        for i in range(plan.n_classes):
            eng.add_rank(i, JaxReplayProc(streams[i]))
        eng._fault = m
        eng.run_incremental()
        want.append(max(eng.clock))
    assert got.tolist() == want


def test_a_level_wider_than_a_step_is_cut():
    """2100 independent compute ops (one a class), a collective over all
    of them, 2100 more: the first and last levels are cut at
    ``STEP_CAP`` ops, and the replay over the tables is the scalar
    engine's."""
    import types

    k = 2100
    peers = list(range(k))
    streams = [[("compute", 1.0 + c / 1024, "a", "c"), ("collective", "x:tp", 0.5, "ar", peers),
                ("compute", 0.25 * (c % 3), "b", "c")] for c in range(k)]
    plan = types.SimpleNamespace(n_classes=k, reps=tuple(range(k)))
    prog = br.lower_family(streams, plan)
    tables = br.replay_tables(prog, "cpu")
    assert (tables.n_levels, tables.n_steps) == (3, 5)
    assert tables.max_width == br.STEP_CAP and tables.threads == 1024
    assert tables.steps.numpy()[:5, 1].tolist() == [0, 0, 1, 0, 0]
    models = synthetic_models(tf, plan, n=2)
    want = []
    for m in models:
        eng = SimuEngine(k, drop_events=True)
        for i in range(k):
            eng.add_rank(i, ReplayProc(streams[i]))
        eng._fault = m
        eng.run_incremental()
        want.append(max(eng.clock))
    assert K.replay_levels(tables, br.pack_scenarios(tables, models)).tolist() == want

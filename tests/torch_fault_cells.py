"""Cells and scenarios of the port's fault-model tests, shared by
``tests/test_torch_faults.py`` (the port against the JAX package) and the
``cuda`` tests of ``tests/test_torch_cuda.py`` (the replay kernel against
its plain version), which import no jax. Each builder takes the package's
``PerfLLM`` and config getters, so one cell builds in either package.

The three cells are the chaos grid's (``tests/test_batched_replay.py``):
dense, MoE and MLA at their own widths and worlds; ``dense-pp2-sync``
adds blocking pipeline sends and an overlapped gradient reduce, whose
families lower to every op kind of the replay (``send_sync``, async
posts and chains, ``wait_comm``).
"""

import copy
import random
import types

CELLS = {
    "dense-pp2": dict(model="llama2-tiny", tp=2, pp=2, world=8, mbc=4),
    "moe-pp4": dict(model="mixtral-8x1b", ep=2, pp=4, world=8, layers=4, mbc=4),
    "mla-pp2": dict(model="deepseekv2-lite", ep=2, pp=2, world=8, layers=4,
                    dense_layers=0, mbc=4, system="tpu_v5p_256"),
}
SYNC_CELL = dict(model="llama2-tiny", tp=2, pp=2, world=8, mbc=4,
                 strategy=dict(pp_comm_async=False, overlap_grad_reduce=True))


def build_perf(perf_cls, get_model, get_strategy, model="llama2-tiny", tp=1, pp=2,
               ep=1, world=8, mbc=4, layers=None, dense_layers=None,
               system="tpu_v5e_256", strategy=None):
    """One estimate of a cell, as ``tests/test_batched_replay.py`` builds
    it: ``tp1_pp1_dp8_mbs1`` with the cell's world and sizes."""
    m = get_model(model)
    if layers is not None or dense_layers is not None:
        m = copy.deepcopy(m)
        if layers is not None:
            m.layer_num = layers
        if dense_layers is not None:
            m.dense_layers = dense_layers
    st = get_strategy("tp1_pp1_dp8_mbs1")
    st.world_size = world
    st.tp_size = tp
    st.pp_size = pp
    st.ep_size = ep
    st.micro_batch_num = mbc
    for k, v in (strategy or {}).items():
        setattr(st, k, v)
    st.__post_init__()
    perf = perf_cls().configure(st, m, system)
    perf.run_estimate()
    return perf


def sampled(sample_scenario, key, world, healthy_ms, n=3, horizon_steps=4):
    """``n`` seeded random scenarios of a cell (slowdowns, preemptions,
    scoped and unscoped link degradations, deaths)."""
    out = []
    for seed in range(n):
        rng = random.Random(sum(ord(c) for c in key) * 7919 + seed)
        out.append(sample_scenario(rng, world, healthy_ms * 6,
                                   horizon_steps=horizon_steps, seed=seed))
    return out


def mixed(FaultEvent, FaultScenario, healthy_ms, horizon_steps=4, death=True):
    """One scenario with every kind of fault: two overlapping slowdowns
    and a preemption on one rank, a scoped and an unscoped link
    degradation, and (with ``death``) a rank death late in the walk."""
    h = healthy_ms
    events = [
        FaultEvent("slowdown", h * 0.2, duration_ms=h * 1.5, rank=1, multiplier=2.5),
        FaultEvent("slowdown", h * 0.6, duration_ms=h * 0.8, rank=1, multiplier=1.7),
        FaultEvent("preemption", h * 1.1, duration_ms=h * 0.3, rank=1),
        FaultEvent("link_degradation", h * 0.1, duration_ms=h * 2.0, dim="*",
                   multiplier=3.0, ranks=[0, 2]),
        FaultEvent("link_degradation", h * 0.5, duration_ms=h * 1.2, dim="pp",
                   multiplier=1.5),
    ]
    if death:
        events.append(FaultEvent("rank_death", h * 2.6, rank=3))
    return FaultScenario(events, horizon_steps=horizon_steps)


def synthetic_family(repeat=1):
    """Three classes' hand-written request streams, one of every kind the
    replay lowers (the first class's compute and advance ops ``repeat``
    times over), and the plan they lower against."""
    peers = [0, 1, 2]
    streams = [
        [("compute", 1.0, "a", "c"), ("advance", 2.5)] * repeat + [
            ("collective", "x:tp", 0.5, "ar", peers),
            ("async_collective", "g:dp_cp", 0.75, "rs", [0, 1]),
            ("send", 1, "t0", 0.25, "s", "pp"), ("compute", 0.5, "b", "c"), ("wait_comm",),
            ("send_sync", 2, "t1", 0.3, "ss", "pp"), ("advance_rel", 0.125),
            ("trace", 0.0, "span", "c")],
        [("compute", 2.0, "a", "c"), ("collective", "x:tp", 0.5, "ar", peers),
         ("async_collective", "g:dp_cp", 0.75, "rs", [0, 1]), ("recv", 0, "t0", "r", "pp"),
         ("compute", 0.25, "b", "c"), ("wait_comm",)],
        [("compute", 0.5, "a", "c"), ("collective", "x:tp", 0.5, "ar", peers),
         ("recv", 0, "t1", "r", "pp"), ("compute", 1.5, "b", "c")],
    ]
    return streams, types.SimpleNamespace(n_classes=3, reps=(0, 1, 2))


def synthetic_models(faults, plan, n=5):
    """A healthy model and ``n`` fault models (of the package module
    ``faults``) for :func:`synthetic_family`: overlapping slowdowns, a
    preemption, scoped and unscoped link windows of three dims."""
    ev, sc = faults.FaultEvent, faults.FaultScenario
    return [faults.StepFaultModel(sc([]), rank_map=plan.reps)] + [
        faults.StepFaultModel(sc([
            ev("slowdown", 300.0 * j, duration_ms=900.0, rank=j % 3, multiplier=2.0 + j),
            ev("slowdown", 500.0, duration_ms=2000.0, rank=1, multiplier=1.25),
            ev("preemption", 1200.0 + 100 * j, duration_ms=400.0, rank=(j + 1) % 3),
            ev("link_degradation", 0.0, duration_ms=3000.0, dim="*", multiplier=1.5,
               ranks=[j % 3]),
            ev("link_degradation", 2000.0, duration_ms=900.0, dim="pp", multiplier=4.0),
            ev("link_degradation", 100.0, duration_ms=5000.0, dim="dp_cp", multiplier=3.0),
        ]), rank_map=plan.reps) for j in range(n)]

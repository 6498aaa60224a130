"""The port's fault model (``simulator/faults.py``) and batched scenario
replay (``simulator/batched_replay.py``) against the JAX package's, and
the replay's plain PyTorch version against the port's scalar engine.

Cells: three of the chaos grid (``tests/torch_fault_cells.py``: dense pp
2, MoE pp 4, MLA pp 2, each at its own widths and world). The JAX package
runs through ``ReplayContext(options=ReplayOptions(replay_backend=
"numpy"))``, its scalar engine; the port runs its scalar engine
(``"numpy"``) and its batched replay on the CPU (``"cuda"`` with
``device="cpu"``: the kernel's plain version).

Tolerance: equal as JSON (``json.dumps(..., sort_keys=True)``, byte for
byte). The copies do the same float64 arithmetic in the same order, and
the batched replay is bit for bit the scalar engine, so nothing may
differ. The plain ``solve_batch`` is held against the port's scalar
engine (``ReplayContext._replay``) with ``==`` on every member of every
lowered family the runs record.
"""

import collections
import json

import pytest

pytest.importorskip("torch")

from simumax_tpu import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.core.config import get_model_config as jax_model  # noqa: E402
from simumax_tpu.core.config import get_strategy_config as jax_strategy  # noqa: E402
from simumax_tpu.simulator import faults as jf  # noqa: E402
from simumax_tpu_torch import PerfLLM  # noqa: E402
from simumax_tpu_torch.core.config import get_model_config, get_strategy_config  # noqa: E402
from simumax_tpu_torch.observe.telemetry import get_registry  # noqa: E402
from simumax_tpu_torch.simulator import batched_replay as br  # noqa: E402
from simumax_tpu_torch.simulator import faults as tf  # noqa: E402

from torch_fault_cells import (  # noqa: E402
    CELLS,
    build_perf,
    mixed,
    sampled,
    synthetic_family,
    synthetic_models,
)

IDS = sorted(CELLS)
SIM = dict(world_ranks=True, granularity="chunk", track_memory=False)
PLAIN = dict(replay_backend="cuda", device="cpu")

_pairs = {}


def _pair(key):
    """(JAX estimate, port estimate, healthy step ms) of a cell."""
    if key not in _pairs:
        ref = build_perf(JaxPerfLLM, jax_model, jax_strategy, **CELLS[key])
        got = build_perf(PerfLLM, get_model_config, get_strategy_config, **CELLS[key])
        _pairs[key] = (ref, got, got.simulate(None, **SIM)["end_time_ms"])
    return _pairs[key]


def _bytes(x):
    return json.dumps(x, sort_keys=True, default=str)


def _jax_ctx(ref):
    return jf.ReplayContext(ref, options=jf.ReplayOptions(replay_backend="numpy"))


@pytest.mark.parametrize("key", IDS)
def test_predict_goodput_matches_jax(key):
    ref, got, h = _pair(key)
    for death in (False, True):
        want = ref.predict_goodput(mixed(jf.FaultEvent, jf.FaultScenario, h, death=death),
                                   spec=jf.CheckpointSpec(interval_steps=2),
                                   _ctx=_jax_ctx(ref)).to_dict()
        for opts in (dict(replay_backend="numpy"), PLAIN):
            rep = got.predict_goodput(mixed(tf.FaultEvent, tf.FaultScenario, h, death=death),
                                      spec=tf.CheckpointSpec(interval_steps=2),
                                      options=tf.ReplayOptions(**opts)).to_dict()
            assert _bytes(rep) == _bytes(want), (key, death, opts)
    assert want["n_restarts"] == 1 and 0 < want["goodput"] < 1


@pytest.mark.parametrize("key", IDS)
def test_analyze_faults_matches_jax(key):
    ref, got, _h = _pair(key)
    kw = dict(n_scenarios=5, seed=3, horizon_steps=6)
    want = ref.analyze_faults(spec=jf.CheckpointSpec(interval_steps=3), _ctx=_jax_ctx(ref), **kw)
    for opts in (dict(replay_backend="numpy"), PLAIN):
        res = got.analyze_faults(spec=tf.CheckpointSpec(interval_steps=3),
                                 options=tf.ReplayOptions(**opts), **kw)
        assert _bytes(res) == _bytes(want), (key, opts)
    assert want["schema"] == "simumax-fault-analysis-v1" and len(want["reports"]) == 5


@pytest.mark.parametrize("key", IDS)
def test_simulate_with_faults_matches_jax(key):
    ref, got, h = _pair(key)
    r = ref.simulate(None, faults=mixed(jf.FaultEvent, jf.FaultScenario, h * 0.3), **SIM)
    g = got.simulate(None, faults=mixed(tf.FaultEvent, tf.FaultScenario, h * 0.3), **SIM)
    assert _bytes(g) == _bytes(r)
    assert g["faults"]["completed"] is False and g["faults"]["deaths"]


def _recording_groups(monkeypatch):
    """Record every family group the replay context solves, as (family,
    program, [(sub-scenario, fault model)], raw makespans)."""
    groups = []
    orig_groups = tf.ReplayContext._solve_groups
    orig_solve = br.solve_batch

    def solve_groups(self, grp, outs):
        for fam, prog, members in grp.values():
            groups.append([fam, prog, [(it[1], m) for it, m in members], None])
        return orig_groups(self, grp, outs)

    def solve_batch(prog, models, device="cuda"):
        raws = orig_solve(prog, models, device=device)
        group = next(g for g in groups if g[3] is None)
        assert group[1] is prog and [m for _s, m in group[2]] == list(models)
        group[3] = raws
        return raws

    monkeypatch.setattr(tf.ReplayContext, "_solve_groups", solve_groups)
    monkeypatch.setattr(br, "solve_batch", solve_batch)
    return groups


@pytest.mark.parametrize("key", IDS)
def test_plain_solve_batch_equals_the_scalar_engine_and_counts_fallbacks(key, monkeypatch):
    """Every member of every lowered family the batched run records: the
    plain ``solve_batch`` makespan == the scalar engine's raw end, and
    the scenarios that cannot lower are counted by reason, in the stats
    and in ``replay_batch_fallbacks_total``."""
    _ref, got, h = _pair(key)
    groups = _recording_groups(monkeypatch)
    reg = get_registry()
    before = {r: reg.counter("replay_batch_fallbacks_total", reason=r).value
              for r in br.FALLBACK_REASONS}
    ctx = tf.ReplayContext(got, options=tf.ReplayOptions(**PLAIN))
    scs = sampled(tf.sample_scenario, key, got.strategy.world_size, h, n=4) + [
        mixed(tf.FaultEvent, tf.FaultScenario, h, death=False)] + [
        tf.FaultScenario([  # distinct slowdowns, each with a death in its second step
            tf.FaultEvent("slowdown", h * 0.1 * (i + 1), duration_ms=h * 4.0, rank=1,
                          multiplier=2.0 + i),
            tf.FaultEvent("rank_death", h * (1.5 + 0.3 * i), rank=3)], horizon_steps=4)
        for i in range(3)]
    tf._predict_goodput_batch(ctx, [(s, tf.CheckpointSpec(interval_steps=2)) for s in scs])
    assert groups and all(raws is not None for *_x, raws in groups)
    for fam, prog, members, raws in groups:
        assert prog.n_ops > 0 and len(raws) == len(members)
        for (sub, _m), raw in zip(members, raws):
            assert raw == ctx._replay(sub, fam)[2], (key, prog.n_ops)
    fallbacks = {k[len("fallback_"):]: v for k, v in ctx.stats.items()
                 if k.startswith("fallback_")}
    assert set(fallbacks) <= set(br.FALLBACK_REASONS) and "jax_unavailable" not in \
        br.FALLBACK_REASONS
    assert fallbacks.get("no_streams") == 1  # the family's first run records its streams
    assert fallbacks.get("deaths", 0) >= 3  # steps with a death stay on the scalar engine
    for reason in br.FALLBACK_REASONS:
        delta = reg.counter("replay_batch_fallbacks_total", reason=reason).value - before[reason]
        assert delta == fallbacks.get(reason, 0), reason
    assert ctx.stats["batched"] == sum(len(m) for _f, _p, m, _r in groups)


def test_small_batches_stay_on_the_scalar_engine_under_auto():
    ref, got, _h = _pair("dense-pp2")
    kw = dict(n_scenarios=4, seed=5, horizon_steps=6)
    want = ref.analyze_faults(spec=jf.CheckpointSpec(interval_steps=3), _ctx=_jax_ctx(ref), **kw)
    ctx = tf.ReplayContext(got, options=tf.ReplayOptions(
        replay_backend="auto", device="cpu", jit_batch_min=1000))
    res = got.analyze_faults(spec=tf.CheckpointSpec(interval_steps=3), _ctx=ctx, **kw)
    assert _bytes(res) == _bytes(want)
    assert ctx.stats["fallback_small_batch"] > 0 and ctx.stats["batched"] == 0


def test_every_op_kind_replays_bit_for_bit_as_the_scalar_engine():
    """A family with every lowered op kind, under fault models with
    overlapping slowdowns, a preemption, scoped and unscoped link
    windows: the plain version == ``SimuEngine`` makespan, one batch."""
    from simumax_tpu_torch.simulator.engine import ReplayProc, SimuEngine

    streams, plan = synthetic_family()
    prog = br.lower_family(streams, plan)
    assert set(collections.Counter(prog.kind.tolist())) == set(range(1, 11))
    models = synthetic_models(tf, plan)
    raws = br.solve_batch(prog, models, device="cpu")
    for m, raw in zip(models, raws):
        eng = SimuEngine(plan.n_classes, drop_events=True)
        for i in range(plan.n_classes):
            eng.add_rank(i, ReplayProc(streams[i]))
        eng._fault = m
        eng.run_incremental()
        assert raw == max(eng.clock)
    assert len(set(raws.tolist())) > 3  # the faults moved the makespan


def test_replay_tables_pack_the_lowered_program():
    streams, plan = synthetic_family()
    prog = br.lower_family(streams, plan)
    model = tf.StepFaultModel(tf.FaultScenario([tf.FaultEvent(
        "link_degradation", 0.0, duration_ms=10.0, dim="pp", multiplier=2.0)]),
        rank_map=plan.reps)
    rb = br.pack_batch(prog, [model, model], device="cpu")
    assert rb.batch == 2 and rb.n_ops == prog.n_ops and rb.mask.shape == (prog.n_ops, 1)
    assert rb.win_s.shape == (2, 3, 0) and rb.link_s.shape == (2, 1)
    assert rb.refs.max().item() == prog.n_ops  # padded refs point at the -inf slot
    pp_ops = (prog.op_dim_id == prog.dim_ids["pp"]).nonzero()[0].tolist()
    assert (rb.app_bits[0] != 0).nonzero().flatten().tolist() == pp_ops


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_the_kernel_backends_raise_without_a_card(backend, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    _ref, got, _h = _pair("dense-pp2")
    with pytest.raises(RuntimeError, match='device="cpu".*replay_backend="numpy"'):
        tf.ReplayContext(got, options=tf.ReplayOptions(replay_backend=backend))
    with pytest.raises(RuntimeError, match="no card"):
        got.analyze_faults(n_scenarios=2, options=tf.ReplayOptions(replay_backend=backend))
    tf.ReplayContext(got, options=tf.ReplayOptions(replay_backend=backend, device="cpu"))
    tf.ReplayContext(got, options=tf.ReplayOptions(replay_backend="numpy"))


def test_a_batch_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    from simumax_tpu_torch.torchref import kernels as K

    monkeypatch.setattr(K, "_lib", lambda name: pytest.fail(f"loaded {name}"))
    streams, plan = synthetic_family()
    prog = br.lower_family(streams, plan)
    model = tf.StepFaultModel(tf.FaultScenario([]), rank_map=plan.reps)
    K.reset_launch_counts()
    br.solve_batch(prog, [model], device="cpu")
    assert K.launch_counts()["replay_solve"] == 0


def test_parallel_analysis_equals_the_serial_one():
    _ref, got, _h = _pair("dense-pp2")
    kw = dict(n_scenarios=4, seed=2, horizon_steps=6, spec=tf.CheckpointSpec(interval_steps=3),
              options=tf.ReplayOptions(replay_backend="numpy"))
    assert _bytes(got.analyze_faults(jobs=2, **kw)) == _bytes(got.analyze_faults(**kw))


def test_the_pool_spawns_once_cuda_is_initialised(monkeypatch):
    import torch

    monkeypatch.delenv("SIMUMAX_MP_START", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert tf._mc_context().get_start_method() == "spawn"

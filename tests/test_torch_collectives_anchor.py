"""The port's collective record against the port's analytical model.

Counterparts of ``tests/test_hlo_crosscheck.py`` and
``tests/test_place_group_anchor.py``: where those read the collectives
XLA compiles into the JAX steps' HLO, these read the port's
``calibration.validate`` record of the collectives the port's steps run
(DTensor's functional collectives and ``torchref/collectives.py``'s
direct calls) on 8 gloo ranks, spawned once for the file, and hold them
against the port's ``PerfLLM`` on the equivalent config.

Conventions. A record entry counts the bytes of this rank's result, as
HLO does, in the dtype the step moves (XLA's CPU backend upcasts bf16 to
f32, the record does not). The analytical calls declare the whole
logical tensor of a collective: for an all-gather and an all-reduce
that is the per-rank result, for a reduce-scatter and an all-to-all the
per-rank result times the group size.

* FSDP (dp 8, fp32): the port gathers each weight once a step and keeps
  the gathered weight for the backward, 4 bytes a parameter; the model
  declares a bf16 gather in the forward and another in the backward,
  also 4 bytes a parameter. The gradients' reduce-scatter (logical
  volume) and the replicated leaves' all-reduces against the model's
  reduce-scatter of fp32 gradients. Both within 0.3 of 1, as the JAX
  test's bound.
* tp 2 + SP (fp32, dp 4): the model charges the Megatron-minimal
  activation collectives; the port gathers the fused qkv and up columns,
  the vocab-sharded logits and the dp gradients too, so the ratio of
  everything recorded to the model's tp volume lies in [1, 12), as in
  the JAX test.
* Ulysses: one all-to-all of a seq-sharded bf16 [1, 2048, 16, 64] tensor
  to head-sharded over cp 8, its logical volume exactly ``cp_q``'s
  declared bytes (no f32 factor).
* pp 2 x tp 2 (the manual step, bf16): 2 pp hops a step, forward and
  backward, each of ``boundary_bytes``.
* Placement: the replica groups of each collective over a (dp 4, tp 2)
  mesh have the (size, stride) signatures of JAX's HLO test, and those
  signatures give ``place_group`` the span decompositions of the JAX
  test.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch.calibration.validate import (  # noqa: E402
    CollectiveRecord,
    collective_bytes,
    group_structure,
    replica_groups,
)
from simumax_tpu_torch.core.config import (  # noqa: E402
    IciConfig,
    ModelConfig,
    StrategyConfig,
    get_system_config,
)
from simumax_tpu_torch.perf import PerfLLM  # noqa: E402
from simumax_tpu_torch.torchref import collectives as C  # noqa: E402
from simumax_tpu_torch.torchref import context_parallel as CP  # noqa: E402
from simumax_tpu_torch.torchref import model as T  # noqa: E402
from simumax_tpu_torch.torchref import parallel as P  # noqa: E402

LLAMA = dict(vocab_size=2048, hidden_size=512, head_num=8, kv_head_num=8, head_size=64,
             intermediate_size=1376, layer_num=4)
ULYSSES = dict(cp=8, b=1, s=2048, H=16, d=64)
PIPE = dict(pp=2, tp=2)
#: the (dp 4, tp 2) placement probes: name -> (family, structure)
PLACEMENTS = {
    "allreduce_inner": ("all-reduce", {"size": 2, "stride": 1, "contiguous": True}),
    "allreduce_multi_axis": ("all-reduce", {"size": 8, "stride": 1, "contiguous": True}),
    "allreduce_strided_outer": ("all-reduce", {"size": 4, "stride": 2, "contiguous": False}),
    "allgather_inner": ("all-gather", {"size": 2, "stride": 1, "contiguous": True}),
    "allgather_strided": ("all-gather", {"size": 4, "stride": 2, "contiguous": False}),
    "reduce_scatter_strided": ("reduce-scatter", {"size": 4, "stride": 2, "contiguous": False}),
    "all_to_all_strided": ("all-to-all", {"size": 4, "stride": 2, "contiguous": False}),
}


def _llama_step(tp, fsdp, sp):
    """The record of one dp x tp training step (fp32) of the probe Llama."""
    cfg = T.LlamaConfig(dtype=torch.float32, **LLAMA)
    mesh = T.make_mesh(8, tp=tp, device="cpu")
    whole = T.init_params(cfg, seed=0, device="cpu")
    params = T.place_params(whole, mesh, T.param_shardings(cfg, mesh, fsdp=fsdp))
    init_opt, step = T.make_train_step(cfg, mesh=mesh, sp=sp)
    opt = init_opt(params)
    ids = np.zeros((8, 256), np.int64)
    batch = T.shard_batch((ids, ids), mesh)
    with CollectiveRecord(mesh) as record:
        step(params, opt, batch)
    return record


def _ulysses_reshard():
    mesh = CP.make_cp_mesh(8, ULYSSES["cp"], device="cpu")
    u = ULYSSES
    x = torch.zeros((u["b"], u["s"] // u["cp"], u["H"], u["d"]), dtype=torch.bfloat16)
    with CollectiveRecord(mesh) as record:
        CP._scatter_heads(x, mesh, "cp")
    return record


def _pipeline_step():
    cfg = P.PPConfig(moe_every=0)  # dense stages, bf16
    mesh = P.make_pp_mesh(8, pp=PIPE["pp"], tp=PIPE["tp"], device="cpu")
    params, specs = P.init_pp_params(cfg, mesh, torch.Generator().manual_seed(0))
    step = P.make_pp_train_step(cfg, mesh)(specs)
    dp = 8 // (PIPE["pp"] * PIPE["tp"])
    ids = np.zeros((2 * dp, 64), np.int64)
    with CollectiveRecord(mesh) as record:
        step(params, ids, ids)
    return record


def _placement_probes():
    """One collective of each placement over a (dp 4, tp 2) mesh."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    mesh = T.make_mesh(8, tp=2, device="cpu")
    x = torch.zeros((8, 64))
    probes = {
        "allreduce_inner": lambda: C.psum(x, mesh, "tp"),
        # one all-reduce over the whole mesh, as a functional collective
        "allreduce_multi_axis": lambda: funcol.all_reduce(x, "sum", dist.group.WORLD).wait(),
        "allreduce_strided_outer": lambda: C.psum(x, mesh, "dp"),
        "allgather_inner": lambda: C.all_gather(x, mesh, "tp", 0),
        "allgather_strided": lambda: C.all_gather(x, mesh, "dp", 0),
        "reduce_scatter_strided": lambda: C.psum_scatter(x, mesh, "dp", 0),
        "all_to_all_strided": lambda: C.all_to_all(x, mesh, "dp"),
        "ppermute_inner_ring": lambda: C.ppermute(x, mesh, "tp", [(0, 1), (1, 0)]),
    }
    out = {}
    for name, probe in probes.items():
        with CollectiveRecord(mesh) as record:
            probe()
        out[name] = replica_groups(record)
    return out


def _records_on_rank():
    import torch.distributed as dist

    out = {"fsdp": collective_bytes(_llama_step(tp=1, fsdp=True, sp=False)),
           "tp_sp": collective_bytes(_llama_step(tp=2, fsdp=False, sp=True)),
           "ulysses": _ulysses_reshard().entries,
           "pipeline": _pipeline_step().entries,
           "placements": _placement_probes()}
    return out if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def records():
    return P.spawn(8, "cpu", _records_on_rank)[0]


def _analytical(tp, zero, sp):
    mc = ModelConfig(model_name="probe", make_vocab_size_divisible_by=1, **LLAMA)
    st = StrategyConfig(world_size=8, tp_size=tp, pp_size=1, seq_len=256,
                        micro_batch_size=8 * tp // 8, micro_batch_num=1, zero_state=zero,
                        enable_sequence_parallel=sp, optimizer_style="functional")
    perf = PerfLLM().configure(st, mc, "tpu_v5e_256")
    perf.run_estimate()
    return perf.chunks[(0, 0)].collective_calls


def test_fsdp_volumes_match_the_model(records):
    got = records["fsdp"]
    calls = _analytical(tp=1, zero=3, sp=False)
    pred_ag = sum(c.size_bytes for c in calls if c.op == "all_gather" and c.dim == "dp_cp")
    pred_red = sum(c.size_bytes for c in calls if c.op == "reduce_scatter" and c.dim == "dp_cp")
    assert pred_ag > 0 and pred_red > 0
    assert set(got) <= {"all-gather", "reduce-scatter", "all-reduce"}, got
    reduced = got.get("all-reduce", 0) + got.get("reduce-scatter", 0) * 8  # logical volume
    assert got["all-gather"] / pred_ag == pytest.approx(1.0, abs=0.3), got
    assert reduced / pred_red == pytest.approx(1.0, abs=0.3), got


def test_tp_volumes_lower_bound_the_record(records):
    calls = _analytical(tp=2, zero=1, sp=True)
    pred_tp = sum(c.size_bytes for c in calls if c.dim == "tp")
    ratio = sum(records["tp_sp"].values()) / pred_tp
    assert 1.0 <= ratio < 12.0, (ratio, records["tp_sp"])


def test_ulysses_a2a_volume_is_cp_q_declared_bytes(records):
    u = ULYSSES
    mc = ModelConfig(model_name="probe", hidden_size=u["H"] * u["d"], head_num=u["H"],
                     kv_head_num=u["H"], head_size=u["d"], intermediate_size=2 * u["H"] * u["d"],
                     layer_num=1, vocab_size=2048, make_vocab_size_divisible_by=1)
    st = StrategyConfig(world_size=u["cp"], tp_size=1, cp_size=u["cp"], pp_size=1,
                        seq_len=u["s"], micro_batch_size=u["b"], micro_batch_num=1,
                        cp_comm_type="a2a", optimizer_style="functional")
    perf = PerfLLM().configure(st, mc, "tpu_v5e_256")
    perf.run_estimate()
    attn = perf.chunks[(0, 0)].blocks[0].attention
    pred_q = [c.size_bytes for c in attn.cp_q.collective_calls if c.phase == "fwd"]
    assert pred_q, "cp_q declared no fwd a2a"
    entries = records["ulysses"]
    assert [e["op"] for e in entries] == ["all-to-all"] and entries[0]["axis"] == "cp"
    # the record's per-rank result in bf16; the model's whole logical tensor
    assert pred_q[0] == entries[0]["bytes"] * u["cp"]


def test_pp_hops_match_boundary_bytes(records):
    hops = [e for e in records["pipeline"] if e["op"] == "collective-permute"]
    assert len(hops) == 2 * PIPE["pp"], [e["op"] for e in records["pipeline"]]
    assert {e["axis"] for e in hops} == {"pp"}
    assert len({e["bytes"] for e in hops}) == 1
    cfg = P.PPConfig(moe_every=0)
    dp = 8 // (PIPE["pp"] * PIPE["tp"])
    mc = ModelConfig(model_name="probe_pp", hidden_size=cfg.hidden_size, head_num=cfg.head_num,
                     kv_head_num=cfg.head_num, head_size=cfg.head_size,
                     intermediate_size=cfg.intermediate_size,
                     layer_num=PIPE["pp"] * cfg.layers_per_stage, vocab_size=2048,
                     make_vocab_size_divisible_by=1)
    st = StrategyConfig(world_size=8, tp_size=PIPE["tp"], pp_size=PIPE["pp"], seq_len=64,
                        micro_batch_size=2 * dp // dp, micro_batch_num=1,
                        enable_sequence_parallel=True, optimizer_style="functional")
    perf = PerfLLM().configure(st, mc, "tpu_v5e_256")
    perf.run_estimate()
    assert perf.chunks[(0, 0)].boundary_bytes() == pytest.approx(hops[0]["bytes"], rel=0.01)


@pytest.mark.parametrize("probe", list(PLACEMENTS))
def test_replica_group_structure(records, probe):
    family, structure = PLACEMENTS[probe]
    groups = records["placements"][probe]
    assert list(groups) == [family], groups
    assert group_structure(groups[family][0]) == structure


def test_ppermute_inner_ring_stays_in_its_tp_groups(records):
    groups = records["placements"]["ppermute_inner_ring"]
    pairs = groups["collective-permute"][0]
    assert all(a // 2 == b // 2 for a, b in pairs), pairs
    assert sorted(a for a, _ in pairs) == list(range(8))


def _path(axes, inner, size):
    sysc = get_system_config("tpu_v5e_256")
    sysc.ici = IciConfig(axes=list(axes), wraparound=[a >= 4 for a in axes],
                         link_gbps=sysc.ici.link_gbps, latency_us=sysc.ici.latency_us)
    return sysc, sysc.place_group("probe", inner, size)


def test_recorded_signatures_place_as_the_jax_test(records):
    """The (stride, size) signatures read off the record, fed to
    ``place_group`` on the JAX test's torus configs, give its span
    decompositions: one full-bandwidth span, a chain of two, a
    time-shared strided span."""
    def signature(probe):
        family = PLACEMENTS[probe][0]
        s = group_structure(records["placements"][probe][family][0])
        return s["stride"], s["size"]

    sysc, p = _path((8,), *signature("allreduce_inner"))
    assert len(p.spans) == 1 and p.spans[0].extent == 2 and not p.spans[0].wrap
    assert p.spans[0].gbps == pytest.approx(sysc.ici.link_gbps)
    _, p = _path((4, 2), *signature("allreduce_multi_axis"))
    assert [s.extent for s in p.spans] == [4, 2]
    sysc, p = _path((8,), *signature("allreduce_strided_outer"))
    assert len(p.spans) == 1 and p.spans[0].extent == 4 and p.spans[0].wrap
    assert p.spans[0].gbps == pytest.approx(sysc.ici.link_gbps * 2 * 0.5)
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all2all", "p2p"):
        t = sysc.compute_net_op_time(op, 2**20, p)
        assert math.isfinite(t) and t > 0

"""The port's network model (``core/config.py``): the JAX package's ICI
torus and DCN model on its TPU system configs, and the H100's NVSwitch
node with InfiniBand between nodes on ``h100_sxm_8x`` and
``h100_sxm_256``, with what reads it (the estimate, the searcher's
cache key, the fault analysis, the guided sweep).

* On each of the JAX package's four TPU system configs, every placement
  (each dim, inner stride {1, 2, 4, 8, 16, 32}, every group size that
  fits), its collective terms and its linear coefficients for the five
  ops equal the JAX package's exactly (``==`` on floats).
* On the H100 configs: placements pinned by hand; each strategy under
  ``configs/strategy/`` that fits ``h100_sxm_256``, and the JAX
  builder's six multi-card members, held against the port's
  ``parallel/mesh.py`` (a group's members a node equal its ``nvlink``
  extent, the nodes it spans its ``ib`` extent); the all-to-all and
  the linear coefficients on a switch against their closed forms (rel
  1e-12); the six members' peak memory and FLOPs against the JAX
  package's on ``tpu_v5p_256`` (rel 1e-12: neither depends on the
  network).
* On ``h100_sxm_256`` on the CPU: ``analyze_faults`` through the replay
  kernel's plain version equals the scalar engine as JSON, and the
  guided Mixtral-8x7B sweep with ``device="cpu"`` equals the numpy fold
  as JSON.
"""

import copy
import dataclasses
import json
import warnings

import pytest

pytest.importorskip("torch")

from simumax_tpu import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.core import config as jc  # noqa: E402
from simumax_tpu_torch import PerfLLM  # noqa: E402
from simumax_tpu_torch.core import config as tc  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError  # noqa: E402
from simumax_tpu_torch.parallel import mesh  # noqa: E402
from simumax_tpu_torch.search import batched as tb  # noqa: E402
from simumax_tpu_torch.search import executor as te  # noqa: E402
from simumax_tpu_torch.search import search_best_parallel_strategy  # noqa: E402
from simumax_tpu_torch.search.searcher import _model_system_key, _network_key  # noqa: E402
from simumax_tpu_torch.simulator import faults as tf  # noqa: E402
from simumax_tpu_torch.tools import build_system_config as BSC  # noqa: E402

from torch_fault_cells import build_perf  # noqa: E402

with warnings.catch_warnings():  # the JAX tool sets a global filter on import
    from tools import build_tpu_system_config as jax_builder  # noqa: E402

TPU_SYSTEMS = ["tpu_v5e_256", "tpu_v5e_calibrated", "tpu_v5p_256", "tpu_v6e_256"]
DIMS = ("tp", "cp", "dp", "pp", "dp_cp", "etp", "ep", "edp")
INNERS = (1, 2, 4, 8, 16, 32)
SIZE = 3.0 * 2**20  # bytes of the costed collectives
GPUS_PER_NODE = 8


def _system(module, name):
    with warnings.catch_warnings():  # stale-provenance warnings of the calibrated config
        warnings.simplefilter("ignore")
        return module.get_system_config(name)


def _placed(system, dim, inner, size):
    with warnings.catch_warnings():  # misaligned strides warn, in both packages alike
        warnings.simplefilter("ignore")
        return system.place_group(dim, inner, size)


@pytest.mark.parametrize("name", TPU_SYSTEMS)
def test_torus_placements_and_costs_equal_the_jax_packages(name):
    ref, got = _system(jc, name), _system(tc, name)
    assert got.ici is not None and got.nvlink is None
    assert got.chips_per_slice == ref.chips_per_slice
    cases = 0
    for inner in INNERS:
        for size in range(1, ref.total_chips // inner + 1):
            for dim in DIMS:
                want, path = _placed(ref, dim, inner, size), _placed(got, dim, inner, size)
                assert path.describe() == want.describe(), (dim, inner, size)
                assert [dataclasses.astuple(s) for s in path.spans] == \
                    [dataclasses.astuple(s) for s in want.spans], (dim, inner, size)
                assert path.on_dcn == want.on_dcn
            for op in tc.NET_OPS:
                assert got.compute_net_op_terms(op, SIZE, path) == \
                    ref.compute_net_op_terms(op, SIZE, want), (op, inner, size)
                assert got.net_op_coeffs(op, path) == ref.net_op_coeffs(op, want)
                cases += 1
    assert cases > 1000


#: (system, dim, inner stride, group size, the placement)
H100_PLACEMENTS = [
    ("h100_sxm_8x", "tp", 1, 8, "tp(8): nvlink[8@450GB/s]"),
    ("h100_sxm_8x", "dp", 4, 2, "dp(2): nvlink[2@450GB/s]"),  # strided: still the full link
    ("h100_sxm_8x", "ep", 1, 8, "ep(8): nvlink[8@450GB/s]"),  # ep 8 after etp 1
    ("h100_sxm_8x", "pp", 2, 4, "pp(4): nvlink[4@450GB/s]"),
    ("h100_sxm_256", "dp", 8, 16, "dp(16): ib[16@50GB/s]"),
    ("h100_sxm_256", "dp", 4, 16, "dp(16): nvlink[2@450GB/s] × ib[8@50GB/s]"),
    ("h100_sxm_256", "pp", 64, 4, "pp(4): ib[4@50GB/s]"),
    ("h100_sxm_256", "edp", 1, 256, "edp(256): nvlink[8@450GB/s] × ib[32@50GB/s]"),
    ("h100_sxm_256", "ep", 2, 8, "ep(8): nvlink[4@450GB/s] × ib[2@50GB/s]"),
    ("h100_sxm_256", "tp", 1, 1, "tp(1)"),
]


@pytest.mark.parametrize("name,dim,inner,size,want", H100_PLACEMENTS)
def test_h100_placements(name, dim, inner, size, want):
    system = tc.get_system_config(name)
    path = system.place_group(dim, inner, size)
    assert path.describe() == want
    assert all(not s.wrap for s in path.spans)
    assert path.on_dcn is ("ib" in want)
    for span in path.spans:
        net = system.net_config(span.kind)
        assert span.latency_us == net.latency_us
        assert span.gbps == (net.link_gbps if span.kind == "nvlink" else net.gbps_per_gpu)


def test_a_stride_that_does_not_tile_the_node_warns_and_goes_on():
    system = tc.get_system_config("h100_sxm_256")
    with pytest.warns(UserWarning, match="does not tile NVLink node of size 8"):
        path = system.place_group("dp", 12, 4)
    assert path.describe() == "dp(4): ib[4@50GB/s]"
    assert system.place_group("dp", 3, 4).describe() == "dp(4): nvlink[2@450GB/s] × ib[2@50GB/s]"


def test_h100_systems_and_their_validation():
    node, nodes = tc.get_system_config("h100_sxm_8x"), tc.get_system_config("h100_sxm_256")
    card = tc.get_system_config("h100_sxm")
    assert (node.total_chips, node.chips_per_slice) == (8, 8)
    assert (nodes.total_chips, nodes.num_slices) == (256, 32)
    assert node.accelerator == card.accelerator == nodes.accelerator
    assert node.ici is None and node.dcn is None
    assert (node.nvlink.link_gbps, node.nvlink.gpus_per_node, node.ib.gbps_per_gpu) == (450, 8, 50)
    data = nodes.to_dict()
    again = tc.SystemConfig.init_from_dict(json.loads(json.dumps(data)))
    assert again.fingerprint() == nodes.fingerprint()
    assert again.place_group("dp", 4, 16).describe() == nodes.place_group("dp", 4, 16).describe()
    # the NVLink and IB rates are part of the hardware identity
    for section, key in (("nvlink", "link_gbps"), ("ib", "gbps_per_gpu")):
        other = copy.deepcopy(data)
        other[section][key] *= 2
        assert tc.SystemConfig.init_from_dict(other).fingerprint() != nodes.fingerprint()
    both = dict(data, ici={"axes": [8]}, dcn={})
    with pytest.raises(ConfigError, match="both an ICI torus and an NVSwitch domain"):
        tc.SystemConfig.init_from_dict(both)
    with pytest.raises(ConfigError, match="one card without a network"):
        tc.SystemConfig.init_from_dict(dict(data, ib=None)).place_group("dp", 1, 2)


def _mesh_cases():
    cases = []
    for name in sorted(tc.list_configs()["strategy"]):
        st = tc.get_strategy_config(name)
        if st.world_size <= 256:
            cases.append((name, name, None))
        if st.world_size < 64 and 64 % st.world_size == 0:
            cases.append((f"{name}@64", name, 64))
    return cases


MESH_CASES = _mesh_cases()
MEMBERS = {label: (st, model) for label, st, model in BSC.multi_card_perfs()}


def _dp_cp_groups(st):
    """Ranks that differ only in their cp and dp coordinates."""
    groups = {}
    for rank in range(st.world_size):
        c = mesh.rank_coords(rank, st)
        groups.setdefault((c["tp"], c["pp"]), []).append(rank)
    return list(groups.values())


def _hold_paths_against_the_mesh(st, paths):
    for dim, path in paths.items():
        groups = _dp_cp_groups(st) if dim == "dp_cp" else mesh.rank_groups(st, dim)
        extents = {"nvlink": 1, "ib": 1}
        for span in path.spans:
            extents[span.kind] *= span.extent
        assert set(extents) == {"nvlink", "ib"}, path.describe()
        for group in groups:
            nodes = {}
            for rank in group:
                nodes[rank // GPUS_PER_NODE] = nodes.get(rank // GPUS_PER_NODE, 0) + 1
            assert set(nodes.values()) == {extents["nvlink"]}, (dim, path.describe(), group)
            assert len(nodes) == extents["ib"], (dim, path.describe(), group)


@pytest.mark.parametrize("case,strategy,world", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_placements_agree_with_the_mesh_groups(case, strategy, world):
    st = tc.get_strategy_config(strategy)
    if world is not None:
        st.world_size = world
        st.__post_init__()
    from simumax_tpu_torch.perf import place_strategy_paths

    _hold_paths_against_the_mesh(st, place_strategy_paths(st, tc.get_system_config("h100_sxm_256")))


@pytest.mark.parametrize("label", list(MEMBERS))
def test_multi_card_members_run_and_match_the_jax_package_off_the_network(label):
    """Each member runs on its H100 system with its dims placed as the
    mesh groups them; its peak memory and FLOPs equal the JAX package's
    estimate of the same member on ``tpu_v5p_256``."""
    st, model = MEMBERS[label]
    index = list(MEMBERS).index(label)
    jst, jmodel = jax_builder.representative_perfs("tpu_v5p_256")[8 + index]
    assert (jst.world_size, jst.tp_size, jst.cp_size, jst.ep_size, jst.pp_size) == \
        (st.world_size, st.tp_size, st.cp_size, st.ep_size, st.pp_size)
    assert {"xla": "torch", "pallas": "cuda"}[jst.sdp_backend] == st.sdp_backend
    name = BSC.multi_card_system(st.world_size)
    got = PerfLLM().configure(st, model, name)
    got.run_estimate()
    ref = JaxPerfLLM().configure(jst, jmodel, "tpu_v5p_256")
    ref.run_estimate()

    def flops(perf):
        return sum(c.compute_info.total_flops
                   for s in range(perf.strategy.pp_size) for c in perf.stage_chunks(s))

    assert got.analysis_mem()["max_peak_gib"] == pytest.approx(
        ref.analysis_mem()["max_peak_gib"], rel=1e-12)
    assert flops(got) == pytest.approx(flops(ref), rel=1e-12)
    cost = got.analysis_cost()
    assert 0 < cost["mfu"] < 1 and cost["iter_time"] > 0
    assert got.system.total_chips == (8 if st.world_size <= 8 else 256)
    _hold_paths_against_the_mesh(got.strategy, got.ctx.paths)
    if label == "llama3-70b tp8 selective":
        assert got.ctx.paths["tp"].describe() == "tp(8): nvlink[8@450GB/s]"
        assert got.ctx.paths["dp"].describe() == "dp(8): ib[8@50GB/s]"


def test_all2all_on_a_switch_is_the_closed_form():
    system = tc.get_system_config("h100_sxm_256")
    path = system.place_group("ep", 2, 32)  # nvlink 4, then ib 8
    assert [(s.kind, s.extent) for s in path.spans] == [("nvlink", 4), ("ib", 8)]
    bw_t, lat_t = system.compute_net_op_terms("all2all", SIZE, path)
    local = SIZE / 32
    want_bw = want_lat = 0.0
    for span in path.spans:
        spec = system._op_spec(span, "all2all")
        rate = span.gbps * 1e9 * spec.efficient_factor
        want_bw += local * (span.extent - 1) / span.extent / rate
        want_lat += (span.latency_us + spec.latency_us) * 1e-6
    assert bw_t == pytest.approx(want_bw, rel=1e-12)
    assert lat_t == pytest.approx(want_lat, rel=1e-12)
    # p2p rides the full link: a switch span never wraps
    spec = system._op_spec(path.spans[0], "p2p")
    assert system.compute_net_op_terms("p2p", SIZE, path)[0] == pytest.approx(
        SIZE / (450e9 * spec.efficient_factor), rel=1e-12)


@pytest.mark.parametrize("op", tc.NET_OPS)
def test_coefficients_stay_linear_in_size_on_a_switch(op):
    system = tc.get_system_config("h100_sxm_256")
    for path in (system.place_group("tp", 1, 8), system.place_group("dp", 4, 64),
                 system.place_group("pp", 64, 4)):
        per_byte, lat = system.net_op_coeffs(op, path)
        for size in (1.0e3, 7.5e6, 2.0e9):
            bw_t, lat_t = system.compute_net_op_terms(op, size, path)
            assert bw_t == pytest.approx(per_byte * size, rel=1e-12)
            assert lat_t == lat


def test_searcher_keys_a_system_on_its_network():
    model = tc.get_model_config("llama3-8b")
    tpu, node, card = (tc.get_system_config(n) for n in ("tpu_v5p_256", "h100_sxm_256", "h100_sxm"))
    assert _network_key(tpu) == (8, 8, 4)
    assert _network_key(node) == ("nvlink", 8)
    assert _network_key(card) == ()
    from simumax_tpu.search.searcher import _model_system_key as jax_key

    assert _model_system_key(model, tpu) == jax_key(jc.get_model_config("llama3-8b"),
                                                    jc.get_system_config("tpu_v5p_256"))
    assert _model_system_key(model, node)[1] == ("h100_sxm_256", 80, ("nvlink", 8), 32)


def test_fault_analysis_on_h100_nodes_equals_the_scalar_engine():
    """A dense tp 2 pp 2 cell at world 16 on ``h100_sxm_256``: its pp hop
    crosses nodes on InfiniBand. The replay kernel's plain version gives
    the scalar engine's analysis."""
    perf = build_perf(PerfLLM, tc.get_model_config, tc.get_strategy_config,
                      model="llama2-tiny", tp=2, pp=2, world=16, mbc=4, system="h100_sxm_256")
    assert perf.ctx.paths["pp"].describe() == "pp(2): ib[2@50GB/s]"
    kw = dict(n_scenarios=4, seed=5, horizon_steps=6, spec=tf.CheckpointSpec(interval_steps=3))
    want = perf.analyze_faults(options=tf.ReplayOptions(replay_backend="numpy"), **kw)
    got = perf.analyze_faults(options=tf.ReplayOptions(replay_backend="cuda", device="cpu"), **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert len(want["reports"]) == 4


def test_guided_sweep_on_h100_nodes_equals_the_numpy_fold(monkeypatch):
    base = tc.get_strategy_config("ep4_pp2_dp4_mbs1")
    base.world_size = 64
    base.__post_init__()
    model, system = tc.get_model_config("mixtral-8x7b"), tc.get_system_config("h100_sxm_256")
    lists = dict(tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4, 8), ep_list=(1, 2, 4, 8),
                 zero_list=(0, 1, 2, 3))

    def sweep(mode="guided"):
        return search_best_parallel_strategy(copy.deepcopy(base), model, system, 64, topk=5,
                                             engine="batched", search_mode=mode, device="cpu",
                                             **lists)

    te._SCORERS.clear()
    guided = sweep()
    assert te._batched_scorer(model, system, "cpu").last_screen_jit  # the fold's dispatch ran
    grid = sweep("grid")
    monkeypatch.setattr(te, "_batched_scorer",
                        lambda m, s, device="cuda": tb.BatchedScorer(m, s, backend="numpy"))
    numpy_rows = sweep()
    assert json.dumps(guided, sort_keys=True) == json.dumps(numpy_rows, sort_keys=True)
    assert json.dumps(guided, sort_keys=True) == json.dumps(grid, sort_keys=True)
    assert len(guided) == 5 and all("nvlink" in row["net"]["tp"] or row["tp"] == 1
                                    for row in guided)

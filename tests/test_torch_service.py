"""The port's planning service (``service/planner.py`` over
``service/store.py``) held against the JAX package's.

Mirrors ``tests/test_service.py``: the content store's integrity, LRU
and atomicity contract, the cache-key invalidation rules, the planner's
cache-on == cache-off parity, single-flight, and the per-cell persistent
sweep layer, including the batched engine's block-kind profiles, which
round-trip through the port's store. Where the JAX test holds a cached
answer against a cache-off one of the same package, the oracle here is
the JAX package's cache-off planner. The Planner's five query kinds
(estimate, explain, faults, fleet, search) are each held against it.

The port's planner runs with ``device="cpu"``: the replay and fold
kernels' plain versions. The JAX package's faults run on its scalar
engine and its batched search on its numpy fold (its jax backends fail
in some sandboxes, ROADMAP queue C).

Tolerance: ``==`` on canonical JSON (``canonical_bytes``).
"""

import copy
import json
import os
import threading
import time

import pytest

pytest.importorskip("torch")

from simumax_tpu.perf import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.search import batched as jax_batched  # noqa: E402
from simumax_tpu.service.planner import Planner as JaxPlanner  # noqa: E402
from simumax_tpu.service.store import canonical_bytes as jax_canonical  # noqa: E402
from simumax_tpu.service.store import normalized as jax_normalized  # noqa: E402
from simumax_tpu.simulator.faults import ReplayOptions as JaxReplayOptions  # noqa: E402
from simumax_tpu_torch.core.config import (  # noqa: E402
    get_model_config,
    get_strategy_config,
    get_system_config,
)
from simumax_tpu_torch.service.planner import Planner as PortPlanner  # noqa: E402
from simumax_tpu_torch.service.planner import query_identity  # noqa: E402
from simumax_tpu_torch.service.store import (  # noqa: E402
    ContentStore,
    canonical_bytes,
    content_key,
)

MODEL, STRAT, SYS = "llama3-8b", "tp1_pp2_dp4_mbs1", "tpu_v5e_256"
SWEEP = dict(global_batch_size=32, world=32, pp_list=(1,), zero_list=(1,), topk=3)


def Planner(*args, **kw):
    """The port's planner on the CPU (the kernels' plain versions)."""
    kw.setdefault("device", "cpu")
    return PortPlanner(*args, **kw)


@pytest.fixture()
def store(tmp_path):
    return ContentStore(str(tmp_path / "store"))


@pytest.fixture()
def planner(tmp_path):
    return Planner(cache_dir=str(tmp_path / "planner-store"))


@pytest.fixture()
def jax_numpy_fold(monkeypatch):
    monkeypatch.setattr(jax_batched, "jax_available", lambda: False)


def assert_same(port, jax):
    assert canonical_bytes(port) == jax_canonical(jax)


# --------------------------------------------------------------------------
# ContentStore
# --------------------------------------------------------------------------


def test_store_roundtrip_json_and_pickle(store):
    import numpy as np

    key = content_key({"q": 1})
    store.put("estimate", key, {"a": [1, 2], "b": "x"})
    assert store.get("estimate", key) == {"a": [1, 2], "b": "x"}
    store.put("profiles", key, {"arr": np.arange(4.0), "k": (1, "x")}, fmt="pickle")
    back = store.get("profiles", key)
    assert list(back["arr"]) == [0.0, 1.0, 2.0, 3.0]
    assert back["k"] == (1, "x")
    assert store.get("estimate", key) == {"a": [1, 2], "b": "x"}


def test_store_miss_and_counters(store):
    assert store.get("estimate", "0" * 64) is None
    store.put("estimate", "1" * 64, {"v": 1})
    store.get("estimate", "1" * 64)
    c = store.stats()["counters"]
    assert c["misses"] == 1 and c["hits"] == 1 and c["puts"] == 1


def test_store_atomic_write_leaves_no_temp_files(store):
    for i in range(8):
        store.put("estimate", content_key(i), {"i": i})
    leftovers = [fn for _dir, _s, files in os.walk(store.root) for fn in files
                 if not fn.endswith(".entry")]
    assert leftovers == []


def test_store_corrupt_entry_dropped_not_served(store):
    key = content_key({"q": "corrupt"})
    path = store.put("estimate", key, {"v": 42})
    with open(path, "rb") as f:
        blob = f.read()
    cut = blob.find(b"\n") + 3
    with open(path, "wb") as f:
        f.write(blob[:cut] + bytes([blob[cut] ^ 0xFF]) + blob[cut + 1:])
    assert store.get("estimate", key) is None
    assert not os.path.exists(path)
    assert store.stats()["counters"]["corrupt_dropped"] == 1


def test_store_verify_reports_corrupt(store):
    k1, k2 = content_key(1), content_key(2)
    store.put("estimate", k1, {"v": 1})
    p2 = store.put("estimate", k2, {"v": 2})
    with open(p2, "ab") as f:
        f.write(b"garbage")
    rep = store.verify()
    assert rep["checked"] == 2 and rep["ok"] == 1
    assert [c["path"] for c in rep["corrupt"]] == [p2]
    store.verify(drop=True)
    rep = store.verify()
    assert rep["checked"] == 1 and not rep["corrupt"]


def test_store_lru_eviction_is_size_bounded(tmp_path):
    small = ContentStore(str(tmp_path / "small"), max_bytes=6000)
    payload = {"blob": "x" * 900}
    keys = [content_key(i) for i in range(10)]
    for i, k in enumerate(keys):
        small.put("estimate", k, payload)
        os.utime(small._path("estimate", k), (1000 + i, 1000 + i))
    small.put("estimate", content_key("last"), payload)
    stats = small.stats()
    assert stats["total_bytes"] <= 6000
    assert stats["counters"]["evictions"] > 0
    assert small.get("estimate", keys[0]) is None
    assert small.get("estimate", content_key("last")) is not None


def test_store_clear_by_namespace(store):
    store.put("estimate", content_key(1), {"v": 1})
    store.put("sweep", content_key(2), {"v": 2})
    assert store.clear("estimate") == 1
    assert store.get("sweep", content_key(2)) == {"v": 2}
    assert store.clear() == 1


# --------------------------------------------------------------------------
# Cache keys
# --------------------------------------------------------------------------


def _configs():
    return get_model_config(MODEL), get_strategy_config(STRAT), get_system_config(SYS)


def _key(model, strategy, system):
    return content_key(query_identity("estimate", model=model, strategy=strategy, system=system))


def test_key_ordering_and_path_independent(tmp_path):
    from simumax_tpu_torch.core.config import ModelConfig

    model, strategy, system = _configs()
    base = _key(model, strategy, system)
    d = model.to_dict()
    reordered = ModelConfig.init_from_dict(dict(reversed(list(d.items()))))
    assert _key(reordered, strategy, system) == base
    alt = tmp_path / "same-model-elsewhere.json"
    alt.write_text(json.dumps(d))
    assert _key(ModelConfig.init_from_config_file(str(alt)), strategy, system) == base


def test_key_invalidation_per_config_family(monkeypatch):
    import simumax_tpu_torch.version

    model, strategy, system = _configs()
    base = _key(model, strategy, system)
    m2 = copy.deepcopy(model)
    m2.layer_num += 1
    s2 = copy.deepcopy(strategy)
    s2.micro_batch_num *= 2
    y2 = copy.deepcopy(system)
    y2.accelerator.mem_gbs += 1
    y3 = copy.deepcopy(system)
    y3.accelerator.op["default"].accurate_efficient_factor["x"] = 0.5
    y4 = copy.deepcopy(system)
    y4.provenance = {"system_hash": "feedface", "created": "2026-01-01", "version": "0.0.9"}
    keys = [_key(m2, strategy, system), _key(model, s2, system), _key(model, strategy, y2),
            _key(model, strategy, y3), _key(model, strategy, y4)]
    monkeypatch.setattr(simumax_tpu_torch.version, "__version__", "99.0.0")
    keys.append(_key(model, strategy, system))
    assert len(keys) == 6 and base not in keys


def test_canonical_bytes_sorts_and_normalizes():
    assert canonical_bytes({"b": (1, 2), "a": {2, 1}}) \
        == canonical_bytes({"a": [1, 2], "b": [1, 2]}) \
        == jax_canonical({"a": [1, 2], "b": [1, 2]})


# --------------------------------------------------------------------------
# The planner's query kinds against the JAX package's
# --------------------------------------------------------------------------


def test_estimate_cache_on_off_bit_identical(planner):
    from simumax_tpu.service.server import response_bytes as jax_response_bytes

    cold = planner.estimate(MODEL, STRAT, SYS)
    warm = planner.estimate(MODEL, STRAT, SYS)
    direct = Planner(enabled=False).estimate(MODEL, STRAT, SYS)
    assert canonical_bytes(cold) == canonical_bytes(warm) == canonical_bytes(direct)
    assert_same(cold, JaxPlanner(enabled=False).estimate(MODEL, STRAT, SYS))
    assert planner.counters["evaluations"] == 1
    assert planner.counters["hits"] == 1
    raw, meta = planner.estimate(MODEL, STRAT, SYS, with_meta=True, raw=True)
    assert meta["cache"] == "hit"
    assert raw == jax_response_bytes(JaxPlanner(enabled=False).estimate(MODEL, STRAT, SYS))


def test_explain_cache_on_off_bit_identical(planner):
    cold = planner.explain(MODEL, STRAT, SYS)
    warm, meta = planner.explain(MODEL, STRAT, SYS, with_meta=True)
    assert meta["cache"] == "hit"
    assert canonical_bytes(cold) == canonical_bytes(warm)
    assert_same(warm, JaxPlanner(enabled=False).explain(MODEL, STRAT, SYS))
    from simumax_tpu_torch.observe.ledger import (
        top_op_lines_from_rows,
        waterfall_lines_from_dict,
    )

    assert any("MFU-loss waterfall" in ln for ln in waterfall_lines_from_dict(warm["ledger"]))
    assert top_op_lines_from_rows(warm["op_rows"], 5)


def test_estimate_inline_dict_hits_name_key(planner):
    model, strategy, system = _configs()
    a = planner.estimate(MODEL, STRAT, SYS)
    _, meta = planner.estimate(model.to_dict(), strategy.to_dict(), system.to_dict(),
                               with_meta=True)
    assert meta["cache"] == "hit"
    b = planner.estimate(model.to_dict(), strategy.to_dict(), system.to_dict())
    assert canonical_bytes(a) == canonical_bytes(b)


def test_version_bump_misses(planner, monkeypatch):
    import simumax_tpu_torch.version

    planner.estimate(MODEL, STRAT, SYS)
    monkeypatch.setattr(simumax_tpu_torch.version, "__version__", "99.0.0")
    _, meta = planner.estimate(MODEL, STRAT, SYS, with_meta=True)
    assert meta["cache"] == "miss"
    assert planner.counters["evaluations"] == 2


def test_singleflight_one_evaluation_for_n_threads(planner, monkeypatch):
    """N threads ask one cold question: the leader's evaluation is held
    until the other N - 1 have joined its flight, so exactly one
    evaluation runs and every other thread waits on it, however the
    threads are scheduled."""
    from simumax_tpu_torch import perf as port_perf

    n = 8
    real = port_perf.PerfLLM.run_estimate

    def held(self, *args, **kw):
        deadline = time.monotonic() + 60.0
        while planner.counters["singleflight_waits"] < n - 1:
            assert time.monotonic() < deadline, "the followers never joined the flight"
            time.sleep(0.001)
        return real(self, *args, **kw)

    monkeypatch.setattr(port_perf.PerfLLM, "run_estimate", held)
    results = [None] * n

    def worker(i):
        results[i] = planner.estimate(MODEL, STRAT, SYS)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert planner.counters["evaluations"] == 1
    assert planner.counters["singleflight_waits"] == n - 1
    assert len({canonical_bytes(r) for r in results}) == 1


def test_singleflight_leader_error_propagates(planner):
    from simumax_tpu_torch.core.errors import UnknownConfigError

    with pytest.raises(UnknownConfigError):
        planner.estimate("no-such-model", STRAT, SYS)
    with pytest.raises(UnknownConfigError):
        planner.estimate("no-such-model", STRAT, SYS)
    assert planner.counters["hits"] == 0


def test_faults_and_simulate_cached_deterministically(planner):
    a, meta_a = planner.faults(MODEL, STRAT, SYS, monte_carlo=3, seed=7, horizon_steps=10,
                               with_meta=True)
    b, meta_b = planner.faults(MODEL, STRAT, SYS, monte_carlo=3, seed=7, horizon_steps=10,
                               with_meta=True)
    assert meta_a["cache"] == "miss" and meta_b["cache"] == "hit"
    assert canonical_bytes(a) == canonical_bytes(b)
    ref = JaxPerfLLM().configure(STRAT, MODEL, SYS)
    ref.run_estimate()
    assert_same(a, jax_normalized(ref.analyze_faults(
        n_scenarios=3, seed=7, horizon_steps=10,
        options=JaxReplayOptions(replay_backend="numpy"))))
    s1, m1 = planner.simulate(MODEL, STRAT, SYS, with_meta=True, track_memory=False)
    s2, m2 = planner.simulate(MODEL, STRAT, SYS, with_meta=True, track_memory=False)
    assert m1["cache"] == "miss" and m2["cache"] == "hit"
    assert canonical_bytes(s1) == canonical_bytes(s2)
    assert s1["end_time_ms"] > 0
    assert_same(s1, JaxPlanner(enabled=False).simulate(MODEL, STRAT, SYS, track_memory=False))


def test_faults_equal_on_every_replay_backend(tmp_path):
    """The kernel's plain version and the scalar engine answer alike, so
    the backend never enters a query's identity."""
    from simumax_tpu_torch.simulator.faults import ReplayOptions

    class NumpyPlanner(PortPlanner):
        def replay_options(self):
            return ReplayOptions(replay_backend="numpy")

    plain, mp = Planner(enabled=False).faults(MODEL, STRAT, SYS, monte_carlo=3, seed=5,
                                              horizon_steps=10, with_meta=True)
    numpy, mn = NumpyPlanner(enabled=False).faults(MODEL, STRAT, SYS, monte_carlo=3, seed=5,
                                                   horizon_steps=10, with_meta=True)
    assert canonical_bytes(plain) == canonical_bytes(numpy)
    assert mp["key"] == mn["key"]


def test_fleet_query_equals_the_jax_packages(planner):
    from test_fleet import base_trace
    from test_torch_fleet import jax_fleet

    got, meta = planner.fleet(base_trace(), with_meta=True)
    assert meta["cache"] == "miss"
    assert_same(got, jax_normalized(jax_fleet(base_trace())))


def test_planner_refuses_to_replay_off_the_card_unasked(tmp_path):
    """A planner built with the defaults replays on the card: without
    one its fault query fails instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default planner would launch the kernel")
    with pytest.raises(Exception, match="cuda|card|CUDA"):
        PortPlanner(enabled=False).faults(MODEL, STRAT, SYS, monte_carlo=2, seed=1,
                                          horizon_steps=4)


# --------------------------------------------------------------------------
# Per-cell persistent sweep layer
# --------------------------------------------------------------------------


def test_search_overlapping_grid_evaluates_only_delta(tmp_path):
    planner = Planner(cache_dir=str(tmp_path / "s"))
    a, meta_a = planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2), with_meta=True, **SWEEP)
    assert a["cells"] == {"total": 6, "pruned": 0, "deduped": 0, "quarantined": 0}
    assert meta_a["cells_evaluated"] == 6 and meta_a["cells_cached"] == 0
    b, meta_b = planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2, 4), with_meta=True,
                               **SWEEP)
    assert meta_b["cells_cached"] == 6 and meta_b["cells_evaluated"] == 3
    assert_same(b, JaxPlanner(enabled=False).search(MODEL, "tpu_v5p_256", tp_list=(1, 2, 4),
                                                    **SWEEP))


def test_search_journal_carries_only_delta_cells(tmp_path):
    planner = Planner(cache_dir=str(tmp_path / "s"))
    j1 = str(tmp_path / "first.jsonl")
    j2 = str(tmp_path / "second.jsonl")

    def journaled_keys(path):
        with open(path) as f:
            return [e["key"] for e in map(json.loads, f) if "key" in e]

    planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2), journal_path=j1, **SWEEP)
    assert len(journaled_keys(j1)) == 6
    planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2, 4), journal_path=j2, **SWEEP)
    keys = journaled_keys(j2)
    assert len(keys) == 3 and all(k.startswith("tp4_") for k in keys)


def test_search_csv_marks_cached_cells(tmp_path):
    import csv

    planner = Planner(cache_dir=str(tmp_path / "s"))
    planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2), **SWEEP)
    csv_path = str(tmp_path / "sweep.csv")
    planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2, 4), csv_path=csv_path, **SWEEP)
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert "cached" in {r["status"] for r in rows}
    assert {r["tp"] for r in rows if r["status"] == "cached"} <= {"1", "2"}
    assert "4" in {r["tp"] for r in rows if r["status"] == "ok"}


def test_search_store_concurrent_same_grid_single_sweep(tmp_path):
    planner = Planner(cache_dir=str(tmp_path / "s"))
    out = [None, None]

    def run(i):
        out[i] = planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2), **SWEEP)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert canonical_bytes(out[0]["rows"]) == canonical_bytes(out[1]["rows"])


def test_batched_profiles_persist_and_seed(tmp_path, jax_numpy_fold):
    """The batched engine's block-kind profiles round-trip through the
    port's store as a pickle, keyed by the scorer of the planner's
    device; a fresh process is seeded from them."""
    from simumax_tpu_torch.search import executor as _executor

    planner = Planner(cache_dir=str(tmp_path / "s"))
    _executor._SCORERS.clear()
    _executor._PROFILE_SEED.clear()
    a, _meta_a = planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2), engine="batched",
                                with_meta=True, **SWEEP)
    assert planner.store.stats()["namespaces"].get("profiles", {}).get("entries") == 1
    _executor._SCORERS.clear()
    _executor._PROFILE_SEED.clear()
    b, meta_b = planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 2), engine="batched",
                               with_meta=True, **SWEEP)
    assert _executor._PROFILE_SEED
    assert meta_b["cells_cached"] == a["cells"]["total"]
    assert meta_b["cache"] == "hit"
    assert canonical_bytes(a["rows"]) == canonical_bytes(b["rows"])
    assert_same(a, JaxPlanner(enabled=False).search(MODEL, "tpu_v5p_256", tp_list=(1, 2),
                                                    engine="batched", **SWEEP))


def test_transient_error_cells_are_not_persisted(tmp_path, monkeypatch):
    from simumax_tpu_torch.search import searcher as _searcher

    planner = Planner(cache_dir=str(tmp_path / "s"))
    real = _searcher._evaluate_sweep_cell
    calls = {"n": 0}

    def flaky(st, rc, *a, **k):
        calls["n"] += 1
        if rc == "selective":
            raise MemoryError("transient pressure")
        return real(st, rc, *a, **k)

    monkeypatch.setattr(_searcher, "_evaluate_sweep_cell", flaky)
    a = planner.search(MODEL, "tpu_v5p_256", tp_list=(1,), **SWEEP)
    assert a["cells"]["quarantined"] == 1
    first = calls["n"]
    monkeypatch.setattr(_searcher, "_evaluate_sweep_cell", real)
    _b, meta = planner.search(MODEL, "tpu_v5p_256", tp_list=(1,), with_meta=True, **SWEEP)
    assert meta["cells_cached"] == 2 and meta["cells_evaluated"] == 1
    assert first == 3


def test_caller_config_objects_are_never_mutated(planner):
    model = get_model_config(MODEL)
    strategy = get_strategy_config("tp8_pp1_dp1_mbs1")
    system = get_system_config("tpu_v5p_256")
    before = model.padded_vocab_size
    planner.estimate(model, strategy, system)
    assert model.padded_vocab_size == before
    _p, meta = planner.estimate(model, strategy, system, with_meta=True)
    assert meta["cache"] == "hit"


def test_batched_profiles_key_stable_under_vocab_padding(tmp_path):
    from simumax_tpu_torch.search import executor as _executor
    from simumax_tpu_torch.service.planner import batched_profiles_key

    planner = Planner(cache_dir=str(tmp_path / "s"))
    _executor._SCORERS.clear()
    _executor._PROFILE_SEED.clear()
    planner.search(MODEL, "tpu_v5p_256", tp_list=(1, 8), engine="batched", **SWEEP)
    fresh_key = batched_profiles_key(get_model_config(MODEL), get_system_config("tpu_v5p_256"))
    assert planner.store.get("profiles", fresh_key) is not None

"""The FLOP and byte counts against hand counts at small shapes, and every
share at most 100% when the measured time is the ideal one."""

import math

import pytest

from portbench import manifest, work
from portbench.weights import Model, leaf_specs

DENSE = Model(kind="dense", vocab=10, hidden=4, heads=2, kv_heads=1, head_dim=2, layers=3,
              ffn=6, rope_theta=1e4, eps=1e-5)
MOE = Model(kind="moe", vocab=10, hidden=4, heads=2, kv_heads=1, head_dim=2, layers=2, ffn=3,
            rope_theta=1e4, eps=1e-5,
            own=manifest.load_kind("moe").Own(experts=4, topk=2, capacity_factor=2.0))


@pytest.mark.parametrize("m", [DENSE, MOE], ids=["dense", "moe"])
def test_param_count_is_the_leaves(m):
    total = 0
    for _path, shape, _scale in leaf_specs(m):
        total += math.prod(shape)
    assert work.param_count(m) == total


def test_dense_counts_by_hand():
    # a layer: qkv 4 x (2 + 2) * 2 = 32, out 4 x 4 = 16, up 4 x 12 = 48, down 6 x 4 = 24
    # -> 120 linear weights a layer, 8 norm weights; LM head 4 x 10 = 40; final norm 4
    touched = work.touched_params(DENSE)
    assert touched == {"linear": 3 * 120 + 40, "other": 3 * 8 + 4}
    tokens = 2 * 8
    # attention: 6 b s^2 heads d layers = 6 * 2 * 64 * 2 * 2 * 3
    assert work.attention_ops(DENSE, 2, 8) == 6 * 2 * 64 * 2 * 2 * 3
    assert work.model_ideal_s(DENSE, 2, 8, "bf16") == pytest.approx(
        (6 * (400 + 28) * tokens + 9216) / 989e12)
    # Adam: 22 B a parameter
    assert work.optimizer_bytes(DENSE) == 22 * work.param_count(DENSE)
    # one product, compute-bound at the bf16 peak: 3 x 2 rows k n / peak
    big = work.product_ideal_s(4096, 4096, 4096, "bf16")
    assert big == pytest.approx(3 * 2 * 4096 ** 3 / 989e12)
    # one product bound by bytes: rows 1, k n bf16 weights read three times
    small = work.product_ideal_s(1, 4096, 4096, "bf16")
    assert small == pytest.approx(3 * 2 * (4096 + 4096 * 4096 + 4096) / 3.35e12)


def test_moe_counts_only_the_top_k_experts():
    # a layer: qkv 32, out 16; top-2 of 4 experts, each 3 x 4 x 3 = 36 -> 72; router 4 x 4
    touched = work.touched_params(MOE)
    assert touched == {"linear": 2 * (48 + 72) + 40, "other": 2 * 8 + 4 + 2 * 16}
    shapes = {name: (per, k, n, w) for name, per, k, n, w in work.linear_shapes(MOE)}
    assert shapes["expert_up"] == (2, 4, 6, 4) and shapes["expert_down"] == (2, 3, 4, 4)


def test_the_published_cells_match_a_hand_reckoning():
    aquila = Model(kind="dense", vocab=100008, hidden=4096, heads=32, kv_heads=32, head_dim=128,
                   layers=8, ffn=11008, rope_theta=1e4, eps=1e-5)
    tokens = 8192
    linear = 6 * work.touched_params(aquila)["linear"] * tokens
    assert linear == pytest.approx(99.7e12, rel=2e-3)
    assert work.attention_ops(aquila, 2, 4096) == pytest.approx(6.6e12, rel=1e-2)
    assert work.param_count(aquila) == pytest.approx(2.44e9, rel=1e-2)


#: each share's ideal seconds a step, as its reader counts them
IDEAL = {
    "step_mfu_pct": lambda m, mbs, seq, linear: work.model_ideal_s(m, mbs, seq, linear),
    "gemm_roofline": lambda m, mbs, seq, linear: work.gemm_ideal_s(m, mbs * seq, linear),
    "attention_roofline": lambda m, mbs, seq, linear: work.attention_ideal_s(m, mbs, seq),
    "optimizer_roofline": lambda m, mbs, seq, linear: work.optimizer_ideal_s(m),
}
FAMILY = {"gemm_roofline": "gemm", "attention_roofline": "attention",
          "optimizer_roofline": "optimizer"}


def _record(m, linear, ms, step_s, steps=10, mbs=2, seq=64):
    """A record with the run's shapes, every family at ``ms`` a step."""
    return {"steps": steps, "window_s": steps * step_s, "model": m, "mbs": mbs, "seq": seq,
            "linear": linear,
            "traced": {"family_ms": {f: ms[f] for f in FAMILY.values()}, "busy_s": 1.0,
                       "window_s": 1.0}}


@pytest.mark.parametrize("linear", ["bf16", "int8"])
@pytest.mark.parametrize("m", [DENSE, MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("name", sorted(IDEAL))
def test_shares_reach_100_at_the_ideal_and_stay_below_it(m, linear, name):
    from portbench import manifest

    reader = manifest.load_reader(name)
    ideal = {n: f(m, 2, 64, linear) for n, f in IDEAL.items()}
    at_ideal = {FAMILY[n]: ideal[n] * 1e3 for n in FAMILY}
    assert reader.read(_record(m, linear, at_ideal, ideal["step_mfu_pct"])) \
        == pytest.approx(100.0)
    slower = _record(m, linear, {f: ms * 1.25 for f, ms in at_ideal.items()},
                     ideal["step_mfu_pct"] * 1.25)
    assert reader.read(slower) == pytest.approx(80.0)


def test_a_share_with_nothing_to_read_is_left_out():
    from portbench import manifest

    base = {"model": DENSE, "mbs": 2, "seq": 64, "linear": "bf16"}
    for name in ("gemm_roofline", "attention_roofline", "optimizer_roofline",
                 "device_idle_pct"):
        assert manifest.load_reader(name).read(dict(base, traced=None)) is None
        assert manifest.load_reader(name).read(
            dict(base, traced={"family_ms": {}, "window_s": 0})) is None


#: a roofline a later change could add as one file: the norm family's
#: bytes (each of the 2 L + 1 norms reads x and writes y forward, reads x
#: and dy and writes dx backward, bf16) over its device time
NEW_READER = '''
LAYER = "norm kernels: rms_norm.cu"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    ms = (record.get("traced") or {}).get("family_ms", {}).get("norm", 0.0)
    if ms <= 0:
        return None
    m = record["model"]
    bytes_ = 2 * 5 * record["mbs"] * record["seq"] * m.hidden * (2 * m.layers + 1)
    return 100.0 * bytes_ / 3.35e12 * 1e3 / ms
'''


def test_a_new_roofline_reads_its_work_from_the_record_alone(tmp_path):
    """A per-layer metric added as one file, with no other file touched,
    counts its work from the shapes the run puts into the record."""
    from portbench import manifest, run
    from portbench.tests.tiny import CELLS, tiny_spec

    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "norm_roofline.py").write_text(NEW_READER)
    reader = manifest.load_reader("norm_roofline", str(tmp_path))
    spec = tiny_spec(CELLS[0])
    m = Model.from_config(spec.config)
    traced = {"family_ms": {"norm": 0.25}, "busy_s": 1.0, "window_s": 1.0}
    record = run.record_of(spec, m, 1.0, [100.0] * 10, 5.0, 0, traced)
    norm_bytes = 2 * 5 * 2 * 64 * 128 * (2 * 2 + 1)
    assert reader.read(record) == pytest.approx(100.0 * norm_bytes / 3.35e12 * 1e3 / 0.25)
    assert reader.read(dict(record, traced=None)) is None

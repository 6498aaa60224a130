"""The op-family attribution of ``simumax_tpu_torch/tools/attribute_step.py``
on the CPU: the ledger's side against the JAX package's ledger, and the
profiler side on a CPU profile of a small reference step.

On the card the tool ties each kernel to the host call that launched it;
here the host calls themselves stand in for the kernels (the CPU runs
each op where it is called), so the test asks the same question of the
ops: does each land in its family, forward, backward (found through the
autograd node's sequence number) and, with full-block recompute, in the
recomputed forward too.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch import bench  # noqa: E402
from simumax_tpu_torch.tools import attribute_step as A  # noqa: E402
from simumax_tpu_torch.torchref import model as M  # noqa: E402
from simumax_tpu_torch.torchref import moe_model as MoE  # noqa: E402

ROW_IDS = [row[0] for row in bench.ROWS]


def _jax_row_perf(kind, seq, mbs, layers, remat):
    """The JAX package's estimate of a bench row on ``tpu_v5e_256``."""
    from tools import accuracy_table

    mc = accuracy_table.moe_model() if kind == "moe" else accuracy_table.dense_model()
    return accuracy_table.predict(mc, seq, mbs, layers, remat, "tpu_v5e_256", kind)


@pytest.mark.parametrize("row", bench.ROWS, ids=ROW_IDS)
def test_ledger_families_group_the_jax_ledger_and_sum_to_the_step(row):
    _label, kind, seq, mbs, layers, remat = row
    got = A.ledger_families(bench.predict_step(bench.build_model(kind), "tpu_v5e_256", kind,
                                               seq, mbs, layers, remat))
    ref = _jax_row_perf(kind, seq, mbs, layers, remat)
    want = dict.fromkeys(A.FAMILIES, 0.0)
    for span in ref.ledger().op_spans:
        want[A._LEDGER_FAMILY.get(span.category, "elementwise")] += span.time * 1e3
    cost = ref.analysis_cost()
    want["optimizer"] += cost["time_breakdown"]["optimizer"] * 1e3
    want["recompute"] = cost["time_breakdown"]["recompute_per_microbatch"] * 1e3
    assert sorted(got) == sorted(want)
    for family in want:
        assert got[family] == pytest.approx(want[family], rel=1e-12, abs=0), family
    assert sum(got.values()) == pytest.approx(cost["iter_time"] * 1e3, rel=1e-9)
    assert (got["recompute"] > 0) == remat
    assert (got["MoE dispatch"] > 0) == (kind == "moe")


def _profiled_ops(step, path):
    """(name, family) of every aten op of one profiled call of ``step``,
    each asked at the middle of its host event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    trace = trace["traceEvents"] if isinstance(trace, dict) else trace
    events = [e for e in trace if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    families = A.host_families(events, [(e["tid"], e["ts"] + e.get("dur", 0) / 2) for e in ops])
    return [(e["name"], f) for e, f in zip(ops, families)]


def _families_of(ops, name):
    return {f for n, f in ops if n == name}


@pytest.mark.parametrize("remat", [False, True], ids=["eager", "remat"])
def test_profiled_dense_step_lands_each_op_in_its_family(remat, tmp_path):
    cfg = M.LlamaConfig(vocab_size=256, hidden_size=64, head_num=2, kv_head_num=1,
                        head_size=32, intermediate_size=128, layer_num=2, dtype=torch.float32)
    params = M.init_params(cfg, seed=0, device="cpu")
    init_opt, train_step = M.make_train_step(cfg, remat=remat)
    opt = init_opt(params)
    ids = torch.randint(0, 256, (1, 64), generator=torch.Generator().manual_seed(0))
    ops = _profiled_ops(lambda: train_step(params, opt, (ids, ids)), tmp_path / "t.json")
    assert _families_of(ops, "aten::mm") == {"GEMM"}  # forward, dgrad and wgrad
    assert _families_of(ops, "aten::sqrt") == {"norm"}  # the norm's 1 / sqrt
    assert _families_of(ops, "aten::_log_softmax") == {"cross-entropy"}
    assert _families_of(ops, "aten::_log_softmax_backward_data") == {"cross-entropy"}
    assert _families_of(ops, "aten::_softmax") == {"attention"}
    assert _families_of(ops, "aten::_softmax_backward_data") == {"attention"}
    assert _families_of(ops, "aten::bmm") == {"attention"}  # math attention's products
    # the plain Adam update's in-place moment decays and square root
    assert _families_of(ops, "aten::mul_") == {"optimizer"}
    assert _families_of(ops, "aten::sqrt_") == {"optimizer"}
    assert _families_of(ops, "aten::silu") == {"elementwise"}
    assert _families_of(ops, "aten::cos") == {"elementwise"}  # rope
    if remat:  # the recomputed forward runs each norm twice
        assert sum(1 for n, _f in ops if n == "aten::sqrt") > 2 * cfg.layer_num + 1


def test_profiled_int8_and_moe_steps_land_each_op_in_its_family(tmp_path):
    cfg = M.LlamaConfig(vocab_size=256, hidden_size=64, head_num=2, kv_head_num=1,
                        head_size=32, intermediate_size=128, layer_num=1,
                        dtype=torch.bfloat16, use_int8=True)
    params = M.init_params(cfg, seed=0, device="cpu")
    init_opt, train_step = M.make_train_step(cfg)
    opt = init_opt(params)
    ids = torch.randint(0, 256, (1, 32), generator=torch.Generator().manual_seed(0))
    ops = _profiled_ops(lambda: train_step(params, opt, (ids, ids)), tmp_path / "int8.json")
    # the int8 path's products (the port's int8 GEMM, whose plain version
    # runs aten::mm here) and its quantization, forward and backward
    assert _families_of(ops, "aten::mm") == {"GEMM"}
    assert _families_of(ops, "aten::round") == {"GEMM"}

    mcfg = MoE.MoeConfig(vocab_size=256, hidden_size=64, head_num=2, kv_head_num=2,
                         head_size=32, layer_num=1, expert_num=4, topk=2, moe_ffn=64,
                         dtype=torch.float32)
    params = MoE.init_params(mcfg, seed=0, device="cpu")
    init_opt, train_step = MoE.make_train_step(mcfg)
    opt = init_opt(params)
    ops = _profiled_ops(lambda: train_step(params, opt, (ids, ids)), tmp_path / "moe.json")
    assert _families_of(ops, "aten::sort") == {"MoE dispatch"}
    # the route's top-k: the plain version's rounds of argmax on the CPU
    assert _families_of(ops, "aten::argmax") == {"MoE dispatch"}
    assert "GEMM" in _families_of(ops, "aten::bmm")  # the experts
    assert "attention" in _families_of(ops, "aten::bmm")  # math attention
    assert _families_of(ops, "aten::mul_") == {"optimizer"}  # the Adam moments' decays


def test_replayed_kernels_take_the_families_of_the_eager_kernels():
    eager = [("gemm_a", 1.0, "GEMM"), ("fill", 0.1, "elementwise"), ("gemm_a", 1.0, "attention")]
    same = [{"ph": "X", "cat": "kernel", "name": n, "ts": i, "dur": 1000.0 * (i + 1)}
            for i, (n, _ms, _f) in enumerate(eager)]
    out, matched = A.replay_families(eager, same)
    assert matched and out["GEMM"] == 1.0 and out["elementwise"] == 2.0 and out["attention"] == 3.0
    # a profiler window that missed the replay's first kernel: matched to the end
    out, matched = A.replay_families(eager, same[1:])
    assert matched and out["GEMM"] == 0.0 and out["elementwise"] == 2.0 and out["attention"] == 3.0
    # lists that differ: a name's ms split over its eager families
    out, matched = A.replay_families(eager, same[:1] + [
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_wgmma_kernel", "ts": 5, "dur": 500.0}])
    assert not matched
    assert out["GEMM"] == 0.5 and out["attention"] == 0.5 + 0.5


def test_a_replay_matches_the_eager_step_across_its_copy_kernels():
    """A graph replay runs the eager step's device copies as kernels of
    its own name (``memcpy32_post``, ``memcpy128``); the replay still
    matches one for one, so each kernel keeps the family of its eager
    position."""
    eager = [("Memcpy DtoD (Device -> Device)", 0.1, "MoE dispatch"), ("div", 1.0, "optimizer"),
             ("div", 0.1, "MoE dispatch"), ("Memset (Device)", 0.1, "elementwise")]
    names = ["memcpy32_post", "div", "div", "Memset (Device)"]
    replay = [{"ph": "X", "cat": "kernel", "name": n, "ts": i, "dur": 1000.0 * (i + 1)}
              for i, n in enumerate(names)]
    kernels, matched = A.replay_kernels(eager, replay)
    assert matched
    assert kernels["MoE dispatch"] == {"memcpy32_post": 1.0, "div": 3.0}
    assert kernels["optimizer"] == {"div": 2.0} and kernels["elementwise"] == {
        "Memset (Device)": 4.0}
    out, matched = A.replay_families(eager, replay)
    assert matched and out["MoE dispatch"] == 4.0 and out["optimizer"] == 2.0


def test_a_window_is_read_from_its_mark_on():
    def kernel(name, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 1.0}

    host = {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.5}
    lead = [kernel("fill", t) for t in (1, 2)]
    mark = kernel("at::cuda::(anonymous namespace)::spin_kernel(long)", 3)
    step = [kernel("gemm", 5), {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 6},
            kernel("fill", 7)]
    # the lead's launches and the mark go, the step's stay, host events too
    assert A.after_mark([host] + lead + [mark] + step) == [host] + step
    assert A.after_mark(lead[1:] + [mark] + step) == step  # a window that dropped launches
    # out of order in the trace: read by time
    assert A.after_mark(step[::-1] + [mark] + lead) == step[::-1]
    # a window that dropped its mark gives no device event: it is not read
    assert A.after_mark([host] + step) == [host]

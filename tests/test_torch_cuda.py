"""The CUDA kernels against their plain PyTorch versions, and the
manual-parallel step, the MoE reference and the int8 path on the card
against the CPU. Every test here needs a CUDA card and skips without
one; the file imports no jax, so it also runs on a machine with only
PyTorch:
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance, element by element: |kernel - plain| <= rtol * (|plain| +
rms(plain)), rtol 2^-7 for bf16 outputs (the two may round one bf16 ulp
apart; the plain versions round P and dS to bf16 where the wgmma kernels
do); for fp32 outputs 1e-4 for the flash kernels (summation order
only) and 1e-5 for SwiGLU (the sigmoids may differ in the last bits).
The int8 quantize kernels and the batched scenario replay are held bit
for bit (the replay also against the scalar engine).
"""

import math

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch.torchref import kernels as K  # noqa: E402


def _within(got, ref, rtol):
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= rtol * (ref.abs() + ref.square().mean().sqrt())).all())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernels_match_plain_versions(card, dtype, rtol, causal):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v, do = (torch.randn(2, 256, 2, 128, generator=gen, device=card).to(dtype)
                   for _ in range(4))
    K.reset_launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal)
    delta = K.flash_delta(o_ref, do)
    got = [o, K.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
           *K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)]
    ref = [o_ref, K.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal),
           *K.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)]
    assert K.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                                 "swiglu_fwd": 0, "swiglu_bwd": 0, "q8_amax": 0,
                                 "q8_quantize": 0, "q8_quantize_cols_tma": 0,
                                 "q8_quantize_both_tma": 0, "replay_solve": 0}
    for (g, r), tol in zip([(lse, lse_ref)] + list(zip(got, ref)), [1e-4] + [rtol] * 4):
        g, r = g.float(), r.float()
        limit = tol * (r.abs() + r.square().mean().sqrt())
        assert bool(((g - r).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal", [
    (1, 1024, 1024, 2, 64, True),   # d = 64, 16 kv tiles
    (2, 320, 320, 3, 128, True),    # s = 64 mod 128
    (1, 512, 512, 2, 128, False),   # several kv tiles, non-causal
    (1, 320, 320, 2, 64, False),
    (1, 128, 320, 2, 64, True),     # more keys than queries: kv tiles past every query
    (2, 320, 128, 2, 128, True),    # more queries than keys
])
def test_bf16_wgmma_kernels_match_plain_versions(card, b, sq, skv, h, d, causal):
    gen = torch.Generator(device=card).manual_seed(1)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device=card).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=gen, device=card).bfloat16() for _ in range(2))
    K.reset_launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal)
    delta = K.flash_delta(o_ref, do)
    dq = K.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dq_ref = K.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    dk_ref, dv_ref = K.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 1
    assert _within(lse, lse_ref, 1e-4)
    for got, ref in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _within(got, ref, 2 ** -7)


@pytest.mark.cuda
def test_bf16_kernels_take_a_tensor_that_is_not_16_byte_aligned(card):
    # one head: the [b*h, s, d] operand is a view of the input, which here
    # starts 2 bytes into its storage; the wrapper copies it to an aligned one
    gen = torch.Generator(device=card).manual_seed(2)
    base = torch.randn(1 * 128 * 1 * 64 + 1, generator=gen, device=card).bfloat16()
    q = base[1:].view(1, 128, 1, 64)
    o, lse = K.flash_fwd(q, q, q)
    o_ref, lse_ref = K.flash_fwd_plain(q, q, q)
    assert _within(o, o_ref, 2 ** -7) and _within(lse, lse_ref, 1e-4)


@pytest.mark.cuda
def test_explicit_flash_on_the_card_raises_for_a_shape_the_kernels_refuse(card):
    ragged = torch.zeros(1, 96, 2, 64, device=card)
    with pytest.raises(ValueError, match="do not take"):
        K.attention(ragged, ragged, ragged, use_flash=True)
    gqa_kv = torch.zeros(1, 128, 1, 64, device=card)
    q = torch.zeros(1, 128, 2, 64, device=card)
    with pytest.raises(ValueError, match="do not take"):
        K.attention(q, gqa_kv, gqa_kv, use_flash=True)
    # left to the dispatcher, such shapes take the math path
    assert K.attention(ragged, ragged, ragged).shape == ragged.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("shape", [(2, 64, 1024), (21, 200), (3, 24)])  # f = 512, 100, 12
def test_swiglu_kernels_match_plain_versions(card, dtype, rtol, shape):
    gen = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn(shape, generator=gen, device=card) * 3).to(dtype)
    dy = torch.randn((*shape[:-1], shape[-1] // 2), generator=gen, device=card).to(dtype)
    K.reset_launch_counts()
    out, dx = K.swiglu_fwd(x), K.swiglu_bwd(x, dy)
    torch.cuda.synchronize()
    assert K.launch_counts()["swiglu_fwd"] == 1 and K.launch_counts()["swiglu_bwd"] == 1
    assert out.dtype == dtype and dx.shape == x.shape
    assert _within(out, K.swiglu_fwd_plain(x), rtol)
    assert _within(dx, K.swiglu_bwd_plain(x, dy), rtol)
    # an unaligned base pointer takes the scalar loads of the same kernel
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=card)[1:].view(shape).copy_(x)
    assert _within(K.swiglu_fwd(xs), K.swiglu_fwd_plain(x), rtol)


@pytest.mark.cuda
def test_swiglu_on_the_card_raises_for_what_the_kernels_refuse(card):
    x = torch.zeros(8, 64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        K.swiglu(x[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        K.swiglu_bwd(x, torch.zeros(32, 8, device=card).t())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.swiglu(x.half())
    with pytest.raises(ValueError, match="even last dim"):
        K.swiglu(torch.zeros(8, 63, device=card))


@pytest.mark.cuda
def test_parallel_step_on_the_card_matches_the_cpu(card):
    from simumax_tpu_torch.torchref import parallel as T

    cfg = T.PPConfig(vocab_size=512, hidden_size=128, head_num=2, head_size=64,
                     intermediate_size=256, moe_ffn=128, expert_num=4, dtype=torch.float32)
    ids = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        with T.process_group(device):
            mesh = T.make_pp_mesh(1, pp=1, tp=1, ep=1, device=device)
            params, specs = T.init_pp_params(cfg, mesh, torch.Generator().manual_seed(0))
            K.reset_launch_counts()
            new, loss = T.make_pp_train_step(cfg, mesh, lr=1.0)(specs)(params, ids, ids)
            runs[device] = (float(loss), {k: v.cpu() for k, v in new.items()},
                            K.launch_counts())
    (loss_gpu, new_gpu, counts), (loss_cpu, new_cpu, _) = runs["cuda"], runs["cpu"]
    assert counts == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                      "swiglu_fwd": 2, "swiglu_bwd": 2, "q8_amax": 0, "q8_quantize": 0,
                      "q8_quantize_cols_tma": 0, "q8_quantize_both_tma": 0,
                      "replay_solve": 0}
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for name in new_cpu:
        assert _within(new_gpu[name], new_cpu[name], 1e-4), name



def _tree_to(tree, device):
    """A params tree's leaves copied to ``device`` as new leaves."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.detach().to(device).requires_grad_(True)


@pytest.mark.cuda
def test_moe_reference_step_on_the_card_matches_the_cpu(card):
    """One fp32 Adam step of the MoE reference on the card against the
    same step on the CPU, with tokens dropped at capacity factor 1: the
    loss to rel 1e-5, every updated parameter to 1e-4 (|cpu| + rms(cpu))
    element by element (fp32 sums in other orders). The first Adam step
    moves an element by about lr times the sign of its gradient, so
    where the CPU's first moment is below 1e-3 of its leaf's largest (a
    gradient that rounding could flip) the two may step apart by 2 lr."""
    from simumax_tpu_torch.torchref import moe_model as M

    cfg = M.MoeConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4, head_size=64,
                      layer_num=2, expert_num=4, topk=2, moe_ffn=512, capacity_factor=1.0,
                      dtype=torch.float32)
    params = M.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, 512, (2, 64), generator=torch.Generator().manual_seed(0))
    lr, results = 1e-2, {}
    for device in ("cuda", "cpu"):
        init_opt, step = M.make_train_step(cfg, lr=lr)
        p = _tree_to(params, device)
        new, opt, loss = step(p, init_opt(p), (ids.to(device), ids.to(device)))
        results[device] = (float(loss), [x.detach().cpu() for x in M.param_leaves(new)],
                           [x.cpu() for x in M.param_leaves(opt["mu"])])
    (loss_gpu, new_gpu, _), (loss_cpu, new_cpu, mu_cpu) = results["cuda"], results["cpu"]
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for got, ref, mu in zip(new_gpu, new_cpu, mu_cpu):
        limit = 1e-4 * (ref.abs() + ref.square().mean().sqrt())
        limit = limit.where(mu.abs() >= 1e-3 * mu.abs().max(), limit.new_tensor(2 * lr))
        assert bool(((got - ref).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_on_the_card_matches_the_cpu(card, dtype):
    """The int8 products (NN forward, NT dgrad, TN wgrad) are integer
    arithmetic: equal on the card and the CPU. So are the quantized
    operands and the bf16 output and gradients of ``int8_matmul``, which
    round the same fp32 values."""
    from simumax_tpu_torch.torchref import quantized as Q

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 64, generator=gen).to(dtype)
    w = (torch.randn(64, 48, generator=gen) * 0.1).to(dtype)
    g = torch.randn(2, 40, 48, generator=gen).bfloat16()
    q = {(name, cols): Q._q8(t.reshape(-1, t.shape[-1]), column_major=cols)[0]
         for name, t in (("x", x), ("w", w), ("g", g)) for cols in (False, True)}
    # each operand in the order the int8 path quantizes it into
    for a, b, ta, tb, (ca, cb) in (("x", "w", False, False, (False, True)),
                                   ("g", "w", False, True, (False, False)),
                                   ("x", "g", True, False, (True, True))):
        ref = Q._mm(q[a, ca], q[b, cb], ta=ta, tb=tb)
        got = Q._mm(q[a, ca].to(card), q[b, cb].to(card), ta=ta, tb=tb)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), ref)
    outs = {}
    for device in ("cuda", "cpu"):
        xd, wd = (t.to(device).requires_grad_(True) for t in (x, w))
        y = Q.int8_matmul(xd, wd)
        outs[device] = [t.cpu() for t in (y, *torch.autograd.grad(y, (xd, wd), g.to(device)))]
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.cuda
def test_int_mm_shape_rules_raise_on_the_card(card):
    """The int8 path refuses, before the card does, the shapes
    ``torch._int_mm`` refuses there (it pads nothing), and takes 17 rows."""
    from simumax_tpu_torch.torchref import quantized as Q

    def ones(*shape):
        return torch.ones(shape, dtype=torch.int8, device=card)

    assert torch.equal(Q._mm(ones(17, 8), ones(8, 8).t()).cpu(), torch.full((17, 8), 8))
    for a, b in ((ones(16, 8), ones(8, 8)), (ones(32, 12), ones(12, 8)),
                 (ones(32, 8), ones(8, 12))):
        with pytest.raises(ValueError, match="more than 16 rows"):
            Q._mm(a, b)
        with pytest.raises(RuntimeError, match="greater than"):
            torch._int_mm(a, b)
    with pytest.raises(RuntimeError, match="dimension 2"):
        torch._int_mm(ones(2, 32, 8), ones(8, 8))


def _events_s(calls, fn, samples=1):
    """Seconds per call of ``samples`` back-to-back windows of ``calls``
    eager calls of ``fn`` between CUDA events, queued behind the graph
    timer's spin kernel; a list, one per window."""
    from simumax_tpu_torch.calibration import timing

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(samples + 1)]
    torch.cuda._sleep(timing.LEAD_CYCLES)
    marks[0].record()
    for mark in marks[1:]:
        for _ in range(calls):
            fn()
        mark.record()
    marks[-1].synchronize()
    return [x.elapsed_time(y) * 1e-3 / calls for x, y in zip(marks, marks[1:])]


@pytest.mark.cuda
def test_graph_timer_agrees_with_event_timing_on_a_long_gemm(card):
    """On a GEMM of over a millisecond the graph timer agrees within 2%
    with CUDA events around back-to-back eager calls, in three
    alternating turns. The eager window repeats the graph timer's: queued
    behind the same spin kernel (the host may take as long to issue a
    call as the card to run it, and must not show), as many samples of
    as many calls. The GEMM is fp32 on the CUDA cores (TF32 off): a bf16
    tensor-core GEMM of this length runs at the clock the card's power
    cap allows, which changes from one turn to the next (the test below
    holds the bf16 GEMM under one load)."""
    from simumax_tpu_torch.calibration import timing

    gen = torch.Generator(device=card).manual_seed(0)
    a, b = (torch.randn(4096, 4096, generator=gen, device=card) for _ in range(2))
    turns = []
    with torch.no_grad():
        _events_s(timing.PILOT_CALLS, lambda: a @ b)
        for _ in range(3):
            g = timing.time_graph(lambda: a @ b)
            calls = math.ceil(timing.MIN_SAMPLE_S / g)
            turns.append((g, timing.robust_median(
                _events_s(calls, lambda: a @ b, timing.GRAPH_ITERS))))
    print("fp32 4096^3: graph / eager ms " + ", ".join(
        f"{g * 1e3:.4f} / {e * 1e3:.4f}" for g, e in turns))
    assert min(g for g, _ in turns) >= 1e-3
    assert abs(sorted(g / e for g, e in turns)[1] - 1) <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,size", [(torch.float32, 4096), (torch.bfloat16, 8192)])
def test_graph_replays_and_eager_calls_agree_under_one_load(card, dtype, size):
    """A replay of a graph of n GEMMs and a window of n eager GEMMs take
    the same time when they alternate inside one unbroken load, within
    2% (medians of five each), after 0.3 s of GEMMs have settled the
    clock under the power cap. n is what :func:`time_graph` sizes a
    sample to. This holds the timer apart from the clock: at bf16 8192³
    separate turns of the graph timer and of an eager window of the same
    length read up to 13% apart, either way round, as the clock the cap
    allows moves between turns."""
    from simumax_tpu_torch.calibration import timing

    gen = torch.Generator(device=card).manual_seed(0)
    a, b = (torch.randn(size, size, generator=gen, device=card).to(dtype) for _ in range(2))
    with torch.no_grad():
        per_call = timing.time_graph(lambda: a @ b)
        calls = math.ceil(timing.MIN_SAMPLE_S / per_call)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            a @ b
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                a @ b
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
        for _ in range(math.ceil(0.3 / per_call)):
            a @ b
        marks[0].record()
        for i in range(5):
            graph.replay()
            marks[2 * i + 1].record()
            for _ in range(calls):
                a @ b
            marks[2 * i + 2].record()
        marks[-1].synchronize()
    spans = [x.elapsed_time(y) * 1e-3 / calls for x, y in zip(marks, marks[1:])]
    replayed, eager = timing.robust_median(spans[0::2]), timing.robust_median(spans[1::2])
    print(f"{dtype} {size}^3 under one load, {calls} calls a sample: graph "
          f"{replayed * 1e3:.4f} ms, eager {eager * 1e3:.4f} ms; time_graph "
          f"{per_call * 1e3:.4f} ms")
    assert per_call >= 1e-3
    assert abs(replayed / eager - 1) <= 0.02


@pytest.mark.cuda
def test_graph_timer_counts_each_replayed_launch(card):
    """The warm-up calls count as launched, the captures count nothing,
    and each replay counts every launch it captured: 2 + 4 (the pilot
    graph's replay) + n x 5 (five samples)."""
    from simumax_tpu_torch.calibration import timing

    q, k, v = (torch.randn(1, 256, 2, 64, device=card).bfloat16() for _ in range(3))
    K.reset_launch_counts()
    with torch.no_grad():
        timing.time_graph(lambda: K.flash_fwd(q, k, v, True))
    counts = K.launch_counts()
    assert counts["flash_fwd"] > 6 and (counts["flash_fwd"] - 6) % 5 == 0
    assert sum(counts.values()) == counts["flash_fwd"]


@pytest.mark.cuda
def test_graph_timer_holds_no_memory_once_it_returns(card):
    """Timing again allocates nothing that outlives the timing: the
    captured graphs and their pools are freed, and every warm-up and
    capture runs on one side stream, so cuBLAS pins no new workspace."""
    from simumax_tpu_torch.calibration import timing

    a, b = (torch.randn(1024, 1024, device=card).bfloat16() for _ in range(2))
    with torch.no_grad():
        timing.time_graph(lambda: a @ b)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        for _ in range(4):
            timing.time_graph(lambda: a @ b)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_an_oom_inside_a_capture_ends_it_and_is_retried(card):
    from simumax_tpu_torch.calibration import autocal, timing

    x = torch.ones(1024, device=card)
    state = {"raised": False}

    def op():
        if torch.cuda.is_current_stream_capturing() and not state["raised"]:
            state["raised"] = True
            raise torch.cuda.OutOfMemoryError("injected inside the capture")
        return x * 2

    attempts = []

    def measure():
        attempts.append(torch.cuda.is_current_stream_capturing())
        return timing.time_graph(op)

    assert autocal.with_retries(measure, backoff=0.0) > 0
    assert attempts == [False, False] and state["raised"]
    assert not torch.cuda.is_current_stream_capturing()


@pytest.mark.cuda
def test_sdp_bwd_key_reads_the_same_with_the_host_slowed(card):
    """The flash row's ``sdp_bwd`` key, timed from CUDA graphs, reads
    within 5% of itself while a thread spinning in Python holds the
    interpreter lock."""
    from simumax_tpu_torch import bench
    from simumax_tpu_torch.calibration import autocal
    from simumax_tpu_torch.calibration.timing import host_slowed

    perf = bench.predict_step(bench.build_bench_model(), "h100_sxm", "flash")
    key = next(iter(perf.system.miss_efficiency["sdp_bwd"]))
    plain = autocal.calibrate_key("sdp_bwd", key, perf.system)
    with host_slowed():
        slowed = autocal.calibrate_key("sdp_bwd", key, perf.system)
    assert 0 < plain <= 1 and abs(slowed - plain) <= 0.05 * plain


@pytest.mark.cuda
def test_moe_step_syncs_the_host_nowhere(card):
    """A MoE training step (tokens dropped, top-2 and top-4) runs under
    ``set_sync_debug_mode("error")``: its dispatch has static shapes."""
    from simumax_tpu_torch.torchref import moe_model as M

    for e, k in ((4, 2), (8, 4)):
        cfg = M.MoeConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4,
                          head_size=64, layer_num=2, expert_num=e, topk=k, moe_ffn=512,
                          capacity_factor=0.5)
        params = M.init_params(cfg, seed=0, device=card)
        ids = torch.randint(0, 512, (2, 64), generator=torch.Generator().manual_seed(0)).to(card)
        init_opt, step = M.make_train_step(cfg)
        opt = init_opt(params)
        params, opt, _ = step(params, opt, (ids, ids))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, opt, loss = step(params, opt, (ids, ids))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(loss)


@pytest.mark.cuda
def test_top4_moe_combine_on_the_card_repeats_bit_for_bit_and_matches_the_cpu(card):
    """The top-4 MoE layer (tokens dropped): two bf16 runs on the card give
    equal outputs and gradients, bit for bit; in fp32 the card's model
    gives the CPU's logits within 1e-5 of their largest (the CPU test's
    tolerance against JAX)."""
    from simumax_tpu_torch.torchref import moe_model as M

    sizes = dict(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4, head_size=64,
                 layer_num=2, expert_num=8, topk=4, moe_ffn=512, capacity_factor=0.5)
    y0 = torch.randn(1, 64, 256, generator=torch.Generator().manual_seed(2))
    runs = []
    for _ in range(2):
        cfg = M.MoeConfig(dtype=torch.bfloat16, **sizes)
        p = M.init_params(cfg, seed=3, device=card)["layers"][0]
        y = y0.to(card, torch.bfloat16).requires_grad_(True)
        out = M._moe_mlp(y, p, cfg)
        runs.append([out, *torch.autograd.grad(out.float().square().sum(),
                                               [y, p["gate"], p["moe_up"], p["moe_down"]])])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    cfg = M.MoeConfig(dtype=torch.float32, **sizes)
    params = M.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, 512, (1, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = M.forward(params, ids, cfg)
        got = M.forward(_tree_to(params, card), ids.to(card), cfg).cpu()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _q8_inputs(rows, cols, dtype, card):
    """x [rows, cols] with exact .5 ties of x / scale among its values
    (x = (j + 0.5) * scale where the fp32 product divides back exactly)."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = (torch.randn(rows, cols, generator=gen, device=card) * 3).to(dtype)
    amax = x.float().abs().max()
    scale = (amax + 1e-6) / torch.full_like(amax, 127.0)
    ties = ((torch.arange(-20, 20, device=card, dtype=torch.float32) + 0.5) * scale).to(dtype)
    r = ties.float() / scale
    ties = ties[r - r.floor() == 0.5][: x.numel()]
    x.view(-1)[: ties.numel()] = ties
    return x


def _q8_launches(kernels):
    """The launch counts a list of quantize kernels adds."""
    counts = dict.fromkeys(K.LAUNCHES, 0)
    for kernel in kernels:
        counts[K.Q8_KERNELS[kernel][1]] += 1
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cols", [
    (2048, 2048), (2048, 5504), (2048, 4096), (2048, 11008), (5504, 2048), (2048, 32000),
    (21, 100), (64, 8), (130, 70), (1, 9), (17, 32), (16, 16), (48, 16), (80, 272),
])
def test_q8_kernels_are_bit_identical_to_their_plain_versions(card, dtype, rows, cols):
    """amax and every quantize order (row-major, column-major, both from
    one read) equal their plain versions bit for bit (true IEEE division,
    round half to even), at the int8 row's shapes, at aligned shapes with
    partial tiles, and at ragged and misaligned ones; each wrapper
    launches the kernels :func:`q8_route` names, once each."""
    x = _q8_inputs(rows, cols, dtype, card)
    # the same values at offsets that are not 16-byte aligned (and, for
    # fp32, one that is)
    views = [x]
    for offset in (1, 4):
        buf = torch.empty(rows * cols + offset, dtype=dtype, device=card)
        views.append(buf[offset:].view(rows, cols))
        views[-1].copy_(x)
    for t in views:
        amax_ref = K.q8_amax_plain(t)
        K.reset_launch_counts()
        amax = K.q8_amax(t)
        assert K.launch_counts() == {**_q8_launches([]), "q8_amax": 1}
        assert amax.dtype == torch.float32 and torch.equal(amax, amax_ref)
        q_ref, scale_ref = K.q8_quantize_plain(t, amax_ref)
        for column_major, both in ((False, False), (True, False), (False, True)):
            K.reset_launch_counts()
            out = K.q8_quantize(t, amax, column_major=column_major, both=both)
            route = K.q8_route(rows, cols, dtype, t.data_ptr(), column_major, both)
            assert K.launch_counts() == _q8_launches(route), route
            qs, scale = (out[:2], out[2]) if both else ((out[0],), out[1])
            orders = (False, True) if both else (column_major,)
            for c, q in zip(orders, qs):
                assert q.dtype == torch.int8 and q.shape == (rows, cols)
                assert q.stride() == ((1, rows) if c else (cols, 1)) or rows == 1 or cols == 1
                assert torch.equal(q, q_ref), (route, c, int((q != q_ref).sum()))
            assert torch.equal(scale, scale_ref)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("both", [False, True])
def test_q8_tma_kernels_replay_from_a_cuda_graph(card, both):
    """The TMA quantize kernels allocate and synchronise nothing: a
    capture of amax and quantize replays on new values of the same input
    buffer, bit for bit as the plain versions."""
    x = _q8_inputs(256, 384, torch.bfloat16, card)
    assert K.q8_route(256, 384, x.dtype, x.data_ptr(), True, both)[0].endswith("_tma_kernel")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K.q8_quantize(x, K.q8_amax(x), column_major=True, both=both)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.q8_quantize(x, K.q8_amax(x), column_major=True, both=both)
    for seed in (1, 2):
        gen = torch.Generator(device=card).manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=gen, device=card) * seed)
        graph.replay()
        torch.cuda.synchronize()
        ref = K.q8_quantize_plain(x, K.q8_amax_plain(x), column_major=True, both=both)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.cuda
def test_q8_wrappers_raise_for_what_the_kernels_refuse(card):
    x = torch.ones(8, 16, device=card)
    amax = K.q8_amax(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.q8_amax(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        K.q8_amax(x.t())
    with pytest.raises(ValueError, match="2-D"):
        K.q8_quantize(x.view(-1), amax)
    with pytest.raises(ValueError, match="float32 scalar"):
        K.q8_quantize(x, amax.view(1))


def _row_step_case(kind):
    from simumax_tpu_torch.torchref import rows

    mc = rows.build_model(kind)
    return mc, dict(kind=kind, seq_len=256, batch_size=1, layers=2, remat=kind == "remat")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "remat", "flash", "int8", "moe"])
def test_captured_row_step_takes_the_eager_steps(card, kind):
    """A row's step (2 layers, seq 256) replayed from a CUDA graph gives,
    step by step, the losses of the same steps run eagerly from the same
    seed: equal bit for bit (the captured launches are the eager ones,
    on the same cuBLAS algorithms). Each replay counts the CUDA kernels
    it runs; the capture counts none."""
    from simumax_tpu_torch.calibration.timing import time_captured_step, time_stateful
    from simumax_tpu_torch.torchref import rows

    mc, case = _row_step_case(kind)
    model_kind = "dense" if kind == "remat" else kind
    step = rows.make_row_step(model_kind, mc, case["seq_len"], case["batch_size"],
                              case["layers"], case["remat"], device=card)
    eager = []
    time_stateful(lambda: eager.append(step().clone()), warmup=2, iters=3)
    del step
    step = rows.make_row_step(model_kind, mc, case["seq_len"], case["batch_size"],
                              case["layers"], case["remat"], device=card)
    K.reset_launch_counts()
    seconds, losses = time_captured_step(step, warmup=2, iters=3)
    counts = K.launch_counts()
    assert seconds > 0 and losses.shape == (5,)
    assert torch.equal(losses, torch.stack(eager)), (losses.tolist(), eager)
    per_step = {"flash": {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2},
                # 4 linear layers a layer and the LM head, 5 quantizes
                # each: x row-major and w column-major forward, g in both
                # orders from one read, w row-major and x column-major
                # backward
                "int8": {"q8_amax": 5 * 9, "q8_quantize": 2 * 9, "q8_quantize_cols_tma": 2 * 9,
                         "q8_quantize_both_tma": 9}}.get(kind, {})
    assert counts == {k: 5 * per_step.get(k, 0) for k in counts}


@pytest.mark.cuda
def test_a_step_that_reads_the_host_fails_to_capture_and_is_not_timed(card):
    from simumax_tpu_torch.calibration.timing import time_captured_step

    x = torch.ones(4, device=card)
    with pytest.raises(RuntimeError):
        time_captured_step(lambda: x.mul_(float(x.sum())), warmup=1, iters=2)


# -- the batched scenario replay ------------------------------------------------


def _replay_groups(cell_key, card_backend=True):
    """A cell's estimate, and every family group the batched replay
    solved in a lockstep walk of seeded scenarios on the card:
    [(family, program, [(sub-scenario, fault model)], raw makespans)]."""
    from simumax_tpu_torch import PerfLLM
    from simumax_tpu_torch.core.config import get_model_config, get_strategy_config
    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import CELLS, SYNC_CELL, build_perf, mixed, sampled

    cell = SYNC_CELL if cell_key == "dense-pp2-sync" else CELLS[cell_key]
    perf = build_perf(PerfLLM, get_model_config, get_strategy_config, **cell)
    h = perf.simulate(None, world_ranks=True, granularity="chunk",
                      track_memory=False)["end_time_ms"]
    groups = []
    ctx = tf.ReplayContext(perf, options=tf.ReplayOptions(replay_backend="cuda"))
    orig = ctx._solve_groups

    def solve_groups(grp, outs):
        for fam, prog, members in grp.values():
            models = [m for _it, m in members]
            before = K.launch_counts()["replay_solve"]
            raws = br.solve_batch(prog, models)
            assert K.launch_counts()["replay_solve"] == before + 1
            groups.append((fam, prog, [(it[1], m) for it, m in members], raws))
        return orig(grp, outs)

    ctx._solve_groups = solve_groups
    scs = sampled(tf.sample_scenario, cell_key, perf.strategy.world_size, h, n=4) + [
        mixed(tf.FaultEvent, tf.FaultScenario, h, death=False)]
    tf._predict_goodput_batch(ctx, [(s, tf.CheckpointSpec(interval_steps=2)) for s in scs])
    return ctx, groups


@pytest.mark.cuda
@pytest.mark.parametrize("cell_key", ["dense-pp2", "moe-pp4", "mla-pp2", "dense-pp2-sync"])
def test_replay_kernel_is_bit_identical_to_its_plain_version(card, cell_key):
    """Every family group a walk of seeded scenarios hands the kernel,
    and every lowered family with all its scenarios in one batch: the
    kernel's makespans == the plain version's == the scalar engine's."""
    from simumax_tpu_torch.simulator import batched_replay as br

    ctx, groups = _replay_groups(cell_key)
    assert groups
    by_prog = {}
    for fam, prog, members, raws in groups:
        plain = br.replay_solve_plain(br.pack_batch(prog, [m for _s, m in members], "cpu"))
        assert raws.tolist() == plain.tolist(), (cell_key, prog.n_ops)
        for (sub, _m), raw in zip(members, raws):
            assert raw == ctx._replay(sub, fam)[2]
        by_prog.setdefault(id(prog), (prog, []))[1].extend(m for _s, m in members)
    for prog, models in by_prog.values():
        got = K.replay_solve(br.pack_batch(prog, models, card)).cpu()
        want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu"))
        assert got.tolist() == want.tolist(), (cell_key, prog.n_ops, len(models))


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", [1, 15000])  # the value slots in shared memory / in scratch
def test_replay_kernel_takes_every_op_kind_and_fault(card, repeat):
    """A family with every lowered op kind (async chains, send_sync,
    wait_comm, both advances) under overlapping slowdowns, preemptions
    and scoped and unscoped link windows, in one batch: the kernel ==
    the plain version. At 15000 repeats the op table (30k ops) holds
    more value slots than a block's shared memory."""
    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import synthetic_family, synthetic_models

    streams, plan = synthetic_family(repeat)
    prog = br.lower_family(streams, plan)
    models = synthetic_models(tf, plan)
    if repeat > 1:  # keep the plain version's loop short: no slowdown on class 0
        models = [m for m in models if 0 not in m._slow]
    assert (prog.n_ops + 1) * 8 > K._REPLAY_SMEM_MAX or repeat == 1
    K.reset_launch_counts()
    got = K.replay_solve(br.pack_batch(prog, models, card)).cpu()
    assert K.launch_counts()["replay_solve"] == 1
    want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu"))
    assert got.tolist() == want.tolist()
    if repeat == 1:  # the faults move the makespan (the long chain absorbs them)
        assert len(set(want.tolist())) > 2


@pytest.mark.cuda
def test_replay_kernel_takes_a_level_wider_than_its_block(card):
    """1100 classes: 1100 independent compute ops, a collective over all
    of them (a warp's masked max over 35 mask words), 1100 more. A level
    holds more ops than the block's 1024 threads; the kernel, through
    the family's memoised tables and its packed scenarios, == the plain
    version == the scalar engine."""
    import types

    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from simumax_tpu_torch.simulator.engine import ReplayProc, SimuEngine
    from torch_fault_cells import synthetic_models

    k = 1100
    streams = [[("compute", 1.0 + c / 1024, "a", "c"),
                ("collective", "x:tp", 0.5, "ar", list(range(k))),
                ("compute", 0.25 * (c % 3), "b", "c")] for c in range(k)]
    plan = types.SimpleNamespace(n_classes=k, reps=tuple(range(k)))
    prog = br.lower_family(streams, plan)
    models = synthetic_models(tf, plan)
    tables = br.replay_tables(prog, card)
    assert tables.max_width == k and tables.threads == 1024 and tables.n_steps == 3
    K.reset_launch_counts()
    got = br.solve_batch(prog, models)
    assert K.launch_counts()["replay_solve"] == 1
    want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu")).tolist()
    assert got.tolist() == want
    for m, raw in zip(models, want):
        eng = SimuEngine(k, drop_events=True)
        for i in range(k):
            eng.add_rank(i, ReplayProc(streams[i]))
        eng._fault = m
        eng.run_incremental()
        assert raw == max(eng.clock)


@pytest.mark.cuda
def test_replay_kernel_takes_a_batch_of_264(card):
    """The largest family a walk of the MoE cell lowers, under 264
    scenarios (the walk's, repeated): two blocks on every SM of the card,
    every makespan == the plain version's."""
    from simumax_tpu_torch.simulator import batched_replay as br

    _ctx, groups = _replay_groups("moe-pp4")
    by_prog = {}
    for _fam, prog, members, _raws in groups:
        by_prog.setdefault(id(prog), (prog, []))[1].extend(m for _s, m in members)
    prog, models = max(by_prog.values(), key=lambda pm: (pm[0].n_ops, len(pm[1])))
    models = [models[j % len(models)] for j in range(264)]
    got = br.solve_batch(prog, models)
    want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu"))
    assert len(got) == 264 and got.tolist() == want.tolist()


@pytest.mark.cuda
def test_analyze_faults_on_the_card_equals_the_scalar_engine_with_two_jobs(card):
    """``replay_backend="cuda"`` equals ``"numpy"``; with CUDA initialised
    the two-worker pool spawns its workers and gives the serial result."""
    import json

    from simumax_tpu_torch import PerfLLM
    from simumax_tpu_torch.core.config import get_model_config, get_strategy_config
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import CELLS, build_perf

    perf = build_perf(PerfLLM, get_model_config, get_strategy_config, **CELLS["dense-pp2"])
    kw = dict(n_scenarios=4, seed=2, horizon_steps=6, spec=tf.CheckpointSpec(interval_steps=3))
    K.reset_launch_counts()
    on_card = perf.analyze_faults(options=tf.ReplayOptions(replay_backend="cuda"), **kw)
    assert K.launch_counts()["replay_solve"] > 0 and torch.cuda.is_initialized()
    assert tf._mc_context().get_start_method() == "spawn"
    two = perf.analyze_faults(jobs=2, options=tf.ReplayOptions(replay_backend="cuda"), **kw)
    scalar = perf.analyze_faults(options=tf.ReplayOptions(replay_backend="numpy"), **kw)
    dump = [json.dumps(x, sort_keys=True) for x in (on_card, two, scalar)]
    assert dump[0] == dump[1] == dump[2]


@pytest.mark.cuda
def test_replay_wrapper_raises_for_what_the_kernel_refuses(card):
    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import synthetic_family, synthetic_models

    streams, plan = synthetic_family()
    prog = br.lower_family(streams, plan)
    rb = br.pack_batch(prog, synthetic_models(tf, plan), card)
    with pytest.raises(ValueError, match="must be contiguous"):
        K.replay_solve(dataclasses_replace(rb, dur=rb.dur.float()))
    with pytest.raises(ValueError, match="is on cpu"):
        K.replay_solve(dataclasses_replace(rb, kind=rb.kind.cpu()))


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)

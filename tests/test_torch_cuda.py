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
"""

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
                                 "swiglu_fwd": 0, "swiglu_bwd": 0}
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
                      "swiglu_fwd": 2, "swiglu_bwd": 2}
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
    q = {name: Q._q8(t.reshape(-1, t.shape[-1]))[0] for name, t in (("x", x), ("w", w), ("g", g))}
    for a, b, ta, tb in (("x", "w", False, False), ("g", "w", False, True),
                         ("x", "g", True, False)):
        ref = Q._mm(q[a], q[b], ta=ta, tb=tb)
        got = Q._mm(q[a].to(card), q[b].to(card), ta=ta, tb=tb)
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

    assert torch.equal(Q._mm(ones(17, 8), ones(8, 8)).cpu(), torch.full((17, 8), 8))
    for a, b in ((ones(16, 8), ones(8, 8)), (ones(32, 12), ones(12, 8)),
                 (ones(32, 8), ones(8, 12))):
        with pytest.raises(ValueError, match="more than 16 rows"):
            Q._mm(a, b)
        with pytest.raises(RuntimeError, match="greater than"):
            torch._int_mm(a, b)
    with pytest.raises(RuntimeError, match="dimension 2"):
        torch._int_mm(ones(2, 32, 8), ones(8, 8))

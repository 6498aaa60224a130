"""The CUDA flash kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one; the file
imports no jax, so it also runs on a machine with only PyTorch:
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance, element by element: |kernel - plain| <= rtol * (|plain| +
rms(plain)), rtol 2^-7 for bf16 outputs (the two may round one bf16 ulp
apart) and 1e-4 for fp32 outputs (summation order only).
"""

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch.torchref import kernels as K  # noqa: E402


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
    assert K.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for (g, r), tol in zip([(lse, lse_ref)] + list(zip(got, ref)), [1e-4] + [rtol] * 4):
        g, r = g.float(), r.float()
        limit = tol * (r.abs() + r.square().mean().sqrt())
        assert bool(((g - r).abs() <= limit).all())


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

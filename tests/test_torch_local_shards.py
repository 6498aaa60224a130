"""The kernels' wrappers on what a rank of the dp x tp step hands them.

The sharded step (``torchref/model.py``, ``mesh=`` given) runs RoPE on
a strided head slice of the fused qkv columns
(``q.reshape(b, s, H, d)[:, :, t*hl:(t+1)*hl]``, its last dim contiguous)
and the step-mode SwiGLU on a rank's gate and val blocks put side by
side (``[gate_t | val_t]``). At tp 2 and 4 each rank's output and its
gradient equal the plain version of the whole tensor, sliced, bit for
bit: on the CPU (the wrappers' plain versions) and, marked ``cuda``, on
the card (the kernels). The norm of a rank's rows hands back its
weight's gradient as a partial sum over every axis that splits the rows.
"""

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch.torchref import kernels as K  # noqa: E402
from simumax_tpu_torch.torchref import model as T  # noqa: E402
from simumax_tpu_torch.torchref import parallel as P  # noqa: E402

#: (device, dtype): the CPU in bf16, the card in both. ATen's CPU silu and
#: its backward round fp32 by where an element lies in the loop (a
#: vectorized body or a scalar tail), so the plain version of the whole
#: tensor and of a slice differ there by a few ulps; on the card the kernel
#: and ATen's functor are elementwise
CASES = [pytest.param("cpu", torch.bfloat16, id="cpu-bf16"),
         pytest.param("cuda", torch.bfloat16, id="cuda-bf16", marks=pytest.mark.cuda),
         pytest.param("cuda", torch.float32, id="cuda-fp32", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("device,dtype", CASES)
def test_swiglu_step_on_a_ranks_columns_is_the_whole_sliced(tp, device, dtype):
    dev = _device(device)
    b, s, f = 2, 24, 64
    gen = torch.Generator().manual_seed(tp)
    up = torch.randn(b, s, 2 * f, generator=gen).to(dev, dtype)
    dy = torch.randn(b, s, f, generator=gen).to(dev, dtype)
    whole = K.swiglu_step_fwd_plain(up)
    dwhole = K.swiglu_step_bwd_plain(up, dy)
    fl = f // tp
    for t in range(tp):
        cols = list(range(t * fl, (t + 1) * fl))
        both = cols + [f + c for c in cols]
        local = up[..., both].requires_grad_(True)  # [gate_t | val_t], as the step copies it
        act = K.swiglu_step(local)
        assert torch.equal(act, whole[..., cols])
        (d,) = torch.autograd.grad(act, local, dy[..., cols].contiguous())
        assert torch.equal(d, dwhole[..., both])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("device,dtype", CASES + [pytest.param("cpu", torch.float32,
                                                               id="cpu-fp32")])
def test_rope_on_a_ranks_heads_is_the_whole_sliced(tp, device, dtype):
    dev = _device(device)
    b, s, H, d = 2, 24, 8, 32
    gen = torch.Generator().manual_seed(tp)
    qkv = torch.randn(b, s, 3 * H * d, generator=gen).to(dev, dtype).requires_grad_(True)
    dy = torch.randn(b, s, H // tp, d, generator=gen).to(dev, dtype)
    q = qkv[..., :H * d].reshape(b, s, H, d)
    whole = K.rope_fwd_plain(q.detach(), 10000.0)
    hl = H // tp
    for t in range(tp):
        view = q[:, :, t * hl:(t + 1) * hl]  # strided: the rank's heads of the fused columns
        assert view.stride(-1) == 1 and not view.is_contiguous()
        out = K.rope(view, 10000.0)
        assert torch.equal(out, whole[:, :, t * hl:(t + 1) * hl])
        (dq,) = torch.autograd.grad(out, qkv, dy)
        ref = torch.zeros_like(qkv).reshape(b, s, 3 * H, d)
        ref[:, :, t * hl:(t + 1) * hl] = K.rope_bwd_plain(dy, 10000.0)
        assert torch.equal(dq, ref.reshape(b, s, 3 * H * d))


def test_sharded_norm_weight_gradient_is_a_partial_sum_over_split_rows():
    """The norm weight's gradient placements follow the rows: a partial
    sum over an axis that splits them, replicated over one that does
    not."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with P.process_group("cpu"):
        mesh = T.make_mesh(1, tp=1, device="cpu")
        for placements, want in (((Shard(0), Shard(1)), (Partial(), Partial())),
                                 ((Replicate(), Replicate()), (Replicate(), Replicate())),
                                 ((Shard(0), Replicate()), (Partial(), Replicate()))):
            x = DTensor.from_local(torch.randn(2, 32, 16, dtype=torch.bfloat16), mesh,
                                   placements, run_check=False).requires_grad_(True)
            w = DTensor.from_local(torch.ones(16, dtype=torch.bfloat16), mesh,
                                   (Replicate(), Replicate()), run_check=False)
            w.requires_grad_(True)
            _s, y = T._sharded_norm(x, w)
            assert tuple(y.placements) == placements
            (dw,) = torch.autograd.grad(y.to_local().float().sum(), w)
            assert tuple(dw.placements) == want

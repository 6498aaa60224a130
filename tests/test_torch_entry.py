"""The port's entry points (``simumax_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.py``.

``entry()`` on the CPU gives the JAX forward's logits from the JAX
parameters carried over: their cross entropy against the ids within
2e-3 (``tests/test_torch_model.py``'s bf16 loss tolerance), every logit
within 2% of the largest (bf16 through 4 layers: the two frameworks
round at other points). ``dryrun_multichip(8, device="cpu")`` runs its
three passes on 8 gloo ranks and prints the JAX function's lines (at n =
8 the JAX function prints the same layouts; its losses differ, its
parameters being ``jax.random``'s). Where the JAX functions go on on CPU
devices, the port's entry points raise without enough cards.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__ as G  # noqa: E402
from simumax_tpu_torch import entry as E  # noqa: E402
from simumax_tpu_torch.core.errors import CardRequiredError  # noqa: E402
from simumax_tpu_torch.torchref import model as M  # noqa: E402

#: the JAX function's lines at n = 8, losses aside
JAX_LINES_8 = [
    "dryrun_multichip: mesh dp=4 x tp=2 (sp=on, fsdp=on) step ok, loss=",
    "dryrun_multichip: manual spmd pp=2 x ep=2 x tp=2 x dp=1 (sp=on, ep_dispatch=a2a) step ok, "
    "loss=",
    "dryrun_multichip: cp=4 x dp=2 (ring attention) step ok, loss=",
    "dryrun_multichip: cp=4 x dp=2 (ulysses attention) step ok, loss=",
]


def _cross_entropy(logits, ids):
    logp = torch.log_softmax(torch.as_tensor(logits, dtype=torch.float32), -1)
    return float(-logp.gather(-1, torch.as_tensor(np.asarray(ids)).long()[..., None]).mean())


def test_entry_forward_matches_jax():
    fn_ref, (jparams, jids) = G.entry()
    ref = np.asarray(jax.jit(fn_ref)(jparams, jids).astype(jnp.float32))
    fn, (params, ids) = E.entry(device="cpu")
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert [p.shape for p in M.param_leaves(params)] == [
        tuple(a.shape) for a in jax.tree.leaves(jparams)]
    carried = M.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                                device="cpu")
    with torch.no_grad():
        out = fn(carried, ids).float().numpy()
    assert out.shape == ref.shape == (2, 256, 2048)
    assert np.abs(out - ref).max() <= 0.02 * np.abs(ref).max()
    assert _cross_entropy(out, jids) == pytest.approx(_cross_entropy(ref, jids), rel=2e-3)


def test_dryrun_multichip_runs_three_passes_on_cpu_ranks(capsys):
    losses = E.dryrun_multichip(8, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4, lines
    for line, want, key in zip(lines, JAX_LINES_8, ("dp_tp", "manual", "ring", "ulysses")):
        assert line.startswith(want), line
        assert float(line[len(want):]) == pytest.approx(losses[key], abs=1e-4)
    assert all(np.isfinite(v) for v in losses.values())
    # the two cp mechanisms compute the same attention
    assert losses["ring"] == pytest.approx(losses["ulysses"], rel=1e-2)


def test_dryrun_multichip_on_one_rank_skips_context_parallelism(capsys):
    losses = E.dryrun_multichip(1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert set(losses) == {"dp_tp", "manual"}
    assert re.fullmatch(r"dryrun_multichip: mesh dp=1 x tp=1 \(sp=off, fsdp=on\) step ok, "
                        r"loss=\d+\.\d{4}", lines[0])
    assert lines[1].startswith("dryrun_multichip: manual spmd pp=1 x ep=1 x tp=1 x dp=1 "
                               "(sp=on, ep_dispatch=psum)")


@pytest.mark.parametrize("n, want", [
    (8, dict(tp=2, dp=4, pp=2, ep=2, tp2=2, dp2=1, cp=4)),
    (6, dict(tp=2, dp=3, pp=1, ep=1, tp2=2, dp2=3, cp=2)),
    (4, dict(tp=2, dp=2, pp=2, ep=1, tp2=2, dp2=1, cp=4)),
    (1, dict(tp=1, dp=1, pp=1, ep=1, tp2=1, dp2=1, cp=1)),
])
def test_layouts_follow_the_jax_rules(n, want):
    assert E.layouts(n) == want


def test_nothing_goes_on_on_the_cpu_when_the_card_is_asked_for(monkeypatch):
    """Where JAX's ``make_mesh`` / ``make_cp_mesh`` / ``dryrun_multichip``
    quietly take CPU devices, the port's raise without enough cards; so
    does ``memory_report``, which measures on the card only."""
    from simumax_tpu_torch.calibration import validate
    from simumax_tpu_torch.torchref import context_parallel as CP
    from simumax_tpu_torch.torchref.rows import build_bench_model

    with pytest.raises(CardRequiredError, match="the CUDA card"):
        validate.memory_report(build_bench_model(), 1, 128, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (lambda: E.dryrun_multichip(8), lambda: E.dryrun_multichip(1),
                 lambda: M.make_mesh(8, tp=2), lambda: CP.make_cp_mesh(8, 4)):
        with pytest.raises(CardRequiredError, match="CUDA cards"):
            call()
    for call in (lambda: E.entry(), lambda: validate.memory_report(build_bench_model())):
        with pytest.raises(CardRequiredError, match="no CUDA device"):
            call()

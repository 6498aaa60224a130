"""``portbench/seq_fault.py``'s partial-batch fault at a tiny size on the
CPU, where a batch holds one sequence: ``faults.half_batch`` keeps the
whole batch there, and ``half_seq``, which leaves out half of each
sequence's tokens, is caught in every cell."""

import pytest

torch = pytest.importorskip("torch")

from portbench import faults, run, seq_fault  # noqa: E402
from portbench.tests.tiny import CELLS, tiny_spec  # noqa: E402


def _seen(wrap, ids, targets):
    seen = []

    def step(params, opt_state, batch):
        seen.append(batch)
        return params, opt_state, torch.zeros(())

    wrap(step)(None, None, (ids, targets))
    return seen[0]


def test_at_one_sequence_half_batch_keeps_the_batch_and_half_seq_halves_it():
    ids = torch.arange(128).reshape(1, 128)
    kept = _seen(faults.half_batch, ids, ids + 1)
    assert torch.equal(kept[0], ids) and torch.equal(kept[1], ids + 1)
    cut = _seen(seq_fault.half_seq, ids, ids + 1)
    assert torch.equal(cut[0], ids[:, :64]) and torch.equal(cut[1], ids[:, 1:65])


@pytest.mark.parametrize("workload", CELLS)
def test_half_seq_is_caught_at_one_sequence_a_batch(workload):
    """The sound run at the same size and seed is correct; the fault is
    not."""
    spec = tiny_spec(workload, seq=128, mbs=1)
    sound = run.run_cell(spec, 7, 0.1, False, device="cpu")
    assert sound["correct"], sound["compared"]
    result = run.run_cell(spec, 7, 0.1, False, device="cpu", wrap_step=seq_fault.half_seq)
    assert not result["correct"], result["compared"]

"""Faults planted under the timed path, to show that the comparison
catches them. Each wraps the program's ``train_step``; nothing in a
benchmark run uses them.

* ``unchanged``: the step runs, then its parameters and optimizer state
  are put back as they were (kept meanwhile in host memory, which holds
  a full-size cell's state beside the card's): a step that returns its
  state unchanged;
* ``half_batch``: the step sees only the first half of the batch's rows,
  its loss the mean over those.

A training cell on one chip has no exchange between chips and produces
no token, so these are the faults it can have.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def unchanged(step: Callable) -> Callable:
    def faulty(params, opt_state, batch):
        state = _leaves(params) + _leaves(opt_state)
        saved = [t.detach().to("cpu", copy=True) for t in state]
        _p, _o, loss = step(params, opt_state, batch)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        return params, opt_state, loss

    return faulty


def half_batch(step: Callable) -> Callable:
    def faulty(params, opt_state, batch):
        ids, targets = batch
        half = max(1, ids.shape[0] // 2)
        return step(params, opt_state, (ids[:half], targets[:half]))

    return faulty


FAULTS: Dict[str, Callable[[Callable], Callable]] = {"unchanged": unchanged,
                                                      "half_batch": half_batch}

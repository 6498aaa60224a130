"""The comparison that decides ``correct``: the program's first steps
against the plain reference's.

Each number named in the cell file's ``limits`` is held to its limit
there; a run prints the others too:

* ``loss_gap``: the largest relative gap between the two sides' losses
  over the compared steps;
* ``grad1_gap``: the first step's gradient, by its worst leaf: the gap
  between the two sides' norms of that leaf's gradient, over the larger of
  the reference's norm of the leaf and the reference's median leaf norm
  (the program's gradient as its optimizer got it: the first moment after
  one step over ``1 - b1``);
* ``change_gap``: the parameters' change after the compared steps, by the
  worst leaf, measured alike.

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

NUMBERS = ("loss_gap", "grad1_gap", "change_gap")


def _worst_leaf(prog: Dict, ref: Dict, leaves) -> Tuple[float, object]:
    """(the largest gap of norms over ``leaves``, its leaf)."""
    median = statistics.median(ref[leaf] for leaf in leaves)

    def gap(leaf) -> float:
        diff, base = abs(prog[leaf] - ref[leaf]), max(ref[leaf], median)
        if not math.isfinite(diff):
            return math.inf
        if base == 0:
            return 0.0 if diff == 0 else math.inf
        return diff / base

    where = max(leaves, key=gap)
    return gap(where), where


def numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """{name: {"value", "leaf"}} of :data:`NUMBERS`, from two sides'
    readings ({"loss": [...], "grad1": {leaf: norm}, "change": {leaf: norm}})."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    sound = len(prog["loss"]) == len(ref["loss"]) and all(math.isfinite(g) for g in gaps)
    loss_gap = max(gaps) if sound else math.inf
    grad1, grad1_leaf = _worst_leaf(prog["grad1"], ref["grad1"], list(ref["grad1"]))
    change, change_leaf = _worst_leaf(prog["change"], ref["change"], list(ref["change"]))
    return {"loss_gap": {"value": loss_gap, "leaf": None},
            "grad1_gap": {"value": grad1, "leaf": grad1_leaf},
            "change_gap": {"value": change, "leaf": change_leaf}}


def judge(found: Dict[str, Dict], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {name: {"value", "limit"}} of the numbers ``limits``
    names): correct when each is finite and at most its limit."""
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"limits must name some of {NUMBERS}, got {sorted(limits)}")
    compared = {name: {"value": found[name]["value"], "limit": limits[name]}
                for name in NUMBERS if name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared

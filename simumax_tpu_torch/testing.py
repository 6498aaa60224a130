"""Golden-comparison helpers (reference ``simumax/testing/base_test_tool.py``:
``RelDiffComparator`` + recursive ``ResultCheck``)."""

from __future__ import annotations

from typing import Any, List


class RelDiffComparator:
    """Relative-error comparator for scalars."""

    def __init__(self, rtol: float = 1e-3, atol: float = 1e-9):
        self.rtol = rtol
        self.atol = atol

    def check(self, got: float, expect: float) -> bool:
        if expect == got:
            return True
        denom = max(abs(expect), self.atol)
        return abs(got - expect) <= self.rtol * denom + self.atol


class ResultCheck:
    """Recursively compare nested result dicts/lists within rtol
    (reference ``base_test_tool.py:48-79``); collects every mismatch
    path instead of failing on the first."""

    def __init__(self, rtol: float = 1e-3, ignore_keys: tuple = ()):
        self.cmp = RelDiffComparator(rtol)
        self.ignore_keys = set(ignore_keys)
        self.mismatches: List[str] = []

    def check(self, got: Any, expect: Any, path: str = "$") -> bool:
        if isinstance(expect, dict):
            if not isinstance(got, dict):
                self.mismatches.append(f"{path}: type {type(got).__name__} != dict")
                return False
            for k, ev in expect.items():
                if k in self.ignore_keys:
                    continue
                if k not in got:
                    self.mismatches.append(f"{path}.{k}: missing")
                    continue
                self.check(got[k], ev, f"{path}.{k}")
        elif isinstance(expect, (list, tuple)):
            if len(got) != len(expect):
                self.mismatches.append(
                    f"{path}: length {len(got)} != {len(expect)}"
                )
                return False
            for i, (g, e) in enumerate(zip(got, expect)):
                self.check(g, e, f"{path}[{i}]")
        elif isinstance(expect, bool) or expect is None or isinstance(expect, str):
            if got != expect:
                self.mismatches.append(f"{path}: {got!r} != {expect!r}")
        elif isinstance(expect, (int, float)):
            if not self.cmp.check(float(got), float(expect)):
                self.mismatches.append(f"{path}: {got} != {expect}")
        else:
            if got != expect:
                self.mismatches.append(f"{path}: {got!r} != {expect!r}")
        return not self.mismatches

    def report(self) -> str:
        return "\n".join(self.mismatches)

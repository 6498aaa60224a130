"""Shape/dtype-only fake tensors (L1).

Reference: ``simumax/core/tensor.py:14-143`` (``TensorSize``). Ours is a
lighter immutable spec — the symbolic forward only needs shapes, dtypes and
byte math; graph edges are recorded by the module framework, not the
tensor.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Tuple

from simumax_tpu_torch.core.config import dtype_to_bytes

_ids = itertools.count()


@dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: str = "bf16"
    uid: int = field(default_factory=lambda: next(_ids), compare=False)

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))

    # -- byte math ---------------------------------------------------------
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def element_size(self) -> float:
        return dtype_to_bytes(self.dtype)

    @property
    def bytes(self) -> float:
        return self.numel() * self.element_size()

    # -- shape algebra -----------------------------------------------------
    def with_shape(self, *shape: int) -> "TensorSpec":
        return TensorSpec(tuple(shape), self.dtype)

    def with_dtype(self, dtype: str) -> "TensorSpec":
        return TensorSpec(self.shape, dtype)

    def view(self, *shape: int) -> "TensorSpec":
        shape = tuple(shape)
        neg = [i for i, d in enumerate(shape) if d == -1]
        assert len(neg) <= 1
        if neg:
            known = 1
            for d in shape:
                if d != -1:
                    known *= d
            shape = tuple(self.numel() // known if d == -1 else d for d in shape)
        assert self.numel() == TensorSpec(shape, self.dtype).numel(), (
            f"view {self.shape} -> {shape}"
        )
        return TensorSpec(shape, self.dtype)

    def transpose(self, i: int, j: int) -> "TensorSpec":
        s = list(self.shape)
        s[i], s[j] = s[j], s[i]
        return TensorSpec(tuple(s), self.dtype)

    def split_dim(self, dim: int, factor: int) -> "TensorSpec":
        s = list(self.shape)
        assert s[dim] % factor == 0, (self.shape, dim, factor)
        s[dim] //= factor
        return TensorSpec(tuple(s), self.dtype)

    def scale_dim(self, dim: int, factor: int) -> "TensorSpec":
        s = list(self.shape)
        s[dim] *= factor
        return TensorSpec(tuple(s), self.dtype)

    def __repr__(self):
        return f"TensorSpec({list(self.shape)}, {self.dtype})"

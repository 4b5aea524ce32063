"""Minimal value-type system describing action spaces.

The reference leans on ``gym3.types`` (DictType / TensorType / Discrete / Real)
purely as shape-and-cardinality metadata for building action heads
(reference: lib/action_head.py:263-275).  gym3 is not a dependency here, so we
define the same small algebra.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Discrete:
    """Integer element type with n possible values."""

    n: int


@dataclasses.dataclass(frozen=True)
class Real:
    """Continuous scalar element type."""


@dataclasses.dataclass(frozen=True)
class TensorType:
    """A tensor of identical elements."""

    shape: Tuple[int, ...]
    eltype: object

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))

    @property
    def size(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


class DictType:
    """An ordered mapping of names to value types."""

    def __init__(self, **kwargs):
        self._items = dict(kwargs)

    def items(self):
        return self._items.items()

    def keys(self):
        return self._items.keys()

    def values(self):
        return self._items.values()

    def __getitem__(self, k):
        return self._items[k]

    def __contains__(self, k):
        return k in self._items

    def __eq__(self, other):
        return isinstance(other, DictType) and self._items == other._items

    def __repr__(self):
        return f"DictType({self._items!r})"

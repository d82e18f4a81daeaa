"""Separator (elimination) tree.

The port's copy of `cholesky_tpu/symbolic/tree.py`: the maps the plan
uses (`heap_of`, `sep_of`, `sep_at`, `level_seps`), line for line.

Mirrors the reference's tree conventions exactly (build_separator_tree,
mmat.rg:835-849): separators are numbered 1..num_separators with the root
receiving the highest number; the tree is a complete binary heap where heap
index h (1-based, root h=1) holds node `num_separators - h + 1`, so
level(h) = floor(log2(h)) and parent(h) = h // 2.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class SeparatorTree:
    levels: int
    num_separators: int

    def __post_init__(self):
        if self.num_separators != (1 << self.levels) - 1:
            raise ValueError(
                f"complete binary separator tree requires 2^levels-1 separators; "
                f"got levels={self.levels}, num_separators={self.num_separators}")

    # -- node <-> heap-index maps ------------------------------------------
    def heap_of(self, sep: int) -> int:
        return self.num_separators - sep + 1

    def sep_of(self, heap: int) -> int:
        return self.num_separators - heap + 1

    def sep_at(self, level: int, slot: int) -> int:
        return self.sep_of((1 << level) + slot)

    def level_seps(self, level: int) -> List[int]:
        """Separators at `level` in slot order (node numbers descend —
        matching the reference's index-launch iteration order)."""
        return [self.sep_at(level, t) for t in range(1 << level)]

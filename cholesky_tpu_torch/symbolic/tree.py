"""Separator (elimination) tree.

The port's copy of `cholesky_tpu/symbolic/tree.py`: the maps the plan
uses (`heap_of`, `sep_of`, `sep_at`, `level_seps`) and those of the fill
analysis and debug log (`level_of`, `ancestors`, `ancestor_at`), line for
line.

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

    def level_of(self, sep: int) -> int:
        return int(self.heap_of(sep)).bit_length() - 1

    def sep_at(self, level: int, slot: int) -> int:
        return self.sep_of((1 << level) + slot)

    def level_seps(self, level: int) -> List[int]:
        """Separators at `level` in slot order (node numbers descend —
        matching the reference's index-launch iteration order)."""
        return [self.sep_at(level, t) for t in range(1 << level)]

    def ancestors(self, sep: int) -> List[int]:
        """Proper ancestors of `sep`, immediate parent first, root last
        (the order the reference walks par_idx//2 chains, mmat.rg:1265-1270)."""
        out = []
        h = self.heap_of(sep) // 2
        while h >= 1:
            out.append(self.sep_of(h))
            h //= 2
        return out

    def ancestor_at(self, sep: int, level: int) -> int:
        """The ancestor of `sep` living at `level` (level must be <= level_of(sep))."""
        h = self.heap_of(sep)
        shift = self.level_of(sep) - level
        if shift < 0:
            raise ValueError("ancestor level deeper than sep level")
        return self.sep_of(h >> shift)

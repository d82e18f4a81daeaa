"""The static solve plan — the central symbolic artifact.

The port's copy of `cholesky_tpu/symbolic/plan.py` (`SolvePlan`,
`build_plan`, `panel_shape`, `block_bounds`, `permute_matrix_dense`), kept
line for line so that both packages build identical plans.

The reference computes this information dynamically inside Legion tasks
(partition_matrix mmat.rg:300-362 for block bounds, build_separator_tree
mmat.rg:835, fill/cluster analysis mmat.rg:896-1028). Here the whole symbolic
phase runs on host, once, and produces a `SolvePlan`: permutation, per-level
padded shape buckets, and panel layout. The numeric phase (JAX) consumes only
this plan plus the assembled panel arrays — everything downstream is
statically shaped, which is what XLA/TPU require.

Panel layout
------------
Each separator `s` at tree level L owns a *panel*: the column block-row of the
permuted matrix holding its diagonal block plus every off-diagonal block
(a, s) for ancestors a of s (the blocks allocated by find_index_space_2d,
mmat.rg:741-767). Panels at a level are padded to a common bucket shape
[H(L), S(L)] and stacked into one [2^L, H(L), S(L)] array, so every numeric
phase is one batched kernel per level — the TPU-native replacement for the
reference's per-separator Legion index launches (mmat.rg:1240-1294).

Panel row layout for a sep at level L (ancestors ordered immediate parent
first, root last — the reference's par_idx//2 walk order):

    rows [0, S(L))                      : own (diagonal) block, lower triangle
    rows [row_off(L, lam), +S(lam))     : block (ancestor at level lam, s)

The permuted global layout matches the reference exactly: separator s
(1-based, root = num_separators) occupies global rows/cols
[offset(s), offset(s)+size(s)) with offset(s) = sum of sizes of separators
numbered below s. (partition_matrix packs the root at the bottom-right and
walks up, mmat.rg:315-339 — equivalent to ascending separator number from the
top-left, which is also verify.py:170-188's convention.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from cholesky_tpu_torch.io.ordering import ClusterHierarchy, Ordering
from cholesky_tpu_torch.symbolic.tree import SeparatorTree
from cholesky_tpu_torch.utils import round_up as _round_up


@dataclasses.dataclass
class SolvePlan:
    tree: SeparatorTree
    n: int                        # matrix dimension
    sep_sizes: np.ndarray         # [num_separators+1], index 0 unused
    perm: np.ndarray              # [n] permuted position -> original dof
    iperm: np.ndarray             # [n] original dof -> permuted position
    sep_offset: np.ndarray        # [num_separators+1] global diag offset of sep
    sep_of_dof: np.ndarray        # [n] original dof -> separator (1-based)
    loc_of_dof: np.ndarray        # [n] original dof -> local index within sep
    S: np.ndarray                 # [levels] padded separator width per level
    H: np.ndarray                 # [levels] padded panel height per level
    row_off: np.ndarray           # [levels, levels] row_off[L, lam]: row offset of
                                  # level-lam ancestor block inside a level-L panel
    u_off: np.ndarray             # [levels, levels] u_off[L, lam]: offset of the
                                  # level-lam range inside a level-L update matrix
    clusters: Optional[ClusterHierarchy] = None

    # ------------------------------------------------------------------
    @property
    def levels(self) -> int:
        return self.tree.levels

    @property
    def num_separators(self) -> int:
        return self.tree.num_separators

    def panel_shape(self, level: int) -> Tuple[int, int, int]:
        return (1 << level, int(self.H[level]), int(self.S[level]))

    def block_bounds(self, row_sep: int, col_sep: int) -> Tuple[int, int, int, int]:
        """Global (lo_r, lo_c, hi_r, hi_c) inclusive bounds of block
        (row_sep, col_sep) in the permuted matrix — parity with the
        reference's BlockBounds (partition_matrix, mmat.rg:331-358)."""
        lo_r = int(self.sep_offset[row_sep])
        lo_c = int(self.sep_offset[col_sep])
        hi_r = lo_r + int(self.sep_sizes[row_sep]) - 1
        hi_c = lo_c + int(self.sep_sizes[col_sep]) - 1
        return (lo_r, lo_c, hi_r, hi_c)


def build_plan(ordering: Ordering, clusters: Optional[ClusterHierarchy] = None,
               pad_to: int = 8) -> SolvePlan:
    """Build the static solve plan from a parsed ordering (and optional
    cluster hierarchy, used by the fill analysis / debug oracle).

    pad_to: round each level's separator-size bucket up to this multiple
    (TPU sublane granularity; 8 for fp32/f64 tiling).
    """
    tree = SeparatorTree(ordering.levels, ordering.num_separators)
    nsep = tree.num_separators
    sizes = ordering.sizes()
    n = int(sizes.sum())

    sep_offset = np.zeros(nsep + 2, dtype=np.int64)
    np.cumsum(sizes[1:], out=sep_offset[2:][: nsep])
    sep_offset = sep_offset[: nsep + 1]
    # sep_offset[s] = sum of sizes of separators 1..s-1

    perm = np.empty(n, dtype=np.int64)
    sep_of_dof = np.empty(n, dtype=np.int64)
    loc_of_dof = np.empty(n, dtype=np.int64)
    for s in range(1, nsep + 1):
        d = ordering.dofs[s]
        off = sep_offset[s]
        perm[off:off + len(d)] = d
        sep_of_dof[d] = s
        loc_of_dof[d] = np.arange(len(d), dtype=np.int64)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n, dtype=np.int64)

    levels = tree.levels
    S = np.zeros(levels, dtype=np.int64)
    for lvl in range(levels):
        lvl_sizes = [sizes[s] for s in tree.level_seps(lvl)]
        S[lvl] = _round_up(max(max(lvl_sizes), 1), pad_to)

    # Panel heights and intra-panel offsets. Ancestor blocks ordered
    # immediate parent (level L-1) first, root (level 0) last.
    H = np.zeros(levels, dtype=np.int64)
    row_off = np.full((levels, levels), -1, dtype=np.int64)
    u_off = np.full((levels, levels), -1, dtype=np.int64)
    for L in range(levels):
        acc = S[L]
        uacc = 0
        for lam in range(L - 1, -1, -1):
            row_off[L, lam] = acc
            u_off[L, lam] = uacc
            acc += S[lam]
            uacc += S[lam]
        H[L] = acc

    return SolvePlan(
        tree=tree, n=n, sep_sizes=sizes, perm=perm, iperm=iperm,
        sep_offset=sep_offset, sep_of_dof=sep_of_dof, loc_of_dof=loc_of_dof,
        S=S, H=H, row_off=row_off, u_off=u_off, clusters=clusters,
    )


def permute_matrix_dense(plan: SolvePlan, a_dense: np.ndarray) -> np.ndarray:
    """Reference implementation of the permuted lower-triangular matrix
    (parity with verify.py:127-213 permute_matrix): diagonal blocks keep only
    their lower triangle; off-diagonal ancestor blocks are dense; all
    non-ancestor blocks are structurally zero."""
    p = plan.perm
    pmat = a_dense[np.ix_(p, p)]
    out = np.tril(pmat)
    # zero non-ancestor-pair blocks (they are zero for a valid ND ordering,
    # but enforce the structure as verify.py does by construction)
    mask = np.zeros_like(out, dtype=bool)
    t = plan.tree
    for s in range(1, t.num_separators + 1):
        lo_r, lo_c, hi_r, hi_c = plan.block_bounds(s, s)
        mask[lo_r:hi_r + 1, lo_c:hi_c + 1] = True
        for a in t.ancestors(s):
            lo_r, lo_c, hi_r, hi_c = plan.block_bounds(a, s)
            mask[lo_r:hi_r + 1, lo_c:hi_c + 1] = True
    out[~mask] = 0.0
    return out

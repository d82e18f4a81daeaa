"""Host-side frontal analysis: the NumPy part of the JAX package's
`cholesky_tpu/numeric/frontal.py`, copied so that the port never imports
that (jax-importing) module.

The code is the same as the original's, line for line where it can be, so
the tests can require identical arrays from both packages:

  * `FrontalPlan`            <- frontal.py:49-83
  * `build_frontal_plan`     <- frontal.py:89-209
  * `_front_scatter_indices` <- frontal.py:216-265
  * `assemble_fronts`        <- frontal.py:268-297
  * `_banded_maps`           <- frontal.py:1942-1980

The one difference: the JAX package keeps module-level caches keyed by
`FrontalPlan.key()` (its jit programs look plans up there); the port caches
derived arrays on the plan object itself (`FrontalPlan.cache`).

One addition: `hands_x`, the form of the update a child level hands its
parent, which the level loop, the row-group levels and the capacity
planner all read.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

import numpy as np

from cholesky_tpu_torch.symbolic.plan import SolvePlan
from cholesky_tpu_torch.utils import round_up


def _round_up(x: int, m: int) -> int:
    # shared rule, with the frontal engine's zero-size clamp (an empty
    # separator still gets a 1-row (-> pad_to) slot so level shapes are valid)
    return round_up(max(x, 1), m)


@dataclasses.dataclass
class FrontalPlan:
    plan: SolvePlan
    W: Tuple[int, ...]                 # padded pivot width per level (= plan.S)
    F: Tuple[int, ...]                 # padded front size per level
    front_rows: List[np.ndarray]       # per level: [B, F] global permuted row
                                       # ids (pivot rows first, then sorted
                                       # boundary), sentinel = n
    inv_child: List[Optional[np.ndarray]]
                                       # per level L: [B, F(L-1)] mapping each
                                       # parent-front position to this child's
                                       # boundary position, or bndK sentinel
    fwd_child: List[Optional[np.ndarray]] = None
                                       # per level L: [B, bndK] mapping each
                                       # child boundary position to its parent
                                       # front position, or F(L-1) sentinel
                                       # (strictly increasing per slot)
    fingerprint: str = ""              # structural hash (front_rows + perm)
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)
                                       # derived arrays and their device
                                       # copies (banded maps, index tensors)

    @property
    def levels(self) -> int:
        return self.plan.levels

    def key(self):
        """Structural identity: two plans that share every bucket shape can
        still differ in structure (the same grid under two orderings); the
        fingerprint separates them."""
        return (self.levels, self.W, self.F, self.plan.n, self.fingerprint)


def build_frontal_plan(plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                       pad_to: int = 8) -> FrontalPlan:
    """Symbolic frontal analysis: exact boundaries, front row lists, and
    extend-add maps. `rows/cols` is the COO lower triangle in ORIGINAL dof
    numbering (values not needed — this is structure only)."""
    t = plan.tree
    n = plan.n
    nsep = t.num_separators

    # permuted coordinates, lower triangle
    pr = plan.iperm[rows]
    pc = plan.iperm[cols]
    swap = pc > pr
    pr2 = np.where(swap, pc, pr)
    pc2 = np.where(swap, pr, pc)

    # separator of each permuted index
    sep_of_perm = np.empty(n, dtype=np.int64)
    for s in range(1, nsep + 1):
        off = int(plan.sep_offset[s])
        sep_of_perm[off:off + int(plan.sep_sizes[s])] = s

    col_sep = sep_of_perm[pc2]
    # original below-diagonal rows per column-separator: one global sort by
    # (col_sep, row) then contiguous slices
    order = np.lexsort((pr2, col_sep))
    cs_sorted = col_sep[order]
    pr_sorted = pr2[order]
    starts = np.searchsorted(cs_sorted, np.arange(1, nsep + 2))
    sep_hi = plan.sep_offset[1:nsep + 1] + plan.sep_sizes[1:nsep + 1]
    orig_rows = {}
    for s in range(1, nsep + 1):
        rr = pr_sorted[starts[s - 1]:starts[s]]      # sorted ascending
        lo = np.searchsorted(rr, int(sep_hi[s - 1]))
        seg = rr[lo:]
        if len(seg):
            seg = seg[np.concatenate([[True], seg[1:] != seg[:-1]])]
        orig_rows[s] = seg

    # bottom-up boundary recurrence (children have smaller sep numbers)
    bnd = {}
    for s in range(1, nsep + 1):
        h = t.heap_of(s)
        parts = [orig_rows[s]]
        if 2 * h <= nsep:                       # internal node: two children
            parts.append(bnd[t.sep_of(2 * h)])
            parts.append(bnd[t.sep_of(2 * h + 1)])
        u = np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)
        hi = int(plan.sep_offset[s] + plan.sep_sizes[s])
        bnd[s] = u[u >= hi]

    levels = plan.levels
    W_list = []
    F_list = []
    front_rows = []
    for lvl in range(levels):
        B = 1 << lvl
        max_sz = max(int(plan.sep_sizes[t.sep_at(lvl, sl)]) for sl in range(B))
        bndK = max((len(bnd[t.sep_at(lvl, sl)]) for sl in range(B)),
                   default=0)
        Wl = _round_up(max_sz, pad_to)
        Fl = Wl + _round_up(bndK, pad_to) if bndK else Wl
        fr = np.full((B, Fl), n, dtype=np.int64)
        for sl in range(B):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            fr[sl, :sz] = np.arange(off, off + sz)
            bs = bnd[s]
            fr[sl, Wl:Wl + len(bs)] = bs
        W_list.append(Wl)
        F_list.append(Fl)
        front_rows.append(fr)
    W = tuple(W_list)

    inv_child: List[Optional[np.ndarray]] = [None] * levels
    for lvl in range(1, levels):
        B = 1 << lvl
        Fp = F_list[lvl - 1]
        bndK = F_list[lvl] - W[lvl]
        inv = np.full((B, Fp), bndK, dtype=np.int32)
        for sl in range(B):
            s = t.sep_at(lvl, sl)
            c_bnd = bnd[s]
            if len(c_bnd) == 0:
                continue
            prow = front_rows[lvl - 1][sl >> 1]
            # position of each parent-front row in this child's boundary
            pos = np.searchsorted(c_bnd, prow)
            pos_ok = pos < len(c_bnd)
            hit = np.zeros(Fp, dtype=bool)
            hit[pos_ok] = c_bnd[pos[pos_ok]] == prow[pos_ok]
            inv[sl, hit] = pos[hit]
            # every child boundary row must appear in the parent front
            assert hit.sum() == len(c_bnd), (
                f"extend-add: child sep {s} boundary not covered by parent front")
        inv_child[lvl] = inv

    fwd_child: List[Optional[np.ndarray]] = [None] * levels
    for lvl in range(1, levels):
        B = 1 << lvl
        Fp = F_list[lvl - 1]
        bndK = F_list[lvl] - W[lvl]
        fwd = np.full((B, bndK), Fp, dtype=np.int32)
        inv = inv_child[lvl]
        for sl in range(B):
            js = np.nonzero(inv[sl] != bndK)[0]
            fwd[sl, inv[sl][js]] = js
        fwd_child[lvl] = fwd

    h = hashlib.blake2b(digest_size=12)
    h.update(np.ascontiguousarray(plan.perm, dtype=np.int64).tobytes())
    for fr in front_rows:
        h.update(np.ascontiguousarray(fr, dtype=np.int32).tobytes())
    return FrontalPlan(plan, W, tuple(F_list), front_rows, inv_child,
                       fwd_child, fingerprint=h.hexdigest())


def hands_x(F, W, cl: int) -> bool:
    """Whether child level `cl` hands its parent its boundary strips X
    [2b, F - W, W] instead of the update X X^T: the leaf level, when its
    fronts have a boundary (the parent forms X X^T, or expands X straight
    into its two pieces). F and W are the per-level front and pivot widths
    of a plan or of any view of it, or the planner's bare tuples."""
    return cl == len(F) - 1 and F[cl] > W[cl]


def _front_scatter_indices(fp: FrontalPlan, rows: np.ndarray,
                           cols: np.ndarray):
    """Where every original COO entry lands in the pivot-column slabs: per
    level, (val_sel, flat_idx, ones_flat) with `vals[val_sel]` going to flat
    position `flat_idx` of the [B*F*W] slab and `ones_flat` the padded pivot
    diagonal positions (set to 1 for well-posed Cholesky under padding).
    Pure pattern bookkeeping — computed once, reused for every refill."""
    plan = fp.plan
    t = plan.tree
    pr = plan.iperm[rows]
    pc = plan.iperm[cols]
    swap = pc > pr
    pr2 = np.where(swap, pc, pr)
    pc2 = np.where(swap, pr, pc)

    # group entries by column separator once (one sort) instead of masking
    # the whole entry array per slot
    col_sep = plan.sep_of_dof[plan.perm[pc2]]
    order = np.argsort(col_sep, kind="stable")
    starts = np.searchsorted(col_sep[order],
                             np.arange(1, plan.num_separators + 2))
    starts = np.concatenate([[0], starts])

    out = []
    for lvl in range(plan.levels):
        B = 1 << lvl
        Fl, Wl = fp.F[lvl], fp.W[lvl]
        sels, flats, ones = [], [], []
        for sl in range(B):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            grp = order[starts[s]:starts[s + 1]]
            if len(grp):
                rr = pr2[grp]
                fr = fp.front_rows[lvl][sl]
                pos = np.searchsorted(fr[Wl:], rr)
                in_piv = rr < off + sz
                rpos = np.where(in_piv, rr - off, Wl + pos)
                sels.append(grp)
                flats.append((sl * Fl + rpos) * Wl + (pc2[grp] - off))
            if sz < Wl:
                d = np.arange(sz, Wl, dtype=np.int64)
                ones.append((sl * Fl + d) * Wl + d)
        cat = lambda xs: (np.concatenate(xs) if xs  # noqa: E731
                          else np.zeros(0, dtype=np.int64))
        out.append((cat(sels).astype(np.int64), cat(flats).astype(np.int64),
                    cat(ones).astype(np.int64)))
    return out


def assemble_fronts(fp: FrontalPlan, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray, dtype=np.float32) -> List[np.ndarray]:
    """Scatter original entries into the pivot-column slabs [B, F, W] of each
    level's fronts on the host: the reference the device assembler is held
    against. Padded pivot diagonal entries are set to 1. (The JAX version
    also takes [K, nnz] values for same-pattern families, which the port
    does not have yet.)"""
    vals = np.asarray(vals)
    out = []
    for lvl, (sel, flat, ones) in enumerate(
            _front_scatter_indices(fp, rows, cols)):
        B = 1 << lvl
        Fl, Wl = fp.F[lvl], fp.W[lvl]
        arr = np.zeros(B * Fl * Wl, dtype=dtype)
        arr[ones] = 1.0
        arr[flat] = vals[sel]
        out.append(arr.reshape(B, Fl, Wl))
    return out


def _banded_maps(fp: FrontalPlan):
    """Level-major padded relabeling of the permuted dofs for the solve
    chain. Each (level, slot) front gets a CONTIGUOUS block of W[lvl] slots
    (real pivot dofs first, then dead pad slots), bands ordered leaves →
    root, so a level's pivot values are a static slice of the padded work
    vector instead of a [B, W] gather + scatter pair. Returns
    (n_pad, offs, inv_map [n_pad] padded→permuted with sentinel n,
    pad_of [n] permuted→padded, bnd_pad per-level [B, F−W] int32
    boundary ids in the padded basis, sentinel n_pad). Cached on the plan."""
    hit = fp.cache.get("banded")
    if hit is not None:
        return hit
    n = fp.plan.n
    levels = fp.levels
    offs = [0] * levels
    off = 0
    for lvl in range(levels - 1, -1, -1):
        offs[lvl] = off
        off += fp.front_rows[lvl].shape[0] * fp.W[lvl]
    n_pad = off
    pad_of = np.full(n + 1, n_pad, dtype=np.int64)
    inv_map = np.full(n_pad, n, dtype=np.int64)
    for lvl in range(levels):
        frp = fp.front_rows[lvl][:, :fp.W[lvl]]
        pos = offs[lvl] + np.arange(frp.size).reshape(frp.shape)
        real = frp < n
        pad_of[frp[real]] = pos[real]
        inv_map[pos[real]] = frp[real]
    bnd_pad = [pad_of[fp.front_rows[lvl][:, fp.W[lvl]:]].astype(np.int32)
               for lvl in range(levels)]
    maps = (n_pad, offs, inv_map, np.ascontiguousarray(pad_of[:n]), bnd_pad)
    fp.cache["banded"] = maps
    return maps

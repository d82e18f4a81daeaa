"""Cluster-level symbolic fill analysis.

Host-side, NumPy/C++ re-implementation of the reference's
`compute_filled_clusters` (mmat.rg:896-1028) + `merge_filled_clusters`
(mmat.rg:636-695) + `partition_separator` cluster-rect decoding
(mmat.rg:365-451): each block (row_sep, col_sep) is a grid of clusters —
row clusters of row_sep x col clusters of col_sep at a given merge interval —
and only clusters that are structurally nonzero ("filled") receive BLAS work.
Fill propagates exactly like the numeric Schur update: A=(gp,sep) filled and
B=(par,sep) filled implies C=(gp,par) filled (mmat.rg:944-994).

The analysis produces one snapshot per interval label (= per elimination
level, deepest first), which drives:
  * the reference-compatible debug log / op-replay oracle (verify/),
  * cluster-masked sparse kernels in the numeric phase,
  * parity tests against the reference's `-d` output.

Interval schedule (mmat.rg:1212-1354 and 914-1027): levels `levels-1` and
`levels-2` both use interval 0; each shallower level uses one more merge:
interval(lvl) = max(0, levels-2-lvl); interval_lbl(lvl) = levels-1-lvl.

Invariant exploited by the reference (and asserted here): at its elimination
interval, a separator's own cluster structure is fully merged to a single
cluster, so blocks (ancestor, sep) are column strips of clusters.

The port's copy of `cholesky_tpu/symbolic/fill.py`, with both analyses: the
Python one and the one on the port's native library (`native/`:
`fill_initial`, `fill_analyze`), which gives identical snapshots.
`analyze_fill(native=...)` chooses, and `FillAnalysis.engine` says which
ran.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from cholesky_tpu_torch.symbolic.plan import SolvePlan


@dataclasses.dataclass
class BlockClusters:
    """Cluster grid of one block at one interval."""

    row_sep: int
    col_sep: int
    row_bounds: np.ndarray   # dof boundaries within row_sep, [nr+1]
    col_bounds: np.ndarray   # dof boundaries within col_sep, [nc+1]
    filled: np.ndarray       # [nr, nc] bool

    @property
    def nr(self) -> int:
        return len(self.row_bounds) - 1

    @property
    def nc(self) -> int:
        return len(self.col_bounds) - 1

    def cluster_rect(self, plan: SolvePlan, r: int, c: int) -> Tuple[int, int, int, int]:
        """Global inclusive (lo_r, lo_c, hi_r, hi_c) of cluster (r, c) —
        what partition_separator stores in ClusterBounds (mmat.rg:426-429)."""
        lo_r = int(plan.sep_offset[self.row_sep] + self.row_bounds[r])
        lo_c = int(plan.sep_offset[self.col_sep] + self.col_bounds[c])
        hi_r = int(plan.sep_offset[self.row_sep] + self.row_bounds[r + 1]) - 1
        hi_c = int(plan.sep_offset[self.col_sep] + self.col_bounds[c + 1]) - 1
        return lo_r, lo_c, hi_r, hi_c


@dataclasses.dataclass
class FillAnalysis:
    plan: SolvePlan
    # snapshots[lbl][(row_sep, col_sep)] -> BlockClusters, lbl = levels-1-lvl
    snapshots: List[Dict[Tuple[int, int], BlockClusters]]
    engine: str = "python"   # "native" or "python": the analysis that ran

    def interval_for_level(self, lvl: int) -> int:
        return max(0, self.plan.levels - 2 - lvl)

    def label_for_level(self, lvl: int) -> int:
        return self.plan.levels - 1 - lvl


def allocated_blocks(plan: SolvePlan) -> List[Tuple[int, int]]:
    """All (row_sep, col_sep) ancestor-pair blocks, the 2-D index space of
    find_index_space_2d (mmat.rg:741-767)."""
    t = plan.tree
    out = []
    for c in range(1, t.num_separators + 1):
        out.append((c, c))
        for a in t.ancestors(c):
            out.append((a, c))
    return out


def _initial_filled(plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray) -> Dict[Tuple[int, int], np.ndarray]:
    """Interval-0 filled flags from the assembled nonzero pattern — what
    fill_block reports per cluster (mmat.rg:614-616). `rows/cols` is the COO
    lower triangle in original dof numbering."""
    clusters = plan.clusters
    if clusters is None:
        raise ValueError("fill analysis requires a cluster hierarchy (-c file)")
    t = plan.tree
    nsep = t.num_separators

    # mirror off-diagonal entries (both orientations considered)
    off = rows != cols
    r = np.concatenate([rows, cols[off]])
    c = np.concatenate([cols, rows[off]])
    v = np.concatenate([vals, vals[off]])

    sr = plan.sep_of_dof[r]
    sc = plan.sep_of_dof[c]
    lr = plan.loc_of_dof[r]
    lc = plan.loc_of_dof[c]
    heap_r = nsep - sr + 1
    heap_c = nsep - sc + 1
    lvl_r = np.int64(np.log2(heap_r))
    lvl_c = np.int64(np.log2(heap_c))
    diag = (sr == sc) & (lr >= lc)
    anc = (lvl_r < lvl_c) & ((heap_c >> (lvl_c - lvl_r).clip(0)) == heap_r)
    # explicit stored zeros are dropped, matching the reference: its hash
    # table probes with `val != 0` (mnd.c:186), so a stored 0.0 is invisible
    # to search()/fill_block and never marks a cluster filled
    keep = (diag | anc) & (v != 0.0)

    filled: Dict[Tuple[int, int], np.ndarray] = {}
    bounds0: Dict[int, np.ndarray] = {
        s: clusters.cluster_dof_ranges(s, 0) for s in range(1, nsep + 1)}
    for b in allocated_blocks(plan):
        rs, cs = b
        nr = len(bounds0[rs]) - 1
        nc = len(bounds0[cs]) - 1
        filled[b] = np.zeros((nr, nc), dtype=bool)

    # vectorized cluster routing: searchsorted per separator, grouped
    ri = np.empty(len(r), dtype=np.int64)
    ci = np.empty(len(c), dtype=np.int64)
    for s in range(1, nsep + 1):
        m = sr == s
        if m.any():
            ri[m] = np.searchsorted(bounds0[s], lr[m], side="right") - 1
        m = sc == s
        if m.any():
            ci[m] = np.searchsorted(bounds0[s], lc[m], side="right") - 1
    idx = np.nonzero(keep)[0]
    order = np.lexsort((sc[idx], sr[idx]))
    idx = idx[order]
    bl_r, bl_c = sr[idx], sc[idx]
    cuts = np.nonzero((np.diff(bl_r) != 0) | (np.diff(bl_c) != 0))[0] + 1
    for grp in np.split(idx, cuts):
        if len(grp) == 0:
            continue
        b = (int(sr[grp[0]]), int(sc[grp[0]]))
        filled[b][ri[grp], ci[grp]] = True
    return filled


def analyze_fill(plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, native: Optional[bool] = None
                 ) -> FillAnalysis:
    """Run the full interval-scheduled fill analysis; returns one snapshot of
    every block's cluster grid + filled flags per interval label.

    `native=None` runs the native analysis when the library is available,
    `native=True` requires it, `native=False` runs the Python one. Errors
    inside the native analysis propagate (no silent fallback)."""
    from cholesky_tpu_torch.native import ext

    if ext.use_native(native):
        return _analyze_fill_native(plan, rows, cols, vals)
    return _analyze_fill_py(plan, rows, cols, vals)


def _analyze_fill_py(plan: SolvePlan, rows, cols, vals) -> FillAnalysis:
    clusters = plan.clusters
    t = plan.tree
    levels = plan.levels
    filled = _initial_filled(plan, rows, cols, vals)
    blocks = allocated_blocks(plan)

    snapshots: List[Dict[Tuple[int, int], BlockClusters]] = []
    cur_t = 0
    for lvl in range(levels - 1, -1, -1):
        # --- fill propagation at this level (mmat.rg:926-998) ---
        for s in t.level_seps(lvl):
            ns = clusters.num_clusters(s, cur_t)
            assert ns == 1, (
                f"separator {s} has {ns} clusters at its elimination "
                f"interval {cur_t}; reference invariant violated")
            anc = t.ancestors(s)
            for pi, par in enumerate(anc):
                B = filled[(par, s)]            # [npar, 1] column strip
                for gp in [par] + anc[pi + 1:]:
                    A = filled[(gp, s)]         # [ngp, 1]
                    C = filled[(gp, par)]
                    arow = A[:, 0]
                    brow = B[:, 0]
                    prop = np.outer(arow, brow)  # [ngp, npar]
                    if gp == par:
                        # j <= i restriction on the diagonal (mmat.rg:959)
                        prop = np.tril(prop)
                    C |= prop

        # --- snapshot (mmat.rg:1000-1016) ---
        snap: Dict[Tuple[int, int], BlockClusters] = {}
        for b in blocks:
            rs, cs = b
            if b not in filled:
                continue
            rb = _bounds_at(clusters, rs, cur_t)
            cb = _bounds_at(clusters, cs, cur_t)
            if rb is None or cb is None:
                continue
            snap[b] = BlockClusters(rs, cs, rb, cb, filled[b].copy())
        snapshots.append(snap)

        # --- merge to the next interval (mmat.rg:1020-1026) ---
        if lvl <= levels - 2 and lvl > 0:
            nxt = cur_t + 1
            if nxt < levels:
                filled = _merge(clusters, filled, blocks, nxt)
                cur_t = nxt
    return FillAnalysis(plan, snapshots)


def _bounds_at(clusters, sep: int, interval: int) -> Optional[np.ndarray]:
    if interval >= len(clusters.intervals.get(sep, [])):
        return None
    return clusters.cluster_dof_ranges(sep, interval)


def _merge(clusters, filled, blocks, interval):
    """OR-coarsen filled flags into the next interval's cluster grid
    (merge_filled_clusters, mmat.rg:636-695). Blocks whose separators lack
    the interval are dropped (they are past their elimination step)."""
    out = {}
    for b in blocks:
        rs, cs = b
        if b not in filled:
            continue
        rext = clusters.intervals.get(rs, [])
        cext = clusters.intervals.get(cs, [])
        if interval >= len(rext) or interval >= len(cext):
            continue
        rb = rext[interval]   # indices into previous interval's cluster list
        cb = cext[interval]
        old = filled[b]
        nr, nc = len(rb) - 1, len(cb) - 1
        new = np.zeros((nr, nc), dtype=bool)
        for R in range(nr):
            for C in range(nc):
                new[R, C] = old[rb[R]:rb[R + 1], cb[C]:cb[C + 1]].any()
        out[b] = new
    return out


def _analyze_fill_native(plan, rows, cols, vals) -> FillAnalysis:
    """C++ planning core (mndio.cc fill_analyze): Python computes the
    interval-0 flags + flattened cluster tables; the propagate/snapshot/merge
    loop runs natively; snapshots are reconstructed from the label arenas."""
    from cholesky_tpu_torch.native import ext

    clusters = plan.clusters
    t = plan.tree
    levels = plan.levels
    nsep = t.num_separators
    if clusters is None:
        raise ValueError("fill analysis requires a cluster hierarchy (-c file)")
    blocks = allocated_blocks(plan)

    # block ids: for col sep c, depth-d ancestor block at base[c] + d
    base = np.zeros(nsep + 1, dtype=np.int64)
    acc = 0
    for c in range(1, nsep + 1):
        base[c] = acc
        acc += t.level_of(c) + 1
    nblocks = acc
    blk_id = {}
    for c in range(1, nsep + 1):
        blk_id[(c, c)] = int(base[c])
        for d, a in enumerate(t.ancestors(c), start=1):
            blk_id[(a, c)] = int(base[c]) + d

    # interval-0 cluster boundaries, flattened per separator
    bounds0_per = {s: clusters.cluster_dof_ranges(s, 0)
                   for s in range(1, nsep + 1)}
    b0_off = np.zeros(nsep + 1, dtype=np.int64)
    b0_len = np.zeros(nsep + 1, dtype=np.int64)
    parts = []
    blen = 0
    for s in range(1, nsep + 1):
        b0_off[s] = blen
        b0_len[s] = len(bounds0_per[s])
        parts.append(np.asarray(bounds0_per[s], dtype=np.int64))
        blen += b0_len[s]
    bounds0 = np.concatenate(parts)

    # working arena at interval-0 layout
    cur_nr = np.empty(nblocks, dtype=np.int64)
    cur_nc = np.empty(nblocks, dtype=np.int64)
    cur_off = np.empty(nblocks, dtype=np.int64)
    off = 0
    for b in blocks:
        bi = blk_id[b]
        nr = b0_len[b[0]] - 1
        nc = b0_len[b[1]] - 1
        cur_nr[bi], cur_nc[bi], cur_off[bi] = nr, nc, off
        off += nr * nc
    arena = np.zeros(off, dtype=np.uint8)
    ext.fill_initial(nsep, rows, cols, vals, plan.sep_of_dof, plan.loc_of_dof,
                     base, bounds0, b0_off, b0_len, arena, cur_off, cur_nc)

    # cluster-count and merge tables per (sep, interval)
    nclus = np.full((nsep + 1) * levels, -1, dtype=np.int64)
    merge_off = np.zeros((nsep + 1) * levels, dtype=np.int64)
    mdata: List[np.ndarray] = []
    mlen = 0
    for s in range(1, nsep + 1):
        ivs = clusters.intervals.get(s, [])
        for ti in range(min(len(ivs), levels)):
            nclus[s * levels + ti] = max(len(ivs[ti]) - 1, 0)
            if ti >= 1:
                merge_off[s * levels + ti] = mlen
                mdata.append(np.asarray(ivs[ti], dtype=np.int64))
                mlen += len(ivs[ti])
    merge_data = (np.concatenate(mdata) if mdata
                  else np.zeros(1, dtype=np.int64))

    # snapshot layout per label: blocks whose both separators define the
    # label's interval, at that interval's cluster dims
    snap_off = np.full(levels * nblocks, -1, dtype=np.int64)
    snap_arenas: List[np.ndarray] = []
    bounds_cache: Dict[Tuple[int, int], Optional[np.ndarray]] = {}

    def bounds(s, ti):
        k = (s, ti)
        if k not in bounds_cache:
            bounds_cache[k] = _bounds_at(clusters, s, ti)
        return bounds_cache[k]

    for lbl in range(levels):
        lvl = levels - 1 - lbl
        ti = max(0, levels - 2 - lvl)
        sz = 0
        for b in blocks:
            rs, cs = b
            rb = bounds(rs, ti)
            cb = bounds(cs, ti)
            if rb is None or cb is None:
                continue
            bi = blk_id[b]
            snap_off[lbl * nblocks + bi] = sz
            sz += (len(rb) - 1) * (len(cb) - 1)
        snap_arenas.append(np.zeros(max(sz, 1), dtype=np.uint8))

    ext.fill_analyze(levels, nsep, nblocks, base, arena, cur_off, cur_nr,
                     cur_nc, nclus, merge_off, merge_data, snap_arenas,
                     snap_off)

    snapshots: List[Dict[Tuple[int, int], BlockClusters]] = []
    for lbl in range(levels):
        lvl = levels - 1 - lbl
        ti = max(0, levels - 2 - lvl)
        snap: Dict[Tuple[int, int], BlockClusters] = {}
        for b in blocks:
            bi = blk_id[b]
            so = snap_off[lbl * nblocks + bi]
            if so < 0:
                continue
            rs, cs = b
            rb = bounds(rs, ti)
            cb = bounds(cs, ti)
            nr, nc = len(rb) - 1, len(cb) - 1
            flags = snap_arenas[lbl][so:so + nr * nc].reshape(nr, nc)
            snap[b] = BlockClusters(rs, cs, rb, cb, flags.astype(bool))
        snapshots.append(snap)
    return FillAnalysis(plan, snapshots, engine="native")

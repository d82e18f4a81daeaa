"""General-graph nested dissection ordering.

The reference consumes orderings computed offline by external tools (its
`*_ord_*.txt` fixtures; SURVEY.md: "ordering computed offline"). For
standalone operation on arbitrary SPD matrices — SuiteSparse-style inputs
with no precomputed ordering — this module computes a complete-binary-tree
nested dissection directly from the sparsity graph:

  * recursive two-way partition by BFS level sets from a pseudo-peripheral
    vertex (the classic Gibbs-Poole-Stockmeyer-style heuristic), preferring
    the tightest balance window that admits a level cut (imbalance compounds
    across recursion levels and leaf factorization work is cubic),
  * vertex separator = the smaller frontier of the bipartition, refined by
    vertex-separator Fiduccia–Mattheyses passes (Ashcraft–Liu gains),
  * recursion to a fixed depth, tolerating empty parts (empty separators
    are legal throughout the solver).

All per-node state lives in a preallocated stamped workspace — BFS levels,
set membership, and FM sides are O(node) per node, not O(n), so the whole
ordering is O(E · levels) plus the FM move heaps.

Output is a standard `Ordering` (+ single-cluster `ClusterHierarchy`), so
everything downstream — plan, fill, frontal engine, CLI, file writers — is
unchanged. Quality is heuristic (minimal separators are not guaranteed), but
the separator property (removing S disconnects A from B) is, which is what
correctness requires; fill quality only affects speed.

The port's copy of `cholesky_tpu/symbolic/nd.py`. The planning core runs in
the port's native library (`native/`, `nd_order`) when it is available: a
statement-level mirror of the Python path here with identical output, so
the engine changes host time only. The JAX package's environment knobs are
keyword arguments here (`native`, `threads`, `md_max`, `md_small`).
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, Optional, Tuple

import numpy as np

from cholesky_tpu_torch.io.ordering import ClusterHierarchy, Ordering
from cholesky_tpu_torch.utils.laplacian import make_clusters


def _build_adjacency(n: int, rows: np.ndarray, cols: np.ndarray):
    """CSR adjacency (symmetric, no self loops) from COO structure."""
    m = rows != cols
    r = np.concatenate([rows[m], cols[m]])
    c = np.concatenate([cols[m], rows[m]])
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, c


class _Workspace:
    """Preallocated stamped scratch arrays shared by every tree node.

    Membership tests are stamp comparisons, so "clearing" a set is a counter
    increment — no O(n) zeroing per node. `side` (the FM state) is the one
    array reset explicitly, O(node) at the end of each refinement."""

    __slots__ = ("member", "node_stamp", "lvl_val", "lvl_stamp", "bfs_stamp",
                 "side", "tag", "tag_stamp")

    def __init__(self, n: int):
        self.member = np.zeros(n, dtype=np.int64)
        self.node_stamp = 0
        self.lvl_val = np.zeros(n, dtype=np.int64)
        self.lvl_stamp = np.zeros(n, dtype=np.int64)
        self.bfs_stamp = 0
        self.side = np.full(n, -1, dtype=np.int8)   # 0=A, 1=B, 2=S, -1=out
        self.tag = np.zeros(n, dtype=np.int64)
        self.tag_stamp = 0


def _gather_neighbors(indptr, indices, verts: np.ndarray) -> np.ndarray:
    """Concatenated neighbor lists of `verts` (with repeats), vectorized."""
    starts = indptr[verts]
    counts = indptr[verts + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    cc = np.cumsum(counts)
    pos = np.arange(total, dtype=np.int64) + np.repeat(starts - (cc - counts),
                                                       counts)
    return indices[pos]


def _bfs_levels(indptr, indices, ws: _Workspace, start: int) -> int:
    """BFS over the current node (membership = ws.member == ws.node_stamp).
    Levels land in ws.lvl_val, valid where ws.lvl_stamp == returned stamp."""
    ws.bfs_stamp += 1
    st = ws.bfs_stamp
    ws.lvl_val[start] = 0
    ws.lvl_stamp[start] = st
    frontier = np.array([start], dtype=np.int64)
    d = 0
    while len(frontier):
        d += 1
        nbrs = np.unique(_gather_neighbors(indptr, indices, frontier))
        nbrs = nbrs[(ws.member[nbrs] == ws.node_stamp)
                    & (ws.lvl_stamp[nbrs] != st)]
        ws.lvl_val[nbrs] = d
        ws.lvl_stamp[nbrs] = st
        frontier = nbrs
    return st


def _frontier(indptr, indices, verts: np.ndarray, tag: np.ndarray,
              tagv: int) -> np.ndarray:
    """Boolean mask over `verts`: which have a neighbor with tag[nbr] ==
    tagv."""
    starts = indptr[verts]
    counts = indptr[verts + 1] - starts
    hits = tag[_gather_neighbors(indptr, indices, verts)] == tagv
    seg = np.repeat(np.arange(len(verts), dtype=np.int64), counts)
    return np.bincount(seg[hits], minlength=len(verts)).astype(bool)


def _pseudo_peripheral(indptr, indices, ws: _Workspace, verts: np.ndarray
                       ) -> int:
    """A vertex of near-maximal eccentricity in the node, with its BFS level
    field left in the workspace (returns the BFS stamp — reused by the
    caller, saves a full sweep). Three improvement hops (dropping to two was
    measured to cost 15-25% schedule FLOPs for <5% ordering time)."""
    v = int(verts[0])
    st = _bfs_levels(indptr, indices, ws, v)
    for _ in range(3):
        reached = ws.lvl_stamp[verts] == st
        reach = verts[reached]
        far = int(reach[np.argmax(ws.lvl_val[reach])])
        if ws.lvl_val[far] == 0:
            break
        v = far
        st = _bfs_levels(indptr, indices, ws, v)
    return st


def _side_counts(indptr, indices, side: np.ndarray, vs: np.ndarray):
    """Per-vertex counts of neighbors on side A (0) and side B (1),
    vectorized over `vs`."""
    counts = indptr[vs + 1] - indptr[vs]
    nb = _gather_neighbors(indptr, indices, vs)
    seg = np.repeat(np.arange(len(vs), dtype=np.int64), counts)
    sn = side[nb]
    ca = np.bincount(seg[sn == 0], minlength=len(vs))
    cb = np.bincount(seg[sn == 1], minlength=len(vs))
    return ca, cb


def _fm_refine(indptr, indices, ws: _Workspace, a: np.ndarray, b: np.ndarray,
               s: np.ndarray, rounds: int = 8, hi_share: float = 0.60
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vertex-separator Fiduccia–Mattheyses refinement (Ashcraft–Liu gains).

    Moving a separator vertex v to side t pulls every neighbor of v on the
    far side into the separator, so |S| changes by |N(v) ∩ far| − 1; the
    move's gain is 1 − |N(v) ∩ far|. Each pass greedily applies the
    best-gain balance-feasible move (lazy-stale heap), allowing negative-gain
    hill climbs, then rolls back to the best state seen. Passes repeat until
    a pass yields no improvement. The separator property (no A–B edge) is an
    invariant of every move.

    Inputs/outputs are vertex-id arrays over the node; balance is measured
    as max(|A|,|B|)/total against `hi_share` (or the starting share when
    that is already worse)."""
    total = len(a) + len(b) + len(s)
    if len(s) == 0 or total < 8:
        # sorted even on the early return: child vertex lists are canonical
        # ascending everywhere (the native mirror relies on this)
        return np.sort(a), np.sort(b), np.sort(s)
    side = ws.side
    side[a] = 0
    side[b] = 1
    side[s] = 2
    sizes = [len(a), len(b)]

    def far_count(v: int, t: int) -> int:
        nb = indices[indptr[v]:indptr[v + 1]]
        return int(np.count_nonzero(side[nb] == (1 - t)))

    hi = max(hi_share, max(sizes) / total if total else 1.0)

    for _ in range(rounds):
        heap = []
        seq = 0
        locked = set()
        ca, cb = _side_counts(indptr, indices, side, s)
        for i, v in enumerate(s):
            heapq.heappush(heap, (int(cb[i]) - 1, seq, int(v), 0))
            heapq.heappush(heap, (int(ca[i]) - 1, seq + 1, int(v), 1))
            seq += 2
        log = []            # (v, t, pulled) per applied move, for rollback
        extra = 0           # current |S| - |S at pass start|
        best_at = 0         # number of moves in the best prefix
        best_extra = 0
        stall = 0
        stall_cap = 2 * len(s) + 64
        while heap and stall < stall_cap:
            cost, _, v, t = heapq.heappop(heap)
            if side[v] != 2 or v in locked:
                continue
            if cost != far_count(v, t) - 1:     # stale entry: reinsert fresh
                heapq.heappush(heap, (far_count(v, t) - 1, seq, v, t))
                seq += 1
                continue
            if (sizes[t] + 1) / total > hi:
                continue
            nb = indices[indptr[v]:indptr[v + 1]]
            pulled = np.unique(nb[side[nb] == (1 - t)])
            side[v] = t
            sizes[t] += 1
            sizes[1 - t] -= len(pulled)
            side[pulled] = 2
            locked.add(v)
            log.append((v, t, pulled))
            extra += len(pulled) - 1
            for u in pulled:
                u = int(u)
                for tt in (0, 1):
                    heapq.heappush(heap, (far_count(u, tt) - 1, seq, u, tt))
                    seq += 1
                # Separator vertices adjacent to u lost a far-side neighbor
                # for direction t (u left side 1-t): push a fresh entry so
                # the improved gain sorts correctly. The opposite direction's
                # gain only worsened — its stale (too-optimistic) entry is
                # caught by the staleness check at pop.
                unb = indices[indptr[u]:indptr[u + 1]]
                for w in unb[side[unb] == 2]:
                    w = int(w)
                    if w in locked:
                        continue
                    heapq.heappush(heap, (far_count(w, t) - 1, seq, w, t))
                    seq += 1
            if extra < best_extra:
                best_extra = extra
                best_at = len(log)
                stall = 0
            else:
                stall += 1
        # roll back past the best prefix
        for v, t, pulled in reversed(log[best_at:]):
            side[pulled] = 1 - t
            sizes[1 - t] += len(pulled)
            side[v] = 2
            sizes[t] -= 1
        verts = np.concatenate([a, b, s])
        a = verts[side[verts] == 0]
        b = verts[side[verts] == 1]
        s = verts[side[verts] == 2]
        if best_extra >= 0:
            break
    # One-sided cleanup: a separator vertex with no neighbor on a side
    # separates nothing — balance feasibility can leave such vertices when
    # FM's gain-1 move was blocked. Two simultaneous sweeps are safe: first
    # every no-B-neighbor vertex moves to A (mover-mover edges end inside A,
    # movers had no B edges), then, against the UPDATED sides, every
    # no-A-neighbor vertex moves to B — so two adjacent removable vertices
    # can never land on opposite sides and re-join A to B.
    if len(s):
        for target in (0, 1):
            s = np.sort(s)
            has_far = _frontier(indptr, indices, s, side, 1 - target)
            moved = s[~has_far]
            if len(moved):
                side[moved] = target
                if target == 0:
                    a = np.concatenate([a, moved])
                else:
                    b = np.concatenate([b, moved])
                s = s[has_far]
    a, b, s = np.sort(a), np.sort(b), np.sort(s)
    side[a] = -1
    side[b] = -1
    side[s] = -1
    return a, b, s


def _split(indptr, indices, verts: np.ndarray,
           ws: Optional[_Workspace] = None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition `verts` into (A, B, S): S is a vertex separator such that no
    edge joins A and B."""
    if len(verts) <= 1:
        return verts, np.empty(0, np.int64), np.empty(0, np.int64)
    if ws is None:
        ws = _Workspace(len(indptr) - 1)
    ws.node_stamp += 1
    ws.member[verts] = ws.node_stamp
    st = _pseudo_peripheral(indptr, indices, ws, verts)
    reached = ws.lvl_stamp[verts] == st
    reach = verts[reached]                # always contains src (lv[src] = 0)
    unreach = verts[~reached]             # disconnected pieces -> side B
    lvr = ws.lvl_val[reach]
    # Choose the cut level. In a BFS level structure every edge stays within
    # a level or joins consecutive levels, so a cut between levels t-1 and t
    # has its separator inside level t-1 or t — min(count[t-1], count[t]) is
    # an exact upper bound on the separator size.
    counts = np.bincount(lvr)
    cum = np.cumsum(counts)
    total = len(reach)
    cut_level = None
    if len(counts) > 1:
        fracs = cum[:-1] / total               # A-side share for t = 1..L
        # Prefer the tightest balance window that admits a level cut: a
        # loose window compounds across recursion levels (0.75^5 of all
        # dofs in one leaf) and leaf factorization work is cubic in leaf
        # size — FM refinement recovers separator width far more cheaply
        # than anything recovers balance.
        proxy = np.minimum(counts[:-1], counts[1:])
        for lo_s, hi_s in ((0.45, 0.55), (0.35, 0.65), (0.25, 0.75)):
            ok = (fracs >= lo_s) & (fracs <= hi_s)
            if ok.any():
                cand = np.flatnonzero(ok)
                cut_level = int(cand[np.argmin(proxy[cand])]) + 1
                break
    if cut_level is None:                      # median-vertex fallback
        order = np.argsort(lvr, kind="stable")
        sorted_r = reach[order]
        cut = len(sorted_r) // 2
        cut_level = int(lvr[order][min(cut, len(sorted_r) - 1)])
    a_side = reach[lvr < cut_level]
    rest = reach[lvr >= cut_level]
    if len(a_side) == 0:                  # degenerate: one level dominates
        a_side = reach[: len(reach) // 2]
        rest = reach[len(reach) // 2:]
    # Two valid vertex separators exist for the (a_side, rest) bipartition:
    # the frontier of `rest` facing A, or the frontier of `a_side` facing
    # rest. Both satisfy "removing S leaves no A-B edge"; take the smaller
    # (fewer separator dofs -> smaller fronts -> less fill).
    ws.tag_stamp += 1
    ta = ws.tag_stamp
    ws.tag[a_side] = ta
    ws.tag_stamp += 1
    tr = ws.tag_stamp
    ws.tag[rest] = tr
    front_r = _frontier(indptr, indices, rest, ws.tag, ta)   # rest facing A
    front_a = _frontier(indptr, indices, a_side, ws.tag, tr)  # facing rest
    # Pre-FM trim: a separator vertex missing a neighbor on one side
    # separates nothing — return it to the far side. Each branch's separator
    # touches its near side by construction, so only the far-side check can
    # remove vertices; all removals go to ONE side, so two adjacent removable
    # vertices can never land on opposite sides and re-join A to B.
    if int(front_r.sum()) <= int(front_a.sum()):
        sep = rest[front_r]                   # every sep vertex touches A
        a, b = a_side, rest[~front_r]
        if len(sep):
            ws.tag_stamp += 1
            tb = ws.tag_stamp
            ws.tag[b] = tb
            has_b = _frontier(indptr, indices, sep, ws.tag, tb)
            a = np.concatenate([a, sep[~has_b]])
            sep = sep[has_b]
    else:
        sep = a_side[front_a]                 # every sep vertex touches B
        a, b = a_side[~front_a], rest
        if len(sep):
            ws.tag_stamp += 1
            ta2 = ws.tag_stamp
            ws.tag[a] = ta2
            has_a = _frontier(indptr, indices, sep, ws.tag, ta2)
            b = np.concatenate([b, sep[~has_a]])
            sep = sep[has_a]
    return _fm_refine(indptr, indices, ws, a, np.concatenate([b, unreach]),
                      np.sort(sep))


def _nd_dofs_python(n: int, indptr, indices, levels: int
                    ) -> Dict[int, np.ndarray]:
    """Reference implementation of the recursion (heap-indexed dof map)."""
    nsep = (1 << levels) - 1
    ws = _Workspace(n)
    boxes: Dict[int, np.ndarray] = {1: np.arange(n, dtype=np.int64)}
    dofs: Dict[int, np.ndarray] = {}
    for h in range(1, nsep + 1):
        verts = boxes[h]
        if h < (1 << (levels - 1)):
            a, b, s = _split(indptr, indices, verts, ws)
            dofs[h] = s
            boxes[2 * h] = a
            boxes[2 * h + 1] = b
        else:
            dofs[h] = np.sort(verts)
    return dofs


def _truncation_costs(dofs: Dict[int, np.ndarray], levels: int) -> np.ndarray:
    """Predicted factorization cost of truncating the heap-indexed separator
    tree at each depth L in 1..levels (cost[L-1] = depth-L tree).

    Truncating at L keeps separators above depth L-1 and merges each depth-
    (L-1) subtree into one leaf. The cost mirrors what the BATCHED engine
    executes: one padded [B, F, W] bucket per level, so every slot at a
    depth pays the depth's MAXIMUM pivot width W and an ancestor-path bound
    on the boundary K — cost per depth d is 2^d · (W³/3 + K·W² + 2·K²·W).
    On meshes deeper is monotonically cheaper (separators shrink
    geometrically and stay balanced); on expander-like graphs
    (random/circuit) separators neither shrink nor balance, so every extra
    level multiplies near-maximal boundary work by the batch — the
    bucket-max structure is exactly what the per-node panel count misses."""
    from cholesky_tpu_torch.utils import round_up

    nsep = (1 << levels) - 1
    size = np.zeros(nsep + 1)
    for h in range(1, nsep + 1):
        size[h] = len(dofs[h])
    subtree = size.copy()
    for h in range(nsep, 0, -1):
        if 2 * h + 1 <= nsep:
            subtree[h] += subtree[2 * h] + subtree[2 * h + 1]
    anc = np.zeros(nsep + 1)
    for h in range(2, nsep + 1):
        anc[h] = anc[h // 2] + size[h // 2]

    def c(w, k):
        w = round_up(max(int(w), 1), 8)
        k = round_up(int(k), 8) if k > 0 else 0
        return w ** 3 / 3.0 + k * w * w + 2.0 * k * k * w

    costs = np.empty(levels)
    for L in range(1, levels + 1):
        total = 0.0
        for d in range(L):
            lo, hi = 1 << d, min(1 << (d + 1), nsep + 1)
            s = size[lo:hi] if d < L - 1 else subtree[lo:hi]
            total += (hi - lo) * c(s.max(), anc[lo:hi].max())
        costs[L - 1] = total
    return costs


def _truncate_dofs(dofs: Dict[int, np.ndarray],
                   new_levels: int) -> Dict[int, np.ndarray]:
    """Merge each depth-(new_levels-1) subtree of the heap-indexed dof map
    into a single sorted leaf. Heap indices above the cut are preserved
    (the subtree walk is bounded by `g in dofs`, not by a depth count)."""
    out = {h: dofs[h] for h in range(1, 1 << (new_levels - 1))}
    for h in range(1 << (new_levels - 1), 1 << new_levels):
        parts, stack = [], [h]
        while stack:
            g = stack.pop()
            if g in dofs:
                parts.append(dofs[g])
                stack.extend((2 * g, 2 * g + 1))
        out[h] = np.sort(np.concatenate(parts))
    return out


def nested_dissection_graph(n: int, rows: np.ndarray, cols: np.ndarray,
                            levels: Optional[int] = None,
                            leaf_target: int = 96,
                            method: str = "auto",
                            md_max: int = 131072,
                            md_small: int = 16384,
                            info: Optional[dict] = None,
                            native: Optional[bool] = None,
                            threads: Optional[int] = None
                            ) -> Tuple[Ordering, ClusterHierarchy]:
    """Compute a fill-reducing Ordering for an arbitrary symmetric
    sparsity structure. `levels=None` picks depth so leaves are around
    `leaf_target` dofs.

    method: "auto" (default) additionally builds a MINIMUM-DEGREE
    candidate tree (symbolic/mdtree: MD ordering -> elimination tree ->
    legal binary separator tree with exactly MD's fill) when n <= md_max
    (always below md_small, above it only when the expander
    depth-collapse fired) and keeps whichever ordering has fewer exact
    symbolic-elimination FLOPs. Mesh-like graphs keep deep ND (which beats
    MD in 3-D); irregular graphs (expanders, hub graphs, unbalanced
    clusters) get minimum-degree quality through the same engine.
    "nd" / "md" force a single candidate.

    The planning core, the minimum-degree candidate and the FLOP counts
    run in the native library (`native/ext.py`: `nd_order` on `threads`
    threads, default min(cpus, 8), with output identical for every count;
    `md_order`; `col_counts`) when `native` is None and the library is
    available, or when `native=True` (which raises without it);
    `native=False` runs the Python paths, the parity oracle.

    `info`, when given, is filled with what was decided: the heuristic
    depth, the depth after the collapse, whether the minimum-degree
    candidate ran, each candidate's symbolic FLOPs and the one chosen, the
    engine that ran ("native" or "python") and the host seconds
    (`order_s`)."""
    from cholesky_tpu_torch.native import ext

    t0 = time.perf_counter()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    native = ext.use_native(native)
    auto_depth = levels is None
    if levels is None:
        levels = max(1, int(np.ceil(np.log2(max(n / leaf_target, 1)))) + 1)
    nsep = (1 << levels) - 1

    if native:
        sep_of = ext.nd_order(n, rows, cols, levels, threads)
        order = np.argsort(sep_of, kind="stable")   # dofs ascending per h
        bounds = np.searchsorted(sep_of[order], np.arange(1, nsep + 2))
        dofs = {h: order[(bounds[h - 1] if h > 1 else 0):bounds[h]]
                for h in range(1, nsep + 1)}
    else:
        indptr, indices = _build_adjacency(n, rows, cols)
        dofs = _nd_dofs_python(n, indptr, indices, levels)

    heur_levels = levels               # pre-collapse heuristic depth
    collapsed = False
    if auto_depth and levels > 1:
        # expander-like graphs (huge non-shrinking separators) pay MORE for
        # every added tree level; shrink the tree when a shallower
        # truncation is predicted decisively cheaper (25% margin keeps
        # mesh-like problems at the heuristic depth)
        costs = _truncation_costs(dofs, levels)
        best = int(np.argmin(costs))
        if costs[best] < 0.75 * costs[levels - 1]:
            levels = best + 1
            nsep = (1 << levels) - 1
            dofs = _truncate_dofs(dofs, levels)
            collapsed = True

    # Minimum-degree candidate (symbolic/mdtree): an MD ordering converted
    # into a legal binary separator tree with exactly MD's fill. ND keeps
    # its 3-D win; irregular graphs (expanders, hub graphs) get MD quality
    # through the same engine. Selection = exact symbolic elimination
    # FLOPs of each candidate's induced permutation (quality.fill_flops).
    #
    # Gating: the candidate always runs below MD_SMALL; past it, only on
    # a HARD depth-collapse (to <= half the heuristic depth) — the cheap
    # structural signal for exactly the irregular class where MD wins.
    # Collapse depths on the gallery: random/circuit expanders 9-11 -> 1,
    # imbalanced 11 -> 4 (all hard); fill-heavy meshes collapse MILDLY
    # (vector-elasticity 11 -> 7, aniso-3D 9 -> 7) and are spared the
    # minimum-degree candidate's host time (deep ND wins there anyway).
    # The MD tree is built at the PRE-collapse depth: the collapse models
    # the PADDED cost of the ND tree's fat separators, not the MD tree's
    # skinny chains.
    hard_collapse = collapsed and levels <= heur_levels // 2
    if info is not None:
        info.update(heuristic_levels=heur_levels, nd_levels=levels,
                    collapsed=collapsed, md_tried=False, chosen="nd")
    try_md = method == "md" or (
        method == "auto" and 1 < n <= md_max and heur_levels > 1
        and (hard_collapse or n <= md_small))
    if try_md:
        from cholesky_tpu_torch.symbolic import mdtree
        from cholesky_tpu_torch.symbolic.quality import permuted_cost

        md_levels = levels if method == "md" else max(heur_levels, 2)
        md_nsep = (1 << md_levels) - 1
        md_perm = mdtree.min_degree_perm(n, rows, cols, native=native)
        md_dofs = mdtree.tree_from_elimination(n, rows, cols, md_perm,
                                               md_levels)

        def perm_of(d, ns):
            return np.concatenate([d[h] for h in range(ns, 0, -1)])

        take_md = method == "md"
        if not take_md:
            md_cost = permuted_cost(n, rows, cols,
                                    perm_of(md_dofs, md_nsep),
                                    native=native)[0]
            nd_cost = permuted_cost(n, rows, cols, perm_of(dofs, nsep),
                                    native=native)[0]
            take_md = md_cost < nd_cost
            if info is not None:
                info.update(md_flops=md_cost, nd_flops=nd_cost)
        if take_md:
            dofs, levels, nsep = md_dofs, md_levels, md_nsep
        if info is not None:
            info.update(md_tried=True, chosen="md" if take_md else "nd")

    ordering = Ordering(
        levels=levels, num_separators=nsep,
        dofs={nsep - h + 1: dofs[h] for h in range(1, nsep + 1)})
    clusters = make_clusters(ordering, None)
    if info is not None:
        info.update(engine="native" if native else "python",
                    order_s=time.perf_counter() - t0)
    return ordering, clusters

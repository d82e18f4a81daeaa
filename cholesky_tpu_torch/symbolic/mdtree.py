"""Minimum-degree ordering and separator trees built from it.

The port's copy of `cholesky_tpu/symbolic/mdtree.py`. `min_degree_perm`
runs in the port's native library (`native/`, `md_order`, identical output)
when it is available and `exact=False`.

The reference consumes professional offline orderings (mnd.c:22 reads
them); the rebuild's standalone generator (symbolic/nd.py) matches or
beats them on mesh-like graphs but lost 1.7-2.3x schedule FLOPs to
SuperLU's MMD on irregular structures (random/circuit/imbalanced —
VERDICT r3 weak #4). Per-leaf minimum degree — the textbook ND+MD
hybrid — was prototyped and moved the ratio by <1%: on those graphs the
excess fill lives in the SEPARATORS (expander cuts do not shrink), not
in leaf-interior order.

This module closes the gap structurally instead: it computes a
minimum-degree ordering and converts it into a LEGAL heap-indexed
binary separator tree via the elimination tree —

  * distinct subtrees of an elimination tree are mutually non-adjacent
    (every path between them passes through common ancestors), so any
    grouping of whole subtrees into the two sides of a tree node is a
    valid bipartition with no crossing edges;
  * a node's separator is formed by PEELING root-chain vertices off the
    forest's dominant trees until the remaining subtrees pack into two
    balanced halves — peeled vertices are etree ancestors of everything
    below them, so eliminating them at their node respects dependence;
  * every node's dofs are ordered by their minimum-degree elimination
    position. The whole tree permutation is then a linear extension of
    the elimination tree, and any such extension reproduces the SAME
    filled pattern — the tree ordering inherits minimum degree's fill
    and schedule FLOPs EXACTLY (asserted in tests) while giving the
    batched frontal engine the complete-binary-tree structure it needs.

symbolic/nd.py's generator computes both candidates and keeps the
cheaper (symbolic fill FLOPs, quality.fill_flops), so mesh-like inputs
keep deep ND (which BEATS minimum degree in 3-D) and irregular inputs
get minimum-degree quality through the same engine.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np


def min_degree_perm(n: int, rows: np.ndarray, cols: np.ndarray,
                    exact: bool = False,
                    native: Optional[bool] = None) -> np.ndarray:
    """Minimum-degree ordering of the symmetric pattern (quotient graph:
    variables + elements, aggressive element absorption, edge pruning
    under element coverage, lazy heap). Degrees use the Amestoy-Davis-
    Duff approximate external-degree bound by default —
        d(u) <= |A_u| + |L_p \\ u| + sum_{e in E_u, e != p} |L_e \\ L_p|
    with the |L_e \\ L_p| terms computed in ONE sweep over the new
    element (the w-counter trick), so a pivot's update costs
    O(sum |lists|) instead of an exact set union per neighbor, with
    ordering quality within a few percent (exact=True restores the
    exact-degree recomputation). Once the minimum degree reaches
    remaining-1 the residual graph is (about to be) a clique and the
    tail is ordered by current degree — identical fill. Returns perm
    with perm[k] = original dof eliminated k-th.

    The default approximate-degree mode runs in the native library
    (`md_order`, a statement-level mirror with IDENTICAL output: the lazy
    (deg, v) heap makes the pop order container-independent) when `native`
    is None and the library is available, or when `native=True`;
    `native=False` runs the Python path here."""
    if not exact:
        from cholesky_tpu_torch.native import ext

        if ext.use_native(native):
            return ext.md_order(n, rows, cols)
    adj: List[set] = [set() for _ in range(n)]
    for r, c in zip(np.asarray(rows), np.asarray(cols)):
        if r != c:
            adj[r].add(int(c))
            adj[c].add(int(r))
    elems: List[set] = [set() for _ in range(n)]   # element ids touching v
    evert: Dict[int, set] = {}                     # element id -> live vars
    alive: Dict[int, bool] = {}
    deg = [len(adj[v]) for v in range(n)]
    heap = [(deg[v], v) for v in range(n)]
    heapq.heapify(heap)
    done = np.zeros(n, dtype=bool)
    perm: List[int] = []
    next_e = 0
    remaining = n
    while heap:
        d, v = heapq.heappop(heap)
        if done[v] or d != deg[v]:
            continue
        if d >= remaining - 1:
            # clique tail: one more elimination makes everyone full
            tail = [(deg[u], u) for u in range(n) if not done[u]]
            tail.sort()
            perm.extend(u for _, u in tail)
            break
        # form element L_v = adj(v) u (union of v's elements), minus v
        Lv = set(adj[v])
        for e in elems[v]:
            if alive.get(e):
                Lv |= evert[e]
                alive[e] = False                   # absorbed
        Lv.discard(v)
        Lv = {u for u in Lv if not done[u]}
        eid = next_e
        next_e += 1
        done[v] = True
        remaining -= 1
        perm.append(v)
        if not exact:
            # one sweep computes w[e] = |L_e \ L_v| for every element
            # touching L_v; elements fully covered (w == 0) absorb
            w: Dict[int, int] = {}
            for u in Lv:
                for e in elems[u]:
                    if alive.get(e):
                        w[e] = w.get(e, len(evert[e])) - 1
            for e, we in w.items():
                if we <= 0:
                    alive[e] = False
        evert[eid] = Lv
        alive[eid] = True
        lsz = len(Lv)
        for u in Lv:
            adj[u].discard(v)
            adj[u] -= Lv                           # covered by the element
            elems[u] = {e for e in elems[u] if alive.get(e)}
            elems[u].add(eid)
            if exact:
                s = set(adj[u])
                for e in elems[u]:
                    s |= evert[e]
                s.discard(u)
                deg[u] = len(s)
            else:
                ext = sum(w.get(e, len(evert[e]))
                          for e in elems[u] if e != eid)
                deg[u] = min(remaining - 1,
                             len(adj[u]) + (lsz - 1) + ext)
            heapq.heappush(heap, (deg[u], u))
    assert len(perm) == n
    return np.asarray(perm, dtype=np.int64)


def etree(n: int, rows: np.ndarray, cols: np.ndarray, perm: np.ndarray
          ) -> np.ndarray:
    """Liu's elimination-tree algorithm on the permuted pattern. Returns
    parent[] in PERMUTED indices (parent[j] > j, or -1 for roots)."""
    iperm = np.empty(n, dtype=np.int64)
    iperm[np.asarray(perm)] = np.arange(n)
    pr = iperm[np.asarray(rows)]
    pc = iperm[np.asarray(cols)]
    lo = np.minimum(pr, pc)
    hi = np.maximum(pr, pc)
    m = lo != hi
    lo, hi = lo[m], hi[m]
    order = np.argsort(hi, kind="stable")
    lo, hi = lo[order], hi[order]
    starts = np.searchsorted(hi, np.arange(n + 1))
    parent = np.full(n, -1, dtype=np.int64)
    anc = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for k in lo[starts[i]:starts[i + 1]]:
            # follow k's ancestor chain to its current root, link to i
            r = int(k)
            while anc[r] != -1 and anc[r] != i:
                nxt = anc[r]
                anc[r] = i                        # path compression
                r = nxt
            if anc[r] == -1 and r != i:
                anc[r] = i
                parent[r] = i
    return parent


def tree_from_elimination(n: int, rows: np.ndarray, cols: np.ndarray,
                          perm: np.ndarray, levels: int,
                          parent: np.ndarray = None
                          ) -> Dict[int, np.ndarray]:
    """Heap-indexed binary separator-tree dof map (same convention as
    nd._nd_dofs_python: h=1 root, children 2h/2h+1, leaves at depth
    levels-1) whose induced permutation is a linear extension of
    `perm`'s elimination tree — i.e. with exactly perm's fill. Values
    are ORIGINAL dof ids, each node ordered by elimination position."""
    if parent is None:
        parent = etree(n, rows, cols, perm)
    perm = np.asarray(perm, dtype=np.int64)
    kids: List[List[int]] = [[] for _ in range(n)]
    roots: List[int] = []
    for j in range(n):
        p = int(parent[j])
        if p >= 0:
            kids[p].append(j)
        else:
            roots.append(j)
    size = np.ones(n, dtype=np.int64)
    for j in range(n):                      # parents come after children
        p = int(parent[j])
        if p >= 0:
            size[p] += size[j]

    def subtree_vertices(r: int) -> List[int]:
        out, stack = [], [r]
        while stack:
            x = stack.pop()
            out.append(x)
            stack.extend(kids[x])
        return out

    nsep = (1 << levels) - 1
    dofs: Dict[int, np.ndarray] = {}

    def build(h: int, forest: List[int], depth: int):
        if depth == levels - 1:
            verts: List[int] = []
            for r in forest:
                verts.extend(subtree_vertices(r))
            verts.sort()                    # permuted position order
            dofs[h] = perm[np.asarray(verts, dtype=np.int64)] \
                if verts else np.empty(0, np.int64)
            return
        sep: List[int] = []
        pool = [(-int(size[r]), r) for r in forest]
        heapq.heapify(pool)
        total = int(sum(size[r] for r in forest))
        # peel dominant roots until the remaining subtrees pack into two
        # halves (a single tree can never split without peeling its root)
        while pool:
            neg, r = pool[0]
            rest = total - len(sep)
            if -neg <= 0.65 * rest and len(pool) >= 2:
                break
            heapq.heappop(pool)
            sep.append(r)
            for c in kids[r]:
                heapq.heappush(pool, (-int(size[c]), c))
            if not pool:
                break
        sep.sort()
        dofs[h] = perm[np.asarray(sep, dtype=np.int64)] \
            if sep else np.empty(0, np.int64)
        # greedy balanced bin packing of the remaining subtrees
        items = sorted(((int(size[r]), r) for _, r in pool), reverse=True)
        a: List[int] = []
        b: List[int] = []
        sa = sb = 0
        for sz, r in items:
            if sa <= sb:
                a.append(r)
                sa += sz
            else:
                b.append(r)
                sb += sz
        build(2 * h, a, depth + 1)
        build(2 * h + 1, b, depth + 1)

    build(1, roots, 0)
    return dofs


def check_separator_tree(n: int, rows: np.ndarray, cols: np.ndarray,
                         dofs: Dict[int, np.ndarray], levels: int) -> None:
    """Assert the separator property: no original edge connects the two
    child subtrees of any tree node (test helper)."""
    nsep = (1 << levels) - 1
    node_of = np.full(n, -1, dtype=np.int64)
    for h in range(1, nsep + 1):
        node_of[dofs[h]] = h
    assert (node_of >= 0).all(), "dofs do not cover all vertices"

    def is_anc(a: int, b: int) -> bool:     # a ancestor-or-self of b
        while b > 0:
            if b == a:
                return True
            b >>= 1
        return False

    for r, c in zip(np.asarray(rows), np.asarray(cols)):
        if r == c:
            continue
        hr, hc = int(node_of[r]), int(node_of[c])
        assert is_anc(hr, hc) or is_anc(hc, hr), (
            f"edge ({r},{c}) crosses tree nodes {hr},{hc}")

"""Built-in problem generator: grid Laplacians + geometric nested-dissection
orderings.

The port's copy of `cholesky_tpu/utils/laplacian.py`, line for line.

The reference consumes precomputed ord/clust files (its fixtures were
generated offline; utils.py:6-16 only does capacity planning for a 50^3
target). For standalone operation — benchmarks at the reference's
aspirational 125k-dof scale and beyond, multichip dry-runs without fixture
files — this module generates the same artifacts: an SPD d-point stencil
Laplacian in COO form, a separator `Ordering`, and a `ClusterHierarchy`,
all in the reference's numbering conventions (sep 1..2^levels-1, root last).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from cholesky_tpu_torch.io.ordering import ClusterHierarchy, Ordering


def grid_laplacian(shape: Tuple[int, ...]):
    """SPD Dirichlet Laplacian on a 1/2/3-D grid (5-/7-point stencil; the
    reference fixtures are exactly this: diag 2d, off-diagonal -1 —
    tests/lapl_9x9/lapl_3_2.mtx has diag 4).

    Returns (n, rows, cols, vals) with only the LOWER triangle stored
    (row >= col), matching MatrixMarket hermitian storage."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    d = len(shape)

    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 2.0 * d)]
    for ax in range(d):
        lo = np.take(idx, range(0, shape[ax] - 1), axis=ax).reshape(-1)
        hi = np.take(idx, range(1, shape[ax]), axis=ax).reshape(-1)
        rows.append(np.maximum(lo, hi))
        cols.append(np.minimum(lo, hi))
        vals.append(np.full(len(lo), -1.0))
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _bisect(box: Tuple[Tuple[int, int], ...]):
    """Split a box along its longest axis; returns (axis, plane, lo_box, hi_box).
    The separator is the middle plane; halves exclude it."""
    lengths = [hi - lo for lo, hi in box]
    ax = int(np.argmax(lengths))
    lo, hi = box[ax]
    mid = (lo + hi) // 2
    lo_box = tuple((l, h) if a != ax else (lo, mid) for a, (l, h) in enumerate(box))
    hi_box = tuple((l, h) if a != ax else (mid + 1, hi) for a, (l, h) in enumerate(box))
    return ax, mid, lo_box, hi_box


def _box_dofs(idx: np.ndarray, box) -> np.ndarray:
    sl = tuple(slice(lo, hi) for lo, hi in box)
    return idx[sl].reshape(-1)


def _plane_dofs(idx: np.ndarray, box, ax: int, plane: int) -> np.ndarray:
    sl = tuple(slice(lo, hi) if a != ax else slice(plane, plane + 1)
               for a, (lo, hi) in enumerate(box))
    return idx[sl].reshape(-1)


def nested_dissection(shape: Tuple[int, ...], levels: int,
                      cluster_size: Optional[int] = None
                      ) -> Tuple[Ordering, ClusterHierarchy]:
    """Geometric nested dissection of a grid into a complete binary separator
    tree with `levels` levels (2^levels - 1 separators).

    Numbering follows the reference (build_separator_tree, mmat.rg:835):
    heap index h holds separator num_separators - h + 1; the root (whole-grid
    middle plane) is separator 2^levels - 1; leaves are 1..2^(levels-1).

    cluster_size: interval-0 cluster granularity for each separator (dof
    boundaries every `cluster_size` dofs), with successive intervals merging
    pairs of clusters — giving the fill analysis real sub-block sparsity to
    exploit. None = single cluster per separator at every interval.
    """
    shape = tuple(int(s) for s in shape)
    nsep = (1 << levels) - 1
    idx = np.arange(int(np.prod(shape))).reshape(shape)

    # heap index -> box; root heap 1 covers everything
    boxes: Dict[int, Tuple] = {1: tuple((0, s) for s in shape)}
    dofs: Dict[int, np.ndarray] = {}
    for h in range(1, nsep + 1):
        box = boxes[h]
        if h < (1 << (levels - 1)):      # internal node: separator plane
            ax, plane, lo_box, hi_box = _bisect(box)
            if box[ax][1] <= box[ax][0]:
                # empty box (tree deeper than the grid): empty separator,
                # empty halves — slicing idx[lo:lo+1] here would steal a dof
                # that belongs to an ancestor separator
                dofs[h] = np.empty(0, dtype=idx.dtype)
            else:
                dofs[h] = _plane_dofs(idx, box, ax, plane)
            boxes[2 * h] = lo_box
            boxes[2 * h + 1] = hi_box
        else:                             # leaf: whole remaining box
            dofs[h] = _box_dofs(idx, box)

    ordering = Ordering(
        levels=levels, num_separators=nsep,
        dofs={nsep - h + 1: dofs[h] for h in range(1, nsep + 1)})

    clusters = make_clusters(ordering, cluster_size)
    return ordering, clusters


def make_clusters(ordering: Ordering, cluster_size: Optional[int] = None
                  ) -> ClusterHierarchy:
    """Build a ClusterHierarchy for an ordering.

    With cluster_size=None every separator is one cluster at every interval
    it participates in. With a size, interval 0 splits each separator's dof
    range into chunks of `cluster_size`; interval i merges pairs of interval
    i-1 clusters, reaching a single cluster by the separator's elimination
    interval (the invariant the reference's fill propagation requires)."""
    levels = ordering.levels
    nsep = ordering.num_separators
    intervals: Dict[int, List[np.ndarray]] = {}
    for s in range(1, nsep + 1):
        size = len(ordering.dofs[s])
        heap = nsep - s + 1
        lvl = heap.bit_length() - 1
        elim_interval = max(0, levels - 2 - lvl)
        # number of intervals this separator participates in: it is touched
        # from interval 0 through its elimination interval
        n_int = elim_interval + 1
        ivs: List[np.ndarray] = []
        if cluster_size is None:
            ivs.append(np.array([0, size], dtype=np.int64))
            for _ in range(1, n_int):
                ivs.append(np.array([0, 1], dtype=np.int64))
        else:
            # interval 0: chunks, but make sure we can halve down to one
            # cluster by elim_interval: start with at most 2^elim clusters
            nc0 = min(-(-size // cluster_size), 1 << elim_interval)
            nc0 = max(nc0, 1)
            b = np.unique(np.linspace(0, size, nc0 + 1).round().astype(np.int64))
            if len(b) < 2:     # empty separator: one zero-size cluster
                b = np.array([0, size], dtype=np.int64)
            ivs.append(b)
            nc = len(ivs[0]) - 1
            for _ in range(1, n_int):
                nxt = np.arange(0, nc + 1, 2, dtype=np.int64)
                if nxt[-1] != nc:
                    nxt = np.append(nxt, nc)
                ivs.append(nxt)
                nc = len(nxt) - 1
            # nc0 <= 2^elim_interval guarantees ceil-halving reaches one
            # cluster by the elimination interval (the reference invariant)
            assert nc == 1, (s, size, ivs)
        intervals[s] = ivs
    return ClusterHierarchy(levels=levels, num_separators=nsep,
                            intervals=intervals)


def generate_problem(shape: Tuple[int, ...], levels: int,
                     cluster_size: Optional[int] = None, seed: int = 0):
    """Full test problem: (n, rows, cols, vals, ordering, clusters, b)."""
    n, rows, cols, vals = grid_laplacian(shape)
    ordering, clusters = nested_dissection(shape, levels, cluster_size)
    rng = np.random.default_rng(seed)
    b = rng.integers(1, 11, size=n).astype(np.float64)   # verify.py:305-308
    return n, rows, cols, vals, ordering, clusters, b

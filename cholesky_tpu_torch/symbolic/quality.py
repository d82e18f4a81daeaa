"""Ordering-quality metrics: exact symbolic-elimination cost of a
permutation, by which `symbolic/nd.py` chooses between its nested-dissection
and minimum-degree candidates.

The port's copy of `fill_flops` / `_fill_flops_python` and `permuted_cost`
of `cholesky_tpu/symbolic/quality.py`. `fill_flops` runs the native
column-count core (`native/`, `col_counts`, identical output) when it is
available, the Python set-merge elimination otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fill_flops(n: int, rows: np.ndarray, cols: np.ndarray,
               native: Optional[bool] = None) -> Tuple[float, int]:
    """Exact symbolic factorization of the symmetric pattern: returns
    (sum cnt_j^2 column FLOPs, nnz(L)) for elimination in natural order.

    `native=None` takes the Gilbert-Ng-Peyton column-count core
    (`col_counts`, O(nnz alpha): it never forms L's structure) when the
    library is available, `native=True` requires it, `native=False` runs
    the Python set-merge elimination. An error inside the core
    propagates."""
    from cholesky_tpu_torch.native import ext

    if ext.use_native(native):
        cc = ext.col_counts(n, rows, cols)
        return float((cc.astype(np.float64) ** 2).sum()), int(cc.sum())
    return _fill_flops_python(n, rows, cols)


def _fill_flops_python(n: int, rows: np.ndarray, cols: np.ndarray
                       ) -> Tuple[float, int]:
    """Set-merge symbolic elimination (O(nnz(L)) set work): child
    structures merge into their elimination-tree parent once each."""
    adj = [set() for _ in range(n)]
    for r, c in zip(rows, cols):
        if r == c:
            continue
        lo, hi = (c, r) if r > c else (r, c)
        adj[lo].add(hi)
    children = [[] for _ in range(n)]
    struct = [None] * n
    flops = 0.0
    nnz = 0
    for j in range(n):
        s = adj[j]
        for ch in children[j]:
            s |= struct[ch]
            struct[ch] = None
        s.discard(j)
        struct[j] = s
        cnt = len(s) + 1
        flops += float(cnt) * cnt
        nnz += cnt
        if s:
            children[min(s)].append(j)
    return flops, nnz


def permuted_cost(n: int, rows: np.ndarray, cols: np.ndarray,
                  perm: np.ndarray, native: Optional[bool] = None
                  ) -> Tuple[float, int]:
    """Cost of eliminating in the order given by perm (perm[k] = original
    dof eliminated k-th)."""
    iperm = np.empty(n, dtype=np.int64)
    iperm[np.asarray(perm)] = np.arange(n)
    return fill_flops(n, iperm[rows], iperm[cols], native=native)

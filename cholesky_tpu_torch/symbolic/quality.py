"""Ordering-quality metrics: exact symbolic-elimination cost of a
permutation, by which `symbolic/nd.py` chooses between its nested-dissection
and minimum-degree candidates, and by which `tools/torch/nd_quality.py`
compares this package's ordering with RCM and SuperLU's orderings.

The port's copy of `cholesky_tpu/symbolic/quality.py`. `fill_flops` runs
the native column-count core (`native/`, `col_counts`, identical output)
when it is available, the Python set-merge elimination otherwise.
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


def nd_cost(n, rows, cols, vals=None, levels=None) -> Tuple[float, int]:
    """Symbolic cost of this package's graph-ND ordering (auto depth when
    levels is None, including the expander depth-collapse policy; pass an
    explicit levels to measure the deep ordering itself)."""
    from cholesky_tpu_torch.symbolic.nd import nested_dissection_graph
    from cholesky_tpu_torch.symbolic.plan import build_plan

    o, cl = nested_dissection_graph(n, rows, cols, levels=levels)
    return permuted_cost(n, rows, cols, build_plan(o, cl).perm)


def _sym_csr(n, rows, cols, vals):
    import scipy.sparse

    off = rows != cols
    return scipy.sparse.csr_matrix(
        (np.concatenate([vals, vals[off]]),
         (np.concatenate([rows, cols[off]]),
          np.concatenate([cols, rows[off]]))), shape=(n, n))


def rcm_cost(n, rows, cols, vals) -> Tuple[float, int]:
    """Symbolic cost of SciPy's reverse Cuthill-McKee ordering: a
    bandwidth orderer, the weakest rival (kept for context)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.asarray(reverse_cuthill_mckee(_sym_csr(n, rows, cols, vals),
                                            symmetric_mode=True))
    return permuted_cost(n, rows, cols, perm)


def superlu_cost(n, rows, cols, vals,
                 permc_spec: str = "MMD_AT_PLUS_A") -> Tuple[float, int]:
    """Symbolic cost of SuperLU's fill-reducing orderings, taken from
    scipy.sparse.linalg.splu's column permutation: 'MMD_AT_PLUS_A'
    (multiple minimum degree on the symmetric structure, the standard
    direct-solver ordering for symmetric systems) or 'COLAMD'. Row pivoting
    (perm_r) does not affect perm_c, so the numeric factorization splu
    performs is only a means to the ordering."""
    from scipy.sparse.linalg import splu

    a = _sym_csr(n, rows, cols, vals).tocsc()
    lu = splu(a, permc_spec=permc_spec,
              options=dict(SymmetricMode=True, DiagPivotThresh=0.0))
    # scipy's perm_c maps ORIGINAL index -> permuted position; this
    # module's convention is perm[k] = original dof eliminated k-th
    # (verified against splu's own nnz(L) on a 48x48 grid: the inverse
    # reproduces it, the as-is orientation is ~70x worse than natural)
    pc = np.asarray(lu.perm_c)
    perm = np.empty_like(pc)
    perm[pc] = np.arange(n)
    return permuted_cost(n, rows, cols, perm)

"""SPD problem gallery beyond grid Laplacians.

The port's copy of `cholesky_tpu/utils/problems.py` (NumPy only), line for
line: both packages generate identical arrays.

The reference ships only grid-Laplacian fixtures (tests/lapl_*; SURVEY §2
item 11) and its aspirational target is another grid Laplacian
(utils.py:43-47). BASELINE.md's north star additionally tracks "SuiteSparse
SPD matrices" — structurally diverse real-world symmetric positive-definite
systems. This module generates local
stand-ins for the SuiteSparse families that matter structurally:

- ``anisotropic_laplacian``: grid stencils with per-axis coefficient
  contrast (thermal/ reservoir-simulation style conditioning — e.g. the
  ``thermal``/``apache`` families).
- ``fem_q4``: bilinear-quad finite-element stiffness with random positive
  per-element coefficients plus a mass shift — the random-coefficient FEM
  structure of MATLAB's ``gallery('wathen')`` / SuiteSparse ``wathen``.
  The Q4 Laplace element stiffness (1/6)·[[4,-1,-2,-1],[-1,4,-1,-2],
  [-2,-1,4,-1],[-1,-2,-1,4]] is exact for the unit-square bilinear element.
- ``vector_laplacian``: ``ncomp`` interleaved dofs per grid node with SPD
  cross-component coupling (A = L ⊗ C + shift) — the multi-dof-per-node
  block structure of elasticity problems (``bcsstk``/``af_shell`` style),
  which stresses nested dissection's treatment of vertex blocks.
- ``random_spd``: diagonally-dominant random sparsity, optionally with a
  power-law degree skew (circuit-simulation style irregular graphs) — the
  adversarial case for the BFS/FM separator heuristics in symbolic/nd.py.

Every generator returns ``(n, rows, cols, vals)`` with the strict lower
triangle plus diagonal only (the package's canonical COO form, matching
mmio.dedup_lower output), ready for ``SparseCholesky.from_matrix`` — the
no-precomputed-ordering entry point the reference lacks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Coo = Tuple[int, np.ndarray, np.ndarray, np.ndarray]


def _to_lower_coo(n: int, rows: np.ndarray, cols: np.ndarray,
                  vals: np.ndarray) -> Coo:
    """Accumulate duplicate (i,j) entries and keep the lower triangle."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    lo = np.where(rows >= cols, rows, cols)
    hi = np.where(rows >= cols, cols, rows)
    key = lo * n + hi
    order = np.argsort(key, kind="stable")
    key, lo, hi, vals = key[order], lo[order], hi[order], vals[order]
    uniq, start = np.unique(key, return_index=True)
    acc = np.add.reduceat(vals, start)
    return n, lo[start], hi[start], acc


def anisotropic_laplacian(shape: Tuple[int, ...],
                          coeff: Optional[Tuple[float, ...]] = None) -> Coo:
    """Grid Laplacian with per-axis diffusion coefficients.

    ``coeff[d]`` scales the stencil along axis ``d``; strong contrast
    (e.g. ``(1.0, 1e-3)``) produces the ill-conditioned, direction-skewed
    systems typical of thermal/reservoir problems. ``coeff=None`` gives the
    isotropic Laplacian (identical values to utils/laplacian.py's
    ``grid_laplacian``, which this generalizes)."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    if coeff is None:
        coeff = (1.0,) * ndim
    if len(coeff) != ndim:
        raise ValueError("coeff must have one entry per axis")
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    diag = np.full(n, 2.0 * float(np.sum(coeff)))
    vals = [diag]
    for ax, c in enumerate(coeff):
        lo = [slice(None)] * ndim
        hi = [slice(None)] * ndim
        lo[ax] = slice(1, None)
        hi[ax] = slice(None, -1)
        a = idx[tuple(lo)].ravel()
        b = idx[tuple(hi)].ravel()
        rows.append(a)
        cols.append(b)
        vals.append(np.full(a.size, -float(c)))
    return _to_lower_coo(n, np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals))


# Bilinear quad (Q4) Laplace element stiffness on the unit square,
# node order (0,0),(1,0),(1,1),(0,1). PSD with nullspace = constants.
_Q4 = np.array([[4.0, -1.0, -2.0, -1.0],
                [-1.0, 4.0, -1.0, -2.0],
                [-2.0, -1.0, 4.0, -1.0],
                [-1.0, -2.0, -1.0, 4.0]]) / 6.0


def fem_q4(nx: int, ny: int, seed: int = 0, shift: float = 1e-2) -> Coo:
    """Random-coefficient Q4 finite-element stiffness on an nx×ny element
    grid ((nx+1)(ny+1) nodes): A = Σ_e ρ_e K_e + shift·I with ρ_e ~ U(0.5,
    5.5). The Wathen-matrix structure (random positive element weights on a
    regular FE mesh); SPD because each K_e is PSD and shift > 0."""
    rng = np.random.default_rng(seed)
    nnx, nny = nx + 1, ny + 1
    n = nnx * nny
    node = np.arange(n).reshape(nny, nnx)
    # element -> its 4 node ids, shape [ne, 4]
    e00 = node[:-1, :-1].ravel()
    e10 = node[:-1, 1:].ravel()
    e11 = node[1:, 1:].ravel()
    e01 = node[1:, :-1].ravel()
    enodes = np.stack([e00, e10, e11, e01], axis=1)
    rho = rng.uniform(0.5, 5.5, size=enodes.shape[0])
    # scatter the element matrix; keep i >= j only, else _to_lower_coo
    # would fold K_e[p,q] and K_e[q,p] together and double off-diagonals
    i = np.repeat(enodes, 4, axis=1).ravel()          # [ne*16]
    j = np.tile(enodes, (1, 4)).ravel()
    v = (rho[:, None] * _Q4.ravel()[None, :]).ravel()
    keep = i >= j
    i, j, v = i[keep], j[keep], v[keep]
    rows = np.concatenate([i, np.arange(n)])
    cols = np.concatenate([j, np.arange(n)])
    vals = np.concatenate([v, np.full(n, shift)])
    return _to_lower_coo(n, rows, cols, vals)


def vector_laplacian(shape: Tuple[int, ...], ncomp: int = 3,
                     shift: float = 1e-2) -> Coo:
    """Multi-component grid operator: A = L ⊗ C + shift·I with L the grid
    Laplacian and C an SPD ``ncomp``×``ncomp`` coupling (tridiagonal
    [1,2,1]). Dofs are interleaved node-major (dof = node*ncomp + comp) —
    the elasticity-style vertex-block structure."""
    n_nodes, lr, lc, lv = anisotropic_laplacian(shape)
    c_mat = (2.0 * np.eye(ncomp) + np.eye(ncomp, k=1) + np.eye(ncomp, k=-1))
    ci, cj = np.nonzero(c_mat)
    cv = c_mat[ci, cj]
    # kron over lower-triangle L entries: block (lr,lc) gets full C when
    # lr > lc; the diagonal block keeps C's lower triangle only
    off = lr != lc
    ro = (lr[off, None] * ncomp + ci[None, :]).ravel()
    co = (lc[off, None] * ncomp + cj[None, :]).ravel()
    vo = (lv[off, None] * cv[None, :]).ravel()
    dmask = ci >= cj
    rd = (lr[~off, None] * ncomp + ci[None, dmask]).ravel()
    cd = (lc[~off, None] * ncomp + cj[None, dmask]).ravel()
    vd = (lv[~off, None] * cv[None, dmask]).ravel()
    n = n_nodes * ncomp
    rows = np.concatenate([ro, rd, np.arange(n)])
    cols = np.concatenate([co, cd, np.arange(n)])
    vals = np.concatenate([vo, vd, np.full(n, shift)])
    return _to_lower_coo(n, rows, cols, vals)


def random_spd(n: int, avg_degree: int = 6, seed: int = 0,
               skew: bool = False) -> Coo:
    """Random symmetric sparsity with diagonal dominance (hence SPD).

    ``skew=True`` draws endpoints with a power-law bias so a few vertices
    get large degree — the hub-dominated structure of circuit matrices,
    where geometric separator heuristics have no grid to exploit."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree // 2
    if skew:
        # quadratic bias toward low ids = hubs
        a = (rng.uniform(size=m) ** 2 * n).astype(np.int64)
        b = rng.integers(0, n, size=m)
    else:
        a = rng.integers(0, n, size=m)
        b = rng.integers(0, n, size=m)
    keep = a != b
    a, b = a[keep], b[keep]
    v = -rng.uniform(0.1, 1.0, size=a.size)
    # diagonal = 1 + sum of |off-diag| over the full row (both triangles)
    diag = np.ones(n)
    np.add.at(diag, a, -v)
    np.add.at(diag, b, -v)
    rows = np.concatenate([a, np.arange(n)])
    cols = np.concatenate([b, np.arange(n)])
    vals = np.concatenate([v, diag])
    n2, r2, c2, v2 = _to_lower_coo(n, rows, cols, vals)
    # duplicate (a,b) draws accumulated their -v into vals but their |v|
    # into diag once per draw, so dominance still holds exactly
    return n2, r2, c2, v2


def dense_row_spd(shape: Tuple[int, ...], k_dense: int = 3,
                  seed: int = 0) -> Coo:
    """Grid Laplacian plus ``k_dense`` DENSE rows/columns coupled to every
    dof — the power-rail / ground-net structure of circuit matrices and the
    Lagrange-multiplier rows of constrained FEM systems (SuiteSparse's
    ``bcsstk``/``c-`` families). A dense row makes its vertex adjacent to
    the whole graph, so every separator-tree level's boundary must carry it:
    the adversarial case for exact-boundary frontal analysis and for the
    bucketing machinery (one huge front row in otherwise small fronts).
    SPD by diagonal dominance of the added rows."""
    rng = np.random.default_rng(seed)
    n0, lr, lc, lv = anisotropic_laplacian(shape)
    n = n0 + k_dense
    # dense rows sit at the END in natural numbering; auto-ND must discover
    # they belong in the root separator
    dr, dc, dv = [lr], [lc], [lv]
    for t in range(k_dense):
        i = n0 + t
        coup = -rng.uniform(0.01, 0.1, size=i)        # row i vs all j < i
        dr.append(np.full(i, i, dtype=np.int64))
        dc.append(np.arange(i, dtype=np.int64))
        dv.append(coup)
        dr.append(np.array([i], dtype=np.int64))
        dc.append(np.array([i], dtype=np.int64))
        dv.append(np.array([2.0 * np.abs(coup).sum() + 1.0]))
        # and symmetric dominance margin on the existing diagonal
        dr.append(np.arange(i, dtype=np.int64))
        dc.append(np.arange(i, dtype=np.int64))
        dv.append(np.abs(coup))
    return _to_lower_coo(n, np.concatenate(dr), np.concatenate(dc),
                         np.concatenate(dv))


def imbalanced_spd(big_shape: Tuple[int, ...] = (40, 40),
                   small_shape: Tuple[int, ...] = (40, 2),
                   bridge: int = 3, seed: int = 0) -> Coo:
    """Two grid components of very different sizes joined by ``bridge``
    random edges — huge separator imbalance: any balanced bisection of the
    vertex set must cut the BIG component internally, while the natural
    separator (the bridge) splits 95/5. Multilevel/graph ND heuristics that
    assume balanced parts produce skewed trees here; the bucketing machinery
    sees sibling subtrees of wildly different front sizes."""
    rng = np.random.default_rng(seed)
    nb, br_, bc_, bv_ = anisotropic_laplacian(big_shape)
    ns, sr_, sc_, sv_ = anisotropic_laplacian(small_shape)
    n = nb + ns
    bi = rng.integers(0, nb, size=bridge)
    bj = nb + rng.integers(0, ns, size=bridge)
    bv = -rng.uniform(0.1, 0.5, size=bridge)
    diag_fix_r = np.concatenate([bi, bj])
    diag_fix_v = np.concatenate([-bv, -bv])           # keep dominance
    rows = np.concatenate([br_, sr_ + nb, bj, diag_fix_r])
    cols = np.concatenate([bc_, sc_ + nb, bi, diag_fix_r])
    vals = np.concatenate([bv_, sv_, bv, diag_fix_v])
    return _to_lower_coo(n, rows, cols, vals)


def make_gallery(scale: int = 1):
    """The canonical gallery at `scale`× the (CPU-test-sized) defaults.
    scale=4 reaches ~100k-dof problems worth running on an accelerator."""
    k = int(scale)
    return {
        "aniso2d": lambda: anisotropic_laplacian((48 * k, 48 * k),
                                                 (1.0, 1e-3)),
        "aniso3d": lambda: anisotropic_laplacian(
            (12 * k, 12 * k, 12 * k), (1.0, 0.1, 1e-3)),
        "wathen": lambda: fem_q4(24 * k, 24 * k, seed=1),
        "elasticity": lambda: vector_laplacian((14 * k, 14 * k), ncomp=3),
        "random": lambda: random_spd(1500 * k * k, avg_degree=8, seed=2),
        "circuit": lambda: random_spd(1500 * k * k, avg_degree=8, seed=3,
                                      skew=True),
        "dense_rows": lambda: dense_row_spd((30 * k, 30 * k), k_dense=3),
        "imbalanced": lambda: imbalanced_spd((40 * k, 40 * k), (40 * k, 2),
                                             bridge=3),
    }


GALLERY = make_gallery()

"""The 7-point Dirichlet Laplacian on a 3-D grid, shifted: A = L + s I.

Plain NumPy; nothing here imports the solver under test.

  * `coo(cfg)`: the lower triangle of L (row >= col) in COO form, the
    matrix handed to the solver;
  * `separators(cfg)`: geometric nested dissection of the grid into a
    complete binary separator tree of `cfg["levels"]` levels;
  * `Reference`: A x by the stencil on the grid in float64, worked out from
    the configuration's shape and the shift alone, not from the COO arrays
    the solver was given;
  * `build(cfg, device)`: the solver under test, planned on this matrix and
    ordering (`SparseCholesky.from_coo`); the only function here that
    imports it.

`coo` and `separators` are a frozen copy of the generator that the solver's
package carries (`grid_laplacian`, `nested_dissection` in its
`utils/laplacian.py`), so that a change to the solver cannot change the
problem the benchmark poses. Separator numbering follows it: separators
1 .. 2^levels - 1, leaves first, the root (the whole grid's middle plane)
last; heap index h holds separator 2^levels - h.
"""

from __future__ import annotations

import numpy as np


def shape_of(cfg):
    return tuple(int(s) for s in cfg["operator"]["shape"])


def coo(cfg):
    """(n, rows, cols, vals): the lower triangle of L, diagonal 2d = 6 and
    -1 between grid neighbours, Dirichlet (no wrap-around)."""
    shape = shape_of(cfg)
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows, cols = [np.arange(n)], [np.arange(n)]
    vals = [np.full(n, 2.0 * len(shape))]
    for ax in range(len(shape)):
        lo = np.take(idx, range(0, shape[ax] - 1), axis=ax).reshape(-1)
        hi = np.take(idx, range(1, shape[ax]), axis=ax).reshape(-1)
        rows.append(np.maximum(lo, hi))
        cols.append(np.minimum(lo, hi))
        vals.append(np.full(len(lo), -1.0))
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _bisect(box):
    """Split a box at the middle plane of its longest axis: (axis, plane,
    lower half, upper half); the halves exclude the plane."""
    lengths = [hi - lo for lo, hi in box]
    ax = int(np.argmax(lengths))
    lo, hi = box[ax]
    mid = (lo + hi) // 2
    lo_box = tuple((a, b) if i != ax else (lo, mid)
                   for i, (a, b) in enumerate(box))
    hi_box = tuple((a, b) if i != ax else (mid + 1, hi)
                   for i, (a, b) in enumerate(box))
    return ax, mid, lo_box, hi_box


def separators(cfg):
    """{separator: its grid dofs} of the nested dissection, 1-based."""
    shape = shape_of(cfg)
    levels = int(cfg["levels"])
    nsep = (1 << levels) - 1
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    boxes = {1: tuple((0, s) for s in shape)}
    dofs = {}
    for h in range(1, nsep + 1):
        box = boxes[h]
        if h < (1 << (levels - 1)):           # internal node: a plane
            ax, plane, lo_box, hi_box = _bisect(box)
            if box[ax][1] <= box[ax][0]:      # empty box: empty separator
                dofs[h] = np.empty(0, dtype=idx.dtype)
            else:
                sl = tuple(slice(a, b) if i != ax else slice(plane, plane + 1)
                           for i, (a, b) in enumerate(box))
                dofs[h] = idx[sl].reshape(-1)
            boxes[2 * h], boxes[2 * h + 1] = lo_box, hi_box
        else:                                 # leaf: the remaining box
            dofs[h] = idx[tuple(slice(a, b) for a, b in box)].reshape(-1)
    return {nsep - h + 1: dofs[h] for h in range(1, nsep + 1)}


class Reference:
    """A = L + shift I applied by the stencil in float64."""

    def __init__(self, cfg):
        self.shape = shape_of(cfg)
        # neighbours of each grid point: 2d minus those beyond the boundary
        nb = np.zeros(self.shape)
        for ax in range(len(self.shape)):
            cnt = np.full(self.shape[ax], 2.0)
            cnt[0] -= 1
            cnt[-1] -= 1
            nb += cnt.reshape([-1 if i == ax else 1
                               for i in range(len(self.shape))])
        self.neighbours = nb

    def matvec(self, x, shift):
        """A x for x of [n] or [n, k]."""
        x = np.asarray(x, dtype=np.float64)
        u = x.reshape(self.shape + x.shape[1:])
        y = (2.0 * len(self.shape) + shift) * u
        for ax in range(len(self.shape)):
            lo = [slice(None)] * u.ndim
            hi = [slice(None)] * u.ndim
            lo[ax], hi[ax] = slice(0, -1), slice(1, None)
            y[tuple(lo)] -= u[tuple(hi)]
            y[tuple(hi)] -= u[tuple(lo)]
        return y.reshape(x.shape)

    def norm_inf(self, shift):
        """||A||_inf: the largest absolute row sum."""
        return float(np.max(abs(2.0 * len(self.shape) + shift)
                            + self.neighbours))


def build(cfg, device):
    """(solver, vals): the solver planned on `coo(cfg)` under
    `separators(cfg)`, with the configuration's dtype and matmul rung, and
    the values `vals` aligned with its stored pattern."""
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.io.ordering import Ordering

    n, rows, cols, vals = coo(cfg)
    seps = separators(cfg)
    solver = SparseCholesky.from_coo(
        n, rows, cols, vals, Ordering(int(cfg["levels"]), len(seps), seps),
        dtype=np.dtype(cfg["dtype"]), device=device,
        precision=cfg["precision"])
    if not (np.array_equal(solver.rows, rows)
            and np.array_equal(solver.cols, cols)):
        raise RuntimeError("the solver reordered the COO entries; the "
                           "generator's values would not align")
    return solver, vals

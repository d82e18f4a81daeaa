"""3-D linear elasticity on Q1 bricks, shifted: A = K + s I.

The discretization of PETSc's `src/ksp/ksp/tutorials/ex56.c`: the unit
cube cut into ne^3 trilinear hexahedra of side h = 1 / ne, an isotropic
homogeneous material (Young's modulus E, Poisson's ratio nu), the face
y = 0 clamped. Each node carries its three displacements, interleaved
(dof = 3 node + component); the clamped nodes are dropped, and the free
nodes are numbered in C order over the (ne + 1) x ne x (ne + 1) grid of
(x, y - 1, z). The shift s I is the Newmark mass term (`mixes/newmark.json`).

  * `coo(cfg)`: the lower triangle of the assembled stiffness K (row >=
    col) in COO form, every 3 x 3 block of two coupled nodes stored whole;
  * `separators(cfg)`: geometric nested dissection of the node grid into
    a complete binary separator tree of `cfg["levels"]` levels, each node
    taking its three dofs along;
  * `Reference`: A x element by element in float64, worked out from the
    configuration alone, not from the COO arrays the solver was given;
  * `build(cfg, device)`: the solver under test, planned on this matrix and
    ordering (`SparseCholesky.from_coo`); the only function here that
    imports it.

Plain NumPy and PyTorch; nothing here but `build` imports the solver.
"""

from __future__ import annotations

import numpy as np

DOFS = 3                       # displacements per node
CORNERS = 8                    # nodes per brick, local a = 4 ax + 2 ay + az
ELEMENT_VALUES = 1 << 19       # elements x columns per step of the reference


def _params(cfg):
    op = cfg["operator"]
    return int(op["ne"]), float(op["E"]), float(op["nu"])


def lame(E, nu):
    """(lambda, mu) of Young's modulus and Poisson's ratio."""
    return E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))


def _corner_offsets():
    """[8, 3] offsets (ax, ay, az) of the local nodes of a brick."""
    a = np.arange(CORNERS)
    return np.stack([(a >> 2) & 1, (a >> 1) & 1, a & 1], axis=1)


def element_stiffness(h, E, nu):
    """K_e [24, 24] of a brick of side h: the integral of B^T D B over the
    brick by 2 x 2 x 2 Gauss points (exact for a brick), engineering strains
    in Voigt order (xx, yy, zz, yz, xz, xy), dofs 3 a + component."""
    lam, mu = lame(E, nu)
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    corners = _corner_offsets()
    g = 0.5 / np.sqrt(3.0)
    K = np.zeros((DOFS * CORNERS, DOFS * CORNERS))
    for q in _corner_offsets():
        xi = 0.5 + g * (2 * q - 1)                   # the point in [0, 1]^3
        # shape factors per corner and axis: xi where the corner sits at 1
        f = np.where(corners == 1, xi, 1 - xi)       # [8, 3]
        s = np.where(corners == 1, 1.0, -1.0)        # d f / d xi
        grad = np.empty((CORNERS, 3))                # dN_a / dx_d
        for d in range(3):
            others = [e for e in range(3) if e != d]
            grad[:, d] = s[:, d] * f[:, others[0]] * f[:, others[1]] / h
        Bm = np.zeros((6, DOFS * CORNERS))
        for a in range(CORNERS):
            gx, gy, gz = grad[a]
            c = DOFS * a
            Bm[0, c], Bm[1, c + 1], Bm[2, c + 2] = gx, gy, gz
            Bm[3, c + 1], Bm[3, c + 2] = gz, gy
            Bm[4, c], Bm[4, c + 2] = gz, gx
            Bm[5, c], Bm[5, c + 1] = gy, gx
        K += Bm.T @ D @ Bm * (h ** 3 / 8.0)
    return K


def node_shape(cfg):
    """The free node grid (x, y - 1, z)."""
    ne = _params(cfg)[0]
    return (ne + 1, ne, ne + 1)


def coo(cfg):
    """(n, rows, cols, vals): the lower triangle of K. The 3 x 3 block of
    two nodes i, j = i + d sums K_e's block over the bricks holding both;
    it is accumulated per offset d on the whole node grid (the clamped
    plane y = 0 included), then the clamped nodes are dropped."""
    ne, E, nu = _params(cfg)
    Ke = element_stiffness(1.0 / ne, E, nu).reshape(CORNERS, DOFS, CORNERS,
                                                    DOFS)
    corners = _corner_offsets()
    m = ne + 1
    blocks = {}                     # d -> [m, m, m, 3, 3] at node i
    for a in range(CORNERS):
        for b in range(CORNERS):
            d = tuple(corners[b] - corners[a])
            arr = blocks.setdefault(d, np.zeros((m, m, m, DOFS, DOFS)))
            x, y, z = corners[a]
            arr[x:x + ne, y:y + ne, z:z + ne] += Ke[a, :, b, :]
    shape = node_shape(cfg)
    node = np.arange(int(np.prod(shape))).reshape(shape)
    comp = np.arange(DOFS)
    rows, cols, vals = [], [], []
    # node j = i + d comes before node i in the C-order numbering exactly
    # when d is lexicographically negative; d = 0 keeps its lower half
    for d in sorted(blocks):
        if d > (0, 0, 0):
            continue
        dx, dy, dz = d
        # free nodes i (grid y >= 1) whose neighbour j is in the grid and
        # free
        lo = [max(0, -dx), max(1, 1 - dy), max(0, -dz)]
        hi = [m - max(0, dx), m - max(0, dy), m - max(0, dz)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        vi = node[lo[0]:hi[0], lo[1] - 1:hi[1] - 1, lo[2]:hi[2]].reshape(-1)
        vj = node[lo[0] + dx:hi[0] + dx, lo[1] - 1 + dy:hi[1] - 1 + dy,
                  lo[2] + dz:hi[2] + dz].reshape(-1)
        v = blocks[d][lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].reshape(
            -1, DOFS, DOFS)
        r = DOFS * vi[:, None, None] + comp[None, :, None]
        c = DOFS * vj[:, None, None] + comp[None, None, :]
        r, c = np.broadcast_arrays(r, c)
        keep = (r >= c).reshape(-1)
        rows.append(r.reshape(-1)[keep])
        cols.append(c.reshape(-1)[keep])
        vals.append(v.reshape(-1)[keep])
    n = DOFS * int(np.prod(shape))
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


# ------------------------------------------------------------- the ordering
# A frozen copy of `laplacian7.separators`, on the node grid.

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


def node_separators(cfg):
    """{separator: its grid nodes} of the nested dissection of the node
    grid, 1-based: separators 1 .. 2^levels - 1, leaves first, the root
    last; heap index h holds separator 2^levels - h."""
    shape = node_shape(cfg)
    levels = int(cfg["levels"])
    nsep = (1 << levels) - 1
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    boxes = {1: tuple((0, s) for s in shape)}
    nodes = {}
    for h in range(1, nsep + 1):
        box = boxes[h]
        if h < (1 << (levels - 1)):           # internal node: a plane
            ax, plane, lo_box, hi_box = _bisect(box)
            if box[ax][1] <= box[ax][0]:      # empty box: empty separator
                nodes[h] = np.empty(0, dtype=idx.dtype)
            else:
                sl = tuple(slice(a, b) if i != ax else slice(plane, plane + 1)
                           for i, (a, b) in enumerate(box))
                nodes[h] = idx[sl].reshape(-1)
            boxes[2 * h], boxes[2 * h + 1] = lo_box, hi_box
        else:                                 # leaf: the remaining box
            nodes[h] = idx[tuple(slice(a, b) for a, b in box)].reshape(-1)
    return {nsep - h + 1: nodes[h] for h in range(1, nsep + 1)}


def separators(cfg):
    """{separator: its dofs}: each node of `node_separators` with its three
    displacements, in node order."""
    comp = np.arange(DOFS)
    return {s: (DOFS * v[:, None] + comp).reshape(-1)
            for s, v in node_separators(cfg).items()}


# ------------------------------------------------------------ the reference

class Reference:
    """A = K + shift I applied brick by brick in float64 on the CPU, in
    plain PyTorch: each brick's 24 displacements gathered (a clamped node's
    read as zero), multiplied by K_e, scattered back with `index_add_`.
    Its own brick loop, independent of `coo`; it never sees the solver's
    arrays."""

    def __init__(self, cfg):
        import torch

        # f64 products on the CPU never take TF32; the flags are cleared all
        # the same, so that the reference stays exact if it is ever run on
        # a card, or on f32 data
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ne, E, nu = _params(cfg)
        self.ne = ne
        self.n = DOFS * int(np.prod(node_shape(cfg)))
        self.Ke = torch.from_numpy(element_stiffness(1.0 / ne, E, nu))
        # the element's dofs in the free numbering; clamped ones -> n (zero)
        e = np.arange(ne)
        ex, ey, ez = np.meshgrid(e, e, e, indexing="ij")
        corners = _corner_offsets()
        x = ex.reshape(-1, 1) + corners[:, 0]
        y = ey.reshape(-1, 1) + corners[:, 1]
        z = ez.reshape(-1, 1) + corners[:, 2]
        node = (x * ne + (y - 1)) * (ne + 1) + z           # [ne^3, 8]
        dof = DOFS * node[:, :, None] + np.arange(DOFS)
        dof[y == 0] = self.n
        self.dofs = torch.from_numpy(dof.reshape(-1, DOFS * CORNERS))
        self._rows = None

    def matvec(self, x, shift):
        """A x for x of [n] or [n, k] (NumPy or torch); a NumPy array."""
        import torch

        xt = torch.as_tensor(np.asarray(x, dtype=np.float64))
        vec = xt.dim() == 1
        xt = xt.reshape(self.n, -1)
        k = xt.shape[1]
        xz = torch.cat([xt, xt.new_zeros((1, k))])
        y = torch.zeros_like(xz)
        step = max(1, ELEMENT_VALUES // k)
        for e0 in range(0, self.dofs.shape[0], step):
            idx = self.dofs[e0:e0 + step]                   # [e, 24]
            ue = xz[idx].transpose(1, 2)                    # [e, k, 24]
            fe = ue.reshape(-1, DOFS * CORNERS) @ self.Ke   # K_e symmetric
            y.index_add_(0, idx.reshape(-1), fe.view(
                -1, k, DOFS * CORNERS).transpose(1, 2).reshape(-1, k))
        out = y[:self.n] + shift * xt
        return (out[:, 0] if vec else out).numpy()

    def _row_sums(self):
        """(diagonal of K, sum of |K_ij| over j != i): K's 3 x 3 node
        blocks assembled brick by brick, per node and neighbour offset
        (27 a node), then summed along each row."""
        if self._rows is None:
            import torch

            nodes = self.n // DOFS                          # sentinel: clamped
            node = self.dofs[:, ::DOFS] // DOFS             # [ne^3, 8]
            free = (node < nodes).to(self.Ke.dtype)
            corners = _corner_offsets()
            Ke = self.Ke.view(CORNERS, DOFS, CORNERS, DOFS)
            blocks = torch.zeros((nodes + 1) * 27, DOFS * DOFS,
                                 dtype=self.Ke.dtype)
            for a in range(CORNERS):
                for b in range(CORNERS):
                    dx, dy, dz = corners[b] - corners[a] + 1
                    o = int(dx * 9 + dy * 3 + dz)
                    blocks.index_add_(0, node[:, a] * 27 + o,
                                      free[:, b, None]
                                      * Ke[a, :, b, :].reshape(1, -1))
            blocks = blocks.view(nodes + 1, 27, DOFS, DOFS)[:nodes]
            diag = torch.diagonal(blocks[:, 13], dim1=1, dim2=2)
            off = blocks.abs().sum(dim=(1, 3)) - diag.abs()
            self._rows = (diag.reshape(-1).numpy(), off.reshape(-1).numpy())
        return self._rows

    def norm_inf(self, shift):
        """||A||_inf: the largest absolute row sum."""
        diag, off = self._row_sums()
        return float(np.max(off + np.abs(diag + shift)))


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

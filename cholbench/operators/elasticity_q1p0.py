"""Nearly incompressible 3-D elasticity in hybrid u-p bricks: the symmetric
quasi-definite saddle-point system

    [ A   B^T ] [u]   [f]     A = int 2 mu eps(u) : eps(v)
    [ B   -C  ] [p] = [0]     B = -int q div v,   C = int p q / lambda

of Herrmann's mixed formulation (L. R. Herrmann, AIAA J. 3(10), 1965) on
the trilinear brick with one constant pressure a brick (Abaqus's C3D8H),
on the mesh of PETSc's `src/ksp/ksp/tutorials/ex56.c` (`elasticity_q1.py`):
the unit cube cut into ne^3 bricks of side h = 1 / ne, the face y = 0
clamped, Young's modulus E and Poisson's ratio nu.

Displacement dofs are numbered as in `elasticity_q1` (3 node + component,
the clamped nodes dropped); the ne^3 pressures follow them, brick by brick
in C order. A is the 2 mu part of `elasticity_q1.element_stiffness` (its
2 x 2 x 2 Gauss rule with lambda = 0, exact on a brick); a brick's row of B
is -h^2 / 4 times the sign of each corner's position along each axis (the
exact integral of -dN_a / dx_d over the brick); C is h^3 / lambda a brick.
A is SPD (Korn, the clamped face) and C diagonal positive, so the matrix
factors as L~ S L~^T under any symmetric ordering (Vanderbei, SIAM J.
Optim. 5(1), 1995), with the signature S of `signs`. Eliminating p gives
A + lambda / h^3 sum_e b_e b_e^T: the mean-dilatation (B-bar) brick.

  * `coo(cfg)`: the lower triangle (row >= col) in COO form;
  * `signs(cfg)`: +1 a displacement, -1 a pressure;
  * `separators(cfg)`: `elasticity_q1.node_separators` with each node's
    three displacements, and each brick's pressure in the deepest
    separator that holds one of its free nodes, after that separator's
    displacements (a brick's nodes lie on one root-to-leaf path, so every
    coupling of the pressure goes to that separator or its ancestors);
  * `Reference`: the matrix applied brick by brick in float64, worked out
    from the configuration alone, not from the COO arrays the solver was
    given;
  * `build(cfg, device)`: the solver under test on this matrix, ordering
    and signature (`SparseCholesky.from_coo(..., signs=)`); the only
    function here that imports it.

Plain NumPy and PyTorch; nothing here but `build` imports the solver.
"""

from __future__ import annotations

import numpy as np

from cholbench.operators import elasticity_q1 as q1

DOFS, CORNERS = q1.DOFS, q1.CORNERS
ELEMENT_DOFS = DOFS * CORNERS + 1      # a brick's displacements, its pressure
ELEMENT_VALUES = q1.ELEMENT_VALUES


def _params(cfg):
    """(ne, h, lambda, mu)."""
    ne, E, nu = q1._params(cfg)
    lam, mu = q1.lame(E, nu)
    return ne, 1.0 / ne, lam, mu


def counts(cfg):
    """(displacement dofs, pressure dofs)."""
    ne = _params(cfg)[0]
    return DOFS * int(np.prod(q1.node_shape(cfg))), ne ** 3


def deviatoric_stiffness(h, mu):
    """A_e [24, 24]: int 2 mu eps(u) : eps(v) over a brick of side h, the
    2 x 2 x 2 Gauss rule of `elasticity_q1.element_stiffness` at lambda =
    0 (E = 2 mu, nu = 0)."""
    return q1.element_stiffness(h, 2.0 * mu, 0.0)


def divergence_row(h):
    """b_e [24]: -int div N_(a, d) over a brick of side h, that is
    -(+-1) h^2 / 4 by the sign of corner a's position along axis d."""
    s = np.where(q1._corner_offsets() == 1, 1.0, -1.0)     # [8, 3]
    return (-s * h * h / 4.0).reshape(-1)


def element_matrix(h, lam, mu):
    """M_e [25, 25] of a brick: [[A_e, b_e], [b_e^T, -h^3 / lambda]]."""
    M = np.zeros((ELEMENT_DOFS, ELEMENT_DOFS))
    M[:-1, :-1] = deviatoric_stiffness(h, mu)
    b = divergence_row(h)
    M[:-1, -1] = M[-1, :-1] = b
    M[-1, -1] = -h ** 3 / lam
    return M


def _bricks(ne):
    """[ne^3, 8] the free node of each brick's corners (-1 where clamped),
    bricks in C order, corners as `elasticity_q1._corner_offsets`."""
    e = np.arange(ne)
    ex, ey, ez = np.meshgrid(e, e, e, indexing="ij")
    corners = q1._corner_offsets()
    x = ex.reshape(-1, 1) + corners[:, 0]
    y = ey.reshape(-1, 1) + corners[:, 1]
    z = ez.reshape(-1, 1) + corners[:, 2]
    node = (x * ne + (y - 1)) * (ne + 1) + z
    return np.where(y == 0, -1, node)


def coo(cfg):
    """(n, rows, cols, vals): the lower triangle of the mixed matrix: A's
    (`elasticity_q1.coo` of the 2 mu part), then each brick's row of B on
    its free displacements, then -h^3 / lambda on each pressure's
    diagonal."""
    ne, h, lam, mu = _params(cfg)
    n_u, n_p = counts(cfg)
    dev = dict(cfg, operator=dict(cfg["operator"], E=2.0 * mu, nu=0.0))
    _, ra, ca, va = q1.coo(dev)
    node = _bricks(ne)                                       # [ne^3, 8]
    b = divergence_row(h).reshape(CORNERS, DOFS)
    dof = DOFS * node[:, :, None] + np.arange(DOFS)          # [ne^3, 8, 3]
    free = np.broadcast_to((node >= 0)[:, :, None], dof.shape)
    prow = np.broadcast_to(n_u + np.arange(n_p)[:, None, None], dof.shape)
    vb = np.broadcast_to(b, dof.shape)
    p = n_u + np.arange(n_p)
    rows = np.concatenate([ra, prow[free], p])
    cols = np.concatenate([ca, dof[free], p])
    vals = np.concatenate([va, vb[free], np.full(n_p, -h ** 3 / lam)])
    return n_u + n_p, rows, cols, vals


def signs(cfg):
    """The signature [n]: +1 a displacement, -1 a pressure."""
    n_u, n_p = counts(cfg)
    return np.concatenate([np.ones(n_u), -np.ones(n_p)])


def pressure_separators(cfg):
    """[ne^3] the separator of each brick's pressure: the deepest (the
    lowest-numbered, leaves first) separator of its free nodes."""
    ne = _params(cfg)[0]
    nodes = q1.node_separators(cfg)
    sep_of = np.empty(int(np.prod(q1.node_shape(cfg))), dtype=np.int64)
    for s, v in nodes.items():
        sep_of[v] = s
    node = _bricks(ne)
    big = np.iinfo(np.int64).max
    return np.where(node >= 0, sep_of[np.maximum(node, 0)], big).min(axis=1)


def separators(cfg):
    """{separator: its dofs}: each node of `elasticity_q1.node_separators`
    with its three displacements, in node order, then the pressures of the
    bricks `pressure_separators` places there, in brick order."""
    n_u, n_p = counts(cfg)
    where = pressure_separators(cfg)
    order = np.argsort(where, kind="stable")
    bounds = np.searchsorted(where[order], np.arange(1, len(where) + 2))
    out = {}
    for s, v in q1.separators(cfg).items():
        p = n_u + order[bounds[s - 1]:bounds[s]]
        out[s] = np.concatenate([v, p])
    return out


# ------------------------------------------------------------ the reference

class Reference:
    """The mixed matrix (+ shift I) applied brick by brick in float64 on
    the CPU, in plain PyTorch: each brick's 24 displacements (a clamped
    node's read as zero) and its pressure gathered, multiplied by M_e
    (`element_matrix`), scattered back with `index_add_`. Its own brick
    loop, independent of `coo`; it never sees the solver's arrays."""

    def __init__(self, cfg):
        import torch

        # f64 products on the CPU never take TF32; the flags are cleared all
        # the same, so that the reference stays exact if it is ever run on
        # a card, or on f32 data
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ne, h, lam, mu = _params(cfg)
        n_u, n_p = counts(cfg)
        self.n = n_u + n_p
        self.Me = torch.from_numpy(element_matrix(h, lam, mu))
        node = _bricks(ne)
        dof = DOFS * node[:, :, None] + np.arange(DOFS)
        dof[node < 0] = self.n                               # zero sentinel
        self.dofs = torch.from_numpy(np.concatenate(
            [dof.reshape(-1, DOFS * CORNERS),
             (n_u + np.arange(n_p))[:, None]], axis=1))      # [ne^3, 25]
        # each brick's nodes, a clamped one numbered past the free ones
        self.nodes = n_u // DOFS
        self.node = torch.from_numpy(np.where(node < 0, self.nodes, node))
        self._rows = None

    def matvec(self, x, shift):
        """(M + shift I) x for x of [n] or [n, k] (NumPy or torch); a NumPy
        array."""
        import torch

        xt = torch.as_tensor(np.asarray(x, dtype=np.float64))
        vec = xt.dim() == 1
        xt = xt.reshape(self.n, -1)
        k = xt.shape[1]
        xz = torch.cat([xt, xt.new_zeros((1, k))])
        y = torch.zeros_like(xz)
        step = max(1, ELEMENT_VALUES // k)
        for e0 in range(0, self.dofs.shape[0], step):
            idx = self.dofs[e0:e0 + step]                    # [e, 25]
            ue = xz[idx].transpose(1, 2)                     # [e, k, 25]
            fe = ue.reshape(-1, ELEMENT_DOFS) @ self.Me      # M_e symmetric
            y.index_add_(0, idx.reshape(-1), fe.view(
                -1, k, ELEMENT_DOFS).transpose(1, 2).reshape(-1, k))
        out = y[:self.n] + shift * xt
        return (out[:, 0] if vec else out).numpy()

    def _row_sums(self):
        """(diagonal, sum of |M_ij| over j != i): A's 3 x 3 node blocks
        assembled brick by brick, per node and neighbour offset (27 a
        node), summed along each row; B's entries added one by one (each
        brick's pressure is its own column); a pressure row's entries are
        its brick's alone."""
        if self._rows is None:
            import torch

            nodes, node = self.nodes, self.node
            disp = self.dofs[:, :-1]
            free = (node < nodes).to(self.Me.dtype)
            corners = q1._corner_offsets()
            Ae = self.Me[:-1, :-1].reshape(CORNERS, DOFS, CORNERS, DOFS)
            blocks = torch.zeros((nodes + 1) * 27, DOFS * DOFS,
                                 dtype=self.Me.dtype)
            for a in range(CORNERS):
                for b in range(CORNERS):
                    dx, dy, dz = corners[b] - corners[a] + 1
                    o = int(dx * 9 + dy * 3 + dz)
                    blocks.index_add_(0, node[:, a] * 27 + o,
                                      free[:, b, None]
                                      * Ae[a, :, b, :].reshape(1, -1))
            blocks = blocks.view(nodes + 1, 27, DOFS, DOFS)[:nodes]
            diag_u = torch.diagonal(blocks[:, 13], dim1=1, dim2=2)
            off_u = blocks.abs().sum(dim=(1, 3)) - diag_u.abs()
            off = torch.zeros(self.n + 1, dtype=self.Me.dtype)
            off[:DOFS * nodes] = off_u.reshape(-1)
            bfree = self.Me[:-1, -1].abs() * free.repeat_interleave(DOFS,
                                                                   dim=1)
            off.index_add_(0, disp.reshape(-1), bfree.reshape(-1))
            off[self.dofs[:, -1]] += bfree.sum(dim=1)
            diag = torch.cat([diag_u.reshape(-1), self.Me[-1, -1].expand(
                self.dofs.shape[0])])
            self._rows = (diag.numpy(), off[:self.n].numpy())
        return self._rows

    def norm_inf(self, shift):
        """||M + shift I||_inf: the largest absolute row sum."""
        diag, off = self._row_sums()
        return float(np.max(off + np.abs(diag + shift)))


def build(cfg, device):
    """(solver, vals): the signed solver planned on `coo(cfg)` under
    `separators(cfg)` with the signature `signs(cfg)`, the configuration's
    dtype and matmul rung, and the values `vals` aligned with its stored
    pattern."""
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.io.ordering import Ordering

    n, rows, cols, vals = coo(cfg)
    seps = separators(cfg)
    solver = SparseCholesky.from_coo(
        n, rows, cols, vals, Ordering(int(cfg["levels"]), len(seps), seps),
        dtype=np.dtype(cfg["dtype"]), device=device,
        precision=cfg["precision"], signs=signs(cfg))
    if not (np.array_equal(solver.rows, rows)
            and np.array_equal(solver.cols, cols)):
        raise RuntimeError("the solver reordered the COO entries; the "
                           "generator's values would not align")
    return solver, vals

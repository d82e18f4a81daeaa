"""Symmetric quasi-definite LDL^T — the port of
`cholesky_tpu/numeric/ldlt.py`: the signed-Cholesky factorization

    A = L~ S L~^T,   S = diag(s),  s in {+1, -1}^n,  L~ lower triangular

for saddle-point / KKT systems [[H, B^T], [B, -C]] (H, C SPD). A
quasi-definite matrix factors stably without pivoting under any symmetric
permutation (Vanderbei, SIAM J. Optim. 5(1), 1995), so the frontal plan,
the assembly and the extend-add of the SPD path apply unchanged; the
factorization differs from `frontal.py` only in three places:

  factor:  L~d = signed Cholesky of the pivot block;
           X~ = A21 L~d^-T S, the stored off-diagonal block;
           Schur update U = X S X^T = X~ X^T (X = A21 L~d^-T)
  solve:   z = L~^-1 b;  w = S z;  x = L~^-T w
  logdet:  log|det A| = 2 sum log diag(L~d),  sign = (-1)^#negative

The signed pivot factorization is dense algebra that the JAX package runs
through XLA (a `lax.scan` over columns), not a Pallas kernel; here it is
PyTorch: a column loop over the batch inside each panel, cuBLAS for the
panel solves and the trailing updates. It never takes the SPD kernel route
(`hopper_kernels.factor_slab` is Cholesky only).

In core and square: the level loop runs every level on the square front,
with updates and the stored factor in the compute dtype on the device; the
regime plan of the budget is `regimes.plan_qd`, which raises `BudgetError`
before anything is allocated when that does not fit.

Under a mesh (`parallel/mesh.py`) the slot-sharded levels factor per slot
on the slot's device and the others on the mesh's first device, as GSPMD
distributes the JAX package's pure-jit qd programs (`ldlt.py:26-29` there);
the solve's sweeps run per slot through `frontal._sweeps`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from cholesky_tpu_torch.numeric import frontal
from cholesky_tpu_torch.numeric.frontal_plan import FrontalPlan, _banded_maps

# Columns per panel of the signed Cholesky. Each column of a panel costs
# five launches on the [B, w, w] diagonal block whatever w is, so the
# factorization is launch-bound on the column count; w sets the share of
# the O(W^3) work left to those elementwise rank-1 updates (w / W of it)
# against the cuBLAS panel solve and trailing GEMM of each panel. 32 keeps
# the elementwise share small on the wide root fronts (W = 2504 at 50^3)
# for one more solve + GEMM pair per 32 columns than 64 would take.
PANEL = 32


def _panel_factor_(D: torch.Tensor, s: torch.Tensor) -> None:
    """Unblocked signed Cholesky of the diagonal blocks D [B, w, w], in
    place on their lower triangle (the strict upper triangle is left with
    the rank-1 updates' values). Per column j: ljj = sqrt(s_j d_j); the
    column below becomes l = col / (s_j ljj); the block below and right of
    it loses s_j l l^T = (col / ljj) l^T. A signature violation (s_j d_j
    < 0) gives NaN, which the later columns and levels carry on."""
    w = D.shape[1]
    for j in range(w):
        sj = s[:, j]
        ljj = D[:, j, j].mul_(sj).sqrt_()               # in place: L~[j, j]
        if j + 1 == w:
            break
        col = D[:, j + 1:, j]
        u = col / ljj[:, None]                          # s_j l
        torch.mul(u, sj[:, None], out=col)              # l
        D[:, j + 1:, j + 1:].addcmul_(u[:, :, None], col[:, None, :],
                                      value=-1)


def blocked_signed_cholesky(a: torch.Tensor, s: torch.Tensor,
                            panel: int = PANEL) -> torch.Tensor:
    """Batched blocked right-looking signed Cholesky of a [B, W, W] (lower
    triangle read) with signature s [B, W]: returns lower-triangular L~
    (zeros above the diagonal) with a = L~ diag(s) L~^T (`ldlt.py:52-104`
    of the JAX package). Per panel of `panel` columns: the column loop on
    its diagonal block, then X = A21 L~11^-T, the stored block X S, and one
    GEMM trailing update A22 -= X S X^T. The input is not modified."""
    work = a.clone()
    s = s.to(a.dtype)
    W = a.shape[1]
    for c0 in range(0, W, panel):
        c1 = min(c0 + panel, W)
        _panel_factor_(work[:, c0:c1, c0:c1], s[:, c0:c1])
        if c1 == W:
            break
        x = frontal._solve_lower_t(work[:, c0:c1, c0:c1],
                                   work[:, c1:, c0:c1])      # A21 L~11^-T
        xs = x * s[:, None, c0:c1]                           # the true L~21
        work[:, c1:, c0:c1] = xs
        work[:, c1:, c1:].baddbmm_(x, xs.transpose(1, 2), alpha=-1)
        del x, xs
    return work.tril_()


# ---------------------------------------------------------------------------
# The signature


def sign_slabs(fp: FrontalPlan, signs: np.ndarray) -> List[np.ndarray]:
    """Per-level pivot signatures [B, W] (f32) from the ORIGINAL-order sign
    vector [n]: permuted, grouped by separator slot; padding and the
    sentinel get +1 (the padded unit diagonal factors as +1 1 1)."""
    sp = np.concatenate([np.asarray(signs, dtype=np.float64)[fp.plan.perm],
                         [1.0]])
    return [sp[fp.front_rows[lvl][:, :fp.W[lvl]]].astype(np.float32)
            for lvl in range(fp.levels)]


class DeviceSigns:
    """A signature on the device, in the compute dtype, in the three bases
    the factor and the solves read: `slabs` the per-level [B, W] pivot
    signatures, `perm` [n + 1] in the permuted basis (sentinel +1), `padded`
    [n_pad + 1] in the banded solve's padded basis. Built once per plan and
    signature (the solver keeps it across refactorizations)."""

    def __init__(self, fp: FrontalPlan, signs: np.ndarray, device, dtype):
        host = np.concatenate([np.asarray(signs, dtype=np.float64)[
            fp.plan.perm], [1.0]])
        _, _, inv_map, _, _ = _banded_maps(fp)

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

        self.slabs = [dev(x) for x in sign_slabs(fp, signs)]
        self.perm = dev(host)
        self.padded = dev(np.concatenate([host[inv_map], [1.0]]))


# ---------------------------------------------------------------------------
# Factorization


def _factor_level_qd(fp: FrontalPlan, lvl: int, piv: torch.Tensor, U,
                     s: torch.Tensor):
    """One level (`_factor_level_qd`, `ldlt.py:125-151`): the square front
    of `frontal._factor_level` with the three sign touch-points. Consumes
    the pivot slabs `piv` [B, F, W] and the children's update U [2B, K, K]
    (None at the leaves). Returns (factor
    [B, F, W], U_next); a leaf level forms its update X~ X^T itself (the
    SPD path's deferred X X^T would give X~ X~^T)."""
    Wl, Fl = fp.W[lvl], fp.F[lvl]
    B = piv.shape[0]
    full = None
    if U is None:
        blk = piv
    else:
        full = piv.new_zeros((B, Fl + 1, Fl))         # row Fl: sentinel
        full[:, :Fl, :Wl] = piv
        del piv
        if U.shape[1] > 0:
            frontal._extend_add_fused_(fp, full, U, lvl + 1)
        del U
        blk = full[:, :Fl, :Wl]
    ld = blocked_signed_cholesky(blk[:, :Wl, :], s)
    fac = blk.new_empty((B, Fl, Wl))
    fac[:, :Wl] = ld
    del ld
    if Fl == Wl:
        return fac, (None if lvl == 0 else fac.new_zeros((B, 0, 0)))
    x = frontal._solve_lower_t(fac[:, :Wl], blk[:, Wl:, :])   # A21 L~d^-T
    xs = fac[:, Wl:]
    torch.mul(x, s.to(x.dtype)[:, None, :], out=xs)           # X~ = X S
    if lvl == 0:
        return fac, None
    xt = xs.transpose(1, 2)
    if full is None:
        return fac, x @ xt                                    # X S X^T
    return fac, torch.baddbmm(full[:, Wl:Fl, Wl:], x, xt, beta=-1)


def factor_qd(fp: FrontalPlan, fronts: List[torch.Tensor], sig: DeviceSigns,
              level_hook=None, mesh=None) -> Tuple[torch.Tensor, ...]:
    """The level loop of the quasi-definite factorization, leaves to root,
    in core (`factor_qd`, `ldlt.py:154-176`). `fronts` is the list of
    assembled [B, F, W] slabs and is CONSUMED (each entry dropped once its
    level ran). Returns per-level [B, F, W] factors: rows :W the signed
    Cholesky L~d, rows W: the off-diagonal block X~. `level_hook(lvl,
    "start" | "end")` as in `frontal.frontal_factor_streamed`. With `mesh`,
    `fronts` as `assemble.MeshAssembler` placed them: a slot-sharded level
    runs per slot over its blocks (a `Sharded` factor), any other on the
    mesh's first device."""
    out: List = [None] * fp.levels
    devices = mesh.flat if mesh is not None else [None]
    pieces, counts = None, None
    for lvl in range(fp.levels - 1, -1, -1):
        if level_hook is not None:
            level_hook(lvl, "start")
        B = 1 << lvl
        place = frontal.level_placement(fp, lvl, mesh)
        spans = frontal._spans(place, devices, B)
        parts, new_pieces = [], []
        for s, dev, b0, b1 in spans:
            dev = dev or fronts[lvl].device
            view = fp if (b0, b1) == (0, B) else frontal._BatchView(
                fp, lvl, b0, b1)
            # the update is passed as a call expression, so that the level
            # frees it once it is extend-added
            fac, nxt = _factor_level_qd(
                view, lvl, frontal._slab_of(fronts[lvl], s, b0, b0, b1, dev),
                None if pieces is None else frontal._take_child_rows(
                    pieces, counts, 2 * b0, 2 * b1, dev),
                sig.slabs[lvl][b0:b1].to(dev))
            parts.append(fac)
            new_pieces.append(nxt)
        fronts[lvl] = None
        out[lvl] = (parts[0] if place is None or place.kind != "slot" else
                    frontal.Sharded(parts, place, (B,) + parts[0].shape[1:],
                                    devices))
        pieces, counts = new_pieces, [b1 - b0 for _, _, b0, b1 in spans]
        if level_hook is not None:
            level_hook(lvl, "end")
    return tuple(out)


# ---------------------------------------------------------------------------
# Solve, logdet, inertia


def solve_qd(fp: FrontalPlan, factors: Sequence[torch.Tensor],
             sig: DeviceSigns, b_perm: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b through the signed factor, without pivot inverses
    (`ldlt.py:179-220`): the forward sweep of `frontal._sweeps`, w = S z on
    the permuted work array, the backward sweep. `b_perm` [n] or [n, k]
    (PERMUTED order, the factor's dtype, on its device) -> x of the same
    shape."""
    bg, vec = frontal._with_sentinel(b_perm)
    frontal._sweeps(fp, factors, bg, backward=False)
    bg.mul_(sig.perm.to(bg.dtype)[:, None])
    frontal._sweeps(fp, factors, bg, forward=False)
    n = fp.plan.n
    return bg[:n, 0] if vec else bg[:n]


def logdet_qd(fp: FrontalPlan, factors: Sequence[torch.Tensor],
              signs: np.ndarray) -> Tuple[int, float]:
    """(sign, log|det A|) from the signed factor: |det A| = prod
    diag(L~d)^2 (padded diagonal 1s contribute 0), sign = (-1)^#negative.
    Summed in f64 on the host."""
    total = 0.0
    for lvl in range(fp.levels):
        Wl = fp.W[lvl]
        d = torch.diagonal(frontal.mesh_mod.local(factors[lvl])[:, :Wl, :Wl],
                           dim1=1, dim2=2)
        total += 2.0 * float(np.log(d.cpu().numpy().astype(np.float64)).sum())
    neg = int(np.sum(np.asarray(signs) < 0))
    return (-1) ** neg, total


def inertia(signs: np.ndarray) -> Tuple[int, int, int]:
    """(n+, n-, n0) of a factored quasi-definite matrix: the signature IS
    the inertia (Sylvester's law through L~ S L~^T)."""
    s = np.asarray(signs)
    return int(np.sum(s > 0)), int(np.sum(s < 0)), 0

"""Selected inversion: diag(A^-1), and the entries of A^-1 on the pattern of
L + L^T, from the frontal Cholesky factor by a top-down batched recursion
over the separator tree — the port of `cholesky_tpu/numeric/selinv.py`.

Math. Let s be a separator with pivot factor L_ss and off-diagonal strip
L_Ss (rows S = s's front boundary, all in ancestor separators). With
X = L_Ss L_ss^-1 and Phi = A^-1:

    Phi_Ss = -Phi_SS X
    Phi_ss =  L_ss^-T L_ss^-1 + X^T Phi_SS X

(the Takahashi recurrences). Phi_SS is the true inverse on s's boundary
rows, and a child's boundary lies inside its parent's front, so Phi_SS is a
gather from the parent's front-inverse block P_parent = Phi over (parent
pivot, parent boundary). The recursion runs root to leaves, one batched
step per tree level: per level [B, ., .] batched products and triangular
solves (cuBLAS / cuSOLVER on the card; the JAX package runs them as XLA
einsums, outside any Pallas kernel).

The parent restriction Pp = P_parent[idx, idx] is a masked gather
(`hopper_kernels.rows_gather` / `cols_gather`; sentinel positions read
zero), where the JAX package contracts two one-hot matrices on the MXU
because XLA lowers a 2-D gather element by element on the TPU. Padded boundary rows of
Pp and PX come out exactly zero, and padded pivot diagonals drop out
through the sentinel row n, as in the JAX package.

Compute dtype: f64 for an f64 factor, f32 otherwise (a bf16-stored factor
is promoted). A level stored bf16 or held in host memory is promoted or
moved to the device one level at a time. Memory: the step at level l holds
P_{l-1} [B/2, F_{l-1}, F_{l-1}], the new P_l [B, F, F] and the gathered
transients; `regimes.selinv_bytes` estimates the peak from the same
allocations, and `SparseCholesky` refuses to start a selected inversion
that does not fit its budget. There is no streamed selected inversion.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from cholesky_tpu_torch.numeric import frontal
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.numeric.frontal_plan import FrontalPlan


def compute_dtype(factors) -> torch.dtype:
    """f64 for an f64 factor, f32 otherwise (`selinv.py:129`)."""
    return (torch.float64 if factors[0].dtype == torch.float64
            else torch.float32)


def _inv_L(fac: torch.Tensor, W: int) -> torch.Tensor:
    """Explicit inverse of the batched pivot Cholesky factors [B, W, W]
    (the lower triangle of fac[:, :W, :] read)."""
    Ld = fac[:, :W, :]
    eye = torch.eye(W, dtype=fac.dtype, device=fac.device)
    return torch.linalg.solve_triangular(Ld, eye.expand_as(Ld), upper=False)


def _selinv_root(stored: torch.Tensor, W: int, dtype, device) -> torch.Tensor:
    """Root separator: no ancestors, P = (L L^T)^-1 over the pivot."""
    invL = _inv_L(stored.to(device, dtype), W)
    return invL.transpose(1, 2) @ invL


def _parent_restriction(P_prev: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """Pp[b] = P_prev[b >> 1][idx[b], idx[b]] for idx = fwd_child [B, bnd]
    (child boundary position -> parent front position, sentinel F_prev):
    the two children of one parent gather their rows in one pass, then
    each its columns; sentinel rows and columns read zero."""
    B, bnd = idx.shape
    Fp = P_prev.shape[1]
    rows = hk.rows_gather(P_prev, idx.reshape(B // 2, 2 * bnd))
    return hk.cols_gather(rows.view(B, bnd, Fp), idx, Fp)


def _selinv_core(stored: torch.Tensor, W: int, dtype, device,
                 idx: torch.Tensor, held: List[torch.Tensor]):
    """The per-level math (`selinv.py:59`): (Phi_ss [B, W, W],
    PX [B, bnd, W], Pp [B, bnd, bnd]). `stored` is the level's stored
    factor [B, F, W], promoted to `dtype` on `device` here and dropped
    after its last use; `held` holds the parent level's P, which is taken
    out and dropped as soon as Pp is gathered from it."""
    fac = stored.to(device, dtype)
    invL = _inv_L(fac, W)
    S = invL.transpose(1, 2) @ invL
    Xs = fac[:, W:, :] @ invL                               # [B, bnd, W]
    del invL, fac
    Pp = _parent_restriction(held.pop(), idx)
    PX = Pp @ Xs                                            # [B, bnd, W]
    Phi_ss = S.baddbmm_(Xs.transpose(1, 2), PX)
    return Phi_ss, PX, Pp


def _assemble_P(Phi_ss, PX, Pp) -> torch.Tensor:
    """P = [[Phi_ss, -PX^T], [-PX, Pp]], [B, F, F]."""
    B, W, _ = Phi_ss.shape
    F = W + Pp.shape[1]
    P = Phi_ss.new_empty((B, F, F))
    P[:, :W, :W] = Phi_ss
    low = P[:, W:, :W]
    low.copy_(PX).neg_()
    P[:, :W, W:] = low.transpose(1, 2)
    P[:, W:, W:] = Pp
    return P


def selinv_diag(fp: FrontalPlan, factors: Sequence[torch.Tensor],
                device=None, dtype: Optional[torch.dtype] = None
                ) -> np.ndarray:
    """diag(A^-1) in PERMUTED coordinates, [n] float64, computed on
    `device` (default: the root level's).

    Accuracy follows the factor precision: ~1e-13 relative from an f64
    factor, ~kappa(A) 1e-7 from f32 / bf16 (selected inversion has no
    refinement loop; factor in f64 when the diagonal must be tight)."""
    dt = dtype or compute_dtype(factors)
    device = torch.device(device) if device is not None \
        else factors[0].device
    n = fp.plan.n
    diag = torch.zeros(n + 1, dtype=dt, device=device)     # slot n: padding
    held: List[torch.Tensor] = []
    for lvl in range(fp.levels):
        W = fp.W[lvl]
        if lvl == 0:
            P = _selinv_root(factors[0], W, dt, device)
            d = torch.diagonal(P, dim1=1, dim2=2)
            held.append(P)
            del P
        else:
            idx = frontal._device_index(fp, "fwd_child", lvl, device)
            Phi_ss, PX, Pp = _selinv_core(factors[lvl], W, dt, device, idx,
                                          held)
            d = torch.diagonal(Phi_ss, dim1=1, dim2=2)
            if lvl < fp.levels - 1:
                held.append(_assemble_P(Phi_ss, PX, Pp))
            del Phi_ss, PX, Pp
        diag[frontal._device_index(fp, "piv_rows", lvl, device)] = d
        del d
    held.clear()
    return diag[:n].cpu().numpy().astype(np.float64)


def _levels_and_slots(tree, seps: np.ndarray):
    """Vectorized `SeparatorTree.level_of` / `slot_of`: the heap index's
    bit length less one, and the position within the level."""
    heap = tree.num_separators - seps + 1
    lvl = np.frexp(heap.astype(np.float64))[1].astype(np.int64) - 1
    return lvl, heap - (np.int64(1) << lvl)


def _locate_entries(fp: FrontalPlan, pr: np.ndarray, pc: np.ndarray):
    """Map permuted entry coordinates (i, j) to (level, slot, row_pos,
    col_pos) in that level's front blocks, as `selinv.py:162` does entry
    by entry: each entry is normalized so the COLUMN belongs to the deeper
    separator; the row must then appear in that separator's front (pivot
    or boundary), i.e. the entry lies in the pattern of L + L^T + I.
    Vectorized: per level, one `searchsorted` of the rows against every
    front's sorted boundary at once (keys slot (n + 1) + row). Returns four
    int64 arrays in entry order; raises ValueError, naming the first
    offending entry, for entries outside the pattern."""
    plan = fp.plan
    n = plan.n
    pr = np.asarray(pr, dtype=np.int64)
    pc = np.asarray(pc, dtype=np.int64)
    sep_of = plan.sep_of_dof[plan.perm]           # separator of each permuted
    si, sj = sep_of[pr], sep_of[pc]
    li = _levels_and_slots(plan.tree, si)[0]
    lj = _levels_and_slots(plan.tree, sj)[0]
    swap = li > lj                                 # deeper separator = column
    i, j = np.where(swap, pc, pr), np.where(swap, pr, pc)
    si, sj = np.where(swap, sj, si), np.where(swap, si, sj)
    lvl, slot = _levels_and_slots(plan.tree, sj)
    col = j - plan.sep_offset[sj]
    row = i - plan.sep_offset[sj]
    bad = np.zeros(len(pr), dtype=bool)
    off = np.nonzero(si != sj)[0]
    for l in np.unique(lvl[off]):
        sel = off[lvl[off] == l]
        Wl = fp.W[l]
        bnd = fp.front_rows[l][:, Wl:]           # sorted per front, sentinel n
        K = bnd.shape[1]
        keys = (np.arange(bnd.shape[0], dtype=np.int64)[:, None] * (n + 1)
                + bnd).ravel()
        q = slot[sel] * (n + 1) + i[sel]
        p = np.searchsorted(keys, q)
        hit = p < keys.size
        hit[hit] = keys[p[hit]] == q[hit]
        row[sel] = Wl + p - slot[sel] * K
        bad[sel[~hit]] = True
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        raise ValueError(
            f"entry ({pr[k]}, {pc[k]}) (permuted) is outside the factor "
            f"pattern — selected inversion only computes Phi on pattern(L + "
            f"L^T); solve unit vectors for arbitrary entries")
    return lvl, slot, row, col


def selinv_entries(fp: FrontalPlan, factors: Sequence[torch.Tensor],
                   pr: np.ndarray, pc: np.ndarray, device=None,
                   dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """Selected entries Phi[pr[k], pc[k]] of A^-1 (PERMUTED coordinates),
    for entries within the factor pattern: the recursion of selinv_diag,
    stopped at the deepest requested level, reading the requested values
    out of each level's front-inverse blocks (non-terminal levels from
    P = [[Phi_ss, -PX^T], [-PX, Pp]]; the terminal level from
    (Phi_ss, PX) without assembling P). [m] float64."""
    dt = dtype or compute_dtype(factors)
    device = torch.device(device) if device is not None \
        else factors[0].device
    lvl_of, slot, rp, cp = _locate_entries(
        fp, np.atleast_1d(np.asarray(pr)), np.atleast_1d(np.asarray(pc)))
    vals = np.empty(len(lvl_of), dtype=np.float64)
    if not len(lvl_of):
        return vals
    max_lvl = int(lvl_of.max())
    held: List[torch.Tensor] = []

    def at(x):
        return torch.from_numpy(x).to(device)

    for lvl in range(max_lvl + 1):
        W = fp.W[lvl]
        want = np.nonzero(lvl_of == lvl)[0]
        s, r, c = at(slot[want]), at(rp[want]), at(cp[want])
        if lvl == 0:
            held.append(_selinv_root(factors[0], W, dt, device))
            got = held[0][s, r, c]
        else:
            idx = frontal._device_index(fp, "fwd_child", lvl, device)
            Phi_ss, PX, Pp = _selinv_core(factors[lvl], W, dt, device, idx,
                                          held)
            if lvl < max_lvl:
                held.append(_assemble_P(Phi_ss, PX, Pp))
                got = held[0][s, r, c]
            else:
                got = Phi_ss[s, r.clamp(max=W - 1), c]
                if PX.shape[1]:                 # boundary rows: -PX
                    b = (r - W).clamp(0, PX.shape[1] - 1)
                    got = torch.where(r < W, got, -PX[s, b, c])
            del Phi_ss, PX, Pp
        vals[want] = got.cpu().numpy()
    held.clear()
    return vals

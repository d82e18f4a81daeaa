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
through XLA (a `lax.scan` over columns), not a Pallas kernel; here each
panel of it (the diagonal block's signed factor and the solve of the
panel below) is one launch of the hand-written `hopper_kernels.
signed_panel` on the card (`kernels/csrc/signed_panel.cu`; on the CPU its
plain version, the column loop), and cuBLAS runs the trailing updates. It
never takes the SPD kernel route (`hopper_kernels.factor_slab` is Cholesky
only).

Spans (`trace.py`): inside each level, `frontal.PIVOT` around the signed
pivot factorization, the boundary solve and X~ = X S; `frontal.SCHUR`
around the update product; `frontal.EXTEND_ADD` in `frontal._form_front`;
and SIGNED_DIAG around each panel's `signed_panel`, inside PIVOT.
Counters: `factor_qd(stats=)` adds the panels and columns of the blocked
factorization and the `signed_panel` launches.

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

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cholesky_tpu_torch import trace
from cholesky_tpu_torch.numeric import frontal
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.numeric.frontal_plan import FrontalPlan, _banded_maps

# Columns per panel of the signed Cholesky, at most `hk.SIGNED_PANEL`, the
# widest the kernel factors (one lane a row of the diagonal block). Each
# panel is one `signed_panel` launch for the level's B fronts plus one
# cuBLAS trailing update, so the factorization takes about two launches per
# PANEL columns; the share of the O(W^3) work done inside the kernel, the
# diagonal blocks and the solves against them, is PANEL / W of it.
PANEL = hk.SIGNED_PANEL

# the span of one panel's `signed_panel`
SIGNED_DIAG = "chol.step.signed_diag"


def blocked_signed_cholesky(a: torch.Tensor, s: torch.Tensor,
                            panel: int = PANEL) -> torch.Tensor:
    """Batched blocked right-looking signed Cholesky of a [B, W, W] (lower
    triangle read) with signature s [B, W]: returns lower-triangular L~
    (zeros above the diagonal) with a = L~ diag(s) L~^T (`ldlt.py:52-104`
    of the JAX package). Per panel of `panel` columns: `hk.signed_panel`
    (the diagonal block's signed factor, X = A21 L~11^-T into a scratch
    and the stored block L~21 = X S), then one GEMM trailing update A22 -=
    X (X S)^T. The input is not modified. On the card a panel is at most
    `hk.SIGNED_PANEL` columns; on the CPU any width (panel=W is the
    unblocked column loop)."""
    work = a.clone()
    s = s.to(a.dtype).contiguous()
    B, W = a.shape[0], a.shape[1]
    w0 = min(panel, W)
    xbuf = work.new_empty(B * (W - w0) * w0)        # X of the widest panel
    tickets = torch.zeros(B, dtype=torch.int32, device=a.device)
    for c0 in range(0, W, panel):
        c1 = min(c0 + panel, W)
        x = xbuf[:B * (W - c1) * (c1 - c0)].view(B, W - c1, c1 - c0)
        with trace.span(SIGNED_DIAG, a.device):
            hk.signed_panel(work, s, c0, c1, x, tickets)
        if c1 == W:
            break
        work[:, c1:, c1:].baddbmm_(x, work[:, c1:, c0:c1].transpose(1, 2),
                                   alpha=-1)
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
    (None: the leaf level, or children with no boundary). Returns (factor
    [B, F, W], U_next), U_next None at the root or without a boundary; a
    leaf level forms its update X~ X^T itself (the SPD path's deferred
    X X^T would give X~ X~^T). Its steps open the spans `frontal.PIVOT`
    and `frontal.SCHUR` (`_form_front` its own `frontal.EXTEND_ADD`)."""
    Wl, Fl = fp.W[lvl], fp.F[lvl]
    B = piv.shape[0]
    dev = piv.device
    full = None
    if lvl == fp.levels - 1:
        blk = piv
    else:
        full = frontal._form_front(fp, piv, U, lvl + 1)   # row Fl: sentinel
        del piv, U
        blk = full[:, :Fl, :Wl]
    with trace.span(frontal.PIVOT, dev):
        ld = blocked_signed_cholesky(blk[:, :Wl, :], s)
        fac = blk.new_empty((B, Fl, Wl))
        fac[:, :Wl] = ld
        del ld
        if Fl == Wl:
            return fac, None
        x = frontal._solve_lower_t(fac[:, :Wl], blk[:, Wl:, :])  # A21 L~d^-T
        xs = fac[:, Wl:]
        torch.mul(x, s.to(x.dtype)[:, None, :], out=xs)          # X~ = X S
    if lvl == 0:
        return fac, None
    with trace.span(frontal.SCHUR, dev):
        xt = xs.transpose(1, 2)
        if full is None:
            return fac, x @ xt                                   # X S X^T
        return fac, torch.baddbmm(full[:, Wl:Fl, Wl:], x, xt, beta=-1)


def factor_qd(fp: FrontalPlan, fronts: List[torch.Tensor], sig: DeviceSigns,
              level_hook=None, mesh=None,
              stats: Optional[dict] = None) -> Tuple[torch.Tensor, ...]:
    """The level loop of the quasi-definite factorization, leaves to root,
    in core (`factor_qd`, `ldlt.py:154-176`). `fronts` is the list of
    assembled [B, F, W] slabs and is CONSUMED (each entry dropped once its
    level ran). Returns per-level [B, F, W] factors: rows :W the signed
    Cholesky L~d, rows W: the off-diagonal block X~. `level_hook(lvl,
    "start" | "end")` as in `frontal.frontal_factor_streamed`. With `mesh`,
    `fronts` as `assemble.MeshAssembler` placed them: a slot-sharded level
    runs per slot over its blocks (a `Sharded` factor), any other on the
    mesh's first device. `stats`, when given, gains `signed_panels` and
    `signed_columns`, the panels and columns of the plan's pivot widths
    that the blocked signed factorization runs (once per level, per slot
    under a mesh), and `signed_panel_launches`, the `hk.signed_panel`
    kernel launches among them: `signed_panels` on the card, 0 on the
    CPU."""
    out: List = [None] * fp.levels
    panels = columns = 0
    launches = hk.LAUNCHES["signed_panel"]
    devices = mesh.flat if mesh is not None else [None]
    home = devices[0] or fronts[-1].device
    pieces, counts = None, None
    for lvl in range(fp.levels - 1, -1, -1):
        with trace.level(lvl, level_hook, home):
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
                    view, lvl,
                    frontal._slab_of(fronts[lvl], s, b0, b0, b1, dev),
                    None if pieces is None else frontal._take_child_rows(
                        pieces, counts, 2 * b0, 2 * b1, dev),
                    sig.slabs[lvl][b0:b1].to(dev))
                parts.append(fac)
                new_pieces.append(nxt)
                panels += -(-int(fp.W[lvl]) // PANEL)
                columns += int(fp.W[lvl])
            fronts[lvl] = None
            out[lvl] = (parts[0] if place is None or place.kind != "slot"
                        else frontal.Sharded(parts, place,
                                             (B,) + parts[0].shape[1:],
                                             devices))
            # every span of a level hands an update, or none does
            pieces = None if new_pieces[0] is None else new_pieces
            counts = [b1 - b0 for _, _, b0, b1 in spans]
    if stats is not None:
        stats.update(signed_panels=panels, signed_columns=columns,
                     signed_panel_launches=hk.LAUNCHES["signed_panel"]
                     - launches)
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

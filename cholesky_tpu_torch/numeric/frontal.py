"""Batched multifrontal factorization and the banded solve chain — the
single-device, in-core part of `cholesky_tpu/numeric/frontal.py`.

Ported:
  * `_factor_level` (`:1249`): the leaf branch (`:1274-1299`, with the
    deferred ("xxt", X) Schur product) and the square-front branch
    (`:1364-1431`).
  * `_apply_child_updates_fused` (`:857-882`), the one extend-add strategy.
  * `frontal_factor` (`:1434`) and `factor` (`:2552`, in-core only).
  * `invert_pivots` (`:2340`), `_solve_banded_core` / `_solve_banded`
    (`:1983-2040`).

Levels that `hopper_kernels.slab_kernel_eligible` accepts go through
`factor_slab` (the hand-written Cholesky/inverse kernel on the card); the
others through `torch.linalg.cholesky_ex` + `solve_triangular`. The
two-piece path for square fronts past TWO_PIECE_BYTES and the streamed
factorization past STREAM_BYTES are not ported (ROADMAP, queue 1, item 10)
and raise NotImplementedError.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.numeric.frontal_plan import FrontalPlan, _banded_maps

# The JAX package's regime thresholds (frontal.py:1111, :2501). Past them it
# switches to paths that this port does not have yet.
TWO_PIECE_BYTES = 512 << 20
STREAM_BYTES = 5 << 30


def _device_index(fp: FrontalPlan, name: str, lvl, device) -> torch.Tensor:
    """int64 device copy of a plan index array, cached on the plan."""
    key = (name, lvl, str(device))
    t = fp.cache.get(key)
    if t is None:
        _, _, inv_map, pad_of, bnd_pad = _banded_maps(fp)
        if name == "inv_map":
            host = inv_map
        elif name == "pad_of":
            host = pad_of
        elif name == "bnd_pad":
            host = bnd_pad[lvl]
        else:                                   # inv_child, fwd_child
            host = getattr(fp, name)[lvl]
        t = torch.from_numpy(np.asarray(host, dtype=np.int64)).to(device)
        fp.cache[key] = t
    return t


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of the lower triangle of `a`."""
    return torch.linalg.cholesky_ex(a)[0]


def _solve_lower_t(ld: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = b @ inv(ld)^T: the boundary-strip TRSM."""
    return torch.linalg.solve_triangular(ld.transpose(1, 2), b, upper=True,
                                         left=False)


def _apply_child_updates_fused(fp: FrontalPlan, full: torch.Tensor,
                               U: torch.Tensor, child_lvl: int):
    """Subtract both children's updates U [2B, K, K] from the parent's
    square fronts [B, Fp, Fp] in one gather + one scatter-add:

      * columns: gather from the child update, padded with a zero column
        (the sentinel K), putting each child row into parent columns;
      * rows: scatter-add the child rows at their parent positions, with a
        dummy sentinel row Fp. Sibling pairs share a batch index, so the
        scatter must accumulate duplicates.

    The update is applied in place on a padded copy of `full`."""
    device = full.device
    inv = _device_index(fp, "inv_child", child_lvl, device)     # [2B, Fp]
    fwd = _device_index(fp, "fwd_child", child_lvl, device)     # [2B, K]
    B2, K = fwd.shape
    Fp = fp.F[child_lvl - 1]
    upad = tnf.pad(U, (0, 1))                                   # col sentinel
    e1 = torch.gather(upad, 2, inv[:, None, :].expand(B2, K, Fp))
    seg = (torch.arange(B2, device=device) >> 1)[:, None].expand(B2, K)
    fullpad = tnf.pad(full, (0, 0, 0, 1))                       # row sentinel
    fullpad.index_put_((seg, fwd), -e1.to(full.dtype), accumulate=True)
    return fullpad[:, :Fp, :]


def _factor_level(fp: FrontalPlan, lvl: int, piv: torch.Tensor, U):
    """One level of the multifrontal factorization. Consumes the level's
    pivot slabs `piv` [B, F, W] and the children's accumulated updates `U`
    (None at the leaf level; a [2B, K, K] tensor; or ("xxt", X), a deferred
    leaf Schur product). Returns (factor [B, F, W], U_next) where U_next
    feeds the parent level (None when lvl == 0)."""
    Wl, Fl = fp.W[lvl], fp.F[lvl]
    B = piv.shape[0]
    use_kernel = hk.slab_kernel_eligible(B, Wl, piv.dtype)

    if U is None:
        # leaf levels: no children, so the square front is never needed —
        # factor the [B, F, W] pivot slab directly
        if use_kernel:
            fac = hk.factor_slab(piv, Wl)
        else:
            ld = _cholesky(piv[:, :Wl, :])
            fac = (torch.cat([ld, _solve_lower_t(ld, piv[:, Wl:, :])], dim=1)
                   if Fl > Wl else ld)
        if lvl == 0:
            return fac, None
        if Fl > Wl:
            # defer the leaf Schur product: the parent forms X X^T
            return fac, ("xxt", fac[:, Wl:, :])
        return fac, piv.new_zeros((B, 0, 0))

    if B * Fl * Fl * 4 > TWO_PIECE_BYTES:
        raise NotImplementedError(
            f"level {lvl}: square fronts of {B * Fl * Fl * 4 >> 20} MiB need "
            "the two-piece path, which is not ported yet (ROADMAP, queue 1, "
            "item 10: capacity regimes)")
    full = torch.cat([piv, piv.new_zeros((B, Fl, Fl - Wl))], dim=2)
    if isinstance(U, tuple):
        xc = U[1]
        U = xc @ xc.transpose(1, 2)
    if U.shape[1] > 0:
        full = _apply_child_updates_fused(fp, full, U, lvl + 1)
    if use_kernel:
        fac = hk.factor_slab(full[:, :, :Wl].contiguous(), Wl)
    else:
        ld = _cholesky(full[:, :Wl, :Wl])
        fac = (torch.cat([ld, _solve_lower_t(ld, full[:, Wl:, :Wl])], dim=1)
               if Fl > Wl else ld)
    if lvl == 0:
        return fac, None
    if Fl > Wl:
        X = fac[:, Wl:, :]
        return fac, X @ X.transpose(1, 2) - full[:, Wl:, Wl:]
    return fac, piv.new_zeros((B, 0, 0))


def frontal_factor(fp: FrontalPlan, fronts: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, ...]:
    """Factor all fronts level by level, leaves to root; returns per-level
    [B, F, W] factors (pivot Cholesky stacked over the solved boundary
    strip)."""
    out: List[torch.Tensor] = [None] * fp.levels
    U = None
    for lvl in range(fp.levels - 1, -1, -1):
        out[lvl], U = _factor_level(fp, lvl, fronts[lvl], U)
    return tuple(out)


def factor(fp: FrontalPlan, fronts: Sequence[torch.Tensor]
           ) -> Tuple[torch.Tensor, ...]:
    """In-core factorization. Front sets past STREAM_BYTES would take the
    JAX package's streamed path, which is not ported."""
    total = sum(f.numel() * f.element_size() for f in fronts)
    if total > STREAM_BYTES:
        raise NotImplementedError(
            f"{total >> 20} MiB of fronts needs the streamed factorization, "
            "which is not ported yet (ROADMAP, queue 1, item 10: capacity "
            "regimes)")
    return frontal_factor(fp, fronts)


def invert_pivots(fp: FrontalPlan, factors) -> Tuple[torch.Tensor, ...]:
    """Per-level explicit inverses of the pivot Cholesky factors (a
    triangular solve against the identity), amortized over the many vector
    solves of the refinement loop. Computed in the factor's dtype (the JAX
    package inverts in f32 and uses the inverses only for f32 factors)."""
    out = []
    for lvl in range(fp.levels):
        W = fp.W[lvl]
        ld = factors[lvl][:, :W, :]
        eye = torch.eye(W, dtype=ld.dtype, device=ld.device)
        out.append(torch.linalg.solve_triangular(ld, eye.expand_as(ld),
                                                 upper=False))
    return tuple(out)


def _solve_banded_core(fp: FrontalPlan, factors, inv_pivots,
                       g: torch.Tensor) -> torch.Tensor:
    """Forward + backward substitution in the level-major padded basis (see
    `_banded_maps`). `g` is the PADDED rhs [n_pad + 1] with a zero sentinel
    last slot (left unchanged); returns x padded [n_pad + 1], sentinel 0.
    Per level the forward step is a slice + 2 batched matvecs + a boundary
    scatter-add (fronts of one level share ancestor rows, so it
    accumulates); the backward step a boundary gather + 2 matvecs + a
    slice write."""
    levels = fp.levels
    _, offs, _, _, _ = _banded_maps(fp)
    g = g.clone()
    ys = [None] * levels
    for lvl in range(levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        B = fp.front_rows[lvl].shape[0]
        band = g[offs[lvl]:offs[lvl] + B * Wl].view(B, Wl, 1)
        y = torch.bmm(inv_pivots[lvl], band)                   # [B, W, 1]
        ys[lvl] = y
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].to(y.dtype)
            contrib = torch.bmm(X, y).reshape(-1)
            g.index_add_(0, _device_index(fp, "bnd_pad", lvl, g.device)
                         .reshape(-1), contrib, alpha=-1)
    xg = torch.zeros_like(g)
    for lvl in range(levels):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        B = fp.front_rows[lvl].shape[0]
        rhs = ys[lvl]
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].to(rhs.dtype)
            z = xg[_device_index(fp, "bnd_pad", lvl, g.device)]   # [B, K]
            rhs = rhs - torch.bmm(X.transpose(1, 2), z[:, :, None])
        x = torch.bmm(inv_pivots[lvl].transpose(1, 2), rhs)
        xg[offs[lvl]:offs[lvl] + B * Wl] = x.reshape(-1)
    return xg


def _solve_banded(fp: FrontalPlan, factors, inv_pivots,
                  b_perm: torch.Tensor) -> torch.Tensor:
    """Permuted-basis wrapper around `_solve_banded_core`: one entry gather
    into the padded basis, one exit gather back. `b_perm` [n] -> x [n]."""
    device = b_perm.device
    b_ext = torch.cat([b_perm, b_perm.new_zeros(1)])
    g = torch.cat([b_ext[_device_index(fp, "inv_map", None, device)],
                   b_perm.new_zeros(1)])                     # [n_pad + 1]
    xg = _solve_banded_core(fp, factors, inv_pivots, g)
    return xg[_device_index(fp, "pad_of", None, device)]

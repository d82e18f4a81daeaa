"""Row-group factorization of NARROW mid-tree levels (1 < B < ndev) — the
port of `cholesky_tpu/parallel/dist_level.py`.

A level with fewer fronts than slots would otherwise replicate. Instead
the mesh reshapes to a (fb = B fronts, rg = ndev / B slots) grid and each
front factors over its own G = ndev / B slots, slot s = fb G + g holding
rows [g F / G, (g + 1) F / G) of front fb:

  1. extend-add: each slot assembles ITS rows of the pivot columns from
     the front's two child updates, with the same `inv_child` maps as the
     single-device paths, row-sliced;
  2. one all-gather of the slab rows inside the group, then the pivot
     block factors redundantly on every slot of the group;
  3. the boundary TRSM on the slot's own rows;
  4. one all-gather of the factored rows gives every slot X in full, and
     each slot emits ITS rows of the Schur update U2 = X X^T + E_T (the
     trailing extend-add, gathered for those rows only).

The all-gathers are peer copies inside the group. The operations are the
single-device square path's (Cholesky of the pivot block, a triangular
solve, one Schur product); only the row partition differs. The factor
and U2 leave row-sharded (`mesh.Sharded`, kind "rows").

DIST_MID is the JAX package's CHOLESKY_TPU_DIST_MID: False replicates
narrow levels instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cholesky_tpu_torch.numeric.frontal_plan import hands_x
from cholesky_tpu_torch.parallel.mesh import (FB_AXIS, RG_AXIS, Mesh,
                                              Placement, Sharded, _send)

DIST_MID = True     # False: narrow levels replicate


def eligible(fp, lvl: int, B: int, mesh) -> bool:
    """A mesh, a non-root level with fewer fronts than slots, slots
    divisible over the fronts, and the slab rows and the Schur rows
    divisible over each group."""
    if mesh is None or lvl < 1 or not DIST_MID:
        return False
    ndev = mesh.size
    if not (1 < B < ndev) or ndev % B:
        return False
    G = ndev // B
    F, W = fp.F[lvl], fp.W[lvl]
    K = F - W
    return not (F % G or (K and K % G))


def level_mesh(mesh: Mesh, B: int) -> Mesh:
    """The (fb, rg) grid over the mesh's slots, slice-major, so sibling
    groups stay inside a slice on a multislice mesh."""
    return Mesh(mesh.flat, (FB_AXIS, RG_AXIS), shape=(B, mesh.size // B))


def _slab_rows(piv, s: int, fb: int, r0: int, r1: int, device):
    """Slot s's rows of front fb's pivot slab: its part of a row-sharded
    slab, or a slice of a whole one."""
    if isinstance(piv, Sharded) and piv.kind == "rows":
        return piv.parts[s][0].to(device)
    if isinstance(piv, Sharded):
        piv = piv.gather(device, fb, fb + 1)
        return piv[0, r0:r1]
    return piv[fb, r0:r1].to(device)


def factor_level_sharded(fp, lvl: int, piv, U, mesh: Mesh, update_dtype,
                         stats: Optional[dict] = None):
    """The square path of `frontal._factor_level` for an eligible narrow
    level: returns (factor [B, F, W], U2 [B, K, K] in update_dtype), both
    `Sharded` by row groups (U2 None when K = 0). `piv` is the level's
    [B, F, W] slab (row sharded or whole); `U` the children's update, an
    object whose `take(r0, r1, device)` gives its rows [r0, r1) on
    `device` (None: no update), in the form `frontal_plan.hands_x` gives:
    the leaves' X [2B, Kc, Wc] or a dense [2B, Kc, Kc]. `stats["bytes"]`
    counts what the all-gathers copy between slots."""
    from cholesky_tpu_torch.numeric import frontal as _f

    B = piv.shape[0]
    F, W = fp.F[lvl], fp.W[lvl]
    K = F - W
    grid = level_mesh(mesh, B)
    devs = grid.flat
    G = grid.devices.shape[1]
    cl = lvl + 1
    xxt = hands_x(fp.F, fp.W, cl)
    inv = np.asarray(fp.inv_child[cl], dtype=np.int64).reshape(B, 2, F)
    rows_per = F // G
    urows = K // G
    place = Placement("rows", (FB_AXIS, RG_AXIS, None), mesh.size, B)

    # 1) each slot: its rows of the pivot columns, extend-added
    slot = []
    for s, dev in enumerate(devs):
        fb, g = divmod(s, G)
        r0, r1 = g * rows_per, (g + 1) * rows_per
        pl = _slab_rows(piv, s, fb, r0, r1, dev)
        cdt = _f._acc(pl.dtype)
        if U is None:
            up = pl.new_zeros((2, 1, 1), dtype=cdt)     # the sentinel only
        else:
            up = U.take(2 * fb, 2 * fb + 2, dev).to(cdt)
            if xxt:
                up = up @ up.transpose(1, 2)            # X X^T [2, Kc, Kc]
            # a zero row and column absorb the sentinel index Kc
            up = torch.nn.functional.pad(up, (0, 1, 0, 1))
        mine = torch.from_numpy(inv[fb]).to(dev)        # [2, F]
        invr, invc, invb = mine[:, r0:r1], mine[:, :W], mine[:, W:]
        contrib = sum(up[c][invr[c][:, None], invc[c][None, :]]
                      for c in range(2))
        slot.append({"dev": dev, "fb": fb, "g": g, "dtype": pl.dtype,
                     "up": up, "invb": invb,
                     "slab": pl.to(cdt) - contrib})
        del pl, contrib

    def group(s, key):
        """The group's row blocks of `key`, gathered on slot s's device."""
        fb, dev = slot[s]["fb"], slot[s]["dev"]
        return torch.cat([_send(slot[t][key], dev, stats, t != s)
                          for t in range(fb * G, (fb + 1) * G)])

    # 2) + 3) redundant pivot factorization, then the TRSM on my rows
    for s, st in enumerate(slot):
        full = group(s, "slab")                          # [F, W]
        ld = _f._cholesky(full[None, :W, :])[0]          # [W, W]
        del full
        sol = _f._solve_lower_t(ld[None], st["slab"][None])[0]
        rows = st["g"] * rows_per + torch.arange(rows_per, device=st["dev"])
        st["fac"] = torch.where((rows < W)[:, None],
                                ld[rows.clamp(max=W - 1)], sol)
        del ld, sol
    for st in slot:
        del st["slab"]
    fac = Sharded([st["fac"].to(st["dtype"])[None] for st in slot], place,
                  (B, F, W), devs)
    if not K:
        return fac, None
    # 4) my rows of U2 = X X^T + E_T
    for s, st in enumerate(slot):
        X = group(s, "fac")[W:]                          # [K, W]
        my = st["g"] * urows + torch.arange(urows, device=st["dev"])
        up, invb = st["up"], st["invb"]
        T = sum(up[c][invb[c][my][:, None], invb[c][None, :]]
                for c in range(2))                       # [K/G, K]
        st["u2"] = torch.addmm(T, X[my], X.T).to(update_dtype)[None]
        del X, T
    u2 = Sharded([st["u2"] for st in slot], place, (B, K, K), devs)
    return fac, u2

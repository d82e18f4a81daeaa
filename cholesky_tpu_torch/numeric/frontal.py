"""Batched multifrontal factorization, its capacity regimes, and the solves —
the single-device part of `cholesky_tpu/numeric/frontal.py`.

Ported:
  * `_factor_level` (`:1249`): the leaf branch (`:1274-1299`), the
    two-piece branch (`:1314-1362`) and the square-front branch
    (`:1364-1431`). The update a level hands its parent is a tensor or
    None; its form is `frontal_plan.hands_x`'s: the leaves' boundary
    strips X, whose Schur product X X^T the parent forms (the deferred
    leaf product), else the dense update.
  * The square path's extend-add `_apply_child_updates_fused` (`:857`):
    `_form_front` forms each level's square fronts from the pivot slabs and
    the children's updates in one pass (`hopper_kernels.form_front`, a
    hand-written kernel on the card; `form_front_ref` its plain version).
  * The two-piece extend-add: `_expand_xxt_2` (`:603`), `_apply_gather_2`
    (`:755`), `_schur_update_cast` / `_schur_gather_2` /
    `_einsum_rows_cast` (`:646-752`) and the dispatcher
    `_apply_extadd_two_piece` (`:824`).
  * `_BatchView` (`:1603`), `_take_child_rows` (`:1687`) and
    `frontal_factor_streamed` (`:1704`), the one level loop: lazily
    assembled levels, batch-chunked levels, the stored factor's dtype, offload
    of finished levels to host memory and the spill of emitted update pieces.
    `factor` (`:2552`) runs it.
  * `invert_pivots` (`:2340`), `_solve_banded_core` / `_solve_banded`
    (`:1983-2040`; with a sign vector, the quasi-definite solve of a signed
    factor, `numeric/ldlt.py`), and `frontal_solve` (`:2043`), the solve
    without pivot inverses, which also reads bf16 and host-resident
    levels. Every solve takes one right-hand side [n] or a block [n, k];
    `solve_multi` (`:2431`) is the block's entry point.
  * `frontal_upper_solve` (`:2203`, x = L^-T z) and `frontal_upper_matvec`
    (`:2249`, z = L^T x), the sampler's and the whitening's transforms.
  * `forward_partial` / `backward_partial` (`:2146-2200`), the sweeps of
    static condensation: `_sweeps` stopped before the root, and the
    backward sweep from level 1 with the root rows given.
  * Same-pattern families (`factor_many` / `solve_many_systems`,
    `:2451-2498`): K systems folded into the batch axis (`FamilyView`), so
    one level loop factors the whole family and the kernel route decides on
    the folded batch K 2^lvl (the JAX package switches its kernel off under
    `vmap`).
  * `extract_factor_coo` / `extract_factor_dense` (`:2649-2700`).
  * The mesh (`parallel/`): `_RootSpec` / `root_spec` (`_effective_root_
    mesh`, `:1152-1210`) and `level_paths` (`_mesh_for_level`, `:1227`).
    Under a mesh the level loop runs slot-sharded levels per slot on the
    slot's device (each slot's blocks are a closed subtree, the batch-chunk
    machinery with global block offsets), eligible narrow levels through
    `dist_level.factor_level_sharded` (`:1301-1313`), the rest on the
    mesh's first device, the root through `dist_cholesky` when
    ROOT_DIST_MIN asks for it (`:1345`, `:1394`); every capacity regime
    applies per slot, and
    an offloaded sharded level goes back to its slots (`:2609-2620`). The
    solves run the slot-sharded levels per slot on work arrays of their
    own and sum them at the transition to the narrow levels; a family on
    a mesh holds K / ndev whole systems per slot (`:2451-2500`).

Which regime each level takes comes from one memory budget
(`regimes.plan_regimes`). Levels that `hopper_kernels.slab_kernel_eligible`
accepts go through `factor_slab` (the hand-written kernels of
`kernels/csrc/factor_slab.cu` and `chol_inv.cu` on the card, which read the
slab in place, the square path's strided view included); the others through
`torch.linalg.cholesky_ex` + `solve_triangular`.

Eager PyTorch runs one level at a time and frees a tensor when its last
reference goes, so the level loop bounds its working set by dropping
references (and by writing in place where the JAX code relied on buffer
donation): a level consumes its pivot slab, and `frontal_factor_streamed`
consumes the list of slabs it is given. Every large temporary of an
extend-add or a Schur product is cut into row chunks of at most
`regimes.CHUNK_BYTES`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from cholesky_tpu_torch import trace
from cholesky_tpu_torch.numeric import devmem, regimes
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.numeric.assemble import LazyFronts
from cholesky_tpu_torch.numeric.frontal_plan import (FrontalPlan, _banded_maps,
                                                     hands_x)
from cholesky_tpu_torch.parallel import dist_cholesky, dist_level
from cholesky_tpu_torch.parallel import mesh as mesh_mod
from cholesky_tpu_torch.parallel.mesh import Sharded

# Narrowest root front that factors collectively over a mesh
# (CHOLESKY_TPU_ROOT_DIST_MIN); None: none does, every root factors on the
# first slot. Nothing observable favours the collective root in one
# process: it gathers the whole factor back onto the first slot, so it
# frees no memory there, and on H100s it lost to one cuSOLVER call on the
# first slot at every width timed (chip_smoke.py's mesh phase, PERF.md).
# Setting a width (the JAX package's default is 2048) forces it.
ROOT_DIST_MIN: Optional[int] = None

# The spans of a level's steps in `_factor_level`, one each per chunk
PIVOT = "chol.step.pivot"
SCHUR = "chol.step.schur"
EXTEND_ADD = "chol.step.extend_add"


def _acc(dtype) -> torch.dtype:
    """Accumulation dtype of a stored dtype: f64 stays f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _device_index(fp: FrontalPlan, name: str, lvl, device,
                  family: int = 1) -> torch.Tensor:
    """int64 device copy of a plan index array, cached on the plan (in the
    pool of long-lived state, `devmem`). With `family` = K > 1, the K-fold
    map of a family folded into the batch axis (`FamilyView`), made on the
    device from the single map: the child maps repeated (their entries are
    positions inside a front), the row maps `piv_rows` / `bnd_rows` of
    system k offset by k (n + 1), so that each system has rows of its own
    and a sentinel row of its own."""
    key = (name, lvl, str(device), family)
    t = fp.cache.get(key)
    if t is None and family > 1:
        one = _device_index(fp, name, lvl, device)
        with devmem.persistent(device):
            t = one.repeat(family, 1)
            if name in ("piv_rows", "bnd_rows"):
                off = (fp.plan.n + 1) * torch.arange(family, device=device)
                t += off.repeat_interleave(one.shape[0])[:, None]
        fp.cache[key] = t
    if t is None:
        _, _, inv_map, pad_of, bnd_pad = _banded_maps(fp)
        if name in ("perm", "iperm"):
            host = getattr(fp.plan, name)
        elif name == "inv_map":
            host = inv_map
        elif name == "pad_of":
            host = pad_of
        elif name == "bnd_pad":
            host = bnd_pad[lvl]
        elif name == "piv_rows":
            host = fp.front_rows[lvl][:, :fp.W[lvl]]
        elif name == "bnd_rows":
            host = fp.front_rows[lvl][:, fp.W[lvl]:]
        elif name == "extent":
            host = np.stack(_extent_host(fp, lvl), axis=1)
        else:                                   # inv_child, fwd_child
            host = getattr(fp, name)[lvl]
        with devmem.persistent(device):
            t = torch.from_numpy(np.asarray(host, dtype=np.int64)).to(device)
        fp.cache[key] = t
    return t


def _extent_host(fp: FrontalPlan, lvl: int):
    """(m, p) per front of level lvl: its boundary rows and its pivots, the
    non-sentinel entries of its row list after and before W (cached on
    the plan)."""
    key = ("extent_host", lvl)
    hit = fp.cache.get(key)
    if hit is None:
        fr, W, n = fp.front_rows[lvl], fp.W[lvl], fp.plan.n
        hit = fp.cache[key] = ((fr[:, W:] < n).sum(axis=1),
                               (fr[:, :W] < n).sum(axis=1))
    return hit


class _BatchView:
    """The plan seen from blocks [c0, c1) of level `lvl`: F, W and levels
    are the plan's; the child maps of level lvl + 1 are cut to rows
    [2 c0, 2 c1) (sibling pairs (2i, 2i + 1) merge into parent i, so a slice
    of a level's blocks is a closed sub-problem)."""

    def __init__(self, fp, lvl: int, c0: int, c1: int):
        self.base, self.lvl, self.c0, self.c1 = fp, lvl, c0, c1
        self.F, self.W, self.levels = fp.F, fp.W, fp.levels


class FamilyView:
    """The plan of a family of K same-pattern systems folded into the batch
    axis: level lvl holds K 2^lvl fronts, system-major (front b of system k
    at k 2^lvl + b). Sibling pairs (2i, 2i + 1) stay adjacent and the parent
    of front i is i >> 1, as for one system, so the level loop, the
    extend-add and the kernel route run unchanged on the folded batch; the
    index maps come K-fold (`_device_index(..., family=K)`)."""

    def __init__(self, fp: FrontalPlan, K: int):
        self.base, self.K = fp, int(K)
        self.F, self.W, self.levels = fp.F, fp.W, fp.levels


class _SlotView:
    """The plan seen from one slot of a mesh in a solve: at the levels in
    `spans` ({lvl: (b0, b1)}) only the slot's blocks; the index maps of
    those levels are cut to its rows."""

    def __init__(self, fp, spans: dict):
        self.base, self.spans = fp, spans
        self.F, self.W, self.levels = fp.F, fp.W, fp.levels


def _unwrap(fp) -> Tuple[FrontalPlan, int]:
    """(the FrontalPlan, the family size K) under a batch, slot or family
    view."""
    if isinstance(fp, (_BatchView, _SlotView)):
        fp = fp.base
    if isinstance(fp, FamilyView):
        return fp.base, fp.K
    return fp, 1


def _index(fp, name: str, lvl, device) -> torch.Tensor:
    """`_device_index` of a plan or a family view (K-fold); a slot view's
    levels cut to the slot's blocks."""
    if isinstance(fp, _SlotView):
        t = _index(fp.base, name, lvl, device)
        if lvl in fp.spans:
            b0, b1 = fp.spans[lvl]
            t = t[b0:b1]
        return t
    base, K = _unwrap(fp)
    return _device_index(base, name, lvl, device, K)


def _child_maps(fp, child_lvl: int, device):
    """(inv [2b, Fp], fwd [2b, Kc]) int64 device maps of level child_lvl,
    cut to a batch view's rows."""
    inv = _index(fp, "inv_child", child_lvl, device)
    fwd = _index(fp, "fwd_child", child_lvl, device)
    if isinstance(fp, _BatchView) and fp.lvl == child_lvl - 1:
        inv = inv[2 * fp.c0:2 * fp.c1]
        fwd = fwd[2 * fp.c0:2 * fp.c1]
    return inv, fwd


def _extents(fp, lvl: int, device) -> torch.Tensor:
    """The int64 [b, 2] device map (m_b, p_b) of level lvl's fronts that
    `schur_syrk` reads, cut to a batch view's blocks (a view of blocks
    [c0, c1) of its level holds [2 c0, 2 c1) of the level below)."""
    ext = _index(fp, "extent", lvl, device)
    if isinstance(fp, _BatchView):
        d = lvl - fp.lvl
        ext = ext[fp.c0 << d:fp.c1 << d]
    return ext


def _syrk_route(dtype, out_dtype) -> bool:
    """Whether a Schur product of X of `dtype` stored as `out_dtype` goes
    to `hk.schur_syrk`: an f32 update of f32 operands at IEEE products;
    the TF32 rung, f64 and narrower updates stay with cuBLAS."""
    return (dtype == torch.float32 and out_dtype == dtype
            and not hk._tf32())


def schur_tile_share(fp: FrontalPlan, plan) -> Optional[float]:
    """The share of the padded full Schur products' flops (2 B K^2 W a
    level with a boundary) that a factorization of fp under the regime plan
    `plan` (`regimes.plan_regimes`) executes, at the rung in force:
    `schur_syrk`'s tiles inside the fronts' extents where `_syrk_route`
    sends the level's product, the padded product where cuBLAS forms it
    (the gather tier; a leaf level whose parent's xxt tier expands X); None
    with no boundary. The tiles' flops are counted once per plan."""
    L, dtype = fp.levels, plan.dtype
    done = full = 0.0
    for lvl in range(1, L):
        K, W = fp.F[lvl] - fp.W[lvl], fp.W[lvl]
        if K == 0:
            continue
        lp = plan.levels[lvl]
        if lvl == L - 1:                # X X^T of the leaves, at the parent
            up = plan.levels[lvl - 1]
            routed = (_syrk_route(lp.update_dtype, lp.update_dtype)
                      and not (up.two_piece and up.xxt_tier))
        else:
            routed = (_syrk_route(dtype, lp.update_dtype)
                      and not (lp.two_piece and not lp.xxt_tier
                               and fp.F[lvl + 1] > fp.W[lvl + 1]))
        tiles = fp.cache.get(("schur_flops", lvl))
        if tiles is None:
            tiles = fp.cache[("schur_flops", lvl)] = float(
                hk.schur_syrk_flops(*_extent_host(fp, lvl)).sum())
        padded = 2.0 * len(fp.front_rows[lvl]) * K * K * W
        full += padded
        done += tiles if routed else padded
    return done / full if full else None


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of the lower triangle of `a`. A block that is not
    positive definite comes back all NaN (LAPACK stops at the failing
    column and leaves finite garbage), so that it poisons its ancestors as
    it does on the kernel route and `factorize(check=True)` sees it; the
    mask is applied on the device, with no host read."""
    L, info = torch.linalg.cholesky_ex(a)
    return L.masked_fill_((info != 0)[:, None, None], float("nan"))


def _solve_lower_t(ld: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = b @ inv(ld)^T: the boundary-strip TRSM."""
    return torch.linalg.solve_triangular(ld.transpose(1, 2), b, upper=True,
                                         left=False)


def _factor_slab(slab: torch.Tensor, Wl: int, route_b: Optional[int] = None,
                 root: Optional["_RootSpec"] = None) -> torch.Tensor:
    """Partial factorization of pivot slabs [b, F, W] (rows [:W] the pivot
    Cholesky, rows [W:] the solved boundary strip): `factor_slab` where the
    routing rule takes the level, else cuSOLVER + TRSM written into one
    output. The rule reads `route_b` (the batch of the level, or of its
    chunk, over the whole mesh; default the slab's own). With `root`, a
    root front [1, W, W] factors collectively over its mesh."""
    b, Fl, _ = slab.shape
    if root is not None and b == 1 and Fl == Wl:
        fn = (dist_cholesky.distributed_cholesky_2d if root.scheme == "2d"
              else dist_cholesky.distributed_cholesky)
        return fn(slab[0], root.mesh, block=root.block)[None]
    if hk.slab_kernel_eligible(b if route_b is None else route_b, Wl,
                               slab.dtype):
        return hk.factor_slab(slab, Wl)
    return _factor_slab_library(slab, Wl)


def _factor_slab_library(slab: torch.Tensor, Wl: int) -> torch.Tensor:
    """The library route of `_factor_slab`: cuSOLVER's Cholesky of the
    pivot blocks and cuBLAS's TRSM of the boundary strip, written into one
    [b, F, W] output."""
    b, Fl, _ = slab.shape
    if Fl == Wl:
        return _cholesky(slab)
    fac = slab.new_empty((b, Fl, Wl))
    fac[:, :Wl] = _cholesky(slab[:, :Wl, :])
    fac[:, Wl:] = _solve_lower_t(fac[:, :Wl], slab[:, Wl:, :])
    return fac


def _extadd_rows(U: torch.Tensor, inv: torch.Tensor, r0: int, r1: int,
                 cols: torch.Tensor, acc) -> torch.Tensor:
    """Rows [r0, r1) of the children's extend-add in parent coordinates,
    restricted to parent columns `cols`:

        E[b, f, g] = sum_s U[2b+s, inv[2b+s, f], inv[2b+s, g]]

    -> [b, r1 - r0, |cols|] in `acc` (sentinel positions read zero)."""
    Kc = U.shape[1]
    E = hk.cols_gather(hk.rows_gather(U, inv[:, r0:r1]), cols, Kc)
    B2 = E.shape[0]
    return E.view(B2 // 2, 2, r1 - r0, E.shape[2]).sum(1, dtype=acc)


def _form_front(fp, piv: torch.Tensor, U: Optional[torch.Tensor],
                child_lvl: int) -> torch.Tensor:
    """The square fronts [B, F + 1, F] of level child_lvl - 1 (row F the
    sentinel, zero) from its pivot slabs piv [B, F, W] and the children's
    update U [2B, K, K] (None: no update). One `hopper_kernels.form_front`
    (the kernel on the card), in the span EXTEND_ADD; the maps are cut to
    a batch view's rows."""
    dev = piv.device
    lvl = child_lvl - 1
    with trace.span(EXTEND_ADD, dev):
        inv = None if U is None else _child_maps(fp, child_lvl, dev)[0]
        return hk.form_front(piv, U, inv, fp.F[lvl], fp.W[lvl])


def _rows_product(A: torch.Tensor, out_dtype, ext=None) -> torch.Tensor:
    """A A^T for A [b, K, J] accumulated in f32 (or f64) and stored as
    out_dtype; by row chunks when out_dtype is narrower, so the full-size
    accumulator never exists (the port of `_einsum_rows_cast` for Ga = Gb).
    Where `_syrk_route` says so, `hk.schur_syrk` forms it inside the
    extents `ext` (`_extents`; None: the whole [K, K])."""
    if _syrk_route(A.dtype, out_dtype):
        return hk.schur_syrk(A, ext=ext)
    acc = _acc(A.dtype)
    A = A.to(acc)
    if out_dtype == acc:
        return A @ A.transpose(1, 2)
    b, K, J = A.shape
    out = torch.empty((b, K, K), dtype=out_dtype, device=A.device)
    ch = regimes.schur_rows(b, K, J, acc_size=A.element_size())
    for r0 in range(0, K, ch):
        out[:, r0:r0 + ch] = A[:, r0:r0 + ch] @ A.transpose(1, 2)
    return out


def _expand_xxt_2(fp, X: torch.Tensor, child_lvl: int, W: int, t_dtype):
    """Leaf-transition two-piece expansion straight from X [2b, Kc, Wc] (a
    leaf child's update is exactly X X^T): X's rows are gathered into parent
    coordinates with the siblings folded into the contraction,
    Gr = [P1 X1 | P2 X2] [b, Fp, 2 Wc], and

        E_slab = Gr Gr[:, :W]^T  [b, Fp, W],  E_T = Gr[:, W:] Gr[:, W:]^T.

    E_T is stored as t_dtype (accumulated in f32 or f64)."""
    inv, _ = _child_maps(fp, child_lvl, X.device)
    B2, Kc, Wc = X.shape
    b, Fp = B2 // 2, inv.shape[1]
    acc = _acc(X.dtype)
    inv2 = inv.view(b, 2, Fp).transpose(1, 2).reshape(b, 2 * Fp)
    sib = torch.arange(2 * Fp, device=X.device) & 1
    bat = 2 * torch.arange(b, device=X.device)[:, None] + sib[None, :]
    Gr = X[bat, inv2.clamp(max=Kc - 1)]                 # [b, 2 Fp, Wc]
    Gr.masked_fill_((inv2 >= Kc)[:, :, None], 0)
    Gr = Gr.view(b, Fp, 2 * Wc).to(acc)
    E_slab = Gr @ Gr[:, :W].transpose(1, 2)
    E_T = _rows_product(Gr[:, W:], t_dtype) if Fp > W else None
    return E_slab, E_T


def _apply_gather_2(fp, slab: torch.Tensor, U: torch.Tensor,
                    child_lvl: int) -> torch.Tensor:
    """Two-piece extend-add by masked gathers: the slab piece is subtracted
    from `slab` in place, row chunk by row chunk (each chunk's gather
    buffers bounded by regimes.CHUNK_BYTES). The trailing piece is left to
    `_schur_gather_2`, which gathers it row chunk by row chunk, so the
    [b, K, K] piece never exists."""
    inv, _ = _child_maps(fp, child_lvl, slab.device)
    B2, Kc = U.shape[:2]
    _, Fp, W = slab.shape
    cols = inv[:, :W]
    ch = regimes.gather_rows(B2, Kc, W, U.element_size(),
                             slab.element_size())
    for r0 in range(0, Fp, ch):
        r1 = min(r0 + ch, Fp)
        slab[:, r0:r1].sub_(_extadd_rows(U, inv, r0, r1, cols, slab.dtype))
    return slab


def _apply_extadd_two_piece(fp, slab: torch.Tensor, U: torch.Tensor,
                            child_lvl: int, lp: "regimes.LevelPlan"):
    """The two-piece extend-add of the children's update U into pivot slabs
    [b, Fp, W] (the slab piece is subtracted in place), by the tier of the
    level plan `lp`. The xxt tier expands the leaves' X [2b, Kc, Wc]
    directly and returns the trailing piece E_T [b, K, K] in
    lp.update_dtype. The gather tier reads a [2b, Kc, Kc] update (a level
    that takes it for the leaves' X materializes X X^T first) and returns
    U itself, whose trailing piece `_schur_gather_2` gathers. Either
    returns None when the level has no trailing block."""
    if lp.xxt_tier:
        E_slab, E_T = _expand_xxt_2(fp, U, child_lvl, slab.shape[2],
                                    lp.update_dtype)
        slab.sub_(E_slab)
        return E_T
    _apply_gather_2(fp, slab, U, child_lvl)
    return U if slab.shape[1] > slab.shape[2] else None


def _schur_update_cast(X: torch.Tensor, E_T: Optional[torch.Tensor],
                       out_dtype, beta: float = 1.0,
                       ext=None) -> torch.Tensor:
    """U2 = X X^T + beta E_T (E_T [b, K, K] or None), accumulated in X's
    dtype (f32 or f64) and stored as out_dtype, by exact row chunks when
    out_dtype is narrower. With beta = 1 and E_T already of the output
    dtype it is accumulated in place, so E_T and U2 never coexist. Where
    `_syrk_route` says so (and E_T, if any, is of X's dtype),
    `hk.schur_syrk` forms it inside the fronts' extents `ext` (`_extents`),
    in place likewise; no consumer reads U2 outside them."""
    if _syrk_route(X.dtype, out_dtype) and (E_T is None
                                            or E_T.dtype == X.dtype):
        if E_T is None:
            return hk.schur_syrk(X, ext=ext)
        return hk.schur_syrk(X, E_T, beta, ext,
                             out=E_T if beta == 1 else None)
    acc = X.dtype
    Xt = X.transpose(1, 2)
    if out_dtype == acc:
        if E_T is None:
            return X @ Xt
        if beta == 1 and E_T.dtype == acc:
            return E_T.baddbmm_(X, Xt)
        return torch.baddbmm(E_T.to(acc), X, Xt, beta=beta)
    b, K, W = X.shape
    ch = regimes.schur_rows(b, K, W, acc_size=X.element_size())
    seeded = E_T is not None and beta == 1 and E_T.dtype == out_dtype
    out = E_T if seeded else torch.empty((b, K, K), dtype=out_dtype,
                                         device=X.device)
    for r0 in range(0, K, ch):
        r1 = min(r0 + ch, K)
        pc = X[:, r0:r1] @ Xt
        if E_T is not None:
            pc.add_(E_T[:, r0:r1], alpha=beta)
        out[:, r0:r1] = pc
        del pc
    return out


def _schur_gather_2(fp, X: torch.Tensor, U: torch.Tensor, child_lvl: int,
                    out_dtype) -> torch.Tensor:
    """U2 = X X^T + E_T of a gather-tier two-piece level, accumulated in
    X's dtype and stored as out_dtype, by row chunks: each chunk of E_T,
    the trailing piece of the children's extend-add of U [2b, Kc, Kc], is
    gathered inside the loop, so E_T is never materialized."""
    acc = X.dtype
    Xt = X.transpose(1, 2)
    b, K, W = X.shape
    inv, _ = _child_maps(fp, child_lvl, X.device)
    cols = inv[:, W:]
    ch = regimes.schur_rows(b, K, W, U.shape[0], U.shape[1],
                            U.element_size(), X.element_size())
    out = torch.empty((b, K, K), dtype=out_dtype, device=X.device)
    for r0 in range(0, K, ch):
        r1 = min(r0 + ch, K)
        pc = X[:, r0:r1] @ Xt
        pc += _extadd_rows(U, inv, W + r0, W + r1, cols, acc)
        out[:, r0:r1] = pc
        del pc
    return out


def _factor_level(fp, lvl: int, piv: torch.Tensor, U: Optional[torch.Tensor],
                  lp: Optional["regimes.LevelPlan"] = None,
                  route_b: Optional[int] = None,
                  root: Optional["_RootSpec"] = None):
    """One level of the multifrontal factorization. Consumes the level's
    pivot slabs `piv` [b, F, W] (the two-piece path writes into them) and
    the children's update `U`: None (the leaf level, or children with no
    boundary), the leaves' X [2b, K, Wc] where `hands_x` says the children
    hand it, else a [2b, K, K] update. Returns (factor [b, F, W], U_next),
    U_next what feeds the parent: the leaves' X (a view of the factor),
    a [b, K, K] update, or None (lvl 0, or no boundary). `lp` is the
    level's regime (square front or two piece, xxt tier, update dtype);
    None is the in-core square path with updates in the factor's dtype.
    `route_b` and `root` as in `_factor_slab` (the root only where children
    feed the level). Its steps open the spans PIVOT, SCHUR and EXTEND_ADD
    (`trace.py`); the leaves' X X^T is formed here, in SCHUR, unless a
    two-piece level's xxt tier expands X directly."""
    Wl, Fl = fp.W[lvl], fp.F[lvl]
    udt = piv.dtype if lp is None else lp.update_dtype
    dev = piv.device

    if lvl == fp.levels - 1:
        # leaf levels: no children, so the square front is never needed —
        # factor the [B, F, W] pivot slab directly; the parent forms X X^T
        with trace.span(PIVOT, dev):
            fac = _factor_slab(piv, Wl, route_b)
        return fac, (fac[:, Wl:, :] if hands_x(fp.F, fp.W, lvl) else None)

    two = lp is not None and lp.two_piece
    if hands_x(fp.F, fp.W, lvl + 1) and not (two and lp.xxt_tier):
        with trace.span(SCHUR, dev):                    # X X^T; frees X
            U = _rows_product(U, U.dtype, _extents(fp, lvl + 1, dev))

    if two:
        # the factorization reads only the pivot slab [B, F, W] and the
        # trailing block [B, K, K], so the square [B, F, F] front is never
        # built; T is what the Schur step reads of the children's update
        T = None
        if U is not None:
            with trace.span(EXTEND_ADD, dev):
                T = _apply_extadd_two_piece(fp, piv, U, lvl + 1, lp)
        del U
        with trace.span(PIVOT, dev):
            fac = _factor_slab(piv, Wl, route_b, root)
        del piv
        if lvl == 0 or Fl == Wl:
            return fac, None
        with trace.span(SCHUR, dev):
            if T is None or lp.xxt_tier:
                return fac, _schur_update_cast(fac[:, Wl:, :], T, udt,
                                               ext=_extents(fp, lvl, dev))
            return fac, _schur_gather_2(fp, fac[:, Wl:, :], T, lvl + 1, udt)

    full = _form_front(fp, piv, U, lvl + 1)           # row Fl: sentinel
    del piv, U
    with trace.span(PIVOT, dev):
        fac = _factor_slab(full[:, :Fl, :Wl], Wl, route_b, root)
    if lvl == 0 or Fl == Wl:
        return fac, None
    with trace.span(SCHUR, dev):
        return fac, _schur_update_cast(fac[:, Wl:, :], full[:, Wl:Fl, Wl:],
                                       udt, beta=-1.0,
                                       ext=_extents(fp, lvl, dev))


def _take_child_rows(pieces: List, counts: List[int], r0: int, r1: int,
                     device):
    """Rows [r0, r1) of the concatenation of `pieces` (child-update tensors
    stacked along axis 0, sizes `counts`; host pieces are uploaded, pieces
    of other devices copied, row-sharded pieces gathered). A span inside
    one piece on `device` is a view; otherwise a copy on the device."""
    parts = []
    off = 0
    for arr, cnt in zip(pieces, counts):
        lo, hi = max(r0 - off, 0), min(r1 - off, cnt)
        if lo < hi:
            parts.append(arr.gather(device, lo, hi) if isinstance(arr, Sharded)
                         else arr[lo:hi])
        off += cnt
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=0)


class _RootSpec:
    """The collective-root decision, resolved once per factorization: the
    mesh, the scheme ("1d", "2d", or "off" when the root is too narrow to
    amortize the per-step traffic) and the column block."""

    __slots__ = ("mesh", "scheme", "block")

    def __init__(self, mesh, scheme: str, block: int):
        self.mesh, self.scheme, self.block = mesh, scheme, block


def root_spec(fp, mesh) -> Optional[_RootSpec]:
    """`_effective_root_mesh`: None without a mesh; else the scheme of
    `dist_cholesky._pick_scheme` for the root's width W[0], "off" when
    ROOT_DIST_MIN is None or above W[0] (read at call time, as the block
    dist_cholesky.ROOT_BLOCK and its ROOT_SCHEME are)."""
    if mesh is None:
        return None
    block = dist_cholesky.ROOT_BLOCK
    if ROOT_DIST_MIN is None or fp.W[0] < ROOT_DIST_MIN:
        return _RootSpec(mesh, "off", block)
    return _RootSpec(mesh, dist_cholesky._pick_scheme(fp.W[0], mesh.size,
                                                      block, mesh), block)


def _is_family(fp) -> bool:
    if isinstance(fp, (_BatchView, _SlotView)):
        fp = fp.base
    return isinstance(fp, FamilyView)


def level_placement(fp, lvl: int, mesh):
    """The placement of level lvl's [B, F, W] on `mesh` (None without one):
    a family's by its system axis at every level, one system's by
    `mesh.panel_sharding`."""
    if mesh is None:
        return None
    if _is_family(fp):
        return mesh_mod.family_sharding(mesh, _unwrap(fp)[1])
    return mesh_mod.panel_sharding(mesh, lvl)


def level_paths(fp, mesh, root: Optional[_RootSpec] = None,
                rows: bool = True) -> List[str]:
    """Per level how the level loop runs it on `mesh` (`_mesh_for_level`):
    "slot" (per slot on its blocks), "rows" (row groups, `dist_level`),
    "root-1d" / "root-2d" (the collective root) or "replicated" (on the
    mesh's first device); all "single" without a mesh. `rows` = False
    gives the quasi-definite factorization's paths (`ldlt.factor_qd`),
    which takes no row groups."""
    out = []
    for lvl in range(fp.levels):
        place = level_placement(fp, lvl, mesh)
        if place is None:
            out.append("single")
        elif place.kind == "slot":
            out.append("slot")
        elif (rows and place.kind == "rows" and lvl < fp.levels - 1
              and dist_level.eligible(fp, lvl, 1 << lvl, mesh)):
            out.append("rows")
        elif (lvl == 0 and root is not None and root.scheme != "off"
              and not _is_family(fp)):
            out.append("root-" + root.scheme)
        else:
            out.append("replicated")
    return out


def _spans(place, devices, B: int):
    """(slot, device, b0, b1) per slot that runs a level of B blocks: every
    slot of a slot-sharded level, else the first device alone."""
    if place is None or place.kind != "slot":
        return [(0, devices[0], 0, B)]
    return [(s, d) + place.batch_range(s, B) for s, d in enumerate(devices)]


def _slab_of(item, s: int, b0: int, c0: int, c1: int, device):
    """Blocks [c0, c1) of a level's assembled slab on `device`: from slot
    s's part (which holds blocks from b0 on) or from the whole slab (a
    row-sharded one gathered)."""
    if isinstance(item, Sharded) and item.kind == "slot":
        return item.parts[s][c0 - b0:c1 - b0].to(device)
    if isinstance(item, Sharded):
        return item.gather(device, c0, c1)
    return item[c0:c1].to(device)


def frontal_factor_streamed(fp: FrontalPlan, fronts, plan,
                            level_hook=None, mesh=None,
                            root: Optional[_RootSpec] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """The level loop, leaves to root, under a regime plan
    (`regimes.plan_regimes`): per level, `plan.levels[lvl]` gives the path
    (square or two-piece), the update dtype, the batch-chunk count, the
    stored factor's dtype and whether the finished level moves to host
    memory (and whether its emitted update pieces do too: the spill).

    `fronts` is a list of [B, F, W] slabs — CONSUMED: each entry is dropped
    once its level ran and its storage may have been overwritten — or a
    `LazyFronts`, which assembles each level (or each chunk of it) on the
    device right before it runs. A chunked level with nc chunks runs nc
    independent sub-problems over blocks [c0, c1); each consumes rows
    [2 c0, 2 c1) of the children's update, and update pieces are freed as
    soon as their last chunk has consumed them.

    `level_hook(lvl, "start" | "end")`, when given, is called around each
    level (instrumentation: per-level device time and memory).

    `fp` may be a `FamilyView` of K systems: B is then K 2^lvl, and `plan`
    the regime plan of that batch (`plan_regimes(..., family=K)`).

    With `mesh` (`parallel.mesh.Mesh`), `fronts` is the list that
    `assemble.MeshAssembler` placed on the slots and `plan` is
    per slot (`plan_regimes(..., mesh=mesh)`): a slot-sharded level runs
    on each slot's device over the slot's blocks, in the plan's chunks
    (the kernel route decided on the level's batch over the whole mesh);
    an eligible narrow level by row groups (`dist_level`); any other
    level on the mesh's first device, the root collectively when `root`
    (`root_spec`) says so.

    Returns the per-level [B, F, W] factors: device tensors, CPU tensors
    for offloaded levels, `Sharded` levels under a mesh."""
    lazy = isinstance(fronts, LazyFronts)
    if mesh is not None:
        devices = mesh.flat
    else:
        devices = [fronts.device if lazy else fronts[0].device]
    dtype = plan.dtype
    K = _unwrap(fp)[1]
    out: List = [None] * fp.levels
    # the children's update: row pieces stacked along axis 0 (none: no
    # update), in the form `hands_x` gives for the level below
    pieces, counts = [], []
    for lvl in range(fp.levels - 1, -1, -1):
        with trace.level(lvl, level_hook, devices[0]):
            lp = plan.levels[lvl]
            B, Fl, Wl = K << lvl, fp.F[lvl], fp.W[lvl]
            place = level_placement(fp, lvl, mesh)
            if (place is not None and place.kind == "rows"
                    and lvl < fp.levels - 1
                    and dist_level.eligible(fp, lvl, B, mesh)):
                child = _Child(pieces, counts) if pieces else None
                pieces = counts = None
                fac, nxt = dist_level.factor_level_sharded(
                    fp, lvl, fronts[lvl], child, mesh, lp.update_dtype)
                del child
                if not lazy:
                    fronts[lvl] = None
                out[lvl] = fac.map(lambda p: _store(p, lp))
                del fac
                pieces = [] if nxt is None else [
                    nxt.map(torch.Tensor.cpu) if lp.spill else nxt]
                counts = [B]
                del nxt
                continue
            nc = lp.chunks
            # the stored factor stays the compute-dtype tensor on the device:
            # a leaf's X can then be a view of it
            keep = not lp.offload and lp.store_dtype == dtype
            x_view = keep and lp.update_dtype == dtype
            x_out = hands_x(fp.F, fp.W, lvl)
            # the kernel route reads the batch of a chunk over the whole mesh
            route_b = B // nc
            lroot = root if (lvl == 0 and root is not None
                             and root.scheme != "off") else None
            new_pieces, new_counts, parts = [], [], []

            def slab(s, b0, c0, c1, device):
                if lazy:
                    return (fronts[lvl] if nc == 1
                            else fronts.chunk(lvl, c0, c1))
                return _slab_of(fronts[lvl], s, b0, c0, c1, device)

            def update(c0, c1, device):
                """Rows [2 c0, 2 c1) of the children's update; pieces that this
                chunk consumes to their end leave the list, so they are freed
                when the level drops the update."""
                if not pieces:
                    return None
                U = _take_child_rows(pieces, counts, 2 * c0, 2 * c1, device)
                off = 0
                for i, cnt in enumerate(counts):
                    if off + cnt <= 2 * c1:
                        pieces[i] = None
                    off += cnt
                return U

            for s, dev, b0, b1 in _spans(place, devices, B):
                cb = (b1 - b0) // nc
                stored = None if nc == 1 else torch.empty(
                    (b1 - b0, Fl, Wl), dtype=lp.store_dtype,
                    device="cpu" if lp.offload else dev)
                for c in range(nc):
                    c0, c1 = b0 + c * cb, b0 + (c + 1) * cb
                    view = (fp if (c0, c1) == (0, B)
                            else _BatchView(fp, lvl, c0, c1))
                    # slab and update are passed as call expressions, not
                    # names, so that the level can free them as soon as it is
                    # done with them
                    fac, nxt = _factor_level(
                        view, lvl, slab(s, b0, c0, c1, dev),
                        update(c0, c1, dev), lp, route_b, lroot)
                    if nc == 1:
                        stored = fac if keep else _store(fac, lp)
                    else:
                        stored[c0 - b0:c1 - b0] = fac
                    if x_out:                                 # the leaf's X
                        nxt = (stored[c0 - b0:c1 - b0, Wl:, :] if x_view else
                               nxt.to(lp.update_dtype).contiguous())
                    del fac
                    if nxt is not None:
                        new_pieces.append(nxt.cpu() if lp.spill else nxt)
                        new_counts.append(cb)
                    del nxt
                parts.append(stored)
                del stored
            if not lazy:
                fronts[lvl] = None
            out[lvl] = (parts[0] if place is None or place.kind != "slot" else
                        Sharded(parts, place, (B, Fl, Wl), devices))
            del parts
            pieces, counts = new_pieces, new_counts
    return tuple(out)


class _Child:
    """The children's update of a row-group level (`dist_level`): rows of
    the pieces on any device."""

    def __init__(self, pieces, counts):
        self.pieces, self.counts = pieces, counts

    def take(self, r0: int, r1: int, device) -> torch.Tensor:
        return _take_child_rows(self.pieces, self.counts, r0, r1, device)


def _store(fac: torch.Tensor, lp) -> torch.Tensor:
    """The level's stored factor: cast to the plan's store dtype and, when
    the plan offloads the level, copied to host memory."""
    out = fac.to(lp.store_dtype)
    return out.cpu() if lp.offload else out


def _upload(f, device):
    """A stored level back on the device: a sharded one on its slots."""
    return f.home() if isinstance(f, Sharded) else f.to(device)


def factor(fp: FrontalPlan, fronts, plan, level_hook=None, mesh=None,
           root: Optional[_RootSpec] = None) -> Tuple[torch.Tensor, ...]:
    """The factorization under a regime plan (`regimes.plan_regimes`), level
    by level, leaves to root; returns per-level [B, F, W] factors (pivot
    Cholesky stacked over the solved boundary strip):
    `frontal_factor_streamed` over eager slabs or a `LazyFronts` (`mesh`
    and `root` as there). When the plan offloaded levels and their stored
    bytes plus the solve's working set fit the budget (`plan.reupload`),
    the levels move back to the device (a sharded level to its slots), so
    that every solve does not ship them again."""
    if mesh is not None:
        device = mesh.flat[0]
    else:
        device = fronts.device if isinstance(fronts, LazyFronts) \
            else fronts[0].device
    out = frontal_factor_streamed(fp, fronts, plan, level_hook=level_hook,
                                  mesh=mesh, root=root)
    if plan.reupload:
        out = tuple(_upload(f, device) for f in out)
    return out


def _inverse(f: torch.Tensor, W: int, device) -> torch.Tensor:
    """inv(L) of the pivot blocks of one stored level (or slot part), on
    `device` in f32 (f64 for an f64 factor)."""
    ld = f[:, :W, :].to(device, _acc(f.dtype))
    eye = torch.eye(W, dtype=ld.dtype, device=ld.device)
    return torch.linalg.solve_triangular(ld, eye.expand_as(ld), upper=False)


def invert_pivots(fp: FrontalPlan, factors, device=None
                  ) -> Tuple[torch.Tensor, ...]:
    """Per-level explicit inverses of the pivot Cholesky factors (a
    triangular solve against the identity), amortized over the many vector
    solves of the refinement loop. Computed on `device` (default: the
    factors') in f32, or in f64 for an f64 factor, whatever the stored
    dtype; a host-resident level is moved to the device for its
    inversion. A slot-sharded level is inverted on its slots (a `Sharded`
    of [B, W, W]); a row-sharded one gathered onto `device`."""
    out = []
    for lvl in range(fp.levels):
        W = fp.W[lvl]
        f = factors[lvl]
        if isinstance(f, Sharded) and f.kind == "slot":
            out.append(Sharded([_inverse(p, W, d)
                                for p, d in zip(f.parts, f.devices)],
                               f.placement, (f.shape[0], W, W), f.devices))
        else:
            f = mesh_mod.local(f, device)
            out.append(_inverse(f, W, device or f.device))
        del f
    return tuple(out)


def _slot_levels(factors, top: int = 0) -> int:
    """The shallowest level from which every deeper level is slot-sharded
    (len(factors) when none is), not above `top`."""
    lw = len(factors)
    while (lw > top and isinstance(factors[lw - 1], Sharded)
           and factors[lw - 1].kind == "slot"):
        lw -= 1
    return lw


def _slots(factors, lw: int, *more):
    """Per slot of the slot-sharded levels lw .. leaves: (device, {lvl:
    (b0, b1)}, and for `factors` and each list in `more` the per-level
    slot parts (None above lw))."""
    L = len(factors)
    if lw >= L:
        return []
    ref = factors[L - 1]
    out = []
    for s, dev in enumerate(ref.devices):
        spans = {lvl: factors[lvl].placement.batch_range(
            s, factors[lvl].shape[0]) for lvl in range(lw, L)}
        lists = [[x[lvl].parts[s] if lvl >= lw else None for lvl in range(L)]
                 for x in (factors,) + more]
        out.append((dev, spans, *lists))
    return out


def _banded_forward(fp, factors, inv_pivots, g, ys, lvls, spans, signs):
    """Forward steps of the banded solve over `lvls` (see
    `_solve_banded_core`), each level over blocks spans[lvl] (default:
    all of them)."""
    _, offs, _, _, _ = _banded_maps(fp)
    k = g.shape[1]
    for lvl in lvls:
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        b0, b1 = spans.get(lvl, (0, fp.front_rows[lvl].shape[0]))
        r0, r1 = offs[lvl] + b0 * Wl, offs[lvl] + b1 * Wl
        inv = mesh_mod.local(inv_pivots[lvl], g.device)
        y = torch.bmm(inv, g[r0:r1].view(b1 - b0, Wl, k))     # [B, W, k]
        ys[lvl] = y
        if Fl > Wl:
            X = _strip(factors[lvl], Wl, y)
            contrib = torch.bmm(X, y).reshape(-1, k)
            del X
            g.index_add_(0, _device_index(fp, "bnd_pad", lvl, g.device)
                         [b0:b1].reshape(-1), contrib, alpha=-1)
        if signs is not None:                                  # w = S z
            y *= signs[r0:r1].view(b1 - b0, Wl, 1).to(y.device, y.dtype)


def _banded_backward(fp, factors, inv_pivots, xg, ys, lvls, spans):
    """Backward steps of the banded solve over `lvls`."""
    _, offs, _, _, _ = _banded_maps(fp)
    k = xg.shape[1]
    for lvl in lvls:
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        b0, b1 = spans.get(lvl, (0, fp.front_rows[lvl].shape[0]))
        rhs = ys[lvl]
        if Fl > Wl:
            X = _strip(factors[lvl], Wl, rhs)
            z = xg[_device_index(fp, "bnd_pad", lvl, xg.device)[b0:b1]]
            rhs = rhs - torch.bmm(X.transpose(1, 2), z)
            del X
        inv = mesh_mod.local(inv_pivots[lvl], xg.device)
        x = torch.bmm(inv.transpose(1, 2), rhs)
        xg[offs[lvl] + b0 * Wl:offs[lvl] + b1 * Wl] = x.reshape(-1, k)


def _strip(f, Wl: int, like: torch.Tensor) -> torch.Tensor:
    """The boundary strips X = f[:, W:, :] of a stored level (a sharded
    one gathered) on `like`'s device and in its dtype."""
    if isinstance(f, Sharded):
        f = f.gather(like.device)
    return f[:, Wl:, :].to(like.device, like.dtype)


def _solve_banded_core(fp: FrontalPlan, factors, inv_pivots,
                       g: torch.Tensor, signs=None) -> torch.Tensor:
    """Forward + backward substitution in the level-major padded basis (see
    `_banded_maps`). `g` is the PADDED rhs [n_pad + 1], or a block of k of
    them [n_pad + 1, k] (columns the minor axis, so that a level's band
    views as [B, W, k]), with a zero sentinel last slot (left unchanged);
    returns x padded in g's shape, sentinel 0. Per level the forward step is
    a slice + 2 batched products + a boundary scatter-add (fronts of one
    level share ancestor rows, so it accumulates; with atomics, so sums
    over shared rows come in no fixed order); the backward step a boundary
    gather + 2 products + a slice write. A level stored narrower than g
    (bf16) or in host memory is promoted / moved for its products.

    `signs` ([n_pad + 1] in the padded basis, `ldlt.DeviceSigns.padded`)
    makes it the quasi-definite solve of a signed factor: the forward
    results ys are scaled by S between the two loops.

    Slot-sharded levels (a mesh factor, with `invert_pivots`' sharded
    inverses) run per slot on the slot's device, on a work vector holding
    only the slot's bands: the forward steps' contributions to the narrow
    levels' rows are summed into g, and after the narrow levels' backward
    steps each slot solves its bands from a copy of x."""
    levels = fp.levels
    _, offs, _, _, _ = _banded_maps(fp)
    vec = g.dim() == 1
    g = (g[:, None] if vec else g).clone()
    ys = [None] * levels
    lw = _slot_levels(factors)
    slots = []
    for dev, spans, fac_s, inv_s in _slots(factors, lw, inv_pivots):
        own = torch.cat([torch.arange(offs[lvl] + b0 * fp.W[lvl],
                                      offs[lvl] + b1 * fp.W[lvl])
                         for lvl, (b0, b1) in spans.items()])
        gs = g.new_zeros(g.shape, device=dev)
        gs[own.to(dev)] = g[own.to(g.device)].to(dev)
        ys_s = [None] * levels
        _banded_forward(fp, fac_s, inv_s, gs, ys_s, range(levels - 1, lw - 1,
                                                          -1), spans, signs)
        slots.append((dev, own, gs, ys_s, spans, fac_s, inv_s))
    for dev, own, gs, *_ in slots:
        gs[own.to(dev)] = 0
        g += gs.to(g.device)
    _banded_forward(fp, factors, inv_pivots, g, ys, range(lw - 1, -1, -1),
                    {}, signs)
    xg = torch.zeros_like(g)
    _banded_backward(fp, factors, inv_pivots, xg, ys, range(lw), {})
    done = []
    for dev, own, _, ys_s, spans, fac_s, inv_s in slots:
        xs = xg.to(dev, copy=True)
        _banded_backward(fp, fac_s, inv_s, xs, ys_s, range(lw, levels), spans)
        done.append((own, xs))
    for own, xs in done:
        xg[own.to(xg.device)] = xs[own.to(xs.device)].to(xg.device)
    return xg[:, 0] if vec else xg


def _solve_banded(fp: FrontalPlan, factors, inv_pivots,
                  b_perm: torch.Tensor, signs=None) -> torch.Tensor:
    """Permuted-basis wrapper around `_solve_banded_core` (`signs` as
    there): one entry gather into the padded basis, one exit gather back.
    `b_perm` [n] or [n, k] -> x of the same shape."""
    device = b_perm.device
    zero = b_perm.new_zeros((1,) + tuple(b_perm.shape[1:]))
    b_ext = torch.cat([b_perm, zero])
    g = torch.cat([b_ext[_device_index(fp, "inv_map", None, device)],
                   zero])                                # [n_pad + 1(, k)]
    xg = _solve_banded_core(fp, factors, inv_pivots, g, signs)
    return xg[_device_index(fp, "pad_of", None, device)]


def _tri_apply(pan: torch.Tensor, rhs: torch.Tensor, W: int,
               transpose: bool, solve: bool = True) -> torch.Tensor:
    """x with L x = rhs (or L^T x = rhs) for the pivot blocks L =
    pan[:, :W, :] and rhs [B, W, k]; with solve=False the product L^T rhs
    (the lower triangle of L read). One batch chunk at a time: each chunk
    of L is promoted to rhs's dtype on its own (a level-sized promotion of
    a bf16 level is GiB-scale)."""
    out = torch.empty_like(rhs)
    bc = regimes.solve_batch(W, W, rhs.element_size(), rhs.shape[2])
    for i in range(0, rhs.shape[0], bc):
        ld = pan[i:i + bc, :W, :].to(rhs.dtype)
        r = rhs[i:i + bc]
        if not solve:
            out[i:i + bc] = torch.tril(ld).transpose(1, 2) @ r
        elif transpose:
            out[i:i + bc] = torch.linalg.solve_triangular(
                ld.transpose(1, 2), r, upper=True)
        else:
            out[i:i + bc] = torch.linalg.solve_triangular(ld, r, upper=False)
    return out


def _x_apply(pan: torch.Tensor, vec: torch.Tensor, W: int,
             forward: bool) -> torch.Tensor:
    """The boundary products X y ([B, K, k], forward) or X^T z ([B, W, k])
    of the strips X = pan[:, W:, :], with the same chunk-local promotion."""
    B, F, _ = pan.shape
    k = vec.shape[2]
    out = vec.new_empty((B, F - W if forward else W, k))
    bc = regimes.solve_batch(F - W, W, vec.element_size(), k)
    for i in range(0, B, bc):
        X = pan[i:i + bc, W:, :].to(vec.dtype)
        v = vec[i:i + bc]
        out[i:i + bc] = X @ v if forward else X.transpose(1, 2) @ v
    return out


def _sweep_forward(fp, factors, bg: torch.Tensor, lvls) -> None:
    """Forward steps of `_sweeps` over `lvls`."""
    base, K = _unwrap(fp)
    n = base.plan.n
    device = bg.device
    k = bg.shape[1]
    sentinels = bg.view(K, n + 1, k)[:, n]
    for lvl in lvls:
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        pan = _on(factors[lvl], device)
        piv = _index(fp, "piv_rows", lvl, device)
        y = _tri_apply(pan, bg[piv], Wl, transpose=False)
        bg[piv] = y
        if Fl > Wl:
            bnd = _index(fp, "bnd_rows", lvl, device)
            bg.index_add_(0, bnd.reshape(-1),
                          _x_apply(pan, y, Wl, True).reshape(-1, k),
                          alpha=-1)
        sentinels.zero_()
        del pan


def _sweep_backward(fp, factors, bg: torch.Tensor, lvls) -> None:
    """Backward steps of `_sweeps` over `lvls`."""
    base, K = _unwrap(fp)
    n = base.plan.n
    device = bg.device
    sentinels = bg.view(K, n + 1, bg.shape[1])[:, n]
    for lvl in lvls:
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        pan = _on(factors[lvl], device)
        piv = _index(fp, "piv_rows", lvl, device)
        rhs = bg[piv]
        if Fl > Wl:
            z = bg[_index(fp, "bnd_rows", lvl, device)]
            rhs = rhs - _x_apply(pan, z, Wl, False)
        bg[piv] = _tri_apply(pan, rhs, Wl, transpose=True)
        sentinels.zero_()
        del pan


def _on(f, device) -> torch.Tensor:
    """A stored level (or slot part) as one tensor on `device`: a sharded
    level gathered."""
    return f.gather(device) if isinstance(f, Sharded) else f.to(device)


def _own_rows(view: _SlotView, lw: int, device) -> torch.Tensor:
    """The work-array rows of a slot's pivots at levels lw .. leaves
    (padded pivots, which land in a sentinel row, left out)."""
    n = _unwrap(view)[0].plan.n
    rows = torch.cat([_index(view, "piv_rows", lvl, device).reshape(-1)
                      for lvl in range(lw, view.levels)])
    return rows[rows % (n + 1) != n]


def _sweeps(fp, factors, bg: torch.Tensor, forward: bool = True,
            backward: bool = True, top: int = 0) -> None:
    """Forward (L y = b) and / or backward (L^T x = y) substitution, in
    place on the work array bg [R, k] in the permuted basis: for one system
    R = n + 1, row n the sentinel; for a family view R = K (n + 1), rows
    [k (n + 1), (k + 1)(n + 1)) system k's, each with its own sentinel
    last. Per level, a batched triangular solve of the pivot blocks and the
    boundary product, with a gather of the level's rows from bg and a
    scatter back; the sentinels are zeroed after every level. A level held
    in host memory is moved to the device one level at a time, in each
    sweep; a level stored narrower than bg (bf16) is promoted one batch
    chunk at a time. `top` = 1 leaves out the root level: the forward sweep
    stops before it and the backward sweep starts below it (the partial
    sweeps of static condensation).

    Slot-sharded levels (a mesh factor) run per slot on the slot's device:
    forward on a work array holding only the slot's pivot rows, whose
    contributions to the narrow levels' rows are then summed into bg (the
    slot's own rows copied in exactly); backward from a copy of bg after
    the narrow levels, the slot's rows copied back. A row-sharded level is
    gathered onto bg's device."""
    L = fp.levels
    lw = _slot_levels(factors, top)
    slots = [(dev, _SlotView(fp, spans), fac_s)
             for dev, spans, fac_s in _slots(factors, lw)]
    if forward:
        done = []
        for dev, view, fac_s in slots:
            own = _own_rows(view, lw, dev)
            bs = bg.new_zeros(bg.shape, device=dev)
            bs[own] = bg[own.to(bg.device)].to(dev)
            _sweep_forward(view, fac_s, bs, range(L - 1, lw - 1, -1))
            done.append((own, bs))
        for own, bs in done:
            bg[own.to(bg.device)] = 0
            bg += bs.to(bg.device)
        del done
        _sweep_forward(fp, factors, bg, range(lw - 1, top - 1, -1))
    if backward:
        _sweep_backward(fp, factors, bg, range(top, lw))
        done = []
        for dev, view, fac_s in slots:
            bs = bg.to(dev, copy=True)
            _sweep_backward(view, fac_s, bs, range(lw, L))
            done.append((_own_rows(view, lw, dev), bs))
        for own, bs in done:
            bg[own.to(bg.device)] = bs[own].to(bg.device)


def _with_sentinel(b_perm: torch.Tensor):
    """(work array [n + 1, k] with a zero sentinel row, whether b_perm was
    a vector)."""
    vec = b_perm.dim() == 1
    b2 = b_perm[:, None] if vec else b_perm
    return torch.cat([b2, b2.new_zeros((1, b2.shape[1]))]), vec


def frontal_solve(fp: FrontalPlan, factors, b_perm: torch.Tensor
                  ) -> torch.Tensor:
    """Forward + backward substitution against the per-level factors
    without pivot inverses (`_sweeps`), in the permuted basis. `b_perm` [n]
    or [n, k] (the rhs in PERMUTED order, f32 or f64, on the solve's
    device) -> x of the same shape."""
    bg, vec = _with_sentinel(b_perm)
    _sweeps(fp, factors, bg)
    n = fp.plan.n
    return bg[:n, 0] if vec else bg[:n]


def forward_partial(fp: FrontalPlan, factors, b_perm: torch.Tensor
                    ) -> torch.Tensor:
    """Forward substitution over levels levels-1 .. 1 only, the interior
    of the tree below the root separator (`frontal_forward_partial`,
    `frontal.py:2146`). Returns the work array [n + 1] (or [n + 1, k]),
    sentinel last: at the root separator's pivot rows the CONDENSED
    right-hand side b_hat = b_r - A_ro A_oo^-1 b_o of the Schur-complement
    system S x_r = b_hat, at interior pivot rows y = L_oo^-1 b_o, which
    `backward_partial` reads."""
    bg, vec = _with_sentinel(b_perm)
    _sweeps(fp, factors, bg, backward=False, top=1)
    return bg[:, 0] if vec else bg


def backward_partial(fp: FrontalPlan, factors, bg: torch.Tensor,
                     x_root: torch.Tensor) -> torch.Tensor:
    """Backward substitution over levels 1 .. levels-1 given the interface
    solution `x_root` ([W0] or [W0, k], zero past the root separator's
    size) and the work array of `forward_partial` (`frontal_backward_
    partial`, `frontal.py:2177`): recovers the interior, x_o = A_oo^-1 (b_o
    - A_or x_r). Returns x in PERMUTED order, [n] or [n, k] (root rows =
    x_root)."""
    vec = bg.dim() == 1
    bg = (bg[:, None] if vec else bg).clone()
    xr = x_root[:, None] if x_root.dim() == 1 else x_root
    bg[_device_index(fp, "piv_rows", 0, bg.device)[0]] = xr.to(bg.dtype)
    n = fp.plan.n
    bg[n] = 0                           # padded root rows land on it
    _sweeps(fp, factors, bg, forward=False, top=1)
    return bg[:n, 0] if vec else bg[:n]


def frontal_upper_solve(fp: FrontalPlan, factors, z_perm: torch.Tensor
                        ) -> torch.Tensor:
    """x = L^-T z in the PERMUTED basis (`frontal.py:2203`): the backward
    sweep of the solve alone. Since A_perm = L L^T, x has covariance
    A_perm^-1 when z ~ N(0, I): the sparse Cholesky sampler. `z_perm` [n]
    or [n, k] -> x of the same shape."""
    bg, vec = _with_sentinel(z_perm)
    _sweeps(fp, factors, bg, forward=False)
    n = fp.plan.n
    return bg[:n, 0] if vec else bg[:n]


def frontal_upper_matvec(fp: FrontalPlan, factors, x_perm: torch.Tensor
                         ) -> torch.Tensor:
    """z = L^T x in the PERMUTED basis (`frontal.py:2249`), the whitening
    transform: for x ~ N(0, A_perm^-1), L^T x ~ N(0, I). No recursion: each
    separator's rows are z_piv = L_piv^T x_piv + X^T x_bnd, one batched
    product per level (the pivot block's lower triangle read, as the JAX
    package's `tril` does). `x_perm` [n] or [n, k] -> z of the same shape;
    bf16 and host-resident levels are promoted or moved as in the solve."""
    bg, vec = _with_sentinel(x_perm)
    out = torch.empty_like(bg)
    device = bg.device
    for lvl in range(fp.levels):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        pan = _on(factors[lvl], device)
        piv = _device_index(fp, "piv_rows", lvl, device)
        z = _tri_apply(pan, bg[piv], Wl, transpose=True, solve=False)
        if Fl > Wl:
            z += _x_apply(pan, bg[_device_index(fp, "bnd_rows", lvl, device)],
                          Wl, False)
        out[piv] = z                    # padded pivots land in row n
        del pan
    n = fp.plan.n
    return out[:n, 0] if vec else out[:n]


def solve_many_systems(fp: "FamilyView", factors, b_perm: torch.Tensor
                       ) -> torch.Tensor:
    """One solve per system of a family (`frontal.py:2487`): `factors` the
    folded per-level [K 2^lvl, F, W] factors of `fp`'s K systems, `b_perm`
    [K, n] (one right-hand side per system, PERMUTED order) -> x [K, n].
    The K systems share one work array of K (n + 1) rows; each has its own
    rows and sentinel, so no scatter of one lands in another."""
    K, n = b_perm.shape
    if K != fp.K:
        raise ValueError(f"b_perm has {K} rows for a family of {fp.K}")
    bg = torch.cat([b_perm, b_perm.new_zeros((K, 1))], dim=1)
    bg = bg.reshape(K * (n + 1), 1)
    _sweeps(fp, factors, bg)
    return bg.view(K, n + 1)[:, :n]


def solve_multi(fp: FrontalPlan, factors, b_perm: torch.Tensor
                ) -> torch.Tensor:
    """A block of right-hand sides [n, k] against the factor, without pivot
    inverses (`frontal.py:2431`, which maps the vector solve over columns;
    here the column axis is carried through every product)."""
    if b_perm.dim() != 2:
        raise ValueError(f"solve_multi takes [n, k], got "
                         f"{tuple(b_perm.shape)}")
    return frontal_solve(fp, factors, b_perm)


# ---------------------------------------------------------------------------
# Extraction (verification / .mtx output)


def _level_host64(f: torch.Tensor) -> np.ndarray:
    """One stored level as an f64 NumPy array; bf16 and host-resident
    levels are read through f32, sharded ones gathered."""
    f = mesh_mod.local(f, torch.device("cpu"))
    if f.dtype == torch.bfloat16:
        f = f.to(torch.float32)
    return f.cpu().numpy().astype(np.float64)


def extract_factor_coo(fp: FrontalPlan, factors, drop_tol: float = 0.0):
    """Extract the factor L as COO (permuted coordinates, lower triangle).
    Returns (rows, cols, vals) with 0-based permuted indices."""
    plan = fp.plan
    t = plan.tree
    out_r, out_c, out_v = [], [], []
    for lvl in range(fp.levels):
        arr = _level_host64(factors[lvl])
        Wl = fp.W[lvl]
        for sl in range(1 << lvl):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            fr = fp.front_rows[lvl][sl]
            piv = np.tril(arr[sl][:sz, :sz])
            pr_, pc_ = np.nonzero(np.abs(piv) > drop_tol)
            out_r.append(pr_ + off)
            out_c.append(pc_ + off)
            out_v.append(piv[pr_, pc_])
            bnd = fr[Wl:]
            bv = bnd < plan.n
            strip = arr[sl][Wl:, :sz][bv]
            br, bc = np.nonzero(np.abs(strip) > drop_tol)
            out_r.append(bnd[bv][br])
            out_c.append(bc + off)
            out_v.append(strip[br, bc])
    return (np.concatenate(out_r), np.concatenate(out_c),
            np.concatenate(out_v))


def extract_factor_dense(fp: FrontalPlan, factors) -> np.ndarray:
    """Materialize L (permuted coordinates, lower triangular)."""
    plan = fp.plan
    L = np.zeros((plan.n, plan.n))
    t = plan.tree
    for lvl in range(fp.levels):
        arr = _level_host64(factors[lvl])
        Wl = fp.W[lvl]
        for sl in range(1 << lvl):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            fr = fp.front_rows[lvl][sl]
            cols = np.arange(off, off + sz)
            L[np.ix_(cols, cols)] = np.tril(arr[sl][:sz, :sz])
            bnd = fr[Wl:]
            bv = bnd < plan.n
            L[np.ix_(bnd[bv], cols)] = arr[sl][Wl:, :sz][bv]
    return L

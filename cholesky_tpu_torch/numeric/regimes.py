"""One memory budget in place of the JAX package's fixed v5e byte gates.

The JAX package picks its capacity regimes with constants set for a
15.75 GiB TPU v5e: `_TWO_PIECE_BYTES`, `_HBM_BUDGET`, `_U_OFFLOAD_BYTES`,
`_UPDATE_BF16_BYTES`, `_STREAM_BYTES`, `_OFFLOAD_BYTES`,
`_F32_STORE_BYTES`, `_SOLVE_HEADROOM_BYTES` (`cholesky_tpu/numeric/
frontal.py:1111-2548`), the fractions of `api._want_inv_pivots` (`api.py:
680-733`) and XLA's `_CHUNK_FUDGE` (`:1629`). The port derives every such
decision from one number, the budget: the device bytes the factorization
may hold at once. `default_budget` is the free memory of the card when the
factorization starts times BUDGET_FRACTION (the counterpart of
`_hbm_bytes`, `:2505`); a caller may pass any other.

`plan_regimes(fp, dtype, budget)` is a pure function of the frontal plan's
level shapes (F, W), the dtype and the budget. Per level it returns the
path (square front or two-piece, and for a two-piece level fed by the
leaves' X whether it expands X directly), the dtype of the update the level
emits, the batch-chunk count, the stored factor's dtype, whether the
finished level moves to host memory and whether its emitted update pieces
do, and the estimate of the level's peak device bytes: what the eager
PyTorch code in `frontal.py` allocates, term by term (`_level_peak`). That
estimate is all a decision reads; eager PyTorch holds what the code holds,
so there is no fudge factor, and the card checks the estimate
(`chip_smoke.py`, scale phase: per-level `max_memory_allocated` against it).

The plan is a search over a ladder, fastest first; the first rung on which
every level fits is taken:

  1. slabs assembled eagerly, factor stored in the compute dtype on device;
  2. slabs assembled lazily, one level (or chunk) right before it runs;
  3. the factor stored bf16 on the device (f32 only: f64 never degrades);
  4. each finished level moved to host memory;
  5. and the update pieces of chunked levels moved to host memory too.

Within a rung, each level (leaves to root) takes the first option that fits
the budget and leaves its parent at least one option that fits, in this
order: the emitted update in the compute dtype before bf16 (f32 fronts
only); then the square front, then two-piece (expanding the leaves' X
directly before materializing X X^T), then two-piece on 2, 4, ...,
MAX_CHUNKS batch chunks. When no rung fits, `BudgetError` names the level
and the bytes of its smallest option.

The keyword arguments of `plan_regimes` force a choice (the tests and the
smoke run use them to drive each regime at small sizes); what is not
forced is still chosen against the budget, and a forced plan that does not
fit raises.

Under a mesh (`parallel/mesh.py`) the plan is one slot's: a slot-sharded
level at B / ndev blocks, a row-group level (`parallel/dist_level.py`)
at F / G rows of one front (`_rows_peak`), a replicated level whole, each
against the budget of one slot (the device's budget over the slots that
share it). Each slot's slabs are assembled on its device before the
factorization (`assemble.MeshAssembler`), so the lazy rung is not taken. The kernel route of a level is
decided on its batch over the whole mesh, as the level loop decides it.
`slot_bytes` is one level's working set on one slot, the counterpart of
the JAX package's `tools/memcheck_mesh.py`.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.parallel import dist_level
from cholesky_tpu_torch.parallel import mesh as mesh_mod

# Share of the card's free memory that the default budget takes. The rest
# is room the estimate does not see: the caching allocator's fragmentation
# (reserved over allocated) and memory that CUDA libraries take outside it.
BUDGET_FRACTION = 0.9

# Temporaries of an extend-add, a Schur product or a promotion are cut into
# row (or batch) chunks of at most this many bytes.
CHUNK_BYTES = 256 << 20

# Bytes that every level estimate adds for what it does not count one by
# one: cuBLAS / cuSOLVER workspaces, the assembler's uploaded values and
# per-chunk indices, and the allocator's rounding.
SLACK_BYTES = 256 << 20

# Batch-chunk counts tried per level: powers of two up to this many.
MAX_CHUNKS = 64

# The widest ELL row the device refinement takes (denser rows refine on the
# host); the solve's working set is bounded with it.
ELL_MAX_K = 96

_SIZE = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2}


class BudgetError(MemoryError, RuntimeError):
    """No regime plan fits the memory budget. A MemoryError, as the JAX
    package's in-core guards raise (selected inversion, families), and a
    RuntimeError."""


def torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def default_budget(device) -> int:
    """BUDGET_FRACTION of the bytes the caching allocator can hand out on
    `device` now: the CUDA driver's free memory (`torch.cuda.mem_get_info`)
    plus what the allocator holds reserved but unallocated."""
    device = torch.device(device)
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int((free + cached) * BUDGET_FRACTION)


@dataclasses.dataclass
class LevelPlan:
    two_piece: bool             # two-piece extend-add (no square front)
    xxt_tier: bool              # two-piece fed by X: expand X directly
    update_dtype: torch.dtype   # the update (or leaf X) this level emits
    chunks: int                 # batch chunks
    store_dtype: torch.dtype    # the stored factor
    offload: bool               # the stored factor goes to host memory
    spill: bool                 # the emitted update pieces go to host
    peak_bytes: int = 0         # estimated peak device bytes
    square_bytes: int = 0       # ... had the level taken the square path

    def describe(self) -> dict:
        return {"path": ("two-piece" + ("/xxt" if self.xxt_tier else "")
                         if self.two_piece else "square"),
                "update": str(self.update_dtype).replace("torch.", ""),
                "chunks": self.chunks,
                "store": str(self.store_dtype).replace("torch.", ""),
                "offload": self.offload, "spill": self.spill,
                "est_peak_bytes": self.peak_bytes,
                "est_square_bytes": self.square_bytes}


@dataclasses.dataclass
class RegimePlan:
    dtype: torch.dtype          # the fronts' (compute) dtype
    budget: int
    lazy: bool                  # slabs assembled level by level
    reupload: bool              # offloaded levels come back after factor
    levels: List[LevelPlan]
    family: int = 1             # systems folded into the batch axis
    mesh: object = None         # one slot's plan of this mesh

    @property
    def peak_bytes(self) -> int:
        return max(lp.peak_bytes for lp in self.levels)

    def describe(self) -> List[dict]:
        out = [dict(lvl=lvl, **lp.describe())
               for lvl, lp in enumerate(self.levels)]
        out[-1]["path"] = "leaf"
        return out


# ---------------------------------------------------------------------------
# Row and batch chunks of the temporaries (frontal.py uses the same helpers,
# so the estimate counts what the code allocates)


def _rows(per_row: int, n: int) -> int:
    return max(1, min(n, CHUNK_BYTES // max(1, per_row)))


def fused_rows(B2: int, Kc: int, Fp: int, u: int, f: int) -> int:
    """Child rows per chunk of the square path's extend-add: the gathered
    [B2, ch, Fp] update rows, their cast to the front dtype, and the
    scatter's index work."""
    return _rows(B2 * Fp * (u + (f if u != f else 0)) + 32 * B2, Kc)


def gather_rows_bytes(B2: int, Kc: int, ncols: int, u: int, acc: int) -> int:
    """Bytes per parent row of a masked extend-add gather: row gather
    [B2, ., Kc] and its row indices, column gather [B2, ., ncols], its
    promotion to acc, the sibling sum [B2/2, ., ncols]."""
    per = B2 * Kc * u + B2 * ncols * u + (B2 // 2) * ncols * acc + 16 * B2
    return per + (B2 * ncols * acc if u != acc else 0)


def gather_rows(B2: int, Kc: int, ncols: int, u: int, acc: int) -> int:
    """Parent rows per chunk of the two-piece slab extend-add."""
    return _rows(gather_rows_bytes(B2, Kc, ncols, u, acc), 1 << 62)


def schur_rows(b: int, K: int, W: int, B2: int = 0, Kc: int = 0,
               u: int = 0, acc_size: int = 4) -> int:
    """Rows per chunk of a Schur product stored narrower than it is
    accumulated, or fused with the deferred trailing extend-add (B2, Kc,
    u: the children's update): the [b, ch, K] product plus the gathers."""
    per = b * K * acc_size
    if B2:
        per += gather_rows_bytes(B2, Kc, K, u, acc_size)
    return _rows(per, K)


def _fused_chunk(B2, Kc, Fp, u, f) -> int:
    """Peak temporaries of one chunk of `_extend_add_fused_`: the rows and
    the column index / mask vectors."""
    ch = fused_rows(B2, Kc, Fp, u, f)
    return ch * (B2 * Fp * (u + (f if u != f else 0)) + 32 * B2) \
        + 9 * B2 * Fp


def _gather_chunk(B2, Kc, ncols, u, acc, n) -> int:
    """... of `_apply_gather_2` over n parent rows."""
    ch = min(gather_rows(B2, Kc, ncols, u, acc), n)
    return ch * gather_rows_bytes(B2, Kc, ncols, u, acc) + 9 * B2 * ncols


def _schur_chunk(b, K, W, acc, B2=0, Kc=0, u=0) -> int:
    """... of a chunked `_schur_update_cast` or `_rows_product`."""
    ch = schur_rows(b, K, W, B2, Kc, u, acc)
    per = b * K * acc + (gather_rows_bytes(B2, Kc, K, u, acc) if B2 else 0)
    return ch * per + 9 * B2 * K


def solve_batch(rows: int, W: int, size: int, k: int = 1) -> int:
    """Blocks per chunk of a solve's promoted triangular solve or boundary
    product: the promoted [rows, W] block and, for a block of k > 1
    right-hand sides, the chunk's k - 1 further columns of operand and
    result."""
    return _rows(rows * (W + 2 * (k - 1)) * size, 1 << 62)


# ---------------------------------------------------------------------------
# The estimate


def _factor_temps(b: int, F: int, W: int, fi: int, dtype,
                  route_b: Optional[int] = None) -> int:
    """Bytes `frontal._factor_slab` allocates beyond its output (the route
    decided on `route_b`, default b)."""
    if hk.slab_kernel_eligible(b if route_b is None else route_b, W, dtype):
        # factor_slab: per panel the updated panel [b, F - c0, w], the
        # boundary product [b, F - c0 - w, w], the diagonal block, the
        # kernel's L and inv(L)
        bs = hk.BS
        return 2 * b * F * min(W, bs) * fi + 3 * b * bs * bs * fi
    if F == W:
        return b * W * W * fi
    # cholesky output + its working copy, TRSM output + its copy
    return 2 * b * W * W * fi + 2 * b * (F - W) * W * fi


@dataclasses.dataclass
class _Piece:
    rows: int
    nbytes: int                 # device bytes (0 for host or view pieces)
    host: bool
    sharded: bool = False       # held across slots: read by a gather


@dataclasses.dataclass
class _State:
    """What is resident when a level starts: stored factors, eager slabs
    not yet consumed, the children's update pieces, cached index maps."""
    stored_dev: int
    pieces: List[_Piece]
    u_form: str                 # "none" | "xxt" | "arr"
    u_size: int                 # itemsize of the update (or X)
    u_cols: int                 # its columns: Kc (arr) or Wc (xxt)


def _idx_bytes(F, W, lvl: int, family: int = 1) -> int:
    """Child maps cached on the plan (int64 inv_child / fwd_child) by the
    time level lvl runs: those of levels lvl + 1 .. leaves, and for a
    family of K > 1 systems their K-fold copies too."""
    one = sum(8 * (1 << c) * (F[c - 1] + F[c] - W[c])
              for c in range(lvl + 1, len(F)))
    return one * (1 + family) if family > 1 else one


def _level_peak(F, W, lvl: int, lp: LevelPlan, st: _State, dtype,
                lazy: bool, eager_bytes: int, family: int = 1,
                nb: Optional[List[int]] = None, bare: bool = False):
    """(peak bytes, emitted pieces) of level lvl under option lp, by the
    phases of `frontal._factor_level` and the chunk loop of
    `frontal_factor_streamed`. `eager_bytes`: eagerly assembled slabs not
    consumed yet (this level's included). `family`: systems folded into
    the batch axis (B = family 2^lvl). `nb`: per level the blocks one slot
    of a mesh runs (the kernel route still reads family 2^lvl / chunks).
    `bare`: the level's own bytes only (no stored factors, index maps or
    slack; its slab counted as lazily assembled)."""
    L = len(F)
    B = family << lvl if nb is None else nb[lvl]
    Fl, Wl = F[lvl], W[lvl]
    K = Fl - Wl
    fi = _SIZE[dtype]
    uo = _SIZE[lp.update_dtype]
    so = _SIZE[lp.store_dtype]
    nc = lp.chunks
    b = B // nc
    keep = not lp.offload and lp.store_dtype == dtype
    leaf = lvl == L - 1
    x_view = leaf and keep and lp.update_dtype == dtype
    P = b * Fl * Wl * fi                    # a chunk's slab, its factor
    fac = P
    ft = _factor_temps(b, Fl, Wl, fi, dtype, (family << lvl) // nc)
    # the stored copy made on the device (a cast, or a chunk copied out)
    store_tmp = 0
    if (not keep and lp.store_dtype != dtype) or (nc > 1 and lp.offload):
        store_tmp = b * Fl * Wl * so
    P_work = P if (lazy or bare) else 0     # eager slabs sit in eager_bytes
    base = 0 if bare else (st.stored_dev + eager_bytes
                           + _idx_bytes(F, W, lvl, family) + SLACK_BYTES)
    if nc > 1 and not lp.offload:
        base += B * Fl * Wl * so            # the level's stored buffer

    if leaf:
        out_piece = 0 if (x_view or K == 0) else b * K * Wl * uo
    else:
        out_piece = b * K * K * uo if (lvl > 0 and K > 0) else 0
    out_dev = 0 if lp.spill else out_piece
    U2 = out_piece if not leaf else 0
    narrow = uo != fi                       # update stored below acc
    u2_chunk = _schur_chunk(b, K, Wl, fi) if (narrow and U2) else 0
    end = fac + store_tmp + out_piece

    # the chunk's phases: bytes while the children's update is alive, and
    # after it was freed
    if st.u_form == "none":
        phases_alive, phases_dead = [P_work + fac + ft], [end]
    else:
        ui, cu = st.u_size, st.u_cols
        Kc, Wc = F[lvl + 1] - W[lvl + 1], W[lvl + 1]
        B2 = 2 * b
        xxt_in = st.u_form == "xxt"
        # X X^T materialized from the leaves' X (square path; gather tier)
        Umat = B2 * Kc * Kc * ui if xxt_in else 0
        rp = ((B2 * Kc * Wc * fi + _schur_chunk(B2, Kc, Wc, fi))
              if (xxt_in and ui != fi) else 0)
        if not lp.two_piece:
            Sq = b * (Fl + 1) * Fl * fi
            ext = _fused_chunk(B2, Kc, Fl, ui, fi) if Kc else 0
            alive = [P_work + Sq]
            dead = [Sq + fac + ft, Sq + fac + U2 + u2_chunk, end]
            if xxt_in:
                alive.append(Sq + Umat + rp)
                dead.append(Sq + Umat + ext)
            else:
                alive.append(Sq + ext)
            phases_alive, phases_dead = alive, dead
        elif xxt_in and lp.xxt_tier:
            Gr = b * Fl * 2 * Wc * ui
            Gacc = b * Fl * 2 * Wc * fi if ui != fi else 0
            ET = b * K * K * uo if K else 0
            et_chunk = _schur_chunk(b, K, 2 * Wc, fi) if (narrow and K) \
                else 0
            idx = 33 * 2 * b * Fl           # the fold's index vectors
            phases_alive = [P_work + Gr + Gacc + idx,
                            P_work + (Gacc or Gr) + P + ET + et_chunk + idx]
            phases_dead = [P_work + ET + fac + ft, ET + fac + u2_chunk, end]
        else:
            slab_ext = _gather_chunk(B2, Kc, Wl, ui, fi, Fl) if Kc else 0
            g2 = _schur_chunk(b, K, Wl, fi, B2, Kc, ui) if (K and Kc) else 0
            work = [P_work + Umat + slab_ext, P_work + Umat + fac + ft]
            if U2:
                work.append(Umat + fac + U2 + g2)
            if xxt_in:
                phases_alive = [P_work + Umat + rp]
                phases_dead = work + [end]
            elif U2:
                phases_alive, phases_dead = work, [end]
            else:                       # no trailing block: U dies early
                phases_alive, phases_dead = work[:1], work[1:] + [end]

    live = [p.nbytes for p in st.pieces]
    starts = np.cumsum([0] + [p.rows for p in st.pieces]).tolist()
    row_bytes = 0
    if st.u_form != "none":
        row_bytes = (F[lvl + 1] - W[lvl + 1]) * st.u_cols * st.u_size
    peak = 0
    for c in range(nc):
        r0, r1 = 2 * c * b, 2 * (c + 1) * b
        touched = [i for i, p in enumerate(st.pieces)
                   if starts[i] < r1 and starts[i + 1] > r0]
        span = 0
        if st.u_form != "none" and not (
                len(touched) == 1 and not st.pieces[touched[0]].host
                and not st.pieces[touched[0]].sharded):
            span = (r1 - r0) * row_bytes    # a copy (or an upload)
        consumed = [i for i in touched if starts[i + 1] <= r1]
        u_before = sum(live)
        u_after = u_before - sum(live[i] for i in consumed)
        # a copied span replaces the consumed pieces right away
        u_alive = (u_after + span) if span else u_before
        fixed = base + c * out_dev
        peak = max(peak, fixed + u_before + span,
                   *(fixed + u_alive + x for x in phases_alive),
                   *(fixed + u_after + x for x in phases_dead))
        for i in consumed:
            live[i] = 0
    emitted = [_Piece(b, 0 if (lp.spill or x_view) else out_piece,
                      lp.spill) for _ in range(nc)]
    return peak, emitted


# ---------------------------------------------------------------------------
# The search


def _rungs(dtype) -> List[Dict]:
    low = torch.bfloat16 if dtype == torch.float32 else dtype
    rungs = [dict(lazy=False, store_dtype=dtype, offload=False, spill=False),
             dict(lazy=True, store_dtype=dtype, offload=False, spill=False)]
    if low != dtype:
        rungs.append(dict(lazy=True, store_dtype=low, offload=False,
                          spill=False))
    rungs += [dict(lazy=True, store_dtype=low, offload=True, spill=False),
              dict(lazy=True, store_dtype=low, offload=True, spill=True)]
    return rungs


def _update_dtypes(F, W, lvl: int, dtype, force: dict) -> list:
    """The update dtypes a level may emit, preferred first."""
    udts = [dtype]
    if dtype == torch.float32 and lvl > 0 and F[lvl] > W[lvl]:
        udts.append(torch.bfloat16)
    if force.get("update_dtype") is not None and lvl > 0:
        udts = [force["update_dtype"]]
    return udts


def _options(F, W, lvl: int, st: _State, dtype, force: dict,
             two_forced, family: int = 1, B: Optional[int] = None
             ) -> List[LevelPlan]:
    """The level's options in order of preference (see the module note);
    `B` the blocks the level runs (default family 2^lvl)."""
    L = len(F)
    B = family << lvl if B is None else B
    udts = _update_dtypes(F, W, lvl, dtype, force)
    forced_nc = (force.get("chunks") or {}).get(lvl)
    ncs = [forced_nc] if forced_nc else [
        1 << k for k in range(0, 64) if (1 << k) <= min(B, MAX_CHUNKS)]
    if lvl == 0:
        ncs = [1]
    common = dict(store_dtype=force["store_dtype"],
                  offload=force["offload"] and lvl > 0,
                  spill=force["spill"])
    out = []
    for udt in udts:
        if st.u_form == "none" or lvl == L - 1:
            paths = [(False, False)]
        else:
            tiers = [True, False] if st.u_form == "xxt" else [False]
            paths = ([] if two_forced is True else [(False, False)])
            if two_forced is not False:
                paths += [(True, t) for t in tiers]
        for nc in ncs:
            for two, tier in paths:
                if (not two and nc > 1 and not forced_nc
                        and st.u_form != "none"):
                    continue            # the square path runs unchunked
                out.append(LevelPlan(two, tier, udt, nc,
                                     spill=common["spill"] and nc > 1,
                                     store_dtype=common["store_dtype"],
                                     offload=common["offload"]))
    return out


def _two_forced(force, lvl):
    tp = force.get("two_piece")
    if tp is None or isinstance(tp, bool):
        return tp
    return lvl in tp


def _rows_peak(F, W, lvl: int, G: int, lp: LevelPlan, st: _State, dtype,
               eager_bytes: int, bare: bool = False):
    """(peak bytes, emitted pieces) of one slot of a row-group level
    (`dist_level.factor_level_sharded`, G slots per front), by its phases:
    the front's two child updates gathered (X X^T formed from a leaf's X),
    promoted and padded by a zero row and column, its index maps and the
    extend-added slab rows [F / G, W]; the group's slab rows gathered
    [F, W] and the pivot Cholesky with its working copy beside the TRSM of
    its rows; the group's factor rows gathered, the trailing rows T and
    U2 [K / G, K] and U2's cast."""
    Fl, Wl = F[lvl], W[lvl]
    K = Fl - Wl
    fi = _SIZE[dtype]
    Kc = F[lvl + 1] - W[lvl + 1]
    ui, cols = st.u_size, st.u_cols
    rows = Fl // G
    P = rows * Wl * fi
    src = 2 * Kc * cols * ui
    up = 2 * (Kc + 1) * (Kc + 1) * fi
    promote = 2 * Kc * cols * fi if ui != fi else 0
    xxt = 2 * Kc * Kc * fi if st.u_form == "xxt" else 0
    idx = 16 * Fl + 9 * rows * Wl
    ext = src + promote + xxt + up + idx + 3 * P
    fac = Fl * Wl * fi + 2 * Wl * Wl * fi + 3 * P
    u2 = (K // G) * K
    tail = (Fl * Wl * fi + 2 * u2 * fi + 9 * u2 + u2 * _SIZE[lp.update_dtype]
            if K else 0)
    out = P * _SIZE[lp.store_dtype] + u2 * _SIZE[lp.update_dtype]
    live = sum(p.nbytes for p in st.pieces)
    base = 0 if bare else (st.stored_dev + eager_bytes
                           + _idx_bytes(F, W, lvl) + SLACK_BYTES)
    peak = base + live + up + max(ext, P + fac, P + tail) + out
    nbytes = 0 if lp.spill else u2 * _SIZE[lp.update_dtype]
    return peak, [_Piece(1 << lvl, nbytes, lp.spill, sharded=True)]


def _mesh_layout(F, W, mesh, family: int = 1):
    """Per level under `mesh`: the blocks one slot runs, the row-group
    count G of a row-group level (0 for the others), and whether the level
    is slot-sharded."""
    shapes = types.SimpleNamespace(F=F, W=W)
    nb, groups, slot = [], [], []
    for lvl in range(len(F)):
        B = family << lvl
        if family > 1:
            place = mesh_mod.family_sharding(mesh, family)
        else:
            place = mesh_mod.panel_sharding(mesh, lvl)
        rows = (place.kind == "rows" and lvl < len(F) - 1
                and dist_level.eligible(shapes, lvl, B, mesh))
        nb.append(B // mesh.size if place.kind == "slot" else
                  (1 if rows else B))
        groups.append(mesh.size // B if rows else 0)
        slot.append(place.kind == "slot")
    return nb, groups, slot


def _plan_levels(F, W, dtype, budget: int, rung: dict, force: dict,
                 family: int = 1, mesh=None):
    """Per-level plans on one rung, or (level, smallest bytes) when a level
    fits no option. Under `mesh`, one slot's plan."""
    L = len(F)
    fi = _SIZE[dtype]
    if mesh is None:
        nb, groups, slot = [family << l for l in range(L)], [0] * L, [False] * L
    else:
        nb, groups, slot = _mesh_layout(F, W, mesh, family)
    slab = [nb[l] * F[l] * W[l] // (groups[l] or 1) for l in range(L)]
    st = _State(0, [], "none", fi, 0)
    force = dict(force, **rung)
    lazy = rung["lazy"]
    plans: List[Optional[LevelPlan]] = [None] * L

    def eager(lvl):
        return 0 if lazy else sum(slab[:lvl + 1]) * fi

    def peak_of(lvl, lp, state):
        if groups[lvl]:
            return _rows_peak(F, W, lvl, groups[lvl], lp, state, dtype,
                              eager(lvl))
        peak, emitted = _level_peak(F, W, lvl, lp, state, dtype, lazy,
                                    eager(lvl), family,
                                    None if mesh is None else nb)
        if lvl > 0 and slot[lvl] and not slot[lvl - 1]:
            # the parent gathers the slots' pieces
            for p in emitted:
                p.sharded = True
        return peak, emitted

    def options(lvl, state):
        if groups[lvl]:
            # a row-group level: the square path in one piece
            return [LevelPlan(False, False, udt, 1,
                              store_dtype=force["store_dtype"],
                              offload=force["offload"], spill=False)
                    for udt in _update_dtypes(F, W, lvl, dtype, force)]
        return _options(F, W, lvl, state, dtype, force,
                        _two_forced(force, lvl), family, nb[lvl])

    def advance(lvl, lp, emitted):
        so = _SIZE[lp.store_dtype]
        stored = st.stored_dev + (0 if lp.offload else slab[lvl] * so)
        if lvl == L - 1 and F[lvl] > W[lvl]:
            form, cols = "xxt", W[lvl]
        else:
            form, cols = "arr", F[lvl] - W[lvl]
        return _State(stored, emitted, form, _SIZE[lp.update_dtype], cols)

    for lvl in range(L - 1, -1, -1):
        best = None                     # (bytes, level) of the nearest miss
        for lp in options(lvl, st):
            peak, emitted = peak_of(lvl, lp, st)
            if peak > budget:
                best = min(best or (peak, lvl), (peak, lvl))
                continue
            nxt = advance(lvl, lp, emitted)
            if lvl > 0:
                # the parent needs one option that fits: stop at the first
                parent = None
                for q in options(lvl - 1, nxt):
                    need = peak_of(lvl - 1, q, nxt)[0]
                    if need <= budget:
                        break
                    parent = need if parent is None else min(parent, need)
                else:
                    best = min(best or (parent, lvl - 1), (parent, lvl - 1))
                    continue
            lp.peak_bytes = peak
            if st.u_form != "none":
                sq = dataclasses.replace(lp, two_piece=False, xxt_tier=False,
                                         chunks=1, spill=False)
                lp.square_bytes = peak_of(lvl, sq, st)[0]
            plans[lvl] = lp
            st = nxt
            break
        else:
            return best[1], best[0]
    return plans


def stored_bytes(F, W, levels: List[LevelPlan], family: int = 1,
                 mesh=None) -> int:
    """Bytes of the stored factor (one slot's under `mesh`)."""
    if mesh is None:
        nb, groups = [family << l for l in range(len(F))], [0] * len(F)
    else:
        nb, groups, _ = _mesh_layout(F, W, mesh, family)
    return sum(nb[l] * F[l] * W[l] // (groups[l] or 1)
               * _SIZE[lp.store_dtype] for l, lp in enumerate(levels))


def slot_bytes(fp, lvl: int, mesh=None, dtype=torch.float32,
               update_dtype=None, store_dtype=None, family: int = 1) -> int:
    """The bytes one slot of `mesh` (the device, without one) holds for
    level lvl alone: its slab, its share of the children's update, the
    level's temporaries, its factor and the update it emits (square path,
    one chunk, in `dtype` unless `update_dtype` / `store_dtype` say
    otherwise); no stored factors of other levels, index maps or slack.
    The counterpart of the JAX package's `tools/memcheck_mesh.py`
    (`analyze`: one level program's per-device bytes)."""
    F, W = tuple(int(f) for f in fp.F), tuple(int(w) for w in fp.W)
    L = len(F)
    dtype = torch_dtype(dtype)
    if mesh is None:
        nb, groups, slot = [family << l for l in range(L)], [0] * L, [False] * L
    else:
        nb, groups, slot = _mesh_layout(F, W, mesh, family)
    lp = LevelPlan(False, False, update_dtype or dtype, 1,
                   store_dtype or dtype, False, False)
    if lvl == L - 1:
        st = _State(0, [], "none", _SIZE[dtype], 0)
    else:
        cl = lvl + 1
        Kc = F[cl] - W[cl]
        xxt = cl == L - 1 and Kc > 0
        cols = W[cl] if xxt else Kc
        usize = _SIZE[dtype if xxt else lp.update_dtype]
        nbytes = (nb[cl] * Kc * cols if not groups[cl]
                  else (Kc // groups[cl]) * Kc) * usize
        rows = nb[cl] if mesh is None or slot[cl] else 1 << cl
        st = _State(0, [_Piece(rows, nbytes, False,
                               sharded=mesh is not None and not slot[lvl])],
                    "xxt" if xxt else "arr", usize, cols)
    if groups[lvl]:
        return _rows_peak(F, W, lvl, groups[lvl], lp, st, dtype, 0,
                          bare=True)[0]
    return _level_peak(F, W, lvl, lp, st, dtype, True, 0, family,
                       None if mesh is None else nb, bare=True)[0]


def inv_bytes(F, W, dtype) -> int:
    """The explicit pivot inverses, [B, W, W] per level, in f32 (f64 for an
    f64 factor)."""
    size = 8 if dtype == torch.float64 else 4
    return sum((1 << l) * W[l] * W[l] * size for l in range(len(F)))


def solve_vector_bytes(W, dtype) -> int:
    """The ~24 work vectors over the padded basis that a refined solve
    holds per right-hand side."""
    n_pad = sum((1 << l) * W[l] for l in range(len(W)))
    return 24 * (n_pad + 1) * (8 if dtype == torch.float64 else 4)


def solve_bytes(F, W, dtype, ell_k: int = ELL_MAX_K,
                host_level: int = 0, k: int = 1,
                promote: bool = True) -> int:
    """Device bytes a refined solve of k right-hand sides holds beside the
    stored factor: the ELL planes and the double-float matvec's
    temporaries (~40 bytes per row, ELL slot and column; the [n, K, k]
    operands of the block residual are within it), the work vectors per
    column, one chunk of promoted factor (unless `promote` is False: a
    factor stored in the compute dtype on the device, as a family's is),
    and the largest host level moved to the device. For a family of k
    systems the ELL value planes are per system, which the per-column
    term covers."""
    n_pad = sum((1 << l) * W[l] for l in range(len(F)))
    return ((40 * (n_pad + 1) * ell_k + solve_vector_bytes(W, dtype)) * k
            + (3 * CHUNK_BYTES if promote else 0) + host_level
            + SLACK_BYTES)


def selinv_bytes(F, W, dtype, resident: int = 0,
                 promoted: Optional[List[bool]] = None) -> int:
    """Peak device bytes of a selected inversion (`numeric/selinv.py`),
    step by step as its code allocates: per level l (B = 2^l fronts,
    bnd = F - W boundary rows, compute size c: 8 for f64, else 4)

      * the level's factor promoted or moved to the device, where
        `promoted[l]` (stored bf16 or in host memory): B F W c;
      * inv(L) and the triangular solve's two working copies, then
        S = inv(L)^T inv(L), [B, W, W] each, beside the parent's P;
      * X = L_Ss inv(L) [B, bnd, W] (and a copy of the strip the product
        may make), still beside the parent's P;
      * the parent restriction: the gathered rows [B, bnd, F_{l-1}], their
        index vectors, and Pp [B, bnd, bnd];
      * PX = Pp X [B, bnd, W]; then, above the leaves, the new
        P [B, F, F] beside Phi_ss, PX and Pp;

    plus `resident` (the stored factor and whatever else stays on the
    device), the index maps the recursion reads (piv_rows, fwd_child), the
    [n + 1] diagonal and SLACK_BYTES. Both inv_diag and inv_entries stay
    within it (the terminal step of inv_entries assembles no P)."""
    c = 8 if torch_dtype(dtype) == torch.float64 else 4
    L = len(F)
    promoted = promoted or [False] * L
    n_pad = sum((1 << l) * W[l] for l in range(L))
    idx = 8 * sum((1 << l) * F[l] for l in range(L))
    peak = P_prev = 0
    for l in range(L):
        B, Fl, Wl = 1 << l, F[l], W[l]
        bnd = Fl - Wl
        copy = B * Fl * Wl * c if promoted[l] else 0
        sq = B * Wl * Wl * c
        P = B * Fl * Fl * c
        if l == 0:
            phases = [copy + 3 * sq, copy + 2 * sq]
        else:
            X = B * bnd * Wl * c
            R = B * bnd * F[l - 1] * c
            Pp = B * bnd * bnd * c
            itmp = 3 * 8 * B * bnd + 2 * B * bnd
            phases = [P_prev + copy + 3 * sq,
                      P_prev + copy + 2 * sq + 2 * X,
                      P_prev + sq + X + R + itmp + Pp,
                      sq + X + Pp + X]
            if l < L - 1:
                phases.append(sq + Pp + X + P)
        peak = max(peak, *phases)
        P_prev = P if l < L - 1 else 0
    return resident + idx + (n_pad + 1) * c + peak + SLACK_BYTES


def plan_qd(fp, dtype, budget: int) -> RegimePlan:
    """The regime plan of a quasi-definite (LDL^T) factorization,
    `ldlt.factor_qd`: in core and square, slabs assembled eagerly, updates
    and the stored factor in the compute dtype on the device, no chunks (the
    JAX package's qd path is in core too). Per level the estimate follows
    `ldlt._factor_level_qd`: beside the stored factors of the levels below,
    the slabs not consumed yet, the child maps, the signature and
    SLACK_BYTES, the largest of its phases, each on top of the square front
    [B, F + 1, F] (not at the leaves): the children's update and one chunk
    of its extend-add; the signed Cholesky's working copy of the pivot
    block, its trailing-update temporary and two panels; that copy beside
    the new factor; the factor and the boundary solve with its copy; the
    factor, the solve and the update it emits [B, K, K]. Raises BudgetError
    naming the first level (leaves to root) that does not fit, before
    anything is allocated."""
    F, W = tuple(int(f) for f in fp.F), tuple(int(w) for w in fp.W)
    dtype = torch_dtype(dtype)
    fi = _SIZE[dtype]
    L = len(F)
    slab = [(1 << l) * F[l] * W[l] * fi for l in range(L)]
    n_pad = sum((1 << l) * W[l] for l in range(L))
    sig = 3 * (n_pad + 1) * fi              # slabs, permuted, padded
    stored, levels = 0, [None] * L
    for lvl in range(L - 1, -1, -1):
        B, Fl, Wl = 1 << lvl, F[lvl], W[lvl]
        K = Fl - Wl
        leaf = lvl == L - 1
        sq = 0 if leaf else B * (Fl + 1) * Fl * fi
        Kc = 0 if leaf else F[lvl + 1] - W[lvl + 1]
        U = 2 * B * Kc * Kc * fi
        ext = _fused_chunk(2 * B, Kc, Fl, fi, fi) if Kc else 0
        ww = B * Wl * Wl * fi
        chol = 2 * ww + 2 * B * Wl * min(64, Wl) * fi
        X = B * K * Wl * fi
        U2 = B * K * K * fi if lvl > 0 else 0
        fac = slab[lvl]
        work = max(U + ext, chol, ww + fac, fac + 2 * X, fac + X + U2)
        peak = (stored + sum(slab[:lvl + 1]) + _idx_bytes(F, W, lvl) + sig
                + SLACK_BYTES + sq + work)
        if peak > budget:
            raise BudgetError(
                f"the quasi-definite (LDL^T) factorization runs in core and "
                f"square only: level {lvl} (B = {B}, F = {Fl}, W = {Wl}) "
                f"needs {peak} bytes, over the budget of {int(budget)} "
                f"bytes")
        levels[lvl] = LevelPlan(False, False, dtype, 1, dtype, False, False,
                                peak_bytes=peak, square_bytes=peak)
        stored += fac
    return RegimePlan(dtype, int(budget), False, False, levels)


def plan_regimes(fp, dtype, budget: int, *, two_piece=None,
                 update_dtype=None, chunks: Optional[dict] = None,
                 store_dtype=None, offload: Optional[bool] = None,
                 spill: Optional[bool] = None, lazy: Optional[bool] = None,
                 reupload: Optional[bool] = None,
                 family: int = 1, mesh=None) -> RegimePlan:
    """The regime plan of a factorization (see the module note). `fp` needs
    only F and W (per-level front and pivot widths). Forcing: two_piece
    (bool, or the set of levels that take it), update_dtype, chunks
    ({lvl: nc}; under a mesh, chunks of one slot's blocks), store_dtype,
    offload, spill, lazy, reupload. `family`: K same-pattern systems
    factored at once, folded into the batch axis (level lvl holds K 2^lvl
    fronts). `mesh`: the plan of one slot of that mesh against `budget`,
    one slot's budget; slabs are then never assembled lazily."""
    F, W = tuple(int(f) for f in fp.F), tuple(int(w) for w in fp.W)
    dtype = torch_dtype(dtype)
    force = {"two_piece": two_piece, "chunks": chunks,
             "update_dtype": update_dtype}
    rungs = []
    for r in _rungs(dtype):
        r = dict(r)
        for k, v in (("lazy", lazy), ("store_dtype", store_dtype),
                     ("offload", offload), ("spill", spill)):
            if v is not None:
                r[k] = v
        if mesh is not None:
            r["lazy"] = False
        if r not in rungs:
            rungs.append(r)
    fail = None
    for rung in rungs:
        res = _plan_levels(F, W, dtype, int(budget), rung, force, family,
                           mesh)
        if isinstance(res, list):
            levels = res
            break
        fail = res
    else:
        lvl, need = fail
        raise BudgetError(
            f"no regime fits the budget of {int(budget)} bytes: level {lvl} "
            f"(B = {family << lvl}, F = {F[lvl]}, W = {W[lvl]}) needs at "
            f"least {need} bytes")
    offloaded = any(lp.offload for lp in levels)
    if reupload is None:
        reupload = (stored_bytes(F, W, levels, family, mesh)
                    + solve_bytes(F, W, dtype) <= int(budget))
    return RegimePlan(dtype, int(budget), rung["lazy"],
                      bool(reupload and offloaded), levels, family, mesh)

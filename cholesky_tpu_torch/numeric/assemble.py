"""Device-side front assembly — the port of `FrontAssembler`
(`cholesky_tpu/numeric/frontal.py:300-356`), `LazyFronts` (`:452-491`) and
`_assemble_level_chunk` (`:410-449`).

The scatter indices are pattern-only: they are built once on the host
(`frontal_plan._front_scatter_indices`) and moved to the device at
construction, into the pool of long-lived state (`devmem`). Each call then uploads only the [nnz] value vector and fills
each level's [B, F, W] slab with one scatter: ones on the padded pivot
diagonal first, then the values. Every index appears once, so the scatters
do not accumulate. The indices are int64, so no slab size needs the JAX
package's (slot, remainder) int32 split.

`FrontAssembler.lazy(vals)` keeps the uploaded values and assembles one level,
or blocks [c0, c1) of one level, on the device right before the level runs:
then only the current level's (or chunk's) slab is ever resident.

Values [K, nnz] (a same-pattern family, `api.factorize_many`) assemble into
folded slabs [K B, F, W], system-major: the same [nnz] scatter indices
address each system's row of a [K, B F W] slab, so no K-fold index exists.

Under a mesh, `MeshAssembler` keeps one `FrontAssembler` per distinct
device of the mesh and assembles each slot's part on the slot's own
device, from the values uploaded once per device: a slot-sharded level's
blocks (`chunk`), a row group's rows of its front, a replicated level on
the first slot, a family's systems of the slot. The JAX package assembles
on the host under a mesh (`api.py:641-648` there) because GSPMD places a
host array; a single-process torch mesh addresses each device directly.

The panel assembly of the oracle engine (`numeric/factor.py`,
`verify/oracle.py`) is host NumPy, copied from
`cholesky_tpu/numeric/assemble.py:21-168`: `empty_panels`,
`assemble_panels` (on the native core when it builds, by `ext.use_native`),
`assemble_panels_numpy`, `assemble_rhs`, `extract_solution`,
`extract_factor_dense`. They give arrays identical to the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cholesky_tpu_torch.native import ext
from cholesky_tpu_torch.numeric import devmem
from cholesky_tpu_torch.numeric.frontal_plan import (FrontalPlan,
                                                     _front_scatter_indices)
from cholesky_tpu_torch.parallel import mesh as mesh_mod
from cholesky_tpu_torch.symbolic.plan import SolvePlan

TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


class FrontAssembler:
    def __init__(self, fp: FrontalPlan, rows: np.ndarray, cols: np.ndarray,
                 device: torch.device):
        self.device = torch.device(device)
        self.shapes = tuple((1 << lvl, fp.F[lvl], fp.W[lvl])
                            for lvl in range(fp.levels))
        with devmem.persistent(self.device):
            self.idx = [tuple(torch.from_numpy(a).to(self.device)
                              for a in lvl)
                        for lvl in _front_scatter_indices(fp, rows, cols)]
        self._chunk_idx = {}

    def upload(self, vals, dtype) -> torch.Tensor:
        """The [nnz] (or a family's [K, nnz]) values on the device in
        `dtype` (cast on the host first when that halves the upload)."""
        dtype = np.dtype(dtype)
        vals = np.asarray(vals)
        if vals.ndim not in (1, 2):
            raise ValueError(f"expected [nnz] or [K, nnz] values, got "
                             f"{vals.shape}")
        if vals.dtype.itemsize > dtype.itemsize:
            vals = vals.astype(dtype)
        return torch.from_numpy(np.ascontiguousarray(vals)).to(self.device)

    def _scatter(self, v: torch.Tensor, shape, idx) -> torch.Tensor:
        B, Fl, Wl = shape
        sel, flat, ones = idx
        v = v.view(-1, v.shape[-1])                     # [K, nnz]
        K = v.shape[0]
        slab = torch.zeros((K, B * Fl * Wl), dtype=v.dtype,
                           device=self.device)
        slab[:, ones] = 1
        slab[:, flat] = v[:, sel]
        return slab.view(K * B, Fl, Wl)

    def level(self, v: torch.Tensor, lvl: int) -> torch.Tensor:
        """Level lvl's slab [B, F, W] from device values `v` [nnz] (or
        [K B, F, W] from a family's [K, nnz])."""
        return self._scatter(v, self.shapes[lvl], self.idx[lvl])

    def chunk(self, v: torch.Tensor, lvl: int, c0: int, c1: int
              ) -> torch.Tensor:
        """Blocks [c0, c1) of level lvl's slab, [c1 - c0, F, W], from device
        values `v`: the level's indices restricted to those blocks and
        shifted to chunk-local positions (memoized per chunk)."""
        _, Fl, Wl = self.shapes[lvl]
        if v.dim() != 1:
            raise ValueError("chunked assembly takes one system's values")
        key = (lvl, c0, c1)
        idx = self._chunk_idx.get(key)
        if idx is None:
            lo, hi = c0 * Fl * Wl, c1 * Fl * Wl
            sel, flat, ones = self.idx[lvl]
            with devmem.persistent(self.device):
                m = (flat >= lo) & (flat < hi)
                mo = (ones >= lo) & (ones < hi)
                idx = self._chunk_idx[key] = (sel[m], flat[m] - lo,
                                              ones[mo] - lo)
        return self._scatter(v, (c1 - c0, Fl, Wl), idx)

    def __call__(self, vals, dtype=np.float32) -> List[torch.Tensor]:
        """vals [nnz] -> per-level slabs [B, F, W] on the device (a family's
        [K, nnz] -> [K B, F, W])."""
        v = self.upload(vals, dtype).to(TORCH_DTYPES[np.dtype(dtype)])
        return [self.level(v, lvl) for lvl in range(len(self.shapes))]

    def lazy(self, vals, dtype=np.float32) -> "LazyFronts":
        return LazyFronts(self, vals, dtype)


class LazyFronts:
    """Sequence view over an unassembled front set: each level's slab (or
    a chunk of it) is scattered on the device when it is asked for and not
    kept, so a factorization over it holds only the current level's slab —
    never the whole front set. The values cross to the device once."""

    def __init__(self, asm: FrontAssembler, vals, dtype=np.float32):
        self.asm = asm
        self.dtype = np.dtype(dtype)
        self.device = asm.device
        self.shapes = asm.shapes
        self.vals = asm.upload(vals, self.dtype).to(TORCH_DTYPES[self.dtype])

    def __len__(self) -> int:
        return len(self.shapes)

    def __getitem__(self, lvl: int) -> torch.Tensor:
        return self.asm.level(self.vals, lvl)

    def chunk(self, lvl: int, c0: int, c1: int) -> torch.Tensor:
        """Assemble only blocks [c0, c1) of a level (batch-chunked levels)."""
        return self.asm.chunk(self.vals, lvl, c0, c1)

    def nbytes_of(self, lvl: int) -> int:
        return int(np.prod(self.shapes[lvl])) * self.dtype.itemsize


class MeshAssembler:
    """Front assembly on a mesh's devices: one `FrontAssembler` per
    distinct device, each slot's part of each level scattered on the
    slot's device."""

    def __init__(self, fp: FrontalPlan, rows: np.ndarray, cols: np.ndarray,
                 mesh):
        self.mesh = mesh
        self.by_device = {d: FrontAssembler(fp, rows, cols, d)
                          for d in mesh.distinct}
        self.shapes = self.by_device[mesh.flat[0]].shapes

    def __call__(self, vals, dtype=np.float32, family: int = 0) -> list:
        """vals [nnz] -> per-level slabs placed as `mesh.panel_sharding`
        says (a `Sharded` of the slots' parts, or one tensor on the first
        slot); a family's [K, nnz] with `family` = K -> folded slabs
        placed as `mesh.family_sharding` says."""
        tdt = TORCH_DTYPES[np.dtype(dtype)]
        v = {d: asm.upload(vals, dtype).to(tdt)
             for d, asm in self.by_device.items()}
        devs = self.mesh.flat
        out = []
        for lvl, (B, Fl, Wl) in enumerate(self.shapes):
            place = (mesh_mod.family_sharding(self.mesh, family) if family
                     else mesh_mod.panel_sharding(self.mesh, lvl))
            if place.kind == "replicated":
                out.append(self.by_device[devs[0]].level(v[devs[0]], lvl))
                continue
            parts = []
            for s, d in enumerate(devs):
                asm = self.by_device[d]
                if family:
                    per = family // len(devs)
                    parts.append(asm.level(v[d][s * per:(s + 1) * per], lvl))
                    continue
                b0, b1 = place.batch_range(s, B)
                part = asm.chunk(v[d], lvl, b0, b1)
                if place.kind == "rows":
                    r0, r1 = place.row_range(s, Fl)
                    part = part[:, r0:r1].contiguous()
                parts.append(part)
            out.append(mesh_mod.Sharded(parts, place,
                                        ((family or 1) * B, Fl, Wl), devs))
        return out


# ---------------------------------------------------------------------------
# Panel assembly of the oracle engine: per level [2^L, H(L), S(L)] panels,
# each separator against its full ancestor path.


def empty_panels(plan: SolvePlan, dtype=np.float64) -> List[np.ndarray]:
    """Zeroed panel arrays, one [2^L, H(L), S(L)] per level, with the
    padded diagonal set to identity so the batched Cholesky stays
    well-posed."""
    panels = [np.zeros(plan.panel_shape(lvl), dtype=dtype)
              for lvl in range(plan.levels)]
    _pad_identity(plan, panels)
    return panels


def _pad_identity(plan: SolvePlan, panels: List[np.ndarray]) -> None:
    t = plan.tree
    for lvl in range(plan.levels):
        W = int(plan.S[lvl])
        for slot in range(1 << lvl):
            sz = int(plan.sep_sizes[t.sep_at(lvl, slot)])
            if sz < W:
                idx = np.arange(sz, W)
                panels[lvl][slot, idx, idx] = 1.0


def assemble_panels(plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray, dtype=np.float64,
                    check_structure: bool = False,
                    native: Optional[bool] = None) -> List[np.ndarray]:
    """Panels from a COO lower triangle (original dof indexing).

    Entries are mirrored to (i, j) and (j, i) and routed to the block that
    exists for the pair: diagonal blocks keep the lower triangle only,
    ancestor blocks take the full entry. `native` follows `ext.use_native`
    (None: the native core when it builds). `check_structure` takes the
    NumPy path, which raises on an entry that couples non-ancestor
    separators; the native core does not check."""
    if check_structure or not ext.use_native(native):
        return assemble_panels_numpy(plan, rows, cols, vals, dtype=dtype,
                                     check_structure=check_structure)
    panels = empty_panels(plan, dtype=np.float64)
    ext.assemble_panels(rows, cols, vals, plan.sep_of_dof, plan.loc_of_dof,
                        plan.num_separators, plan.levels, plan.row_off,
                        panels)
    if np.dtype(dtype) != np.float64:
        panels = [p.astype(dtype) for p in panels]
    return panels


def assemble_panels_numpy(plan: SolvePlan, rows: np.ndarray,
                          cols: np.ndarray, vals: np.ndarray,
                          dtype=np.float64,
                          check_structure: bool = False) -> List[np.ndarray]:
    """The NumPy assembly (where the native core does not build, and the
    native path's parity reference)."""
    off = rows != cols
    r = np.concatenate([rows, cols[off]])
    c = np.concatenate([cols, rows[off]])
    v = np.concatenate([vals, vals[off]])

    nsep = plan.num_separators
    sr = plan.sep_of_dof[r]
    sc = plan.sep_of_dof[c]
    lr = plan.loc_of_dof[r]
    lc = plan.loc_of_dof[c]
    heap_r = nsep - sr + 1
    heap_c = nsep - sc + 1
    lvl_r = np.int64(np.log2(heap_r))
    lvl_c = np.int64(np.log2(heap_c))

    diag = (sr == sc) & (lr >= lc)
    anc = (lvl_r < lvl_c) & ((heap_c >> (lvl_c - lvl_r).clip(0)) == heap_r)

    if check_structure:
        bad = ~(diag | anc | ((sr == sc) & (lr < lc)) |
                ((lvl_c < lvl_r)
                 & ((heap_r >> (lvl_r - lvl_c).clip(0)) == heap_c)))
        if bad.any():
            k = int(np.argmax(bad))
            raise ValueError(
                f"matrix entry ({r[k]},{c[k]}) couples non-ancestor "
                f"separators {sr[k]} and {sc[k]}: invalid nested-dissection "
                "ordering")

    panels = empty_panels(plan, dtype=dtype)
    slot_c = heap_c - (np.int64(1) << lvl_c)
    prow = np.where(sr == sc, lr,
                    plan.row_off[lvl_c.clip(0, plan.levels - 1),
                                 lvl_r.clip(0, plan.levels - 1)] + lr)
    keep = diag | anc
    for lvl in range(plan.levels):
        m = keep & (lvl_c == lvl)
        panels[lvl][slot_c[m], prow[m], lc[m]] = v[m].astype(dtype)
    return panels


def assemble_rhs(plan: SolvePlan, b: np.ndarray,
                 dtype=np.float64) -> List[np.ndarray]:
    """The right-hand side permuted into per-level [2^L, S(L)] slabs."""
    b = np.asarray(b).reshape(-1)
    t = plan.tree
    out = []
    for lvl in range(plan.levels):
        arr = np.zeros((1 << lvl, int(plan.S[lvl])), dtype=dtype)
        for slot in range(1 << lvl):
            s = t.sep_at(lvl, slot)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            arr[slot, :sz] = b[plan.perm[off:off + sz]]
        out.append(arr)
    return out


def extract_solution(plan: SolvePlan, xlv: List[np.ndarray]) -> np.ndarray:
    """The per-level solution slabs un-permuted to original dof order."""
    t = plan.tree
    x = np.zeros(plan.n, dtype=np.asarray(xlv[0]).dtype)
    for lvl in range(plan.levels):
        arr = np.asarray(xlv[lvl])
        for slot in range(1 << lvl):
            s = t.sep_at(lvl, slot)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            x[plan.perm[off:off + sz]] = arr[slot, :sz]
    return x


def extract_factor_dense(plan: SolvePlan,
                         panels: List[np.ndarray]) -> np.ndarray:
    """The factor L as a dense [n, n] f64 lower-triangular array in
    permuted coordinates."""
    t = plan.tree
    L = np.zeros((plan.n, plan.n))
    for lvl in range(plan.levels):
        arr = np.asarray(panels[lvl])
        for slot in range(1 << lvl):
            s = t.sep_at(lvl, slot)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            L[off:off + sz, off:off + sz] = np.tril(arr[slot, :sz, :sz])
            for a in t.ancestors(s):
                ro = int(plan.row_off[lvl, t.level_of(a)])
                ao = int(plan.sep_offset[a])
                asz = int(plan.sep_sizes[a])
                L[ao:ao + asz, off:off + sz] = arr[slot, ro:ro + asz, :sz]
    return L

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
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from cholesky_tpu_torch.numeric import devmem
from cholesky_tpu_torch.numeric.frontal_plan import (FrontalPlan,
                                                     _front_scatter_indices)
from cholesky_tpu_torch.parallel import mesh as mesh_mod

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

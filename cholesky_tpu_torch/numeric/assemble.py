"""Device-side front assembly — the port of `FrontAssembler`
(`cholesky_tpu/numeric/frontal.py:300-356`).

The scatter indices are pattern-only: they are built once on the host
(`frontal_plan._front_scatter_indices`) and moved to the device at
construction. Each call then uploads only the [nnz] value vector and fills
each level's [B, F, W] slab with one scatter: ones on the padded pivot
diagonal first, then the values. Every index appears once, so the scatters
do not accumulate.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from cholesky_tpu_torch.numeric.frontal_plan import (FrontalPlan,
                                                     _front_scatter_indices)

TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


class FrontAssembler:
    def __init__(self, fp: FrontalPlan, rows: np.ndarray, cols: np.ndarray,
                 device: torch.device):
        self.device = torch.device(device)
        self.shapes = tuple((1 << lvl, fp.F[lvl], fp.W[lvl])
                            for lvl in range(fp.levels))
        self.idx = [tuple(torch.from_numpy(a).to(self.device) for a in lvl)
                    for lvl in _front_scatter_indices(fp, rows, cols)]

    def __call__(self, vals, dtype=np.float32) -> List[torch.Tensor]:
        """vals [nnz] -> per-level slabs [B, F, W] on the device."""
        dtype = np.dtype(dtype)
        vals = np.asarray(vals)
        if vals.ndim != 1:
            raise ValueError(f"expected [nnz] values, got {vals.shape}")
        if vals.dtype.itemsize > dtype.itemsize:
            vals = vals.astype(dtype)       # halve the upload
        tdt = TORCH_DTYPES[dtype]
        v = torch.from_numpy(np.ascontiguousarray(vals)).to(self.device)
        one = torch.ones((), dtype=tdt, device=self.device)
        out = []
        for (B, Fl, Wl), (sel, flat, ones) in zip(self.shapes, self.idx):
            slab = torch.zeros(B * Fl * Wl, dtype=tdt, device=self.device)
            slab.index_put_((ones,), one, accumulate=False)
            slab.index_put_((flat,), v[sel].to(tdt), accumulate=False)
            out.append(slab.view(B, Fl, Wl))
        return out

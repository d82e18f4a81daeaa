"""PanelsOracle: the verification engine, the port of
`cholesky_tpu/verify/oracle.py`.

Not a production path: the dense ancestor-path panel engine
(`numeric/factor.py` + the panel assembly of `numeric/assemble.py`)
wrapped as a small, explicitly named cross-check. It runs one batched
POTRF / TRSM / SYRK triple per tree level over full ancestor-path panels
and sums sibling updates by segment, where the production engine
(`SparseCholesky`) factors exact-boundary fronts and extend-adds them, so
its factor checks the production factor by a different algorithm.

Each separator is stored against its FULL ancestor path (O(path) memory
and FLOPs: 6.49 GiB of f64 panels at 50^3 L8). One dtype, one device, and
only factorize / solve / factor_dense, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cholesky_tpu_torch.api import _resolve_device
from cholesky_tpu_torch.numeric import assemble
from cholesky_tpu_torch.numeric import factor as nfactor
from cholesky_tpu_torch.numeric.assemble import TORCH_DTYPES
from cholesky_tpu_torch.symbolic.plan import SolvePlan


class PanelsOracle:
    """Reference-structured panel factorization that cross-checks the
    production frontal engine (see tests/test_torch_oracle.py)."""

    def __init__(self, plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, dtype=np.float64, device="cuda"):
        """`device`: "cpu" or "cuda[:i]"; "cuda" raises without a card."""
        self.plan = plan
        self.rows, self.cols, self.vals = rows, cols, vals
        self.dtype = np.dtype(dtype)
        if self.dtype not in TORCH_DTYPES:
            raise ValueError(f"dtype {self.dtype}; the oracle takes float32 "
                             "or float64")
        self.device = _resolve_device(device)
        self.panels: Optional[List[torch.Tensor]] = None

    def factorize(self) -> List[torch.Tensor]:
        panels = assemble.assemble_panels(
            self.plan, self.rows, self.cols, self.vals, dtype=self.dtype)
        self.panels = nfactor.factor(self.plan, panels, self.device)
        return self.panels

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (original dof order) in one direct pass: the
        oracle has no refinement; use f64 for tight residuals."""
        if self.panels is None:
            self.factorize()
        blv = assemble.assemble_rhs(self.plan, b, dtype=self.dtype)
        xlv = nfactor.solve(self.plan, self.panels, blv)
        return assemble.extract_solution(self.plan,
                                         [x.cpu().numpy() for x in xlv])

    def factor_dense(self) -> np.ndarray:
        """The factor L as a dense lower-triangular array (permuted)."""
        if self.panels is None:
            self.factorize()
        return assemble.extract_factor_dense(
            self.plan, [p.cpu().numpy() for p in self.panels])

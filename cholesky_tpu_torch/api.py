"""High-level API of the port: load → plan → assemble → factor → solve.

The single-device, in-core counterpart of `cholesky_tpu/api.py:147-583`
and `:1535-1664`: `SparseCholesky.from_files` / `from_coo`, `factorize()`,
`solve(b)` for a 1-D right-hand side, `residual`, and `solve_spd`. The
device is an explicit argument everywhere; asking for "cuda" without a card
raises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cholesky_tpu_torch.io import mmio, ordering as ordio
from cholesky_tpu_torch.symbolic.plan import SolvePlan, build_plan
from cholesky_tpu_torch.numeric import frontal, refine
from cholesky_tpu_torch.numeric.assemble import TORCH_DTYPES, FrontAssembler
from cholesky_tpu_torch.numeric.frontal_plan import (FrontalPlan,
                                                     build_frontal_plan)


def _resolve_device(device) -> torch.device:
    """torch.device for "cpu" or "cuda[:i]"; raises for CUDA without a
    card (there is no silent CPU default)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class SparseCholesky:
    """Sparse SPD Cholesky solver over a nested-dissection ordering.

    Usage:
        solver = SparseCholesky.from_files(mtx, ord_file, clust_file,
                                           dtype=np.float32, device="cuda")
        solver.factorize()
        x = solver.solve(b)          # b in original dof order
    """

    def __init__(self, plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, dtype=np.float64, device="cuda"):
        self.device = _resolve_device(device)
        self.dtype = np.dtype(dtype)
        if self.dtype not in TORCH_DTYPES:
            raise ValueError(f"dtype must be float32 or float64, got "
                             f"{self.dtype}")
        self.plan = plan
        self.rows, self.cols, self.vals = rows, cols, vals
        self.panels = None          # assembled (pre-factor) or factored slabs
        self.factored = False
        self.last_solve = {}        # sweeps and residual estimate of solve()
        self._csr = None
        self._fplan: Optional[FrontalPlan] = None
        self._fasm = None
        self._inv = None            # (panels id, pivot inverses)
        self._ell = None            # padded ELL planes on the device

    @classmethod
    def from_files(cls, matrix_file: str, separator_file: str,
                   clusters_file: Optional[str] = None, dtype=np.float64,
                   pad_to: int = 8, device="cuda") -> "SparseCholesky":
        ordng = ordio.parse_ordering(separator_file)
        clusters = ordio.parse_clusters(clusters_file) if clusters_file else None
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        banner, r, c, v = mmio.read_coo(matrix_file)
        if banner.rows != plan.n:
            raise ValueError(
                f"matrix dim {banner.rows} != ordering dof count {plan.n}")
        r2, c2, v2 = mmio.dedup_lower(r, c, v)
        return cls(plan, r2, c2, v2, dtype=dtype, device=device)

    @classmethod
    def from_coo(cls, n: int, rows, cols, vals, ordng: ordio.Ordering,
                 clusters=None, dtype=np.float64, pad_to: int = 8,
                 device="cuda") -> "SparseCholesky":
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        if plan.n != n:
            raise ValueError("ordering does not cover the matrix dimension")
        r2, c2, v2 = mmio.dedup_lower(rows, cols, vals)
        return cls(plan, r2, c2, v2, dtype=dtype, device=device)

    # ------------------------------------------------------------------
    @property
    def fplan(self) -> FrontalPlan:
        if self._fplan is None:
            self._fplan = build_frontal_plan(self.plan, self.rows, self.cols)
        return self._fplan

    def assemble(self) -> List[torch.Tensor]:
        """(Re)build the per-level pivot slabs on the device from the COO
        values: one scatter per level, only the [nnz] values uploaded."""
        if self._fasm is None:
            self._fasm = FrontAssembler(self.fplan, self.rows, self.cols,
                                        self.device)
        self.panels = self._fasm(self.vals, dtype=self.dtype)
        self.factored = False
        return self.panels

    def factorize(self):
        """Numeric factorization; returns the per-level [B, F, W] factors."""
        if self.panels is None or self.factored:
            self.assemble()
        self.panels = frontal.factor(self.fplan, self.panels)
        self.factored = True
        return self.panels

    def _inv_pivots(self):
        """Per-level pivot inverses, cached with the factorization."""
        if self._inv is None or self._inv[0] != id(self.panels):
            self._inv = (id(self.panels),
                         frontal.invert_pivots(self.fplan, self.panels))
        return self._inv[1]

    def _ell_padded(self):
        """Double-float ELL planes of the symmetrized matrix in the banded
        padded basis, on the device (False when a row is too dense)."""
        if self._ell is None:
            r, c, v = mmio.symmetrize_coo(self.rows, self.cols, self.vals)
            ell = refine.build_ell(self.plan.n, self.plan.iperm[r],
                                   self.plan.iperm[c], v)
            if ell is None:
                self._ell = False
            else:
                idx, a_hi, a_lo = refine.pad_ell(self.fplan, ell)
                self._ell = (torch.from_numpy(idx.astype(np.int64)),
                             torch.from_numpy(a_hi), torch.from_numpy(a_lo))
                self._ell = tuple(t.to(self.device) for t in self._ell)
        return self._ell

    def _solve_once(self, b: np.ndarray) -> np.ndarray:
        """One banded solve against the factor: b [n] -> x [n] (f64)."""
        bp = torch.from_numpy(np.ascontiguousarray(
            b.reshape(-1)[self.plan.perm].astype(self.dtype))).to(self.device)
        xp = frontal._solve_banded(self.fplan, self.panels,
                                   self._inv_pivots(), bp)
        x = np.empty(self.plan.n)
        x[self.plan.perm] = xp.cpu().numpy()
        return x

    def solve(self, b: np.ndarray, tol: float = 1e-10,
              max_iter: int = 50) -> np.ndarray:
        """Solve A x = b for a 1-D b; b and x are in ORIGINAL dof order.

        An f32 factor is refined on the device (f32 banded solves,
        double-float residuals) to a relative residual of tol / 3; should
        that not reach `tol`, a host loop with an f64 residual continues.
        An f64 factor is applied once."""
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 2 and b.shape[1] == 1:
            b = b.reshape(-1)
        if b.ndim != 1 or b.shape[0] != self.plan.n:
            raise ValueError(f"b must be [{self.plan.n}], got {b.shape}")
        if not self.factored:
            self.factorize()
        self.last_solve = {"sweeps": 0, "host_sweeps": 0}
        if self.dtype == np.float64:
            return self._solve_once(b)
        x = None
        ell = self._ell_padded()
        if ell:
            # the device loop targets tol/3: its f32 residual-norm estimate
            # can sit slightly above the true f64 residual
            x_perm, sweeps, rn_rel = refine.solve_refined_df(
                self.fplan, self.panels, self._inv_pivots(),
                b[self.plan.perm], ell, tol=tol / 3.0, max_iter=max_iter)
            x = np.empty(self.plan.n)
            x[self.plan.perm] = x_perm
            self.last_solve.update(sweeps=sweeps, rn_rel=rn_rel)
            if rn_rel <= tol:
                return x
        a = self._matrix_csr()
        bnorm = np.linalg.norm(b)
        if x is None:
            x = self._solve_once(b)
        for _ in range(max_iter):
            r = b - a @ x
            if np.linalg.norm(r) <= tol * bnorm:
                break
            x = x + self._solve_once(r)
            self.last_solve["host_sweeps"] += 1
        return x

    def _matrix_csr(self):
        if self._csr is None:
            import scipy.sparse

            r, c, v = mmio.symmetrize_coo(self.rows, self.cols, self.vals)
            self._csr = scipy.sparse.csr_matrix(
                (v, (r, c)), shape=(self.plan.n, self.plan.n))
        return self._csr

    def residual(self, b: np.ndarray, x: np.ndarray) -> float:
        """Relative residual ||Ax-b|| / ||b|| against the original matrix,
        in f64 on the host."""
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        ax = self._matrix_csr() @ np.asarray(x, dtype=np.float64).reshape(-1)
        return float(np.linalg.norm(ax - b) / np.linalg.norm(b))


def solve_spd(matrix_file: str, separator_file: str, b: np.ndarray,
              clusters_file: Optional[str] = None, dtype=np.float64,
              device="cuda") -> np.ndarray:
    """One-shot convenience: factor and solve from files."""
    s = SparseCholesky.from_files(matrix_file, separator_file, clusters_file,
                                  dtype=dtype, device=device)
    s.factorize()
    return s.solve(b)

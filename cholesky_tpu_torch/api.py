"""High-level API of the port: load → plan → assemble → factor → solve.

The single-device counterpart of `cholesky_tpu/api.py:147-733` and
`:1535-1664`: `SparseCholesky.from_files` / `from_coo`, `factorize()`,
`solve(b)` for a 1-D right-hand side, `residual`, and `solve_spd`. The
device is an explicit argument everywhere; asking for "cuda" without a card
raises.

Capacity: `factorize()` plans its regimes against one memory budget
(`numeric/regimes.py`): by default BUDGET_FRACTION of the card's free
memory when it starts, or the `budget` given to the constructor (bytes);
on the CPU the default is unbounded. The plan decides the assembly (all
levels up front, or each level right before it runs), each level's path,
update dtype and batch chunks, and the stored factor's dtype and place
(device or host). `solve()` then uses explicit pivot inverses when they fit
the same budget beside the factor, and the solve without inverses
otherwise. The plan of the last budget is kept: a refactorization under
the same budget does not search again.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from cholesky_tpu_torch.io import mmio, ordering as ordio
from cholesky_tpu_torch.symbolic.plan import SolvePlan, build_plan
from cholesky_tpu_torch.numeric import devmem, frontal, refine, regimes
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
                 vals: np.ndarray, dtype=np.float64, device="cuda",
                 budget: Optional[int] = None):
        """`budget`: device bytes the factorization may hold at once (None:
        regimes.BUDGET_FRACTION of the card's free memory when factorize()
        starts; unbounded on the CPU)."""
        self.device = _resolve_device(device)
        self.budget = budget
        self.regimes: Optional[regimes.RegimePlan] = None  # last plan
        self._plans = None          # (budget, its plan)
        # a plan that factorize() takes in place of the budget's (tests
        # force a regime at small sizes with regimes.plan_regimes keywords)
        self._plan_override: Optional[regimes.RegimePlan] = None
        # factorize() returns the allocator's cache to the driver when the
        # planned peak does not fit in the driver's free memory (chip_smoke
        # turns this off on one refactorization to measure both ways)
        self._release_cache = True
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
        self._ell = None            # (host ELL planes,) or False
        self._ell_dev = {}          # {banded: ELL planes on the device}
        self.factor_stats = {}      # budget and baseline of factorize()

    @classmethod
    def from_files(cls, matrix_file: str, separator_file: str,
                   clusters_file: Optional[str] = None, dtype=np.float64,
                   pad_to: int = 8, device="cuda",
                   budget: Optional[int] = None) -> "SparseCholesky":
        ordng = ordio.parse_ordering(separator_file)
        clusters = ordio.parse_clusters(clusters_file) if clusters_file else None
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        banner, r, c, v = mmio.read_coo(matrix_file)
        if banner.rows != plan.n:
            raise ValueError(
                f"matrix dim {banner.rows} != ordering dof count {plan.n}")
        r2, c2, v2 = mmio.dedup_lower(r, c, v)
        return cls(plan, r2, c2, v2, dtype=dtype, device=device,
                   budget=budget)

    @classmethod
    def from_coo(cls, n: int, rows, cols, vals, ordng: ordio.Ordering,
                 clusters=None, dtype=np.float64, pad_to: int = 8,
                 device="cuda", budget: Optional[int] = None
                 ) -> "SparseCholesky":
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        if plan.n != n:
            raise ValueError("ordering does not cover the matrix dimension")
        r2, c2, v2 = mmio.dedup_lower(rows, cols, vals)
        return cls(plan, r2, c2, v2, dtype=dtype, device=device,
                   budget=budget)

    # ------------------------------------------------------------------
    @property
    def fplan(self) -> FrontalPlan:
        if self._fplan is None:
            self._fplan = build_frontal_plan(self.plan, self.rows, self.cols)
        return self._fplan

    def _assembler(self) -> FrontAssembler:
        if self._fasm is None:
            self._fasm = FrontAssembler(self.fplan, self.rows, self.cols,
                                        self.device)
        return self._fasm

    def assemble(self) -> List[torch.Tensor]:
        """(Re)build the per-level pivot slabs on the device from the COO
        values: one scatter per level, only the [nnz] values uploaded."""
        self.panels = self._assembler()(self.vals, dtype=self.dtype)
        self.factored = False
        return self.panels

    def _budget_bytes(self) -> int:
        if self.budget is not None:
            return int(self.budget)
        if self.device.type == "cuda":
            return regimes.default_budget(self.device)
        return 1 << 62                          # the CPU: unbounded

    def factorize(self, level_hook=None):
        """Numeric factorization under the regime plan of the budget;
        returns the per-level [B, F, W] factors (device tensors, or CPU
        tensors for levels the plan keeps in host memory). `level_hook(lvl,
        "start" | "end")` is called around each level (instrumentation).
        `self.regimes` keeps the plan and `self.factor_stats` the budget,
        the seconds spent planning (and whether the plan of the last budget
        was reused), whether the allocator's cache was released, and the
        bytes allocated on the device when the factorization began (after
        the previous factor was dropped)."""
        asm = self._assembler()
        pre = self.panels if (self.panels is not None
                              and not self.factored) else None
        # drop the previous factor and its inverses before the budget is
        # read: the new factorization replaces them
        self.panels, self.factored, self._inv = None, False, None
        t0 = time.perf_counter()
        budget = self._budget_bytes()
        reused = self._plans is not None and self._plans[0] == budget
        plan = self._plan_override or self._plan(budget)
        self.regimes = plan
        plan_s = time.perf_counter() - t0
        # A factorization that does not fit in the driver's free memory runs
        # in the segments its predecessor left cached. Its slabs, factors
        # and updates are then carved out of them at other places than the
        # first time, and the split segments fragment: at 140^3 L14 on an
        # 80 GB card a third refactorization without a release failed to
        # allocate 15.91 GiB with 40.48 GiB reserved but unallocated, though
        # no long-lived tensor sat in those segments (devmem). Returning the
        # cache to the driver first starts it as the first one started.
        released = (self.device.type == "cuda" and self._release_cache
                    and plan.peak_bytes
                    > torch.cuda.mem_get_info(self.device)[0])
        if released:
            torch.cuda.empty_cache()
        self.factor_stats = {
            "budget": plan.budget, "plan_s": plan_s, "plan_reused": reused,
            "released_cache": released,
            "allocated_at_start": (torch.cuda.memory_allocated(self.device)
                                   if self.device.type == "cuda" else None)}
        if pre is not None:
            fronts = pre                        # assembled by the caller
        elif plan.lazy:
            fronts = asm.lazy(self.vals, dtype=self.dtype)
        else:
            fronts = asm(self.vals, dtype=self.dtype)
        del pre                 # the level loop consumes the slabs
        self.panels = frontal.factor(self.fplan, fronts, plan,
                                     level_hook=level_hook)
        self.factored = True
        return self.panels

    def _plan(self, budget: int) -> regimes.RegimePlan:
        """The regime plan of `budget`, searched once per budget."""
        if self._plans is None or self._plans[0] != budget:
            self._plans = (budget, regimes.plan_regimes(
                self.fplan, self.dtype, budget))
        return self._plans[1]

    def _factor_bytes(self) -> int:
        """Device bytes of the stored factor (levels in host memory not
        counted)."""
        return sum(p.numel() * p.element_size() for p in self.panels
                   if p.device == self.device)

    def _want_inv_pivots(self) -> bool:
        """Explicit pivot inverses when they fit the budget beside the
        device-resident factor and the solve's working set (ELL planes,
        work vectors, the promotion of one bf16 or host level); the solve
        without inverses needs no extra residency."""
        fp = self.fplan
        tdt = TORCH_DTYPES[self.dtype]
        promote = max((p.numel() * 4 for p in self.panels
                       if p.device != self.device
                       or p.dtype == torch.bfloat16), default=0)
        ell = self._ell_host()
        ell_k = ell[0].shape[1] if ell is not None else regimes.ELL_MAX_K
        need = (self._factor_bytes() + regimes.inv_bytes(fp.F, fp.W, tdt)
                + regimes.solve_bytes(fp.F, fp.W, tdt, ell_k,
                                      host_level=promote))
        budget = (self.regimes.budget if self.regimes is not None
                  else self._budget_bytes())
        return need <= budget

    def _inv_pivots(self):
        """Per-level pivot inverses, cached with the factorization."""
        if self._inv is None or self._inv[0] != id(self.panels):
            self._inv = None            # free stale inverses first
            self._inv = (id(self.panels),
                         frontal.invert_pivots(self.fplan, self.panels,
                                               device=self.device))
        return self._inv[1]

    def _ell_host(self):
        """Double-float ELL planes of the symmetrized PERMUTED matrix on the
        host (None when a row is too dense)."""
        if self._ell is None:
            r, c, v = mmio.symmetrize_coo(self.rows, self.cols, self.vals)
            ell = refine.build_ell(self.plan.n, self.plan.iperm[r],
                                   self.plan.iperm[c], v)
            self._ell = (ell,) if ell is not None else False
            self._ell_dev = {}
        return self._ell[0] if self._ell else None

    def _ell_device(self, banded: bool):
        """The ELL planes for one refinement engine, on the device: in the
        banded padded basis (banded) or the permuted basis (plain)."""
        ell = self._ell_host()
        if ell is None:
            return None
        if banded not in self._ell_dev:
            planes = refine.pad_ell(self.fplan, ell) if banded else ell
            self._ell_dev = {}
            with devmem.persistent(self.device):
                self._ell_dev[banded] = (
                    torch.from_numpy(planes[0].astype(np.int64)).to(
                        self.device),
                    torch.from_numpy(planes[1]).to(self.device),
                    torch.from_numpy(planes[2]).to(self.device))
        return self._ell_dev[banded]

    def _solve_once(self, b: np.ndarray) -> np.ndarray:
        """One solve against the factor: b [n] -> x [n] (f64): the banded
        chain with pivot inverses when they fit the budget, else the solve
        without inverses."""
        bp = torch.from_numpy(np.ascontiguousarray(
            b.reshape(-1)[self.plan.perm].astype(self.dtype))).to(self.device)
        if self._want_inv_pivots():
            xp = frontal._solve_banded(self.fplan, self.panels,
                                       self._inv_pivots(), bp)
        else:
            xp = frontal.frontal_solve(self.fplan, self.panels, bp)
        x = np.empty(self.plan.n)
        x[self.plan.perm] = xp.cpu().numpy()
        return x

    def solve(self, b: np.ndarray, tol: float = 1e-10,
              max_iter: int = 50) -> np.ndarray:
        """Solve A x = b for a 1-D b; b and x are in ORIGINAL dof order.

        An f32 factor (stored f32 or bf16, on the device or in host memory)
        is refined on the device (f32 solves, double-float residuals) to a
        relative residual of tol / 3; should that not reach `tol`, a host
        loop with an f64 residual continues. An f64 factor is applied once.
        `last_solve` records the sweeps and the inner engine ("banded" with
        pivot inverses, "plain" without)."""
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 2 and b.shape[1] == 1:
            b = b.reshape(-1)
        if b.ndim != 1 or b.shape[0] != self.plan.n:
            raise ValueError(f"b must be [{self.plan.n}], got {b.shape}")
        if not self.factored:
            self.factorize()
        use_inv = self._want_inv_pivots()
        self.last_solve = {"sweeps": 0, "host_sweeps": 0,
                           "engine": "banded" if use_inv else "plain"}
        if self.dtype == np.float64:
            return self._solve_once(b)
        x = None
        ell = self._ell_device(use_inv)
        if ell is not None:
            # the device loop targets tol/3: its f32 residual-norm estimate
            # can sit slightly above the true f64 residual
            x_perm, sweeps, rn_rel = refine.solve_refined_df(
                self.fplan, self.panels,
                self._inv_pivots() if use_inv else None,
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
              device="cuda", budget: Optional[int] = None) -> np.ndarray:
    """One-shot convenience: factor and solve from files."""
    s = SparseCholesky.from_files(matrix_file, separator_file, clusters_file,
                                  dtype=dtype, device=device, budget=budget)
    s.factorize()
    return s.solve(b)

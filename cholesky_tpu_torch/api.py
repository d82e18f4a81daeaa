"""High-level API of the port: load -> plan -> assemble -> factor -> solve.

The single-device SPD surface of `cholesky_tpu/api.py`:

  * ways in: `SparseCholesky.from_files` / `from_coo` (an ordering computed
    elsewhere), `from_matrix` / `from_scipy` (no ordering: graph nested
    dissection with a minimum-degree candidate, `symbolic/nd.py`), and the
    one-shots `solve_spd` and `spsolve`;
  * `factorize(check=)`, `update_values` (new coefficients on the same
    pattern: only the numeric phase runs again), `save_factor` /
    `load_factor` (the JAX package's `.npz` layout, so a checkpoint written
    by either package loads in the other);
  * ways out: `solve(b, refine=, tol=, max_iter=)` for one right-hand side
    [n] or a block [n, k], `residual`, `logdet`, `factor_dense`,
    `factor_coo`, `permuted_dense`, `aslinearoperator`;
  * what a GMRF or GP user asks of a precision matrix beyond solves:
    `inv_diag` / `inv_entries` (selected inversion, `numeric/selinv.py`),
    `logdet_grad` / `solve_grad` / `quadform_grad` (gradients with respect
    to the values), `sample` / `whiten` (x = L^-T z and its inverse);
  * `factorize_many`: K matrices of the same pattern factored as one
    family, folded into the batch axis of every level; `BatchedFactors`
    solves, refines and takes the logdet of each system;
  * symmetric quasi-definite matrices (KKT / saddle-point systems): every
    constructor takes `signs=` (+1 / -1 per dof), `factorize()` then runs
    the signed LDL^T of `numeric/ldlt.py`, `solve` refines through the
    signed solve, and `slogdet` / `inertia` read the factor; the methods
    that need a Cholesky factor raise NotImplementedError on such a solver;
  * the factor's companions: the Schur complement onto the root separator
    (`schur_dofs`, `schur_complement`, `condense_rhs`, `expand_solution`),
    low-rank updates by Woodbury (`solve_updated`, `logdet_updated`), a
    general perturbation by preconditioned CG (`solve_perturbed`), and
    Lanczos eigenpairs and condition numbers (`eigsh`, `condest`,
    `numeric/eigs.py`);
  * the matmul-precision ladder: every constructor and `factorize` take
    `precision=` (the JAX package's names), the `precision` property
    resolves AUTO (None) from the plan's executed frontal FLOPs
    (`utils/capacity.py`) and pins the answer once factored, and
    checkpoints carry it. On the card a rung is cuBLAS's float32 math
    (`numeric/precision.py`: TF32, or IEEE for "highest" / "float32"),
    set for the factorization, the solves and every method that applies
    the factor, and put back after each.

The device is an explicit argument everywhere; asking for "cuda" without a
card raises. The port reads no environment variable.

Multi-device: every constructor, `spsolve` and `solve_spd` take `mesh=`
(`parallel.mesh.make_mesh` / `make_multislice_mesh`), which overrides
`device=` (the mesh's first slot is `self.device`). Each slot's part of
the slabs is then assembled on the slot's device (`MeshAssembler`);
`factorize()` runs the slot-sharded levels per slot, eligible narrow levels
by row groups and the rest on the first slot, the root collectively only
where `frontal.ROOT_DIST_MIN` asks for it (`numeric/frontal.py`,
`parallel/`), under one slot's regime plan; the solves and their
refinement run the slot-sharded levels per slot, the residual on the first
slot. `factorize_many` shards the family's systems over the mesh, padding
K to a multiple of the slot count with copies of the last system
(`BatchedFactors.pad`). Selected inversion, the Schur complement, factor
export and checkpoints run on the factor gathered onto the first slot's
device (a sharded selected inversion is later work), and give the JAX
package's results.

Capacity: `factorize()` plans its regimes against one memory budget
(`numeric/regimes.py`): by default BUDGET_FRACTION of the card's free
memory when it starts, or the `budget` given to the constructor (bytes);
on the CPU the default is unbounded. The plan decides the assembly (all
levels up front, or each level right before it runs), each level's path,
update dtype and batch chunks, and the stored factor's dtype and place
(device or host). `solve()` then uses explicit pivot inverses when they fit
the same budget beside the factor, and the solve without inverses
otherwise; a block of right-hand sides refines in one device loop when the
block residual's temporaries fit that budget too, else in a host loop over
column chunks. The plan of the last budget is kept: a refactorization
under the same budget does not search again. Selected inversion and a
family stay in core, as in the JAX package: `regimes.selinv_bytes` and the
family's regime plan (at batch K 2^lvl, factor in the compute dtype on the
device) are held to the budget before anything is allocated, and
`regimes.BudgetError` (a MemoryError, as the JAX package raises) says by
how much they miss it. A quasi-definite factorization is in core and square
(`regimes.plan_qd`), under the same guard.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import List, Optional

import numpy as np
import torch

from cholesky_tpu_torch.io import mmio, ordering as ordio
from cholesky_tpu_torch.symbolic.plan import SolvePlan, build_plan
from cholesky_tpu_torch.numeric import devmem, frontal, ldlt, regimes, selinv
from cholesky_tpu_torch.numeric import refine as refine_mod
from cholesky_tpu_torch.numeric.assemble import (TORCH_DTYPES, FrontAssembler,
                                                 MeshAssembler)
from cholesky_tpu_torch.numeric.frontal_plan import (FrontalPlan,
                                                     build_frontal_plan)
from cholesky_tpu_torch.numeric.precision import (
    check as _check_precision, precision_ctx as _precision_ctx)
from cholesky_tpu_torch.parallel import mesh as mesh_mod
from cholesky_tpu_torch.utils import capacity

# AUTO rung (precision=None, f32 factors): executed frontal FLOPs
# (`capacity.frontal_flops`) at or below this pick "highest", above it the
# one-pass default. The JAX package's threshold, kept so that both packages
# name the same rung on the same plan (50^3 L8 executes 0.35 TFLOP); the
# H100's own crossover is measured by chip_smoke's precision phase
# (PERF.md), not adopted here. Read at use time, so a test can move it.
_AUTO_HIGHEST_FLOPS = 1e12


def _with_precision(fn):
    """Method decorator: run the body under the solver's rung, so that every
    surface that applies the factor (solves, selected inversion, sampling,
    Schur reads, gradients, spectra) runs at the precision the factor was
    built at. Nesting with an identical inner context is harmless."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with _precision_ctx(self.precision):
            return fn(self, *args, **kwargs)
    return wrapper


def _resolve_device(device) -> torch.device:
    """torch.device for "cpu" or "cuda[:i]"; raises for CUDA without a
    card (there is no silent CPU default). "cuda" resolves to the current
    card's index: the solver compares its device with its tensors' (which
    levels are resident, which are promoted), and torch.device("cuda") is
    not equal to torch.device("cuda:0")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _home_device(device, mesh) -> torch.device:
    """The solver's device: the mesh's first slot (every slot's device
    checked as `_resolve_device` checks one), else `device`."""
    if mesh is None:
        return _resolve_device(device)
    for d in mesh.distinct:
        _resolve_device(d)
    return mesh.flat[0]


class SparseCholesky:
    """Sparse SPD Cholesky solver over a nested-dissection ordering.

    Usage:
        solver = SparseCholesky.from_files(mtx, ord_file, clust_file,
                                           dtype=np.float32, device="cuda")
        solver.factorize()
        x = solver.solve(b)          # b [n] or [n, k] in original dof order

        solver = SparseCholesky.from_scipy(a)      # no ordering files
        solver.update_values(new_vals)             # same pattern, new values
    """

    def __init__(self, plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, dtype=np.float64, device="cuda",
                 budget: Optional[int] = None, signs=None,
                 precision: Optional[str] = None, mesh=None):
        """`budget`: device bytes the factorization may hold at once (None:
        regimes.BUDGET_FRACTION of the card's free memory when factorize()
        starts; unbounded on the CPU; under a mesh, per device, shared by
        the slots on it). `mesh`: a `parallel.mesh.Mesh` to distribute
        over (it overrides `device`). `signs`: [n] of +1 / -1 in original
        dof order, the signature of a symmetric quasi-definite matrix
        (factored as L~ S L~^T, `numeric/ldlt.py`); an all-positive
        signature is the SPD path (`signs` None). `precision`: the matmul
        rung of the factorization and of every application of the factor,
        one of the JAX package's names (`numeric/precision.py`); None is
        AUTO (see the `precision` property), "default" the one-pass rung."""
        _check_precision(precision)
        self._precision = precision
        self._precision_resolved = None   # AUTO's answer, pinned when factored
        self.mesh = mesh
        self.device = _home_device(device, mesh)
        self.signs = None
        if signs is not None:
            signs = np.asarray(signs, dtype=np.float64).reshape(-1)
            if signs.shape[0] != plan.n or not np.all(np.abs(signs) == 1.0):
                raise ValueError("signs must be [n] of +1/-1")
            if not np.all(signs == 1.0):
                self.signs = signs
        self._sig = None            # the signature on the device
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
        self.ordering_info = {}     # from_matrix: what the ordering decided

    @classmethod
    def from_files(cls, matrix_file: str, separator_file: str,
                   clusters_file: Optional[str] = None, dtype=np.float64,
                   pad_to: int = 8, device="cuda",
                   budget: Optional[int] = None, signs=None,
                   precision: Optional[str] = None,
                   mesh=None) -> "SparseCholesky":
        ordng = ordio.parse_ordering(separator_file)
        clusters = ordio.parse_clusters(clusters_file) if clusters_file else None
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        banner, r, c, v = mmio.read_coo(matrix_file)
        if banner.rows != plan.n:
            raise ValueError(
                f"matrix dim {banner.rows} != ordering dof count {plan.n}")
        r2, c2, v2 = mmio.dedup_lower(r, c, v)
        return cls(plan, r2, c2, v2, dtype=dtype, device=device,
                   budget=budget, signs=signs, precision=precision,
                   mesh=mesh)

    @classmethod
    def from_matrix(cls, n: int, rows, cols, vals, levels=None,
                    dtype=np.float64, device="cuda",
                    budget: Optional[int] = None, md_max: int = 131072,
                    md_small: int = 16384, signs=None,
                    native: Optional[bool] = None,
                    threads: Optional[int] = None,
                    precision: Optional[str] = None, mesh=None,
                    _canonical: bool = False) -> "SparseCholesky":
        """Solve an arbitrary SPD (or, with `signs`, symmetric
        quasi-definite) matrix with NO precomputed ordering: a
        nested-dissection ordering is computed from the sparsity graph
        (`symbolic/nd.py`; `md_max` / `md_small` gate its minimum-degree
        candidate; `native` / `threads` choose its engine, the native
        library by default when it is available). `ordering_info` keeps
        what it decided, the engine that ran (`engine`: "native" or
        "python") and its host seconds (`order_s`).

        `_canonical=True` asserts the COO is already lower-triangle with
        unique coordinates (from_scipy's fold guarantees this), skipping a
        redundant O(nnz log nnz) dedup pass."""
        from cholesky_tpu_torch.symbolic.nd import nested_dissection_graph

        _home_device(device, mesh)          # fail before the host work
        _check_precision(precision)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        info = {}
        ordng, clusters = nested_dissection_graph(
            n, rows, cols, levels, md_max=md_max, md_small=md_small,
            info=info, native=native, threads=threads)
        solver = cls.from_coo(n, rows, cols, vals, ordng, clusters,
                              dtype=dtype, device=device, budget=budget,
                              signs=signs, precision=precision, mesh=mesh,
                              _canonical=_canonical)
        solver.ordering_info = info
        return solver

    @classmethod
    def from_scipy(cls, a, dtype=None, levels=None, device="cuda",
                   budget: Optional[int] = None,
                   precision: Optional[str] = None, mesh=None,
                   **kw) -> "SparseCholesky":
        """Build from a scipy sparse matrix (any format) or a dense
        symmetric ndarray. Accepts the lower triangle, the upper triangle,
        or a fully-populated symmetric matrix: (i,j)/(j,i) pairs fold to
        the lower triangle by averaging, so a full symmetric store and a
        one-triangle store give identical input. `dtype=None` keeps the
        matrix's own dtype. Extra keywords go to `from_matrix`."""
        import scipy.sparse as _sp

        if _sp.issparse(a):
            if a.shape[0] != a.shape[1]:
                raise ValueError("matrix must be square")
            # canonicalize through CSR first: scipy's COO convention sums
            # duplicate coordinates; the triangle fold below must then see
            # at most one entry per (i,j)
            coo = a.tocsr().tocoo()
            n, r, c, v = coo.shape[0], coo.row, coo.col, coo.data
        else:
            arr = np.asarray(a)
            if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
                raise ValueError("dense input must be square 2-D")
            r, c = np.nonzero(arr)
            n, v = arr.shape[0], arr[r, c]
        # a full symmetric store carries each off-diagonal twice; fold
        # (i,j)/(j,i) to the lower triangle by MEAN so one-triangle and
        # full-symmetric stores produce identical COO input
        off = r != c
        lo_r = np.where(off & (r < c), c, r)
        lo_c = np.where(off & (r < c), r, c)
        key = lo_r.astype(np.int64) * n + lo_c
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        v64 = np.asarray(v, dtype=np.float64)[order]
        uniq, start, counts = np.unique(key_s, return_index=True,
                                        return_counts=True)
        vsum = np.add.reduceat(v64, start)
        vmean = vsum / counts
        # symmetry guard: where BOTH triangles are stored, (i,j) and (j,i)
        # must agree — silently averaging a nonsymmetric matrix would
        # return a confidently wrong answer for the system the user meant
        both = counts == 2
        if np.any(both):
            second = np.minimum(start + 1, v64.size - 1)
            va, vb = v64[start[both]], v64[second[both]]
            scale = np.maximum(np.abs(va), np.abs(vb))
            bad = np.abs(va - vb) > 1e-8 * np.maximum(scale, 1e-30)
            if np.any(bad):
                k = int(np.flatnonzero(bad)[0])
                ij = uniq[both][k]
                raise ValueError(
                    f"matrix is not symmetric: A[{ij // n},{ij % n}] stores "
                    f"{va[k]!r} and {vb[k]!r} across the two triangles "
                    "(this solver is for symmetric positive-definite "
                    "systems; symmetrize explicitly if intended)")
        rr, cc = uniq // n, uniq % n
        if dtype is None:
            dtype = np.asarray(v).dtype
            if np.dtype(dtype).kind != "f":
                dtype = np.float64
        return cls.from_matrix(int(n), rr, cc, vmean, levels=levels,
                               dtype=dtype, device=device, budget=budget,
                               precision=precision, mesh=mesh,
                               _canonical=True, **kw)

    @classmethod
    def from_coo(cls, n: int, rows, cols, vals, ordng: ordio.Ordering,
                 clusters=None, dtype=np.float64, pad_to: int = 8,
                 device="cuda", budget: Optional[int] = None, signs=None,
                 precision: Optional[str] = None, mesh=None,
                 _canonical: bool = False) -> "SparseCholesky":
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        if plan.n != n:
            raise ValueError("ordering does not cover the matrix dimension")
        if _canonical:
            r2 = np.asarray(rows, dtype=np.int64)
            c2 = np.asarray(cols, dtype=np.int64)
            v2 = np.asarray(vals, dtype=np.float64)
        else:
            r2, c2, v2 = mmio.dedup_lower(rows, cols, vals)
        return cls(plan, r2, c2, v2, dtype=dtype, device=device,
                   budget=budget, signs=signs, precision=precision,
                   mesh=mesh)

    # ------------------------------------------------------------------
    @property
    def precision(self) -> Optional[str]:
        """The effective matmul rung, as the JAX package resolves it. An
        explicit one (constructor, setter, `factorize(precision=)`) wins,
        "default" reading back as None. Otherwise AUTO: an f32 factor whose
        executed frontal FLOPs (`capacity.frontal_flops`) are at most
        `_AUTO_HIGHEST_FLOPS` gets "highest", a larger one None (the
        one-pass rung); f64 and quasi-definite solvers get None. The answer
        is pinned once the solver is factored (a factor is applied at the
        rung it was built at); `update_values` re-resolves it from the same
        plan, `load_factor` pins the checkpoint's."""
        if self._precision is not None:
            return None if self._precision == "default" else self._precision
        if (self.dtype != np.float32 or self.signs is not None
                or self.factored):
            return self._precision_resolved
        auto = ("highest" if capacity.frontal_flops(self.fplan)
                <= _AUTO_HIGHEST_FLOPS else None)
        self._precision_resolved = auto
        return auto

    @precision.setter
    def precision(self, value: Optional[str]) -> None:
        self._precision = value
        self._precision_resolved = None

    @property
    def fplan(self) -> FrontalPlan:
        if self._fplan is None:
            self._fplan = build_frontal_plan(self.plan, self.rows, self.cols)
        return self._fplan

    def _assembler(self):
        """The front assembler: on the device, or under a mesh on each
        slot's device (`MeshAssembler`)."""
        if self._fasm is None:
            self._fasm = (FrontAssembler(self.fplan, self.rows, self.cols,
                                         self.device)
                          if self.mesh is None else
                          MeshAssembler(self.fplan, self.rows, self.cols,
                                        self.mesh))
        return self._fasm

    def _fronts(self, vals, lazy: bool = False):
        """The slabs of `vals`: on the device (eagerly or level by level),
        or under a mesh each slot's part on its own device."""
        asm = self._assembler()
        if self.mesh is not None:
            return asm(vals, dtype=self.dtype)
        return (asm.lazy if lazy else asm)(vals, dtype=self.dtype)

    def assemble(self) -> List[torch.Tensor]:
        """(Re)build the per-level pivot slabs on the device from the COO
        values: one scatter per level, only the [nnz] values uploaded.
        Under a mesh, each slot's part on its own device."""
        self.panels = self._fronts(self.vals)
        self.factored = False
        return self.panels

    def coo_pattern(self):
        """The canonical sparsity pattern (0-based lower-triangle rows, cols)
        that `update_values(vals)` must align with."""
        return self.rows, self.cols

    def update_values(self, vals, rows=None, cols=None):
        """Replace the matrix's numeric values, keeping the sparsity pattern
        and every symbolic artifact: the ordering and plan, the frontal
        plan, the assembler's scatter indices and the regime plan of the
        budget. The next factorize()/solve() re-runs only the numeric phase
        (time stepping, Newton iterations). Everything derived from the old
        values goes, on the host and on the device: the factor, the pivot
        inverses, the CSR matrix and the ELL planes of the residual.

        With only `vals`, entries must align with `coo_pattern()` (the
        deduplicated lower triangle). With `rows`/`cols`, any COO layout of
        the SAME pattern is accepted (either triangle, duplicates dropped as
        at construction) and checked against the stored pattern."""
        if (rows is None) != (cols is None):
            raise ValueError("pass both rows and cols, or neither")
        if rows is not None:
            r2, c2, v2 = mmio.dedup_lower(rows, cols, vals)
            # dedup_lower preserves input entry order, so compare patterns
            # canonically and realign the values to the stored entry order
            n = int(self.plan.n)
            key_new = r2 * n + c2
            key_old = self.rows * n + self.cols
            order_new = np.argsort(key_new)
            order_old = np.argsort(key_old)
            if (len(r2) != len(self.rows)
                    or not np.array_equal(key_new[order_new],
                                          key_old[order_old])):
                raise ValueError(
                    "sparsity pattern differs from the planned matrix — "
                    "build a new SparseCholesky for a new pattern")
            vals = np.empty_like(v2)
            vals[order_old] = v2[order_new]
        else:
            vals = np.asarray(vals, dtype=np.float64)
            if vals.shape != self.vals.shape:
                raise ValueError(
                    f"expected {self.vals.shape[0]} values aligned with "
                    f"coo_pattern(), got {vals.shape}")
        self.vals = vals
        self.panels, self.factored = None, False
        self._inv = self._csr = self._ell = None
        self._ell_dev = {}

    def _budget_bytes(self) -> int:
        """The factorization's budget; under a mesh one slot's: the
        smallest of its devices' budgets over the slots sharing it."""
        if self.mesh is not None:
            return min(self._device_budget(d) // self.mesh.slots_on(d)
                       for d in self.mesh.distinct)
        return self._device_budget(self.device)

    def _device_budget(self, device) -> int:
        if self.budget is not None:
            return int(self.budget)
        if device.type == "cuda":
            return regimes.default_budget(device)
        return 1 << 62                          # the CPU: unbounded

    def factorize(self, check: bool = False, precision: Optional[str] = None,
                  level_hook=None):
        """Numeric factorization under the regime plan of the budget;
        returns the per-level [B, F, W] factors (device tensors, or CPU
        tensors for levels the plan keeps in host memory). `level_hook(lvl,
        "start" | "end")` is called around each level (instrumentation).
        `self.regimes` keeps the plan and `self.factor_stats` the budget,
        the seconds spent planning (and whether the plan of the last budget
        was reused), whether the allocator's cache was released, and the
        bytes allocated on the device when the factorization began (after
        the previous factor was dropped).

        With `signs`, the quasi-definite factorization `ldlt.factor_qd`
        runs instead, under `regimes.plan_qd` (in core, square, slabs
        assembled up front; BudgetError before anything is allocated when
        it does not fit).

        With `check=True`, every pivot is verified finite and positive
        afterwards and ArithmeticError names the first bad separator (the
        LAPACK `info`-style diagnosis; a signed factor's pivots are
        sqrt(s_j d_j), NaN where the signature does not fit). Off by
        default: the check reads each level's diagonals back to the
        host.

        `precision` overrides the solver's matmul rung for this and every
        later factorization (sticky, as in the JAX package: the solves
        apply the factor at the same rung). The factorization runs under
        the resolved rung (`numeric/precision.py`)."""
        if precision is not None:
            _check_precision(precision)
            self.precision = precision
        if self.factored:
            # drop the previous factor and its inverses before the budget
            # is read: the new factorization replaces them
            self.panels, self.factored, self._inv = None, False, None
        with _precision_ctx(self.precision):
            return self._factorize(check, level_hook)

    def _factorize(self, check: bool, level_hook):
        """The body of `factorize`, under the solver's rung."""
        # slabs the caller assembled (or None); only `pre` holds them now
        pre, self.panels, self._inv = self.panels, None, None
        t0 = time.perf_counter()
        budget = self._budget_bytes()
        kept = self._plans[1] if self._plans is not None else None
        plan = self._plan_override or self._plan(budget)
        reused = plan is kept
        self.regimes = plan
        plan_s = time.perf_counter() - t0
        # long-lived state, built once the plan fits, before the baseline
        self._assembler()
        if self.signs is not None:
            self._signature()
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
        fronts = pre if pre is not None else self._fronts(self.vals,
                                                           plan.lazy)
        del pre                 # the level loop consumes the slabs
        if self.signs is not None:
            self.panels = ldlt.factor_qd(self.fplan, fronts,
                                         self._signature(),
                                         level_hook=level_hook,
                                         mesh=self.mesh)
        else:
            self.panels = frontal.factor(
                self.fplan, fronts, plan, level_hook=level_hook,
                mesh=self.mesh, root=frontal.root_spec(self.fplan, self.mesh))
        self.factored = True
        if check:
            self._check_pivots()
        return self.panels

    def _level_diagonals(self):
        """(level, [B, W] f64 pivot diagonals) per level: one host transfer
        each; bf16 and host-resident levels are read through f32, sharded
        ones gathered."""
        for lvl, p in enumerate(self.panels):
            p = mesh_mod.local(p)
            w = int(self.fplan.W[lvl])
            if w == 0 or p.shape[0] == 0:
                continue
            d = torch.diagonal(p[:, :w, :w], dim1=1, dim2=2)
            if d.dtype == torch.bfloat16:
                d = d.to(torch.float32)
            yield lvl, d.cpu().numpy().astype(np.float64)

    def _check_pivots(self) -> None:
        """Raise if any factor pivot is non-finite or <= 0 (non-SPD input,
        or catastrophic cancellation in low precision)."""
        for lvl, d in self._level_diagonals():
            bad = ~(np.isfinite(d) & (d > 0))
            if bad.any():
                slot, idx = np.argwhere(bad)[0]
                what = ("not quasi-definite with the given signature"
                        if self.signs is not None else
                        "not positive definite")
                raise ArithmeticError(
                    f"factorization failed: non-positive/non-finite pivot at "
                    f"tree level {lvl}, separator slot {slot}, local dof "
                    f"{idx} — input matrix is {what} (or lost "
                    f"definiteness in {np.dtype(self.dtype).name})")

    def _signature(self) -> ldlt.DeviceSigns:
        """The quasi-definite signature on the device, built once per
        solver (it outlives update_values: the signature is the
        pattern's)."""
        if self._sig is None:
            with devmem.persistent(self.device):
                self._sig = ldlt.DeviceSigns(self.fplan, self.signs,
                                             self.device,
                                             TORCH_DTYPES[self.dtype])
        return self._sig

    def _require_spd(self, what: str) -> None:
        if self.signs is not None:
            raise NotImplementedError(
                f"{what} requires an SPD (Cholesky) factorization — this "
                f"solver holds a quasi-definite LDL^T factor")

    def _plan(self, budget: int) -> regimes.RegimePlan:
        """The regime plan of `budget`, searched once per budget. The
        default budget (no `budget` given) follows the card's free memory,
        which long-lived state (ELL planes, index maps) lowers a little
        between factorizations: a smaller default budget that the kept
        plan's peak still fits takes the kept plan. The search would return
        it: every option it passed over fits a smaller budget no better,
        and every level it chose still fits. (Not when the plan re-uploads
        offloaded levels: that choice reads the budget itself.)"""
        if self.signs is not None:
            if self._plans is None or self._plans[0] != budget:
                self._plans = (budget, regimes.plan_qd(self.fplan, self.dtype,
                                                       budget))
            return self._plans[1]
        if self._plans is not None:
            kept_budget, kept = self._plans
            if budget == kept_budget or (
                    self.budget is None and not kept.reupload
                    and kept.peak_bytes <= budget < kept_budget):
                return kept
        mesh = {} if self.mesh is None else {"mesh": self.mesh}
        self._plans = (budget, regimes.plan_regimes(self.fplan, self.dtype,
                                                    budget, **mesh))
        return self._plans[1]

    def _local_panels(self):
        """The factor with one tensor per level: under a mesh its sharded
        levels gathered onto the first slot's device (host memory for an
        offloaded level). Selected inversion, the Schur complement, the
        quasi-definite logdet, factor export and checkpoints read it."""
        return tuple(mesh_mod.local(p) for p in self.panels)

    def _factor_bytes(self) -> int:
        """Bytes of the stored factor on the solver's device (levels in host
        memory, and a mesh's parts on other devices, not counted)."""
        parts = [t for p in self.panels
                 for t in (p.parts if isinstance(p, mesh_mod.Sharded)
                           else [p])]
        return sum(t.numel() * t.element_size() for t in parts
                   if t.device == self.device)

    def _solve_fits(self, use_inv: bool, k: int = 1) -> bool:
        """Whether a refined solve of k right-hand sides fits the budget:
        the device-resident factor, with the banded engine the pivot
        inverses, and the working set of `regimes.solve_bytes` (ELL planes
        and the residual's temporaries, the [n, K, k] operands of a block
        among them; work vectors; the promotion of one bf16 or host
        level)."""
        fp = self.fplan
        tdt = TORCH_DTYPES[self.dtype]
        ell = self._ell_host()
        ell_k = ell[0].shape[1] if ell is not None else regimes.ELL_MAX_K
        need = (self._solve_residency(use_inv) + regimes.solve_bytes(
            fp.F, fp.W, tdt, ell_k, host_level=self._promote_bytes(), k=k))
        return need <= self._solve_budget()

    def _want_inv_pivots(self) -> bool:
        """Explicit pivot inverses when they fit the budget beside the
        factor and one solve's working set; the solve without inverses
        needs no extra residency."""
        return self._solve_fits(True)

    def _promote_bytes(self) -> int:
        """f32 bytes of the largest level a solve promotes or moves whole:
        one stored bf16 or held in host memory."""
        return max((p.numel() * 4 for p in self.panels
                    if p.device != self.device
                    or p.dtype == torch.bfloat16), default=0)

    def _inv_pivots(self):
        """Per-level pivot inverses, cached with the factorization."""
        if self._inv is None or self._inv[0] != id(self.panels):
            self._inv = None            # free stale inverses first
            with _precision_ctx(self.precision):
                inv = frontal.invert_pivots(self.fplan, self.panels,
                                            device=self.device)
            self._inv = (id(self.panels), inv)
        return self._inv[1]

    def _ell_host(self):
        """Double-float ELL planes of the symmetrized PERMUTED matrix on the
        host (None when a row is too dense)."""
        if self._ell is None:
            r, c, v = mmio.symmetrize_coo(self.rows, self.cols, self.vals)
            ell = refine_mod.build_ell(self.plan.n, self.plan.iperm[r],
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
            planes = refine_mod.pad_ell(self.fplan, ell) if banded else ell
            self._ell_dev = {}
            with devmem.persistent(self.device):
                self._ell_dev[banded] = (
                    torch.from_numpy(planes[0].astype(np.int64)).to(
                        self.device),
                    torch.from_numpy(planes[1]).to(self.device),
                    torch.from_numpy(planes[2]).to(self.device))
        return self._ell_dev[banded]

    def _solve_once(self, b: np.ndarray) -> np.ndarray:
        """One solve against the factor: b [n] or [n, k] -> x of the same
        shape (f64): the banded chain with pivot inverses when they fit the
        budget, else the solve without inverses. A block goes through in
        column chunks whose work vectors fit the budget."""
        use_inv = self._want_inv_pivots()
        _, iperm = self._perm_device()
        b2 = b.reshape(self.plan.n, -1)
        x = np.empty(b2.shape)
        step = self._solve_cols(b2.shape[1])
        for j in range(0, b2.shape[1], step):
            bp = self._permuted_on_device(b2[:, j:j + step], "b")
            sig = self._signature() if self.signs is not None else None
            if use_inv:
                xp = frontal._solve_banded(
                    self.fplan, self.panels, self._inv_pivots(), bp,
                    None if sig is None else sig.padded)
            elif sig is not None:
                xp = ldlt.solve_qd(self.fplan, self.panels, sig, bp)
            else:
                xp = frontal.frontal_solve(self.fplan, self.panels, bp)
            x[:, j:j + step] = xp[iperm].cpu().numpy()
        return x.reshape(b.shape)

    def _perm_device(self):
        """(perm, iperm) of the plan on the device: permuting a right-hand
        side and a solution there costs the host no pass over them."""
        return tuple(frontal._device_index(self.fplan, name, None,
                                           self.device)
                     for name in ("perm", "iperm"))

    def _solve_residency(self, use_inv: bool) -> int:
        """Device bytes of what a solve keeps beside its working set: the
        device-resident factor and, with the banded engine, the pivot
        inverses."""
        fp = self.fplan
        inv = regimes.inv_bytes(fp.F, fp.W, TORCH_DTYPES[self.dtype])
        return self._factor_bytes() + (inv if use_inv else 0)

    def _solve_budget(self) -> int:
        """The solve's budget on the solver's device: the factorization's
        (under a mesh, the slots' on that device together)."""
        budget = (self.regimes.budget if self.regimes is not None
                  else self._budget_bytes())
        if self.mesh is not None:
            budget *= self.mesh.slots_on(self.device)
        return budget

    def _solve_cols(self, k: int) -> int:
        """Columns per chunk of a block solve outside the device loop: as
        many as the budget leaves work vectors for beside the factor, the
        inverses and one solve's fixed working set (at least one)."""
        fp = self.fplan
        tdt = TORCH_DTYPES[self.dtype]
        room = (self._solve_budget()
                - self._solve_residency(self._want_inv_pivots())
                - regimes.solve_bytes(fp.F, fp.W, tdt, 0,
                                      host_level=self._promote_bytes()))
        more = room // regimes.solve_vector_bytes(fp.W, tdt)
        return int(max(1, min(k, 1 + more)))

    @_with_precision
    def solve(self, b: np.ndarray, refine: str = "auto", tol: float = 1e-10,
              max_iter: int = 50) -> np.ndarray:
        """Solve A x = b; b and x are in ORIGINAL dof order. b is one
        right-hand side [n] (or [n, 1]: x comes back [n]) or a block
        [n, k]; [n, 0] gives [n, 0].

        refine: 'auto' runs mixed-precision iterative refinement when the
        factor is below float64; 'never' applies the factor once; 'always'
        refines an f64 factor too (on the host: the device loop's
        double-float residual is built for f32 solves).

        An f32 factor (stored f32 or bf16, on the device or in host memory)
        is refined on the device (f32 solves, double-float residuals) to a
        relative residual of tol / 3, a block in one loop that stops on its
        worst column; should that not reach `tol`, or the block's residual
        temporaries not fit the budget, a host loop with an f64 CSR
        residual and block device solves continues. `last_solve` records
        the sweeps of each loop, the inner engine ("banded" with pivot
        inverses, "plain" without), the block width and which loop
        finished ("device", "host", or "none" without refinement). A
        quasi-definite solver refines the same way through its signed
        solve."""
        if refine not in ("auto", "never", "always"):
            raise ValueError(f"refine must be 'auto', 'never' or 'always', "
                             f"got {refine!r}")
        b = np.asarray(b, dtype=np.float64)
        if b.ndim not in (1, 2) or b.shape[0] != self.plan.n:
            raise ValueError(f"b must be [{self.plan.n}] or "
                             f"[{self.plan.n}, k], got {b.shape}")
        if b.ndim == 2 and b.shape[1] == 1:
            b = b.reshape(-1)
        if not self.factored:
            self.factorize()
        k = b.shape[1] if b.ndim == 2 else 1
        use_inv = self._want_inv_pivots()
        self.last_solve = {"sweeps": 0, "host_sweeps": 0, "k": k,
                           "engine": "banded" if use_inv else "plain",
                           "loop": "none"}
        if k == 0:
            return np.zeros((self.plan.n, 0))
        want_ir = refine == "always" or (
            refine == "auto" and self.dtype != np.float64)
        if not want_ir:
            return self._solve_once(b)
        x = None
        ell = (self._ell_device(use_inv) if self.dtype == np.float32
               else None)
        if ell is not None and k > 1 and not self._solve_fits(use_inv, k):
            ell = None          # a very wide block: the host loop below
        if ell is not None:
            # the device loop targets tol/3: its f32 residual-norm estimate
            # can sit slightly above the true f64 residual
            loop = (refine_mod.solve_refined_df if b.ndim == 1
                    else refine_mod.solve_refined_df_multi)
            perm, iperm = self._perm_device()
            x_perm, sweeps, rn_rel = loop(
                self.fplan, self.panels,
                self._inv_pivots() if use_inv else None,
                torch.from_numpy(b).to(self.device)[perm], ell,
                tol=tol / 3.0, max_iter=max_iter,
                signs=self._signature() if self.signs is not None else None)
            x = x_perm[iperm].cpu().numpy()
            del x_perm
            self.last_solve.update(sweeps=sweeps, rn_rel=rn_rel,
                                   loop="device")
            if rn_rel <= tol:
                return x
        a = self._matrix_csr()
        bnorm = np.linalg.norm(b, axis=0)
        if x is None:
            x = self._solve_once(b)
        self.last_solve["loop"] = "host"
        for _ in range(max_iter):
            r = b - a @ x
            if np.all(np.linalg.norm(r, axis=0) <= tol * bnorm):
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

    # ------------------------------------------------------------------
    def logdet(self) -> float:
        """log det(A) = 2 sum log diag(L), read off the factor's per-level
        pivot blocks (bf16 and host-resident levels included). Padded
        diagonal entries are exactly 1 and contribute nothing. A
        quasi-definite solver raises ValueError (its det may be negative:
        `slogdet`)."""
        if self.signs is not None:
            raise ValueError(
                "quasi-definite matrix: det may be negative — use slogdet()")
        if not self.factored:
            self.factorize()
        return 2.0 * sum(float(np.log(d).sum())
                         for _, d in self._level_diagonals())

    def slogdet(self):
        """(sign, log|det A|), like numpy.linalg.slogdet, read off the
        factor: SPD gives (1, logdet()); a quasi-definite factorization
        gives sign = (-1)^(negatives in the signature) (the signature IS
        the inertia, Sylvester's law through L~ S L~^T)."""
        if self.signs is None:
            return 1, self.logdet()
        if not self.factored:
            self.factorize()
        return ldlt.logdet_qd(self.fplan, self._local_panels(), self.signs)

    def inertia(self):
        """(n+, n-, n0) of the factored matrix: the quasi-definite
        signature for LDL^T, (n, 0, 0) for SPD. Interior-point methods use
        it to verify a KKT system's expected inertia."""
        if self.signs is None:
            return int(self.plan.n), 0, 0
        return ldlt.inertia(self.signs)

    def factor_dense(self) -> np.ndarray:
        """The factor L as a dense lower-triangular array in permuted
        coords."""
        if not self.factored:
            self.factorize()
        return frontal.extract_factor_dense(self.fplan, self.panels)

    def factor_coo(self):
        """The factor L as COO (0-based permuted coordinates, lower
        triangle): scales to problems where a dense n^2 factor is
        infeasible."""
        if not self.factored:
            self.factorize()
        return frontal.extract_factor_coo(self.fplan, self.panels)

    def permuted_dense(self) -> np.ndarray:
        """The permuted (unfactored) matrix, lower triangle, dense: what
        the CLI's -p writes. Built from the COO entries and the plan's
        inverse permutation."""
        n = int(self.plan.n)
        pr, pc = self.plan.iperm[self.rows], self.plan.iperm[self.cols]
        dense = np.zeros((n, n))
        dense[np.maximum(pr, pc), np.minimum(pr, pc)] = self.vals
        return dense

    def aslinearoperator(self, inverse: bool = True, tol: float = 1e-10):
        """A scipy.sparse.linalg.LinearOperator view of A^-1 (default) or A,
        in original dof order: plugs the factored solver into any scipy
        iterative code as a black-box preconditioner/operator
        (`eigsh(..., OPinv=s.aslinearoperator())`, `cg(..., M=...)`). Each
        `matvec` of the inverse operator is one refined solve through the
        factor; `matmat` maps to the block solve."""
        import scipy.sparse.linalg

        n = int(self.plan.n)
        if inverse:
            if not self.factored:
                self.factorize()
            return scipy.sparse.linalg.LinearOperator(
                (n, n), dtype=np.float64,
                matvec=lambda v: self.solve(np.asarray(v).reshape(n),
                                            tol=tol),
                matmat=lambda V: self.solve(np.asarray(V),
                                            tol=tol).reshape(n, -1))
        return scipy.sparse.linalg.aslinearoperator(self._matrix_csr())

    # ------------------------------------------------------------------
    # Selected inversion, value gradients, sampling (`api.py:820-1128` of
    # the JAX package)

    def _resident_bytes(self) -> int:
        """Device bytes the factorization keeps: the device-resident factor
        levels and the cached pivot inverses."""
        if self.panels is None:
            return 0
        inv = sum(t.numel() * t.element_size() for t in self._inv[1]) \
            if self._inv is not None else 0
        return self._factor_bytes() + inv

    def _selinv_guard(self) -> int:
        """Selected inversion is in-core only: the stored factor and the
        recursion's working set (`regimes.selinv_bytes`: two adjacent
        levels of front-inverse blocks and the gathered transients) must
        fit the budget of the factorization. Raises `regimes.BudgetError`
        with the bytes and the budget, before any device allocation; a
        larger `budget=` is the override. `selinv_stats` keeps both
        numbers. Returns the estimate."""
        fp = self.fplan
        dt = selinv.compute_dtype(self.panels)
        # a sharded level is gathered onto the device: a copy, as a
        # promotion is
        promoted = [isinstance(p, mesh_mod.Sharded) or p.device != self.device
                    or p.dtype != dt for p in self.panels]
        need = regimes.selinv_bytes(fp.F, fp.W, dt, self._resident_bytes(),
                                    promoted)
        budget = self._solve_budget()
        self.selinv_stats = {"estimate": need, "budget": budget}
        if need > budget:
            raise regimes.BudgetError(
                f"selected inversion needs ~{need} bytes (the stored factor "
                f"and two adjacent levels of front-inverse blocks with their "
                f"gathers) but the budget is {budget} bytes; it has no "
                f"streamed path: pass a larger budget= if the device has "
                f"the room")
        return need

    @_with_precision
    def inv_diag(self) -> np.ndarray:
        """diag(A^-1) in original dof order, by selected inversion on the
        factor (`numeric/selinv.py`): a top-down batched recursion over the
        separator tree that never forms A^-1 or solves n right-hand sides.
        Marginal variances of a GMRF / GP posterior (A the precision
        matrix), leverage scores, error estimation. Accuracy follows the
        factor precision (f64 factor ~1e-13 relative; f32 ~kappa(A) 1e-7).
        In core only: raises `regimes.BudgetError` when it does not fit
        the budget. A mesh's factor is gathered onto the first slot's
        device first (the recursion is not sharded)."""
        self._require_spd("selected inversion")
        if not self.factored:
            self.factorize()
        self._selinv_guard()
        out = np.empty(self.plan.n)
        out[self.plan.perm] = selinv.selinv_diag(
            self.fplan, self._local_panels(), device=self.device)
        return out

    @_with_precision
    def inv_entries(self, rows, cols) -> np.ndarray:
        """Selected entries (A^-1)[rows[k], cols[k]] in original dof order,
        for entries within the factor pattern (L + L^T + I): covariances
        between coupled sites of a GMRF, off-diagonal posterior terms. The
        recursion of inv_diag, stopped at the deepest requested tree level.
        Entries outside the pattern raise ValueError (solve unit vectors
        for those)."""
        self._require_spd("selected inversion")
        if not self.factored:
            self.factorize()
        self._selinv_guard()
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        return selinv.selinv_entries(
            self.fplan, self._local_panels(), self.plan.iperm[rows],
            self.plan.iperm[cols], device=self.device)

    @_with_precision
    def logdet_grad(self) -> np.ndarray:
        """d logdet(A) / dv, aligned with coo_pattern(): d logdet =
        tr(A^-1 dA), and entry v_k stands at (r_k, c_k) and (c_k, r_k), so
        the gradient is 2 (A^-1)[r_k, c_k] off the diagonal and
        (A^-1)[r_k, r_k] on it. The inverse entries come from selected
        inversion (A's pattern lies inside the factor's), so the cost is
        about one factorization-shaped pass, not n solves; the memory is
        selected inversion's (in core)."""
        self._require_spd("logdet_grad")
        g = self.inv_entries(self.rows, self.cols)
        return np.where(self.rows == self.cols, g, 2.0 * g)

    @_with_precision
    def solve_grad(self, b: np.ndarray, xbar: np.ndarray,
                   x: Optional[np.ndarray] = None, tol: float = 1e-12):
        """Adjoint of x = A^-1 b: given the cotangent xbar = df/dx of a
        scalar f(x), returns (vbar, bbar) with

            bbar   = A^-1 xbar                                 (df/db)
            vbar_k = -(lam[r_k] x[c_k] + lam[c_k] x[r_k])   off the diagonal
                     -lam[r_k] x[r_k]                       on it

        (lam = bbar), aligned with coo_pattern(): the implicit-function
        adjoint dA -> -lam x^T restricted to the symmetric pattern. Pass x
        if it is already computed (saves one solve)."""
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        if x is None:
            x = self.solve(b, tol=tol)
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        lam = np.asarray(self.solve(np.asarray(xbar, dtype=np.float64)
                                    .reshape(-1), tol=tol))
        r, c = self.rows, self.cols
        vbar = -(lam[r] * x[c] + lam[c] * x[r])
        vbar[r == c] = -(lam[r] * x[r])[r == c]
        return vbar, lam

    @_with_precision
    def quadform_grad(self, b: np.ndarray, x: Optional[np.ndarray] = None,
                      tol: float = 1e-12) -> np.ndarray:
        """d(b^T A^-1 b) / dv aligned with coo_pattern(): -x_r x_c, doubled
        off the diagonal (x = A^-1 b). One solve; with logdet_grad, the
        whole gradient of a GP's evidence."""
        self._require_spd("quadform_grad")
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        if x is None:
            x = self.solve(b, tol=tol)
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        r, c = self.rows, self.cols
        g = -2.0 * x[r] * x[c]
        g[r == c] = -(x[r] * x[r])[r == c]
        return g

    def _permuted_on_device(self, v: np.ndarray, what: str) -> torch.Tensor:
        """[n] or [n, k] in original order -> the permuted rows on the
        device, in the factor's dtype."""
        v = np.asarray(v, dtype=np.float64)
        if v.ndim not in (1, 2) or v.shape[0] != self.plan.n:
            raise ValueError(f"{what} must be [{self.plan.n}] or "
                             f"[{self.plan.n}, k], got {v.shape}")
        perm, _ = self._perm_device()
        return torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device)[perm].to(TORCH_DTYPES[self.dtype])

    @_with_precision
    def sample(self, z: np.ndarray) -> np.ndarray:
        """Samples with covariance A^-1 from standard-normal draws: with
        A_perm = L L^T, x_perm = L^-T z has covariance A_perm^-1 (the
        sparse Cholesky sampler of GMRF / GP posteriors, A the precision
        matrix; moments from inv_diag / inv_entries, draws from here). `z`
        is [n] or [n, k] standard normal; returns f64 samples of the same
        shape in ORIGINAL dof order. Computed in the factor's dtype (f32:
        covariance error ~1e-7 relative, far below sampling noise)."""
        self._require_spd("sample")
        if not self.factored:
            self.factorize()
        zp = self._permuted_on_device(z, "z")
        xp = frontal.frontal_upper_solve(self.fplan, self.panels, zp)
        _, iperm = self._perm_device()
        return xp[iperm].to(torch.float64).cpu().numpy()

    @_with_precision
    def whiten(self, x: np.ndarray) -> np.ndarray:
        """The inverse transform of sample(): z = L^T P x. For x ~
        N(0, A^-1) in original dof order the result is standard normal
        (residual whitening, standardized innovations for model checking).
        `x` is [n] or [n, k]; whiten(sample(z)) == z coordinate-wise."""
        self._require_spd("whiten")
        if not self.factored:
            self.factorize()
        xp = self._permuted_on_device(x, "x")
        zp = frontal.frontal_upper_matvec(self.fplan, self.panels, xp)
        _, iperm = self._perm_device()
        return zp[iperm].to(torch.float64).cpu().numpy()

    # ------------------------------------------------------------------
    # Static condensation (`api.py:888-968` of the JAX package): the Schur
    # complement of A onto the ROOT separator dofs. The caller chooses the
    # interface by making it the root separator of the ordering (from_coo
    # with an Ordering of one's own puts any dof set there).

    def _root_extent(self):
        root = self.plan.tree.sep_at(0, 0)
        return int(self.plan.sep_offset[root]), int(self.plan.sep_sizes[root])

    def schur_dofs(self) -> np.ndarray:
        """Original dof ids of the root separator: the index set of the
        schur_complement() / condense_rhs() entries, in their row order."""
        off, sz = self._root_extent()
        return self.plan.perm[off:off + sz]

    @_with_precision
    def schur_complement(self) -> np.ndarray:
        """Dense Schur complement S = A_rr - A_ro A_oo^-1 A_or of A onto
        the root separator dofs (rows / cols ordered as schur_dofs()). The
        fully assembled root front IS this Schur complement and the factor
        stores its Cholesky L_S, so S = L_S L_S^T costs one product, no
        refactorization: the root's pivot block is promoted to f64 on the
        device (from bf16 or host memory too) before it. Accuracy follows
        the factor (f64 to roundoff, f32 ~1e-7 relative)."""
        self._require_spd("schur_complement")
        if not self.factored:
            self.factorize()
        _, sz = self._root_extent()
        ld = mesh_mod.local(self.panels[0])[0, :sz, :sz].to(
            self.device, torch.float64)
        ld = ld.tril()
        return (ld @ ld.T).cpu().numpy()

    @_with_precision
    def condense_rhs(self, b: np.ndarray) -> np.ndarray:
        """Condensed right-hand side b_hat = b_r - A_ro A_oo^-1 b_o of the
        interface system S x_r = b_hat (forward substitution over the
        interior levels, `frontal.forward_partial`). `b` is the FULL rhs
        [n] in original dof order; the result is ordered as
        schur_dofs()."""
        self._require_spd("condense_rhs")
        if not self.factored:
            self.factorize()
        bg = frontal.forward_partial(
            self.fplan, self.panels,
            self._permuted_on_device(np.asarray(b).reshape(-1), "b"))
        off, sz = self._root_extent()
        return bg[off:off + sz].to(torch.float64).cpu().numpy()

    @_with_precision
    def expand_solution(self, b: np.ndarray, x_root: np.ndarray
                        ) -> np.ndarray:
        """The full solution from an interface solution: given x_r solving
        S x_r = condense_rhs(b) (by any external solver), back-substitute
        the interior, x_o = A_oo^-1 (b_o - A_or x_r). Returns x in original
        dof order. The (b, x_root) pair must be consistent: the interior
        recovery reuses the partial forward pass of b."""
        self._require_spd("expand_solution")
        if not self.factored:
            self.factorize()
        _, sz = self._root_extent()
        x_root = np.asarray(x_root, dtype=np.float64).reshape(-1)
        if x_root.shape[0] != sz:
            raise ValueError(
                f"x_root has {x_root.shape[0]} entries; root separator "
                f"has {sz}")
        bg = frontal.forward_partial(
            self.fplan, self.panels,
            self._permuted_on_device(np.asarray(b).reshape(-1), "b"))
        xr = bg.new_zeros(self.fplan.W[0])
        xr[:sz] = torch.from_numpy(x_root).to(xr.device, xr.dtype)
        xp = frontal.backward_partial(self.fplan, self.panels, bg, xr)
        _, iperm = self._perm_device()
        return xp[iperm].to(torch.float64).cpu().numpy()

    # ------------------------------------------------------------------
    # Low-rank updates and perturbations reusing the factor (`api.py:
    # 1131-1264` of the JAX package)

    @staticmethod
    def _update_weights(u, w):
        u = np.asarray(u, dtype=np.float64)
        if u.ndim == 1:
            u = u[:, None]
        k = u.shape[1]
        w = np.broadcast_to(np.asarray(1.0 if w is None else w,
                                       dtype=np.float64), (k,))
        if np.any(w == 0.0):
            raise ValueError("update weights must be nonzero")
        return u, w

    @_with_precision
    def solve_updated(self, b: np.ndarray, u: np.ndarray, w=None,
                      tol: float = 1e-12) -> np.ndarray:
        """Solve (A + U diag(w) U^T) x = b by the Woodbury identity, reusing
        the factorization of A (no refactorization for low-rank changes:
        observation insertion / deletion, regularizer or boundary-condition
        tweaks, GP inducing-point updates):

            M^-1 b = A^-1 b - A^-1 U (diag(w)^-1 + U^T A^-1 U)^-1 U^T A^-1 b

        U is [n, k] (or [n] for k = 1) in original dof order; w a scalar or
        [k] of weights (negative entries down-date; A + U diag(w) U^T must
        stay nonsingular: a singular capacitance matrix raises LinAlgError).
        b is [n] or [n, m]. Cost: one k-column block solve, one solve of b
        and an O(k^3) dense solve. Runs on a quasi-definite solver too."""
        u, w = self._update_weights(u, w)
        k = u.shape[1]
        # solve() squeezes a [n, 1] block to [n]; restore the column axis
        ainv_u = np.asarray(self.solve(u, tol=tol)).reshape(self.plan.n, k)
        x = self.solve(b, tol=tol)
        cap = np.diag(1.0 / w) + u.T @ ainv_u            # [k, k] capacitance
        return x - ainv_u @ np.linalg.solve(cap, u.T @ x)

    @_with_precision
    def logdet_updated(self, u: np.ndarray, w=None, tol: float = 1e-12
                       ) -> float:
        """log det(A + U diag(w) U^T) by the matrix determinant lemma,
        reusing the factor (the companion of solve_updated, e.g. GP evidence
        under observation updates):

            log det M = log det A + sum log w
                        + log det(diag(w)^-1 + U^T A^-1 U)

        Raises ArithmeticError when the update makes the matrix lose
        positive definiteness (a negative determinant sign)."""
        self._require_spd("logdet_updated")
        u, w = self._update_weights(u, w)
        ainv_u = np.asarray(self.solve(u, tol=tol)).reshape(self.plan.n,
                                                            u.shape[1])
        sign, logabs = np.linalg.slogdet(np.diag(1.0 / w) + u.T @ ainv_u)
        if sign * float(np.prod(np.sign(w))) <= 0:
            raise ArithmeticError(
                "A + U diag(w) U^T is not positive definite")
        return float(self.logdet() + np.log(np.abs(w)).sum() + logabs)

    @_with_precision
    def solve_perturbed(self, b: np.ndarray, rows: np.ndarray,
                        cols: np.ndarray, vals: np.ndarray,
                        tol: float = 1e-10, max_iter: int = 200
                        ) -> np.ndarray:
        """Solve (A + dA) x = b for a GENERAL symmetric perturbation dA
        without refactorizing: conjugate gradients preconditioned by this
        factor (one sparse f64 matvec and one solve through the factor an
        iteration). The complement of solve_updated's low-rank path, for
        coefficients that drift everywhere but stay close enough that the
        old factor keeps the preconditioned spectrum clustered; when the
        iteration counts grow, refactor with update_values.

        dA is COO in the input's lower-triangle convention (rows >= cols;
        off-diagonal entries imply their transposes); A + dA must stay SPD.
        b is [n] or [n, k] in original dof order. The flexible
        (Polak-Ribiere) update keeps an f32 preconditioner from stalling.
        Converges to ||(A + dA) x - b|| / ||b|| <= tol or raises
        RuntimeError. `last_perturbed` keeps the iterations of each
        column."""
        self._require_spd("solve_perturbed")
        if not self.factored:
            self.factorize()
        import scipy.sparse

        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        if np.any(rows < cols):
            raise ValueError(
                "perturbation must be lower-triangle COO (rows >= cols), "
                "matching the input matrix convention")
        dr, dc, dv = mmio.symmetrize_coo(rows, cols, vals)
        a_pert = self._matrix_csr() + scipy.sparse.csr_matrix(
            (dv, (dr, dc)), shape=(self.plan.n, self.plan.n))
        b = np.asarray(b, dtype=np.float64)
        cols_b = b.reshape(self.plan.n, -1)
        x = np.empty_like(cols_b)
        self.last_perturbed = {"iterations": []}
        for j in range(cols_b.shape[1]):
            x[:, j] = self._pcg(a_pert, cols_b[:, j], tol, max_iter)
        return x.reshape(b.shape)

    def _pcg(self, a, b: np.ndarray, tol: float, max_iter: int) -> np.ndarray:
        """Flexible PCG for a x = b with this factor as the preconditioner
        (`api.py:1203-1234` of the JAX package)."""
        bnorm = float(np.linalg.norm(b))
        if bnorm == 0.0:
            self.last_perturbed["iterations"].append(0)
            return np.zeros_like(b)
        x = np.zeros_like(b)
        r = b.copy()
        z = self._solve_once(r)
        p = z.copy()
        rz = float(r @ z)
        for it in range(max_iter):
            ap = a @ p
            pap = float(p @ ap)
            if pap <= 0.0:
                raise RuntimeError(
                    "CG direction with non-positive curvature — the "
                    "perturbed matrix is not positive definite")
            alpha = rz / pap
            x += alpha * p
            r_new = r - alpha * ap
            if np.linalg.norm(r_new) <= tol * bnorm:
                self.last_perturbed["iterations"].append(it + 1)
                return x
            z_new = self._solve_once(r_new)
            # flexible (Polak-Ribiere) beta: robust to the inexact,
            # slightly nonsymmetric f32 preconditioner solve
            beta = float(z_new @ (r_new - r)) / rz
            rz = float(r_new @ z_new)
            p = z_new + beta * p
            r = r_new
        raise RuntimeError(
            f"solve_perturbed did not reach tol={tol:g} in {max_iter} "
            f"iterations (relative residual "
            f"{np.linalg.norm(r) / bnorm:.3e}) — the perturbation is too "
            f"large for this factor; refactor with update_values")

    # ------------------------------------------------------------------
    # Spectra through the factor (`api.py:1320-1389`; `numeric/eigs.py`)

    @_with_precision
    def eigsh(self, k: int = 6, which: str = "smallest", tol: float = 1e-9,
              m: Optional[int] = None, seed: int = 0, M=None):
        """k extremal eigenpairs of A (eigenvalues ascending, orthonormal
        eigenvectors [n, k]), converged to ||A v - lambda v|| <= tol
        ||A||_1. which='smallest' runs shift-invert Lanczos at sigma = 0,
        one refined solve through the factor a step (SPD only);
        which='largest' needs only sparse matvecs (quasi-definite solvers
        too). M (scipy sparse or dense, symmetric positive definite): the
        generalized pencil A x = lambda M x (the FEM modal problem), with
        M-inner-product Lanczos and mass-normalized eigenvectors."""
        from cholesky_tpu_torch.numeric import eigs

        if which == "smallest":
            self._require_spd("eigsh(which='smallest') (shift-invert)")
            if not self.factored:
                self.factorize()
        return eigs.eigsh(self, k=k, which=which, tol=tol, m=m, seed=seed,
                          M=M)

    @_with_precision
    def condest(self, iters: int = 12, seed: int = 0,
                method: str = "power") -> float:
        """2-norm condition-number estimate kappa_2(A) ~ lambda_max /
        lambda_min by power iteration: lambda_max on A (sparse matvecs),
        1 / lambda_min on A^-1 (solves through the factor), `iters` of each.
        method='lanczos' converges both ends with Lanczos instead
        (`numeric/eigs.cond2`; SPD only), tighter where either end
        clusters."""
        if not self.factored:
            self.factorize()
        if method == "lanczos":
            from cholesky_tpu_torch.numeric import eigs

            self._require_spd("condest(method='lanczos')")
            return eigs.cond2(self, seed=seed)
        a = self._matrix_csr()
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(self.plan.n)
        v /= np.linalg.norm(v)
        lam_max = 0.0
        for _ in range(iters):
            w = a @ v
            lam_max = float(np.linalg.norm(w))
            if lam_max == 0.0:
                break
            v = w / lam_max
        v = rng.standard_normal(self.plan.n)
        v /= np.linalg.norm(v)
        inv_max = 0.0
        for _ in range(iters):
            w = self._solve_once(v)
            inv_max = float(np.linalg.norm(w))
            if not np.isfinite(inv_max) or inv_max == 0.0:
                return float("inf")
            v = w / inv_max
        return lam_max * inv_max

    # ------------------------------------------------------------------
    # Same-pattern families (`api.py:1014-1066` of the JAX package)

    def _family_budget(self) -> int:
        """What a family may hold (per slot under a mesh): the solver's
        budget less its own resident factor (the default budget reads the
        card's free memory now, which that factor has already left)."""
        if self.budget is None:
            return self._budget_bytes()
        slots = self.mesh.size if self.mesh is not None else 1
        return self._budget_bytes() - self._resident_bytes() // slots

    def _family_plan(self, K: int) -> regimes.RegimePlan:
        """The regime plan of K systems at batch K 2^lvl, in core: square or
        two-piece levels, factor stored in the compute dtype on the device,
        no chunks, no offload (under a mesh one slot's, at K / ndev
        systems). Raises BudgetError naming K when neither it nor the
        family's factor beside its solve fits the budget."""
        fp = self.fplan
        tdt = TORCH_DTYPES[self.dtype]
        budget = self._family_budget()
        ks = K // self.mesh.size if self.mesh is not None else K
        try:
            plan = regimes.plan_regimes(
                fp, self.dtype, budget, family=K, store_dtype=tdt,
                offload=False, spill=False, mesh=self.mesh,
                chunks=dict.fromkeys(range(fp.levels), 1))
        except regimes.BudgetError as e:
            raise regimes.BudgetError(
                f"factorize_many: a family of K = {K} systems does not fit "
                f"in core in the budget of {budget} bytes ({e}); split the "
                f"family into smaller ones") from None
        sym = np.concatenate([self.rows, self.cols[self.rows != self.cols]])
        ell_k = min(int(np.bincount(sym, minlength=self.plan.n).max()),
                    regimes.ELL_MAX_K)
        need = (regimes.stored_bytes(fp.F, fp.W, plan.levels, K, self.mesh)
                + regimes.solve_bytes(fp.F, fp.W, tdt, ell_k, k=ks,
                                      promote=False))
        if need > budget:
            raise regimes.BudgetError(
                f"factorize_many: the factors of a family of K = {K} "
                f"systems and their solve need {need} bytes, over the "
                f"budget of {budget} bytes; split the family into smaller "
                f"ones")
        return plan

    @_with_precision
    def factorize_many(self, vals_many) -> "BatchedFactors":
        """Factor K matrices that share THIS solver's sparsity pattern as
        one family: `vals_many` is [K, nnz] aligned with coo_pattern().
        The family is folded into the batch axis of every level (level lvl
        holds K 2^lvl fronts), so one level loop factors all K and the
        kernel route decides on the folded batch: a family of GP
        hyperparameter candidates, MCMC proposals or time steps runs wider
        batches than one system does. Returns a BatchedFactors handle
        (solve / residual / logdet per system); this solver's own factor
        state is untouched. In core only: `regimes.BudgetError` (naming K)
        when the family does not fit the budget.

        Under a mesh the SYSTEM axis shards over the slots: each slot
        factors K / ndev whole systems on its device, with no traffic
        between slots. A K that the slot count does not divide is padded
        with copies of the last system (at most ndev - 1 redundant
        factorizations; `BatchedFactors.pad`), and every result is cut back
        to K."""
        self._require_spd("factorize_many")
        vals_many = np.asarray(vals_many, dtype=np.float64)
        if (vals_many.ndim != 2 or vals_many.shape[0] < 1
                or vals_many.shape[1] != self.vals.shape[0]):
            raise ValueError(
                f"vals_many must be [K, {self.vals.shape[0]}] aligned with "
                f"coo_pattern(); got {vals_many.shape}")
        K = vals_many.shape[0]
        pad = (-K) % self.mesh.size if self.mesh is not None else 0
        vals_padded = np.concatenate(
            [vals_many, np.repeat(vals_many[-1:], pad, axis=0)]) \
            if pad else vals_many
        plan = self._family_plan(K + pad)
        asm = self._assembler()
        if self.mesh is not None:
            fronts = asm(vals_padded, dtype=self.dtype, family=K + pad)
        else:
            fronts = (asm.lazy if plan.lazy else asm)(vals_many,
                                                      dtype=self.dtype)
        fp = frontal.FamilyView(self.fplan, K + pad)
        factors = frontal.factor(fp, fronts, plan, mesh=self.mesh)
        return BatchedFactors(self, fp, factors, vals_many, plan, pad=pad)

    # ------------------------------------------------------------------
    def _factor_fingerprint(self) -> str:
        """Identity of (matrix, ordering, dtype) a saved factor binds to:
        the JAX package's hash over the same fields."""
        h = hashlib.sha256()
        h.update(np.int64(self.plan.n).tobytes())
        h.update(np.ascontiguousarray(self.plan.perm, dtype=np.int64).tobytes())
        # panel layout: sep boundaries + padded bucket shapes (covers pad_to:
        # same perm with different padding yields incompatible panel shapes)
        for arr in (self.plan.sep_sizes, self.plan.S, self.plan.H,
                    self.rows, self.cols):
            h.update(np.ascontiguousarray(arr, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.vals, dtype=np.float64).tobytes())
        h.update(str(np.dtype(self.dtype)).encode())
        h.update(b"frontal")        # engine tag kept for checkpoint compat
        return h.hexdigest()

    @staticmethod
    def _npz_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save_factor(self, path: str) -> str:
        """Checkpoint the completed factorization to `path` (.npz): the
        factored per-level panels plus a fingerprint binding them to this
        exact matrix/ordering/dtype, in the JAX package's layout (version
        2), so either package loads it. Levels held in host memory are
        saved from there. bf16 levels are stored as their bit patterns
        (uint16). The meta record names the rung the factor was built at
        (`"precision"`, the `precision` property). Returns the written
        path."""
        self._require_spd("save_factor/load_factor")
        if not self.factored:
            self.factorize()
        arrays, dtypes = {}, []
        for i, p in enumerate(self._local_panels()):
            if p.dtype == torch.bfloat16:
                dtypes.append("bfloat16")
                arrays[f"panel_{i}"] = p.cpu().view(torch.int16).numpy().view(
                    np.uint16)
            else:
                a = p.cpu().numpy()
                dtypes.append(str(a.dtype))
                arrays[f"panel_{i}"] = a
        meta = {"version": 2, "engine": "frontal", "storage": "bits",
                "n_panels": len(dtypes), "panel_dtypes": dtypes,
                "fingerprint": self._factor_fingerprint(),
                # the rung the factor was built at: a loader applies its
                # solves at the same one (None: the one-pass rung)
                "precision": self.precision}
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
        path = self._npz_path(path)
        # uncompressed: factor panels are high-entropy floats
        np.savez(path, **arrays)
        return path

    def load_factor(self, path: str) -> None:
        """Load a factorization written by `save_factor` (of either
        package). Refuses a factor whose fingerprint does not match this
        solver's matrix/ordering/dtype (a mismatched factor would silently
        solve the wrong system). Each level keeps its stored dtype and goes
        where the regime plan of this solver's budget puts it: on the
        device, or in host memory for levels the plan offloads. A solver
        without an explicit `precision` takes the checkpoint's rung
        (`meta["precision"]`); a checkpoint without the key gets AUTO's
        answer on this plan. Under a mesh the levels are placed on the
        slots as a factorization leaves them."""
        self._require_spd("save_factor/load_factor")
        with np.load(self._npz_path(path)) as data:
            meta = json.loads(bytes(data["meta"].tobytes()).decode())
            if meta.get("fingerprint") != self._factor_fingerprint():
                raise ValueError(
                    "saved factor does not match this solver's "
                    "matrix/ordering/dtype/engine")
            self.panels, self.factored, self._inv = None, False, None
            plan = self._plan_override or self._plan(self._budget_bytes())
            panels = []
            for i in range(meta["n_panels"]):
                a = data[f"panel_{i}"]
                want = meta["panel_dtypes"][i]
                if meta.get("storage") == "bits" and a.dtype == np.uint16:
                    t = torch.from_numpy(a.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(a.astype(np.dtype(want)))
                host = plan.levels[i].offload and not plan.reupload
                if self.mesh is not None:
                    t = mesh_mod.distribute(
                        t, mesh_mod.panel_sharding(self.mesh, i), self.mesh)
                    if host:
                        t = (t.map(torch.Tensor.cpu)
                             if isinstance(t, mesh_mod.Sharded) else t.cpu())
                    panels.append(t)
                else:
                    panels.append(t if host else t.to(self.device))
        self.regimes = plan
        # pin the factor's rung BEFORE factored=True: its solves apply at
        # the rung it was built at, not at AUTO's answer in this process
        if self._precision is None:
            if "precision" in meta:
                self._precision_resolved = meta["precision"]
            else:
                _ = self.precision      # resolve while factored is False
        self.panels = tuple(panels)
        self.factored = True

    def residual(self, b: np.ndarray, x: np.ndarray) -> float:
        """Relative residual ||Ax-b|| / ||b|| against the original matrix,
        in f64 on the host. For a block ([n, k] b and x) this is the WORST
        column's relative residual: the gate every column must meet."""
        b = np.asarray(b, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        if b.ndim == 2 and b.shape[1] > 1:
            r = self._matrix_csr() @ x - b
            bn = np.linalg.norm(b, axis=0)
            bn = np.where(bn > 0, bn, 1.0)
            return float((np.linalg.norm(r, axis=0) / bn).max())
        b = b.reshape(-1)
        ax = self._matrix_csr() @ x.reshape(-1)
        return float(np.linalg.norm(ax - b) / np.linalg.norm(b))


class BatchedFactors:
    """K same-pattern factorizations (`SparseCholesky.factorize_many`):
    per-system solve (with mixed-precision refinement of an f32 family),
    residual and logdet. `factors[lvl]` is the folded [K 2^lvl, F, W]
    level on the device (system k's fronts at rows [k 2^lvl, (k + 1)
    2^lvl)), `Sharded` by systems under a mesh; `regimes` the plan it was
    factored under. `pad`: copies of the last system that make the family
    divisible over a mesh; every result is cut back to K."""

    def __init__(self, solver: SparseCholesky, fp, factors, vals_many,
                 plan: regimes.RegimePlan, pad: int = 0):
        self._s = solver
        self.fp = fp                    # frontal.FamilyView of K + pad
        self.factors = factors
        self.vals_many = vals_many      # [K, nnz] f64, solver's coo_pattern
        self.k = int(vals_many.shape[0])
        self.pad = pad
        self.regimes = plan
        self.last_solve = {}
        self._csr = None
        self._ell = None                # device ELL planes, or False

    def _csr_family(self):
        """One CSR structure shared by the family, and the map from the
        pattern-aligned values to CSR data order."""
        if self._csr is None:
            import scipy.sparse

            s = self._s
            nnz = s.vals.shape[0]
            sr, sc, sidx = mmio.symmetrize_coo(
                s.rows, s.cols, np.arange(nnz, dtype=np.float64))
            csr = scipy.sparse.coo_matrix(
                (np.arange(len(sr), dtype=np.float64), (sr, sc)),
                shape=(s.plan.n, s.plan.n)).tocsr()
            # csr.data holds the symmetrized entry at each CSR slot; through
            # sidx, the pattern entry
            self._csr = (csr, sidx.astype(np.int64)[csr.data.astype(np.int64)])
        return self._csr

    def _matvec(self, x):
        """A_k x_k for every system, f64 on the host: [K, n] -> [K, n]."""
        csr, vmap = self._csr_family()
        out = np.empty_like(x)
        for i in range(self.k):
            csr.data = self.vals_many[i, vmap]
            out[i] = csr @ x[i]
        return out

    def _ell_device(self):
        """The family's double-float ELL planes of the PERMUTED matrices on
        the device: one index [n, K_ell] (int64) for the pattern, hi / lo
        value planes [K, n, K_ell]. None when a row is too dense."""
        if self._ell is None:
            s = self._s
            n = s.plan.n
            r, c, ent = mmio.symmetrize_coo(
                s.rows, s.cols, np.arange(s.vals.shape[0]))
            pr, pc = s.plan.iperm[r], s.plan.iperm[c]
            lay = refine_mod.ell_slots(n, pr, pc)
            if lay is None:
                self._ell = False
            else:
                idx, slot = lay
                a64 = np.zeros((self.k + self.pad,) + idx.shape)
                a64[:, pr, slot] = self._padded(self.vals_many)[:, ent]
                hi, lo = refine_mod.split_f64(a64)
                dev = s.device
                self._ell = (torch.from_numpy(idx.astype(np.int64)).to(dev),
                             torch.from_numpy(hi).to(dev),
                             torch.from_numpy(lo).to(dev))
        return self._ell or None

    def _padded(self, x: np.ndarray) -> np.ndarray:
        """[K, ...] with the pad's copies of the last row appended."""
        if not self.pad:
            return x
        return np.concatenate([x, np.repeat(x[-1:], self.pad, axis=0)])

    def _solve_once(self, b: np.ndarray) -> np.ndarray:
        """One solve per system against the family's factors: b [K, n] f64
        in original order -> x [K, n] f64."""
        s = self._s
        perm, iperm = s._perm_device()
        bp = torch.from_numpy(np.ascontiguousarray(self._padded(b))).to(
            s.device)[:, perm].to(TORCH_DTYPES[s.dtype])
        xp = frontal.solve_many_systems(self.fp, self.factors, bp)
        return xp[:self.k, iperm].to(torch.float64).cpu().numpy()

    def _rhs(self, b) -> np.ndarray:
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1:
            b = np.broadcast_to(b, (self.k, b.shape[0]))
        if b.shape != (self.k, self._s.plan.n):
            raise ValueError(f"b must be [{self.k}, {self._s.plan.n}] or "
                             f"[{self._s.plan.n}], got {b.shape}")
        return b

    def solve(self, b, refine: str = "auto", tol: float = 1e-10,
              max_iter: int = 50) -> np.ndarray:
        """Solve A_k x_k = b_k for every system: `b` is [K, n], or [n]
        shared by the family; returns [K, n] f64 in original order.
        Refinement ('auto', as in SparseCholesky.solve) iterates the whole
        family until every system's relative residual meets tol: an f32
        family on the device (double-float residuals, the ELL index shared
        by the family), then, where that does not reach tol or a row is too
        dense for ELL, a host loop with f64 CSR residuals. `last_solve`
        records the sweeps of each loop and which loop finished. Runs at
        the parent solver's matmul rung, as the family was factored."""
        if refine not in ("auto", "never", "always"):
            raise ValueError(f"refine must be 'auto', 'never' or 'always', "
                             f"got {refine!r}")
        with _precision_ctx(self._s.precision):
            return self._solve(self._rhs(b), refine, tol, max_iter)

    def _solve(self, b: np.ndarray, refine: str, tol: float,
               max_iter: int) -> np.ndarray:
        s = self._s
        self.last_solve = {"sweeps": 0, "host_sweeps": 0, "loop": "none"}
        want_ir = refine == "always" or (
            refine == "auto" and s.dtype != np.float64)
        if not want_ir:
            return self._solve_once(b)
        x = None
        ell = self._ell_device() if s.dtype == np.float32 else None
        if ell is not None:
            perm, iperm = s._perm_device()
            xp, sweeps, rn_rel = refine_mod.solve_refined_df_family(
                self.fp, self.factors,
                torch.from_numpy(np.ascontiguousarray(self._padded(b))).to(
                    s.device)[:, perm], ell, tol=tol / 3.0, max_iter=max_iter)
            x = xp[:self.k, iperm].cpu().numpy()
            del xp
            self.last_solve.update(sweeps=sweeps, rn_rel=rn_rel,
                                   loop="device")
            if rn_rel <= tol:
                return x
        if x is None:
            x = self._solve_once(b)
        self.last_solve["loop"] = "host"
        bnorm = np.linalg.norm(b, axis=1)
        for _ in range(max_iter):
            r = b - self._matvec(x)
            if np.all(np.linalg.norm(r, axis=1) <= tol * bnorm):
                break
            x = x + self._solve_once(r)
            self.last_solve["host_sweeps"] += 1
        return x

    def residual(self, b, x) -> np.ndarray:
        """Per-system relative residuals ||A_k x_k - b_k|| / ||b_k||, [K],
        f64 on the host."""
        b = self._rhs(b)
        r = self._matvec(np.asarray(x, dtype=np.float64)) - b
        return np.linalg.norm(r, axis=1) / np.linalg.norm(b, axis=1)

    def logdet(self) -> np.ndarray:
        """log det(A_k) for every system, [K] (padded pivot diagonals are
        exactly 1 and contribute nothing)."""
        total = np.zeros(self.k + self.pad)
        for lvl, p in enumerate(self.factors):
            w = int(self.fp.W[lvl])
            d = torch.diagonal(mesh_mod.local(p)[:, :w, :w], dim1=1, dim2=2)
            d = d.cpu().numpy().astype(np.float64).reshape(len(total), -1)
            total += np.log(d).sum(axis=1)
        return 2.0 * total[:self.k]


def solve_spd(matrix_file: str, separator_file: str, b: np.ndarray,
              clusters_file: Optional[str] = None, dtype=np.float64,
              device="cuda", budget: Optional[int] = None,
              mesh=None) -> np.ndarray:
    """One-shot convenience: factor and solve from files."""
    s = SparseCholesky.from_files(matrix_file, separator_file, clusters_file,
                                  dtype=dtype, device=device, budget=budget,
                                  mesh=mesh)
    s.factorize()
    return s.solve(b)


def spsolve(a, b: np.ndarray, dtype=None, levels=None, tol: float = 1e-10,
            device="cuda", budget: Optional[int] = None, mesh=None,
            **kw) -> np.ndarray:
    """scipy.sparse.linalg.spsolve-shaped one-shot: solve A x = b for a
    symmetric positive-definite scipy sparse (or dense symmetric) matrix,
    ordering computed automatically (graph nested dissection). Either
    triangle (or both) of A may be populated. `dtype=None` keeps A's dtype
    (float32 factors in f32 and refines to `tol`). A sparse `b` is
    densified: a direct factor-solve has no sparsity to exploit in the
    right-hand side. Extra keywords (`precision=` among them) pass through
    to `SparseCholesky.from_scipy`."""
    import scipy.sparse as _sp

    if _sp.issparse(b):
        b = b.toarray()
        if b.ndim == 2 and b.shape[1] == 1:
            b = b.reshape(-1)
    s = SparseCholesky.from_scipy(a, dtype=dtype, levels=levels,
                                  device=device, budget=budget, mesh=mesh,
                                  **kw)
    s.factorize()
    return s.solve(b, tol=tol)

"""Carry a plan and a factorization across the two packages.

`plan_from_jax` copies a JAX-side `SolvePlan` field by field into the
port's own `SolvePlan` (the arrays are copied, not shared).

`state_from_jax` turns a factored JAX `cholesky_tpu.SparseCholesky` into a
factored port solver: its `SolvePlan` (converted by `plan_from_jax`; it
holds `perm`), its frontal plan
arrays (`W`, `F`, `front_rows`, `inv_child`, `fwd_child`) and its per-level
factors, read as NumPy with `np.asarray`. The port then solves against the
JAX factor; a quasi-definite (LDL^T) JAX solver's signature comes along, so
its signed factor solves and gives `slogdet` / `inertia` in the port too.
A level the JAX package stored bfloat16 stays bfloat16, and a
level it kept in host memory (a NumPy array in its `panels`: the offloaded
regimes) stays in host memory; the port's solve reads both. The other way
needs no code: the port's per-level [B, F, W] factors, read with
`.cpu().numpy()`, are the JAX package's layout.

`oracle_from_jax` turns a JAX `cholesky_tpu.verify.oracle.PanelsOracle`
into the port's: its plan, COO and, once factored, its [2^L, H, S] panels,
so that the port's oracle solves on the JAX factor.

This module does not import jax; it only reads the arrays it is handed.
"""

from __future__ import annotations

import numpy as np
import torch

from cholesky_tpu_torch.api import SparseCholesky
from cholesky_tpu_torch.io.ordering import ClusterHierarchy
from cholesky_tpu_torch.numeric.assemble import TORCH_DTYPES
from cholesky_tpu_torch.numeric.frontal_plan import FrontalPlan
from cholesky_tpu_torch.symbolic.plan import SolvePlan
from cholesky_tpu_torch.symbolic.tree import SeparatorTree
from cholesky_tpu_torch.verify.oracle import PanelsOracle


def _host(a):
    return None if a is None else np.asarray(a)


def plan_from_jax(jplan) -> SolvePlan:
    """The port's `SolvePlan` holding copies of a JAX-side plan's fields."""
    cl = jplan.clusters
    if cl is not None:
        cl = ClusterHierarchy(cl.levels, cl.num_separators,
                              {s: [np.array(b) for b in ivs]
                               for s, ivs in cl.intervals.items()})
    arrays = {f: np.array(getattr(jplan, f)) for f in (
        "sep_sizes", "perm", "iperm", "sep_offset", "sep_of_dof",
        "loc_of_dof", "S", "H", "row_off", "u_off")}
    return SolvePlan(tree=SeparatorTree(jplan.tree.levels,
                                        jplan.tree.num_separators),
                     n=int(jplan.n), clusters=cl, **arrays)


def state_from_jax(jax_solver, device="cuda") -> SparseCholesky:
    """A factored port solver holding the JAX solver's plan, factor,
    signature (`signs`, None for a Cholesky factor) and matmul rung (pinned
    as `load_factor` pins a checkpoint's)."""
    if not jax_solver.factored:
        raise ValueError("factorize the JAX solver first")
    jfp = jax_solver.fplan
    plan = plan_from_jax(jax_solver.plan)
    fp = FrontalPlan(plan, tuple(int(w) for w in jfp.W),
                     tuple(int(f) for f in jfp.F),
                     [np.asarray(fr) for fr in jfp.front_rows],
                     [_host(a) for a in jfp.inv_child],
                     [_host(a) for a in jfp.fwd_child],
                     fingerprint=jfp.fingerprint)
    dtype = np.dtype(jax_solver.dtype)
    if dtype not in TORCH_DTYPES:
        raise ValueError(f"solver dtype {dtype}; the port takes float32 or "
                         "float64 factorizations")
    solver = SparseCholesky(plan, jax_solver.rows, jax_solver.cols,
                            jax_solver.vals, dtype=dtype, device=device,
                            signs=getattr(jax_solver, "signs", None))
    solver._fplan = fp
    solver.panels = tuple(
        _level(p, "cpu" if isinstance(p, np.ndarray) else solver.device)
        for p in jax_solver.panels)
    solver._precision_resolved = jax_solver.precision
    solver.factored = True
    return solver


def oracle_from_jax(jax_oracle, device="cuda") -> PanelsOracle:
    """The port's `PanelsOracle` holding the JAX oracle's plan, COO and
    dtype, and its factored panels when it has them (copied to
    `device`)."""
    oracle = PanelsOracle(plan_from_jax(jax_oracle.plan),
                          np.array(jax_oracle.rows),
                          np.array(jax_oracle.cols),
                          np.array(jax_oracle.vals),
                          dtype=jax_oracle.dtype, device=device)
    if jax_oracle.panels is not None:
        oracle.panels = [_level(p, oracle.device) for p in jax_oracle.panels]
    return oracle


def _level(p, device) -> torch.Tensor:
    """One factor level as a torch tensor on `device`: f32 and f64 as they
    are, bfloat16 (NumPy's ml_dtypes type, 2 bytes) through its bits."""
    a = np.array(p)                                    # a writable copy
    if a.dtype in TORCH_DTYPES:
        return torch.from_numpy(a).to(device)
    if a.dtype.name != "bfloat16":
        raise ValueError(f"factor level stored as {a.dtype}; the port takes "
                         "float32, float64 or bfloat16 levels")
    bits = torch.from_numpy(a.view(np.uint16).astype(np.int16))
    return bits.view(torch.bfloat16).to(device)


"""Carry a factorization across the two packages.

`state_from_jax` turns a factored JAX `cholesky_tpu.SparseCholesky` into a
factored port solver: its `SolvePlan` (which holds `perm`), its frontal plan
arrays (`W`, `F`, `front_rows`, `inv_child`, `fwd_child`) and its per-level
factors, read as NumPy with `np.asarray`. The port then solves against the
JAX factor. The other way needs no code: the port's per-level [B, F, W]
factors, read with `.cpu().numpy()`, are the JAX package's layout.

This module does not import jax; it only reads the arrays it is handed.
"""

from __future__ import annotations

import numpy as np
import torch

from cholesky_tpu_torch.api import SparseCholesky
from cholesky_tpu_torch.numeric.assemble import TORCH_DTYPES
from cholesky_tpu_torch.numeric.frontal_plan import FrontalPlan


def _host(a):
    return None if a is None else np.asarray(a)


def state_from_jax(jax_solver, device="cuda") -> SparseCholesky:
    """A factored port solver holding the JAX solver's plan and factor."""
    if not jax_solver.factored:
        raise ValueError("factorize the JAX solver first")
    jfp = jax_solver.fplan
    fp = FrontalPlan(jax_solver.plan, tuple(int(w) for w in jfp.W),
                     tuple(int(f) for f in jfp.F),
                     [np.asarray(fr) for fr in jfp.front_rows],
                     [_host(a) for a in jfp.inv_child],
                     [_host(a) for a in jfp.fwd_child],
                     fingerprint=jfp.fingerprint)
    panels = [np.array(p) for p in jax_solver.panels]       # writable copies
    dtype = panels[0].dtype
    if dtype not in TORCH_DTYPES:
        raise ValueError(f"factor stored as {dtype}; the port takes float32 "
                         "or float64 factors")
    solver = SparseCholesky(jax_solver.plan, jax_solver.rows, jax_solver.cols,
                            jax_solver.vals, dtype=dtype, device=device)
    solver._fplan = fp
    solver.panels = tuple(torch.from_numpy(p).to(solver.device)
                          for p in panels)
    solver.factored = True
    return solver


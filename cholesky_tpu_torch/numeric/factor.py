"""Batched dense-ancestor-path Cholesky: the ORACLE engine, the port of
`cholesky_tpu/numeric/factor.py`.

Not the production path (that is `numeric/frontal.py`, the exact-boundary
multifrontal engine); the independent cross-check behind
`verify.oracle.PanelsOracle`. Each separator's panel holds its full
ancestor path, rows ordered [own, parent, grandparent, ..., root], and
each tree level, leaves to root, runs three batched dense steps over the
stacked [2^L, H(L), S(L)] panels:

  1. POTRF: `torch.linalg.cholesky_ex` of the [B, S, S] diagonal blocks
     (a block that is not positive definite comes back all NaN, as
     `lax.linalg.cholesky` gives it);
  2. TRSM:  X = A[:, S:] L^-T, the sub-diagonal panel against L^T;
  3. SYRK:  per target ancestor level lam one batched product
     tail @ Xp^T, summed over the 2^(lvl-lam) siblings that share the
     ancestor, subtracted from the ancestor's panels.

The siblings under one ancestor are a contiguous run of slots (the
ancestor's slot is slot >> (lvl - lam)), so the JAX package's
`segment_sum` is a view and a sum over the run, and the backward solve's
ancestor gather a `repeat_interleave`. The products are torch ops
(cuBLAS / cuSOLVER on the card), as they are XLA dots in the JAX package.

The JAX package jits each entry point and donates the panels; here the
entry points run eagerly, the panels cross to the device once and are
factored in place.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cholesky_tpu_torch.numeric.frontal import _cholesky, _solve_lower_t
from cholesky_tpu_torch.symbolic.plan import SolvePlan


def _level_meta(plan: SolvePlan):
    return (tuple(int(s) for s in plan.S), tuple(int(h) for h in plan.H),
            tuple(tuple(int(x) for x in row) for row in plan.u_off))


def _segment_sum(x: torch.Tensor, lvl: int, lam: int) -> torch.Tensor:
    """Sum of x [2^lvl, ...] over each run of 2^(lvl-lam) slots that share
    an ancestor at level lam: [2^lam, ...]."""
    return x.view(1 << lam, 1 << (lvl - lam), *x.shape[1:]).sum(1)


def factor_panels(plan: SolvePlan,
                  panels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Factor assembled panels in place; returns them holding L: diagonal
    blocks lower-triangular, sub-diagonal blocks solved."""
    S, H, _ = _level_meta(plan)
    panels = list(panels)
    for lvl in range(plan.levels - 1, -1, -1):
        W = S[lvl]
        A = panels[lvl]
        A[:, :W] = _cholesky(A[:, :W])
        if lvl == 0 or H[lvl] == W:
            continue
        A[:, W:] = _solve_lower_t(A[:, :W], A[:, W:])
        update_ancestors(plan, panels, A[:, W:], lvl)
    return panels


def update_ancestors(plan: SolvePlan, panels: List[torch.Tensor],
                     X: torch.Tensor, lvl: int) -> None:
    """The SYRK step of level `lvl`: subtract its solved sub-diagonal
    panels X [2^lvl, H - S, S] from every ancestor level's panels, in
    place. X's rows are ordered [parent, ..., root], so for a target level
    lam the product X[:, u_off:] @ X_lam^T aligns with the whole target
    panel: one product, sum and subtraction per ancestor. One expression,
    so that no product outlives its subtraction."""
    S, _, u_off = _level_meta(plan)
    for lam in range(lvl - 1, -1, -1):
        co = u_off[lvl][lam]
        panels[lam] -= _segment_sum(
            torch.matmul(X[:, co:], X[:, co:co + S[lam]].mT), lvl, lam)


def solve_forward(plan: SolvePlan, panels: Sequence[torch.Tensor],
                  b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Forward substitution L y = b, leaves to root."""
    S, H, u_off = _level_meta(plan)
    b = list(b)
    for lvl in range(plan.levels - 1, -1, -1):
        W = S[lvl]
        A = panels[lvl]
        y = torch.linalg.solve_triangular(A[:, :W], b[lvl][..., None],
                                          upper=False)[..., 0]
        b[lvl] = y
        if lvl == 0 or H[lvl] == W:
            continue
        contrib = torch.matmul(A[:, W:], y[..., None])[..., 0]
        for lam in range(lvl - 1, -1, -1):
            o = u_off[lvl][lam]
            b[lam] = b[lam] - _segment_sum(contrib[:, o:o + S[lam]], lvl,
                                           lam)
    return b


def solve_backward(plan: SolvePlan, panels: Sequence[torch.Tensor],
                   y: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Backward substitution L^T x = y, root to leaves; each separator
    gathers its ancestors' solutions."""
    S, H, _ = _level_meta(plan)
    x: List[torch.Tensor] = [None] * plan.levels
    for lvl in range(plan.levels):
        W = S[lvl]
        A = panels[lvl]
        rhs = y[lvl]
        if lvl > 0 and H[lvl] > W:
            z = torch.cat([x[lam].repeat_interleave(1 << (lvl - lam), dim=0)
                           for lam in range(lvl - 1, -1, -1)], dim=1)
            rhs = rhs - torch.matmul(A[:, W:].mT, z[..., None])[..., 0]
        x[lvl] = torch.linalg.solve_triangular(
            A[:, :W].mT, rhs[..., None], upper=True)[..., 0]
    return x


def _on(arrays, device, copy: bool = False) -> List[torch.Tensor]:
    """Tensors on `device`: NumPy arrays copied there once (never
    written), tensors moved only when they live elsewhere, or copied with
    `copy`."""
    return [a.to(device, copy=copy) if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                              copy=True)
            for a in arrays]


def factor(plan: SolvePlan, panels, device) -> List[torch.Tensor]:
    """Factor panels (NumPy arrays or tensors) on `device`; a tensor
    already there is factored in place."""
    return factor_panels(plan, _on(panels, device))


def solve(plan: SolvePlan, panels: Sequence[torch.Tensor],
          b) -> List[torch.Tensor]:
    """Forward and backward solve with factored panels; b per level
    [2^L, S(L)], moved to the panels' device."""
    y = solve_forward(plan, panels, _on(b, panels[0].device))
    return solve_backward(plan, panels, y)


def factor_and_solve(plan: SolvePlan, panels, b, device):
    """(factored panels, per-level solution) on `device`."""
    panels = factor(plan, panels, device)
    return panels, solve(plan, panels, b)

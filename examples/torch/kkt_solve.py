#!/usr/bin/env python
"""Equality-constrained least squares through a quasi-definite KKT system.
The `cholesky_tpu_torch` counterpart of examples/kkt_solve.py.

    minimize   ||G x − d||²  +  δ||x||²
    subject to B x = e

First-order optimality is the saddle-point (KKT) system

    [ GᵀG + δI   Bᵀ ] [x]   [Gᵀd]
    [    B      −εI ] [y] = [ e ]          (ε > 0: regularized multipliers)

which is symmetric QUASI-DEFINITE — (1,1) block SPD, (2,2) block negative
definite — so it factors stably WITHOUT pivoting (Vanderbei '95) and the
whole multifrontal pipeline applies: pass `signs` (+1 for primal dofs,
−1 for multipliers) and solve. This is the linear-algebra core of
interior-point and SQP methods; the reference solver (SPD-only dpotrf,
blas.rg:63-79) cannot touch this matrix class.

Run: python examples/torch/kkt_solve.py [--nx 40] [--m 60] [--device cuda]

--device picks the torch device (default cuda, which needs a card).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import scipy.sparse

from cholesky_tpu_torch import SparseCholesky  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=40,
                    help="grid side; primal dofs = nx^2")
    ap.add_argument("--m", type=int, default=60, help="constraint count")
    ap.add_argument("--delta", type=float, default=1e-3)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    n1 = args.nx * args.nx
    m = args.m

    # sparse design: 2-D Laplacian stencil as G (any sparse operator works)
    G = scipy.sparse.diags([4.0] * n1) - scipy.sparse.diags(
        [1.0] * (n1 - 1), 1) - scipy.sparse.diags([1.0] * (n1 - 1), -1)
    d = rng.standard_normal(n1)
    # sparse constraints: each ties a few random dofs
    B = scipy.sparse.random(m, n1, density=3.0 / n1, random_state=1,
                            data_rvs=lambda k: rng.uniform(0.5, 1.5, k))
    B = B.tocsr()
    B[np.arange(m), rng.integers(0, n1, m)] = 1.0   # no empty rows
    e = rng.standard_normal(m)

    H = (G.T @ G + args.delta * scipy.sparse.eye(n1)).tocoo()
    K = scipy.sparse.bmat([[H, B.T], [B, -args.eps * scipy.sparse.eye(m)]],
                          format="coo")
    n = n1 + m
    signs = np.concatenate([np.ones(n1), -np.ones(m)])
    mask = K.row >= K.col

    t0 = time.time()
    solver = SparseCholesky.from_matrix(
        n, K.row[mask], K.col[mask], K.data[mask], signs=signs,
        device=args.device)
    rhs = np.concatenate([G.T @ d, e])
    sol = solver.solve(rhs)
    x, y = sol[:n1], sol[n1:]
    dt = time.time() - t0

    print(f"KKT system: n = {n} ({n1} primal + {m} multipliers), "
          f"nnz = {K.nnz}")
    print(f"ordering+factor+solve: {dt:.2f}s   "
          f"KKT residual {solver.residual(rhs, sol):.2e}")
    print(f"constraint violation ||Bx - e||_inf = "
          f"{np.abs(B @ x - e).max():.2e} (ε-regularized: expect ~ε·|y|)")
    npos, nneg, _ = solver.inertia()
    print(f"inertia ({npos}, {nneg}) — correct for a KKT point "
          f"({n1}, {m} expected)")
    sgn, ld = solver.slogdet()
    print(f"slogdet: sign {sgn}, log|det| {ld:.3f}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Gaussian-process regression on a grid with a sparse SPD precision matrix:
posterior mean via solve(), marginal variances via selected inversion
(inv_diag), hyperparameter sweep via update_values (same pattern, new
coefficients: the plan is reused), and model evidence via logdet. The
`cholesky_tpu_torch` counterpart of examples/gp_variance.py.

    python examples/torch/gp_variance.py [--dim 24] [--levels 5]
                                         [--device cuda]

A Gaussian Markov random field prior: precision Q = tau * (G + kappa^2 I)
with G the grid Laplacian. Observing y = x + noise at every site gives the
posterior precision A = Q + sigma^{-2} I; then

    posterior mean      m = A^{-1} y / sigma^2        -> solve()
    marginal variances  diag(A^{-1})                  -> inv_diag()
    log evidence terms  log det(A)                    -> logdet()

This is the workload selected inversion exists for: n marginal variances
without n solves or a dense inverse. --device picks the torch device
(default cuda, which needs a card; cpu runs the CPU path).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=24)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--sigma", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    shape = (args.dim, args.dim)
    n, r, c, lap_vals, ordering, clusters, _ = generate_problem(
        shape, args.levels)
    diag_mask = r == c
    rng = np.random.default_rng(0)
    truth = np.sin(np.arange(n) * 0.07) + 0.2 * rng.standard_normal(n)
    y = truth + args.sigma * rng.standard_normal(n)

    def precision_vals(tau, kappa2):
        v = tau * lap_vals.copy()
        v[diag_mask] += tau * kappa2 + 1.0 / args.sigma**2
        return v

    s = SparseCholesky.from_coo(n, r, c, precision_vals(1.0, 0.5),
                                ordering, clusters, dtype=np.float64,
                                device=args.device)

    best = None
    for tau, kappa2 in [(0.5, 0.5), (1.0, 0.5), (2.0, 1.0)]:
        t0 = time.time()
        s.update_values(precision_vals(tau, kappa2))   # same pattern: the
        s.factorize()                                  # plan is reused
        m = s.solve(y / args.sigma**2)
        # log evidence (up to constants): -0.5(logdet A - mAm) for this toy
        score = -0.5 * (s.logdet() - m @ (y / args.sigma**2))
        rmse = float(np.sqrt(np.mean((m - truth) ** 2)))
        print(f"tau={tau:4.1f} kappa2={kappa2:3.1f}: rmse={rmse:.4f} "
              f"score={score:10.2f}  ({time.time()-t0:.2f}s)")
        if best is None or score > best[0]:
            best = (score, tau, kappa2, m)

    _, tau, kappa2, m = best
    s.update_values(precision_vals(tau, kappa2))
    s.factorize()
    t0 = time.time()
    var = s.inv_diag()                                 # marginal variances
    print(f"\nselected inversion: {time.time()-t0:.2f}s for {n} variances "
          f"(best model tau={tau}, kappa2={kappa2})")
    sd = np.sqrt(var)
    inside = np.mean(np.abs(truth - m) <= 1.96 * sd)
    print(f"posterior sd in [{sd.min():.4f}, {sd.max():.4f}]; "
          f"95% interval coverage of truth: {inside:.1%}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Maximum-likelihood GMRF hyperparameter learning with exact gradients —
the statistical toolkit around one sparse pattern. The `cholesky_tpu_torch`
counterpart of examples/gmrf_learn.py:

  * sample(): the synthetic truth is an exact draw from the prior
    (x = L⁻ᵀz with covariance Q⁻¹);
  * factorize_many(): the candidate grid factors BOTH A(τ) = Q(τ) + σ⁻²I
    and Q(τ) for every τ as one folded batch (2K same-pattern systems),
    scored by batched logdet + solve;
  * quadform_grad()/logdet_grad(): the exact marginal-likelihood gradient
    via the chain rule through the COO values — no differentiation through
    the factorization.

Model: y = x + ε, ε ~ N(0, σ²I), x ~ N(0, Q(τ)⁻¹), Q(τ) = τ(G + κ²I).
Marginal likelihood of y via Woodbury (A = Q + σ⁻²I):

    2·NLL(τ) = σ⁻²yᵀy − σ⁻⁴yᵀA⁻¹y + logdet A − logdet Q + n·log σ² + const

    python examples/torch/gmrf_learn.py [--dim 24] [--levels 5]
                                        [--device cuda]

--device picks the torch device (default cuda, which needs a card).
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
    ap.add_argument("--tau-true", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    shape = (args.dim, args.dim)
    n, r, c, lap_vals, ordering, clusters, _ = generate_problem(
        shape, args.levels)
    diag = (r == c).astype(np.float64)
    kappa2, sig2 = 0.5, args.sigma**2

    def q_vals(tau):
        return tau * (lap_vals + kappa2 * diag)

    def a_vals(tau):
        return q_vals(tau) + diag / sig2

    # ---- 0. ground truth drawn EXACTLY from the prior via sample() ------
    rng = np.random.default_rng(0)
    sQ = SparseCholesky.from_coo(n, r, c, q_vals(args.tau_true), ordering,
                                 clusters, dtype=np.float64,
                                 device=args.device)
    truth = sQ.sample(rng.standard_normal(n))
    y = truth + args.sigma * rng.standard_normal(n)
    yty = float(y @ y)

    def nll_terms(ainv_y, logdet_a, logdet_q):
        return 0.5 * (yty / sig2 - (y @ ainv_y) / sig2**2
                      + logdet_a - logdet_q + n * np.log(sig2))

    # ---- 1. batched candidate sweep: 2K systems, one folded batch -------
    taus = np.array([0.25, 0.5, 1.0, 2.0, 4.0])
    sA = SparseCholesky.from_coo(n, r, c, a_vals(1.0), ordering, clusters,
                                 dtype=np.float64, device=args.device)
    t0 = time.time()
    fam = sA.factorize_many(
        np.concatenate([np.stack([a_vals(t) for t in taus]),
                        np.stack([q_vals(t) for t in taus])]))
    X = fam.solve(y)                   # only the A half is used
    ld = fam.logdet()
    K = len(taus)
    nll = np.array([nll_terms(X[i], ld[i], ld[K + i]) for i in range(K)])
    t1 = time.time()
    for t, sc in zip(taus, nll):
        print(f"tau={t:5.2f}: NLL={sc:10.2f}")
    print(f"batched sweep of {2*K} factorizations: {t1-t0:.2f}s\n")
    tau = float(taus[np.argmin(nll)])

    # ---- 2. exact-gradient refinement -----------------------------------
    # dNLL/dtau = dv·[−½σ⁻⁴·quadform_grad(A) + ½·logdet_grad(A)
    #                 − ½·logdet_grad(Q)],  dv/dtau = lap + κ²·diag
    dv = lap_vals + kappa2 * diag
    for it in range(8):
        sA.update_values(a_vals(tau)); sA.factorize()
        sQ.update_values(q_vals(tau)); sQ.factorize()
        g = 0.5 * (-sA.quadform_grad(y) / sig2**2 + sA.logdet_grad()
                   - sQ.logdet_grad())
        d_logtau = tau * float(g @ dv)
        print(f"iter {it}: tau={tau:7.4f}  dNLL/dlog tau={d_logtau:9.3f}")
        if abs(d_logtau) < 0.5:
            break
        tau *= np.exp(np.clip(-4e-3 * d_logtau / np.sqrt(n), -0.3, 0.3))
    print(f"MLE tau ~= {tau:.3f} (true {args.tau_true})\n")

    # ---- 3. posterior at the learned model ------------------------------
    sA.update_values(a_vals(tau)); sA.factorize()
    m = sA.solve(y / sig2)
    var = sA.inv_diag()
    draws = m[:, None] + sA.sample(rng.standard_normal((n, 8)))
    print(f"posterior: rmse={np.sqrt(np.mean((m-truth)**2)):.4f} "
          f"(noise sd {args.sigma})")
    sd = np.sqrt(var)
    print(f"selected-inversion sd in [{sd.min():.4f}, {sd.max():.4f}]; "
          f"95% coverage of truth: "
          f"{np.mean(np.abs(truth-m) <= 1.96*sd):.1%}; "
          f"8-draw empirical sd median ratio "
          f"{np.median(draws.std(axis=1)/sd):.2f}")


if __name__ == "__main__":
    main()

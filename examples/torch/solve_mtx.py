#!/usr/bin/env python
"""Solve an arbitrary SPD MatrixMarket file end to end, no ordering files.
The `cholesky_tpu_torch` counterpart of examples/solve_mtx.py.

    python examples/torch/solve_mtx.py A.mtx [B.mtx] [--dtype float32]
                                       [--device cuda]

Computes a nested-dissection ordering from the sparsity graph, factors in
fp32 with iterative refinement to 1e-10 (f64 on request via --dtype
float64), reports residual, logdet, and a condition estimate. The
reference solver requires precomputed ord/clust files for this; here they
are derived (symbolic/nd.py). --device picks the torch device (default
cuda, which needs a card).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix")
    ap.add_argument("rhs", nargs="?",
                    help="MatrixMarket array RHS (default: random)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.io import mmio

    banner, r, c, v = mmio.read_coo(args.matrix)
    print(f"{args.matrix}: {banner.rows}x{banner.cols}, nnz={banner.nnz}")

    t0 = time.time()
    s = SparseCholesky.from_matrix(banner.rows, r, c, v,
                                   levels=args.levels,
                                   dtype=np.dtype(args.dtype),
                                   device=args.device)
    print(f"ordering+plan: {time.time()-t0:.2f}s "
          f"({s.plan.levels} levels, {s.plan.num_separators} separators)")

    t0 = time.time()
    s.factorize(check=True)
    print(f"factorize: {time.time()-t0:.2f}s (first use)")

    b = (mmio.read_array(args.rhs).reshape(-1) if args.rhs
         else np.random.default_rng(0).standard_normal(banner.rows))
    t0 = time.time()
    x = s.solve(b)
    print(f"solve: {time.time()-t0:.2f}s")
    print(f"residual ||Ax-b||/||b||: {s.residual(b, x):.3e}")
    print(f"logdet(A): {s.logdet():.6g}")
    print(f"condest(A): {s.condest():.3e}")


if __name__ == "__main__":
    main()

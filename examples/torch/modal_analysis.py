#!/usr/bin/env python
"""FEM modal analysis: the lowest vibration modes of a 2-D elastic membrane,
K·x = ω²·M·x, by shift-invert Lanczos through the sparse Cholesky factor.
The `cholesky_tpu_torch` counterpart of examples/modal_analysis.py.

  * K: Wathen-style random-coefficient FEM stiffness from the SPD gallery,
    ordered by auto nested dissection (no offline files) and factored once;
  * M: lumped (diagonal) mass matrix;
  * eigsh(k, M=M): each Lanczos step is ONE refined triangular-solve pair
    through the factor — the ARPACK sigma=0 mode a direct solver
    classically drives. Modes come back mass-normalized (VᵀMV = I).

    python examples/torch/modal_analysis.py [--nx 64] [--k 6]
        [--dtype float32] [--device cuda | --cpu]

--device picks the torch device (default cuda, which needs a card); --cpu
is --device cpu.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args()
    device = "cpu" if args.cpu else args.device

    import scipy.sparse

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.problems import fem_q4

    n, r, c, v = fem_q4(args.nx, args.nx, seed=0)
    print(f"stiffness: {args.nx}x{args.nx} Q4 mesh, n={n}, nnz={len(v)}")

    t0 = time.time()
    s = SparseCholesky.from_matrix(n, r, c, v, dtype=args.dtype,
                                   device=device)
    s.factorize()
    print(f"auto-ND + factorize: {time.time() - t0:.2f}s "
          f"(levels={s.plan.levels}, dtype={args.dtype})")

    rng = np.random.default_rng(0)
    mass = scipy.sparse.diags(rng.uniform(0.5, 2.0, n)).tocsr()

    t0 = time.time()
    w, V = s.eigsh(k=args.k, M=mass, tol=1e-9)
    print(f"eigsh(k={args.k}, M=lumped mass): {time.time() - t0:.2f}s")
    print("  omega^2 (ascending):", np.array2string(w, precision=6))
    print("  mass-orthonormality |V'MV - I|_max:",
          f"{np.abs(V.T @ (mass @ V) - np.eye(args.k)).max():.2e}")

    # residual check against the true pencil
    kcsr = s._matrix_csr()
    res = np.linalg.norm(kcsr @ V - (mass @ V) * w, axis=0)
    print("  worst pencil residual:", f"{res.max():.2e}")


if __name__ == "__main__":
    main()

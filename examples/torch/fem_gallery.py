#!/usr/bin/env python
"""Factor and solve every problem in the SPD gallery (utils/problems.py):
anisotropic stencils, Wathen-style random-coefficient FEM, elasticity-style
vector blocks, random/circuit graphs — all through scipy interop and the
auto-nested-dissection path, to the 1e-10 residual contract. The
`cholesky_tpu_torch` counterpart of examples/fem_gallery.py.

    python examples/torch/fem_gallery.py [--dtype float32] [--scale 2]
                                         [--device cuda | --cpu]

--scale multiplies the default problem sizes (the gallery defaults are
CPU-test-sized; --scale 4 reaches ~100k-dof problems worth running on the
GPU). --device picks the torch device (default cuda, which needs a card);
--cpu is --device cpu.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args()
    device = "cpu" if args.cpu else args.device

    import scipy.sparse as sp

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils import problems

    gallery = problems.make_gallery(args.scale)
    rng = np.random.default_rng(0)
    for name, gen in gallery.items():
        n, r, c, v = gen()
        a = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
        b = rng.standard_normal(n)
        t0 = time.time()
        s = SparseCholesky.from_scipy(a, dtype=args.dtype, device=device)
        t_plan = time.time() - t0
        t0 = time.time()
        s.factorize()
        x = s.solve(b)
        t_solve = time.time() - t0
        print(f"{name:11s} n={n:>8d} nnz={a.nnz:>9d} "
              f"plan {t_plan:6.2f}s  factor+solve {t_solve:6.2f}s  "
              f"residual {s.residual(b, x):.2e}")


if __name__ == "__main__":
    main()

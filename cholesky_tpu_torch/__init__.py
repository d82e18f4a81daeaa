"""cholesky_tpu_torch — the PyTorch/CUDA port of `cholesky_tpu`, for NVIDIA
Hopper (H100).

The single-device SPD solver and its user-facing surface: ordering (graph
nested dissection with a minimum-degree candidate) and plan (the port's own
copies of the JAX package's host modules: io, symbolic, utils), device
assembly, batched multifrontal factorization with a hand-written CUDA
Cholesky/inverse kernel on the high-batch levels, its capacity regimes
under one memory budget (two-piece extend-add, bf16 child updates, lazily
assembled and batch-chunked levels, a bf16 or host-resident factor),
iterative refinement with a double-float residual for one right-hand side
or a block, value updates on a fixed pattern, factor export and
checkpoints, a per-stage profiler and a command-line interface; selected
inversion (diag and entries of A^-1), gradients with respect to the
values, sampling and whitening, and same-pattern families factored as one
folded batch; symmetric quasi-definite (KKT) matrices by a signed LDL^T
(`signs=`, `slogdet`, `inertia`); the Schur complement onto the root
separator, Woodbury updates, factor-preconditioned CG for perturbed
matrices, and Lanczos eigenpairs and condition numbers; multi-device
distribution over a single-process mesh of torch devices (`mesh=`,
`--devices` / `--slices`).

  api.py                   SparseCholesky (from_files, from_coo, from_matrix,
                           from_scipy), BatchedFactors, solve_spd, spsolve
  cli.py                   python -m cholesky_tpu_torch.cli (flag-compatible
                           with python -m cholesky_tpu.cli)
  convert.py               carry a plan and a factor across from the JAX package
  io/                      MatrixMarket and ordering readers and writers
  native/                  the C++ host core (a copy of the JAX package's):
                           ordering, MatrixMarket I/O, fill analysis; g++
                           at first use, ctypes
  symbolic/                SolvePlan; nd.py, mdtree.py, quality.py: the
                           ordering of a matrix that comes without one;
                           fill.py: the cluster fill analysis of -d
  verify/                  the -d structure log, the op schedule and its
                           replay oracle (NumPy, SciPy)
  utils/                   problem generators (grid Laplacians, the gallery)
  numeric/frontal_plan.py  host frontal analysis (NumPy)
  numeric/regimes.py       the budget and the per-level regime plan
  numeric/devmem.py        the allocator pool of long-lived device state
  numeric/assemble.py      device assembly, eager or level by level
  numeric/frontal.py       per-level factorization, level loop (one system
                           or a family), solves of [n], [n, k] and of a
                           family, L^-T and L^T, factor extraction
  numeric/selinv.py        selected inversion
  numeric/ldlt.py          quasi-definite signed LDL^T: factor, solve, slogdet
  numeric/eigs.py          Lanczos eigenpairs and kappa_2 (host NumPy)
  numeric/hopper_kernels.py  chol_inv kernel wrapper, factor_slab
  numeric/refine.py        double-float iterative refinement, single and block
  numeric/profile.py       per-level, per-stage BLAS: timing lines
  kernels/                 CUDA sources and their nvcc build
  parallel/                mesh.py (the mesh, placement, Sharded),
                           dist_cholesky.py (collective root),
                           dist_level.py (row-group narrow levels)
"""

__version__ = "0.1.0"

from cholesky_tpu_torch.api import (BatchedFactors,  # noqa: E402,F401
                                    SparseCholesky, solve_spd, spsolve)

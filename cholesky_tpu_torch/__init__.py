"""cholesky_tpu_torch — the PyTorch/CUDA port of `cholesky_tpu`, for NVIDIA
Hopper (H100).

The single-device SPD solve: plan (the port's own copies of the JAX
package's host modules: io, symbolic, utils), device assembly, batched
multifrontal factorization with a hand-written CUDA Cholesky/inverse kernel
on the high-batch levels, its capacity regimes under one memory budget
(two-piece extend-add, bf16 child updates, lazily assembled and
batch-chunked levels, a bf16 or host-resident factor), and iterative
refinement with a double-float residual.

  api.py                   SparseCholesky, solve_spd
  convert.py               carry a plan and a factor across from the JAX package
  io/, symbolic/, utils/   MatrixMarket and ordering readers, SolvePlan,
                           problem generator (copies of cholesky_tpu's)
  numeric/frontal_plan.py  host frontal analysis (NumPy)
  numeric/regimes.py       the budget and the per-level regime plan
  numeric/devmem.py        the allocator pool of long-lived device state
  numeric/assemble.py      device assembly, eager or level by level
  numeric/frontal.py       per-level factorization, level loop, solves
  numeric/hopper_kernels.py  chol_inv kernel wrapper, factor_slab
  numeric/refine.py        double-float iterative refinement
  kernels/                 CUDA sources and their nvcc build
"""

__version__ = "0.1.0"

from cholesky_tpu_torch.api import SparseCholesky, solve_spd  # noqa: E402,F401

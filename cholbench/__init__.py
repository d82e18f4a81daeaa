"""The benchmark of the PyTorch / CUDA sparse Cholesky solver
(`cholesky_tpu_torch`): refactor-and-solve cycles and repeated solves on
grid Laplacians, one cell of `BENCHMARK.json` a run (`run.py`)."""

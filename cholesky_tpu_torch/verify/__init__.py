"""Verification subsystem: golden-model checks, the reference-compatible
structured debug log, and the op-by-op replay oracle (the rebuild of
verify.py + the reference's `-d` debug machinery).

The port's copy of `cholesky_tpu/verify/`: this module, `schedule.py`,
`debuglog.py` and `replay.py` (the independent NumPy / SciPy oracle of the
CLI's `-d` / `--debug-dumps`), and `oracle.py` (`PanelsOracle`, the panel
engine that cross-checks the production factor, on torch)."""

import numpy as np


def generate_b(n: int, path: str = None, seed=None) -> np.ndarray:
    """RHS fixture generator (verify.py:305-308): random integers 1..10,
    shape [n, 1], written as an array-format .mtx (B_<n>x1.mtx)."""
    from cholesky_tpu_torch.io import mmio

    rng = np.random.default_rng(seed)
    b = rng.integers(1, 11, size=(n, 1))
    mmio.write_array(path or f"B_{n}x1.mtx", b, field="integer")
    return b

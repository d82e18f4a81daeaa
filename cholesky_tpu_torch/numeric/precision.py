"""The matmul-precision ladder on the card: the rung names of
`cholesky_tpu/api.py` (`_PRECISIONS`, `_precision_ctx`) mapped onto
cuBLAS's float32 math, as `jax.lax.Precision` reads on a GPU:

  * "default", "bfloat16", "high", "tensorfloat32", and None (the AUTO
    rung's low answer): TF32 tensor cores,
    `torch.backends.cuda.matmul.fp32_precision = "tf32"`;
  * "highest", "float32": IEEE float32, `fp32_precision = "ieee"`.

On the TPU the JAX package's rungs are 1-, 3- and 6-pass bf16 products; on
an H100 the ladder has these two rungs. The context sets that one flag and
nothing else: not `torch.set_float32_matmul_precision` (global across
backends, and on the CPU it steers oneDNN) and not the legacy
`allow_tf32` (reading a legacy flag after the new one is set raises). CPU
products and f64 products do not read the flag. Only cuBLAS GEMMs follow
it; the hand kernel `chol_inv` computes in scalar f32 FMAs at every rung.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

PRECISIONS = ("default", "high", "highest", "bfloat16", "tensorfloat32",
              "float32")

# the rungs that keep IEEE float32 products; every other rung is TF32
_IEEE = ("highest", "float32")


def check(precision: Optional[str]) -> None:
    """ValueError for a name outside PRECISIONS (None is AUTO)."""
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")


def fp32_flag(precision: Optional[str]) -> str:
    """The value of `torch.backends.cuda.matmul.fp32_precision` for a
    rung."""
    return "ieee" if precision in _IEEE else "tf32"


@contextlib.contextmanager
def precision_ctx(precision: Optional[str]):
    """Run the body with cuBLAS's float32 math set to the rung's, and put
    the flag back as it was on exit, also when the body raises. An inner
    context of the same rung is harmless."""
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    matmul.fp32_precision = fp32_flag(precision)
    try:
        yield
    finally:
        matmul.fp32_precision = before

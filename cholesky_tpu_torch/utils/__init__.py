"""Host utilities: the port's copy of `cholesky_tpu/utils/__init__.py`."""


def round_up(x: int, m: int) -> int:
    """Smallest multiple of `m` that is >= `x` (the padding-granularity rule
    shared by the symbolic planner, the frontal engine, and the collective
    root-front factorization)."""
    return -(-x // m) * m

"""pivot_ms.cycle: device extent of the solver's span `chol.step.pivot`
summed per cycle (ms): the partial front factorizations, pivot Cholesky and
boundary strip (`frontal._factor_slab`), per chunk of each level. Moves
cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.step.pivot", "device")

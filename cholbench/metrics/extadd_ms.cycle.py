"""extadd_ms.cycle: device extent of the solver's span `chol.step.extend_add`
summed per cycle (ms): the children's updates added into their parents'
fronts (`frontal._extend_add_fused_`, `_apply_extadd_two_piece`), per chunk
of each level. Moves cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.step.extend_add", "device")

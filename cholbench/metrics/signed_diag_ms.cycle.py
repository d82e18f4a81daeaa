"""signed_diag_ms.cycle: device extent of the solver's span
`chol.step.signed_diag` summed per cycle (ms): the column loop of each
panel of the signed pivot factorization (`ldlt._panel_factor_`, ~5
launches a column), inside `chol.step.pivot`. A solver without the span
(an SPD factorization, or one that records none) reads nothing. Moves
cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.step.signed_diag", "device")

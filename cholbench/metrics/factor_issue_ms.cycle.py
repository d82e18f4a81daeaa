"""factor_issue_ms.cycle: host wall of the solver's span `chol.factorize`
per cycle (ms), closed without a synchronize: the time the host takes to
issue the level loop. Beside factor_ms.cycle (synchronized) it says how
much of the factorization's wall is the host's. Moves cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.factorize", "host")

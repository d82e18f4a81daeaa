"""cycle_solve_ms.cycle: mean synchronized wall of the cycle's solve,
the rebuild of the residual's ELL planes and the pivot inverses after the
update included (ms). Moves cycle_ms."""

from cholbench.metrics._common import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "solve")

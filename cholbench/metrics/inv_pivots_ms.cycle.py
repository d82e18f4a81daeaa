"""inv_pivots_ms.cycle: device extent of the solver's span
`chol.solve.inv_pivots` per cycle (ms): stream time from its first to its
last marker while the pivot inverses of the new factor are built. Moves
cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.solve.inv_pivots", "device")

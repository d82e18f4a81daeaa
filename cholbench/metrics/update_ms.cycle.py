"""update_ms.cycle: mean wall of update_values (API layer) in a cycle (ms).
Moves cycle_ms."""

from cholbench.metrics._common import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "update")

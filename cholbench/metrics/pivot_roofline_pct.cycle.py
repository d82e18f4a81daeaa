"""pivot_roofline_pct.cycle: the least time of one factorization's partial
front factorizations (the configuration's `step_work` pivot_flops and
pivot_bytes at the rung's peak, `yardstick.least_seconds`) over the device
extent of `chol.step.pivot` per cycle (%). Moves cycle_ms."""

from cholbench.metrics._steps import roofline_pct


def read(rec):
    return roofline_pct(rec, "pivot", "chol.step.pivot")

"""schur_roofline_pct.cycle: the least time of one factorization's Schur
updates (the configuration's `step_work` schur_flops and schur_bytes at
the rung's peak, `yardstick.least_seconds`) over the device extent of
`chol.step.schur` per cycle (%). Moves cycle_ms."""

from cholbench.metrics._steps import roofline_pct


def read(rec):
    return roofline_pct(rec, "schur", "chol.step.schur")

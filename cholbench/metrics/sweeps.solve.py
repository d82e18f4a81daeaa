"""sweeps.solve: mean refinement sweeps of the device loop per solve
(solves that finish on the host loop are counted apart on standard
error). Moves solve_ms."""

from cholbench.metrics._common import mean_sweeps


def read(rec):
    return mean_sweeps(rec, "solve")

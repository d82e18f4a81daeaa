"""sweeps.cycle: mean refinement sweeps of the device loop per cycle's
solve (solves that finish on the host loop are counted apart on standard
error). Moves cycle_ms."""

from cholbench.metrics._common import mean_sweeps


def read(rec):
    return mean_sweeps(rec, "cycle")

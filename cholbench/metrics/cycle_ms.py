"""cycle_ms: window time up to the end of the last completed
update -> factorize -> solve cycle, over the cycles completed (ms)."""

from cholbench.metrics._common import window_ms_per_request


def read(rec):
    return window_ms_per_request(rec, "cycle")

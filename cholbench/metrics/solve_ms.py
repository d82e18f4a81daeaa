"""solve_ms: window time up to the end of the last completed solve, over
the right-hand sides solved against the factor made in set-up (ms)."""

from cholbench.metrics._common import window_ms_per_request


def read(rec):
    return window_ms_per_request(rec, "solve")

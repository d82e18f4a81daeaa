"""apply_dev_ms.solve: mean device extent of one application of the
factor in the refinement loop, the solver's span `chol.refine.apply`
(ms): stream time from its first to its last marker. Near
apply_host_ms.solve the device waits on the host that issues the chain;
well above it the device work itself is slow. Moves solve_ms."""

from cholbench.metrics._program import per_span_ms


def read(rec):
    return per_span_ms(rec, "solve", "chol.refine.apply", "device")

"""apply_host_ms.solve: mean host wall of one application of the factor
in the refinement loop, the solver's span `chol.refine.apply` (ms). Moves
solve_ms."""

from cholbench.metrics._program import per_span_ms


def read(rec):
    return per_span_ms(rec, "solve", "chol.refine.apply", "host")

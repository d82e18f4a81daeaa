"""ell_build_ms.cycle: host wall of the solver's span
`chol.solve.ell_build` per cycle (ms): the residual's ELL planes rebuilt
on the host after `update_values` (`symmetrize_coo`, `build_ell`,
`pad_ell`). Moves cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.solve.ell_build", "host")

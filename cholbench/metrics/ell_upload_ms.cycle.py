"""ell_upload_ms.cycle: host wall of the solver's span
`chol.solve.ell_upload` per cycle (ms): the three ELL planes copied to the
device from pageable memory. Moves cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.solve.ell_upload", "host")

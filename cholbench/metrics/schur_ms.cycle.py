"""schur_ms.cycle: device extent of the solver's span `chol.step.schur`
summed per cycle (ms): the Schur updates of the boundary blocks
(`frontal._schur_update_cast`, the deferred leaf product `_rows_product`),
per chunk of each level. Moves cycle_ms."""

from cholbench.metrics._program import per_request_ms


def read(rec):
    return per_request_ms(rec, "cycle", "chol.step.schur", "device")

"""factor_ms.cycle: mean synchronized wall of factorize() (level loop,
assembly, slab kernels) in a cycle (ms). Moves cycle_ms."""

from cholbench.metrics._common import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "factor")

"""factor_roofline_pct.cycle: the least time of one factorization over the
mean factorize() wall (%). The least time is the larger of the
configuration's fixed FLOPs over the published peak of its rung and its
fixed bytes over the HBM rate (`yardstick.least_seconds`); the counts are
the benchmark's own, of a multifrontal Cholesky of its ordering
(`yardstick.count_work`), stored in the configuration's `work`. Moves
cycle_ms."""

from cholbench import yardstick
from cholbench.metrics._common import span_mean_ms


def read(rec):
    wall = span_mean_ms(rec, "factor")
    if not wall:
        return None
    work = rec.cfg["work"]
    least, _ = yardstick.least_seconds(work["flops"], work["bytes"], rec.rung)
    return 100.0 * least / (wall / 1e3)

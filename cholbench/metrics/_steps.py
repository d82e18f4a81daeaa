"""The roofline share of one step of the level loop: the least time of the
step's fixed work (the configuration's `step_work`, `stepwork.py`) at the
rung's peak over the device extent of the step's span summed per cycle."""

from cholbench import yardstick
from cholbench.metrics._program import per_request_ms


def roofline_pct(rec, step, span):
    work = rec.cfg.get("step_work")
    if not work:
        return None
    ms = per_request_ms(rec, "cycle", span, "device")
    if not ms:
        return None
    least, _ = yardstick.least_seconds(work[step + "_flops"],
                                       work[step + "_bytes"], rec.rung)
    return 100.0 * least / (ms / 1e3)

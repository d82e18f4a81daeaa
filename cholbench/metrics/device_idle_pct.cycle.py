"""device_idle_pct.cycle: share of the traced window in which no kernel,
copy or fill ran on the device (%), refactor traffic. Moves cycle_ms."""

from cholbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec) if rec.mix["request"] == "cycle" else None

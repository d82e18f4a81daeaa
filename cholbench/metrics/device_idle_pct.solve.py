"""device_idle_pct.solve: share of the traced window in which no kernel,
copy or fill ran on the device (%), solve traffic. Moves solve_ms."""

from cholbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec) if rec.mix["request"] == "solve" else None

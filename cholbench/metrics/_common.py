"""Helpers the metric readers share. A reader returns None where its run
has nothing to read; the harness then leaves the metric out."""

import numpy as np


def window_ms_per_request(rec, request):
    """Window time up to the end of the last completed request, over the
    requests completed, in ms, where the mix's requests are of the kind
    `request`. The benchmark's own factor checks between requests (their
    `check_s`) are not the solver's time and are left out."""
    if rec.mix["request"] != request or not rec.requests:
        return None
    t0, t1 = rec.window
    checks = sum(r["check_s"] for r in rec.requests[:-1])
    return (t1 - t0 - checks) / len(rec.requests) * 1e3


def span_mean_ms(rec, name):
    """Mean wall of a span over the window's requests, in ms."""
    xs = [r["spans"][name] for r in rec.requests if name in r["spans"]]
    return float(np.mean(xs)) * 1e3 if xs else None


def idle_pct(rec):
    """Share of the traced window in which no operation ran on the device."""
    p = rec.profile
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def mean_sweeps(rec, request):
    if rec.mix["request"] != request or not rec.requests:
        return None
    return float(np.mean([r["sweeps"] for r in rec.requests]))

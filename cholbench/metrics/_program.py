"""The solver's own spans (`cholesky_tpu_torch.trace`), for the metric
readers: those whose start falls inside a window request's [t0, t1], so
the set-up and the factor checks between requests are left out. The solver
records spans only while a profiler runs, that is in a traced run. Where
the run holds no such span (an untraced run, a solver that records none,
a device extent on the CPU) the helpers return None."""

import bisect

import numpy as np


def _recorded():
    try:
        from cholesky_tpu_torch import trace
    except ImportError:
        return []
    return trace.spans()


def by_request(rec, name):
    """[the closed spans named `name` in each window request], or None
    where no request holds one."""
    if not rec.requests:
        return None
    t0s = [r["t0"] for r in rec.requests]
    out = [[] for _ in rec.requests]
    for s in _recorded():
        if s.name != name or s.t1_ns is None:
            continue
        t = s.t0_ns / 1e9
        i = bisect.bisect_right(t0s, t) - 1
        if i >= 0 and t <= rec.requests[i]["t1"]:
            out[i].append(s)
    return out if any(out) else None


def _ms(spans, clock):
    """The spans' host walls (clock "host") or device extents ("device")
    in ms; None where one has none."""
    xs = [s.host_ms if clock == "host" else s.device_ms for s in spans]
    return None if any(x is None for x in xs) else xs


def per_request_ms(rec, request, name, clock):
    """Time in the spans `name` per window request, summed in each request
    and averaged over all of them (ms), where the mix's requests are of the
    kind `request`."""
    if rec.mix["request"] != request:
        return None
    per = by_request(rec, name)
    if per is None:
        return None
    sums = [_ms(spans, clock) for spans in per]
    if any(x is None for x in sums):
        return None
    return float(np.mean([sum(x) for x in sums]))


def per_span_ms(rec, request, name, clock):
    """Mean time of one span `name` over the window requests (ms), where
    the mix's requests are of the kind `request`."""
    if rec.mix["request"] != request:
        return None
    per = by_request(rec, name)
    if per is None:
        return None
    xs = _ms([s for spans in per for s in spans], clock)
    return float(np.mean(xs)) if xs else None

"""The benchmark's spans and its reading of a `torch.profiler` trace.

Spans are the benchmark's own, around its calls into the solver's layers:
`cholbench.request` around each request, and inside it
`cholbench.update` / `cholbench.factor` / `cholbench.solve`, each closed
after a device synchronize in a traced run. They go to the profiler as
user annotations and into `Spans` as host-clock walls.

`read_trace` takes the profiler's raw events (no tree is built, so a
window of some hundred thousand kernels reads in seconds) and returns the
traced window, the device's busy time in it, the kernels launched, device
time by operation, and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120          # a kernel's name is cut to this in the breakdown
TOP = 10


class Spans:
    """Host-clock walls of the named spans of each request."""

    def __init__(self, sync, profiled):
        self.sync = sync              # a device synchronize, or None
        self.profiled = profiled
        self.current = None

    @contextlib.contextmanager
    def span(self, name):
        ctx = contextlib.nullcontext()
        if self.profiled:
            from torch.profiler import record_function

            ctx = record_function("cholbench." + name)
        with ctx:
            t = time.perf_counter()
            yield
            if self.sync is not None:
                self.sync()
            if self.current is not None:
                self.current[name] = time.perf_counter() - t


def _union(starts, ends):
    """Merged intervals of [starts, ends), sorted by start."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def _kind(e):
    """The activity of a raw profiler event: "kernel", "gpu_memcpy",
    "gpu_memset", another device activity, or a host one ("cpu_op",
    "user_annotation", ...). Builds of PyTorch whose events do not carry
    it are told apart by device and name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    if "CUDA" not in str(e.device_type()):
        return "cpu_op"
    name = e.name()
    annotation = getattr(e, "is_user_annotation", None)
    if ((annotation is not None and annotation())
            or name.startswith(("cholbench.", "ProfilerStep"))):
        return "gpu_user_annotation"
    if name.endswith(" Sync") or name.startswith("Stream Wait"):
        return "cuda_sync"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read_trace(events):
    """The reading of a traced window from the profiler's raw events
    (`prof.profiler.kineto_results.events()`), or None when the window
    holds no request span. Times in seconds."""
    req = [(e.start_ns(), e.end_ns(), e.start_thread_id()) for e in events
           if e.name() == "cholbench.request"
           and "CUDA" not in str(e.device_type())]
    if not req:
        return None
    w0 = min(r[0] for r in req)
    w1 = max(r[1] for r in req)
    thread = req[0][2]
    dev, host = [], []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_OPS:
            if e.end_ns() > w0 and e.start_ns() < w1:
                dev.append((e.start_ns(), e.end_ns(), e.name(), kind))
        elif (e.start_thread_id() == thread and e.end_ns() > w0
              and e.start_ns() < w1 and kind in ("cpu_op", "user_annotation",
                                                "python_function")):
            host.append((e.start_ns(), e.end_ns(), e.name()))
    out = {"window_s": (w1 - w0) / 1e9, "requests": len(req),
           "busy_s": 0.0, "kernels": 0, "device_ops": [], "idle_gaps": [],
           "kernel_s_by_name": {}}
    if not dev:
        return out
    starts = np.clip(np.array([d[0] for d in dev], dtype=np.int64), w0, w1)
    ends = np.clip(np.array([d[1] for d in dev], dtype=np.int64), w0, w1)
    us, ue = _union(starts, ends)
    out["busy_s"] = float(np.sum(ue - us)) / 1e9
    by_name = defaultdict(int)
    kernel_s = defaultdict(int)
    for (_, _, name, kind), s, e in zip(dev, starts, ends):
        by_name[name] += int(e - s)
        if kind == "kernel":
            out["kernels"] += 1
            kernel_s[name] += int(e - s)
    out["kernel_s_by_name"] = {k: v / 1e9 for k, v in kernel_s.items()}
    out["device_ops"] = [[k[:NAME_CHARS], v / 1e9] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    # idle gaps: before the first op, between merged intervals, after the
    # last; each labelled by the innermost host event open at its middle
    gs = np.concatenate([[w0], ue])
    ge = np.concatenate([us, [w1]])
    keep = ge > gs
    gaps = list(zip(gs[keep], ge[keep]))
    out["idle_gaps"] = _label_gaps(gaps, host)
    return out


def _label_gaps(gaps, host):
    """[[label, seconds]] of the idle gaps summed by the innermost host
    event (on the requests' thread) open at each gap's middle, the longest
    TOP. Host events on one thread nest, so a stack finds it in one pass."""
    host.sort(key=lambda h: (h[0], -h[1]))
    mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
    totals = defaultdict(int)
    stack = []
    i = 0
    for t, length in mids:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        label = stack[-1][2] if stack else "outside any host event"
        totals[label] += int(length)
    return [[k[:NAME_CHARS], v / 1e9] for k, v in sorted(
        totals.items(), key=lambda kv: -kv[1])[:TOP]]

"""Spans of the port's hot path, on the profiler's clock.

A span is on exactly while a `torch.profiler` (or the autograd profiler)
records; the port has no switch of its own. Off, `span(name)` reads one
flag and returns a shared no-op context: it allocates nothing and never
enters `record_function`. On, a span

  * enters `torch.profiler.record_function(name)`: a user annotation on
    the profiler's clock, on the same timeline as the device activity;
  * keeps a `Span` record (name, id, the id of its top-level call, host
    start and end on `time.perf_counter_ns`, the clock of a caller's own
    request walls) in a bounded in-memory list;
  * given a CUDA `device`, records a pair of timing events on the device's
    current stream at open and close: the span's device extent, stream
    time from its first marker to its last, resolved when it is read
    (after the caller has synchronized).

`spans()` returns the kept records, oldest first; `dropped()` counts those
that the bound (LIMIT) pushed out; `clear()` empties the list.

The spans (their names are the contract the benchmark's readers rely on):

  chol.update_values          SparseCholesky.update_values
  chol.factorize              the body of factorize(), not synchronized
  chol.factorize.plan         its budget and regime plan
  chol.factorize.fronts       its assembly of the slabs (`_fronts`)
  chol.level.L<lvl:02d>       each level of the level loops
                              (`frontal.frontal_factor_streamed`,
                              `ldlt.factor_qd`), inside `level_hook`
  chol.step.pivot             inside a level of `frontal._factor_level`,
                              per chunk: the partial front factorization
                              (`_factor_slab`); of `ldlt._factor_level_qd`:
                              the signed pivot factorization
                              (`blocked_signed_cholesky`), the boundary
                              solve and X~ = X S
  chol.step.schur             there: the Schur update of the boundary
                              block (`_schur_update_cast`, or
                              `_schur_gather_2` on a gather-tier level;
                              and the leaves' deferred X X^T,
                              `_rows_product`); in `ldlt._factor_level_qd`
                              the update product X~ X^T
  chol.step.signed_diag       inside chol.step.pivot of a signed level:
                              each panel's diagonal factor and solve below
                              it, one `hopper_kernels.signed_panel` launch
                              on the card (`ldlt.blocked_signed_cholesky`)
  chol.step.extend_add        there: the children's updates added into the
                              fronts: the square fronts formed from the
                              pivot slabs and the updates in one pass
                              (`_form_front`, also in `ldlt.factor_qd`),
                              or `_apply_extadd_two_piece` (its leaf tier
                              forms the leaves' products in it)
  chol.solve                  SparseCholesky.solve
  chol.solve.ell_index        the residual's ELL layout (index and source
                              map) built on the host and uploaded, once
                              per solver and engine
  chol.solve.ell_build        the ELL value planes refilled on the device
                              after an update (a gather and the f64 split)
  chol.solve.ell_upload       the values' upload for that refill
  chol.solve.inv_pivots       the pivot inverses built
  chol.solve.host_loop        the host refinement loop
  chol.refine.apply           each application of the factor in a
                              refinement loop (`refine._iterate`)
  chol.refine.resid           each double-float residual there
  chol.refine.norm            each residual norm there (a host read)
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

# records kept; older ones are dropped (and counted) past it. A record on
# the card holds its CUDA event pair until its extent is read, so the bound
# also bounds the events alive (a 5 s traced window of a refactor loop
# opens ~1,000 spans, ~3,700 with the level steps, of a solve loop ~3,000)
LIMIT = 1 << 16


class _Recorder:
    """The kept records and the count of those opened."""

    def __init__(self):
        self.records = deque(maxlen=LIMIT)
        self.opened = 0


_recorder = _Recorder()
_ids = itertools.count()
_local = threading.local()          # each thread's stack of open spans
_OFF = contextlib.nullcontext()     # the shared context of a span that is off


class Span:
    """One span: `name`, `id` (the order of opening over the process),
    `parent` (the id of the top-level span it lies in, None for a
    top-level one), `t0_ns` / `t1_ns` (host clock, `perf_counter_ns`;
    `t1_ns` None while open)."""

    __slots__ = ("name", "id", "parent", "t0_ns", "t1_ns", "_device",
                 "_events", "_device_ms", "_annotation")

    def __init__(self, name: str, device=None):
        self.name = name
        self._device = (device if device is not None
                        and torch.device(device).type == "cuda" else None)
        self.id = self.parent = self.t0_ns = self.t1_ns = None
        self._events = self._device_ms = self._annotation = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[0].id if stack else None
        self._annotation = record_function(self.name)
        self._annotation.__enter__()
        if self._device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self._device))
            self._events = (start, None)
        _recorder.records.append(self)
        _recorder.opened += 1
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            self._events = (self._events[0], end)
        _local.stack.remove(self)
        annotation, self._annotation = self._annotation, None
        annotation.__exit__(*exc)
        return False

    @property
    def host_ms(self):
        """Host wall in ms (None while open)."""
        return None if self.t1_ns is None else (self.t1_ns - self.t0_ns) / 1e6

    @property
    def device_ms(self):
        """Device extent in ms: stream time from the span's first marker to
        its last. None without a CUDA device, or while open. Waits for the
        last marker the first time it is read."""
        if self._events is not None and self._events[1] is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


def span(name: str, device=None):
    """The context of the span `name`: while a profiler records, a `Span`
    (with its device extent when `device` is a CUDA device); otherwise the
    shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device)


class _Level:
    __slots__ = ("lvl", "hook", "span")

    def __init__(self, lvl, hook, span_):
        self.lvl, self.hook, self.span = lvl, hook, span_

    def __enter__(self):
        if self.hook is not None:
            self.hook(self.lvl, "start")
        if self.span is not None:
            self.span.__enter__()

    def __exit__(self, *exc):
        if self.span is not None:
            self.span.__exit__(*exc)
        if exc[0] is None and self.hook is not None:
            self.hook(self.lvl, "end")
        return False


def level(lvl: int, hook=None, device=None):
    """The scope of one level of a level loop: `hook(lvl, "start")` on
    entry and `hook(lvl, "end")` on a normal exit (a loop's `level_hook`,
    None for none), and between them, while a profiler records, the span
    `chol.level.L<lvl:02d>`."""
    on = _profiler._is_profiler_enabled
    if hook is None and not on:
        return _OFF
    return _Level(lvl, hook, Span(f"chol.level.L{lvl:02d}", device)
                  if on else None)


def spans() -> list:
    """The kept records, oldest first (the last LIMIT opened)."""
    return list(_recorder.records)


def dropped() -> int:
    """Records opened since the last `clear()` but no longer kept."""
    return _recorder.opened - len(_recorder.records)


def clear() -> None:
    """Empty the list and its count of dropped records."""
    _recorder.records.clear()
    _recorder.opened = 0

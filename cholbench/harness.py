"""One run of one cell of the benchmark (see `run.py` for the command).

Everything that belongs to a configuration, a traffic mix or a metric is
found by name under the benchmark's directory:

  configs/<config>.json    the deployment: operator and size, ordering
                           depth, dtype, matmul rung, residual contract,
                           the limit of the factor check, its fixed work
                           (`yardstick.count_work`) and its control
  operators/<kind>.py      the operator a configuration names: its matrix
                           and ordering, the solver built on them
                           (`build`), and its plain reference
  mixes/<traffic>.json     the traffic's parameters (`traffic.py`)
  requests/<request>.py    the request a mix names: `warm(ctx)` in set-up,
                           `serve(ctx, slot, spans)` in the window
  metrics/<metric>.py      one reader per metric: `read(rec)` returns the
                           value, or None where the run has nothing to read

A run: set-up (inputs from the seed, the solver planned, factored and
warmed on this cell's shapes), a closed-loop window of `--seconds` with one
caller, then the check of what the window produced against the reference,
then the metrics of the run's kind (`--trace 0`: the cell's end-to-end
metrics; `--trace 1`: its per-layer metrics, read from spans and a
`torch.profiler` trace of the window).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time

import numpy as np

from cholbench import tracing, traffic, yardstick

# top-level module names that no run may load (whole-name comparison: the
# solver under test, cholesky_tpu_torch, begins with one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "cholesky_tpu")
# a traced run's window: it closes after TRACE_S seconds and TRACE_REQUESTS
# requests, or at --seconds, whichever comes first
TRACE_S = 5.0
TRACE_REQUESTS = 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with its configuration, mix, operator and
    metric readers, all found by name under `root`."""

    def __init__(self, root, workload, trace):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; cells: "
                             f"{sorted(cells)}")
        self.entry = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        with open(os.path.join(root, configs[self.entry["config"]]["file"])
                  ) as f:
            self.cfg = json.load(f)
        self.dir = os.path.join(root, "cholbench")
        self.mix = traffic.load_mix(self.dir, self.entry["traffic"])
        self.operator = yardstick.operator(self.cfg, self.dir)
        request = self.mix["request"]
        self.request = yardstick.load_module(
            os.path.join(self.dir, "requests", request + ".py"),
            "cholbench_request_" + request)
        kind = "per_layer" if trace else "end_to_end"
        self.metrics = [m for m in bench[kind]
                        if workload in m.get("workloads", [workload])]
        self.readers = {
            m["name"]: yardstick.load_module(
                os.path.join(self.dir, "metrics", m["name"] + ".py"),
                "cholbench_metric_" + m["name"].replace(".", "_"))
            for m in self.metrics}


class Record:
    """What a run measured, for the metric readers."""

    def __init__(self, cfg, mix):
        self.cfg, self.mix = cfg, mix
        self.requests = []        # per request: t0, t1, spans, sweeps, ...
        self.setup_s = None
        self.window = None        # (start, end of the last request) seconds
        self.profile = None       # tracing.read_trace of a traced window
        self.slab_levels = []     # [B, F, W] of each kernel-routed level
        self.window_peak_bytes = None

    @property
    def rung(self):
        return self.cfg["rung"]


def _sync(device):
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return None


class Context:
    """What a request module works with: the solver, the inputs, the
    matrix's values for each input slot, the tolerance."""

    def __init__(self, solver, inputs, vals, tol):
        self.solver, self.inputs, self.tol = solver, inputs, tol
        diag = solver.rows == solver.cols
        self.values = [traffic.shifted(vals, diag, sh) if sh else vals
                       for sh in inputs.shifts]


def routed_slabs(solver):
    """[B, F, W] of each level of the solver's last factorization that its
    plan routes through the slab kernels (`factor_slab`): the level's
    fronts, front size and pivot width from the frontal plan, the batch
    per chunk from the regime plan, the routing rule the solver's own."""
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    plan, fp = solver.regimes, solver.fplan
    if plan is None:
        return []
    out = []
    for lvl in range(fp.levels):
        B, F, W = plan.family << lvl, int(fp.F[lvl]), int(fp.W[lvl])
        if hk.slab_kernel_eligible(B // plan.levels[lvl].chunks, W,
                                   plan.dtype):
            out.append((B, F, W))
    return out


def _apply_once(solver, b):
    """One unrefined application of the solver's factor (the factor
    check), or None when it raises."""
    try:
        return solver.solve(b, refine="never")
    except Exception as exc:
        log(f"the factor check's solve raised {type(exc).__name__}: {exc}")
        return None


def run(root, workload, seed, seconds, trace, device, t_start,
        prepare=None):
    """One run of a cell; returns (result dict, checks). `prepare(solver,
    cfg)`, when given, is applied to the solver before its first
    factorization (the control uses it)."""
    import torch

    device = torch.device(device)
    cell = Cell(root, workload, trace)
    cfg, mix, op, req = cell.cfg, cell.mix, cell.operator, cell.request
    rec = Record(cfg, mix)

    # set-up: the solver, inputs, warm-up on this cell's shapes
    solver, vals = op.build(cfg, device)
    inputs = traffic.Inputs(mix, int(solver.plan.n), seed)
    ctx = Context(solver, inputs, vals, float(cfg["tol"]))
    if prepare is not None:
        prepare(solver, cfg)
    req.warm(ctx)
    sync = _sync(device)
    if sync is not None:
        sync()
        pre_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    request_span = (lambda: record_function("cholbench.request")) if trace \
        else contextlib.nullcontext
    spans = tracing.Spans(sync if trace else None, trace)

    # the window: a closed loop with one caller
    answers = []                  # (k, slot, x) of the checked requests
    factor_checks = []            # (slot, x0): unrefined applications
    failed_requests = 0
    k = 0
    t_open = time.perf_counter()
    rec.setup_s = t_open - t_start
    limit_s = min(seconds, TRACE_S) if trace else seconds
    while True:
        slot = inputs.slot(k)
        spans.current = {}
        t0 = time.perf_counter()
        try:
            with request_span():
                x = req.serve(ctx, slot, spans)
        except Exception as exc:          # the run reports it, not correct
            log(f"request {k} raised {type(exc).__name__}: {exc}")
            failed_requests += 1
            k += 1
            break
        t1 = time.perf_counter()
        last = solver.last_solve
        entry = {"t0": t0, "t1": t1, "spans": spans.current,
                 "sweeps": last.get("sweeps", 0),
                 "host_sweeps": last.get("host_sweeps", 0),
                 "loop": last.get("loop"), "check_s": 0.0}
        rec.requests.append(entry)
        if inputs.checked(k):
            answers.append((k, slot, x))
        if inputs.factor_checked(k):
            # outside the request's span; the window metrics leave it out
            factor_checks.append((slot, _apply_once(solver,
                                                    inputs.rhs[slot])))
            entry["check_s"] = time.perf_counter() - t1
        k += 1
        if t1 - t_open >= seconds or (t1 - t_open >= limit_s
                                      and k >= TRACE_REQUESTS):
            break
    if rec.requests:
        rec.window = (t_open, rec.requests[-1]["t1"])
    if rec.requests and (not answers
                         or answers[-1][0] != len(rec.requests) - 1):
        answers.append((len(rec.requests) - 1,
                        inputs.slot(len(rec.requests) - 1), x))

    # the window has closed: peak, trace, then the factor check
    peak = None
    if sync is not None:
        sync()
        rec.window_peak_bytes = torch.cuda.max_memory_allocated(device)
        peak = max(pre_peak, rec.window_peak_bytes)
    if trace:
        prof.stop()
        rec.profile = tracing.read_trace(
            prof.profiler.kineto_results.events())
        del prof
        rec.slab_levels = routed_slabs(solver)
    fslot = answers[-1][1] if answers else inputs.warm
    factor_checks.append((fslot, _apply_once(solver, inputs.rhs[fslot])))
    del solver, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, failed = check(op.Reference(cfg), cfg, inputs, answers,
                           factor_checks, failed_requests)
    metrics = {}
    for m in cell.metrics:
        value = cell.readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": k, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        result["breakdown"] = {"device_ops": rec.profile["device_ops"],
                               "idle_gaps": rec.profile["idle_gaps"]}
    loops = [r["loop"] for r in rec.requests]
    log(f"# {workload} seed {seed}: {len(rec.requests)} requests in "
        f"{(rec.window[1] - rec.window[0]) if rec.window else 0:.3f} s, "
        f"setup {rec.setup_s:.3f} s; solves finished on the host loop: "
        f"{loops.count('host')}; host sweeps "
        f"{sum(r['host_sweeps'] for r in rec.requests)}; factors checked "
        f"{len(factor_checks)}")
    return result, checks


def check(ref, cfg, inputs, answers, factor_checks, failed_requests):
    """The comparison that decides `correct`, in float64 against the
    operator's plain reference:

      resid_max      the largest relative residual ||b - A x|| / ||b|| of
                     the checked answers (of their worst column) (limit:
                     the configuration's contract `tol`);
      factor_eta     the largest normwise backward error ||b - A x0||_inf /
                     (||A||_inf ||x0||_inf + ||b||_inf) of the unrefined
                     applications `factor_checks` ((slot, x0): the factors
                     the mix's factor_check_every picked and the window's
                     last) (limit `limits.factor_eta`);
      failed         requests that raised or whose answer missed `tol`, and
                     factor checks that raised (limit 0).

    Returns ({name: {"value", "limit"}}, failed)."""
    tol = float(cfg["tol"])
    worst = 0.0
    wrong = 0
    for _, slot, x in answers:
        shift = inputs.shifts[slot]
        b = inputs.rhs[slot]
        r = float(np.max(np.linalg.norm(b - ref.matvec(x, shift), axis=0)
                         / np.linalg.norm(b, axis=0)))
        if not np.isfinite(r):
            r = float("inf")
        worst = max(worst, r)
        wrong += r > tol
    eta = 0.0
    unanswered = 0
    for slot, x0 in factor_checks:
        if x0 is None:
            unanswered += 1
            eta = float("inf")
            continue
        shift = inputs.shifts[slot]
        b = inputs.rhs[slot]
        x0 = np.asarray(x0, dtype=np.float64)
        r = b - ref.matvec(x0, shift)
        den = ref.norm_inf(shift) * np.abs(x0).max() + np.abs(b).max()
        e = float(np.abs(r).max() / den)
        eta = max(eta, e if np.isfinite(e) else float("inf"))
    if not factor_checks:
        eta = float("inf")
    failed = failed_requests + wrong
    if not answers:
        worst = float("inf")
    checks = {"resid_max": {"value": worst, "limit": tol},
              "factor_eta": {"value": eta,
                             "limit": float(cfg["limits"]["factor_eta"])},
              "failed": {"value": failed + unanswered, "limit": 0}}
    return checks, failed

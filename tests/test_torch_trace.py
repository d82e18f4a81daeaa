"""The port's spans (`cholesky_tpu_torch/trace.py`) on the CPU: off, a span
reads one flag and enters nothing; under `torch.profiler` the solver emits
its spans where and as often as its work runs, each tied to its top-level
call and mirrored by a user annotation of the profiler; and the
benchmark's readers of those spans (`cholbench/metrics/_program.py`) give
their numbers through a traced run of the harness.
"""

import dataclasses
import json
import os
import sys
import time
from collections import defaultdict, deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cholesky_tpu_torch
from cholesky_tpu_torch import trace
from cholesky_tpu_torch.numeric import frontal, ldlt, regimes
from cholesky_tpu_torch.utils.laplacian import generate_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cholbench import harness, yardstick  # noqa: E402
from cholbench.tests.test_cholbench_harness import (  # noqa: E402
    bench_copy, run_cell)

# the metrics that read the solver's spans: (name, cell kind, a number on
# the CPU); the device extents have nothing to read there
PROGRAM_METRICS = [("ell_build_ms.cycle", "refactor", True),
                   ("ell_upload_ms.cycle", "refactor", True),
                   ("inv_pivots_ms.cycle", "refactor", False),
                   ("factor_issue_ms.cycle", "refactor", True),
                   ("apply_host_ms.solve", "solve", True),
                   ("apply_dev_ms.solve", "solve", False),
                   ("extadd_ms.cycle", "refactor", False),
                   ("pivot_ms.cycle", "refactor", False),
                   ("schur_ms.cycle", "refactor", False),
                   ("pivot_roofline_pct.cycle", "refactor", False),
                   ("schur_roofline_pct.cycle", "refactor", False),
                   ("signed_diag_ms.cycle", "refactor", False)]
# the refactor cells; the step rooflines read a configuration's step_work,
# which only the elasticity configurations have; the signed column loop
# runs only in the hybrid u-p cell
ELAST = "elast_q1_64.newmark"
MIXED = "elast_q1p0_48.refactor_fixed"
CELLS = {"pivot_roofline_pct.cycle": [ELAST, MIXED],
         "schur_roofline_pct.cycle": [ELAST, MIXED],
         "signed_diag_ms.cycle": [MIXED]}
STEPS = (frontal.PIVOT, frontal.SCHUR, frontal.EXTEND_ADD)
SIGNED_STEPS = STEPS + (ldlt.SIGNED_DIAG,)


def _solver(signs=False):
    """An f32 solver of the 8^3 Laplacian at 3 levels on the CPU; with
    `signs`, of a quasi-definite matrix on its pattern (a seeded 40% of the
    diagonal's signs flipped, |diag| + 0.5: both sign blocks stay
    diagonally dominant)."""
    n, r, c, v, o, cl, b = generate_problem((8, 8, 8), 3)
    kw = {}
    if signs:
        kw["signs"] = np.where(np.random.default_rng(5).random(n) < 0.4,
                               -1.0, 1.0)
        d = r == c
        v = v.copy()
        v[d] = kw["signs"][r[d]] * (v[d] + 0.5)
    s = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu", **kw)
    return s, v, b


def _cycle(s, vals, b, solves=2):
    s.update_values(vals)
    s.factorize()
    return [(s.solve(b), dict(s.last_solve)) for _ in range(solves)]


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler")


def test_off_span_reads_a_flag_and_enters_nothing(monkeypatch):
    s, v, b = _solver()
    s.factorize()
    s.solve(b)
    monkeypatch.setattr(trace, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    trace.clear()
    seen = []
    (x, last), = _cycle(s, v * 1.5, b, solves=1)
    s.factorize(level_hook=lambda lvl, what: seen.append((lvl, what)))
    assert trace.spans() == [] and trace.dropped() == 0
    assert trace.span("a", "cpu") is trace.span("b") is trace.level(0)
    # the level loop still calls its hook around each level, in order
    L = s.fplan.levels
    assert seen == [(lvl, w) for lvl in range(L - 1, -1, -1)
                    for w in ("start", "end")]
    assert s.residual(b, x) <= 1e-10


def _closed(spans):
    return [sp for sp in spans if sp.t1_ns is not None]


def _by_top(spans):
    """{top-level span: [its records]} in the order opened."""
    tops = {sp.id: sp for sp in spans if sp.parent is None}
    out = {sp: [] for sp in tops.values()}
    for sp in spans:
        if sp.parent is not None:
            out[tops[sp.parent]].append(sp)
    return out


@pytest.fixture(scope="module")
def traced_cycles():
    """Two cycles of update_values -> factorize -> solve, solve under
    torch.profiler, on a warm f32 solver; (solver, spans, profiler events,
    last_solve of each solve)."""
    s, v, b = _solver()
    s.factorize()
    s.solve(b)
    trace.clear()
    lasts = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2):
            lasts += [last for _, last in _cycle(s, v * (1.0 + k), b)]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("chol.")
              and "CUDA" not in str(e.device_type())]
    return s, trace.spans(), events, lasts


def test_spans_of_a_cycle(traced_cycles):
    s, spans, _, lasts = traced_cycles
    assert spans and _closed(spans) == spans and trace.dropped() == 0
    tops = list(_by_top(spans).items())
    assert [t.name for t, _ in tops] == [
        "chol.update_values", "chol.factorize", "chol.solve",
        "chol.solve"] * 2
    L = s.fplan.levels
    for i, (top, kids) in enumerate(tops):
        names = [k.name for k in kids if k.name not in STEPS]
        if top.name == "chol.factorize":
            assert names == (["chol.factorize.plan", "chol.factorize.fronts"]
                             + [f"chol.level.L{lvl:02d}"
                                for lvl in range(L - 1, -1, -1)])
        elif top.name == "chol.solve":
            first = tops[i - 1][0].name == "chol.factorize"
            last = lasts[[t.name for t, _ in tops[:i]].count("chol.solve")]
            assert last["engine"] == "banded" and last["loop"] == "device"
            # the banded engine, on the first solve after the update only:
            # the values uploaded, the ELL value planes refilled on the
            # device, the pivot inverses; the ELL layout (chol.solve.
            # ell_index) was built on the solver's first solve, before
            assert last["ell"] == ("refill" if first else "kept")
            rebuild = (["chol.solve.ell_upload", "chol.solve.ell_build",
                        "chol.solve.inv_pivots"] if first else [])
            sweeps = ["chol.refine.apply", "chol.refine.resid",
                      "chol.refine.norm"] * (last["sweeps"] + 1)
            assert names == rebuild + sweeps
            assert names.count("chol.refine.apply") == last["sweeps"] + 1
        else:
            assert names == []


def test_ell_index_on_a_solvers_first_solve_only():
    """The ELL layout is built once, on a solver's first solve (its host
    pattern, then the engine's index on the device), and kept across
    update_values: the next cycle's solve only refills the value planes."""
    s, v, b = _solver()
    s.factorize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        s.solve(b)
        first = dict(s.last_solve)
        (_, again), = _cycle(s, v * 2.0, b, solves=1)
    tops = [(t.name, [k.name for k in kids])
            for t, kids in _by_top(trace.spans()).items()]
    solves = [kids for name, kids in tops if name == "chol.solve"]
    assert len(solves) == 2
    assert solves[0][:5] == ["chol.solve.ell_index", "chol.solve.ell_index",
                             "chol.solve.ell_upload", "chol.solve.ell_build",
                             "chol.solve.inv_pivots"]
    assert solves[1][:3] == ["chol.solve.ell_upload", "chol.solve.ell_build",
                             "chol.solve.inv_pivots"]
    assert [n for _, kids in tops for n in kids].count(
        "chol.solve.ell_index") == 2
    assert (first["ell"], again["ell"]) == ("index", "refill")


def test_each_record_lies_in_its_top_level_call(traced_cycles):
    _, spans, _, _ = traced_cycles
    for top, kids in _by_top(spans).items():
        for k in kids:
            assert top.id < k.id and k.parent == top.id
            assert top.t0_ns <= k.t0_ns <= k.t1_ns <= top.t1_ns
            assert k.host_ms >= 0 and k.device_ms is None   # the CPU
    ids = [sp.id for sp in spans]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)


def test_each_record_is_a_profiler_annotation_nested_alike(traced_cycles):
    _, spans, events, _ = traced_cycles
    kinds = {e.activity_type() for e in events
             if hasattr(e, "activity_type")}
    assert kinds <= {"user_annotation"}
    by_name = defaultdict(list)
    for e in sorted(events, key=lambda e: e.start_ns()):
        by_name[e.name()].append(e)
    seen = defaultdict(int)
    match = {}
    for sp in spans:                    # records in the order opened
        match[sp.id] = by_name[sp.name][seen[sp.name]]
        seen[sp.name] += 1
    assert dict(seen) == {k: len(v) for k, v in by_name.items()}
    for sp in spans:
        if sp.parent is not None:
            e, top = match[sp.id], match[sp.parent]
            assert top.start_ns() <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= (top.start_ns()
                                                      + top.duration_ns())


def test_level_spans_of_the_signed_factorization():
    s, v, b = _solver(signs=True)
    s.factorize()
    trace.clear()
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        s.factorize(level_hook=lambda lvl, what: seen.append(what))
    (top, kids), = _by_top(trace.spans()).items()
    L = s.fplan.levels
    assert top.name == "chol.factorize"
    assert [k.name for k in kids if k.name.startswith("chol.level.")] == [
        f"chol.level.L{lvl:02d}" for lvl in range(L - 1, -1, -1)]
    assert seen == ["start", "end"] * L


def _regime(s, kind):
    """The regime plan `kind` of an 8^3 L3 solver: the default (square
    fronts), two-piece fronts fed by the leaves' X (xxt tier) or by their
    X X^T (gather tier), or square fronts in two batch chunks below the
    root."""
    if kind == "square":
        return regimes.plan_regimes(s.fplan, s.dtype, 1 << 40,
                                    two_piece=False)
    if kind == "chunks":
        return regimes.plan_regimes(s.fplan, s.dtype, 1 << 40,
                                    two_piece=False, chunks={2: 2, 1: 2})
    plan = regimes.plan_regimes(s.fplan, s.dtype, 1 << 40, two_piece=True)
    if kind == "gather":
        plan.levels = [dataclasses.replace(lp, xxt_tier=False)
                       for lp in plan.levels]
    return plan


def _expected_steps(fp, lp, lvl):
    """The step spans `_factor_level` opens in one chunk of level `lvl`:
    the leaves' deferred X X^T (unless a two-piece level's xxt tier forms
    it inside its extend-add), the extend-add where the children emit an
    update, the partial factorization, and the Schur update below the
    root where the front has a boundary."""
    L = fp.levels
    if lvl == L - 1:
        return [frontal.PIVOT]
    leaf_x = lvl == L - 2 and fp.F[L - 1] > fp.W[L - 1]
    out = []
    if leaf_x and not (lp.two_piece and lp.xxt_tier):
        out.append(frontal.SCHUR)
    if fp.F[lvl + 1] > fp.W[lvl + 1]:
        out.append(frontal.EXTEND_ADD)
    out.append(frontal.PIVOT)
    if lvl > 0 and fp.F[lvl] > fp.W[lvl]:
        out.append(frontal.SCHUR)
    return out


@pytest.mark.parametrize("kind", ["square", "xxt", "gather", "chunks"])
def test_step_spans_of_each_level(kind):
    """A traced factorization opens, inside each level's span, the spans
    of that level's steps, once per chunk, in the order the steps run."""
    s, v, b = _solver()
    s._plan_override = _regime(s, kind)
    s.factorize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        s.factorize()
    spans = trace.spans()
    levels = [sp for sp in spans if sp.name.startswith("chol.level.")]
    steps = [sp for sp in spans if sp.name in STEPS]
    fp = s.fplan
    assert [sp.name for sp in levels] == [
        f"chol.level.L{lvl:02d}" for lvl in range(fp.levels - 1, -1, -1)]
    seen = 0
    for sp in levels:
        lvl = int(sp.name[-2:])
        lp = s.regimes.levels[lvl]
        inside = [st for st in steps if sp.t0_ns <= st.t0_ns <= sp.t1_ns]
        assert [st.name for st in inside] == (
            _expected_steps(fp, lp, lvl) * lp.chunks)
        assert all(st.t1_ns <= sp.t1_ns and st.parent == sp.parent
                   for st in inside)
        seen += len(inside)
    assert seen == len(steps) > 0
    assert [lp.chunks for lp in s.regimes.levels] == (
        [1, 2, 2] if kind == "chunks" else [1, 1, 1])
    assert s.residual(b, s.solve(b)) <= 1e-10


def _expected_signed_steps(fp, lvl):
    """The step spans `ldlt._factor_level_qd` opens in level `lvl`: the
    fronts formed (not at the leaves), the pivot step with a column loop a
    panel inside it, and the Schur update below the root where the front
    has a boundary."""
    out = [] if lvl == fp.levels - 1 else [frontal.EXTEND_ADD]
    out += [frontal.PIVOT] + [ldlt.SIGNED_DIAG] * -(-int(fp.W[lvl])
                                                    // ldlt.PANEL)
    if lvl > 0 and fp.F[lvl] > fp.W[lvl]:
        out.append(frontal.SCHUR)
    return out


def test_step_spans_of_each_signed_level():
    """A traced signed factorization opens, inside each level's span, its
    steps' spans in the order they run, each panel's column loop inside
    the level's pivot step; the counters give the loop's panels and
    columns."""
    s, v, b = _solver(signs=True)
    s.factorize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        s.factorize()
    spans = trace.spans()
    levels = [sp for sp in spans if sp.name.startswith("chol.level.")]
    steps = [sp for sp in spans if sp.name in SIGNED_STEPS]
    fp = s.fplan
    assert [sp.name for sp in levels] == [
        f"chol.level.L{lvl:02d}" for lvl in range(fp.levels - 1, -1, -1)]
    seen = 0
    for sp in levels:
        lvl = int(sp.name[-2:])
        inside = [st for st in steps if sp.t0_ns <= st.t0_ns <= sp.t1_ns]
        assert [st.name for st in inside] == _expected_signed_steps(fp, lvl)
        pivot, = [st for st in inside if st.name == frontal.PIVOT]
        for st in inside:
            assert st.t1_ns <= sp.t1_ns and st.parent == sp.parent
            if st.name == ldlt.SIGNED_DIAG:
                assert pivot.t0_ns <= st.t0_ns and st.t1_ns <= pivot.t1_ns
        seen += len(inside)
    assert seen == len(steps) > 0
    W = [int(w) for w in fp.W]
    assert s.factor_stats["signed_columns"] == sum(W)
    assert s.factor_stats["signed_panels"] == len(
        [st for st in steps if st.name == ldlt.SIGNED_DIAG])
    assert s.residual(b, s.solve(b)) <= 1e-10


def test_signed_step_spans_off_record_nothing(monkeypatch):
    s, v, b = _solver(signs=True)
    s.factorize()
    monkeypatch.setattr(trace, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    trace.clear()
    s.update_values(v * 2.0)
    s.factorize()
    assert trace.spans() == [] and trace.dropped() == 0
    assert s.residual(b, s.solve(b)) <= 1e-10


@pytest.mark.parametrize("kind", ["square", "xxt", "gather", "chunks"])
def test_step_spans_off_record_nothing(kind, monkeypatch):
    s, v, b = _solver()
    s._plan_override = _regime(s, kind)
    s.factorize()
    monkeypatch.setattr(trace, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    trace.clear()
    s.update_values(v * 2.0)
    s.factorize()
    assert trace.spans() == [] and trace.dropped() == 0
    assert s.residual(b, s.solve(b)) <= 1e-10


class _FakeSpan:
    def __init__(self, name, t0, device_ms):
        self.name, self.t0_ns, self.t1_ns = name, int(t0 * 1e9), int(
            t0 * 1e9) + 1
        self.device_ms, self.host_ms = device_ms, 1e-6


def test_step_readers_sum_per_cycle_and_divide_the_step_work(monkeypatch):
    """The step metrics sum a cycle's device extents of their span; the
    rooflines divide the step's least time by that sum, and read nothing
    in a configuration without `step_work`."""
    from cholbench.metrics import _program

    with open(os.path.join(REPO, "cholbench/configs/elast_q1_64.json")) as f:
        cfg = json.load(f)
    rec = harness.Record(cfg, {"request": "cycle"})
    rec.requests = [{"t0": 1.0, "t1": 2.0, "spans": {}},
                    {"t0": 3.0, "t1": 4.0, "spans": {}}]
    fake = [_FakeSpan(frontal.PIVOT, 1.1, 100.0),
            _FakeSpan(frontal.PIVOT, 1.2, 20.0),
            _FakeSpan(frontal.SCHUR, 1.3, 300.0),
            _FakeSpan(frontal.PIVOT, 2.5, 999.0),      # between cycles
            _FakeSpan(frontal.PIVOT, 3.1, 80.0),
            _FakeSpan(frontal.SCHUR, 3.2, 500.0)]
    monkeypatch.setattr(_program, "_recorded", lambda: fake)

    def read(name, r=rec):
        path = os.path.join(REPO, "cholbench/metrics", name + ".py")
        return yardstick.load_module(path, "m").read(r)

    assert read("pivot_ms.cycle") == pytest.approx(100.0)
    assert read("schur_ms.cycle") == pytest.approx(400.0)
    assert read("extadd_ms.cycle") is None
    work = cfg["step_work"]
    for step, ms in (("pivot", 100.0), ("schur", 400.0)):
        least, _ = yardstick.least_seconds(work[step + "_flops"],
                                           work[step + "_bytes"], "ieee")
        assert read(f"{step}_roofline_pct.cycle") == pytest.approx(
            100.0 * least / (ms / 1e3))
    del rec.cfg["step_work"]
    assert read("pivot_roofline_pct.cycle") is None
    assert read("pivot_ms.cycle") == pytest.approx(100.0)


def test_a_raising_level_closes_its_span_and_skips_the_end_hook():
    s, v, b = _solver()
    trace.clear()
    seen = []

    def hook(lvl, what):
        seen.append(what)
        if lvl == 1 and what == "start":
            raise RuntimeError("planted")

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="planted"):
            s.factorize(level_hook=hook)
        with trace.span("after"):
            pass
    spans = trace.spans()
    assert _closed(spans) == spans
    assert seen == ["start", "end", "start"]          # level 2, then 1
    assert spans[-1].name == "after" and spans[-1].parent is None


def test_the_list_is_bounded_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(trace._recorder, "records", deque(maxlen=3))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [sp.name for sp in trace.spans()] == ["s2", "s3", "s4"]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


# ----------------------------------------------------- the benchmark's readers

@pytest.mark.parametrize("name,kind,on_cpu", PROGRAM_METRICS)
def test_program_metric_declared_with_a_reader(name, kind, on_cpu):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    m, = [m for m in bench["per_layer"] if m["name"] == name]
    assert m["workloads"] == CELLS.get(name, [f"lapl7_50.{kind}"] + (
        [ELAST, MIXED] if kind == "refactor" else ["lapl7_50.block16"]))
    assert m["moves"] == ("cycle_ms" if kind == "refactor" else "solve_ms")
    assert m["source"] == ("host_clock" if on_cpu else "device_trace")
    path = os.path.join(REPO, "cholbench/metrics", name + ".py")
    assert hasattr(yardstick.load_module(path, "m"), "read")


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """A traced run of each small cell through the harness on the CPU."""
    root, _ = bench_copy(tmp_path_factory.mktemp("trace"))
    return {kind: run_cell(root, f"lapl7_t.{kind}", seconds=0.3, trace=True)
            for kind in ("refactor", "solve")}


@pytest.mark.parametrize("name,kind,on_cpu", PROGRAM_METRICS)
def test_program_metric_in_a_traced_run(traced_runs, name, kind, on_cpu):
    res, checks = traced_runs[kind]
    assert res["correct"], checks
    if on_cpu:
        value = res["metrics"][name]["value"]
        assert value > 0 and res["metrics"][name]["unit"] == "ms"
    else:
        assert name not in res["metrics"]      # no device extent on the CPU


def test_program_metrics_read_nothing_without_spans():
    """A window whose requests hold no span of the solver (an untraced
    run) gives None from every reader."""
    with open(os.path.join(REPO, "cholbench/configs/lapl7_50.json")) as f:
        cfg = json.load(f)
    for kind, request in (("refactor", "cycle"), ("solve", "solve")):
        rec = harness.Record(cfg, {"request": request})
        t = time.perf_counter()
        with trace.span("chol.solve.ell_build"):  # no profiler: not kept
            pass
        rec.requests = [{"t0": t, "t1": time.perf_counter(), "spans": {},
                         "sweeps": 1, "check_s": 0.0}]
        for name, k, _ in PROGRAM_METRICS:
            path = os.path.join(REPO, "cholbench/metrics", name + ".py")
            assert yardstick.load_module(path, "m").read(rec) is None, name

"""CPU tests of the benchmark harness: discovery of configurations, mixes
and metrics by name, the yardstick's work count, the window metrics, the
command's refusals, the import check, and the comparison that decides
`correct` against faults planted under a run.

    python -m pytest cholbench/tests -q

Runs in-process on the CPU at 6^3 / 8^3; the card's own test is
`test_cholbench_control.py` (marker `cuda`).
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from cholbench import harness, traffic, yardstick  # noqa: E402
from cholbench.metrics import _common  # noqa: E402

SEED = 3_000_000_019          # above 2**31: seeds need not fit 32 bits


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def bench_copy(tmp_path, shape=(8, 8, 8), levels=3, name="lapl7_t"):
    """BENCHMARK.json and cholbench/ copied to tmp_path, plus a small
    configuration `name` and its two cells (`<name>.refactor`,
    `<name>.solve`) added as a new file and new entries, every metric that
    lists the 50^3 cells listing them too."""
    root = tmp_path / "bench"
    shutil.copytree(os.path.join(REPO, "cholbench"), root / "cholbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    with open(os.path.join(REPO, "cholbench/configs/lapl7_50.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, n=int(np.prod(shape)), levels=levels,
               operator={"kind": "laplacian7", "shape": list(shape),
                         "boundary": "dirichlet"})
    cfg["work"] = yardstick.count_work(cfg)
    with open(root / "cholbench/configs" / f"{name}.json", "w") as f:
        json.dump(cfg, f)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"cholbench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    for mix in ("refactor", "solve"):
        bench["workloads"].append({"name": f"{name}.{mix}", "config": name,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("lapl7_50", name)
                               for w in m["workloads"]
                               if w.startswith("lapl7_50.")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root, bench


def run_cell(root, workload, seconds=0.3, trace=False, prepare=None,
             seed=SEED):
    return harness.run(str(root), workload, seed, seconds, trace, "cpu",
                       time.perf_counter(), prepare=prepare)


# --------------------------------------------------------------- discovery

NEW_METRIC = '''"""requests.solve: requests completed in the traced window."""


def read(rec):
    return float(len(rec.requests)) if rec.requests else None
'''


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    root, bench = bench_copy(tmp_path, shape=(6, 6, 6), levels=3,
                             name="lapl7_6")
    before = {p: _digest(os.path.join(REPO, "cholbench", p))
              for p in _files(os.path.join(REPO, "cholbench"))}
    # a new mix: two right-hand sides a request, every answer checked
    (root / "cholbench/mixes/block2.json").write_text(json.dumps(
        {"request": "solve", "shift": None, "columns": 2, "pool": 3,
         "check_every": 1}))
    (root / "cholbench/metrics/requests.solve.py").write_text(NEW_METRIC)
    bench["workloads"].append({"name": "lapl7_6.block2", "config": "lapl7_6",
                               "traffic": "block2", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "requests.solve", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "Device", "moves": "solve_ms",
                               "workloads": ["lapl7_6.block2"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("solve"):
            m["workloads"].append("lapl7_6.block2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    res, checks = run_cell(root, "lapl7_6.block2", trace=True)
    assert res["correct"], checks
    assert res["metrics"]["requests.solve"]["value"] == res["attempted"]
    assert set(res["metrics"]) == {"requests.solve"}
    res, _ = run_cell(root, "lapl7_6.block2")
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}
    # no file the benchmark already had was edited
    for p, d in before.items():
        if os.path.exists(root / "cholbench" / p):
            assert _digest(root / "cholbench" / p) == d, p


def _files(top):
    out = []
    for d, _, fs in os.walk(top):
        if "__pycache__" in d or os.sep + "tests" in d:
            continue
        out += [os.path.relpath(os.path.join(d, f), top) for f in fs]
    return out


def test_each_metric_has_a_reader_and_each_cell_reports(tmp_path):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        path = os.path.join(REPO, "cholbench/metrics", m["name"] + ".py")
        assert hasattr(yardstick.load_module(path, "m"), "read"), m["name"]
    cells = {w["name"] for w in bench["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for cell in cells:
            assert [m for m in bench[kind]
                    if cell in m.get("workloads", [cell])], (kind, cell)


# ---------------------------------------------------------------- yardstick

def _dense_boundaries(cfg):
    """Boundary rows of each front by a dense symbolic factorization of
    the permuted pattern."""
    op = yardstick.operator(cfg)
    n, r, c, _ = op.coo(cfg)
    seps = op.separators(cfg)
    order = np.concatenate([seps[s] for s in range(1, len(seps) + 1)])
    a = np.zeros((n, n), dtype=bool)
    a[r, c] = a[c, r] = True
    L = np.tril(a[np.ix_(order, order)])
    for j in range(n):
        idx = np.flatnonzero(L[j + 1:, j]) + j + 1
        for i in idx:
            L[idx[idx >= i], i] = True
    p = np.array([len(seps[s]) for s in range(1, len(seps) + 1)])
    ends = np.cumsum(p)
    m = [int(L[e:, e - k:e].any(axis=1).sum()) for k, e in zip(p, ends)]
    return p, np.array(m)


@pytest.mark.parametrize("shape,levels", [((6, 6, 6), 3), ((6, 6, 6), 2),
                                          ((7, 5, 6), 4)])
def test_work_count_against_dense_symbolic(shape, levels):
    cfg = {"operator": {"kind": "laplacian7", "shape": list(shape)},
           "levels": levels}
    op = yardstick.operator(cfg)
    n, r, c, _ = op.coo(cfg)
    p, m = yardstick.front_sizes(n, r, c, op.separators(cfg))
    pd, md = _dense_boundaries(cfg)
    assert np.array_equal(p, pd) and np.array_equal(m, md)
    flops, entries = yardstick.front_work(p, m)
    assert flops == pytest.approx(float(np.sum(
        pd ** 3 / 3 + md * pd ** 2 + md ** 2 * pd)), rel=1e-15)
    assert entries == int(np.sum(pd * (pd + 1) // 2 + md * pd))


def test_work_count_of_one_front_is_dense_cholesky():
    cfg = {"operator": {"kind": "laplacian7", "shape": [6, 6, 6]},
           "levels": 1}
    w = yardstick.count_work(cfg)
    assert w["flops"] == pytest.approx(216 ** 3 / 3)
    assert w["factor_entries"] == 216 * 217 // 2


@pytest.mark.parametrize("name", ["lapl7_50"])
def test_stored_work_is_the_count(name):
    with open(os.path.join(REPO, f"cholbench/configs/{name}.json")) as f:
        cfg = json.load(f)
    assert cfg["work"] == yardstick.count_work(cfg)
    n = int(np.prod(cfg["operator"]["shape"]))
    assert cfg["n"] == n


def test_slab_bound_is_bench_front_kernels_arithmetic():
    # [128, 1440, 864] at IEEE: 1.2322 ms, bound by operations
    assert yardstick.slab_bound_seconds(128, 1440, 864, "ieee") * 1e3 == \
        pytest.approx(1.2322, abs=1e-4)
    # [512, 256, 128] at TF32: bound by bytes, 0.0401 ms
    assert yardstick.slab_bound_seconds(512, 256, 128, "tf32") * 1e3 == \
        pytest.approx(0.0401, abs=1e-4)


def test_reference_matvec_is_the_matrix():
    cfg = {"operator": {"kind": "laplacian7", "shape": [4, 5, 3]},
           "levels": 2}
    op = yardstick.operator(cfg)
    n, r, c, v = op.coo(cfg)
    a = np.zeros((n, n))
    a[r, c] = v
    a = a + np.tril(a, -1).T + 0.25 * np.eye(n)
    x = np.random.default_rng(0).standard_normal(n)
    ref = op.Reference(cfg)
    assert np.allclose(ref.matvec(x, 0.25), a @ x, rtol=0, atol=1e-13)
    assert ref.norm_inf(0.25) == pytest.approx(np.abs(a).sum(axis=1).max())


def test_inputs_repeat_with_the_seed_and_stratify_shifts():
    mix = {"request": "cycle", "shift": {"tau_min": 1.0, "tau_max": 1e4},
           "pool": 16, "check_every": 1, "factor_check_every": 7}
    a, b = traffic.Inputs(mix, 50, SEED), traffic.Inputs(mix, 50, SEED)
    assert a.shifts == b.shifts
    assert all(np.array_equal(x, y) for x, y in zip(a.rhs, b.rhs))
    c = traffic.Inputs(mix, 50, SEED + 1)
    logtau = np.sort(np.log10(1 / np.array(c.shifts)))
    # one shift in each of the 17 slices of [0, 4]
    assert np.array_equal(np.floor(logtau / (4 / 17)), np.arange(17))
    # a factor check every 7th request visits every one of the 16 inputs
    assert {c.slot(k) for k in range(7 * 16) if c.factor_checked(k)} == \
        set(range(16))
    assert not any(traffic.Inputs(dict(mix, factor_check_every=0), 50,
                                  SEED).factor_checked(k) for k in range(20))


# ---------------------------------------------------------- window metrics

class _Rec:
    def __init__(self, request, walls, gap=0.001, check_s=0.0):
        self.mix = {"request": request}
        t, self.requests = 10.0, []
        for w in walls:
            self.requests.append({"t0": t, "t1": t + w, "spans": {},
                                  "sweeps": 2, "check_s": check_s})
            t += w + gap + check_s
        self.window = (10.0, self.requests[-1]["t1"])


def test_window_metrics_over_completed_requests():
    walls = [0.05] * 95 + [0.5] * 5
    rec = _Rec("cycle", walls)
    span = rec.window[1] - rec.window[0]
    assert _common.window_ms_per_request(rec, "cycle") == pytest.approx(
        span / 100 * 1e3)
    # a stall shows in the window metric
    assert span / 100 * 1e3 > 0.05 * 1e3 * 1.4
    assert _common.window_ms_per_request(rec, "solve") is None
    srec = _Rec("solve", [0.008] * 10)
    assert _common.window_ms_per_request(srec, "solve") == pytest.approx(
        (srec.window[1] - srec.window[0]) / 10 * 1e3)
    # the benchmark's factor checks between requests are left out, the
    # gaps between requests are not
    crec = _Rec("cycle", walls, check_s=0.004)
    assert _common.window_ms_per_request(crec, "cycle") == pytest.approx(
        _common.window_ms_per_request(rec, "cycle"))


# ----------------------------------------------------- refusals and imports

def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "cholbench/run.py", "--workload",
         "lapl7_50.refactor", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_run_fails_without_a_card():
    p = _cli(REPO)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr[-2000:]
    assert "CUDA device" in p.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copytree(os.path.join(REPO, "cholbench"), tmp_path / "cholbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    p = _cli(tmp_path)
    assert p.returncode != 0 and not p.stdout.strip().startswith("{")


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cholesky_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cholesky_tpu.numeric", sys)
    assert harness.forbidden_modules() == ["cholesky_tpu"]


IMPORTS = r'''
import sys, time, json
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def _loaded(body, tmp_path):
    code = IMPORTS.format(repo=REPO, body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    root, _ = bench_copy(tmp_path)
    names = _loaded(
        "from cholbench import harness\n"
        f"harness.run({str(root)!r}, 'lapl7_t.refactor', {SEED}, 0.2, True,"
        " 'cpu', time.perf_counter())", tmp_path)
    assert "cholesky_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_solver(tmp_path):
    names = _loaded(
        "from cholbench import yardstick, traffic\n"
        "cfg = {'operator': {'kind': 'laplacian7', 'shape': [5, 5, 5]},"
        " 'levels': 2}\n"
        "op = yardstick.operator(cfg)\n"
        "op.Reference(cfg).matvec(op.coo(cfg)[3][:125], 0.0)\n"
        "yardstick.count_work(cfg)", tmp_path)
    assert not names & {"cholesky_tpu_torch", "torch", *harness.FORBIDDEN}


# ------------------------------------------------- correct, against faults

def test_sound_runs_are_correct(tmp_path):
    root, _ = bench_copy(tmp_path)
    for cell in ("lapl7_t.refactor", "lapl7_t.solve"):
        res, checks = run_cell(root, cell)
        assert res["correct"] and res["failed"] == 0, checks
        assert res["attempted"] >= 1
        assert set(checks) == {"resid_max", "factor_eta", "failed"}


def _api():
    from cholesky_tpu_torch import api

    return api.SparseCholesky


def test_an_update_that_leaves_the_state_unchanged_is_caught(
        tmp_path, monkeypatch):
    root, _ = bench_copy(tmp_path)
    monkeypatch.setattr(_api(), "update_values",
                        lambda self, vals, rows=None, cols=None: None)
    res, checks = run_cell(root, "lapl7_t.refactor")
    assert not res["correct"]
    assert checks["resid_max"]["value"] > checks["resid_max"]["limit"]


@pytest.mark.parametrize("cell", ["lapl7_t.refactor", "lapl7_t.solve"])
def test_an_answer_altered_where_it_is_produced_is_caught(
        tmp_path, monkeypatch, cell):
    root, _ = bench_copy(tmp_path)
    solve = _api().solve

    def altered(self, b, *a, **k):
        x = solve(self, b, *a, **k)
        x = x.copy()
        x[len(x) // 2] *= 1 + 1e-6
        return x

    monkeypatch.setattr(_api(), "solve", altered)
    res, checks = run_cell(root, cell)
    assert not res["correct"] and res["failed"] > 0
    assert checks["resid_max"]["value"] > checks["resid_max"]["limit"]


@pytest.mark.parametrize("cell", ["lapl7_t.refactor", "lapl7_t.solve"])
def test_a_degraded_factor_is_caught_though_refinement_hides_it(
        tmp_path, monkeypatch, cell):
    import torch

    from cholesky_tpu_torch.numeric import frontal

    root, _ = bench_copy(tmp_path)
    inner = frontal.factor

    def degraded(*a, **k):
        panels = inner(*a, **k)
        gen = torch.Generator().manual_seed(0)
        return [p * (1 + 1e-3 * torch.randn(p.shape, generator=gen,
                                             dtype=p.dtype))
                for p in panels]

    monkeypatch.setattr(frontal, "factor", degraded)
    res, checks = run_cell(root, cell)
    # refinement still meets the contract; the factor check does not pass
    assert checks["resid_max"]["value"] <= checks["resid_max"]["limit"]
    assert checks["factor_eta"]["value"] > checks["factor_eta"]["limit"]
    assert not res["correct"]


def test_a_stale_factor_is_caught(tmp_path):
    from cholbench import faults

    root, _ = bench_copy(tmp_path)
    res, checks = run_cell(root, "lapl7_t.refactor", seconds=0.5,
                           prepare=faults.stale_factor)
    assert checks["factor_eta"]["value"] > checks["factor_eta"]["limit"]
    assert not res["correct"]


def test_a_request_that_raises_is_a_failure(tmp_path, monkeypatch):
    root, _ = bench_copy(tmp_path)
    calls = {"n": 0}
    factorize = _api().factorize

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("planted")
        return factorize(self, *a, **k)

    monkeypatch.setattr(_api(), "factorize", flaky)
    res, checks = run_cell(root, "lapl7_t.refactor")
    assert not res["correct"] and res["failed"] >= 1

"""CPU tests of the hybrid u-p configuration (`operators/elasticity_q1p0.py`,
`configs/elast_q1p0_48.json`), its cell and the block-solve cell: small
copies of both cells through the harness, the stored work counts, and the
new metric's declaration.

    python -m pytest cholbench/tests/test_cholbench_mixed.py -q

The count of the ne = 48 configuration reads its 16 M entries (~10 s);
everything else runs at ne = 3 and 8^3.
"""

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from cholbench import harness, stepwork, yardstick  # noqa: E402
from cholbench.tests.test_cholbench_harness import (  # noqa: E402
    bench_copy, run_cell)

SEED = 3_000_000_043
CONFIG = os.path.join(REPO, "cholbench/configs/elast_q1p0_48.json")
CELL = "elast_q1p0_48.refactor_fixed"


def _cfg(ne, levels):
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["operator"] = dict(cfg["operator"], ne=ne)
    cfg.update(n=3 * (ne + 1) * ne * (ne + 1) + ne ** 3, levels=levels)
    return cfg


def mixed_copy(tmp_path, ne=3, levels=3, name="elast_p_t"):
    """BENCHMARK.json and cholbench/ copied to tmp_path, plus a small copy
    `name` of the hybrid configuration and its cell `<name>.refactor_fixed`,
    every metric that lists the hybrid cell listing it too."""
    root = tmp_path / "bench"
    shutil.copytree(os.path.join(REPO, "cholbench"), root / "cholbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    cfg = _cfg(ne, levels)
    cfg["name"] = name
    cfg["work"] = yardstick.count_work(cfg)
    cfg["step_work"] = stepwork.count_step_work(cfg)
    with open(root / "cholbench/configs" / f"{name}.json", "w") as f:
        json.dump(cfg, f)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"cholbench/configs/{name}.json",
                             "reduced": ["ne"], "why": "test"})
    bench["workloads"].append({"name": f"{name}.refactor_fixed",
                               "config": name, "traffic": "refactor_fixed",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(f"{name}.refactor_fixed")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_copy_of_the_mixed_cell_is_correct(tmp_path, trace):
    root = mixed_copy(tmp_path)
    res, checks = harness.run(str(root), "elast_p_t.refactor_fixed", SEED,
                              0.3, trace, "cpu", time.perf_counter())
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert checks["resid_max"]["value"] <= 1e-10
    assert 0 < checks["factor_eta"]["value"] <= checks["factor_eta"]["limit"]
    if trace:
        assert res["metrics"]["factor_ms.cycle"]["value"] > 0
        assert res["metrics"]["factor_issue_ms.cycle"]["value"] > 0
        for name in ("pivot_ms.cycle", "signed_diag_ms.cycle",
                     "schur_roofline_pct.cycle"):
            assert name not in res["metrics"]     # no device extent here
    else:
        assert set(res["metrics"]) == {"cycle_ms", "setup_s"}


def test_every_cycle_refactors_the_unchanged_values(tmp_path, monkeypatch):
    """The mix sets the same values on every cycle; each cycle still
    factors them again."""
    from cholesky_tpu_torch import SparseCholesky

    root = mixed_copy(tmp_path)
    calls = []
    factorize = SparseCholesky.factorize

    def counted(self, *a, **k):
        calls.append(self.factored)
        return factorize(self, *a, **k)

    monkeypatch.setattr(SparseCholesky, "factorize", counted)
    res, checks = harness.run(str(root), "elast_p_t.refactor_fixed", SEED,
                              0.3, False, "cpu", time.perf_counter())
    assert res["correct"], checks
    # the warm-up's and one a window request, never on a standing factor
    assert len(calls) == 1 + res["attempted"] and not any(calls)


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_copy_of_the_block_cell_is_correct(tmp_path, trace):
    root, bench = bench_copy(tmp_path)
    bench["workloads"].append({"name": "lapl7_t.block16",
                               "config": "lapl7_t", "traffic": "block16",
                               "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    res, checks = run_cell(root, "lapl7_t.block16", trace=trace)
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert checks["resid_max"]["value"] <= 1e-10
    if trace:
        assert res["metrics"]["apply_host_ms.solve"]["value"] > 0
        assert res["metrics"]["sweeps.solve"]["value"] >= 1
    else:
        assert set(res["metrics"]) == {"solve_ms", "setup_s"}


def test_the_block_mix_solves_sixteen_columns():
    mix = json.load(open(os.path.join(REPO, "cholbench/mixes/block16.json")))
    from cholbench import traffic

    inputs = traffic.Inputs(mix, 10, SEED)
    assert mix["request"] == "solve" and mix["shift"] is None
    assert inputs.rhs[0].shape == (10, 16) and inputs.pool == 32
    fixed = json.load(open(os.path.join(
        REPO, "cholbench/mixes/refactor_fixed.json")))
    assert fixed["request"] == "cycle" and fixed["shift"] is None
    assert traffic.Inputs(fixed, 10, SEED).shifts == [0.0] * 17


def test_the_signed_metric_is_declared_with_a_reader():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    m, = [m for m in bench["per_layer"]
          if m["name"] == "signed_diag_ms.cycle"]
    assert m == {"name": "signed_diag_ms.cycle", "unit": "ms",
                 "better": "lower", "source": "device_trace",
                 "layer": "Level loop", "moves": "cycle_ms",
                 "workloads": [CELL]}
    path = os.path.join(REPO, "cholbench/metrics", m["name"] + ".py")
    assert hasattr(yardstick.load_module(path, "m"), "read")
    slab, = [m for m in bench["per_layer"]
             if m["name"] == "slab_roofline_pct.cycle"]
    assert CELL not in slab["workloads"]       # the signed path has no slab


@pytest.fixture(scope="module")
def ne48():
    with open(CONFIG) as f:
        cfg = json.load(f)
    return cfg, yardstick.count_work(cfg), stepwork.count_step_work(cfg)


def test_stored_work_is_the_count(ne48):
    cfg, work, steps = ne48
    assert cfg["work"] == work
    assert cfg["step_work"] == steps
    assert cfg["n"] == 456_336 == 3 * 49 * 48 * 49 + 48 ** 3
    assert cfg["levels"] == int(np.ceil(np.log2(cfg["n"] / 64))) + 1
    assert steps["pivot_flops"] + steps["schur_flops"] == pytest.approx(
        work["flops"], rel=1e-15)

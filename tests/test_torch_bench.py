"""The port's bench (tools/torch/bench.py) and its fresh-process tool
(tools/torch/warm_start.py) on the CPU, in process, at tiny sizes (8^3 L3,
a 6^3 x 3 irregular operator), on one torch thread: the table on stderr,
then one JSON line on stdout equal to what `main` returns; useful FLOPs
and padding efficiency equal to the JAX package's on the same problem;
--measure-baseline's host replay equal to the JAX package's replay; the
fixture and irregular rows; a failed row recorded with its message and
traceback tail, the other rows still run, the exit code nonzero; a failed
warm-start process recorded with its return code and stderr tail; one
real warm_start.py subprocess; without --device cpu both scripts raise
when there is no card."""

import argparse
import contextlib
import functools
import io
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

import cholesky_tpu
from cholesky_tpu.symbolic import fill as jfill
from cholesky_tpu.utils import capacity as jcap
from cholesky_tpu.utils.laplacian import generate_problem as jgenerate
from cholesky_tpu.verify import replay as jreplay
from cholesky_tpu.verify import schedule as jschedule

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = ["--shape", "8,8,8", "--levels", "3", "--device", "cpu"]
CLUSTER = 16                     # the bench's default --cluster-size


def _tool(name):
    """The module globals of tools/torch/<name>.py run as a library (the
    dict its functions read, so that a test can replace one), with
    sys.path restored after."""
    syspath = list(sys.path)
    try:
        return runpy.run_path(os.path.join(ROOT, "tools", "torch",
                                           name + ".py"),
                              run_name="tool")["main"].__globals__
    finally:
        sys.path[:] = syspath


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _main(mod, argv):
    """(mod's main(argv) result, stdout, stderr) on one torch thread."""
    out, err = io.StringIO(), io.StringIO()
    with _one_thread(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        result = mod["main"](argv)
    return result, out.getvalue(), err.getvalue()


@functools.lru_cache(maxsize=None)
def _bench_no_extras():
    return _main(_tool("bench"), TINY + ["--no-extras"])


def _jax_schedule(shape, levels):
    """The JAX package's solver, schedule ops and useful FLOPs of the
    bench's problem."""
    n, r, c, v, o, cl, _ = jgenerate(shape, levels, cluster_size=CLUSTER)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
    ops = jschedule.generate_schedule(jfill.analyze_fill(
        js.plan, js.rows, js.cols, js.vals))
    return js, ops, jschedule.schedule_flops(ops)


def test_bench_prints_its_table_then_one_json_line():
    result, out, err = _bench_no_extras()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == json.loads(json.dumps(result))
    assert "# problem 8x8x8_L3" in err and "# factor (default" in err
    assert "# production (highest" in err
    assert result["metric"] == "factor_gflops" and result["unit"] == "GFLOP/s"
    assert result["key"] == "8x8x8_L3" and result["n"] == 512
    assert result["device"] == "cpu" and result["card"] == "cpu"
    assert result["failed"] == [] and result["residual_ok"]
    assert result["residual"] <= 1e-10
    assert result["residual_production"] <= 1e-10
    assert result["factor_precision"] == "default (tf32)"
    assert result["solve_precision"] == "highest (auto, ieee)"
    assert result["value"] == (result["useful_flops"]
                               / result["factor_wall_s"] / 1e9)
    assert result["useful_gflop"] == round(result["useful_flops"] / 1e9, 1)
    walls = result["factor_walls_s"]
    assert len(walls) == 10 and result["factor_wall_s"] == np.median(walls)
    assert (result["factor_wall_min_s"] <= result["factor_wall_q1_s"]
            <= result["factor_wall_s"] <= result["factor_wall_q3_s"])
    assert len(result["factor_walls_s_production"]) == 10
    for key in ("solve_wall_s", "t_pair_wall_s", "solve_first_s",
                "factor_first_s", "solve_wall_s_production",
                "factor_wall_s_production"):
        assert result[key] > 0
    assert result["solve_sweeps"] >= 1
    # no card: no device time, no peak, the wrappers' plain versions
    assert result["factor_device_s"] is None
    assert result["max_memory_allocated"] is None
    assert result["factor_peak_bytes"] is None
    assert result["plan_peak_estimate_bytes"] > 0
    assert result["launches"] == result["launches_production"] == {
        "chol_inv": 0, "factor_slab": 0, "form_front": 0, "schur_syrk": 0,
        "signed_panel": 0}
    assert result["vs_baseline"] is None
    assert [lv["B"] for lv in result["regime_plan"]] == [1, 2, 4]
    assert result["executed_flops"] >= result["useful_flops"] > 0
    for row in ("peak", "fixture_3375", "irregular_elasticity",
                "warm_start"):
        assert row not in result                   # --no-extras


def test_production_row_is_the_chain_where_auto_resolves_default(
        monkeypatch):
    """Where AUTO resolves the one-pass rung (140^3 on the card), the
    production row is the default chain's own: not timed again."""
    import cholesky_tpu_torch.api as api

    monkeypatch.setattr(api, "_AUTO_HIGHEST_FLOPS", 0.0)
    result, _, err = _main(_tool("bench"), TINY + ["--no-extras"])
    assert result["solve_precision"] == "default (auto, tf32)"
    assert result["residual_production"] == result["residual"]
    assert "factor_wall_s_production" not in result
    assert "# production" not in err and result["failed"] == []


@pytest.mark.parametrize("shape,levels", [((8, 8, 8), 3), ((12, 12, 12), 4)])
def test_useful_flops_and_padding_equal_the_jax_package(shape, levels):
    js, _, useful = _jax_schedule(shape, levels)
    padding = jcap.padding_efficiency(js.fplan, useful)
    if shape == (8, 8, 8):
        result = _bench_no_extras()[0]
        got, got_padding = result["useful_flops"], result["padding_efficiency"]
        assert result["executed_flops"] == jcap.frontal_flops(js.fplan)
    else:
        from cholesky_tpu_torch import SparseCholesky
        from cholesky_tpu_torch.utils import capacity
        from cholesky_tpu_torch.utils.laplacian import generate_problem

        bench = _tool("bench")
        n, r, c, v, o, cl, _ = generate_problem(shape, levels,
                                                cluster_size=CLUSTER)
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    device="cpu")
        got, _ = bench["useful_flops"](s)
        got_padding = capacity.padding_efficiency(s.fplan, got)
    assert got == useful and got_padding == padding


def test_measure_baseline_replays_as_the_jax_package():
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    bench = _tool("bench")
    result, out, _ = _main(bench, ["--shape", "6,6,6", "--levels", "2",
                                   "--measure-baseline", "--device", "cpu"])
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["metric"] == "cpu_baseline_factor_gflops"
    assert result["key"] == "6x6x6_L2" and result["value"] > 0
    assert result["vs_baseline"] == 1.0 and result["wall_s"] > 0
    assert bench["exit_code"](result) == 0

    js, jops, useful = _jax_schedule((6, 6, 6), 2)
    assert result["useful_flops"] == useful
    off = js.rows != js.cols
    import scipy.sparse

    full = scipy.sparse.coo_matrix(
        (np.concatenate([js.vals, js.vals[off]]),
         (np.concatenate([js.rows, js.cols[off]]),
          np.concatenate([js.cols, js.rows[off]]))),
        shape=(js.plan.n, js.plan.n)).toarray()
    want = jreplay.replay_schedule(
        np.tril(full[np.ix_(js.plan.perm, js.plan.perm)]), jops)
    n, r, c, v, o, cl, _ = generate_problem((6, 6, 6), 2,
                                            cluster_size=CLUSTER)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    got, seconds = bench["host_replay"](s, bench["useful_flops"](s)[1])
    assert seconds > 0 and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("where", ["stand-in", "directory"])
def test_fixture_row_returns_its_fields(where, tmp_path):
    bench = _tool("bench")
    spec = ((6, 6, 6), 3)
    fixture_dir = None
    if where == "directory":
        for src, dst in zip(bench["write_stand_in"](str(tmp_path), *spec),
                            bench["FIXTURE_FILES"]):
            shutil.move(src, tmp_path / dst)
        fixture_dir = str(tmp_path)
    with _one_thread():
        r = bench["bench_fixture"](torch.device("cpu"), np.dtype("float32"),
                                   10, fixture_dir, spec=spec)
    assert r["source"] == (os.path.abspath(fixture_dir) if fixture_dir
                           else "generated stand-in: 6x6x6 L3 grid Laplacian")
    assert r["n"] == 216 and r["levels"] == 3
    assert r["precision"] == "highest (auto, ieee)"
    assert r["residual_ok"] and r["residual"] <= 1e-10
    assert r["residual_default"] <= 1e-10 and r["solve_wall_s_default"] > 0
    assert r["factor_gflops"] == (r["useful_flops"] / r["factor_wall_s"]
                                  / 1e9)
    assert r["factor_device_s"] is None and r["solve_wall_s"] > 0
    assert r["factor_peak_bytes"] is None
    assert len(r["regime_plan"]) == 3 and r["plan_peak_estimate_bytes"] > 0


def test_irregular_row_returns_its_fields():
    bench = _tool("bench")
    with _one_thread():
        r = bench["bench_irregular"](torch.device("cpu"),
                                     np.dtype("float32"), 10,
                                     shape=(6, 6, 6), ncomp=3)
    assert r["problem"] == "vector_laplacian(6x6x6, 3) elasticity-type"
    assert r["n"] == 648 and r["levels"] == len(r["regime_plan"])
    assert r["ordering"]["engine"] in ("native", "python")
    assert r["ordering_wall_s"] > 0 and r["plan_s"] >= 0
    assert r["residual_ok"] and r["residual"] <= 1e-10
    assert r["factor_gflops"] > 0 and r["solve_wall_s"] > 0
    assert r["plan_peak_estimate_bytes"] > 0
    assert r["precision"].endswith("(auto, ieee)")


@pytest.mark.parametrize("fault", ["raises", "misses its residual"])
def test_a_failed_primary_row_is_recorded_and_exits_nonzero(fault):
    bench = _tool("bench")

    def primary(args, device, base):
        if fault == "raises":
            raise ValueError("made to fail")
        return {"value": 1.0, "vs_baseline": None, "residual": 1.0,
                "residual_ok": False}

    bench["bench_primary"] = primary
    result, out, err = _main(bench, TINY + ["--no-extras"])
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["failed"] == ["primary"]
    assert bench["exit_code"](result) == 1
    assert "# primary FAILED" in err
    if fault == "raises":
        assert result["error"] == "ValueError: made to fail"
        assert result["value"] is None
        tail = result["traceback_tail"]
        assert 0 < len(tail) <= bench["TAIL"]
        assert tail[-1] == "ValueError: made to fail"
        assert any("in primary" in line for line in tail)


def test_rows_run_on_after_one_fails_and_warm_start_runs_fresh():
    """Every extra row at a tiny size, the peak row made to raise: it is
    recorded, the fixture, irregular and warm-start rows still run, and
    the warm-start row is a real warm_start.py process on the CPU with the
    parent's problem."""
    bench = _tool("bench")

    def rates(device, potrf=False):
        raise RuntimeError("no yardstick")

    bench["library_rates"] = rates
    bench["bench_fixture"] = functools.partial(bench["bench_fixture"],
                                               spec=((6, 6, 6), 3))
    bench["bench_irregular"] = functools.partial(bench["bench_irregular"],
                                                 shape=(6, 6, 6), ncomp=3)
    result, out, _ = _main(bench, TINY)
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["failed"] == ["peak"] and bench["exit_code"](result) == 1
    assert result["peak"]["error"] == "RuntimeError: no yardstick"
    assert result["residual_ok"]
    assert result["fixture_3375"]["residual_ok"]
    assert result["irregular_elasticity"]["residual_ok"]
    ws = result["warm_start"]
    assert ws["returncode"] == 0 and ws["residual_ok"]
    assert ws["residual"] <= 1e-10
    assert (ws["key"], ws["dtype"], ws["cluster_size"], ws["device"]) == (
        "8x8x8_L3", "float32", CLUSTER, "cpu")
    assert ws["kernels"] == {} and ws["native"]["available"] is not None
    for key in ("import_s", "plan_s", "factor_first_s", "factor_warm_s",
                "solve_first_s", "solve_warm_s", "process_total_s",
                "process_wall_s"):
        assert ws[key] > 0
    assert ws["process_total_s"] <= ws["process_wall_s"]


@pytest.mark.parametrize("code,stdout", [(3, ""), (0, "no json here")])
def test_warm_start_spawn_records_a_failing_process(code, stdout):
    bench = _tool("bench")
    cmd = [sys.executable, "-c",
           f"import sys; print({stdout!r}); "
           f"sys.stderr.write('first\\nboom\\n'); sys.exit({code})"]
    r = bench["spawn_warm_start"](cmd, timeout=60)
    assert r["returncode"] == code
    assert r["stderr_tail"] == ["first", "boom"]
    assert r["error"].startswith(f"warm_start exited {code}")
    failed = []
    bench["row"]("warm_start", lambda: r, failed)
    assert failed == ["warm_start"]


def test_warm_start_gets_the_parents_problem():
    bench = _tool("bench")
    args = argparse.Namespace(
        shape=(9, 7, 5), levels=4, dtype="float64", cluster_size=8,
        device="cuda:1")
    cmd = bench["warm_start_cmd"](args)
    assert cmd[0] == sys.executable
    assert cmd[1].endswith(os.path.join("tools", "torch", "warm_start.py"))
    assert cmd[2:] == ["--shape", "9,7,5", "--levels", "4", "--dtype",
                       "float64", "--cluster-size", "8", "--device",
                       "cuda:1"]


def test_library_rates_at_both_flags():
    bench = _tool("bench")
    with _one_thread():
        r = bench["library_rates"](torch.device("cpu"), potrf=True,
                                   gemm_n=64, root_mk=(48, 24), potrf_n=32,
                                   iters=2)
    assert sorted(r) == sorted(
        f"{k}_{flag}" for flag in ("ieee", "tf32")
        for k in ("gemm_peak_tflops", "syrk_root_tflops", "peak_fraction",
                  "potrf_32_tflops"))
    assert all(x > 0 for x in r.values())
    for flag in ("ieee", "tf32"):
        assert r[f"peak_fraction_{flag}"] == (r[f"syrk_root_tflops_{flag}"]
                                              / r[f"gemm_peak_tflops_{flag}"])


@pytest.mark.parametrize("name", ["bench", "warm_start"])
def test_scripts_need_a_card_without_device_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        _main(_tool(name), ["--shape", "8,8,8", "--levels", "3"])

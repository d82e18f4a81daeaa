"""The port's profiling tools (tools/torch/) on the CPU, in process, at tiny
sizes: each one's `main(argv)` with `--device cpu` prints its table and,
last, one JSON line equal to what it returns; without `--device cpu` each
tool that times the device raises when there is no card; and
tools/torch/nd_quality.compare equals the JAX package's
tools/nd_quality.compare at scale 1, number for number."""

import contextlib
import functools
import io
import json
import os
import runpy
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

# (tool, its arguments at a tiny size): two slab classes, 10^3 L4
TINY = {
    "bench_front_kernels": ["--classes", "4,384,256", "8,256,128",
                            "--reps", "1"],
    "prof_solve_levels": ["10", "4", "--reps", "1"],
    "prof_solve": ["solve1", "refine", "api", "resid", "--dim", "10",
                   "--levels", "4"],
    "exp_solve_profile": ["--dim", "10", "--levels", "4"],
    "prof_scatter": ["2000", "16", "8", "20", "--reps", "1"],
    "bench_matvec": ["--dim", "10", "--levels", "4", "--reps", "1"],
    "nd_quality": ["1"],
}
DEVICE_TOOLS = sorted(set(TINY) - {"nd_quality"})


def _load(path):
    """The module globals of the script at `path`, run as a library (its
    `__main__` block not run), with sys.path restored after."""
    syspath = list(sys.path)
    try:
        return runpy.run_path(path, run_name="tool")
    finally:
        sys.path[:] = syspath


def _tool(name):
    return _load(os.path.join(ROOT, "tools", "torch", name + ".py"))


@functools.lru_cache(maxsize=None)
def _run(name):
    """(tool `name`'s main(TINY[name] + --device cpu) result, stdout), on
    one CPU thread: at these sizes the solves are many tiny ops, and
    OpenMP threads contending with other test workers for the cores
    slowed one tool 250-fold."""
    args = TINY[name] + ([] if name == "nd_quality" else ["--device", "cpu"])
    out, threads = io.StringIO(), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            result = _tool(name)["main"](args)
    finally:
        torch.set_num_threads(threads)
    return result, out.getvalue()


@pytest.mark.parametrize("name", sorted(TINY))
def test_tool_prints_its_table_and_a_json_line(name):
    result, out = _run(name)
    lines = out.strip().splitlines()
    assert len(lines) >= 2                           # a table, then JSON
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(result))
    if name != "nd_quality":
        assert last["device"] == "cpu" and last["card"] == "cpu"
    if name == "bench_front_kernels":
        assert [(r["B"], r["F"], r["W"]) for r in last["classes"]] == [
            (4, 384, 256), (8, 256, 128)]
        for r in last["classes"]:
            assert r["max_rel_diff"] <= 1e-4 and r["routed"] == "library"
            assert r["bound_ieee_ms"] >= r["bound_tf32_ms"] > 0
    if name == "prof_solve_levels":
        assert len(last["fwd"]) == len(last["bwd"]) == 4
        assert last["sum_levels_ms"] > 0 and last["banded_chain_ms"] > 0
    if name == "prof_solve":
        assert last["refine_rn_rel"] <= 1e-10 and last["refine_sweeps"] >= 1
    if name == "exp_solve_profile":
        assert [p["max_iter"] for p in last["banded"]] == [1, 2, 3, 4, 5, 6]
        assert last["per_sweep_ms"] is not None
        assert last["residual"] <= 1e-10
    if name == "bench_matvec":
        assert last["agree"] and set(last["layouts"]) == {
            "stacked2", "two_flat", "transp"}


@pytest.mark.parametrize("name", DEVICE_TOOLS)
def test_tool_needs_a_card_without_device_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="cuda"), \
            contextlib.redirect_stdout(out):
        _tool(name)["main"](TINY[name])


def test_nd_quality_compare_equals_the_jax_tool():
    result, _ = _run("nd_quality")
    jax_tool = _load(os.path.join(ROOT, "tools", "nd_quality.py"))
    assert result["rows"] == jax_tool["compare"](scale=1)

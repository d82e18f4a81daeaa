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
            assert set(r["rungs"]) == {"ieee", "tf32"}
            for x in r["rungs"].values():
                assert x["max_rel_diff"] <= 1e-4
                assert min(x["kernel_ms"], x["composite_ms"],
                           x["library_ms"]) > 0
                assert len(x["kernel_ms_rounds"]) == last["rounds"]
                assert len(x["composite_ms_rounds"]) == last["rounds"]
                assert x["factor_slab_launches"] == 0     # CPU: plain
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


# The limits chip_smoke.py and tests/test_torch_cuda.py hold the card's
# factor_slab to, by bench_front_kernels.slab_err: IEEE f32, and TF32
IEEE_TOL = 1e-4
TF32_TOL = 5e-3


def _tf32(x):
    """x with its significand rounded to TF32's 10 bits, to nearest with
    ties away from zero (what the kernel's cvt.rna does)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _faulty_factor(a, W, fault):
    """factor_slab_ref's schedule with one fault a kernel could have:
    "tf32" rounds every product's operands to TF32 (a kernel that used
    the TF32 core under "highest"), "skip" leaves out the past panels'
    update, "strip" leaves the boundary strip unwritten (zero), "pivot"
    the pivot's entries below the diagonal."""
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    mm = ((lambda x, y: _tf32(x) @ _tf32(y)) if fault == "tf32"
          else (lambda x, y: x @ y))
    B = a.shape[0]
    out = torch.zeros_like(a)
    for c0 in range(0, W, hk.BS):
        w = min(hk.BS, W - c0)
        pan = a[:, c0:, c0:c0 + w]
        if c0 > 0 and fault != "skip":
            past = out[:, c0:, :c0]
            pan = pan - mm(past, past[:, :w, :].mT)
        d = torch.eye(hk.BS).repeat(B, 1, 1)
        d[:, :w, :w] = pan[:, :w, :w]
        ld, dinv = hk.chol_inv_ref(d)
        out[:, c0:c0 + w, c0:c0 + w] = ld[:, :w, :w]
        out[:, c0 + w:, c0:c0 + w] = mm(pan[:, w:, :], dinv[:, :w, :w].mT)
    if fault == "strip":
        out[:, W:] = 0
    if fault == "pivot":
        out[:, :W] = torch.diag_embed(out[:, :W].diagonal(dim1=1, dim2=2))
    return out


def _known(B, F, W, seed):
    gen = torch.Generator().manual_seed(seed)
    return _tool("bench_front_kernels")["known_slab"](B, F, W, gen, "cpu")


@pytest.mark.parametrize("B,F,W", [(2, 300, 200), (3, 256, 128),
                                   (1, 260, 260), (2, 300, 100)])
def test_known_slab_factor_is_the_plain_factor(B, F, W):
    """The plain factor of `known_slab`'s slab is its known factor, each
    part within a few f32 ulps of its own scale; the slab is f32."""
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    a, exact = _known(B, F, W, seed=F + W)
    assert a.dtype == torch.float32 and a.shape == exact.shape == (B, F, W)
    err = _tool("bench_front_kernels")["slab_err"]
    assert err(hk.factor_slab_ref(a, W), exact, W) <= 1e-5


@pytest.mark.parametrize("fault,least", [("tf32", IEEE_TOL),
                                         ("skip", 10 * TF32_TOL),
                                         ("strip", 10 * TF32_TOL),
                                         ("pivot", 10 * TF32_TOL)])
def test_slab_err_fails_a_faulty_factor(fault, least):
    """The card's check can fail the faults a kernel could have, on the
    data it runs on: a factor with TF32 products differs from the plain
    IEEE one by more than IEEE_TOL (and by less than TF32_TOL, so a
    sound TF32 kernel passes at its rung); a skipped update, an unwritten
    strip or pivot by more than ten times TF32_TOL."""
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    err = _tool("bench_front_kernels")["slab_err"]
    W = 200
    a, exact = _known(2, 300, W, seed=5)
    plain = hk.factor_slab_ref(a, W)
    faulty = _faulty_factor(a, W, fault)
    assert err(plain, exact, W) <= 1e-5
    assert err(faulty, plain, W) > least
    if fault == "tf32":
        assert err(faulty, plain, W) < TF32_TOL


"""`python -m cholesky_tpu_torch.cli --device cpu` against the reference
harness contract (check_matrix + check_solution against SciPy, 1e-4, as
tests/test_cli.py) and against the JAX package's CLI on the same files
(solution and factor files within 1e-10; the `-d` log and `--debug-dumps`
files byte for byte), plus the port's own flags."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import scipy.linalg

from cholesky_tpu.io import mmio, ordering as ordio
from cholesky_tpu.symbolic.plan import build_plan, permute_matrix_dense
from tests.conftest import FIXTURES
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILE_TOL = 1e-10        # the two CLIs' output files, f64 runs


def run_cli(args, module="cholesky_tpu_torch.cli", cpu=True, python_args=(),
            env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               **(env or {}))
    extra = ["--device", "cpu"] if cpu and module.endswith("torch.cli") else []
    return subprocess.run(
        [sys.executable, *python_args, "-m", module] + list(args) + extra,
        capture_output=True, text=True, env=env, timeout=600)


def _files(p):
    return ["-i", p["mat"], "-s", p["separators"], "-c", p["clusters"]]


def check_matrix(matrix_file, separator_file, factored_mat):
    plan = build_plan(ordio.parse_ordering(separator_file))
    pmat = permute_matrix_dense(plan, mmio.read_dense(matrix_file))
    l_numpy = scipy.linalg.cholesky(pmat + np.tril(pmat, -1).T, lower=True)
    l_ours = np.tril(scipy.io.mmread(factored_mat).toarray())
    return np.allclose(l_numpy, l_ours, rtol=1e-4, atol=1e-4)


def check_solution(matrix_file, b_file, solution_file):
    a = mmio.read_dense(matrix_file)
    b = mmio.read_array(b_file)
    sol = np.genfromtxt(solution_file).reshape(b.shape)
    return np.allclose(scipy.linalg.solve(a, b), sol, rtol=1e-4, atol=1e-4)


def _lines(stdout, tag):
    return [ast.literal_eval(ln.split(": ", 1)[1])
            for ln in stdout.splitlines() if ln.startswith(tag + ": ")]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cli_end_to_end_matches_scipy_and_the_jax_cli(name, tmp_path,
                                                      port_fixtures):
    p = port_fixtures(name)
    out = {}
    for tag, module in (("t", "cholesky_tpu_torch.cli"),
                        ("j", "cholesky_tpu.cli")):
        sol, fac, perm = (str(tmp_path / f"{tag}_{x}") for x in (
            "solution.txt", "factored.mtx", "permuted.mtx"))
        dump = [] if name == "lapl_3375x3375" else ["-p", perm]
        r = run_cli([*_files(p), "-b", p["b"], "-o", sol, "-m", fac, *dump,
                     "-fflow", "0", "-ll:cpu", "3", "-lg:spy"], module)
        assert r.returncode == 0, r.stderr[-2000:]
        out[tag] = (r.stdout, sol, fac, perm if dump else None)
    stdout, sol, fac, perm = out["t"]
    jout, jsol, jfac, jperm = out["j"]
    for want in ("Iterations: 1", "levels: ", "separators: ", "Done fill.",
                 "Done factoring Iteration: 0.", "Done solve."):
        assert want in stdout
    head = [ln for ln in stdout.splitlines() if ln.startswith("M: ")]
    assert head == [ln for ln in jout.splitlines() if ln.startswith("M: ")]
    (factor,), (solve,) = _lines(stdout, "FACTOR"), _lines(stdout, "SOLVE")
    assert factor["op"] == "factor" and factor["time_s"] > 0
    assert solve["residual"] <= 1e-10 and solve["time_s"] > 0
    assert check_matrix(p["mat"], p["separators"], fac)
    assert check_solution(p["mat"], p["b"], sol)
    x, xj = np.genfromtxt(sol), np.genfromtxt(jsol)
    assert np.abs(x - xj).max() <= FILE_TOL * np.abs(xj).max()
    L = scipy.io.mmread(fac).toarray()
    Lj = scipy.io.mmread(jfac).toarray()
    assert np.abs(L - Lj).max() <= FILE_TOL * np.abs(Lj).max()
    if perm:
        assert open(perm).read() == open(jperm).read()


def test_cli_without_an_ordering_file(tmp_path, port_fixtures):
    p = port_fixtures("lapl_400x400")
    sol = str(tmp_path / "sol.txt")
    r = run_cli(["-i", p["mat"], "-b", p["b"], "-o", sol, "--dtype",
                 "float32", "--iterations", "2", "--bench"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "No separator file; computing nested-dissection ordering." \
        in r.stdout
    assert len(_lines(r.stdout, "FACTOR")) == 2
    assert _lines(r.stdout, "SOLVE")[0]["residual"] <= 1e-10
    assert check_solution(p["mat"], p["b"], sol)
    bench = json.loads(r.stdout.strip().splitlines()[-1])
    assert bench["metric"] == "factor_wall_s" and bench["value"] > 0


def test_cli_save_then_load_factor(tmp_path, port_fixtures):
    p = port_fixtures("lapl_400x400")
    ck = str(tmp_path / "ck.npz")
    r = run_cli([*_files(p), "--save-factor", ck, "--budget", str(4 << 30)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"Saved factor: {ck}" in r.stdout
    sol = str(tmp_path / "sol.txt")
    r = run_cli([*_files(p), "--load-factor", ck, "-b", p["b"], "-o", sol,
                 "--bench"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"Loaded factor: {ck}" in r.stdout
    assert "Done factoring" not in r.stdout
    assert check_solution(p["mat"], p["b"], sol)
    assert json.loads(r.stdout.strip().splitlines()[-1])["value"] is None
    # the JAX CLI resumes from the port's checkpoint too
    r = run_cli([*_files(p), "--load-factor", ck, "-b", p["b"]],
                module="cholesky_tpu.cli")
    assert r.returncode == 0, r.stderr[-2000:]
    assert _lines(r.stdout, "SOLVE")[0]["residual"] <= 1e-10


def test_cli_profile_emits_the_jax_profilers_ops(port_fixtures):
    """`--profile`: one BLAS line per stage in the JAX profiler's format.
    On the CPU fixtures no level is kernel-routed in either package
    (B < 32), so the op sequences are the same line for line."""
    p = port_fixtures("lapl_400x400")
    ops = {}
    for tag, module in (("t", "cholesky_tpu_torch.cli"),
                        ("j", "cholesky_tpu.cli")):
        r = run_cli([*_files(p), "--profile", "--dtype", "float32"], module)
        assert r.returncode == 0, r.stderr[-2000:]
        ops[tag] = _lines(r.stdout, "BLAS")
    assert [{k: v for k, v in d.items() if k != "Time"} for d in ops["t"]] \
        == [{k: v for k, v in d.items() if k != "Time"} for d in ops["j"]]
    assert {d["op"] for d in ops["t"]} == {"EXTADD", "POTRF", "TRSM", "SYRK"}
    assert all(isinstance(d["Time"], int) and d["Time"] >= 0
               for d in ops["t"])


@pytest.mark.parametrize("args", [["--devices", "8"],
                                  ["--slices", "2", "--devices", "8"]],
                         ids=["devices8", "slices2x4"])
def test_cli_mesh_matches_jax(args, tmp_path, port_fixtures):
    """`--devices 8` and `--slices 2 --devices 8` on `--device cpu` (8
    logical CPU slots) against the JAX CLI on 8 virtual CPU devices: the
    solution and factor files within FILE_TOL (f64)."""
    p = port_fixtures("lapl_400x400")
    out = {}
    for tag, module in (("t", "cholesky_tpu_torch.cli"),
                        ("j", "cholesky_tpu.cli")):
        sol, fac = (str(tmp_path / f"{tag}_{x}") for x in ("sol.txt",
                                                           "fac.mtx"))
        r = run_cli([*_files(p), "-b", p["b"], "-o", sol, "-m", fac, *args],
                    module, env={"XLA_FLAGS":
                                 "--xla_force_host_platform_device_count=8"})
        assert r.returncode == 0, r.stderr[-2000:]
        assert _lines(r.stdout, "SOLVE")[0]["residual"] <= 1e-10
        out[tag] = (np.genfromtxt(sol), scipy.io.mmread(fac).toarray())
    (x, L), (xj, Lj) = out["t"], out["j"]
    assert np.abs(x - xj).max() <= FILE_TOL * np.abs(xj).max()
    assert np.abs(L - Lj).max() <= FILE_TOL * np.abs(Lj).max()


def test_cli_slices_not_dividing_devices_prints_the_jax_line(capsys,
                                                              port_fixtures):
    from cholesky_tpu_torch import cli

    p = port_fixtures("lapl_9x9")
    assert cli.main([*_files(p), "--slices", "3", "--devices", "8",
                     "--device", "cpu"]) == 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["Error: --devices 8 is not divisible by --slices 3"]
    r = run_cli([*_files(p), "--slices", "3", "--devices", "8"],
                "cholesky_tpu.cli")
    assert r.returncode == 2 and lines[0] in r.stdout.splitlines()


def test_cli_signs_matches_the_jax_cli(tmp_path, port_fixtures):
    """`--signs FILE`: a quasi-definite matrix made from the 9x9 fixture
    (seeded diagonal signs flipped, |diag| + 0.5) and its signature file
    through both CLIs: the same `signature:` line, SOLVE residuals at the
    contract, solution files within FILE_TOL (f64)."""
    p = port_fixtures("lapl_9x9")
    banner, r, c, v = mmio.read_coo(p["mat"])
    n = banner.rows
    s = np.where(np.random.default_rng(5).random(n) < 0.4, -1.0, 1.0)
    d = r == c
    v = v.copy()
    v[d] = s[r[d]] * (np.abs(v[d]) + 0.5)
    mat, sig = str(tmp_path / "qd.mtx"), str(tmp_path / "signs.txt")
    mmio.write_coo(mat, r, c, v, (n, n), symmetry=banner.symmetry)
    np.savetxt(sig, s)
    out = {}
    for tag, module in (("t", "cholesky_tpu_torch.cli"),
                        ("j", "cholesky_tpu.cli")):
        sol = str(tmp_path / f"{tag}_sol.txt")
        r_ = run_cli(["-i", mat, "-s", p["separators"], "-c", p["clusters"],
                      "-b", p["b"], "-o", sol, "--signs", sig], module)
        assert r_.returncode == 0, r_.stderr[-2000:]
        line = [ln for ln in r_.stdout.splitlines()
                if ln.startswith("signature: ")]
        (solve,) = _lines(r_.stdout, "SOLVE")
        assert solve["residual"] <= 1e-10
        out[tag] = (line, np.genfromtxt(sol))
    assert out["t"][0] == out["j"][0] == [
        f"signature: {int((s > 0).sum())} positive, {int((s < 0).sum())} "
        "negative (quasi-definite LDL^T)"]
    x, xj = out["t"][1], out["j"][1]
    assert np.abs(x - xj).max() <= FILE_TOL * np.abs(xj).max()


def test_cli_inv_diag_matches_the_jax_cli(tmp_path, port_fixtures):
    """`--inv-diag FILE`: the INVDIAG line and diag(A^-1) in original dof
    order, one value per line, within 1e-10 of the JAX CLI's file (f64)."""
    p = port_fixtures("lapl_400x400")
    out = {}
    for tag, module in (("t", "cholesky_tpu_torch.cli"),
                        ("j", "cholesky_tpu.cli")):
        d = str(tmp_path / f"{tag}_diag.txt")
        r = run_cli([*_files(p), "-b", p["b"], "--inv-diag", d], module)
        assert r.returncode == 0, r.stderr[-2000:]
        (line,) = _lines(r.stdout, "INVDIAG")
        assert line["op"] == "inv_diag" and line["time_s"] > 0
        assert f"Saved diag(A^-1) to: {d}" in r.stdout
        out[tag] = np.loadtxt(d)
    assert out["t"].shape == (400,)
    assert np.abs(out["t"] - out["j"]).max() <= FILE_TOL * np.abs(
        out["j"]).max()


def test_cli_usage_and_device_default(port_fixtures):
    assert run_cli([]).returncode == 2
    p = port_fixtures("lapl_9x9")
    import torch

    if not torch.cuda.is_available():
        # without a card the default device fails: nothing runs on the CPU
        # unasked
        r = run_cli(_files(p), cpu=False)
        assert r.returncode != 0 and "Done factoring" not in r.stdout
        assert "cuda" in r.stderr


def test_cli_never_loads_jax(port_fixtures):
    """The import trace of a whole run (factor, profile, checkpoint, solve)
    names neither jax nor any module of the JAX package."""
    p = port_fixtures("lapl_25x25")
    r = run_cli([*_files(p), "-b", p["b"], "--profile"],
                python_args=("-X", "importtime"))
    assert r.returncode == 0, r.stderr[-2000:]
    mods = [ln.rsplit("|", 1)[1].strip() for ln in r.stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln]
    assert "torch" in mods and "cholesky_tpu_torch.api" in mods
    bad = [m for m in mods if m == "jax" or m.startswith("jax.")
           or m == "cholesky_tpu" or m.startswith("cholesky_tpu.")]
    assert not bad, bad


def _dump_names(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".mtx"))


def test_cli_debug_log_and_dumps_match_the_jax_cli(tmp_path, port_fixtures):
    """`-d DIR --debug-dumps`: the structure log and the per-op dumps are
    the JAX CLI's, byte for byte, and each package's debug_factor accepts
    the other's log, dumps and factor file at 1e-10 (f64)."""
    from cholesky_tpu.verify import replay as jreplay
    from cholesky_tpu_torch import cli
    from cholesky_tpu_torch.verify import replay

    p = port_fixtures("lapl_400x400")
    out = {}
    for tag in ("t", "j"):
        dbg, fac = str(tmp_path / f"{tag}_dbg"), str(tmp_path / f"{tag}.mtx")
        args = [*_files(p), "-b", p["b"], "-m", fac, "-d", dbg,
                "--debug-dumps"]
        if tag == "t":
            assert cli.main(args + ["--device", "cpu"]) == 0
        else:
            r = run_cli(args, "cholesky_tpu.cli")
            assert r.returncode == 0, r.stderr[-2000:]
        out[tag] = (dbg, fac)
    (tdbg, tfac), (jdbg, jfac) = out["t"], out["j"]
    names = _dump_names(tdbg)
    assert len(names) > 10 and names == _dump_names(jdbg)
    for f in ["output", *names]:
        assert open(os.path.join(tdbg, f), "rb").read() == open(
            os.path.join(jdbg, f), "rb").read(), f
    kw = dict(rtol=FILE_TOL, atol=FILE_TOL)
    assert jreplay.debug_factor(p["mat"], p["separators"], tfac,
                                os.path.join(tdbg, "output"),
                                directory=tdbg, **kw)
    assert replay.debug_factor(p["mat"], p["separators"], jfac,
                               os.path.join(jdbg, "output"),
                               directory=jdbg, **kw)


def test_cli_debug_log_without_an_ordering_file(tmp_path, port_fixtures):
    """`-d` without `-s`: the log of the plan from_matrix computed, the
    JAX CLI's byte for byte; the engines are printed; no dumps."""
    p = port_fixtures("lapl_25x25")
    out = {}
    for tag, module in (("t", "cholesky_tpu_torch.cli"),
                        ("j", "cholesky_tpu.cli")):
        dbg = str(tmp_path / f"{tag}_dbg")
        r = run_cli(["-i", p["mat"], "-b", p["b"], "-d", dbg], module)
        assert r.returncode == 0, r.stderr[-2000:]
        assert f"debug log: {dbg}/output" in r.stdout
        assert _lines(r.stdout, "SOLVE")[0]["residual"] <= 1e-10
        out[tag] = (r, dbg)
    (r, dbg), (_, jdbg) = out["t"], out["j"]
    assert "ordering engine: native" in r.stdout
    assert "fill engine: native" in r.stdout
    assert "debug dumps" not in r.stdout and _dump_names(dbg) == []
    assert open(os.path.join(dbg, "output"), "rb").read() == open(
        os.path.join(jdbg, "output"), "rb").read()


def test_cli_debug_dumps_without_d_does_nothing(tmp_path, capsys,
                                                port_fixtures,
                                                monkeypatch):
    from cholesky_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    p = port_fixtures("lapl_9x9")
    assert cli.main([*_files(p), "--debug-dumps", "--device", "cpu"]) == 0
    stdout = capsys.readouterr().out
    assert "debug" not in stdout and "Done factoring" in stdout
    assert os.listdir(tmp_path) == []

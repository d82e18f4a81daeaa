"""The port's examples (examples/torch/) on the CPU, in process, at the sizes
and with the assertions of tests/test_examples.py (which runs the JAX
package's twins in examples/): residuals within 1e-10 (1e-8 for the KKT
system), a printed tau, coverage of at least 80%, a pencil residual within
1e-6, and logdet / condest lines.

gmrf_learn and kkt_solve also run their JAX twins in process on the same
arguments; every number the two print (MLE tau and the path to it; the
KKT slogdet sign, log|det| and inertia) agrees to 1e-8 relative.
"""

import contextlib
import io
import os
import re
import runpy
import sys

import pytest
import torch

from tests.test_examples import _residuals
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
REL = 1e-8          # a number printed by the port's script vs the JAX one's


def run(script, args, twin=False):
    """stdout of examples/torch/<script> (examples/<script> with `twin`)
    run in this process with `args`."""
    path = os.path.join(ROOT, "examples", script if twin else
                        os.path.join("torch", script))
    argv, syspath = sys.argv, list(sys.path)
    out = io.StringIO()
    sys.argv = [path, *args]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv, sys.path[:] = argv, syspath
    return out.getvalue()


def _check_residuals(text, tol):
    res = _residuals(text)
    assert res, f"no residual lines in output:\n{text[-2000:]}"
    assert max(res) <= tol, text[-2000:]


def _check_gmrf(text):
    assert re.search(r"tau[^0-9-]*([0-9.]+)", text), text[-2000:]
    assert re.search(r"MLE tau ~= ([0-9.]+)", text), text[-2000:]


def _check_gp(text):
    m = re.search(r"coverage of truth: ([0-9.]+)%", text)
    assert m, text[-2000:]
    assert float(m.group(1)) >= 80.0


def _check_kkt(text):
    assert "slogdet" in text, text[-2000:]
    _check_residuals(text, 1e-8)


def _check_modal(text):
    m = re.search(r"worst pencil residual: ([0-9.]+e[+-]?[0-9]+)", text)
    assert m, text[-2000:]
    assert float(m.group(1)) <= 1e-6


def _check_mtx(text):
    assert "logdet" in text and "condest" in text, text[-2000:]
    _check_residuals(text, 1e-10)


CASES = {
    "fem_gallery": (["--cpu", "--dtype", "float64"],
                    lambda t: _check_residuals(t, 1e-10)),
    "fem_gallery_f32": (["--device", "cpu"],
                        lambda t: _check_residuals(t, 1e-10)),
    "gmrf_learn": (["--dim", "12", "--levels", "3", "--device", "cpu"],
                   _check_gmrf),
    "gp_variance": (["--dim", "12", "--levels", "3", "--device", "cpu"],
                    _check_gp),
    "kkt_solve": (["--nx", "12", "--m", "8", "--device", "cpu"],
                  _check_kkt),
    "modal_analysis": (["--nx", "16", "--k", "3", "--cpu", "--dtype",
                        "float64"], _check_modal),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_on_cpu(name):
    args, check = CASES[name]
    check(run(name.replace("_f32", "") + ".py", args))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_mtx_on_cpu(dtype, port_fixtures):
    p = port_fixtures("lapl_25x25")
    _check_mtx(run("solve_mtx.py", [p["mat"], p["b"], "--dtype", dtype,
                                    "--device", "cpu"]))


@pytest.mark.parametrize("script", ["gp_variance.py", "kkt_solve.py",
                                    "modal_analysis.py", "solve_mtx.py"])
def test_example_needs_a_card_without_device_cpu(script, monkeypatch,
                                                 port_fixtures):
    """The default device is cuda: with no card the script raises, it does
    not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ([port_fixtures("lapl_25x25")["mat"]] if script == "solve_mtx.py"
            else [])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run(script, args)


def _numbers(text, keep):
    """The floats of every line that matches `keep`, in order."""
    return [float(x) for line in text.splitlines() if re.search(keep, line)
            for x in re.findall(r"-?[0-9]+\.[0-9]+(?:e[+-]?[0-9]+)?|-?[0-9]+",
                                line)]


@pytest.mark.parametrize("script,args,keep", [
    ("gmrf_learn.py", ["--dim", "12", "--levels", "3"],
     r"NLL=|^iter |MLE tau|posterior: rmse|selected-inversion sd"),
    ("kkt_solve.py", ["--nx", "12", "--m", "8"], r"^inertia |^slogdet:"),
])
def test_example_matches_jax_twin(script, args, keep):
    mine = _numbers(run(script, args + ["--device", "cpu"]), keep)
    jax_twin = _numbers(run(script, args, twin=True), keep)
    assert mine and len(mine) == len(jax_twin)
    for a, b in zip(mine, jax_twin):
        assert abs(a - b) <= REL * max(abs(b), 1e-300), (mine, jax_twin)

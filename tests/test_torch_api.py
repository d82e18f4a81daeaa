"""The port's user API end to end (cholesky_tpu_torch.SparseCholesky) against
the JAX package, on the CPU: load -> plan -> assemble -> factor -> refined
solve, the factor carried across packages, and the port's independence
from jax."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cholesky_tpu
import cholesky_tpu_torch
from cholesky_tpu.io import mmio
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import convert
from cholesky_tpu_torch.numeric import refine as trefine
from tests.conftest import FIXTURES
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

TOL = 1e-10         # the solver's relative-residual contract
X_REL = 1e-8        # solutions of the two packages, both at <= 1e-10
                    # residual on matrices with kappa <~ 1e2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(paths, name):
    p = paths(name)
    b = mmio.read_array(p["b"]).reshape(-1).astype(np.float64)
    return (p["mat"], p["separators"], p["clusters"]), b


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_solve_matches_jax(name, dtype, port_fixtures):
    files, b = _files(port_fixtures, name)
    ts = cholesky_tpu_torch.SparseCholesky.from_files(*files, dtype=dtype,
                                                      device="cpu")
    ts.factorize()
    x = ts.solve(b)
    assert x.shape == b.shape and x.dtype == np.float64
    assert ts.residual(b, x) <= TOL
    js = cholesky_tpu.SparseCholesky.from_files(*files, dtype=dtype)
    js.factorize()
    xj = js.solve(b)
    assert np.linalg.norm(x - xj) <= X_REL * np.linalg.norm(xj)
    if dtype == np.float32:
        assert ts.last_solve["sweeps"] >= 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_state_from_jax_round_trip(dtype, port_fixtures):
    """A JAX factor solves in the port, and the port's factor in the JAX
    package, both to the residual contract."""
    files, b = _files(port_fixtures, "lapl_3375x3375")
    js = cholesky_tpu.SparseCholesky.from_files(*files, dtype=dtype)
    js.factorize()
    ts = convert.state_from_jax(js, device="cpu")
    assert ts.factored and ts.fplan.key() == js.fplan.key()
    assert ts.residual(b, ts.solve(b)) <= TOL

    own = cholesky_tpu_torch.SparseCholesky.from_files(*files, dtype=dtype,
                                                       device="cpu")
    own.factorize()
    js.panels = tuple(jnp.asarray(p.numpy()) for p in own.panels)
    assert js.residual(b, js.solve(b)) <= TOL


def test_host_refinement_when_ell_is_too_dense(monkeypatch):
    """Rows denser than ELL_MAX_K skip the device loop; the host loop with
    an f64 residual still meets the contract."""
    monkeypatch.setattr(trefine, "ELL_MAX_K", 0)
    n, r, c, v, o, cl, b = generate_problem((12, 12, 12), 4)
    s = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu")
    x = s.solve(b)
    assert s.residual(b, x) <= TOL
    assert s.last_solve["sweeps"] == 0 and s.last_solve["host_sweeps"] >= 1


def test_solve_spd_and_input_checks(port_fixtures):
    files, b = _files(port_fixtures, "lapl_400x400")
    x = cholesky_tpu_torch.solve_spd(files[0], files[1], b,
                                     clusters_file=files[2], device="cpu")
    s = cholesky_tpu_torch.SparseCholesky.from_files(*files, device="cpu")
    assert s.residual(b, x) <= TOL
    with pytest.raises(ValueError):
        s.solve(np.stack([b, b], axis=0))       # [2, n]: rows are not dofs
    with pytest.raises(ValueError):
        cholesky_tpu_torch.SparseCholesky.from_files(*files, dtype=np.int32,
                                                     device="cpu")


def test_cuda_device_is_never_a_silent_cpu(port_fixtures):
    files, _ = _files(port_fixtures, "lapl_9x9")
    if torch.cuda.is_available():
        s = cholesky_tpu_torch.SparseCholesky.from_files(*files,
                                                         device="cuda")
        assert s.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            cholesky_tpu_torch.SparseCholesky.from_files(*files)


def test_port_never_imports_jax():
    """The port's entry points (from_coo, from_scipy, spsolve, block solve,
    update_values, checkpoint, profiler, inv_diag, sample, factorize_many,
    the quasi-definite path, the Schur set, Woodbury updates, eigsh,
    condest) load neither jax nor any module of the JAX package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import cholesky_tpu_torch\n"
        "from cholesky_tpu_torch import convert\n"
        "from cholesky_tpu_torch.utils.laplacian import generate_problem\n"
        "n, r, c, v, o, cl, b = generate_problem((6, 6, 6), 3)\n"
        "s = cholesky_tpu_torch.SparseCholesky.from_coo(\n"
        "    n, r, c, v, o, cl, dtype=np.float32, device='cpu')\n"
        "x = s.solve(b)\n"
        "assert s.residual(b, x) <= 1e-10\n"
        "assert np.all(s.inv_diag() > 0)\n"
        "assert s.sample(np.ones((n, 2))).shape == (n, 2)\n"
        "f = s.factorize_many(np.stack([s.vals, 2.0 * s.vals]))\n"
        "assert np.all(f.residual(b, f.solve(b)) <= 1e-10)\n"
        "import os, tempfile, scipy.sparse as sp\n"
        "from cholesky_tpu_torch.numeric import profile\n"
        "from cholesky_tpu_torch.utils import problems\n"
        "n, r, c, v = problems.make_gallery(1)['elasticity']()\n"
        "a = sp.csr_matrix((v, (r, c)), shape=(n, n))\n"
        "t = cholesky_tpu_torch.SparseCholesky.from_scipy(\n"
        "    a, dtype=np.float32, device='cpu')\n"
        "B = np.ones((n, 3))\n"
        "assert t.residual(B, t.solve(B)) <= 1e-10\n"
        "t.update_values(2.0 * t.vals)\n"
        "t.factorize(check=True)\n"
        "assert np.isfinite(t.logdet()) and len(t.factor_coo()[2]) > n\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    t.load_factor(t.save_factor(os.path.join(d, 'ck')))\n"
        "profile.profile_frontal(t.fplan, t.assemble(), iters=1,\n"
        "                        emit=lambda line: None)\n"
        "x = cholesky_tpu_torch.spsolve(a, np.ones(n), device='cpu')\n"
        "assert np.linalg.norm(t._matrix_csr() @ x / 2 - 1) <= 1e-8\n"
        "n, r, c, v, o, cl, b = generate_problem((6, 6), 2)\n"
        "sg = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)\n"
        "vq = np.where(r == c, sg[r] * (v + 0.5), v)\n"
        "q = cholesky_tpu_torch.SparseCholesky.from_coo(\n"
        "    n, r, c, vq, o, cl, signs=sg, device='cpu')\n"
        "assert q.residual(b, q.solve(b)) <= 1e-10\n"
        "assert q.inertia() == (24, 12, 0) and q.slogdet()[0] == 1\n"
        "p = cholesky_tpu_torch.SparseCholesky.from_coo(\n"
        "    n, r, c, v, o, cl, device='cpu')\n"
        "xr = np.linalg.solve(p.schur_complement(), p.condense_rhs(b))\n"
        "assert p.residual(b, p.expand_solution(b, xr)) <= 1e-10\n"
        "assert p.eigsh(k=2)[0].shape == (2,)\n"
        "assert p.condest(method='lanczos') > 1\n"
        "assert np.all(np.isfinite(p.solve_updated(b, np.ones(n))))\n"
        "print('jax' in sys.modules)\n"
        "print(sorted(m for m in sys.modules if m == 'cholesky_tpu'\n"
        "             or m.startswith('cholesky_tpu.')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["False", "[]"], out.stdout


_JAX_PACKAGE_IMPORT = re.compile(
    r"\bfrom\s+cholesky_tpu\.|\bimport\s+cholesky_tpu\.|"
    r"\bimport\s+cholesky_tpu(?!_torch)\b|\bfrom\s+cholesky_tpu\s+import\b")


def _port_sources():
    root = os.path.join(REPO, "cholesky_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        paths += [os.path.join(d, f) for f in names
                  if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(paths)


def test_port_sources_never_name_the_jax_package_in_an_import():
    paths = _port_sources()
    assert len(paths) > 10
    for new in ("numeric/ldlt.py", "numeric/eigs.py"):
        assert os.path.join(REPO, "cholesky_tpu_torch", new) in paths
    bad = []
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _JAX_PACKAGE_IMPORT.search(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: "
                               f"{line.strip()}")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("line,hit", [
    ("from cholesky_tpu.io import mmio", True),
    ("import cholesky_tpu.utils.laplacian", True),
    ("import cholesky_tpu", True),
    ("from cholesky_tpu import SparseCholesky", True),
    ("import cholesky_tpu_torch", False),
    ("from cholesky_tpu_torch.io import mmio", False),
    ('"replaces": "cholesky_tpu/numeric/pallas_kernels.py:66"', False)])
def test_jax_package_import_pattern(line, hit):
    assert bool(_JAX_PACKAGE_IMPORT.search(line)) is hit

"""The port's panel oracle engine (cholesky_tpu_torch/numeric/factor.py, the
panel assembly of numeric/assemble.py, verify/oracle.PanelsOracle) against
the JAX package's (cholesky_tpu/numeric/factor.py, numeric/assemble.py,
verify/oracle.py) on the CPU.

The same inputs go through both packages, each building its own plan:
grid Laplacians from `generate_problem` (6^2 and 5^2 under 3 levels, 14^3
under 4), the lapl_25x25 fixture and the three irregular fixtures of
tests/fixtures. Tolerances, each relative to the largest entry:

- panel assembly, native core and NumPy: bit for bit;
- factored panels per level: f64 1e-12, f32 1e-4 (summation order);
- solves on one factor through both packages' level loops: 1e-12 (f64);
- the port's production solver against its oracle, as
  tests/test_frontal.py and tests/test_selinv.py hold the JAX package's:
  residuals 1e-10, solutions 1e-9, inv_diag rtol 1e-10.
"""

import os

import numpy as np
import pytest
import scipy.linalg
import torch

import cholesky_tpu
from cholesky_tpu.numeric import assemble as jasm
from cholesky_tpu.numeric import factor as jfactor
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu.verify.oracle import PanelsOracle as JaxOracle
from cholesky_tpu_torch import SparseCholesky, convert
from cholesky_tpu_torch.native import ext
from cholesky_tpu_torch.numeric import assemble as tasm
from cholesky_tpu_torch.numeric import factor as tfactor
from cholesky_tpu_torch.symbolic.plan import permute_matrix_dense
from cholesky_tpu_torch.verify.oracle import PanelsOracle
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

F64_REL = 1e-12     # both packages' f64 panel factors and solves
F32_REL = 1e-4      # ... in f32
TOL = 1e-10         # the residual contract
X_TOL = 1e-9        # production solution vs the oracle's (test_frontal.py)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
GRIDS = {"grid6x6": ((6, 6), 3), "grid5x5": ((5, 5), 3),
         "grid14^3": ((14, 14, 14), 4)}
CASES = [*GRIDS, "lapl_25x25", "circuit", "dense_rows", "imbalanced"]


def _rel(x, ref):
    x, ref = np.asarray(x, dtype=np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _case(name, port_fixtures):
    """(JAX solver, port solver on the CPU, b) for one case, each package
    building its own plan from the same files or arrays."""
    if name in GRIDS:
        shape, levels = GRIDS[name]
        n, r, c, v, o, cl, b = generate_problem(shape, levels)
        return (cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl),
                SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu"), b)
    if name == "lapl_25x25":
        p = port_fixtures(name)
        files = (p["mat"], p["separators"], p["clusters"])
        bfile = p["b"]
    else:
        d = os.path.join(FIXDIR, name)
        files = tuple(os.path.join(d, f)
                      for f in ("matrix.mtx", "ord.txt", "clust.txt"))
        bfile = os.path.join(d, "B.mtx")
    from cholesky_tpu_torch.io import mmio
    b = mmio.read_array(bfile).reshape(-1).astype(np.float64)
    return (cholesky_tpu.SparseCholesky.from_files(*files),
            SparseCholesky.from_files(*files, device="cpu"), b)


def _coo(s):
    return s.rows, s.cols, s.vals


@pytest.mark.parametrize("name", CASES)
def test_panel_assembly_matches_jax(name, port_fixtures):
    js, ts, _ = _case(name, port_fixtures)
    want = jasm.assemble_panels_numpy(js.plan, *_coo(js))
    for got in (tasm.assemble_panels(ts.plan, *_coo(ts), native=True),
                tasm.assemble_panels_numpy(ts.plan, *_coo(ts)),
                tasm.assemble_panels(ts.plan, *_coo(ts),
                                     check_structure=True)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert ext.CALLS["assemble_panels"] > 0
    for g, w in zip(tasm.assemble_panels(ts.plan, *_coo(ts),
                                         dtype=np.float32),
                    jasm.assemble_panels(js.plan, *_coo(js),
                                         dtype=np.float32)):
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_assembly_rejects_a_non_ancestor_entry():
    n, r, c, v, o, cl, _ = generate_problem((5, 5), 3)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    p = ts.plan
    # two dofs of the two level-1 separators, which are siblings
    a = p.perm[p.sep_offset[p.tree.sep_at(1, 0)]]
    b = p.perm[p.sep_offset[p.tree.sep_at(1, 1)]]
    i, j = max(a, b), min(a, b)
    rows, cols = np.append(ts.rows, i), np.append(ts.cols, j)
    with pytest.raises(ValueError, match="non-ancestor"):
        tasm.assemble_panels(p, rows, cols, np.append(ts.vals, -0.1),
                             check_structure=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", CASES)
def test_factor_panels_matches_jax(name, dtype, port_fixtures):
    js, ts, _ = _case(name, port_fixtures)
    panels = tasm.assemble_panels(ts.plan, *_coo(ts), dtype=dtype)
    want = [np.asarray(p) for p in jfactor.factor(js.plan, panels)]
    got = tfactor.factor(ts.plan, panels, "cpu")
    tol = F64_REL if dtype == np.float64 else F32_REL
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.numpy().dtype == w.dtype
        assert _rel(g.numpy(), w) <= tol, f"level {lvl}"


def test_factor_in_place_on_tensors_never_on_numpy():
    """Tensors on the device are factored in place (the JAX package donates
    its panels); NumPy panels are copied and left as they were."""
    n, r, c, v, o, cl, _ = generate_problem((5, 5), 3)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    host = tasm.assemble_panels(ts.plan, *_coo(ts))
    kept = [p.copy() for p in host]
    panels = [torch.from_numpy(p.copy()) for p in host]
    out = tfactor.factor(ts.plan, panels, "cpu")
    assert all(a is b for a, b in zip(out, panels))
    again = tfactor.factor(ts.plan, host, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(host, kept))
    assert all(torch.equal(a, b) for a, b in zip(again, out))


@pytest.mark.parametrize("name", CASES)
def test_solve_matches_jax(name, port_fixtures):
    """Both packages' forward and backward level loops on the port's f64
    factor, and factor_and_solve against the JAX package's."""
    js, ts, b = _case(name, port_fixtures)
    panels = tasm.assemble_panels(ts.plan, *_coo(ts))
    blv = tasm.assemble_rhs(ts.plan, b)
    fp, x = tfactor.factor_and_solve(ts.plan, panels, blv, "cpu")
    jp, jx = jfactor.factor_and_solve(js.plan, panels,
                                      jasm.assemble_rhs(js.plan, b))
    jx_own = jfactor.solve(js.plan, [p.numpy() for p in fp], blv)
    for lvl in range(ts.plan.levels):
        assert _rel(x[lvl].numpy(), np.asarray(jx_own[lvl])) <= F64_REL
        assert _rel(x[lvl].numpy(), np.asarray(jx[lvl])) <= F64_REL
    xs = tasm.extract_solution(ts.plan, [t.numpy() for t in x])
    assert np.array_equal(xs, jasm.extract_solution(
        js.plan, [t.numpy() for t in x]))
    assert ts.residual(b, xs) <= TOL


@pytest.mark.parametrize("name", CASES)
def test_oracle_matches_jax_oracle(name, port_fixtures):
    """PanelsOracle's solve and factor_dense against the JAX class's, and
    factor_dense against SciPy's Cholesky in the plan's permutation."""
    js, ts, b = _case(name, port_fixtures)
    jo = JaxOracle(js.plan, *_coo(js))
    to = PanelsOracle(ts.plan, *_coo(ts), device="cpu")
    x, jx = to.solve(b), jo.solve(b)
    assert _rel(x, jx) <= F64_REL
    assert ts.residual(b, x) <= TOL
    L = to.factor_dense()
    assert _rel(L, jo.factor_dense()) <= F64_REL
    a = permute_matrix_dense(ts.plan, _dense(ts))
    a = a + np.tril(a, -1).T
    assert _rel(L, scipy.linalg.cholesky(a, lower=True)) <= F64_REL


def _dense(s):
    n = s.plan.n
    a = np.zeros((n, n))
    a[s.rows, s.cols] = s.vals
    a[s.cols, s.rows] = s.vals
    return a


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_oracle_from_jax(dtype):
    """The port's solve on the JAX oracle's factor, and on a JAX oracle
    not factored yet (the port factors it)."""
    n, r, c, v, o, cl, b = generate_problem((14, 14, 14), 4)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
    jo = JaxOracle(js.plan, js.rows, js.cols, js.vals, dtype=dtype)
    fresh = convert.oracle_from_jax(jo, device="cpu")
    assert fresh.panels is None
    jx = jo.solve(b)
    to = convert.oracle_from_jax(jo, device="cpu")
    for got, want in zip(to.panels, jo.panels):
        assert np.array_equal(got.numpy(), np.asarray(want))
    tol = F64_REL if dtype == np.float64 else F32_REL
    assert _rel(to.solve(b), jx) <= tol
    assert _rel(fresh.solve(b), jx) <= tol
    assert np.array_equal(to.factor_dense(), jo.factor_dense())


def test_frontal_matches_panels_oracle():
    """The port's production engine against its oracle, as
    tests/test_frontal.py holds the JAX package's: 14^3 L4, both
    residuals within the contract, solutions within 1e-9."""
    n, r, c, v, o, cl, b = generate_problem((14, 14, 14), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    x = s.solve(b)
    assert s.residual(b, x) <= TOL
    oracle = PanelsOracle(s.plan, s.rows, s.cols, s.vals, device="cpu")
    x_o = oracle.solve(b)
    assert s.residual(b, x_o) <= TOL
    np.testing.assert_allclose(x, x_o, rtol=X_TOL, atol=X_TOL)


def test_inv_diag_vs_panels_oracle_factor():
    """inv_diag against a dense inverse built from the oracle's factor, as
    tests/test_selinv.py holds the JAX package's: 5^2 L3, rtol 1e-10."""
    n, r, c, v, o, cl, b = generate_problem((5, 5), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64,
                                device="cpu")
    oracle = PanelsOracle(s.plan, s.rows, s.cols, s.vals, device="cpu")
    L = oracle.factor_dense()
    linv = scipy.linalg.solve_triangular(L, np.eye(n), lower=True)
    ref = np.empty(n)
    ref[s.plan.perm] = (linv * linv).sum(axis=0)
    np.testing.assert_allclose(s.inv_diag(), ref, rtol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_non_spd_gives_non_finite(dtype):
    """A negative definite matrix: every pivot block fails, and both
    packages' oracles give a non-finite solution (no exception)."""
    n, r, c, v, o, cl, b = generate_problem((5, 5), 3)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, -v, o, cl)
    ts = SparseCholesky.from_coo(n, r, c, -v, o, cl, device="cpu")
    jx = JaxOracle(js.plan, *_coo(js), dtype=dtype).solve(b)
    to = PanelsOracle(ts.plan, *_coo(ts), dtype=dtype, device="cpu")
    x = to.solve(b)
    assert not np.all(np.isfinite(jx))
    assert not np.all(np.isfinite(x))
    assert all(torch.isnan(p[:, :ts.plan.S[lvl]]).all()
               for lvl, p in enumerate(to.panels))


def test_oracle_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n, r, c, v, o, cl, _ = generate_problem((5, 5), 3)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        PanelsOracle(ts.plan, *_coo(ts))
    with pytest.raises(RuntimeError, match="cuda"):
        PanelsOracle(ts.plan, *_coo(ts), device="cuda:0")
    with pytest.raises(ValueError, match="float32 or float64"):
        PanelsOracle(ts.plan, *_coo(ts), dtype=np.float16, device="cpu")

"""The port's ordering-free entry points and factor read-outs
(`from_matrix`, `from_scipy`, `spsolve`, `update_values`,
`factorize(check=)`, `logdet`, `factor_dense` / `factor_coo`,
`permuted_dense`, `aslinearoperator`) and its file writers, against the JAX
package on the same inputs, on the CPU.

Tolerances: 1e-12 relative for f64 quantities (the same algorithm up to
summation order), 1e-10 for `logdet` against `numpy.linalg.slogdet`, the
1e-10 residual contract for solves, 1e-8 between the two packages'
refined f32 solutions."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cholesky_tpu
import cholesky_tpu_torch
from cholesky_tpu.io import mmio as jmmio, ordering as jordio
from cholesky_tpu.utils import problems
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.io import mmio as tmmio, ordering as tordio
from cholesky_tpu_torch.numeric import regimes
from tests.conftest import FIXTURES
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

TOL = 1e-10
F64_REL = 1e-12
X_REL = 1e-8


def _gallery(name="wathen"):
    n, r, c, v = problems.make_gallery(1)[name]()
    lower = sp.csr_matrix((v, (r, c)), shape=(n, n))
    full = (lower + sp.tril(lower, -1).T).tocsr()
    return n, r, c, v, lower, full


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("store", ["lower", "upper", "full", "coo_duplicates",
                                   "dense", "nested_list"])
def test_from_scipy_stores_give_the_same_solver(store):
    n, r, c, v, lower, full = _gallery("aniso2d" if store in (
        "dense", "nested_list") else "wathen")
    if store == "lower":
        a = lower
    elif store == "upper":
        a = lower.T.tocsc()
    elif store == "full":
        a = full
    elif store == "coo_duplicates":
        # every entry split into two COO duplicates: scipy's convention sums
        a = sp.coo_matrix((np.concatenate([0.25 * v, 0.75 * v]),
                           (np.concatenate([r, r]), np.concatenate([c, c]))),
                          shape=(n, n))
    else:
        a = full.toarray()[:300, :300]
        n = 300
        r, c = np.nonzero(np.tril(a))
        v = a[r, c]
        if store == "nested_list":
            a = a.tolist()
    ts = SparseCholesky.from_scipy(a, device="cpu")
    js = cholesky_tpu.SparseCholesky.from_scipy(a)
    assert ts.dtype == np.float64
    for x, y in ((ts.rows, js.rows), (ts.cols, js.cols),
                 (ts.plan.perm, js.plan.perm)):
        assert np.array_equal(x, y)
    assert np.allclose(ts.vals, js.vals, rtol=1e-15, atol=0)
    assert len(ts.vals) == len(v) and ts.ordering_info["order_s"] > 0
    b = np.random.default_rng(1).standard_normal(n)
    x = ts.solve(b)
    assert ts.residual(b, x) <= 1e-13
    assert _rel(x, js.solve(b)) <= F64_REL


def test_from_scipy_keeps_the_matrix_dtype():
    _, _, _, _, lower, _ = _gallery()
    assert SparseCholesky.from_scipy(lower.astype(np.float32),
                                     device="cpu").dtype == np.float32
    assert SparseCholesky.from_scipy(lower.astype(np.int64),
                                     device="cpu").dtype == np.float64
    assert SparseCholesky.from_scipy(lower, dtype=np.float32,
                                     device="cpu").dtype == np.float32


@pytest.mark.parametrize("case", ["nonsymmetric", "nonsquare_sparse",
                                  "nonsquare_dense"])
def test_from_scipy_refuses(case):
    _, _, _, _, _, full = _gallery()
    if case == "nonsymmetric":
        a = full.tolil()
        a[5, 4] = a[5, 4] * 1.5 + 1.0
        a = a.tocsr()
    elif case == "nonsquare_sparse":
        a = full[:, :-1]
    else:
        a = np.ones((3, 4))
    with pytest.raises(ValueError) as port:
        SparseCholesky.from_scipy(a, device="cpu")
    with pytest.raises(ValueError) as ref:
        cholesky_tpu.SparseCholesky.from_scipy(a)
    assert str(port.value) == str(ref.value)


def test_from_matrix_takes_levels_and_md_thresholds():
    n, r, c, v, _, _ = _gallery("circuit")
    ts = SparseCholesky.from_matrix(n, r, c, v, device="cpu")
    js = cholesky_tpu.SparseCholesky.from_matrix(n, r, c, v)
    assert np.array_equal(ts.plan.perm, js.plan.perm)
    assert ts.ordering_info["md_tried"]
    t3 = SparseCholesky.from_matrix(n, r, c, v, levels=3, md_small=0,
                                    device="cpu")
    assert t3.plan.levels == 3 and not t3.ordering_info["md_tried"]
    b = np.ones(n)
    assert t3.residual(b, t3.solve(b)) <= 1e-13


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spsolve_dense_and_sparse_rhs(dtype):
    n, _, _, _, lower, full = _gallery()
    b = np.random.default_rng(2).standard_normal(n)
    # dtype= picks the factor's precision; the f64 values are kept
    x = cholesky_tpu_torch.spsolve(lower, b, dtype=dtype, device="cpu")
    ref = spla.spsolve(full.tocsc(), b)
    assert np.linalg.norm(full @ x - b) <= TOL * np.linalg.norm(b)
    assert _rel(x, ref) <= X_REL
    xs = cholesky_tpu_torch.spsolve(lower, sp.csr_matrix(b[:, None]),
                                    dtype=dtype, device="cpu")
    assert xs.shape == (n,) and _rel(xs, ref) <= X_REL
    B = np.stack([b, 2 * b, -b], axis=1)
    X = cholesky_tpu_torch.spsolve(full, sp.csc_matrix(B), dtype=dtype,
                                   device="cpu")
    assert X.shape == (n, 3) and _rel(X[:, 1], 2 * ref) <= X_REL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_update_values_follows_the_new_values(dtype):
    """New coefficients on the same pattern: every value-derived cache goes
    (a stale ELL plane would refine towards the old matrix's solution),
    every symbolic object stays the same object."""
    n, r, c, v, _, _ = _gallery()
    ts = SparseCholesky.from_matrix(n, r, c, v, dtype=dtype, device="cpu")
    js = cholesky_tpu.SparseCholesky.from_matrix(n, r, c, v, dtype=dtype)
    b = np.random.default_rng(3).standard_normal(n)
    x_old = ts.solve(b)
    kept = (ts.plan, ts.fplan, ts._fasm, ts._plans)
    assert all(k is not None for k in kept)
    rng = np.random.default_rng(4)
    new = ts.vals * rng.uniform(0.5, 1.5, size=len(ts.vals))
    diag = ts.rows == ts.cols
    new[diag] = ts.vals[diag] * 3.0 + 1.0       # keeps diagonal dominance
    pr, pc = ts.coo_pattern()
    assert np.array_equal(pr, js.coo_pattern()[0])
    ts.update_values(new)
    js.update_values(new)
    assert not ts.factored and ts.panels is None
    assert ts._inv is None and ts._csr is None and ts._ell is None
    assert ts._ell_dev == {}
    x = ts.solve(b)
    assert all(a is k for a, k in zip(
        (ts.plan, ts.fplan, ts._fasm, ts._plans), kept))
    assert ts.factor_stats["plan_reused"]
    a_new = sp.csr_matrix((new, (pr, pc)), shape=(n, n))
    a_new = a_new + sp.tril(a_new, -1).T
    assert np.linalg.norm(a_new @ x - b) <= TOL * np.linalg.norm(b)
    assert ts.residual(b, x) <= TOL
    assert np.linalg.norm(x - x_old) > 0.1 * np.linalg.norm(x)
    assert _rel(x, js.solve(b)) <= X_REL
    # the (rows, cols, vals) form: the other triangle, shuffled
    p = rng.permutation(len(new))
    ts.update_values(2.0 * new[p], rows=pc[p], cols=pr[p])
    assert np.array_equal(ts.vals, 2.0 * new)
    assert _rel(ts.solve(b), 0.5 * x) <= X_REL


def test_update_values_refuses_another_pattern():
    n, r, c, v, _, _ = _gallery()
    ts = SparseCholesky.from_matrix(n, r, c, v, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        ts.update_values(v[:-1])
    with pytest.raises(ValueError, match="both rows and cols"):
        ts.update_values(v, rows=r)
    r2 = r.copy()
    off = np.flatnonzero(r != c)[0]
    r2[off] = n - 1 if r[off] != n - 1 else n - 2
    with pytest.raises(ValueError, match="sparsity pattern differs"):
        ts.update_values(v, rows=r2, cols=c)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_check_names_the_first_bad_pivot(dtype, port_fixtures):
    p = port_fixtures("lapl_400x400")
    files = (p["mat"], p["separators"], p["clusters"])
    ts = SparseCholesky.from_files(*files, dtype=dtype, device="cpu")
    js = cholesky_tpu.SparseCholesky.from_files(*files, dtype=dtype)
    ts.factorize(check=True)                    # SPD: passes
    vals = ts.vals.copy()
    diag = np.flatnonzero(ts.rows == ts.cols)
    vals[diag[137]] = -5.0                      # indefinite
    ts.update_values(vals)
    js.update_values(vals)
    with pytest.raises(ArithmeticError) as port:
        ts.factorize(check=True)
    with pytest.raises(ArithmeticError) as ref:
        js.factorize(check=True)
    assert str(port.value) == str(ref.value)
    assert "tree level" in str(port.value)


@pytest.mark.parametrize("name", sorted(FIXTURES) + ["elasticity"])
def test_logdet_and_factor_exports_match_jax(name, port_fixtures):
    if name in FIXTURES:
        p = port_fixtures(name)
        files = (p["mat"], p["separators"], p["clusters"])
        ts = SparseCholesky.from_files(*files, device="cpu")
        js = cholesky_tpu.SparseCholesky.from_files(*files)
    else:
        n, r, c, v, _, _ = _gallery(name)
        ts = SparseCholesky.from_matrix(n, r, c, v, device="cpu")
        js = cholesky_tpu.SparseCholesky.from_matrix(n, r, c, v)
    ld = ts.logdet()
    assert abs(ld - js.logdet()) <= F64_REL * abs(ld)
    dense = ts._matrix_csr().toarray()
    sign, ref = np.linalg.slogdet(dense)
    assert sign == 1 and abs(ld - ref) <= 1e-10 * abs(ref)
    L = ts.factor_dense()
    Lj = js.factor_dense()
    assert _rel(L, Lj) <= F64_REL
    pd = ts.permuted_dense()
    assert np.array_equal(pd, js.permuted_dense())
    full = pd + np.tril(pd, -1).T
    assert _rel(L @ L.T, full) <= F64_REL
    fr, fc, fv = ts.factor_coo()
    jr, jc, jv = js.factor_coo()
    assert np.array_equal(fr, jr) and np.array_equal(fc, jc)
    assert _rel(fv, jv) <= F64_REL
    assert _rel(sp.coo_matrix((fv, (fr, fc)), shape=L.shape).toarray(),
                L) == 0.0


def test_logdet_reads_bf16_and_host_levels(port_fixtures):
    p = port_fixtures("lapl_3375x3375")
    files = (p["mat"], p["separators"], p["clusters"])
    ts = SparseCholesky.from_files(*files, dtype=np.float32, device="cpu")
    ref = ts.logdet()
    lo = SparseCholesky.from_files(*files, dtype=np.float32, device="cpu")
    lo._plan_override = regimes.plan_regimes(
        lo.fplan, lo.dtype, 600 << 20, store_dtype=torch.bfloat16,
        offload=True, reupload=False, lazy=True)
    lo.factorize(check=True)
    assert all(q.dtype == torch.bfloat16 for q in lo.panels)
    # bf16 keeps 8 significand bits: each log diag is within ~4e-3
    assert abs(lo.logdet() - ref) <= 4e-3 * lo.plan.n
    assert abs(lo.logdet() - ref) <= 1e-2 * abs(ref)
    assert _rel(lo.factor_dense(), ts.factor_dense()) <= 1e-2
    fr, fc, fv = lo.factor_coo()
    assert fv.dtype == np.float64 and len(fr) == len(ts.factor_coo()[0])


def test_aslinearoperator_drives_eigsh():
    n, _, _, _, lower, full = _gallery("aniso2d")
    ts = SparseCholesky.from_scipy(lower, dtype=np.float32, device="cpu")
    op = ts.aslinearoperator()
    assert op.shape == (n, n)
    small = spla.eigsh(full, k=3, sigma=0.0, which="LM", OPinv=op,
                       return_eigenvectors=False)
    ref = spla.eigsh(full, k=3, sigma=0.0, which="LM",
                     return_eigenvectors=False)
    assert _rel(np.sort(small), np.sort(ref)) <= 1e-8
    V = np.random.default_rng(5).standard_normal((n, 4))
    assert np.linalg.norm(full @ op.matmat(V) - V) <= TOL * np.linalg.norm(V)
    fwd = ts.aslinearoperator(inverse=False)
    assert _rel(fwd.matvec(V[:, 0]), full @ V[:, 0]) <= 1e-15


def test_cuda_entry_points_are_never_a_silent_cpu():
    _, _, _, _, lower, _ = _gallery()
    if torch.cuda.is_available():
        assert SparseCholesky.from_scipy(lower).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        SparseCholesky.from_scipy(lower)
    with pytest.raises(RuntimeError, match="cuda"):
        SparseCholesky.from_scipy(lower, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cholesky_tpu_torch.spsolve(lower, np.ones(lower.shape[0]))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_writers_are_byte_identical(name, tmp_path, port_fixtures,
                                    monkeypatch):
    """The port's writers against the JAX package's NumPy writers (its
    native fast path switched off), file by file."""
    import builtins

    p = port_fixtures(name)
    banner, r, c, v = tmmio.read_coo(p["mat"])
    o = tordio.parse_ordering(p["separators"])
    cl = tordio.parse_clusters(p["clusters"])
    b = tmmio.read_array(p["b"])
    dense = tmmio.read_dense(p["mat"])
    assert np.array_equal(dense, jmmio.read_dense(p["mat"]))
    assert banner.typecode == jmmio.read_banner(p["mat"]).typecode

    real_import = builtins.__import__

    def no_native(mod, *a, **k):
        if mod.startswith("cholesky_tpu.native"):
            raise ImportError(mod)
        return real_import(mod, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_native)
    shape = (banner.rows, banner.cols)
    pairs = [
        (lambda m, f: m.write_coo(f, r, c, v, shape, symmetry="hermitian")),
        (lambda m, f: m.write_coo(f, r, c, v / 3.0, shape, precision=9,
                                  symmetry="symmetric")),
        (lambda m, f: m.write_array(f, b / 7.0)),
        (lambda m, f: m.write_array(f, b, field="integer")),
        (lambda m, f: m.write_dense_coo(f, dense[:40, :40])),
    ]
    for i, write in enumerate(pairs):
        write(tmmio, str(tmp_path / f"t{i}"))
        write(jmmio, str(tmp_path / f"j{i}"))
        assert (tmp_path / f"t{i}").read_bytes() == (
            tmp_path / f"j{i}").read_bytes(), i
    for mod, tag in ((tordio, "t"), (jordio, "j")):
        mod.write_ordering(str(tmp_path / f"{tag}o"), o)
        mod.write_clusters(str(tmp_path / f"{tag}c"), cl)
    assert (tmp_path / "to").read_bytes() == (tmp_path / "jo").read_bytes()
    assert (tmp_path / "tc").read_bytes() == (tmp_path / "jc").read_bytes()
    o2 = tordio.parse_ordering(str(tmp_path / "to"))
    cl2 = tordio.parse_clusters(str(tmp_path / "tc"))
    assert all(np.array_equal(o.dofs[s], o2.dofs[s]) for s in o.dofs)
    assert all(np.array_equal(x, y) for s in cl.intervals
               for x, y in zip(cl.intervals[s], cl2.intervals[s]))


def test_default_budget_keeps_the_plan_when_free_memory_shrinks(monkeypatch):
    """The default budget follows the card's free memory; a slightly
    smaller one that the kept plan's peak still fits does not search
    again (an explicit budget always plans for itself)."""
    n, r, c, v, _, _ = _gallery()
    s = SparseCholesky.from_matrix(n, r, c, v, dtype=np.float32,
                                   device="cpu")
    free = [8 << 30]
    monkeypatch.setattr(SparseCholesky, "_budget_bytes",
                        lambda self: free[0])
    s.factorize()
    plan = s.regimes
    assert not s.factor_stats["plan_reused"]
    free[0] -= 64 << 20
    s.factorize()
    assert s.regimes is plan and s.factor_stats["plan_reused"]
    for budget in (plan.peak_bytes - 1,     # the kept plan no longer fits
                   16 << 30):               # more room: search again
        free[0] = budget
        s.factorize()
        assert s.regimes.budget == budget
        assert s.regimes is not plan and not s.factor_stats["plan_reused"]
        plan = s.regimes
    assert s.residual(np.ones(n), s.solve(np.ones(n))) <= TOL

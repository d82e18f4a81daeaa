"""The factor's companions in the port against the JAX package on the CPU
(f64, the same seeded inputs): the Schur-complement set (schur_dofs,
schur_complement, condense_rhs, expand_solution), Woodbury updates
(solve_updated, logdet_updated), the factor-preconditioned CG
(solve_perturbed), Lanczos eigenpairs and condition numbers (eigsh,
condest), and the ones that also run on a quasi-definite solver. Mirrors
tests/test_schur.py, test_perturbed.py, test_eigs.py and the Woodbury
cases of test_api_extras.py.
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import torch

import cholesky_tpu
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import frontal

REL = 1e-10             # Schur set, f64
SOLVE_REL = 1e-9        # Woodbury, PCG, f64
EIG_REL = 1e-8
COND_REL = 1e-6
TOL = 1e-10
PROBLEMS = [((9, 9), 3), ((7, 7, 7), 4), ((15, 15, 15), 5)]


def _pair(shape, levels, dtype=np.float64, vals=None):
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    v = v if vals is None else vals(r, c, v)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                 device="cpu")
    return js, ts, b


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - ref).max() / np.abs(ref).max())


def _dense(s):
    a = np.zeros((s.plan.n, s.plan.n))
    a[s.rows, s.cols] = s.vals
    a[s.cols, s.rows] = s.vals
    return a


@pytest.mark.parametrize("shape,levels", PROBLEMS)
def test_schur_set_matches_jax(shape, levels):
    js, ts, b = _pair(shape, levels)
    dofs = ts.schur_dofs()
    assert np.array_equal(dofs, js.schur_dofs())
    S, Sj = ts.schur_complement(), js.schur_complement()
    assert S.shape == (len(dofs), len(dofs)) and _rel(S, Sj) <= REL
    bh = ts.condense_rhs(b)
    assert _rel(bh, js.condense_rhs(b)) <= REL
    xr = scipy.linalg.solve(S, bh, assume_a="pos")
    x = ts.expand_solution(b, xr)
    assert _rel(x, js.expand_solution(b, xr)) <= REL
    assert ts.residual(b, x) <= TOL
    np.testing.assert_allclose(x, ts.solve(b), rtol=1e-8, atol=1e-10)


def test_schur_complement_matches_dense():
    """S = A_rr - A_ro A_oo^-1 A_or and the condensed rhs, against dense
    algebra (tests/test_schur.py)."""
    _, ts, b = _pair((10, 10), 3)
    a = _dense(ts)
    r_dofs = ts.schur_dofs()
    o_dofs = np.setdiff1d(np.arange(ts.plan.n), r_dofs)
    a_oo = a[np.ix_(o_dofs, o_dofs)]
    a_ro = a[np.ix_(r_dofs, o_dofs)]
    S_ref = a[np.ix_(r_dofs, r_dofs)] - a_ro @ np.linalg.solve(a_oo, a_ro.T)
    np.testing.assert_allclose(ts.schur_complement(), S_ref, rtol=REL,
                               atol=1e-12)
    bh_ref = b[r_dofs] - a_ro @ np.linalg.solve(a_oo, b[o_dofs])
    np.testing.assert_allclose(ts.condense_rhs(b), bh_ref, rtol=REL,
                               atol=1e-12)
    with pytest.raises(ValueError, match="root separator"):
        ts.expand_solution(b, np.zeros(len(r_dofs) + 1))


@pytest.mark.parametrize("store", ["bf16", "host"])
def test_schur_set_reads_bf16_and_host_levels(store):
    """The root level stored bf16 or in host memory: schur_complement
    promotes it to f64 on the device; the partial sweeps read both."""
    _, ts, b = _pair((8, 8, 8), 4, dtype=np.float32)
    ts.factorize()
    S32 = ts.schur_complement()
    bh32 = ts.condense_rhs(b)
    if store == "bf16":
        ts.panels = tuple(p.to(torch.bfloat16) for p in ts.panels)
        tol = 5e-2
    else:
        ts.panels = tuple(p.cpu() for p in ts.panels)
        tol = 1e-6
    S = ts.schur_complement()
    assert S.dtype == np.float64 and _rel(S, S32) <= tol
    assert _rel(ts.condense_rhs(b), bh32) <= tol
    x = ts.expand_solution(b, scipy.linalg.solve(S32, bh32))
    assert ts.residual(b, x) <= (1e-1 if store == "bf16" else 1e-4)


def test_partial_sweeps_compose_to_the_solve():
    """forward_partial + the root solve + backward_partial = the solve:
    with x_root from the full solve, backward_partial returns it."""
    _, ts, b = _pair((7, 7, 7), 4)
    ts.factorize()
    fp = ts.fplan
    bp = ts._permuted_on_device(b, "b")
    x = frontal.frontal_solve(fp, ts.panels, bp)
    off, sz = ts._root_extent()
    bg = frontal.forward_partial(fp, ts.panels, bp[:, None].repeat(1, 2))
    xr = torch.zeros(fp.W[0], 2, dtype=x.dtype)
    xr[:sz] = x[off:off + sz, None]
    xp = frontal.backward_partial(fp, ts.panels, bg, xr)
    assert xp.shape == (ts.plan.n, 2)
    assert float((xp - x[:, None]).abs().max() / x.abs().max()) <= 1e-13


@pytest.mark.parametrize("k,w", [(1, None), (4, [2.0, 0.5, -1e-3, 1.0])])
def test_solve_updated_matches_jax(k, w):
    js, ts, b = _pair((9, 9), 3)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((ts.plan.n, k) if k > 1 else ts.plan.n)
    x = ts.solve_updated(b, u, w)
    assert _rel(x, js.solve_updated(b, u, w)) <= SOLVE_REL
    U = u.reshape(ts.plan.n, k)
    m = _dense(ts) + U @ np.diag(np.ones(k) if w is None else w) @ U.T
    np.testing.assert_allclose(x, np.linalg.solve(m, b), rtol=SOLVE_REL,
                               atol=1e-11)
    bs = rng.standard_normal((ts.plan.n, 2))
    assert _rel(ts.solve_updated(bs, u, w), np.linalg.solve(m, bs)) \
        <= SOLVE_REL
    with pytest.raises(ValueError, match="nonzero"):
        ts.solve_updated(b, np.ones((ts.plan.n, 2)), [1.0, 0.0])


def test_logdet_updated_matches_jax():
    js, ts, _ = _pair((7, 7, 7), 4)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((ts.plan.n, 2))
    w = np.array([1.5, -1e-3])
    got = ts.logdet_updated(u, w)
    assert abs(got - js.logdet_updated(u, w)) <= SOLVE_REL * abs(got)
    ref = np.linalg.slogdet(_dense(ts) + u @ np.diag(w) @ u.T)[1]
    assert abs(got - ref) <= SOLVE_REL * abs(ref)
    u1 = u[:, :1] / np.linalg.norm(u[:, 0])
    lam_max = float(np.linalg.eigvalsh(_dense(ts)).max())
    with pytest.raises(ArithmeticError, match="not positive definite"):
        ts.logdet_updated(u1, -2.0 * lam_max)


def _perturbation(s, scale, seed=0):
    rng = np.random.default_rng(seed)
    dv = s.vals * rng.uniform(-scale, scale, s.vals.shape)
    return s.rows, s.cols, np.where(s.rows == s.cols, np.abs(dv), dv)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_perturbed_matches_jax(k, dtype):
    js, ts, b = _pair((20, 20), 3, dtype=dtype)
    dr, dc, dv = _perturbation(ts, 0.1)
    B = b if k == 1 else np.stack([b, 2.0 * b + 1.0], axis=1)
    x = ts.solve_perturbed(B, dr, dc, dv, tol=1e-12)
    xj = js.solve_perturbed(B, dr, dc, dv, tol=1e-12)
    assert x.shape == B.shape
    assert _rel(x, xj) <= SOLVE_REL
    rr, cc, vv = np.concatenate([dr, dc[dr != dc]]), np.concatenate(
        [dc, dr[dr != dc]]), np.concatenate([dv, dv[dr != dc]])
    a_pert = ts._matrix_csr() + scipy.sparse.csr_matrix(
        (vv, (rr, cc)), shape=(ts.plan.n, ts.plan.n))
    R = (a_pert @ x - B).reshape(ts.plan.n, -1)
    assert np.all(np.linalg.norm(R, axis=0)
                  <= 1e-12 * np.linalg.norm(B.reshape(ts.plan.n, -1), axis=0))
    assert len(ts.last_perturbed["iterations"]) == k


def test_solve_perturbed_rejects_what_the_jax_package_rejects():
    _, ts, b = _pair((20, 20), 3)
    with pytest.raises(ValueError, match="lower-triangle"):
        ts.solve_perturbed(b, np.array([0]), np.array([1]), np.array([1.0]))
    n = ts.plan.n
    with pytest.raises(RuntimeError, match="positive"):
        ts.solve_perturbed(b, np.arange(n), np.arange(n), -10.0 * np.ones(n),
                           max_iter=20)
    x = ts.solve_perturbed(b, ts.rows[:1], ts.cols[:1], np.zeros(1),
                           tol=1e-12)
    assert ts.residual(b, x) <= 1e-12


@pytest.mark.parametrize("which,k", [("smallest", 4), ("largest", 3)])
def test_eigsh_matches_jax(which, k):
    js, ts, _ = _pair((20, 20), 3)
    w, V = ts.eigsh(k=k, which=which, tol=1e-10)
    wj, Vj = js.eigsh(k=k, which=which, tol=1e-10)
    assert _rel(w, wj) <= EIG_REL
    np.testing.assert_allclose(np.abs(np.sum(V * Vj, axis=0)), 1.0,
                               atol=1e-7)               # up to sign
    dense = _dense(ts)
    w_all = scipy.linalg.eigh(dense, eigvals_only=True)
    ref = w_all[:k] if which == "smallest" else w_all[-k:]
    np.testing.assert_allclose(w, ref, rtol=EIG_REL)
    res = np.linalg.norm(dense @ V - V * w, axis=0)
    assert res.max() <= 1e-9 * np.abs(dense).sum(axis=1).max()


def test_generalized_eigsh_matches_jax():
    js, ts, _ = _pair((20, 20), 3)
    mdiag = np.random.default_rng(3).uniform(0.5, 2.0, ts.plan.n)
    M = scipy.sparse.diags(mdiag).tocsr()
    w, V = ts.eigsh(k=4, M=M, tol=1e-10)
    wj, Vj = js.eigsh(k=4, M=M, tol=1e-10)
    assert _rel(w, wj) <= EIG_REL
    np.testing.assert_allclose(np.abs(np.sum(V * (M @ Vj), axis=0)), 1.0,
                               atol=1e-7)
    np.testing.assert_allclose(V.T @ (M @ V), np.eye(4), atol=1e-8)
    with pytest.raises(ValueError):
        ts.eigsh(k=1, which="largest", M=M)
    with pytest.raises(ValueError):
        ts.eigsh(k=0)


@pytest.mark.parametrize("method", ["power", "lanczos"])
def test_condest_matches_jax(method):
    js, ts, _ = _pair((20, 20), 3)
    kappa = ts.condest(method=method)
    assert abs(kappa - js.condest(method=method)) <= COND_REL * kappa
    if method == "lanczos":
        w_all = scipy.linalg.eigh(_dense(ts), eigvals_only=True)
        assert abs(kappa - w_all[-1] / w_all[0]) <= COND_REL * kappa


def test_f32_factor_gives_f64_eigenpairs():
    """The refined solves make the inverse operator f64-accurate though
    the factor is f32 (tests/test_eigs.py)."""
    _, ts, _ = _pair((20, 20), 3, dtype=np.float32)
    w_all = scipy.linalg.eigh(_dense(ts), eigvals_only=True)
    w, _ = ts.eigsh(k=2, which="smallest", tol=1e-9)
    np.testing.assert_allclose(w, w_all[:2], rtol=1e-7)


def test_companions_on_a_qd_solver():
    """solve_updated, eigsh(which='largest') and condest('power') run on a
    quasi-definite solver, as in the JAX package."""
    n, r, c, v, o, cl, b = generate_problem((10, 9), 3)
    s = np.where(np.random.default_rng(5).random(n) < 0.4, -1.0, 1.0)
    vq = v.copy()
    d = r == c
    vq[d] = s[r[d]] * (v[d] + 0.5)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=s)
    ts = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=s, device="cpu")
    u = np.random.default_rng(6).standard_normal((n, 3))
    x = ts.solve_updated(b, u, [1.0, 2.0, -0.5])
    assert _rel(x, js.solve_updated(b, u, [1.0, 2.0, -0.5])) <= SOLVE_REL
    m = _dense(ts) + u @ np.diag([1.0, 2.0, -0.5]) @ u.T
    np.testing.assert_allclose(x, np.linalg.solve(m, b), rtol=SOLVE_REL,
                               atol=1e-11)
    w, _ = ts.eigsh(k=3, which="largest", tol=1e-10)
    assert _rel(w, js.eigsh(k=3, which="largest", tol=1e-10)[0]) <= EIG_REL
    assert abs(ts.condest() - js.condest()) <= COND_REL * js.condest()

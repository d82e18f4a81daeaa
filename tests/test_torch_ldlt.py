"""The quasi-definite LDL^T path of the port (cholesky_tpu_torch/numeric/
ldlt.py, SparseCholesky(..., signs=)) against the JAX package's
(cholesky_tpu/numeric/ldlt.py) on the CPU.

The same seeded inputs go through both packages in f64: per-level signed
factors within 1e-12 of the level's largest entry, solves within 1e-9
relative, residuals <= 1e-10 with and without pivot inverses, slogdet
within 1e-10 relative with the same sign, inertia identical. An f32 signed
factor refines to 1e-10 through the double-float loop.
"""

import numpy as np
import pytest
import scipy.sparse
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import cholesky_tpu
from cholesky_tpu.numeric import ldlt as jldlt
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky, convert
from cholesky_tpu_torch.numeric import ldlt, regimes

FACTOR_REL = 1e-12      # per level, to the level's largest entry (f64)
SOLVE_RTOL = 1e-9
TOL = 1e-10
GRIDS = [((8, 7), 3), ((12, 12), 4), ((6, 6, 6), 3)]


def _qd(shape, levels, seed=5, neg_frac=0.4):
    """A quasi-definite matrix on the grid pattern: a seeded 40% of the
    diagonal signs flipped, |diag| + 0.5, so both sign blocks stay strictly
    diagonally dominant (tests/test_ldlt.py's construction)."""
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    rng = np.random.default_rng(seed)
    s = np.where(rng.random(n) < neg_frac, -1.0, 1.0)
    vq = v.copy()
    d = r == c
    vq[d] = s[r[d]] * (v[d] + 0.5)
    return n, r, c, vq, o, cl, b, s


def _pair(shape, levels, dtype=np.float64, seed=5):
    n, r, c, vq, o, cl, b, s = _qd(shape, levels, seed)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=s,
                                              dtype=dtype)
    ts = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=s, dtype=dtype,
                                 device="cpu")
    return js, ts, b, s


def _dense(s):
    a = np.zeros((s.plan.n, s.plan.n))
    a[s.rows, s.cols] = s.vals
    a[s.cols, s.rows] = s.vals
    return a


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape,levels", GRIDS)
def test_sign_slabs_identical(shape, levels):
    js, ts, _, s = _pair(shape, levels)
    got = ldlt.sign_slabs(ts.fplan, s)
    want = jldlt.sign_slabs(js.fplan, s)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    sig = ldlt.DeviceSigns(ts.fplan, s, "cpu", torch.float64)
    assert all(np.array_equal(t.numpy(), w) for t, w in zip(sig.slabs, want))
    assert np.array_equal(sig.perm.numpy()[:-1], s[ts.plan.perm])


@pytest.mark.parametrize("shape,levels", GRIDS)
def test_factor_qd_levels_match_jax(shape, levels):
    js, ts, _, s = _pair(shape, levels)
    js.factorize()
    ts.factorize(check=True)
    leaf = ldlt.sign_slabs(ts.fplan, s)[-1]
    assert (leaf < 0).any()                 # leaves carry negative pivots
    for lvl, (jp, tp) in enumerate(zip(js.panels, ts.panels)):
        jp = np.asarray(jp)
        assert tp.shape == jp.shape
        assert _rel(tp.numpy(), jp) <= FACTOR_REL, lvl
    # the JAX package's own level function on the port's inputs
    fronts = ts.assemble()
    ref = jldlt.factor_qd(js.fplan, [f.numpy() for f in fronts], s)
    got = ldlt.factor_qd(ts.fplan, list(fronts),
                         ldlt.DeviceSigns(ts.fplan, s, "cpu", torch.float64))
    assert all(_rel(g.numpy(), np.asarray(r)) <= FACTOR_REL
               for g, r in zip(got, ref))


def test_factor_reconstructs_the_permuted_matrix():
    """L~ S L~^T == the permuted A, assembled from the per-level slabs
    (tests/test_ldlt.py::test_qd_factor_reconstructs)."""
    _, ts, _, s = _pair((8, 7), 3, seed=1)
    ts.factorize(check=True)
    n, fp = ts.plan.n, ts.fplan
    L = np.zeros((n, n))
    for lvl in range(fp.levels):
        fac = ts.panels[lvl].numpy()
        fr = fp.front_rows[lvl]
        for sl in range(fac.shape[0]):
            ok_r = fr[sl] < n
            ok_c = fr[sl][:fp.W[lvl]] < n
            L[np.ix_(fr[sl][ok_r], fr[sl][:fp.W[lvl]][ok_c])] = \
                fac[sl][np.ix_(ok_r, ok_c)]
    sp = s[ts.plan.perm]
    a_perm = _dense(ts)[np.ix_(ts.plan.perm, ts.plan.perm)]
    np.testing.assert_allclose(np.tril(L) @ np.diag(sp) @ np.tril(L).T,
                               a_perm, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("panel", [8, 32, 64])
def test_blocked_signed_cholesky_panel_width(panel):
    """The result does not depend on the panel width beyond roundoff; a
    signature violation gives NaN in that block only."""
    g = torch.Generator().manual_seed(0)
    B, W = 3, 150
    a = torch.randn(B, W, W, generator=g, dtype=torch.float64)
    s = torch.where(torch.rand(B, W, generator=g) < 0.4, -1.0, 1.0).double()
    a = 0.05 * (a + a.transpose(1, 2)) + torch.diag_embed(s * (0.2 * W + 1))
    L = ldlt.blocked_signed_cholesky(a, s, panel=panel)
    ref = ldlt.blocked_signed_cholesky(a, s, panel=W)        # unblocked
    assert float((L - ref).abs().max() / ref.abs().max()) <= 1e-13
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    assert torch.allclose(L @ torch.diag_embed(s) @ L.transpose(1, 2), a,
                          rtol=0, atol=1e-12 * float(a.abs().max()))
    bad = s.clone()
    bad[1, 100] = -bad[1, 100]
    nan = torch.isnan(ldlt.blocked_signed_cholesky(a, bad, panel=panel))
    assert nan.any(dim=(1, 2)).tolist() == [False, True, False]


@pytest.mark.parametrize("shape,levels", GRIDS)
@pytest.mark.parametrize("engine", ["banded", "plain"])
@pytest.mark.parametrize("k", [1, 3])
def test_solve_matches_jax(shape, levels, engine, k, monkeypatch):
    js, ts, b, _ = _pair(shape, levels)
    if engine == "plain":
        monkeypatch.setattr(ts, "_want_inv_pivots", lambda: False)
    B = b if k == 1 else np.random.default_rng(3).standard_normal(
        (ts.plan.n, k))
    x = ts.solve(B)
    assert ts.last_solve["engine"] == engine
    np.testing.assert_allclose(x, js.solve(B), rtol=SOLVE_RTOL,
                               atol=1e-12 * np.abs(x).max())
    assert ts.residual(B, x) <= TOL
    np.testing.assert_allclose(x, np.linalg.solve(_dense(ts), B),
                               rtol=SOLVE_RTOL, atol=1e-11)


@pytest.mark.parametrize("engine", ["banded", "plain"])
@pytest.mark.parametrize("k", [1, 3])
def test_f32_refinement_reaches_the_contract(engine, k, monkeypatch):
    """An f32 signed factor + the double-float device loop reaches 1e-10
    (tests/test_ldlt.py::test_qd_f32_iterative_refinement's matrix)."""
    _, ts, b, _ = _pair((12, 12), 4, dtype=np.float32, seed=7)
    if engine == "plain":
        monkeypatch.setattr(ts, "_want_inv_pivots", lambda: False)
    B = b if k == 1 else np.random.default_rng(4).standard_normal(
        (ts.plan.n, k))
    x = ts.solve(B, tol=1e-12)
    assert ts.residual(B, x) <= TOL
    assert ts.last_solve["loop"] == "device"
    assert ts.last_solve["engine"] == engine
    assert 1 <= ts.last_solve["sweeps"] <= 4


@pytest.mark.parametrize("shape,levels", GRIDS)
def test_slogdet_and_inertia_match_jax(shape, levels):
    js, ts, _, s = _pair(shape, levels)
    sgn, ld = ts.slogdet()
    jsgn, jld = js.slogdet()
    assert sgn == jsgn == np.linalg.slogdet(_dense(ts))[0]
    assert abs(ld - jld) <= 1e-10 * abs(jld)
    assert ts.inertia() == js.inertia() == (int((s > 0).sum()),
                                            int((s < 0).sum()), 0)
    with pytest.raises(ValueError, match="slogdet"):
        ts.logdet()


def test_update_values_keeps_the_signature():
    js, ts, b, s = _pair((9, 9), 3, seed=11)
    ts.solve(b)
    ts.update_values(1.5 * ts.vals)
    js.update_values(1.5 * js.vals)
    assert np.array_equal(ts.signs, s)
    x = ts.solve(b)
    assert ts.residual(b, x) <= TOL
    np.testing.assert_allclose(x, js.solve(b), rtol=SOLVE_RTOL)
    assert ts.slogdet()[0] == js.slogdet()[0]


def test_kkt_system_through_from_matrix():
    """A genuine KKT system [[H, B^T], [B, -C]] through graph nested
    dissection (tests/test_ldlt.py::test_qd_kkt_block_system_auto_nd)."""
    rng = np.random.default_rng(3)
    n1, n2 = 60, 25
    H = scipy.sparse.diags([4.0] * n1) + scipy.sparse.random(
        n1, n1, density=0.05, random_state=3)
    H = (H + H.T) * 0.5
    C = scipy.sparse.diags(rng.uniform(1.0, 2.0, n2))
    Bm = scipy.sparse.random(n2, n1, density=0.1, random_state=4)
    K = scipy.sparse.bmat([[H, Bm.T], [Bm, -C]]).tocoo()
    mask = K.row >= K.col
    n = n1 + n2
    s = np.concatenate([np.ones(n1), -np.ones(n2)])
    args = (n, K.row[mask], K.col[mask], K.data[mask])
    ts = SparseCholesky.from_matrix(*args, signs=s, device="cpu")
    js = cholesky_tpu.SparseCholesky.from_matrix(*args, signs=s)
    assert np.array_equal(ts.plan.perm, js.plan.perm)
    b = rng.standard_normal(n)
    x = ts.solve(b)
    assert ts.residual(b, x) <= TOL
    np.testing.assert_allclose(x, js.solve(b), rtol=SOLVE_RTOL, atol=1e-12)
    sgn, ld = ts.slogdet()
    sgn_ref, ld_ref = np.linalg.slogdet(K.toarray())
    assert sgn == sgn_ref and abs(ld - ld_ref) < 1e-8
    assert ts.inertia() == (n1, n2, 0)
    # from_scipy takes the signature too
    t2 = SparseCholesky.from_scipy(K.tocsr(), signs=s, device="cpu")
    assert t2.residual(b, t2.solve(b)) <= TOL


_GUARDED = {
    "inv_diag": lambda s, b: s.inv_diag(),
    "inv_entries": lambda s, b: s.inv_entries([0], [0]),
    "schur_complement": lambda s, b: s.schur_complement(),
    "condense_rhs": lambda s, b: s.condense_rhs(b),
    "expand_solution": lambda s, b: s.expand_solution(b, np.zeros(1)),
    "sample": lambda s, b: s.sample(b),
    "whiten": lambda s, b: s.whiten(b),
    "factorize_many": lambda s, b: s.factorize_many(s.vals[None, :]),
    "logdet_grad": lambda s, b: s.logdet_grad(),
    "quadform_grad": lambda s, b: s.quadform_grad(b),
    "solve_perturbed": lambda s, b: s.solve_perturbed(
        b, s.rows[:1], s.cols[:1], np.zeros(1)),
    "logdet_updated": lambda s, b: s.logdet_updated(np.ones(s.plan.n)),
    "eigsh smallest": lambda s, b: s.eigsh(k=1, which="smallest"),
    "condest lanczos": lambda s, b: s.condest(method="lanczos"),
    "save_factor": lambda s, b: s.save_factor("unused.npz"),
    "load_factor": lambda s, b: s.load_factor("unused.npz")}


@pytest.mark.parametrize("what", sorted(_GUARDED))
def test_spd_only_methods_raise_on_a_qd_solver(what):
    """Each of the JAX package's 16 `_require_spd` sites raises
    NotImplementedError in the port too, before any work."""
    _, ts, b, _ = _pair((8, 8), 3)
    with pytest.raises(NotImplementedError, match="quasi-definite"):
        _GUARDED[what](ts, b)
    assert not ts.factored or what in ("eigsh smallest", "condest lanczos")


def test_signature_validation():
    n, r, c, vq, o, cl, b, s = _qd((8, 8), 3)
    for bad in (s[:-1], np.where(s > 0, 2.0, -1.0), np.zeros(n)):
        with pytest.raises(ValueError, match="signs"):
            SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=bad,
                                    device="cpu")
    n2, r2, c2, v2, o2, cl2, b2 = generate_problem((8, 8), 3)
    sp = SparseCholesky.from_coo(n2, r2, c2, v2, o2, cl2, signs=np.ones(n2),
                                 device="cpu")
    assert sp.signs is None
    assert sp.residual(b2, sp.solve(b2)) <= TOL
    assert sp.slogdet() == (1, sp.logdet()) and sp.inertia() == (n2, 0, 0)


def test_check_names_a_mismatched_signature():
    """An SPD matrix claimed to have a negative pivot: NaN, and
    factorize(check=True) raises ArithmeticError, as the JAX package."""
    n, r, c, v, o, cl, b = generate_problem((8, 8), 3)
    s = np.ones(n)
    s[0] = -1.0
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, signs=s, device="cpu")
    with pytest.raises(ArithmeticError, match="quasi-definite"):
        ts.factorize(check=True)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, signs=s)
    with pytest.raises(ArithmeticError):
        js.factorize(check=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_state_from_jax_carries_the_signature(dtype):
    js, ts, b, s = _pair((10, 9), 3, dtype=dtype)
    js.factorize()
    t = convert.state_from_jax(js, device="cpu")
    assert np.array_equal(t.signs, s) and t.factored
    x = t.solve(b)
    assert t.residual(b, x) <= TOL
    np.testing.assert_allclose(x, js.solve(b), rtol=1e-9)
    assert t.slogdet()[0] == js.slogdet()[0]
    assert abs(t.slogdet()[1] - js.slogdet()[1]) <= (
        1e-10 if dtype == np.float64 else 1e-6) * abs(js.slogdet()[1])
    assert t.inertia() == js.inertia()


def test_qd_budget_guard_raises_memory_error_before_allocating():
    """Under a budget the in-core square plan does not fit, factorize()
    raises BudgetError (a MemoryError) naming the level and the bytes,
    before anything is assembled; a budget with room factors."""
    _, ts, b, _ = _pair((12, 12), 4, dtype=np.float32)
    fp = ts.fplan
    need = regimes.plan_qd(fp, np.float32, 1 << 40).peak_bytes
    ts.budget = need - 1
    with pytest.raises(MemoryError, match=r"level \d+ .* needs \d+ bytes"):
        ts.factorize()
    assert ts.panels is None and ts._fasm is None and ts._sig is None
    ts.budget = need
    ts.factorize()
    assert ts.regimes.peak_bytes <= need and not ts.regimes.lazy
    assert all(not lp.two_piece and lp.chunks == 1 and not lp.offload
               and lp.store_dtype == lp.update_dtype == torch.float32
               for lp in ts.regimes.levels)
    assert ts.residual(b, ts.solve(b)) <= TOL


@pytest.mark.parametrize("guard", ["selinv", "family", "qd"])
def test_budget_guards_are_memory_errors(guard):
    """regimes.BudgetError is a MemoryError (as the JAX package raises
    from these guards) and still a RuntimeError."""
    assert issubclass(regimes.BudgetError, MemoryError)
    assert issubclass(regimes.BudgetError, RuntimeError)
    n, r, c, v, o, cl, b = generate_problem((8, 8, 8), 4)
    signs = None
    if guard == "qd":
        *_, v, o, cl, b, signs = _qd((8, 8, 8), 4)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 device="cpu", signs=signs)
    if guard == "selinv":
        ts.factorize()
        ts.budget, ts.regimes = 1, None         # read the budget anew
        with pytest.raises(MemoryError):
            ts.inv_diag()
    elif guard == "family":
        ts.budget = regimes.SLACK_BYTES + (30 << 20)
        with pytest.raises(MemoryError):
            ts.factorize_many(np.repeat(ts.vals[None, :], 64, axis=0))
    else:
        ts.budget = regimes.SLACK_BYTES
        with pytest.raises(MemoryError):
            ts.factorize()


def test_qd_level_estimates_bound_cpu_allocations():
    """Each level's estimate of regimes.plan_qd, less the fixed slack,
    bounds what ldlt.factor_qd allocated during the level on the CPU
    (profiler memory events; second factorization, maps cached)."""
    _, ts, _, _ = _pair((16, 15, 14), 6, dtype=np.float32)
    ts.factorize()
    ts.panels, ts.factored = None, False
    marks = {}

    def hook(lvl, what):
        if what == "start":
            marks[lvl] = record_function(f"level {lvl}")
            marks[lvl].__enter__()
        else:
            marks[lvl].__exit__(None, None, None)

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        ts.factorize(level_hook=hook)
    events = list(prof.profiler.kineto_results.events())
    mem = sorted((e.start_ns(), e.nbytes()) for e in events
                 if e.name() == "[memory]")
    times = np.array([t for t, _ in mem])
    cum = np.cumsum([d for _, d in mem])
    for e in events:
        if e.name().startswith("level "):
            lvl = int(e.name()[6:])
            i0 = np.searchsorted(times, e.start_ns())
            i1 = np.searchsorted(times, e.start_ns() + e.duration_ns(),
                                 side="right")
            peak = max([cum[i0 - 1] if i0 else 0, *cum[i0:i1]])
            est = ts.regimes.levels[lvl].peak_bytes - regimes.SLACK_BYTES
            assert peak <= est, (lvl, peak, est)

"""Selected inversion of the port (cholesky_tpu_torch/numeric/selinv.py,
SparseCholesky.inv_diag / inv_entries) against the JAX package's
(cholesky_tpu/numeric/selinv.py) on the CPU.

The same seeded inputs go through both packages. f64: the two packages'
own factorizations and recursions agree to 1e-10 relative. f32: both
recursions run on the SAME factor (the port's, stored f32, bf16 or in host
memory, read into the JAX package's layout), so they differ only by the
rounding of f32 products: 1e-4 relative to the largest entry.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

import cholesky_tpu
from cholesky_tpu.numeric import selinv as jselinv
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import regimes
from cholesky_tpu_torch.numeric import selinv as tselinv
from cholesky_tpu_torch.utils import problems

F64_REL = 1e-10     # both packages' f64 factor and recursion
F32_REL = 1e-4      # one f32 / bf16 factor through both recursions
BIG = 1 << 40       # a budget that binds nothing


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - ref).max() / np.abs(ref).max())


def _pair(kind, dtype=np.float64):
    """(JAX solver, port solver) on one matrix and one ordering: a 7^3
    grid Laplacian, or the irregular `random` gallery matrix (1,500 dofs)
    ordered by each package's own nested dissection."""
    if kind == "grid":
        n, r, c, v, o, cl, _ = generate_problem((7, 7, 7), 4)
        js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                                  dtype=dtype)
        ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                     device="cpu")
    else:
        n, r, c, v = problems.make_gallery(1)["random"]()
        a = sp.csr_matrix((v, (r, c)), shape=(n, n))
        js = cholesky_tpu.SparseCholesky.from_scipy(a, dtype=dtype)
        ts = SparseCholesky.from_scipy(a, dtype=dtype, device="cpu")
    assert np.array_equal(js.plan.perm, ts.plan.perm)
    return js, ts


def _fill_entries(ts, count=40, seed=0):
    """Original-order (rows, cols) of seeded entries of L's pattern that
    are not in A's (fill)."""
    pr, pc, _ = ts.factor_coo()
    n = ts.plan.n
    a = set((ts.plan.iperm[ts.rows] * n + ts.plan.iperm[ts.cols]).tolist())
    a |= set((ts.plan.iperm[ts.cols] * n + ts.plan.iperm[ts.rows]).tolist())
    fill = np.array([k for k, key in enumerate((pr * n + pc).tolist())
                     if key not in a])
    assert len(fill) > count
    pick = np.random.default_rng(seed).choice(fill, count, replace=False)
    return ts.plan.perm[pr[pick]], ts.plan.perm[pc[pick]]


def _dense(ts):
    return (sp.csr_matrix((ts.vals, (ts.rows, ts.cols)),
                          shape=(ts.plan.n,) * 2)
            + sp.csr_matrix((ts.vals, (ts.cols, ts.rows)),
                            shape=(ts.plan.n,) * 2)
            - sp.diags(ts.vals[ts.rows == ts.cols])).toarray()


@pytest.mark.parametrize("kind", ["grid", "gallery"])
def test_inv_diag_and_entries_match_jax_f64(kind):
    """diag(A^-1), A's pattern (both triangles) and fill entries of L, f64,
    against the JAX package; the fill entries also against a dense
    inverse."""
    js, ts = _pair(kind)
    np.testing.assert_allclose(ts.inv_diag(), js.inv_diag(), rtol=F64_REL,
                               atol=0)
    fr, fc = _fill_entries(ts)
    rows = np.concatenate([ts.rows, ts.cols[:50], fr])
    cols = np.concatenate([ts.cols, ts.rows[:50], fc])
    got = ts.inv_entries(rows, cols)
    ref = js.inv_entries(rows, cols)
    assert _rel(got, ref) <= F64_REL
    inv = np.linalg.inv(_dense(ts))
    assert _rel(got[-len(fr):], inv[fr, fc]) <= F64_REL
    assert np.all(got[-len(fr):] != 0)


def _jax_levels(panels):
    """The port's factor levels as the JAX package's arrays (bf16 levels
    stay bf16)."""
    out = []
    for p in panels:
        if p.dtype == torch.bfloat16:
            out.append(jnp.asarray(p.float().numpy()).astype(jnp.bfloat16))
        else:
            out.append(jnp.asarray(p.numpy()))
    return out


@pytest.mark.parametrize("regime", ["f32", "bf16 store", "offloaded"])
def test_selinv_on_the_same_low_precision_factor(regime):
    """An f32 factor stored f32, stored bf16, or moved level by level to
    host memory (forced through the plan override): the port's recursion
    and the JAX package's on the same factor values."""
    n, r, c, v, o, cl, _ = generate_problem((8, 8, 8), 4)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 device="cpu")
    force = {"f32": {},
             "bf16 store": {"store_dtype": torch.bfloat16, "lazy": True},
             "offloaded": {"offload": True, "reupload": False,
                           "lazy": True, "store_dtype": torch.float32}}
    ts._plan_override = regimes.plan_regimes(ts.fplan, np.float32, BIG,
                                             **force[regime])
    ts.factorize()
    if regime == "bf16 store":
        assert all(p.dtype == torch.bfloat16 for p in ts.panels)
    if regime == "offloaded":
        assert all(lp.offload for lp in ts.regimes.levels[1:])
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    jf = _jax_levels(ts.panels)
    d = ts.inv_diag()
    ref = np.empty(n)
    ref[js.plan.perm] = jselinv.selinv_diag(js.fplan, jf)
    assert _rel(d, ref) <= F32_REL
    fr, fc = _fill_entries(ts, count=20)
    rows = np.concatenate([ts.rows, fr])
    cols = np.concatenate([ts.cols, fc])
    got = ts.inv_entries(rows, cols)
    ref = jselinv.selinv_entries(js.fplan, jf, js.plan.iperm[rows],
                                 js.plan.iperm[cols])
    assert _rel(got, ref) <= F32_REL


def test_locate_entries_is_the_jax_loop():
    """The vectorized `_locate_entries` gives the JAX package's loop's
    (level, slot, row, col) for A's pattern in both triangles, the
    diagonal and fill entries, and the same ValueError for an entry
    outside pattern(L + L^T)."""
    js, ts = _pair("grid")
    fr, fc = _fill_entries(ts)
    iperm = ts.plan.iperm
    pr = iperm[np.concatenate([ts.rows, ts.cols, fr])]
    pc = iperm[np.concatenate([ts.cols, ts.rows, fc])]
    got = tselinv._locate_entries(ts.fplan, pr, pc)
    ref = np.array(jselinv._locate_entries(js.fplan, pr, pc))
    for i in range(4):
        assert np.array_equal(got[i], ref[:, i]), i
    # two pivots of the two leaf separators under one parent: no front holds
    # both
    fp = ts.fplan
    leaf = fp.levels - 1
    i, j = fp.front_rows[leaf][0, 0], fp.front_rows[leaf][1, 0]
    bad_r, bad_c = np.append(pr[:5], i), np.append(pc[:5], j)
    with pytest.raises(ValueError) as t_err:
        tselinv._locate_entries(fp, bad_r, bad_c)
    with pytest.raises(ValueError) as j_err:
        jselinv._locate_entries(js.fplan, bad_r, bad_c)
    assert str(t_err.value) == str(j_err.value)
    assert "outside the factor pattern" in str(t_err.value)


def test_inv_entries_outside_the_pattern_raise():
    _, ts = _pair("grid")
    fp = ts.fplan
    leaf = fp.levels - 1
    i, j = ts.plan.perm[[fp.front_rows[leaf][0, 0],
                         fp.front_rows[leaf][1, 0]]]
    with pytest.raises(ValueError, match="outside the factor pattern"):
        ts.inv_entries([i], [j])
    assert ts.inv_entries([], []).shape == (0,)


def test_guard_raises_budget_error_before_allocating(monkeypatch):
    """Under a budget that the factorization fits and the recursion does
    not, inv_diag raises BudgetError with both numbers before the
    recursion starts; a budget with room runs it."""
    n, r, c, v, o, cl, _ = generate_problem((8, 8, 8), 4)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 device="cpu")
    ts.factorize()
    fp = ts.fplan
    need = regimes.selinv_bytes(fp.F, fp.W, torch.float32,
                                ts._resident_bytes())
    budget = need - 1
    s = SparseCholesky(ts.plan, ts.rows, ts.cols, ts.vals, np.float32,
                       device="cpu", budget=budget)
    s._fplan = fp
    s.factorize()
    assert s.regimes.peak_bytes <= budget
    monkeypatch.setattr(tselinv, "selinv_diag", None)    # must not be reached
    with pytest.raises(regimes.BudgetError) as err:
        s.inv_diag()
    assert f"{need} bytes" in str(err.value)
    assert f"{budget} bytes" in str(err.value)
    assert s.selinv_stats == {"estimate": need, "budget": budget}
    monkeypatch.undo()
    s.budget, s.regimes = need, None
    s._plans = None
    s.factorize()
    assert np.allclose(s.inv_diag(), ts.inv_diag(), rtol=1e-6)


def _peak_during(fn):
    """Peak bytes the CPU allocator handed out during fn() above what was
    allocated when it began (profiler memory events)."""
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    mem = sorted((e.start_ns(), e.nbytes())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "[memory]")
    return int(max(np.cumsum([0] + [d for _, d in mem])))


@pytest.mark.parametrize("dtype,store", [(np.float64, None),
                                         (np.float32, None),
                                         (np.float32, torch.bfloat16)])
def test_selinv_bytes_bounds_cpu_allocations(dtype, store):
    """`regimes.selinv_bytes`, less what was resident and the fixed slack,
    bounds what inv_diag allocated on the CPU (second call: the index maps
    exist)."""
    n, r, c, v, o, cl, _ = generate_problem((12, 12, 12), 5)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                 device="cpu")
    if store is not None:
        ts._plan_override = regimes.plan_regimes(ts.fplan, dtype, BIG,
                                                 store_dtype=store, lazy=True)
    ts.inv_diag()
    resident = ts._resident_bytes()
    est = ts._selinv_guard()
    peak = _peak_during(ts.inv_diag)
    assert 0 < peak <= est - resident - regimes.SLACK_BYTES, (
        peak, est - resident - regimes.SLACK_BYTES)

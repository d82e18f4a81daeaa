"""Same-pattern families of the port (SparseCholesky.factorize_many,
BatchedFactors; the family folded into the batch axis of every level)
against the JAX package's vmapped family (`factor_many`, [K, B, F, W] per
level), on the CPU.

The family is the JAX tests' seeded scale-and-shift one
(`tests/test_batched.py`): all SPD, one pattern. Tolerances: f64 factors
1e-12 relative (the same sums in another order); f64 solutions 1e-9, and
residuals and logdets 1e-10; an f32 family refines to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cholesky_tpu
from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import BatchedFactors, SparseCholesky
from cholesky_tpu_torch.numeric import frontal as tfrontal
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.numeric import regimes
from cholesky_tpu_torch.numeric.assemble import FrontAssembler

F64_REL = 1e-12     # folded factors against the vmapped ones
X_REL = 1e-9        # f64 solutions of the two packages
TOL = 1e-10         # residuals, logdets; the solver's contract
BIG = 1 << 40
# per-level pivot widths of 50^3 L8 (the smoke problem; test_torch_capacity)
W50 = (2504, 1256, 632, 632, 304, 144, 144, 864)


def _family(shape=(8, 8), levels=3, k=4, dtype=np.float64):
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                 device="cpu")
    rng = np.random.default_rng(7)
    scales = 1.0 + rng.uniform(0, 2, size=k)
    shifts = rng.uniform(0, 1, size=k)
    vals = scales[:, None] * ts.vals[None, :]
    vals[:, ts.rows == ts.cols] += shifts[:, None]
    return js, ts, vals, b


def _rel(x, ref):
    x = x.double().numpy() if torch.is_tensor(x) else np.asarray(x)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape,levels,k", [((8, 8), 3, 4),
                                            ((7, 7, 7), 4, 3)])
def test_folded_factors_match_jax_vmap(shape, levels, k):
    js, ts, vals, _ = _family(shape, levels, k)
    bt = ts.factorize_many(vals)
    jf = jfrontal.factor_many(js.fplan, jfrontal.assemble_fronts(
        js.fplan, js.rows, js.cols, vals, dtype=np.float64))
    for lvl in range(ts.fplan.levels):
        ref = np.asarray(jf[lvl])                       # [K, B, F, W]
        got = bt.factors[lvl]
        assert got.shape == (k * ref.shape[1],) + ref.shape[2:]
        assert _rel(got.view(ref.shape), ref) <= F64_REL, lvl


def test_two_piece_family_matches_jax_vmap():
    """Every non-leaf level of the family forced through the two-piece
    path (K-fold child maps in the gathers and the leaf X expansion)."""
    js, ts, vals, _ = _family((7, 7, 7), 4, 3)
    fp = tfrontal.FamilyView(ts.fplan, 3)
    plan = regimes.plan_regimes(ts.fplan, np.float64, BIG, family=3,
                                two_piece=True)
    assert all(lp.two_piece for lp in plan.levels[:-1])
    fronts = FrontAssembler(ts.fplan, ts.rows, ts.cols, "cpu")(
        vals, dtype=np.float64)
    got = tfrontal.factor(fp, fronts, plan)
    jf = jfrontal.factor_many(js.fplan, jfrontal.assemble_fronts(
        js.fplan, js.rows, js.cols, vals, dtype=np.float64))
    for lvl in range(ts.fplan.levels):
        ref = np.asarray(jf[lvl])
        assert _rel(got[lvl].view(ref.shape), ref) <= F64_REL, lvl


@pytest.mark.parametrize("shared", [False, True])
def test_batched_solve_residual_logdet_match_jax(shared):
    js, ts, vals, b = _family((7, 7, 7), 4, 3)
    bt, bj = ts.factorize_many(vals), js.factorize_many(vals)
    assert isinstance(bt, BatchedFactors) and bt.k == 3
    B = b if shared else np.random.default_rng(3).standard_normal(
        (3, ts.plan.n))
    X, Xj = bt.solve(B), bj.solve(B)
    assert X.shape == (3, ts.plan.n) and X.dtype == np.float64
    assert _rel(X, Xj) <= X_REL
    res = bt.residual(B, X)
    assert res.shape == (3,) and np.all(res <= TOL)
    assert np.allclose(res, bj.residual(B, X), rtol=1e-6, atol=1e-16)
    np.testing.assert_allclose(bt.logdet(), bj.logdet(), rtol=TOL)


def test_batched_f32_refinement():
    """An f32 family refines on the device loop (shared ELL index, a value
    plane per system) to the contract, for every system."""
    _, ts, vals, b = _family((8, 8, 8), 4, 3, dtype=np.float32)
    bt = ts.factorize_many(vals)
    X = bt.solve(b)
    assert np.all(bt.residual(b, X) <= TOL)
    assert bt.last_solve["loop"] == "device"
    assert bt.last_solve["sweeps"] >= 1
    X0 = bt.solve(b, refine="never")
    assert np.all(bt.residual(b, X0) > TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_refine_false_means_never(dtype):
    """BatchedFactors.solve(refine=False) solves once, as "never" does and
    as the JAX package's family solve does for False; True and "yes"
    raise."""
    js, ts, vals, b = _family((7, 7, 7), 4, 3, dtype=dtype)
    bt, bj = ts.factorize_many(vals), js.factorize_many(vals)
    X = bt.solve(b, refine=False)
    assert bt.last_solve["loop"] == "none" and bt.last_solve["sweeps"] == 0
    assert np.array_equal(X, bt.solve(b, refine="never"))
    rel = 1e-4 if dtype == np.float32 else X_REL   # one f32 solve each
    assert _rel(X, bj.solve(b, refine=False)) <= rel
    for bad in (True, "yes"):
        with pytest.raises(ValueError, match="refine"):
            bt.solve(b, refine=bad)


def test_batched_host_loop_when_rows_are_too_dense(monkeypatch):
    from cholesky_tpu_torch.numeric import refine as trefine

    monkeypatch.setattr(trefine, "ELL_MAX_K", 0)
    _, ts, vals, b = _family((8, 8), 3, 2, dtype=np.float32)
    bt = ts.factorize_many(vals)
    X = bt.solve(b)
    assert bt.last_solve["loop"] == "host"
    assert bt.last_solve["host_sweeps"] >= 1
    assert np.all(bt.residual(b, X) <= TOL)


def test_batched_matches_sequential_and_leaves_solver_state_alone():
    _, ts, vals, b = _family(k=3)
    ts.factorize()
    x0 = ts.solve(b)
    panels, plan = ts.panels, ts.regimes
    bt = ts.factorize_many(vals)
    assert ts.panels is panels and ts.regimes is plan and ts.factored
    assert np.array_equal(ts.solve(b), x0)
    X = bt.solve(b)
    for i in range(3):
        s = SparseCholesky(ts.plan, ts.rows, ts.cols, vals[i],
                           dtype=np.float64, device="cpu")
        assert _rel(X[i], s.solve(b)) <= X_REL
        assert abs(bt.logdet()[i] - s.logdet()) <= TOL * abs(s.logdet())


def test_batched_validates_shape():
    _, ts, vals, b = _family()
    with pytest.raises(ValueError):
        ts.factorize_many(vals[:, :-1])
    with pytest.raises(ValueError):
        ts.factorize_many(vals[0])
    with pytest.raises(ValueError):
        ts.factorize_many(vals[:0])
    bt = ts.factorize_many(vals)
    with pytest.raises(ValueError):
        bt.solve(np.ones((3, ts.plan.n)))
    with pytest.raises(ValueError):
        bt.solve(np.ones(ts.plan.n + 1))
    with pytest.raises(ValueError):
        bt.solve(b, refine="sometimes")


def test_routing_rule_decides_on_the_folded_batch(monkeypatch):
    """At 50^3 L8's pivot widths the rule routes levels 7, 6, 5 for one
    system (11 chol_inv launches a factorization), adds levels 4 and 3 for
    K = 8 (19) and level 2 for K = 16 (24). A small family run shows the
    level loop hands factor_slab the folded batch: with MIN_B = 4, no level
    of a 16^3 L4 problem routes for one system, and in a family of 4 every
    level that the rule takes at batch 4 2^lvl does (among them level 1:
    B = 2, W = 128)."""
    def routed(K):
        return [l for l in range(8)
                if hk.slab_kernel_eligible(K << l, W50[l], torch.float32)]

    def launches(K):
        return sum(-(-W50[l] // hk.BS) for l in routed(K))

    assert routed(1) == [5, 6, 7] and launches(1) == 11
    assert routed(8) == [3, 4, 5, 6, 7] and launches(8) == 19
    assert routed(16) == [2, 3, 4, 5, 6, 7] and launches(16) == 24

    n, r, c, v, o, cl, _ = generate_problem((16, 16, 16), 4)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 device="cpu")
    assert ts.fplan.W[1] == 128
    monkeypatch.setattr(hk, "MIN_B", 4)
    calls = []
    slab = hk.factor_slab
    monkeypatch.setattr(hk, "factor_slab", lambda a, W, **kw: calls.append(
        (a.shape[0], W)) or slab(a, W, **kw))
    ts.factorize()
    assert calls == []
    vals = np.stack([ts.vals * s for s in (1.0, 2.0, 3.0, 4.0)])
    bt = ts.factorize_many(vals)
    W = ts.fplan.W
    assert (8, 128) in calls
    assert calls == [(4 << l, W[l]) for l in range(3, -1, -1)
                     if hk.slab_kernel_eligible(4 << l, W[l], torch.float32)]
    b = np.ones(n)
    assert np.all(bt.residual(b, bt.solve(b)) <= TOL)


def test_oversized_family_raises_budget_error():
    """At 8^3 L4 a family of K f32 systems plans ~1 MB a system beside the
    fixed slack: 30 MB over the slack takes K = 2, not K = 64."""
    _, ts, vals, _ = _family((8, 8, 8), 4, 4, dtype=np.float32)
    ts.budget = regimes.SLACK_BYTES + (30 << 20)
    with pytest.raises(regimes.BudgetError, match=r"K = 64 .*split"):
        ts.factorize_many(np.repeat(vals, 16, axis=0))
    bt = ts.factorize_many(vals[:2])
    assert bt.regimes.family == 2 and bt.regimes.peak_bytes <= ts.budget

"""The port's capacity regimes (cholesky_tpu_torch/numeric/regimes.py and
the level loop of numeric/frontal.py) against the JAX package's same
regimes, on the CPU.

The same inputs (`generate_problem` with a seed) go through both packages.
The JAX package is forced into a regime the way its own tests force it
(`tests/test_frontal.py`): its byte gates monkeypatched, its
`CHOLESKY_TPU_*` variables set, or the arguments of
`frontal_factor_streamed`. The port is forced with `budget` or the
keywords of `regimes.plan_regimes` (a solver takes such a plan through its
private `_plan_override`). Tolerances: f64 factors and solves
agree to 1e-12 relative (the same sums in another order); f32 solutions
of the two packages, each refined to a residual <= 1e-10, within 1e-8.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import jax.numpy as jnp

import cholesky_tpu
from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky, convert
from cholesky_tpu_torch.numeric import frontal as tfrontal
from cholesky_tpu_torch.numeric import regimes
from cholesky_tpu_torch.numeric.assemble import FrontAssembler
from cholesky_tpu_torch.numeric.frontal_plan import (build_frontal_plan,
                                                     hands_x)

F64_REL = 1e-12     # f64: the same algorithm up to summation order
TOL = 1e-10         # the solver's relative-residual contract
X_REL = 1e-8        # solutions of the two packages, both at <= 1e-10
PROBLEMS = [((15, 14), 4), ((12, 12, 12), 6)]
BIG = 1 << 40       # a budget that binds nothing

# Per-level front and pivot widths of the JAX package's largest verified
# run, 140^3 under 14 levels of nested dissection (tools/run_scale140.py),
# and of the 50^3 L8 smoke problem, from the port's host plan.
F140 = (19600, 29400, 24504, 19608, 17016, 11912, 8168, 5224, 3192, 2032,
        1264, 736, 448, 512)
W140 = (19600, 9800, 4904, 4904, 2456, 1232, 1232, 600, 296, 296, 136, 64,
        64, 256)
F50 = (2504, 3760, 3136, 2512, 2160, 1488, 1008, 1440)
W50 = (2504, 1256, 632, 632, 304, 144, 144, 864)
CARD = int(regimes.BUDGET_FRACTION * 80e9)      # default budget, 80 GB free


class _Shapes:
    def __init__(self, F, W):
        self.F, self.W = F, W


def _rel(x, ref):
    x = np.asarray(x.double() if torch.is_tensor(x) else x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


def cut_leaves(problem):
    """A `generate_problem` tuple with every coupling between a leaf
    separator's rows and the other rows dropped (the matrix stays
    diagonally dominant): the leaf fronts have no boundary, F = W at the
    leaf level, so the leaves hand their parents no update."""
    n, r, c, v, o, cl, b = problem
    fp = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl).fplan
    rows = fp.front_rows[-1][:, :fp.W[-1]].ravel()
    leaf = np.zeros(n, bool)
    leaf[fp.plan.perm[rows[rows < n]]] = True
    keep = leaf[r] == leaf[c]
    return n, r[keep], c[keep], v[keep], o, cl, b


def _setup(shape, levels, dtype=np.float64, leaf_boundary=True):
    problem = generate_problem(shape, levels)
    if not leaf_boundary:
        problem = cut_leaves(problem)
    n, r, c, v, o, cl, b = problem
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
    tfp = build_frontal_plan(convert.plan_from_jax(js.plan), js.rows, js.cols)
    fronts = jfrontal.assemble_fronts(js.fplan, js.rows, js.cols, js.vals,
                                      dtype=dtype)
    return js, tfp, fronts, b


_JAX_TWO_PIECE = {}     # the JAX package's two-piece factors, per problem


def _forced(solver, budget=BIG, **force):
    """Make `solver` factor under the plan that `force` (keywords of
    regimes.plan_regimes) gives under `budget`."""
    solver._plan_override = regimes.plan_regimes(solver.fplan, solver.dtype,
                                                 budget, **force)
    return solver


def _port_factor(tfp, fronts, plan):
    # the level loop consumes its slabs: hand it copies
    return tfrontal.factor(tfp, [torch.tensor(f) for f in fronts], plan)


@pytest.mark.parametrize("tier", ["xxt", "gather"])
@pytest.mark.parametrize("shape,levels", PROBLEMS)
def test_two_piece_matches_jax(monkeypatch, shape, levels, tier):
    """Every non-leaf level on the two-piece path, f64. The leaves' parent
    expands X directly (xxt tier) or materializes X X^T and gathers (gather
    tier); the levels above gather. The JAX package's gathermm cap floors
    at 256 MB, so it keeps its own tiers at these sizes; every tier
    computes the same sums."""
    js, tfp, fronts, _ = _setup(shape, levels)
    monkeypatch.setattr(jfrontal, "_TWO_PIECE_BYTES", 1)
    if tier == "gather":
        monkeypatch.setattr(jfrontal, "_GATHERMM_BYTES_CAP", 1)
    key = (shape, levels, tier)
    if key not in _JAX_TWO_PIECE:
        _JAX_TWO_PIECE[key] = [np.asarray(f) for f in jfrontal.frontal_factor(
            js.fplan, tuple(jnp.asarray(f) for f in fronts))]
    jfac = _JAX_TWO_PIECE[key]
    plan = regimes.plan_regimes(tfp, np.float64, BIG, two_piece=True)
    assert all(lp.two_piece for lp in plan.levels[:-1])
    parent = plan.levels[tfp.levels - 2]
    assert parent.xxt_tier
    parent.xxt_tier = tier == "xxt"
    tfac = _port_factor(tfp, fronts, plan)
    for lvl in range(tfp.levels):
        assert _rel(tfac[lvl], jfac[lvl]) <= F64_REL, lvl


@pytest.mark.parametrize("path", ["square", "xxt", "gather"])
@pytest.mark.parametrize("leaf_boundary", [True, False])
def test_leaves_hand_x_where_hands_x_says(monkeypatch, leaf_boundary, path):
    """`frontal_plan.hands_x` decides the form of the leaves' update. With
    a leaf boundary (F > W) the leaves hand their parent X, which the
    parent turns into X X^T once, by `_rows_product` (square path, gather
    tier), or expands by `_expand_xxt_2` (xxt tier), and the planner
    offers the parent the xxt tier; without one (F = W) the parent gets no
    update, neither runs on a leaf's X, and the planner offers no xxt
    tier. The factor matches the JAX package's, f64."""
    js, tfp, fronts, _ = _setup((12, 11), 3, leaf_boundary=leaf_boundary)
    L = tfp.levels
    x = hands_x(tfp.F, tfp.W, L - 1)
    assert x == leaf_boundary
    assert not any(hands_x(tfp.F, tfp.W, cl) for cl in range(L - 1))
    plan = regimes.plan_regimes(tfp, np.float64, BIG,
                                two_piece=path != "square")
    parent = plan.levels[L - 2]
    assert parent.two_piece == (path != "square")
    assert parent.xxt_tier == (x and path != "square")
    parent.xxt_tier = path == "xxt" and x
    leaf_x = (tfp.F[L - 1] - tfp.W[L - 1], tfp.W[L - 1])
    seen, handed = [], []
    for name, arg in (("_rows_product", 0), ("_expand_xxt_2", 1)):
        def spy(*a, _real=getattr(tfrontal, name), _name=name, _arg=arg,
                **k):
            if tuple(a[_arg].shape[1:]) == leaf_x:
                seen.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(tfrontal, name, spy)
    real_level = tfrontal._factor_level

    def level_spy(fp, lvl, piv, U, *a):
        if lvl == L - 2:
            handed.append(None if U is None else tuple(U.shape))
        return real_level(fp, lvl, piv, U, *a)

    monkeypatch.setattr(tfrontal, "_factor_level", level_spy)
    tfac = _port_factor(tfp, fronts, plan)
    assert handed == [(1 << L - 1,) + leaf_x if x else None]
    assert seen == ([] if not x else
                    ["_expand_xxt_2" if path == "xxt" else "_rows_product"])
    jfac = jfrontal.frontal_factor(js.fplan,
                                   tuple(jnp.asarray(f) for f in fronts))
    for lvl in range(L):
        assert _rel(tfac[lvl], jfac[lvl]) <= F64_REL, lvl


@pytest.mark.parametrize("view", ["plan", "family", "batch", "slot",
                                  "planner"])
def test_hands_x_reads_every_view(view):
    """The predicate reads F and W, which the plan, each of its views and
    the planner's bare tuples carry alike: true at the leaf level of a
    plan with a leaf boundary, nowhere without one."""
    for leaf_boundary in (True, False):
        _, tfp, _, _ = _setup((12, 11), 3, leaf_boundary=leaf_boundary)
        v = {"plan": tfp, "family": tfrontal.FamilyView(tfp, 3),
             "batch": tfrontal._BatchView(tfp, 1, 0, 1),
             "slot": tfrontal._SlotView(tfp, {2: (0, 2)}),
             "planner": _Shapes(tuple(int(f) for f in tfp.F),
                                tuple(int(w) for w in tfp.W))}[view]
        got = [hands_x(v.F, v.W, cl) for cl in range(1, tfp.levels)]
        assert got == [False] * (tfp.levels - 2) + [leaf_boundary]


@pytest.mark.parametrize("chunks", [{5: 2, 4: 2}, {5: 8, 3: 4, 2: 2},
                                    {4: 4}])
def test_chunked_levels_match_jax(monkeypatch, chunks):
    """Batch-chunked levels with lazy assembly, offload of finished levels
    and the spill of emitted update pieces, f64, against the unchunked run
    of both packages; the JAX package runs the same chunk map."""
    js, tfp, fronts, _ = _setup((12, 12, 12), 6)
    jfp = js.fplan
    jref = jfrontal.frontal_factor_streamed(
        jfp, tuple(jnp.asarray(f) for f in fronts), donate=False, chunks={})
    monkeypatch.setattr(jfrontal, "_U_OFFLOAD_BYTES", 1)
    jlz = jfrontal.LazyFronts(jfrontal.FrontAssembler(jfp, js.rows, js.cols),
                              js.vals, dtype=np.float64)
    jout = jfrontal.frontal_factor_streamed(jfp, jlz, donate=True,
                                            offload=True, chunks=chunks)
    tref = _port_factor(tfp, fronts,
                        regimes.plan_regimes(tfp, np.float64, BIG))
    plan = regimes.plan_regimes(tfp, np.float64, BIG, chunks=chunks,
                                lazy=True, offload=True, spill=True,
                                reupload=False)
    assert {l: lp.chunks for l, lp in enumerate(plan.levels)
            if lp.chunks > 1} == chunks
    assert all(lp.offload for lp in plan.levels[1:])
    assert [lp.spill for lp in plan.levels] == [
        lp.chunks > 1 for lp in plan.levels]
    asm = FrontAssembler(tfp, js.rows, js.cols, "cpu")
    tout = tfrontal.factor(tfp, asm.lazy(js.vals, np.float64), plan)
    for lvl in range(tfp.levels):
        assert _rel(tout[lvl], tref[lvl]) <= F64_REL, lvl
        assert _rel(tout[lvl], jref[lvl]) <= F64_REL, lvl
        assert _rel(np.asarray(jout[lvl]), jref[lvl]) <= F64_REL, lvl


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunk_assembly_bit_identical(dtype):
    """Per-chunk lazy assembly is exactly the slice of the level's slab, and
    the JAX package's LazyFronts.chunk, padded-diagonal ones included."""
    n, r, c, v, o, cl, _ = generate_problem((14, 13), 4)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
    tfp = build_frontal_plan(convert.plan_from_jax(js.plan), js.rows, js.cols)
    jlz = jfrontal.LazyFronts(
        jfrontal.FrontAssembler(js.fplan, js.rows, js.cols), js.vals,
        dtype=dtype)
    tlz = FrontAssembler(tfp, js.rows, js.cols, "cpu").lazy(js.vals, dtype)
    for lvl in range(1, tfp.levels):
        full = tlz[lvl].numpy()
        assert full.tobytes() == np.asarray(jlz[lvl]).tobytes()
        B = 1 << lvl
        for nc in (2, B):
            cb = B // nc
            for ch in range(nc):
                c0, c1 = ch * cb, (ch + 1) * cb
                got = tlz.chunk(lvl, c0, c1).numpy()
                assert got.tobytes() == full[c0:c1].tobytes()
                assert got.tobytes() == np.asarray(
                    jlz.chunk(lvl, c0, c1)).tobytes()


@pytest.mark.parametrize("shape,levels", PROBLEMS)
def test_frontal_solve_without_inverses_matches_jax(shape, levels):
    """The solve without pivot inverses (per-level triangular solves in the
    permuted basis) on the same f64 factor."""
    js, tfp, fronts, _ = _setup(shape, levels)
    jfac = jfrontal.factor(js.fplan, fronts)
    b = np.random.default_rng(4).standard_normal(js.plan.n)
    ref = jfrontal.solve(js.fplan, jfac, jnp.asarray(b))   # frontal_solve
    out = tfrontal.frontal_solve(tfp, [torch.from_numpy(np.array(f))
                                       for f in jfac], torch.from_numpy(b))
    assert out.dtype == torch.float64
    assert _rel(out, ref) <= F64_REL


@pytest.mark.parametrize("case", ["bf16_updates", "bf16_store_offload"])
@pytest.mark.parametrize("shape,levels", PROBLEMS)
def test_low_precision_regimes_solve_like_jax(monkeypatch, case, shape,
                                              levels):
    """f32 fronts with bf16 child updates (two-piece), and a bf16 factor
    offloaded to host memory and not re-uploaded (the solve reads
    host-resident levels, without pivot inverses: the budget leaves no room
    for them): both solve to the residual contract, and to the JAX
    package's solution of the same regime."""
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    if case == "bf16_updates":
        monkeypatch.setattr(jfrontal, "_TWO_PIECE_BYTES", 1)
        monkeypatch.setenv("CHOLESKY_TPU_UPDATE_DTYPE", "bfloat16")
        budget, force = BIG, dict(two_piece=True,
                                  update_dtype=torch.bfloat16)
    else:
        monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
        monkeypatch.setenv("CHOLESKY_TPU_OFFLOAD", "1")
        monkeypatch.setattr(jfrontal, "_F32_STORE_BYTES", 0)
        monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", "1")
        budget, force = 600 << 20, dict(store_dtype=torch.bfloat16,
                                        offload=True, reupload=False,
                                        lazy=True)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    xj = js.solve(b)
    assert js.residual(b, xj) <= TOL
    ts = _forced(SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                         device="cpu"), budget, **force)
    ts.factorize()
    levels_ = ts.regimes.levels
    if case == "bf16_updates":
        assert all(lp.two_piece and lp.update_dtype == torch.bfloat16
                   for lp in levels_[1:-1])
    else:
        assert all(p.dtype == torch.bfloat16 for p in ts.panels)
        assert all(lp.offload for lp in levels_[1:])
        assert not ts.regimes.reupload
    x = ts.solve(b)
    assert ts.last_solve["engine"] == (
        "banded" if case == "bf16_updates" else "plain")
    assert ts.residual(b, x) <= TOL
    assert np.linalg.norm(x - xj) <= X_REL * np.linalg.norm(xj)


def test_state_from_jax_carries_bf16_host_levels(monkeypatch):
    """A JAX factor stored bf16 and kept in host memory solves in the
    port."""
    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setenv("CHOLESKY_TPU_OFFLOAD", "1")
    monkeypatch.setattr(jfrontal, "_F32_STORE_BYTES", 0)
    monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", "1")
    n, r, c, v, o, cl, b = generate_problem((16, 15), 4)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    js.factorize()
    assert any(isinstance(p, np.ndarray) for p in js.panels)
    ts = convert.state_from_jax(js, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in ts.panels)
    for p, q in zip(ts.panels, js.panels):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(q).astype(np.float32))
    assert ts.residual(b, ts.solve(b)) <= TOL


def test_budget_plan_at_140_cubed():
    """The plan on 140^3 L14's level shapes. With the default budget of an
    80 GB card every level fits on the square path (its extend-add and
    Schur temporaries are bounded by row chunks), in f32, in core; a level
    takes two-piece exactly where the square path's estimate passes the
    budget. Half the card (40 GiB) forces two-piece levels, and a budget
    that fits nothing names the level and the bytes."""
    shapes = _Shapes(F140, W140)
    for budget in (CARD, 40 << 30, 24 << 30):
        plan = regimes.plan_regimes(shapes, np.float32, budget)
        assert plan.peak_bytes <= budget
        for lvl, lp in enumerate(plan.levels[:-1]):
            assert lp.peak_bytes <= budget
            assert lp.two_piece == (lp.square_bytes > budget), (budget, lvl)
    card = regimes.plan_regimes(shapes, np.float32, CARD)
    assert not any(lp.two_piece for lp in card.levels)
    assert all(lp.update_dtype == lp.store_dtype == torch.float32
               and lp.chunks == 1 and not lp.offload for lp in card.levels)
    half = regimes.plan_regimes(shapes, np.float32, 40 << 30)
    assert half.levels[4].two_piece
    assert sum(lp.two_piece for lp in half.levels) >= 3
    with pytest.raises(regimes.BudgetError, match=r"level \d+ "):
        regimes.plan_regimes(shapes, np.float32, 4 << 30)


def test_budget_plan_at_50_cubed_is_in_core_square():
    plan = regimes.plan_regimes(_Shapes(F50, W50), np.float32, CARD)
    assert not plan.lazy and not plan.reupload
    assert all(not lp.two_piece and lp.chunks == 1 and not lp.offload
               and lp.update_dtype == lp.store_dtype == torch.float32
               for lp in plan.levels)
    f64 = regimes.plan_regimes(_Shapes(F50, W50), np.float64, 1 << 30)
    assert all(lp.store_dtype == lp.update_dtype == torch.float64
               for lp in f64.levels)


def _level_peaks(solver):
    """Per-level peak bytes the CPU allocator handed out during
    factorize(), above what was allocated when it began (profiler memory
    events between the level's start and end)."""
    marks = {}

    def hook(lvl, what):
        if what == "start":
            marks[lvl] = record_function(f"level {lvl}")
            marks[lvl].__enter__()
        else:
            marks[lvl].__exit__(None, None, None)

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        solver.factorize(level_hook=hook)
    events = list(prof.profiler.kineto_results.events())
    mem = sorted((e.start_ns(), e.nbytes()) for e in events
                 if e.name() == "[memory]")
    ts = np.array([t for t, _ in mem])
    cum = np.cumsum([d for _, d in mem])
    peaks = {}
    for e in events:
        if e.name().startswith("level "):
            i0 = np.searchsorted(ts, e.start_ns())
            i1 = np.searchsorted(ts, e.start_ns() + e.duration_ns(),
                                 side="right")
            before = cum[i0 - 1] if i0 else 0
            peaks[int(e.name()[6:])] = max([before, *cum[i0:i1]])
    return peaks


@pytest.mark.parametrize("dtype,regime", [
    (np.float32, {}),
    (np.float32, dict(two_piece=True)),
    (np.float32, dict(two_piece=True, update_dtype=torch.bfloat16,
                      lazy=True)),
    (np.float32, dict(chunks={4: 4, 3: 2, 2: 2}, lazy=True)),
    (np.float32, dict(update_dtype=torch.bfloat16, lazy=True)),
    (np.float32, dict(store_dtype=torch.bfloat16, chunks={5: 2},
                      lazy=True)),
    (np.float64, dict(two_piece=True, chunks={3: 2}, lazy=True))])
def test_level_estimates_bound_cpu_allocations(dtype, regime):
    """Each level's estimate, less the fixed slack for library workspaces,
    bounds what the port's code allocated during the level on the CPU
    (second factorization: the assembler's chunk indices are cached). The
    card checks the whole estimate (chip_smoke.py). Offload is left out:
    on the CPU, host memory is the device's."""
    n, r, c, v, o, cl, _ = generate_problem((16, 15, 14), 6)
    s = _forced(SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                        device="cpu"), **regime)
    s.factorize()
    s.panels, s.factored = None, False      # measure from an empty start
    peaks = _level_peaks(s)
    for lvl, lp in enumerate(s.regimes.levels):
        assert peaks[lvl] <= lp.peak_bytes - regimes.SLACK_BYTES, (
            lvl, peaks[lvl], lp.peak_bytes - regimes.SLACK_BYTES)


def test_plan_is_searched_once_per_budget(monkeypatch):
    """A refactorization under the same budget reuses the solver's plan;
    another budget plans again."""
    n, r, c, v, o, cl, b = generate_problem((12, 12), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cpu", budget=1 << 30)
    budgets = []
    search = regimes.plan_regimes
    monkeypatch.setattr(regimes, "plan_regimes", lambda fp, dtype, budget:
                        budgets.append(budget) or search(fp, dtype, budget))
    s.factorize()
    plan = s.regimes
    s.factorize()
    assert budgets == [1 << 30] and s.regimes is plan
    s.budget = 1 << 29
    s.factorize()
    assert budgets == [1 << 30, 1 << 29] and s.regimes.budget == 1 << 29
    assert s.factor_stats["plan_s"] >= 0
    assert s.residual(b, s.solve(b)) <= TOL

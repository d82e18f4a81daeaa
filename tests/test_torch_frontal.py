"""The port's host plan, device assembly, per-level factorization and banded
solve (cholesky_tpu_torch/numeric/) against the JAX package on the same
inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cholesky_tpu
from cholesky_tpu.io import mmio
from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.numeric import refine as jrefine
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import convert
from cholesky_tpu_torch.numeric import frontal as tfrontal
from cholesky_tpu_torch.numeric import frontal_plan, hopper_kernels as hk
from cholesky_tpu_torch.numeric import regimes
from cholesky_tpu_torch.numeric import refine as trefine
from cholesky_tpu_torch.numeric.assemble import FrontAssembler
from tests.conftest import FIXTURES
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

F64_REL = 1e-12     # f64 factors: same algorithm up to summation order
F32_REL = 1e-4      # f32 factors: rounding grows with the front chain


def _jax_solver(paths, name, dtype=np.float64):
    p = paths(name)
    return cholesky_tpu.SparseCholesky.from_files(
        p["mat"], p["separators"], p["clusters"], dtype=dtype)


def _port_plan(js):
    return frontal_plan.build_frontal_plan(convert.plan_from_jax(js.plan),
                                           js.rows, js.cols)


def _in_core(tfp, fronts):
    """The port's factor of host slabs under an unbounded budget: every
    level square, updates and factor in the slabs' dtype, on the device."""
    plan = regimes.plan_regimes(tfp, fronts[0].dtype, 1 << 40)
    return tfrontal.factor(tfp, [torch.from_numpy(f) for f in fronts], plan)


def _rel(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_frontal_plan_identical(name, port_fixtures):
    js = _jax_solver(port_fixtures, name)
    jfp, tfp = js.fplan, _port_plan(js)
    assert tfp.W == jfp.W and tfp.F == jfp.F
    assert tfp.fingerprint == jfp.fingerprint and tfp.key() == jfp.key()
    for lvl in range(jfp.levels):
        np.testing.assert_array_equal(tfp.front_rows[lvl],
                                      jfp.front_rows[lvl])
        for field in ("inv_child", "fwd_child"):
            a, b = getattr(tfp, field)[lvl], getattr(jfp, field)[lvl]
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_banded_maps_and_ell_identical(name, port_fixtures):
    js = _jax_solver(port_fixtures, name)
    jfp, tfp = js.fplan, _port_plan(js)
    jm, tm = jfrontal._banded_maps(jfp), frontal_plan._banded_maps(tfp)
    assert tm[0] == jm[0] and list(tm[1]) == list(jm[1])
    for a, b in zip(tm[2:4], jm[2:4]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tm[4], jm[4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    pr, pc, pv = js._perm_coo()
    jell = jrefine.build_ell(js.plan.n, pr, pc, pv)
    tell = trefine.build_ell(js.plan.n, pr, pc, pv)
    for a, b in zip(tell, jell):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(trefine.pad_ell(tfp, tell), jrefine.pad_ell(jfp, jell)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_assembly_bit_identical(name, dtype, port_fixtures):
    js = _jax_solver(port_fixtures, name)
    tfp = _port_plan(js)
    ref = jfrontal.assemble_fronts(js.fplan, js.rows, js.cols, js.vals,
                                   dtype=dtype)
    host = frontal_plan.assemble_fronts(tfp, js.rows, js.cols, js.vals,
                                        dtype=dtype)
    dev = FrontAssembler(tfp, js.rows, js.cols, "cpu")(js.vals, dtype=dtype)
    for r, h, d in zip(ref, host, dev):
        assert d.dtype == torch.from_numpy(r).dtype
        assert tuple(d.shape) == r.shape
        assert d.numpy().tobytes() == r.tobytes()
        assert h.tobytes() == r.tobytes()


def _factor_both(shape, levels, dtype):
    n, r, c, v, o, cl, _ = generate_problem(shape, levels)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
    jfp = js.fplan
    fronts = jfrontal.assemble_fronts(jfp, js.rows, js.cols, js.vals,
                                      dtype=dtype)
    jfac = jfrontal.frontal_factor(jfp, tuple(jnp.asarray(f) for f in fronts))
    tfp = _port_plan(js)
    tfac = _in_core(tfp, fronts)
    return js, tfp, [np.array(f) for f in jfac], tfac


@pytest.mark.parametrize("dtype,tol,route", [
    (np.float64, F64_REL, "default"),
    (np.float32, F32_REL, "default"),
    (np.float32, F32_REL, "kernel")])
def test_level_factors_match_jax(monkeypatch, dtype, tol, route):
    """Per-level [B, F, W] factors of a 15^3 Laplacian (levels 0 and 4 have
    W = 232 and 152). route="kernel" lowers the routing constants so that
    both go through factor_slab; the JAX package factors them with its
    blocked Cholesky on the CPU."""
    calls = []
    if route == "kernel":
        monkeypatch.setattr(hk, "MIN_B", 1)
        monkeypatch.setattr(hk, "W_PER_B", 1 << 20)
        real = hk.factor_slab
        monkeypatch.setattr(hk, "factor_slab",
                            lambda a, W: calls.append(W) or real(a, W))
    js, tfp, jfac, tfac = _factor_both((15, 15, 15), 5, dtype)
    assert tfp.W[0] == 232 and tfp.W[4] == 152
    assert sorted(calls) == ([152, 232] if route == "kernel" else [])
    for lvl in range(tfp.levels):
        assert tfac[lvl].dtype == torch.from_numpy(jfac[lvl]).dtype
        assert _rel(tfac[lvl], jfac[lvl]) <= tol, lvl


@pytest.mark.parametrize("impl", ["form_front_ref"])
def test_fused_extend_add_matches_jax(impl):
    """The square path's extend-add against the JAX package's:
    `form_front_ref` on a front that starts from its pivot slab (zeros
    right of W)."""
    n, r, c, v, o, cl, _ = generate_problem((9, 8, 7), 4)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
    tfp = _port_plan(js)
    rng = np.random.default_rng(0)
    for child in range(1, tfp.levels):
        B = 1 << (child - 1)
        Fp, Wp = tfp.F[child - 1], tfp.W[child - 1]
        K = tfp.F[child] - tfp.W[child]
        full = rng.standard_normal((B, Fp, Fp))
        full[:, :, Wp:] = 0
        U = rng.standard_normal((2 * B, K, K))
        ref = jfrontal._apply_child_updates_fused(
            js.fplan, jnp.asarray(full), jnp.asarray(U), child)
        inv, _ = tfrontal._child_maps(tfp, child, torch.device("cpu"))
        out = hk.form_front_ref(torch.from_numpy(full[:, :, :Wp]),
                                torch.from_numpy(U), inv, Fp, Wp)
        assert not out[:, Fp].any()
        np.testing.assert_allclose(out[:, :Fp].numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-12)


# f32 fronts against the JAX package's in f64: (p - u0) - u1 rounds twice in
# f32, each rounding within 2^-24 of a sum of three entries of at most this
# size's magnitude; the bound allows twice that
FRONT_F32_ATOL = 4 * 2.0 ** -24 * 3 * 4.0


@pytest.mark.parametrize("case", ["f64", "f32", "bf16_updates", "xxt",
                                  "family", "no_update"])
def test_form_front_matches_jax(case):
    """`_form_front` (on the CPU `form_front_ref`) against the JAX
    package's `_apply_child_updates_fused` on the padded pivot slab, at
    every level of a 9x8x7 L4 plan with children: f64 to 1e-12, f32 fronts
    (f32 or bf16 updates) to FRONT_F32_ATOL, the leaves' X as the level
    loop hands it (its X X^T by `_rows_product`; the JAX package's in
    f64), a family of two systems folded into the batch (each system
    against the single-system plan), and no update (None: the padded slab
    exactly). The sentinel row reads zero."""
    n, r, c, v, o, cl, _ = generate_problem((9, 8, 7), 4)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
    tfp = _port_plan(js)
    fp = tfrontal.FamilyView(tfp, 2) if case == "family" else tfp
    K = 2 if case == "family" else 1
    fdt = torch.float64 if case in ("f64", "xxt", "family") else torch.float32
    udt = torch.bfloat16 if case == "bf16_updates" else fdt
    rng = np.random.default_rng(3)
    for child in range(1, tfp.levels):
        B = K << (child - 1)
        Fl, Wl = tfp.F[child - 1], tfp.W[child - 1]
        Kc, Wc = tfp.F[child] - tfp.W[child], tfp.W[child]
        piv = torch.from_numpy(rng.uniform(-4, 4, (B, Fl, Wl))).to(fdt)
        if case == "xxt":
            X = torch.from_numpy(rng.standard_normal((2 * B, Kc, Wc)))
            U = tfrontal._rows_product(X, X.dtype)
            U_ref = (X @ X.transpose(1, 2)).numpy()
        elif case == "no_update":
            U, U_ref = None, np.zeros((2 * B, Kc, Kc))
        else:
            U = torch.from_numpy(rng.uniform(-4, 4, (2 * B, Kc, Kc))).to(udt)
            U_ref = U.double().numpy()
        out = tfrontal._form_front(fp, piv, U, child)
        assert out.shape == (B, Fl + 1, Fl) and out.dtype == fdt
        assert out.is_contiguous()
        assert not out[:, Fl].any()
        full = np.zeros((B, Fl, Fl))
        full[:, :, :Wl] = piv.double().numpy()
        b1 = B // K
        for k in range(K):          # system k: fronts [k b1, (k + 1) b1)
            ref = np.asarray(jfrontal._apply_child_updates_fused(
                js.fplan, jnp.asarray(full[k * b1:(k + 1) * b1]),
                jnp.asarray(U_ref[2 * k * b1:2 * (k + 1) * b1]), child))
            got = out[k * b1:(k + 1) * b1, :Fl].double().numpy()
            if case == "no_update":
                np.testing.assert_array_equal(got, ref)
            elif fdt == torch.float64:
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
            else:
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=FRONT_F32_ATOL)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_banded_solve_matches_jax(dtype, tol):
    """invert_pivots + _solve_banded on the JAX factor, in both packages.
    The JAX package inverts in f32 whatever the factor's dtype, so the f64
    case compares against inverses computed in f64 here."""
    js, tfp, jfac, _ = _factor_both((8, 7, 6), 3, dtype)
    b = np.random.default_rng(1).standard_normal(js.plan.n).astype(dtype)
    jinv = jfrontal.invert_pivots(js.fplan, tuple(jnp.asarray(f)
                                                  for f in jfac))
    tinv = tfrontal.invert_pivots(tfp, [torch.from_numpy(f) for f in jfac])
    for a, r in zip(tinv, jinv):
        assert _rel(a, r) <= max(tol, 1e-5)
    if dtype == np.float64:
        jinv = tuple(jnp.asarray(t.numpy()) for t in tinv)
    ref = jfrontal._solve_banded(js.fplan, tuple(jnp.asarray(f) for f in jfac),
                                 jinv, jnp.asarray(b))
    out = tfrontal._solve_banded(tfp, [torch.from_numpy(f) for f in jfac],
                                 tinv, torch.from_numpy(b))
    assert out.dtype == torch.from_numpy(b).dtype
    assert _rel(out, ref) <= tol


def test_unported_regimes_raise():
    """No capacity regime is left unported: square fronts past the JAX
    package's 512 MiB gate take the two-piece path and front sets past its
    5 GiB gate the lazily assembled, offloaded level loop. What raises is a
    budget that no regime plan fits, and the error names the level and the
    bytes."""
    n, r, c, v, o, cl, _ = generate_problem((9, 9), 3)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
    tfp = _port_plan(js)
    fronts = frontal_plan.assemble_fronts(tfp, js.rows, js.cols, js.vals,
                                          dtype=np.float64)
    ref = _in_core(tfp, fronts)
    plan = regimes.plan_regimes(tfp, np.float64, 1 << 40, two_piece=True,
                                offload=True, reupload=False)
    out = tfrontal.factor(tfp, [torch.tensor(f) for f in fronts], plan)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= F64_REL
    with pytest.raises(regimes.BudgetError,
                       match=r"level \d+ .*needs at least \d+ bytes"):
        regimes.plan_regimes(tfp, np.float64, 1 << 20)


def test_df_matvec_matches_jax():
    """The double-float ELL matvec agrees with the JAX package's to the
    double-float floor, and with an f64 CSR product."""
    n, r, c, v, o, cl, _ = generate_problem((10, 9, 8), 4)
    rr, cc, vv = mmio.symmetrize_coo(*mmio.dedup_lower(r, c, v))
    idx, a_hi, a_lo = trefine.build_ell(n, rr, cc, vv)
    x64 = np.concatenate([np.random.default_rng(2).standard_normal(n), [0.0]])
    x_hi, x_lo = trefine.split_f64(x64)
    t = trefine.df_matvec(torch.from_numpy(idx.astype(np.int64)),
                          *(torch.from_numpy(a) for a in (a_hi, a_lo, x_hi,
                                                          x_lo)))
    j = jrefine.df_matvec(*(jnp.asarray(a) for a in (idx, a_hi, a_lo, x_hi,
                                                     x_lo)))
    y_t = t[0].numpy().astype(np.float64) + t[1].numpy()
    y_j = np.asarray(j[0], np.float64) + np.asarray(j[1])
    import scipy.sparse

    y64 = scipy.sparse.csr_matrix((vv, (rr, cc)), shape=(n, n)) @ x64[:n]
    assert _rel(y_t, y_j) <= 1e-13
    assert _rel(y_t, y64) <= 1e-13


def test_extents_follow_batch_and_family_views():
    """Each front's (m_b, p_b): the non-sentinel rows of its row list after
    and before W; a family repeats them per system, and a batch view of
    blocks [c0, c1) of level l cuts level l to them and level l + 1 to
    [2 c0, 2 c1)."""
    n, r, c, v, o, cl, _ = generate_problem((9, 8, 7), 4)
    tfp = _port_plan(cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl))
    cpu = torch.device("cpu")
    for lvl in range(tfp.levels):
        ext = tfrontal._extents(tfp, lvl, cpu)
        fr, W = tfp.front_rows[lvl], tfp.W[lvl]
        m = [int((row[W:] < n).sum()) for row in fr]
        p = [int((row[:W] < n).sum()) for row in fr]
        assert ext.dtype == torch.int64
        assert ext.tolist() == [list(mp) for mp in zip(m, p)]
        fam = tfrontal._extents(tfrontal.FamilyView(tfp, 2), lvl, cpu)
        assert fam.tolist() == ext.tolist() * 2
    view = tfrontal._BatchView(tfp, 2, 1, 3)
    for lvl, lo, hi in ((2, 1, 3), (3, 2, 6)):
        whole = tfrontal._extents(tfp, lvl, cpu)[lo:hi]
        assert tfrontal._extents(view, lvl, cpu).tolist() == whole.tolist()


def _poison(fp, U, child_lvl):
    """NaN in every entry of the children's update U [2b, K, K] outside
    each child front's own m_b x m_b block."""
    m = tfrontal._extents(fp, child_lvl, U.device)[:, 0]
    rows = torch.arange(U.shape[1]) < m[:, None]
    U.masked_fill_(~(rows[:, :, None] & rows[:, None, :]), float("nan"))


@pytest.mark.parametrize("regime", [{}, dict(two_piece=True),
                                    dict(chunks={3: 2, 2: 2})])
def test_factor_never_reads_an_update_outside_its_extents(monkeypatch,
                                                          regime):
    """Every children's update poisoned with NaN outside each child front's
    extent before the parent reads it (`_form_front`; the two-piece gather
    tier's extend-add) gives the same f32 factor, bit for bit, as the
    unpoisoned run: square levels, two-piece levels and batch-chunked
    levels read an update only inside its extents."""
    from cholesky_tpu_torch import SparseCholesky

    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)

    def factor():
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    device="cpu")
        s._plan_override = regimes.plan_regimes(s.fplan, s.dtype, 1 << 40,
                                                **regime)
        return [p.clone() for p in s.factorize()], s

    clean, _ = factor()
    form, two = tfrontal._form_front, tfrontal._apply_extadd_two_piece
    poisoned = []

    def poisoned_form(fp, piv, U, child_lvl):
        if U is not None:
            _poison(fp, U, child_lvl)
            poisoned.append(child_lvl)
        return form(fp, piv, U, child_lvl)

    def poisoned_two(fp, slab, U, child_lvl, lp):
        if not lp.xxt_tier:
            _poison(fp, U, child_lvl)
            poisoned.append(child_lvl)
        return two(fp, slab, U, child_lvl, lp)

    monkeypatch.setattr(tfrontal, "_form_front", poisoned_form)
    monkeypatch.setattr(tfrontal, "_apply_extadd_two_piece", poisoned_two)
    dirty, s = factor()
    assert poisoned
    for lvl, (a, d) in enumerate(zip(clean, dirty)):
        assert torch.equal(a, d), lvl
    assert s.residual(b, s.solve(b)) <= 1e-10


@pytest.mark.parametrize("dtype,precision,routed", [
    (np.float32, "highest", True), (np.float32, "default", False),
    (np.float64, "highest", False)])
def test_schur_products_route_by_dtype_and_rung(monkeypatch, dtype,
                                                precision, routed):
    """f32 at IEEE products takes `schur_syrk` at every level with a
    boundary (the leaves' X X^T at their parent); the TF32 rung and f64
    keep the library product. The factor stats carry the executed share
    of the padded full products, computed here from the plan's own
    extents, and no launch on the CPU."""
    from cholesky_tpu_torch import SparseCholesky

    calls = []
    real = hk.schur_syrk
    monkeypatch.setattr(hk, "schur_syrk", lambda X, *a, **k: calls.append(
        tuple(X.shape)) or real(X, *a, **k))
    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype, device="cpu")
    s.factorize(precision=precision)
    fp = s.fplan
    bnd = [lvl for lvl in range(1, fp.levels) if fp.F[lvl] > fp.W[lvl]]
    assert len(calls) == (len(bnd) if routed else 0)
    done = full = 0.0
    for lvl in bnd:
        m, p = tfrontal._extent_host(fp, lvl)
        padded = 2.0 * len(m) * (fp.F[lvl] - fp.W[lvl]) ** 2 * fp.W[lvl]
        full += padded
        done += hk.schur_syrk_flops(m, p).sum() if routed else padded
    assert s.factor_stats["schur_tile_share"] == pytest.approx(done / full)
    assert s.factor_stats["schur_syrk_launches"] == 0
    assert s.residual(b, s.solve(b)) <= 1e-10

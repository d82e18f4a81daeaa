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


def test_fused_extend_add_matches_jax():
    n, r, c, v, o, cl, _ = generate_problem((9, 8, 7), 4)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
    tfp = _port_plan(js)
    rng = np.random.default_rng(0)
    for child in range(1, tfp.levels):
        B = 1 << (child - 1)
        Fp = tfp.F[child - 1]
        K = tfp.F[child] - tfp.W[child]
        full = rng.standard_normal((B, Fp, Fp))
        U = rng.standard_normal((2 * B, K, K))
        ref = jfrontal._apply_child_updates_fused(
            js.fplan, jnp.asarray(full), jnp.asarray(U), child)
        # the port works in place on a buffer with a sentinel row
        out = torch.zeros((B, Fp + 1, Fp), dtype=torch.float64)
        out[:, :Fp] = torch.from_numpy(full)
        tfrontal._extend_add_fused_(tfp, out, torch.from_numpy(U), child)
        np.testing.assert_allclose(out[:, :Fp].numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-12)


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

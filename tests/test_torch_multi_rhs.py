"""Block right-hand sides in the port (`frontal.solve_multi`, the block
solves of `_solve_banded` / `frontal_solve`, `refine.solve_refined_df_multi`,
`SparseCholesky.solve` of [n, k]) against the JAX package on the same
inputs, on the CPU.

Tolerances: f64 solves agree to 1e-12 relative (the same algorithm up to
summation order); f32 refined blocks reach a per-column relative residual
of 1e-10 (the solver's contract) and agree with the JAX package's solution
to 1e-8 relative per column (both at <= 1e-10 residual, kappa <~ 1e3)."""

import dataclasses

import numpy as np
import pytest
import torch

import cholesky_tpu
import cholesky_tpu_torch
from cholesky_tpu.io import mmio
from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.utils import problems
from cholesky_tpu_torch.numeric import frontal as tfrontal
from cholesky_tpu_torch.numeric import refine as trefine
from cholesky_tpu_torch.numeric import regimes
from tests.conftest import FIXTURES
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

F64_REL = 1e-12
TOL = 1e-10
X_REL = 1e-8
KMAX = 17
NAMES = sorted(FIXTURES) + ["wathen"]
_CACHE = {}


def _block(n, k=KMAX, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k))


def _pair(name, dtype, paths):
    """(JAX solver, port solver), both factored, cached per (name, dtype)."""
    key = (name, np.dtype(dtype).name)
    if key not in _CACHE:
        if name in FIXTURES:
            p = paths(name)
            files = (p["mat"], p["separators"], p["clusters"])
            js = cholesky_tpu.SparseCholesky.from_files(*files, dtype=dtype)
            ts = cholesky_tpu_torch.SparseCholesky.from_files(
                *files, dtype=dtype, device="cpu")
        else:
            n, r, c, v = problems.make_gallery(1)[name]()
            js = cholesky_tpu.SparseCholesky.from_matrix(n, r, c, v,
                                                         dtype=dtype)
            ts = cholesky_tpu_torch.SparseCholesky.from_matrix(
                n, r, c, v, dtype=dtype, device="cpu")
        js.factorize()
        ts.factorize()
        _CACHE[key] = (js, ts)
    return _CACHE[key]


def _jax_block_solution(name, paths, scaled):
    """The JAX package's refined f32 solution of the KMAX-column block (one
    compiled program per problem serves every k below: columns are
    independent), plain and with columns scaled 1e-6..1e6 and one zeroed."""
    key = (name, "x", scaled)
    if key not in _CACHE:
        js, _ = _pair(name, np.float32, paths)
        B = _rhs(js.plan.n, scaled)
        X = js.solve(B)
        assert js.residual(B, X) <= TOL
        _CACHE[key] = X
    return _CACHE[key]


def _rhs(n, scaled):
    B = _block(n)
    if scaled:
        B = B * np.logspace(-6, 6, KMAX)[None, :]
        B[:, 5] = 0.0
    return B


def _col_residuals(s, B, X):
    r = s._matrix_csr() @ X - B
    bn = np.linalg.norm(B, axis=0)
    return np.linalg.norm(r, axis=0) / np.where(bn > 0, bn, 1.0)


def _col_diffs(X, ref):
    rn = np.linalg.norm(ref, axis=0)
    return np.linalg.norm(X - ref, axis=0) / np.where(rn > 0, rn, 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_solve_multi_matches_jax_f64(name, port_fixtures):
    js, ts = _pair(name, np.float64, port_fixtures)
    assert np.array_equal(js.plan.perm, ts.plan.perm)
    Bp = _block(ts.plan.n, 5)[ts.plan.perm]
    ref = np.asarray(jfrontal.solve_multi(js.fplan, js.panels, Bp))
    bt = torch.from_numpy(Bp)
    x = tfrontal.solve_multi(ts.fplan, ts.panels, bt).numpy()
    scale = np.abs(ref).max()
    assert np.abs(x - ref).max() <= F64_REL * scale
    xb = tfrontal._solve_banded(ts.fplan, ts.panels, ts._inv_pivots(),
                                bt).numpy()
    assert np.abs(xb - ref).max() <= F64_REL * scale
    # a block's column is the vector solve of that column
    x0 = tfrontal.frontal_solve(ts.fplan, ts.panels, bt[:, 2].contiguous())
    assert x0.shape == (ts.plan.n,)
    assert np.abs(x0.numpy() - ref[:, 2]).max() <= F64_REL * scale
    with pytest.raises(ValueError):
        tfrontal.solve_multi(ts.fplan, ts.panels, bt[:, 0])


@pytest.mark.parametrize("engine", ["banded", "plain"])
@pytest.mark.parametrize("k", [1, 3, KMAX])
@pytest.mark.parametrize("name", NAMES)
def test_refined_block_matches_jax_f32(name, k, engine, port_fixtures):
    _, ts = _pair(name, np.float32, port_fixtures)
    ref = _jax_block_solution(name, port_fixtures, False)[:, :k]
    B = _rhs(ts.plan.n, False)[:, :k]
    banded = engine == "banded"
    Xp, sweeps, rn = trefine.solve_refined_df_multi(
        ts.fplan, ts.panels, ts._inv_pivots() if banded else None,
        B[ts.plan.perm], ts._ell_device(banded), tol=TOL / 3)
    X = np.empty_like(Xp)
    X[ts.plan.perm] = Xp
    assert X.shape == (ts.plan.n, k) and sweeps >= 1 and rn <= TOL
    assert _col_residuals(ts, B, X).max() <= TOL
    assert _col_diffs(X, ref).max() <= X_REL


@pytest.mark.parametrize("engine", ["banded", "plain"])
@pytest.mark.parametrize("name", ["lapl_3375x3375", "wathen"])
def test_zero_and_scaled_columns(name, engine, port_fixtures):
    """Columns scaled 1e-6..1e6 and a zero column: the loop stops on
    per-column relative residuals, so every column meets the contract."""
    _, ts = _pair(name, np.float32, port_fixtures)
    ref = _jax_block_solution(name, port_fixtures, True)
    B = _rhs(ts.plan.n, True)
    banded = engine == "banded"
    Xp, _, rn = trefine.solve_refined_df_multi(
        ts.fplan, ts.panels, ts._inv_pivots() if banded else None,
        B[ts.plan.perm], ts._ell_device(banded), tol=TOL / 3)
    X = np.empty_like(Xp)
    X[ts.plan.perm] = Xp
    assert rn <= TOL and np.all(X[:, 5] == 0.0)
    assert _col_residuals(ts, B, X).max() <= TOL
    assert _col_diffs(X, ref).max() <= X_REL


@pytest.mark.parametrize("name", NAMES)
def test_api_block_solve_matches_jax(name, port_fixtures):
    """`solve` of [n, k], [n, 1] and [n, 0] through the API, f32."""
    _, ts = _pair(name, np.float32, port_fixtures)
    ref = _jax_block_solution(name, port_fixtures, False)
    B = _rhs(ts.plan.n, False)
    X = ts.solve(B)
    assert ts.last_solve["loop"] == "device" and ts.last_solve["k"] == KMAX
    assert ts.last_solve["engine"] == "banded"
    assert ts.residual(B, X) <= TOL
    assert _col_diffs(X, ref).max() <= X_REL
    x1 = ts.solve(B[:, :1])
    assert x1.shape == (ts.plan.n,)
    assert np.linalg.norm(x1 - ref[:, 0]) <= X_REL * np.linalg.norm(ref[:, 0])
    assert ts.solve(np.zeros((ts.plan.n, 0))).shape == (ts.plan.n, 0)
    assert ts.last_solve["k"] == 0
    never = ts.solve(B, refine="never")
    assert ts.last_solve["loop"] == "none"
    assert 1e-9 < _col_diffs(never, ref).max() < 1e-3    # an f32 solve
    for bad in (np.zeros((ts.plan.n + 1, 2)), np.zeros((2, 2, 2))):
        with pytest.raises(ValueError):
            ts.solve(bad)
    with pytest.raises(ValueError):
        ts.solve(B, refine="sometimes")


def test_f64_block_and_refine_always(port_fixtures):
    js, ts = _pair("lapl_400x400", np.float64, port_fixtures)
    B = _block(ts.plan.n, 4)
    ref = js.solve(B)
    X = ts.solve(B)
    assert ts.last_solve["loop"] == "none"
    assert np.abs(X - ref).max() <= F64_REL * np.abs(ref).max()
    Xa = ts.solve(B, refine="always")
    assert ts.last_solve["loop"] == "host"
    assert ts.residual(B, Xa) <= 1e-14
    assert np.abs(Xa - ref).max() <= F64_REL * np.abs(ref).max()


@pytest.mark.parametrize("case", ["bf16_updates", "bf16_store_offload"])
def test_block_solve_reads_low_precision_factors(case, port_fixtures):
    """A block against a factor built with bf16 child updates (banded
    engine), and against a bf16 factor held in host memory (the solve
    without inverses promotes it chunk by chunk)."""
    name = "lapl_3375x3375"
    p = port_fixtures(name)
    ref = _jax_block_solution(name, port_fixtures, False)[:, :3]
    ts = cholesky_tpu_torch.SparseCholesky.from_files(
        p["mat"], p["separators"], p["clusters"], dtype=np.float32,
        device="cpu")
    if case == "bf16_updates":
        budget, force = 1 << 40, dict(two_piece=True,
                                      update_dtype=torch.bfloat16)
    else:
        budget, force = 600 << 20, dict(store_dtype=torch.bfloat16,
                                        offload=True, reupload=False,
                                        lazy=True)
    ts._plan_override = regimes.plan_regimes(ts.fplan, ts.dtype, budget,
                                             **force)
    ts.factorize()
    B = _rhs(ts.plan.n, False)[:, :3]
    X = ts.solve(B)
    if case == "bf16_updates":
        assert ts.last_solve["engine"] == "banded"
    else:
        assert all(q.dtype == torch.bfloat16 for q in ts.panels)
        assert all(q.device.type == "cpu" for q in ts.panels)
        assert ts.last_solve["engine"] == "plain"
        # 600 MiB has no room for a block's working set: the host loop ran
        assert ts.last_solve["loop"] == "host"
        # the device loop reads the same host-resident bf16 levels
        Xp, _, rn = trefine.solve_refined_df_multi(
            ts.fplan, ts.panels, None, B[ts.plan.perm],
            ts._ell_device(False), tol=TOL / 3)
        assert rn <= TOL
        assert _col_diffs(Xp, ref[ts.plan.perm]).max() <= X_REL
    assert ts.residual(B, X) <= TOL
    assert _col_diffs(X, ref).max() <= X_REL


def test_wide_block_takes_the_host_loop_under_a_small_budget(port_fixtures):
    """The block residual's [n, K, k] temporaries past the budget: the
    host loop (CSR residual, block device solves) takes over, and meets
    the same contract."""
    p = port_fixtures("lapl_3375x3375")
    ts = cholesky_tpu_torch.SparseCholesky.from_files(
        p["mat"], p["separators"], p["clusters"], dtype=np.float32,
        device="cpu", budget=1300 << 20)
    B = _block(ts.plan.n, 512, seed=3)
    assert ts.solve(B[:, :3]).shape == (ts.plan.n, 3)
    assert ts.last_solve["loop"] == "device"
    X = ts.solve(B)
    assert ts.last_solve["loop"] == "host"
    assert ts.last_solve["sweeps"] == 0 and ts.last_solve["host_sweeps"] >= 1
    assert ts.residual(B, X) <= TOL


def test_block_solve_in_column_chunks(port_fixtures):
    """Under a budget with room for one column of work vectors the block
    goes through the factor column by column, to the same answer."""
    _, ts0 = _pair("lapl_400x400", np.float32, port_fixtures)
    p = port_fixtures("lapl_400x400")
    ts = cholesky_tpu_torch.SparseCholesky.from_files(
        p["mat"], p["separators"], p["clusters"], dtype=np.float32,
        device="cpu")
    ts.factorize()
    ts.regimes = dataclasses.replace(ts.regimes, budget=1)
    assert ts._solve_cols(7) == 1 and not ts._want_inv_pivots()
    B = _block(ts.plan.n, 7, seed=4)
    X = ts.solve(B)
    assert ts.last_solve["loop"] == "host"
    assert ts.last_solve["engine"] == "plain"
    assert ts.residual(B, X) <= TOL
    assert _col_diffs(X, ts0.solve(B)).max() <= X_REL


def test_solve_bytes_and_batch_learn_k():
    F, W = (40, 24), (40, 8)
    one = regimes.solve_bytes(F, W, torch.float32, 7)
    assert one == regimes.solve_bytes(F, W, torch.float32, 7, k=1)
    n_pad = 40 + 2 * 8
    assert (regimes.solve_bytes(F, W, torch.float32, 7, k=9) - one
            == 8 * (40 * (n_pad + 1) * 7 + 24 * (n_pad + 1) * 4))
    # the JAX rule's bytes (6 n K k 4) lie within the per-column term
    assert 40 * (n_pad + 1) * 7 >= 6 * n_pad * 7 * 4
    assert regimes.solve_batch(64, 64, 4) == regimes.solve_batch(64, 64, 4, 1)
    assert (regimes.solve_batch(1 << 12, 1 << 12, 4, 1 << 12)
            < regimes.solve_batch(1 << 12, 1 << 12, 4))


def test_rhs_file_round_trip(tmp_path, port_fixtures):
    """A block written with the port's `write_array` reads back and
    solves."""
    from cholesky_tpu_torch.io import mmio as tmmio

    _, ts = _pair("lapl_25x25", np.float64, port_fixtures)
    B = _block(ts.plan.n, 3)
    tmmio.write_array(str(tmp_path / "B.mtx"), B)
    back = tmmio.read_array(str(tmp_path / "B.mtx"))
    assert np.array_equal(back, mmio.read_array(str(tmp_path / "B.mtx")))
    assert np.array_equal(back, B)
    assert ts.residual(back, ts.solve(back)) <= 1e-13

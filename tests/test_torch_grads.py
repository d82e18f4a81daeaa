"""Value gradients (logdet_grad, solve_grad, quadform_grad) and the sampler
pair (sample, whiten) of the port against the JAX package's, on the CPU.

f64: the two packages' own factorizations agree to 1e-10 relative.
Low-precision factors (stored bf16 or held in host memory, forced through
the plan override): the port's L^-T z and L^T x on its own factor against
the JAX package's transforms (`frontal.upper_solve` / `upper_matvec`) on
the same factor values, both computed in f32: 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cholesky_tpu
from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import regimes

F64_REL = 1e-10     # both packages, f64
F32_REL = 1e-5      # one low-precision factor, both transforms in f32
BIG = 1 << 40


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - ref).max() / np.abs(ref).max())


def _pair(shape=(7, 7, 7), levels=4, dtype=np.float64):
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                 device="cpu")
    return js, ts, b


@pytest.mark.parametrize("which", ["logdet_grad", "solve_grad",
                                   "quadform_grad"])
def test_gradients_match_jax(which):
    js, ts, b = _pair()
    xbar = np.random.default_rng(1).standard_normal(b.shape[0])
    if which == "logdet_grad":
        got, ref = ts.logdet_grad(), js.logdet_grad()
        assert got.shape == ts.vals.shape
        assert _rel(got, ref) <= F64_REL
    elif which == "solve_grad":
        (vbar, lam), (vref, lref) = (ts.solve_grad(b, xbar),
                                     js.solve_grad(b, xbar))
        assert _rel(vbar, vref) <= F64_REL and _rel(lam, lref) <= F64_REL
        # with x passed in, one solve fewer and the same answer
        v2, _ = ts.solve_grad(b, xbar, x=ts.solve(b))
        assert _rel(v2, vref) <= F64_REL
    else:
        assert _rel(ts.quadform_grad(b), js.quadform_grad(b)) <= F64_REL


def test_logdet_grad_is_a_finite_difference_of_logdet():
    """d logdet / dv_k against central differences of the port's own f64
    logdet on a few entries (diagonal and off-diagonal)."""
    _, ts, _ = _pair((8, 8), 3)
    g = ts.logdet_grad()
    vals = ts.vals.copy()
    for k in (0, 1, 7, len(vals) - 1):
        h = 1e-6 * max(abs(vals[k]), 1.0)
        lds = []
        for sgn in (1, -1):
            v = vals.copy()
            v[k] += sgn * h
            ts.update_values(v)
            lds.append(ts.logdet())
        assert abs((lds[0] - lds[1]) / (2 * h) - g[k]) <= 1e-6 * abs(g[k])
    ts.update_values(vals)


@pytest.mark.parametrize("k", [None, 1, 4])
def test_sample_and_whiten_match_jax(k):
    """sample (x = P^T L^-T z) and whiten (z = L^T P x) on [n], [n, 1] and
    [n, k], f64, against the JAX package; whiten(sample(z)) == z."""
    js, ts, _ = _pair()
    n = ts.plan.n
    z = np.random.default_rng(2).standard_normal((n,) if k is None
                                                 else (n, k))
    x = ts.sample(z)
    assert x.shape == z.shape and x.dtype == np.float64
    assert _rel(x, js.sample(z)) <= F64_REL
    w = ts.whiten(z)
    assert w.shape == z.shape and _rel(w, js.whiten(z)) <= F64_REL
    assert _rel(ts.whiten(x), z) <= F64_REL
    assert _rel(ts.sample(ts.whiten(z)), z) <= F64_REL


def test_sample_covariance_is_the_inverse():
    """x = sample(z) is linear in z with covariance A^-1: sample applied to
    the identity gives S with S S^T = A^-1 (f64)."""
    _, ts, _ = _pair((6, 6), 3)
    n = ts.plan.n
    S = ts.sample(np.eye(n))
    a = ts.permuted_dense()
    a = a + np.tril(a, -1).T
    p = ts.plan.perm
    ainv = np.empty_like(a)
    ainv[np.ix_(p, p)] = np.linalg.inv(a)
    assert _rel(S @ S.T, ainv) <= F64_REL


@pytest.mark.parametrize("regime", ["bf16 store", "offloaded"])
def test_sampler_on_low_precision_factors(regime):
    """A factor stored bf16, or moved to host memory level by level: the
    port's transforms against the JAX package's on the same factor values;
    the round trip holds to the transforms' f32 rounding."""
    n, r, c, v, o, cl, _ = generate_problem((8, 8, 8), 4)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 device="cpu")
    force = ({"store_dtype": torch.bfloat16, "lazy": True}
             if regime == "bf16 store" else
             {"offload": True, "reupload": False, "lazy": True,
              "store_dtype": torch.float32})
    ts._plan_override = regimes.plan_regimes(ts.fplan, np.float32, BIG,
                                             **force)
    ts.factorize()
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    jf = tuple(jnp.asarray(p.float().numpy()).astype(
        jnp.bfloat16 if p.dtype == torch.bfloat16 else jnp.float32)
        for p in ts.panels)
    z = np.random.default_rng(3).standard_normal((n, 3))
    perm = ts.plan.perm
    zp = z[perm].astype(np.float32)
    for got, jfn in ((ts.sample(z), jfrontal.upper_solve),
                     (ts.whiten(z), jfrontal.upper_matvec)):
        ref = np.empty((n, 3))
        ref[perm] = np.asarray(jfn(js.fplan, jf, zp), dtype=np.float64)
        assert _rel(got, ref) <= F32_REL
    assert _rel(ts.whiten(ts.sample(z)), z) <= F32_REL


def test_sample_input_checks():
    _, ts, _ = _pair((6, 6), 3)
    with pytest.raises(ValueError, match="z must be"):
        ts.sample(np.ones(ts.plan.n + 1))
    with pytest.raises(ValueError, match="x must be"):
        ts.whiten(np.ones((2, ts.plan.n)))

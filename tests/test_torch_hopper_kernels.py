"""The port's Cholesky/inverse kernel and slab factorization
(cholesky_tpu_torch/numeric/hopper_kernels.py) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel in interpret mode (N = 16, 32; the 128-step
unrolled kernel takes minutes to interpret at N = 128) and against an f64
`lax.linalg.cholesky` at N = 128. So is `chol_inv_blocked_ref`, the CUDA
kernel's blocked schedule written out in PyTorch (panel widths 4, 8 and
32). `factor_slab_ref` is held against the JAX package's
`factor_slab_lanes` with its Pallas kernel replaced by a plain reference
(interpreting it at N = 128 takes about ten minutes a two-panel slab on a
CPU) and
against the JAX blocked route. The CUDA kernels themselves are held
against the plain versions on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.numeric import pallas_kernels as pk
import cholesky_tpu_torch
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.utils.laplacian import generate_problem

# f32 Cholesky/inverse of well-conditioned (kappa < 10) blocks: a few ulps
# of accumulated rounding, relative to the largest entry
F32_REL = 1e-5
F64_REL = 1e-12


def _spd_blocks(rng, B, N, dtype=np.float32):
    g = rng.standard_normal((B, N, N))
    return (g @ g.transpose(0, 2, 1) / N + np.eye(N)).astype(dtype)


def _rel(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("N", [16, 32])
def test_chol_inv_ref_matches_pallas_interpret(N):
    d = _spd_blocks(np.random.default_rng(N), 8, N)
    l_j, m_j = pk.chol_inv_lanes(jnp.asarray(d), interpret=True)
    l_t, m_t = hk.chol_inv_ref(torch.from_numpy(d))
    assert _rel(l_t, np.tril(np.asarray(l_j))) <= F32_REL
    assert _rel(m_t, np.tril(np.asarray(m_j))) <= F32_REL
    assert np.all(np.triu(l_t.numpy(), 1) == 0)
    assert np.all(np.triu(m_t.numpy(), 1) == 0)


def test_chol_inv_ref_matches_f64_lax_at_128():
    d = _spd_blocks(np.random.default_rng(128), 4, 128)
    l64 = lax.linalg.cholesky(jnp.asarray(d, jnp.float64),
                              symmetrize_input=False)
    eye = jnp.broadcast_to(jnp.eye(128, dtype=jnp.float64), l64.shape)
    m64 = lax.linalg.triangular_solve(l64, eye, left_side=True, lower=True)
    l_t, m_t = hk.chol_inv(torch.from_numpy(d))      # CPU -> plain version
    assert l_t.dtype == torch.float32
    assert _rel(l_t, l64) <= F32_REL
    assert _rel(m_t, m64) <= F32_REL


def _f64_lax(d):
    l64 = lax.linalg.cholesky(jnp.asarray(d, jnp.float64),
                              symmetrize_input=False)
    eye = jnp.broadcast_to(jnp.eye(d.shape[-1], dtype=jnp.float64), l64.shape)
    return l64, lax.linalg.triangular_solve(l64, eye, left_side=True,
                                            lower=True)


@pytest.mark.parametrize("N,panel", [(16, 4), (32, 8)])
def test_chol_inv_blocked_ref_matches_pallas_interpret(N, panel):
    d = _spd_blocks(np.random.default_rng(N + 1), 8, N)
    l_j, m_j = pk.chol_inv_lanes(jnp.asarray(d), interpret=True)
    l_t, m_t = hk.chol_inv_blocked_ref(torch.from_numpy(d), panel)
    assert l_t.dtype == torch.float32
    assert _rel(l_t, np.tril(np.asarray(l_j))) <= F32_REL
    assert _rel(m_t, np.tril(np.asarray(m_j))) <= F32_REL
    assert np.all(np.triu(l_t.numpy(), 1) == 0)
    assert np.all(np.triu(m_t.numpy(), 1) == 0)


@pytest.mark.parametrize("panel", [32, 16])
def test_chol_inv_blocked_ref_matches_f64_lax_at_128(panel):
    """The kernel's panel width (32), and one more level of halving (16)."""
    d = _spd_blocks(np.random.default_rng(129), 4, 128)
    l64, m64 = _f64_lax(d)
    l_t, m_t = hk.chol_inv_blocked_ref(torch.from_numpy(d), panel)
    assert _rel(l_t, l64) <= F32_REL
    assert _rel(m_t, m64) <= F32_REL


def test_chol_inv_blocked_ref_reads_only_the_lower_triangle():
    d = _spd_blocks(np.random.default_rng(5), 3, 64)
    junk = d + np.triu(np.full_like(d, 1e30), 1)
    l1, m1 = hk.chol_inv_blocked_ref(torch.from_numpy(d), 16)
    l2, m2 = hk.chol_inv_blocked_ref(torch.from_numpy(junk), 16)
    assert torch.equal(l1, l2) and torch.equal(m1, m2)
    with pytest.raises(ValueError):
        hk.chol_inv_blocked_ref(torch.from_numpy(d[:, :48, :48]), 16)


def test_chol_inv_on_cpu_is_plain_and_uncounted():
    d = torch.from_numpy(_spd_blocks(np.random.default_rng(1), 3, 128))
    before = dict(hk.LAUNCHES)
    l1, m1 = hk.chol_inv(d)
    l2, m2 = hk.chol_inv_ref(d)
    assert torch.equal(l1, l2) and torch.equal(m1, m2)
    assert hk.LAUNCHES == before


def _slab(rng, B, F, W, dtype):
    a = 0.01 * rng.standard_normal((B, F, W))
    a[:, :W, :] += 2.0 * np.eye(W)
    return a.astype(dtype)


@pytest.mark.parametrize("W", [100, 128, 200, 300])
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_REL),
                                       (np.float32, F32_REL)])
def test_factor_slab_matches_jax_blocked(W, dtype, tol):
    """The plain composite vs the JAX package's non-kernel route (blocked
    Cholesky + boundary TRSM). W = 200 is two panels, the second a 72-wide
    identity-padded tail; W = 100 is a tail only."""
    a = _slab(np.random.default_rng(W), 4, 300, W, dtype)
    aj = jnp.asarray(a)
    ld = jfrontal._blocked_cholesky(aj[:, :W, :])
    x = jfrontal._tri_solve(ld, aj[:, W:, :], left_side=False, lower=True,
                            transpose_a=True)
    ref = np.concatenate([np.asarray(ld), np.asarray(x)], axis=1)
    out = hk.factor_slab(torch.from_numpy(a), W)
    assert out.dtype == torch.from_numpy(a).dtype
    assert _rel(out, ref) <= tol
    assert np.all(np.triu(out[:, :W, :].numpy(), 1) == 0)


def _lax_chol_inv(d, interpret=False):
    """A plain reference of `chol_inv_lanes`: (L, inv(L)) by lax."""
    L = lax.linalg.cholesky(d, symmetrize_input=False)
    eye = jnp.broadcast_to(jnp.eye(d.shape[-1], dtype=d.dtype), d.shape)
    return L, lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)


def test_factor_slab_ref_matches_factor_slab_lanes(monkeypatch):
    """The plain version against the JAX package's left-looking schedule
    (its products, concatenations and identity-padded tail) on a
    two-panel slab with a 72-wide tail, the Pallas kernel through a plain
    reference."""
    monkeypatch.setattr(pk, "chol_inv_lanes", _lax_chol_inv)
    a = _slab(np.random.default_rng(12), 2, 300, 200, np.float32)
    ref = np.asarray(pk.factor_slab_lanes(jnp.asarray(a), 200))
    out = hk.factor_slab_ref(torch.from_numpy(a), 200)
    assert _rel(out, ref) <= F32_REL
    assert np.all(np.triu(out[:, :200, :].numpy(), 1) == 0)


@pytest.mark.parametrize("W", [136, 200])
def test_factor_slab_reads_a_strided_view(W):
    """factor_slab on the square path's view full[:, :F, :W] of a
    [B, F + 1, F] front against the JAX blocked route on the same
    values."""
    F = 320
    a = _slab(np.random.default_rng(W + 1), 3, F, W, np.float32)
    full = torch.zeros(3, F + 1, F)
    full[:, :F, :W] = torch.from_numpy(a)
    view = full[:, :F, :W]
    assert not view.is_contiguous()
    aj = jnp.asarray(a)
    ld = jfrontal._blocked_cholesky(aj[:, :W, :])
    x = jfrontal._tri_solve(ld, aj[:, W:, :], left_side=False, lower=True,
                            transpose_a=True)
    ref = np.concatenate([np.asarray(ld), np.asarray(x)], axis=1)
    assert _rel(hk.factor_slab(view, W), ref) <= F32_REL


def test_form_front_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(6)
    piv = torch.from_numpy(rng.standard_normal((2, 24, 8)))
    U = torch.from_numpy(rng.standard_normal((4, 16, 16)))
    inv = torch.from_numpy(rng.integers(0, 17, (4, 24)))
    before = dict(hk.LAUNCHES)
    assert torch.equal(hk.form_front(piv, U, inv, 24, 8),
                       hk.form_front_ref(piv, U, inv, 24, 8))
    assert hk.LAUNCHES == before
    with pytest.raises(ValueError):
        hk.form_front(torch.empty(2, 24, 8, device="meta"), None, None, 24, 8)


def test_factorization_on_cpu_counts_no_launch():
    """A factorization on the CPU takes every plain version: no kernel's
    count moves."""
    n, r, c, v, o, cl, b = generate_problem((8, 8, 8), 3)
    s = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu")
    before = dict(hk.LAUNCHES)
    s.factorize()
    assert hk.LAUNCHES == before
    assert s.residual(b, s.solve(b)) <= 1e-10


def test_factor_slab_on_cpu_is_plain_and_uncounted():
    a = torch.from_numpy(_slab(np.random.default_rng(4), 2, 300, 200,
                               np.float32))
    before = dict(hk.LAUNCHES)
    assert torch.equal(hk.factor_slab(a, 200), hk.factor_slab_ref(a, 200))
    assert hk.LAUNCHES == before
    with pytest.raises(ValueError):
        hk.factor_slab(torch.empty(2, 300, 200, device="meta"), 200)


def test_factor_slab_flops_cover_the_bound():
    """The kernels' executed flops are at least the bound's: the padding
    of tail panels, row tiles and the diagonal tile only adds."""
    for B, F, W in [(128, 1440, 864), (1024, 1264, 136), (64, 1008, 144),
                    (1, 2504, 2504), (512, 256, 128)]:
        bound = B * (W ** 3 / 3 + (F - W) * W * W)
        assert bound <= hk.factor_slab_flops(B, F, W) <= 3 * bound


def test_tf32_flag_follows_the_precision_ladder():
    """The kernels' rung is the flag `precision_ctx` sets."""
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    for rung, want in (("highest", False), ("float32", False),
                       ("default", True), ("tensorfloat32", True),
                       (None, True)):
        with precision_ctx(rung):
            assert hk._tf32() is want


@pytest.mark.parametrize("B,W,routed", [
    (128, 864, True), (64, 384, True), (32, 512, True), (256, 256, True),
    (512, 128, True), (64, 144, True), (32, 144, True),
    (16, 640, False), (8, 768, False), (4, 1024, False), (2, 1280, False),
    (1, 2504, False), (16, 304, False), (128, 120, False)])
def test_slab_kernel_eligible_rule(B, W, routed):
    """The JAX crossover B >= max(32, W/16) with W >= 128, in f32 only; the
    50^3 L8 levels 5-7 route, levels 0-4 do not."""
    assert hk.slab_kernel_eligible(B, W, torch.float32) is routed
    assert not hk.slab_kernel_eligible(B, W, torch.float64)

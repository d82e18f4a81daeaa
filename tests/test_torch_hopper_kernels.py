"""The port's Cholesky/inverse kernel and slab composite
(cholesky_tpu_torch/numeric/hopper_kernels.py) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel in interpret mode (N = 16, 32; the 128-step
unrolled kernel takes minutes to interpret at N = 128) and against an f64
`lax.linalg.cholesky` at N = 128. So is `chol_inv_blocked_ref`, the CUDA
kernel's blocked schedule written out in PyTorch (panel widths 4, 8 and
32). The CUDA kernel itself is held against the plain version on the card
in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.numeric import pallas_kernels as pk
from cholesky_tpu_torch.numeric import hopper_kernels as hk

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

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


def _schur_case(seed, B=5, K=300, W=40):
    """X [B, K, W] (a view of [B, W + K, W]), a strided symmetric E
    [B, K, K] (a view of [B, W + K + 1, W + K]), and ragged extents: front
    0 whole, one front with m_b = 0, the others m_b, p_b at random; K is
    no multiple of 128."""
    rng = np.random.default_rng(seed)
    F = W + K
    X = torch.from_numpy(rng.standard_normal((B, F, W)))[:, W:, :]
    E = torch.from_numpy(rng.standard_normal((B, F + 1, F)))[:, W:F, W:]
    E.copy_(E + E.transpose(1, 2))
    ext = torch.from_numpy(np.stack([rng.integers(1, K + 1, B),
                                     rng.integers(0, W + 1, B)], 1))
    ext[0] = torch.tensor([K, W])
    ext[1, 0] = 0
    return X, E, ext


@pytest.mark.parametrize("mode", ["minus", "plus", "none", "in_place"])
def test_schur_syrk_ref_equals_the_product_within_each_extent(mode):
    """U = X X^T - E (sign -1), X X^T + E (+1), X X^T (no E) and X X^T + E
    written into E itself, on each front's own m_b rows and p_b columns
    only: f64 to 1e-12 of the product of the extents' blocks; outside the
    extents nothing is written (a NaN-filled out stays NaN there, an
    in-place E keeps its entries)."""
    X, E, ext = _schur_case(7)
    B, K, W = X.shape
    sign = -1.0 if mode == "minus" else 1.0
    E0 = E.clone()
    if mode == "in_place":
        out = hk.schur_syrk_ref(X, E, sign, ext, out=E)
        assert out.data_ptr() == E.data_ptr()
    else:
        out = torch.full((B, K, K), float("nan"), dtype=X.dtype)
        res = hk.schur_syrk_ref(X, None if mode == "none" else E, sign, ext,
                                out=out)
        assert res is out
        assert torch.equal(E, E0)
    for b, (m, p) in enumerate(ext.tolist()):
        x = X[b, :m, :p]
        want = x @ x.T + (0 if mode == "none" else sign * E0[b, :m, :m])
        np.testing.assert_allclose(out[b, :m, :m].numpy(), want.numpy(),
                                   rtol=0, atol=1e-12)
        pad = torch.ones(K, K, dtype=torch.bool)
        pad[:m, :m] = False
        kept = E0[b][pad] if mode == "in_place" else torch.full(
            (int(pad.sum()),), float("nan"), dtype=X.dtype)
        assert torch.equal(out[b][pad].isnan(), kept.isnan())
        assert torch.equal(out[b][pad].nan_to_num(), kept.nan_to_num())


def test_schur_syrk_ref_without_extents_is_the_whole_product():
    X, E, _ = _schur_case(8, B=3, K=70, W=20)
    out = hk.schur_syrk_ref(X, E)
    np.testing.assert_allclose(
        out.numpy(), (X @ X.transpose(1, 2) - E).numpy(), rtol=0, atol=1e-12)


def test_schur_syrk_on_cpu_is_plain_and_uncounted():
    """On the CPU one batched product of X zeroed outside the extents (X is
    random there, so the zeroing shows) equals the plain version inside
    every extent, for X X^T - E, X X^T and X X^T + E into E itself; no
    launch is counted."""
    X, E, ext = _schur_case(9)
    X, E = X.float(), E.float()
    before = dict(hk.LAUNCHES)
    for e, sign, inplace in ((E, -1.0, False), (None, 1.0, False),
                             (E, 1.0, True)):
        want = hk.schur_syrk_ref(X, e, sign, ext)
        if inplace:
            own = e.clone()
            got = hk.schur_syrk(X, own, sign, ext, out=own)
            assert got is own
        else:
            got = hk.schur_syrk(X, e, sign, ext)
        for b, (m, _) in enumerate(ext.tolist()):
            np.testing.assert_allclose(got[b, :m, :m].numpy(),
                                       want[b, :m, :m].numpy(),
                                       rtol=1e-5, atol=1e-4)
    assert hk.LAUNCHES == before
    with pytest.raises(ValueError):
        hk.schur_syrk(torch.empty(2, 30, 8, device="meta"))


def test_schur_syrk_flops_count_the_lower_tiles():
    """Per front, T (T + 1) / 2 tiles of 128 x 128 for m rows, each
    contracted over p rounded up to 32; m = 0 computes nothing."""
    tile = 2 * 128 * 128
    assert hk.schur_syrk_flops([128, 129, 0, 300], [32, 33, 10, 1]).tolist() \
        == [tile * 32, 3 * tile * 64, 0, 6 * tile * 32]
    # never below the symmetric work m^2 p, never above the padded full
    # product once m fills its tiles
    m, p = np.array([1024, 2048, 640]), np.array([96, 600, 64])
    assert (m * m * p).sum() <= hk.schur_syrk_flops(m, p).sum()
    assert hk.schur_syrk_flops(m, p).sum() <= 2 * 3 * 2048 ** 2 * 608

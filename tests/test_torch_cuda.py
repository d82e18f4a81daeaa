"""The port on the card: the hand-written CUDA kernel against its plain
PyTorch version, and the slice with every wide level forced through it.

Every test is marked `cuda` and skips when torch.cuda.is_available() is
False. This file imports neither jax nor tests.conftest, so it also runs
where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.utils.laplacian import generate_problem

L_REL = 1e-4        # kernel vs plain, L, f32 (rsqrt vs cuSOLVER rounding)
INV_REL = 1e-3      # kernel vs plain, inv(L), f32
F64_REL = 2e-6      # kernel vs an f64 reference, f32 (a few ulps)
TOL = 1e-10         # the solver's relative-residual contract


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def _rel(x, ref):
    x, ref = x.double().cpu(), ref.double().cpu()
    return float((x - ref).abs().max() / ref.abs().max())


def _spd_blocks(rng, B, N):
    g = rng.standard_normal((B, N, N))
    return (g @ g.transpose(0, 2, 1) / N + np.eye(N)).astype(np.float32)


def _blocks(B, seed=2):
    """B random SPD blocks; the last is identity beyond row 72 (the
    identity-padded tail panel that factor_slab builds)."""
    d = _spd_blocks(np.random.default_rng(seed), B, 128)
    d[-1, 72:, :] = 0.0
    d[-1, :, 72:] = 0.0
    d[-1, 72:, 72:] = np.eye(56)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32, 64, 128, 300])
def test_chol_inv_kernel_matches_plain(B):
    _require_cuda()
    dc = torch.from_numpy(_blocks(B)).cuda()
    before = hk.LAUNCHES["chol_inv"]
    l_k, m_k = hk.chol_inv(dc)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["chol_inv"] == before + 1
    l_p, m_p = hk.chol_inv_ref(dc)
    assert _rel(l_k, l_p) <= L_REL
    assert _rel(m_k, m_p) <= INV_REL
    l_64, m_64 = hk.chol_inv_ref(dc.double())
    assert _rel(l_k, l_64) <= F64_REL
    assert _rel(m_k, m_64) <= F64_REL


@pytest.mark.cuda
def test_chol_inv_kernel_exact_zeros_above_diagonal():
    _require_cuda()
    l_k, m_k = hk.chol_inv(torch.from_numpy(_blocks(64)).cuda())
    assert torch.all(torch.triu(l_k, 1) == 0)
    assert torch.all(torch.triu(m_k, 1) == 0)


@pytest.mark.cuda
def test_chol_inv_kernel_reads_only_the_lower_triangle():
    """Garbage above the diagonal (huge values, NaN) leaves L and inv(L)
    bit for bit unchanged."""
    _require_cuda()
    d = _blocks(33)
    junk = d + np.triu(np.full_like(d, 1e30), 1)
    junk[:, 0, 1:] = np.nan
    l1, m1 = hk.chol_inv(torch.from_numpy(d).cuda())
    l2, m2 = hk.chol_inv(torch.from_numpy(junk).cuda())
    assert torch.equal(l1, l2) and torch.equal(m1, m2)


@pytest.mark.cuda
def test_chol_inv_kernel_rejects_bad_input():
    _require_cuda()
    d = torch.eye(128, device="cuda").repeat(2, 1, 1)
    with pytest.raises(ValueError):
        hk.chol_inv(d.double())
    with pytest.raises(ValueError):
        hk.chol_inv(d[:, :64, :64])
    with pytest.raises(ValueError):
        hk.chol_inv(d.transpose(1, 2))
    l, m = hk.chol_inv(d[:0])
    assert l.shape == (0, 128, 128) and m.shape == (0, 128, 128)


@pytest.mark.cuda
def test_factor_slab_kernel_matches_plain():
    _require_cuda()
    rng = np.random.default_rng(3)
    a = 0.01 * rng.standard_normal((32, 400, 200))
    a[:, :200, :] += 2.0 * np.eye(200)
    a = torch.from_numpy(a.astype(np.float32)).cuda()
    f_k = hk.factor_slab(a, 200)
    f_p = hk.factor_slab(a, 200, block_fn=hk.chol_inv_ref)
    assert _rel(f_k, f_p) <= L_REL


@pytest.mark.cuda
def test_slice_on_card_matches_cpu():
    """15^3 with every W >= 128 level forced through the CUDA kernel: the
    card's solution agrees with the CPU's and meets the contract."""
    _require_cuda()
    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    xs = []
    rule = (hk.MIN_B, hk.W_PER_B)
    hk.MIN_B, hk.W_PER_B = 1, 1 << 20
    try:
        for device in ("cuda", "cpu"):
            s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                        device=device)
            before = hk.LAUNCHES["chol_inv"]
            xs.append(s.solve(b))
            assert s.residual(b, xs[-1]) <= TOL
            assert (hk.LAUNCHES["chol_inv"] > before) == (device == "cuda")
    finally:
        hk.MIN_B, hk.W_PER_B = rule
    assert np.linalg.norm(xs[0] - xs[1]) <= 1e-8 * np.linalg.norm(xs[1])

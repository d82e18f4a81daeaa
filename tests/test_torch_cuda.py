"""The port on the card: the hand-written CUDA kernel against its plain
PyTorch version, the slice with every wide level forced through it, and
the matmul-precision ladder's flag (TF32 or IEEE cuBLAS products).

Every test is marked `cuda` and skips when torch.cuda.is_available() is
False. This file imports neither jax nor tests.conftest, so it also runs
where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import functools
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.io import mmio
from cholesky_tpu_torch.numeric import devmem, refine, regimes
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.utils.laplacian import generate_problem

L_REL = 1e-4        # kernel vs plain, L, f32 (rsqrt vs cuSOLVER rounding)
INV_REL = 1e-3      # kernel vs plain, inv(L), f32
F64_REL = 2e-6      # kernel vs an f64 reference, f32 (a few ulps)
# factor_slab kernels vs plain and vs the known factor, each part of the
# result relative to its own largest entry (`slab_err`), IEEE f32
SLAB_REL = 1e-4
# ... at TF32: both round their products to TF32 (10 significand bits),
# in different orders
SLAB_TF32_REL = 5e-3
TOL = 1e-10         # the solver's relative-residual contract


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def _rel(x, ref):
    x, ref = x.double().cpu(), ref.double().cpu()
    return float((x - ref).abs().max() / ref.abs().max())


@functools.lru_cache(maxsize=None)
def _bench_tool():
    """tools/torch/bench_front_kernels.py's globals (`known_slab`,
    `slab_err`, `main`), its main not run, sys.path restored."""
    syspath = list(sys.path)
    try:
        return runpy.run_path(os.path.join(
            os.path.dirname(__file__), "..", "tools", "torch",
            "bench_front_kernels.py"), run_name="tool")
    finally:
        sys.path[:] = syspath


def _slab_err(x, ref, W):
    return _bench_tool()["slab_err"](x, ref, W)


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
    a, exact = _slab_on_card(32, 400, 200, seed=3)
    before = hk.LAUNCHES["factor_slab"]
    f_k = hk.factor_slab(a, 200)
    assert hk.LAUNCHES["factor_slab"] == before + 1
    f_p = hk.factor_slab_ref(a, 200)
    assert _slab_err(f_k, f_p, 200) <= SLAB_REL
    assert _slab_err(f_k, exact, 200) <= SLAB_REL


def _slab_on_card(B, F, W, seed, view=False):
    """A [B, F, W] f32 slab on the card with a known partial factor
    (`known_slab`), and that factor; with `view`, the slab as the square
    path's strided view full[:, :F, :W] of a [B, F + 1, F + 4] front (row
    stride F + 4)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, exact = _bench_tool()["known_slab"](B, F, W, gen, "cuda")
    if not view:
        return a, exact
    full = torch.zeros(B, F + 1, F + 4, device="cuda")
    full[:, :F, :W] = a
    return full[:, :F, :W], exact


@pytest.mark.cuda
@pytest.mark.parametrize("rung,tol", [("highest", SLAB_REL),
                                      ("tensorfloat32", SLAB_TF32_REL)])
@pytest.mark.parametrize("B", [1, 3, 11, 20, 128])
@pytest.mark.parametrize("F,W", [(300, 100), (400, 200), (1440, 864),
                                 (512, 512)])
def test_factor_slab_kernel_at_each_rung(F, W, B, rung, tol):
    """The kernels against the plain version on the same slab and against
    the slab's known factor: a tail panel only (W = 100), a two-panel slab
    with a 72-wide tail, the 50^3 leaf width, and a root-like slab (F = W);
    exact zeros above the diagonal, the same bits on a repeated call. On a
    132-SM H100, B = 11 and 20 split each diagonal tile's K over clusters
    of 6 and 3 CTAs (unevenly), B = 3 over 8, B = 1 over up to 8, B = 128
    not at all."""
    _require_cuda()
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    a, exact = _slab_on_card(B, F, W, seed=F + W + B)
    with precision_ctx(rung):
        f_k = hk.factor_slab(a, W)
        again = hk.factor_slab(a, W)
        f_p = hk.factor_slab_ref(a, W)
    torch.cuda.synchronize()
    assert _slab_err(f_k, f_p, W) <= tol
    assert _slab_err(f_k, exact, W) <= tol
    assert torch.all(torch.triu(f_k[:, :W], 1) == 0)
    assert torch.equal(f_k, again)


@pytest.mark.cuda
@pytest.mark.parametrize("rung,tol", [("highest", SLAB_REL),
                                      ("tensorfloat32", SLAB_TF32_REL)])
def test_factor_slab_kernel_reads_a_strided_view(rung, tol):
    _require_cuda()
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    view, exact = _slab_on_card(32, 700, 296, seed=9, view=True)
    assert not view.is_contiguous()
    with precision_ctx(rung):
        f_k = hk.factor_slab(view, 296)
        f_p = hk.factor_slab_ref(view.contiguous(), 296)
    assert _slab_err(f_k, f_p, 296) <= tol
    assert _slab_err(f_k, exact, 296) <= tol


@pytest.mark.cuda
def test_factor_slab_kernel_rejects_bad_input():
    _require_cuda()
    a, _ = _slab_on_card(2, 300, 200, seed=1)
    with pytest.raises(ValueError):
        hk.factor_slab(a.double(), 200)
    full = torch.zeros(2, 300, 301, device="cuda")       # row stride 301
    with pytest.raises(ValueError):
        hk.factor_slab(full[:, :, :200], 200)
    with pytest.raises(ValueError):
        hk.factor_slab(a.transpose(1, 2), 200)


# (B, F, W, K, mapped rows of a child) of the narrowest and the widest
# level with children of each configuration's plan (`cholbench/configs`),
# cut in B where the memory needs it; K is the children's update width
FRONT_SHAPES = {
    "lapl7_50 L10": (1024, 168, 24, 96, 52),
    "lapl7_50 L1": (2, 3760, 1256, 2504, 2450),
    "elast_q1_64 L13": (8192, 312, 24, 208, 123),
    "elast_q1_64 L1": (2, 18624, 6144, 12480, 12480),
}


def _front_inputs(shape, fdt, udt, seed):
    """Seeded pivot slabs, child updates and maps on the card: each child's
    `mapped` rows land on sorted random rows of the parent."""
    B, F, W, K, m = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    piv = torch.randn(B, F, W, generator=gen, device="cuda").to(fdt)
    U = torch.randn(2 * B, K, K, generator=gen, device="cuda").to(udt)
    pos = torch.rand(2 * B, F, generator=gen, device="cuda").argsort(1)
    pos = pos[:, :m].sort(1).values
    inv = torch.full((2 * B, F), K, dtype=torch.int64, device="cuda")
    inv.scatter_(1, pos, torch.arange(m, device="cuda").expand(2 * B, m)
                 .contiguous())
    return piv, U, inv


@pytest.mark.cuda
@pytest.mark.parametrize("fdt,udt", [(torch.float32, torch.float32),
                                     (torch.float64, torch.float64),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", sorted(FRONT_SHAPES))
def test_form_front_kernel_bitwise_equals_plain(shape, fdt, udt):
    _require_cuda()
    B, F, W, K, _ = FRONT_SHAPES[shape]
    piv, U, inv = _front_inputs(FRONT_SHAPES[shape], fdt, udt, seed=11)
    before = hk.LAUNCHES["form_front"]
    k = hk.form_front(piv, U, inv, F, W)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["form_front"] == before + 1
    assert k.shape == (B, F + 1, F) and k.dtype == fdt
    assert torch.equal(k, hk.form_front_ref(piv, U, inv, F, W))
    assert not k[:, F].any()


@pytest.mark.cuda
def test_form_front_kernel_reads_views_and_empty_updates():
    """Strided slabs and updates (the kernel reads their strides), no
    update (None or K = 0: the padded slab), and an empty batch."""
    _require_cuda()
    piv, U, inv = _front_inputs((6, 200, 64, 150, 140), torch.float32,
                                torch.float32, seed=12)
    pv = torch.zeros(6, 201, 204, device="cuda")
    pv[:, :200, :64] = piv
    uv = torch.zeros(12, 150, 153, device="cuda")
    uv[:, :, :150] = U
    k = hk.form_front(pv[:, :200, :64], uv[:, :, :150], inv, 200, 64)
    assert torch.equal(k, hk.form_front_ref(piv, U, inv, 200, 64))
    for none in (None, U[:, :0, :0]):
        k = hk.form_front(piv, none, None, 200, 64)
        assert torch.equal(k, hk.form_front_ref(piv, None, None, 200, 64))
    assert hk.form_front(piv[:0], U[:0], inv[:0], 200, 64).shape == (
        0, 201, 200)


@pytest.mark.cuda
def test_form_front_kernel_is_deterministic():
    _require_cuda()
    shape = FRONT_SHAPES["lapl7_50 L1"]
    piv, U, inv = _front_inputs(shape, torch.float32, torch.float32, seed=13)
    a = hk.form_front(piv, U, inv, shape[1], shape[2])
    b = hk.form_front(piv, U, inv, shape[1], shape[2])
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_form_front_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor launches the kernel or raises: the plain version is
    never called, and inputs the kernel does not take raise."""
    _require_cuda()
    piv, U, inv = _front_inputs((4, 100, 20, 60, 50), torch.float32,
                                torch.float32, seed=14)

    def plain(*a):
        raise AssertionError("form_front_ref called on a CUDA tensor")

    monkeypatch.setattr(hk, "form_front_ref", plain)
    hk.form_front(piv, U, inv, 100, 20)
    with pytest.raises(ValueError):
        hk.form_front(piv.half(), U, inv, 100, 20)
    with pytest.raises(ValueError):
        hk.form_front(piv, U.half(), inv, 100, 20)
    with pytest.raises(ValueError):
        hk.form_front(piv, U, inv.int(), 100, 20)
    with pytest.raises(ValueError):
        hk.form_front(piv, U[:4], inv, 100, 20)
    with pytest.raises(ValueError):
        hk.form_front(piv, U, inv.cpu(), 100, 20)


@pytest.mark.cuda
def test_form_front_launches_once_per_square_level():
    """A lapl7_50-shaped factorization (50^3, 12 levels) forms the fronts
    of every square level with children with one launch a level, or a
    chunk where the plan chunks the level, and meets the contract."""
    _require_cuda()
    n, r, c, v, o, cl, b = generate_problem((50, 50, 50), 12)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    plan = s.regimes.levels
    want = sum(plan[lvl].chunks for lvl in range(len(plan) - 1)
               if not plan[lvl].two_piece)
    assert want == 11
    before = hk.LAUNCHES["form_front"]
    s.factorize()
    assert hk.LAUNCHES["form_front"] - before == want
    assert s.residual(b, s.solve(b)) <= TOL


# Every level with a boundary of the benchmark's two configurations: (B, K,
# W, least m_b, least p_b), the padded shape and the least front extents
SCHUR_SHAPES = {
    **{f"lapl7_50 L{lvl}": shape for lvl, *shape in (
        (1, 2, 2504, 1256, 2500, 1200), (2, 4, 2504, 632, 2400, 576),
        (3, 8, 1880, 632, 1728, 576), (4, 16, 1856, 304, 1104, 264),
        (5, 32, 1344, 144, 649, 121), (6, 64, 864, 144, 363, 121),
        (7, 128, 576, 72, 231, 55), (8, 256, 360, 40, 135, 25),
        (9, 512, 216, 40, 75, 25), (10, 1024, 144, 24, 45, 10),
        (11, 2048, 96, 56, 24, 20))},
    **{f"elast_q1_64 L{lvl}": shape for lvl, *shape in (
        (1, 2, 12480, 6144, 12480, 6144), (2, 4, 12480, 3072, 12480, 3072),
        (3, 8, 9512, 3072, 9312, 2976), (4, 16, 9656, 1536, 6048, 1395),
        (5, 32, 7296, 768, 3651, 675), (6, 64, 5008, 768, 2163, 675),
        (7, 128, 3424, 384, 1419, 315), (8, 256, 2224, 192, 867, 147),
        (9, 512, 1360, 192, 507, 147), (10, 1024, 952, 96, 327, 63),
        (11, 2048, 640, 48, 195, 27), (12, 4096, 400, 48, 111, 27),
        (13, 8192, 288, 24, 69, 9), (14, 16384, 208, 48, 39, 9))},
}


def _schur_inputs(shape, seed):
    """Seeded X [B, K, W] and symmetric E [B, K, K] (views of a factor and
    of fronts, as the level loop passes them) and extents [B, 2]: m_b, p_b
    uniform from the least to K and W, front 0 at (K, W); X zero outside
    each extent, as the level loop's is. Also the [B, K] rows inside."""
    B, K, W, m_min, p_min = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    F = W + K
    X = torch.randn(B, F, W, generator=gen, device="cuda")[:, W:, :]
    E = torch.randn(B, F + 1, F, generator=gen, device="cuda")[:, W:F, W:]
    E.copy_((E + E.transpose(1, 2)) / 2)
    m = torch.randint(m_min, K + 1, (B,), generator=gen, device="cuda")
    p = torch.randint(p_min, W + 1, (B,), generator=gen, device="cuda")
    m[0], p[0] = K, W
    rows = torch.arange(K, device="cuda") < m[:, None]
    X.masked_fill_(~(rows[:, :, None] & (torch.arange(W, device="cuda")
                                         < p[:, None])[:, None, :]), 0)
    return X, E, torch.stack([m, p], 1), rows


def _schur_within_bound(k, ref, X, E, ext, rows):
    """Whether |k - ref| inside the extents is within the bound of two f32
    sums of p products in different orders: each lies within gamma_p |X|
    |X|^T of the exact product (gamma_p = p u / (1 - p u), u = 2^-24;
    Higham, Accuracy and Stability of Numerical Algorithms, 3.1), and
    adding E rounds once more. A pass of fronts at a time."""
    B, K, _ = X.shape
    step = max(1, (1 << 28) // (K * K))
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        p = ext[sl, 1].double()[:, None, None]
        ax = X[sl].abs().double()
        bound = 2 * p * 2.0 ** -24 / (1 - p * 2.0 ** -24) * (
            ax @ ax.transpose(1, 2))
        bound += 2.0 ** -23 * (ref[sl].double().abs() + E[sl].double().abs())
        inside = rows[sl, :, None] & rows[sl, None, :]
        over = (k[sl].double() - ref[sl].double()).abs() > bound
        if bool((over & inside).any()):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SCHUR_SHAPES))
def test_schur_syrk_kernel_matches_plain(shape):
    """U = X X^T - E on the card at every level shape of both
    configurations, with ragged extents: inside each front's extent within
    the summation-order bound of `schur_syrk_ref` (f32 products in another
    order); outside it nothing written (a NaN-filled output keeps its NaN
    there); one launch."""
    _require_cuda()
    X, E, ext, rows = _schur_inputs(SCHUR_SHAPES[shape], seed=31)
    B, K, _ = X.shape
    out = torch.full((B, K, K), float("nan"), device="cuda")
    before = hk.LAUNCHES["schur_syrk"]
    k = hk.schur_syrk(X, E, -1.0, ext, out=out)
    torch.cuda.synchronize()
    assert k is out and hk.LAUNCHES["schur_syrk"] == before + 1
    inside = rows[:, :, None] & rows[:, None, :]
    assert torch.equal(k.isnan(), ~inside)
    ref = hk.schur_syrk_ref(X, E, -1.0, ext)
    assert _schur_within_bound(k, ref, X, E, ext, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["lapl7_50 L4", "elast_q1_64 L12"])
def test_schur_syrk_kernel_modes_repeat_and_run_in_place(shape):
    """X X^T + E and X X^T without E within the bound of the plain version;
    every mode bitwise equal to a second launch; X X^T + E written into E
    itself bitwise equal to the same out of place."""
    _require_cuda()
    X, E, ext, rows = _schur_inputs(SCHUR_SHAPES[shape], seed=32)
    inside = rows[:, :, None] & rows[:, None, :]
    for e, sign in ((E, 1.0), (None, 1.0), (E, -1.0)):
        k = hk.schur_syrk(X, e, sign, ext)
        assert torch.equal(k[inside], hk.schur_syrk(X, e, sign, ext)[inside])
        ref = hk.schur_syrk_ref(X, e, sign, ext)
        assert _schur_within_bound(k, ref, X, torch.zeros_like(k) if e is None
                                   else E, ext, rows)
    k = hk.schur_syrk(X, E, 1.0, ext)
    own = E.contiguous()
    assert hk.schur_syrk(X, own, 1.0, ext, out=own) is own
    assert torch.equal(own[inside], k[inside])


@pytest.mark.cuda
def test_schur_syrk_launches_once_per_level_with_a_boundary():
    """A lapl7_50-shaped factorization (50^3, 12 levels) at IEEE products
    forms the Schur update of each of its 11 levels with a boundary (the
    leaves' X X^T at their parent) in one launch, or one a chunk; the
    factor stats count them and the executed share of the padded
    products; the TF32 rung keeps cuBLAS. Both meet the contract."""
    _require_cuda()
    from cholesky_tpu_torch.numeric import frontal

    n, r, c, v, o, cl, b = generate_problem((50, 50, 50), 12)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize(precision="highest")
    plan = s.regimes.levels
    # levels 1-10 each per chunk, and level 10 the leaves' X X^T
    L = len(plan)
    want = sum(plan[lvl].chunks for lvl in range(1, L - 1)) + plan[
        L - 2].chunks
    assert want == 11
    before = hk.LAUNCHES["schur_syrk"]
    s.factorize()
    assert hk.LAUNCHES["schur_syrk"] - before == want
    assert s.factor_stats["schur_syrk_launches"] == want
    fp = s.fplan
    done = full = 0.0
    for lvl in range(1, fp.levels):
        m, p = frontal._extent_host(fp, lvl)
        full += 2.0 * len(m) * (fp.F[lvl] - fp.W[lvl]) ** 2 * fp.W[lvl]
        done += hk.schur_syrk_flops(m, p).sum()
    assert s.factor_stats["schur_tile_share"] == pytest.approx(done / full)
    assert s.residual(b, s.solve(b)) <= TOL
    s.factorize(precision="default")
    assert s.factor_stats["schur_syrk_launches"] == 0
    assert s.factor_stats["schur_tile_share"] == pytest.approx(1.0)
    assert s.residual(b, s.solve(b)) <= TOL


@pytest.mark.cuda
def test_schur_syrk_takes_rows_at_any_alignment():
    """X and E as views whose bases and strides are not 16-byte aligned (a
    level padded to a multiple of 6, say): the kernel's 4-byte copies give
    bitwise the result of its 16-byte copies on aligned copies of the same
    values, in every mode, and write nothing outside the extents."""
    _require_cuda()
    X, E, ext, rows = _schur_inputs((4, 300, 40, 100, 10), seed=34)
    B, K, W = X.shape
    Xu = torch.zeros(B, K + 1, W + 3, device="cuda")[:, 1:, 2:W + 2]
    Eu = torch.zeros(B, K + 1, K + 1, device="cuda")[:, 1:, 1:]
    Xu.copy_(X)
    Eu.copy_(E)
    assert Xu.data_ptr() % 16 and Eu.data_ptr() % 16
    assert Xu.stride(1) % 4 and Eu.stride(1) % 4
    inside = rows[:, :, None] & rows[:, None, :]
    for e, eu, sign in ((E, Eu, -1.0), (E, Eu, 1.0), (None, None, 1.0)):
        want = hk.schur_syrk(X.contiguous(), e if e is None
                             else e.contiguous(), sign, ext)
        out = torch.full((B, K, K), float("nan"), device="cuda")
        got = hk.schur_syrk(Xu, eu, sign, ext, out=out)
        assert torch.equal(got.isnan(), ~inside)
        assert torch.equal(got[inside], want[inside])
    own_u = torch.zeros(B, K + 1, K + 1, device="cuda")[:, 1:, 1:]
    own_u.copy_(E)
    hk.schur_syrk(Xu, own_u, 1.0, ext, out=own_u)
    assert torch.equal(own_u[inside], hk.schur_syrk(X, E, 1.0, ext)[inside])


@pytest.mark.cuda
def test_factor_on_a_plan_padded_to_six_launches_schur_syrk():
    """The frontal plan pads fronts to multiples of 8 whatever `pad_to`
    the solve plan takes; one padded to multiples of 6 gives fronts whose
    rows are not 16-byte aligned. At IEEE products every level with a
    boundary still forms its Schur update in one `schur_syrk` launch (its
    4-byte copies), as on the plan of the default padding, and both
    factors meet the contract."""
    _require_cuda()
    from cholesky_tpu_torch.numeric.frontal_plan import build_frontal_plan

    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    for pad in (8, 6):
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    pad_to=pad, precision="highest")
        s._fplan = build_frontal_plan(s.plan, s.rows, s.cols, pad_to=pad)
        fp = s.fplan
        assert (pad == 8) == all(w % 4 == 0 for w in fp.W + fp.F)
        want = sum(1 for lvl in range(1, fp.levels) if fp.F[lvl] > fp.W[lvl])
        before = hk.LAUNCHES["schur_syrk"]
        s.factorize()
        assert hk.LAUNCHES["schur_syrk"] - before == want > 0
        assert s.factor_stats["schur_syrk_launches"] == want
        assert s.residual(b, s.solve(b)) <= TOL


@pytest.mark.cuda
def test_schur_syrk_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor launches the kernel or raises: the plain version is
    never called, and inputs the kernel does not take raise."""
    _require_cuda()
    X, E, ext, _ = _schur_inputs((4, 300, 40, 100, 10), seed=33)

    def plain(*a, **k):
        raise AssertionError("schur_syrk_ref called on a CUDA tensor")

    monkeypatch.setattr(hk, "schur_syrk_ref", plain)
    hk.schur_syrk(X, E, -1.0, ext)
    hk.schur_syrk(X)
    for bad in (dict(X=X.double()), dict(X=X.transpose(1, 2)[:, :40]),
                dict(E=E.double()), dict(E=E[:3]),
                dict(E=E.transpose(1, 2)),
                dict(ext=ext.int()), dict(ext=ext.cpu()), dict(ext=ext[:3]),
                dict(sign=2.0), dict(out=torch.empty(4, 300, 301,
                                                     device="cuda"))):
        args = {**dict(X=X, E=E, sign=-1.0, ext=ext, out=None), **bad}
        with pytest.raises(ValueError):
            hk.schur_syrk(args["X"], args["E"], args["sign"], args["ext"],
                          args["out"])


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


def _regime_solver(force, budget=1 << 40, dtype=np.float32):
    """A 12^3 L6 solver on the card that factors under the plan `force`
    (keywords of regimes.plan_regimes) gives under `budget`."""
    n, r, c, v, o, cl, b = generate_problem((12, 12, 12), 6)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                device="cuda")
    s._plan_override = regimes.plan_regimes(s.fplan, s.dtype, budget,
                                            **force)
    return s, b


@pytest.mark.cuda
def test_two_piece_factor_matches_square_on_card():
    """Every non-leaf level on the two-piece path against the square path,
    f32 on the card (rounding differs only in summation order)."""
    _require_cuda()
    square, _ = _regime_solver({})
    two, _ = _regime_solver({"two_piece": True})
    fa, fb = square.factorize(), two.factorize()
    assert not any(lp.two_piece for lp in square.regimes.levels)
    assert all(lp.two_piece for lp in two.regimes.levels[:-1])
    for a, b in zip(fa, fb):
        assert a.is_cuda and b.is_cuda
        assert _rel(b, a) <= L_REL


@pytest.mark.cuda
def test_bf16_update_solve_on_card():
    """Two-piece levels with bf16 child updates: the refined solve meets the
    residual contract."""
    _require_cuda()
    s, b = _regime_solver({"two_piece": True,
                           "update_dtype": torch.bfloat16})
    x = s.solve(b)
    assert all(lp.update_dtype == torch.bfloat16
               for lp in s.regimes.levels[1:-1])
    assert s.residual(b, x) <= TOL


@pytest.mark.cuda
def test_offloaded_bf16_factor_solve_on_card():
    """Chunked levels, a bf16 factor moved to host memory level by level
    and not re-uploaded, update pieces spilled: the solve reads the host
    levels (without pivot inverses) and meets the residual contract."""
    _require_cuda()
    s, b = _regime_solver({"store_dtype": torch.bfloat16, "offload": True,
                           "reupload": False, "spill": True,
                           "chunks": {5: 4, 4: 2}}, budget=600 << 20)
    x = s.solve(b)
    assert all(p.device.type == "cpu" for p in s.panels[1:])
    assert s.last_solve["engine"] == "plain"
    assert s.residual(b, x) <= TOL


@pytest.mark.cuda
def test_long_lived_state_lives_in_its_own_pool():
    """The plan's index maps, the assembler's scatter indices (per chunk
    too), the ELL layout (index, source map, values buffer) and its value
    planes come from the pool of long-lived state
    (`devmem`), never from a segment that fronts and factors use; a
    refactorization after solves meets the contract."""
    _require_cuda()
    s, b = _regime_solver({"chunks": {4: 2}, "lazy": True})
    assert s.residual(b, s.solve(b)) <= TOL
    pool = tuple(devmem._POOLS[torch.cuda.current_device()].id)
    segs = [(g["address"], g["address"] + g["total_size"],
             tuple(g["segment_pool_id"]))
            for g in torch.cuda.memory._snapshot()["segments"]]

    def pool_of(t):
        p = t.data_ptr()
        return next(sp for a0, a1, sp in segs if a0 <= p < a1)

    fasm = s._assembler()
    long_lived = [t for t in s.fplan.cache.values() if torch.is_tensor(t)]
    long_lived += [t for planes in s._ell_dev.values() for t in planes]
    long_lived += list(s._ell_vals)
    long_lived += [t for lvl in fasm.idx for t in lvl]
    long_lived += [t for idx in fasm._chunk_idx.values() for t in idx]
    long_lived = [t for t in long_lived if t.numel()]
    assert fasm._chunk_idx and s._ell_dev
    assert all(pool_of(t) == pool for t in long_lived)
    assert all(pool_of(p) != pool for p in s.panels if p.numel())
    s.factorize()
    assert s.residual(b, s.solve(b)) <= TOL


@pytest.mark.cuda
def test_refactorize_after_releasing_cached_memory(monkeypatch):
    """When the planned peak does not fit in the CUDA driver's free
    memory, factorize() returns the allocator's cache to the driver before
    it starts, and keeps the long-lived device state (it lives in its own
    pool); the factorization and the next solve still meet the contract."""
    _require_cuda()
    s, b = _regime_solver({}, budget=8 << 30)
    assert s.residual(b, s.solve(b)) <= TOL
    ell = s._ell_dev[True]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, 80 << 30))
    s.factorize()
    monkeypatch.undo()
    assert s.factor_stats["released_cache"]
    assert s._ell_dev[True] is ell
    x = s.solve(b)
    assert s.residual(b, x) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("banded", [True, False])
def test_ell_planes_refilled_on_card_equal_a_host_build(banded, monkeypatch):
    """The ELL value planes refilled on the card after an update (a gather
    and the f64 split, rounded by the card) are bitwise those the host
    builds from the new values; the index stays the same tensor."""
    _require_cuda()
    s, b = _regime_solver({})
    if not banded:
        monkeypatch.setattr(s, "_want_inv_pivots", lambda: False)
    s.solve(b)
    idx = s._ell_dev[banded][0]
    rng = np.random.default_rng(11)
    pr, pc = s.coo_pattern()
    v0, diag = s.vals.copy(), pr == pc
    for step in range(2):
        new = v0 * rng.uniform(0.5, 1.5, size=len(v0))
        new[diag] = v0[diag] * 3.0 + 1.0 + step   # diagonally dominant
        s.update_values(new)
        x = s.solve(b)
        assert s.last_solve["ell"] == "refill"
        assert s.residual(b, x) <= TOL
        r, c, v = mmio.symmetrize_coo(pr, pc, new)
        want = refine.build_ell(s.plan.n, s.plan.iperm[r], s.plan.iperm[c], v)
        if banded:
            want = refine.pad_ell(s.fplan, want)
        got = s._ell_device(banded)
        assert got[0] is idx and got[1].is_cuda
        assert np.array_equal(got[0].cpu().numpy(), want[0])
        for g, w in zip(got[1:], want[1:]):
            assert np.array_equal(g.cpu().numpy().view(np.uint32),
                                  w.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
def test_block_solve_on_card_matches_cpu(k):
    """[n, k] through the device loop on the card: every column at the
    contract, and within 1e-8 of the same solve on the CPU."""
    _require_cuda()
    n, r, c, v, o, cl, _ = generate_problem((12, 12, 12), 5)
    B = np.random.default_rng(7).standard_normal((n, k))
    B[:, -1] *= 1e6
    xs = {}
    for dev in ("cuda", "cpu"):
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    device=dev)
        xs[dev] = s.solve(B).reshape(n, k)
        assert s.last_solve["loop"] == "device" and s.last_solve["k"] == k
        assert s.residual(B, xs[dev]) <= TOL
    diff = np.linalg.norm(xs["cuda"] - xs["cpu"], axis=0)
    assert np.all(diff <= 1e-8 * np.linalg.norm(xs["cpu"], axis=0))


@pytest.mark.cuda
def test_from_scipy_update_values_and_checkpoint_on_card(tmp_path):
    _require_cuda()
    import scipy.sparse as sp

    from cholesky_tpu_torch.utils import problems

    n, r, c, v = problems.make_gallery(1)["wathen"]()
    a = sp.csr_matrix((v, (r, c)), shape=(n, n))
    s = SparseCholesky.from_scipy(a, dtype=np.float32)
    assert s.device.type == "cuda"
    b = np.random.default_rng(8).standard_normal(n)
    assert s.residual(b, s.solve(b)) <= TOL
    s.update_values(3.0 * s.vals)
    x = s.solve(b)
    assert s.residual(b, x) <= TOL and s.factor_stats["plan_reused"]
    cpu = SparseCholesky.from_scipy(3.0 * a, dtype=np.float64, device="cpu")
    assert abs(s.logdet() - cpu.logdet()) <= 1e-6 * abs(cpu.logdet())
    path = s.save_factor(str(tmp_path / "ck"))
    t = SparseCholesky(s.plan, s.rows, s.cols, s.vals, dtype=np.float32)
    t.load_factor(path)
    assert all(p.device.type == "cuda" for p in t.panels)
    assert np.linalg.norm(t.solve(b) - x) <= 1e-8 * np.linalg.norm(x)


@pytest.mark.cuda
def test_profile_frontal_times_the_kernel_route_on_card():
    _require_cuda()
    from cholesky_tpu_torch.numeric import profile

    n, r, c, v, o, cl, _ = generate_problem((20, 20, 20), 7)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    fp = s.fplan
    lines = []
    before = hk.LAUNCHES["chol_inv"]
    recs = profile.profile_frontal(fp, s.assemble(), iters=2,
                                   emit=lines.append)
    routed = [lvl for lvl in range(fp.levels) if hk.slab_kernel_eligible(
        1 << lvl, fp.W[lvl], torch.float32)]
    assert routed and hk.LAUNCHES["chol_inv"] > before
    assert sorted(x["level"] for x in recs
                  if x["op"] == "FACTOR_SLAB") == routed
    assert len(lines) == len(recs) and all(
        ln.startswith("BLAS: {'op': ") for ln in lines)
    assert all(x["time_us"] >= 0 for x in recs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-4)])
def test_selinv_and_sampler_on_card_match_cpu(dtype, tol):
    """inv_diag, inv_entries, sample and whiten on the card (every W >= 128
    level of an f32 factor through the kernel) against the same calls on
    the CPU."""
    _require_cuda()
    n, r, c, v, o, cl, _ = generate_problem((12, 12, 12), 5)
    z = np.random.default_rng(9).standard_normal((n, 2))
    out = {}
    rule = (hk.MIN_B, hk.W_PER_B)
    hk.MIN_B, hk.W_PER_B = 1, 1 << 20
    try:
        for dev in ("cuda", "cpu"):
            s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                        device=dev)
            x = s.sample(z)
            out[dev] = (s.inv_diag(), s.inv_entries(s.rows, s.cols), x,
                        s.whiten(x))
    finally:
        hk.MIN_B, hk.W_PER_B = rule
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    assert np.abs(out["cuda"][3] - z).max() <= tol * np.abs(z).max()


@pytest.mark.cuda
def test_family_on_card_matches_cpu():
    """factorize_many of 4 systems on the card, with the kernel on every
    level it can take at the folded batch: the family solve meets the
    contract for every system and agrees with the CPU's; logdets too."""
    _require_cuda()
    n, r, c, v, o, cl, b = generate_problem((12, 12, 12), 5)
    out = {}
    rule = (hk.MIN_B, hk.W_PER_B)
    hk.MIN_B, hk.W_PER_B = 4, 1 << 20
    try:
        for dev in ("cuda", "cpu"):
            s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                        device=dev)
            vals = np.stack([s.vals * k for k in (1.0, 1.5, 2.0, 3.0)])
            before = hk.LAUNCHES["chol_inv"]
            bf = s.factorize_many(vals)
            assert (hk.LAUNCHES["chol_inv"] > before) == (dev == "cuda")
            X = bf.solve(b)
            assert np.all(bf.residual(b, X) <= TOL)
            assert bf.last_solve["loop"] == "device"
            out[dev] = (X, bf.logdet())
    finally:
        hk.MIN_B, hk.W_PER_B = rule
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= 1e-8 * np.abs(
        out["cpu"][0]).max()
    assert np.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-6)


@pytest.mark.cuda
def test_solver_device_is_its_tensors_device():
    """device="cuda" resolves to the card's index, so the resident factor
    counts toward the budget checks (a bare "cuda" device compares unequal
    to a tensor's cuda:0)."""
    _require_cuda()
    n, r, c, v, o, cl, _ = generate_problem((10, 10, 10), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    assert all(p.device == s.device for p in s.panels)
    assert s._factor_bytes() == sum(p.numel() * 4 for p in s.panels) > 0
    assert s._promote_bytes() == 0


def _qd_problem(shape, levels, seed=5):
    """A quasi-definite matrix on the grid pattern (a seeded 40% of the
    diagonal signs flipped, |diag| + 0.5) and its signature."""
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    s = np.where(np.random.default_rng(seed).random(n) < 0.4, -1.0, 1.0)
    vq = v.copy()
    d = r == c
    vq[d] = s[r[d]] * (v[d] + 0.5)
    return n, r, c, vq, o, cl, b, s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_qd_factor_and_solve_on_card_match_cpu(dtype):
    """The signed factor on the card against the CPU port's (per level),
    solves of [n] and [n, 3] at the contract, slogdet and inertia."""
    _require_cuda()
    n, r, c, vq, o, cl, b, s = _qd_problem((12, 12, 12), 5)
    out = {}
    for dev in ("cuda", "cpu"):
        t = SparseCholesky.from_coo(n, r, c, vq, o, cl, dtype=dtype,
                                    device=dev, signs=s)
        t.factorize(check=True)
        B = np.random.default_rng(1).standard_normal((n, 3))
        x, X = t.solve(b), t.solve(B)
        assert t.residual(b, x) <= TOL and t.residual(B, X) <= TOL
        out[dev] = ([p.cpu() for p in t.panels], x, t.slogdet(),
                    t.inertia())
    tol = 1e-10 if dtype == np.float64 else 1e-4
    assert all(_rel(g, w) <= tol for g, w in zip(out["cuda"][0],
                                                 out["cpu"][0]))
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= 1e-8 * np.abs(
        out["cpu"][1]).max()
    assert out["cuda"][2][0] == out["cpu"][2][0]
    assert abs(out["cuda"][2][1] - out["cpu"][2][1]) <= 1e-6 * abs(
        out["cpu"][2][1])
    assert out["cuda"][3] == out["cpu"][3] == (int((s > 0).sum()),
                                               int((s < 0).sum()), 0)


@pytest.mark.cuda
def test_qd_factorization_launches_no_chol_inv():
    """The signed factorization never takes the SPD kernel route, even on
    levels the routing rule would send there; the SPD factorization of the
    same pattern still does."""
    _require_cuda()
    n, r, c, vq, o, cl, b, s = _qd_problem((20, 20, 20), 6)
    rule = (hk.MIN_B, hk.W_PER_B)
    hk.MIN_B, hk.W_PER_B = 1, 1 << 20       # every W >= 128 level eligible
    try:
        t = SparseCholesky.from_coo(n, r, c, vq, o, cl, dtype=np.float32,
                                    signs=s)
        before = hk.LAUNCHES["chol_inv"]
        t.factorize()
        assert hk.LAUNCHES["chol_inv"] == before
        assert t.residual(b, t.solve(b)) <= TOL
        spd = SparseCholesky.from_coo(n, r, c, np.abs(vq), o, cl,
                                      dtype=np.float32)
        spd.factorize()
        assert hk.LAUNCHES["chol_inv"] > before
    finally:
        hk.MIN_B, hk.W_PER_B = rule


# (B, W) of every signed level: the benchmark's hybrid u-p elasticity
# (`cholbench/configs/elast_q1p0_48.json`, levels 0 to 13) and the 50^3 L8
# quasi-definite grid of chip_smoke's qd phase; W = 7056, 2504, 1256, 632,
# 304, 144 and 56 end in a panel of 16, 8, 8, 24, 16, 16 and 24 columns
SIGNED_SHAPES = {
    **{f"elast_q1p0_48 L{lvl}": bw for lvl, bw in enumerate((
        (1, 7056), (2, 3456), (4, 1728), (8, 1728), (16, 864), (32, 432),
        (64, 432), (128, 216), (256, 112), (512, 112), (1024, 56),
        (2048, 32), (4096, 32), (8192, 64)))},
    **{f"qd 50^3 L{lvl}": bw for lvl, bw in enumerate((
        (1, 2504), (2, 1256), (4, 632), (8, 632), (16, 304), (32, 144),
        (64, 144), (128, 864)))},
    "odd rows": (3, 151),           # rows of an odd stride: scalar access
}
# signed_panel against its plain version, each part (the diagonal block's
# lower triangle, the panel, X) relative to its own largest entry. Both are
# IEEE; they differ in the order of the sums inside the 32-wide solve
# (cuBLAS's TRSM against the kernel's row-by-row substitution) and in the
# fused multiply-adds of the column updates: a few ulps a step over at most
# 32 steps on these well-conditioned blocks.
SIGNED_REL = {torch.float32: 2e-5, torch.float64: 1e-13}


def _signed_fronts(B, W, dtype, seed):
    """Seeded quasi-definite fronts [B, W, W] on the card and their
    signature: off-diagonal entries of variance 0.5 / W, so a row's sum of
    magnitudes is about 0.56 W^0.5, and the diagonal s (1 + W^0.5), so that
    both sign blocks are diagonally dominant and any diagonal block factors
    alone."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = torch.where(torch.rand(B, W, generator=gen, device="cuda") < 0.4,
                    -1.0, 1.0).to(dtype)
    a = torch.randn(B, W, W, generator=gen, device="cuda").to(dtype)
    a = (a + a.transpose(1, 2)).mul_(0.5 / W ** 0.5)
    a.diagonal(dim1=1, dim2=2).copy_(s * (1 + W ** 0.5))
    return a, s


def _signed_parts(work, x, c0, c1):
    return (work[:, c0:c1, c0:c1].tril(), work[:, c1:, c0:c1], x)


def _signed_panels(W):
    """The first panel, one in the middle and the last (ragged where W is
    not a multiple of 32)."""
    last = (W - 1) // 32 * 32
    return sorted({0, (W // 64) * 32, last})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", sorted(SIGNED_SHAPES))
def test_signed_panel_kernel_matches_plain(shape, dtype):
    """The kernel against `signed_panel_ref` on the same fronts, at the
    first, a middle and the last panel of every signed level shape; a
    second launch bitwise equal; the tickets left zero."""
    _require_cuda()
    B, W = SIGNED_SHAPES[shape]
    a, s = _signed_fronts(B, W, dtype, seed=31)
    tickets = torch.zeros(B, dtype=torch.int32, device="cuda")
    for c0 in _signed_panels(W):
        c1 = min(c0 + 32, W)
        k, again, p = a.clone(), a.clone(), a.clone()
        xk, xa, xp = (torch.empty(B, W - c1, c1 - c0, dtype=dtype,
                                  device="cuda") for _ in range(3))
        before = hk.LAUNCHES["signed_panel"]
        hk.signed_panel(k, s, c0, c1, xk, tickets)
        hk.signed_panel(again, s, c0, c1, xa, tickets)
        hk.signed_panel_ref(p, s, c0, c1, xp)
        torch.cuda.synchronize()
        assert hk.LAUNCHES["signed_panel"] == before + 2
        assert not tickets.any()
        assert torch.equal(k, again) and torch.equal(xk, xa)
        for got, want in zip(_signed_parts(k, xk, c0, c1),
                             _signed_parts(p, xp, c0, c1)):
            if want.numel():
                assert torch.isfinite(got).all()
                assert _rel(got, want) <= SIGNED_REL[dtype], (shape, c0)
        # nothing outside the panel's columns and the block's lower triangle
        keep = a.clone()
        keep[:, c0:, c0:c1] = k[:, c0:, c0:c1]
        up = torch.ones(c1 - c0, c1 - c0, dtype=torch.bool,
                        device="cuda").triu(1)
        keep[:, c0:c1, c0:c1][:, up] = a[:, c0:c1, c0:c1][:, up]
        assert torch.equal(k, keep)
        del k, again, p, xk, xa, xp, keep
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_signed_panel_kernel_reads_strided_fronts(dtype):
    """A work that is a clone of a strided `blk` view (as the level loop
    makes it), and a strided view itself (row stride F + 1, aligned and
    not), give what the plain version gives."""
    _require_cuda()
    B, W, F = 5, 300, 420
    a, s = _signed_fronts(B, W, dtype, seed=32)
    for pad in (1, 4):
        full = torch.zeros(B, F + pad, F + pad, dtype=dtype, device="cuda")
        full[:, :W, :W] = a
        blk = full[:, :F, :W]
        for work in (blk[:, :W, :].clone(), full[:, :W, :W]):
            p = a.clone()
            xk = torch.empty(B, W - 64, 32, dtype=dtype, device="cuda")
            xp = torch.empty_like(xk)
            hk.signed_panel(work, s, 32, 64, xk)
            hk.signed_panel_ref(p, s, 32, 64, xp)
            for got, want in zip(_signed_parts(work, xk, 32, 64),
                                 _signed_parts(p, xp, 32, 64)):
                assert _rel(got, want) <= SIGNED_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_signed_cholesky_on_card_matches_cpu(dtype):
    """The whole blocked factorization through the kernel against the CPU
    port's column loop, within the f32 / f64 rounding of 160 columns; a
    signature violation still gives NaN in that front only."""
    _require_cuda()
    from cholesky_tpu_torch.numeric import ldlt

    a, s = _signed_fronts(3, 160, torch.float64, seed=33)
    want = ldlt.blocked_signed_cholesky(a.cpu(), s.cpu())
    got = ldlt.blocked_signed_cholesky(a.to(dtype), s.to(dtype))
    # ten times a panel's bound: five panels and the trailing GEMMs
    # between them, and the f32 input's own rounding
    assert _rel(got, want) <= SIGNED_REL[dtype] * 10
    assert not got.triu(1).any()
    bad = s.clone()
    bad[1, 100] = -bad[1, 100]
    nan = torch.isnan(ldlt.blocked_signed_cholesky(a.to(dtype),
                                                    bad.to(dtype)))
    assert nan.any(dim=(1, 2)).tolist() == [False, True, False]


@pytest.mark.cuda
def test_signed_panel_kernel_rejects_bad_input(monkeypatch):
    """A CUDA tensor launches the kernel or raises: a wrong dtype, shape,
    panel or device raises, and the plain version is never called."""
    _require_cuda()
    a, s = _signed_fronts(2, 100, torch.float32, seed=34)
    x = torch.empty(2, 68, 32, device="cuda")

    def plain(*args):
        raise AssertionError("signed_panel_ref called on a CUDA tensor")

    monkeypatch.setattr(hk, "signed_panel_ref", plain)
    hk.signed_panel(a.clone(), s, 0, 32, x)
    bad = [(a.half(), s.half(), 0, 32, x.half()),       # dtype
           (a, s.double(), 0, 32, x),                   # s's dtype
           (a[:, :, :99], s, 0, 32, x),                 # not square
           (a, s[:, :99], 0, 32, x),                    # s's shape
           (a, s, 0, 32, x[:, 1:]),                     # xbuf's shape
           (a, s, 0, 64, torch.empty(2, 36, 64, device="cuda")),  # > 32
           (a, s, 96, 104, x),                          # past W
           (a.transpose(1, 2), s, 0, 32, x),            # last stride
           (a, s, 0, 32, x.cpu()),                      # device
           (a, s.cpu(), 0, 32, x)]
    for args in bad:
        with pytest.raises(ValueError):
            hk.signed_panel(*args)
    with pytest.raises(ValueError):
        hk.signed_panel(a, s, 0, 32, x, torch.zeros(2, device="cuda"))
    with pytest.raises(ValueError):
        hk.signed_panel(a, s, 0, 32, x,
                        torch.zeros(2, dtype=torch.int32))


@pytest.mark.cuda
def test_qd_factorization_launches_signed_panel_once_a_panel():
    """One signed factorization on the card: one `signed_panel` launch for
    every panel of every level, no column loop left (no `addcmul_` or
    `sqrt_` among the operators the profiler records), and the contract
    met."""
    _require_cuda()
    from torch.profiler import ProfilerActivity, profile

    n, r, c, vq, o, cl, b, s = _qd_problem((20, 20, 20), 6)
    t = SparseCholesky.from_coo(n, r, c, vq, o, cl, dtype=np.float32,
                                signs=s)
    t.factorize()
    before = hk.LAUNCHES["signed_panel"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.factorize()
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert not [k for k in ops if "addcmul" in k or "sqrt" in k], ops
    st = t.factor_stats
    assert st["signed_panels"] == sum(-(-int(w) // 32) for w in t.fplan.W)
    assert st["signed_panel_launches"] == st["signed_panels"] > 0
    assert hk.LAUNCHES["signed_panel"] - before == st["signed_panels"]
    assert t.residual(b, t.solve(b)) <= TOL


@pytest.mark.cuda
def test_schur_complement_on_card_matches_cpu():
    _require_cuda()
    n, r, c, v, o, cl, b = generate_problem((14, 14, 14), 5)
    out = {}
    for dev in ("cuda", "cpu"):
        t = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64,
                                    device=dev)
        S = t.schur_complement()
        bh = t.condense_rhs(b)
        x = t.expand_solution(b, np.linalg.solve(S, bh))
        assert t.residual(b, x) <= TOL
        out[dev] = (S, bh, x)
    for g, w in zip(out["cuda"], out["cpu"]):
        assert np.abs(g - w).max() <= 1e-10 * np.abs(w).max()


@pytest.mark.cuda
def test_native_ordering_from_scipy_factors_on_card():
    """from_scipy orders with the native host core and factors on the card;
    the Python engine gives the same plan."""
    _require_cuda()
    import scipy.sparse as sp

    from cholesky_tpu_torch.utils import problems

    n, r, c, v = problems.make_gallery(1)["aniso3d"]()
    a = sp.csr_matrix((v, (r, c)), shape=(n, n))
    s = SparseCholesky.from_scipy(a, dtype=np.float32)
    assert s.ordering_info["engine"] == "native"
    assert s.device.type == "cuda"
    py = SparseCholesky.from_scipy(a, dtype=np.float32, device="cpu",
                                   native=False)
    assert py.ordering_info["engine"] == "python"
    assert np.array_equal(s.plan.perm, py.plan.perm)
    b = np.random.default_rng(9).standard_normal(n)
    assert s.residual(b, s.solve(b)) <= TOL


@pytest.mark.cuda
def test_cli_debug_log_on_card_matches_cpu(tmp_path, capsys):
    """`-d` on the card writes the log a CPU run writes, byte for byte; its
    `--debug-dumps` and f64 factor file pass debug_factor at 1e-10."""
    _require_cuda()
    from cholesky_tpu_torch import cli
    from cholesky_tpu_torch.io import mmio, ordering as ordio
    from cholesky_tpu_torch.verify import replay

    n, r, c, v, o, cl, b = generate_problem((20, 20), 5)
    f = {k: str(tmp_path / k) for k in ("m.mtx", "ord.txt", "clust.txt",
                                         "b.mtx", "factored.mtx")}
    mmio.write_coo(f["m.mtx"], r, c, v, (n, n), symmetry="hermitian")
    ordio.write_ordering(f["ord.txt"], o)
    ordio.write_clusters(f["clust.txt"], cl)
    mmio.write_array(f["b.mtx"], b)
    base = ["-i", f["m.mtx"], "-s", f["ord.txt"], "-c", f["clust.txt"],
            "-b", f["b.mtx"], "--dtype", "float64"]
    card, host = str(tmp_path / "card"), str(tmp_path / "host")
    assert cli.main(base + ["-d", card, "--debug-dumps", "-m",
                            f["factored.mtx"], "--device", "cuda"]) == 0
    assert cli.main(base + ["-d", host, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("fill engine: native") == 2
    assert open(f"{card}/output", "rb").read() == open(
        f"{host}/output", "rb").read()
    assert replay.debug_factor(f["m.mtx"], f["ord.txt"], f["factored.mtx"],
                               f"{card}/output", directory=card, rtol=TOL,
                               atol=TOL)


def _flag():
    return torch.backends.cuda.matmul.fp32_precision


@pytest.mark.cuda
def test_tf32_flag_takes_effect_on_a_batched_gemm():
    """A [256, 128, 128] f32 batched GEMM: IEEE within f32 rounding of an
    f64 product, TF32 (10 significand bits) at least 10x coarser."""
    _require_cuda()
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(256, 128, 128, generator=gen, device="cuda")
    y = torch.randn(256, 128, 128, generator=gen, device="cuda")
    ref = torch.bmm(x.double(), y.double())
    errs = {}
    for rung in ("highest", "default"):
        with precision_ctx(rung):
            errs[_flag()] = _rel(torch.bmm(x, y), ref)
    assert errs["ieee"] <= 1e-5
    assert errs["tf32"] > 10 * errs["ieee"]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 1024])
def test_chol_inv_bit_identical_under_both_flags(B):
    """chol_inv computes in scalar FMAs: the TF32 flag leaves it bit for
    bit unchanged."""
    _require_cuda()
    from cholesky_tpu_torch.numeric.precision import precision_ctx

    d = torch.from_numpy(_blocks(B)).cuda()
    out = {}
    for rung in ("highest", "default"):
        with precision_ctx(rung):
            out[_flag()] = hk.chol_inv(d)
    torch.cuda.synchronize()
    assert torch.equal(out["ieee"][0], out["tf32"][0])
    assert torch.equal(out["ieee"][1], out["tf32"][1])
    l_p, m_p = hk.chol_inv_ref(d)
    assert _rel(out["tf32"][0], l_p) <= L_REL
    assert _rel(out["tf32"][1], m_p) <= INV_REL


@pytest.mark.cuda
@pytest.mark.parametrize("rung", [None, "highest", "high", "default"])
def test_solve_at_each_rung_on_card(rung):
    """15^3 L5 at each rung (AUTO resolves "highest" there) solves to the
    contract, and the flag is what it was before."""
    _require_cuda()
    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    before = _flag()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cuda", precision=rung)
    s.factorize()
    x = s.solve(b)
    assert s.residual(b, x) <= TOL
    assert s.precision == ("highest" if rung is None else
                           None if rung == "default" else rung)
    assert _flag() == before


@pytest.mark.cuda
def test_flag_restored_on_card(monkeypatch):
    """The flag inside the level loop is the rung's; after the
    factorization, the solves, selected inversion and a factorization that
    raises, it is what the process had set."""
    _require_cuda()
    from cholesky_tpu_torch.numeric import frontal

    n, r, c, v, o, cl, b = generate_problem((12, 12, 12), 4)
    matmul = torch.backends.cuda.matmul
    for outer in ("none", "ieee", "tf32"):
        matmul.fp32_precision = outer
        try:
            for rung, want in (("highest", "ieee"), ("default", "tf32")):
                s = SparseCholesky.from_coo(n, r, c, v, o, cl,
                                            dtype=np.float32, device="cuda",
                                            precision=rung)
                seen = set()
                s.factorize(level_hook=lambda lvl, w: seen.add(_flag()))
                assert seen == {want}
                assert s.residual(b, s.solve(b)) <= TOL
                s.inv_diag()
                assert _flag() == outer
                with monkeypatch.context() as m:
                    def boom(*args, **kwargs):
                        raise RuntimeError("boom")
                    m.setattr(frontal, "factor", boom)
                    with pytest.raises(RuntimeError, match="boom"):
                        s.factorize()
                assert _flag() == outer
        finally:
            matmul.fp32_precision = "none"


# ---------------------------------------------------------------------------
# The mesh (cholesky_tpu_torch/parallel/) on the card


@pytest.mark.cuda
def test_50cubed_on_a_four_slot_mesh_of_one_card():
    """50^3 L8 f32 on 4 logical slots of cuda:0: the placement per level
    (slot-sharded 7-2, row groups at 1, the root on the first slot), every
    level within 1e-5 of the mesh-free factor, chol_inv launched by every
    slot of the kernel-routed levels, and the refined solve at the
    contract."""
    _require_cuda()
    from cholesky_tpu_torch.numeric import frontal
    from cholesky_tpu_torch.parallel import mesh as mesh_mod

    n, r, c, v, o, cl, b = generate_problem((50, 50, 50), 8)
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 device="cuda")
    free = s1.factorize()
    mesh = mesh_mod.make_mesh(devices=[torch.device("cuda", 0)] * 4)
    sD = SparseCholesky(s1.plan, s1.rows, s1.cols, s1.vals,
                        dtype=np.float32, mesh=mesh)
    fp = sD.fplan
    assert frontal.level_paths(fp, mesh, frontal.root_spec(fp, mesh)) == \
        ["replicated", "rows"] + ["slot"] * 6
    before = hk.LAUNCHES["chol_inv"]
    sD.factorize()
    assert hk.LAUNCHES["chol_inv"] - before == 4 * (7 + 2 + 2)
    for lvl in range(fp.levels):
        assert _rel(mesh_mod.local(sD.panels[lvl], "cuda:0"),
                    free[lvl]) <= 1e-5, lvl
    x = sD.solve(b)
    assert sD.residual(b, x) <= TOL


@pytest.mark.cuda
def test_mesh_factor_export_on_card_matches_mesh_free(monkeypatch):
    """`factor_coo` of a solver on 4 logical slots of cuda:0 (the levels
    gathered from the card into host memory) equals the mesh-free
    factor's entries to 1e-12 in f64, with the root factored on the first
    slot and, forced, collectively."""
    _require_cuda()
    from cholesky_tpu_torch.numeric import frontal
    from cholesky_tpu_torch.parallel import mesh as mesh_mod

    n, r, c, v, o, cl, b = generate_problem((24, 24, 24), 6)
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cuda")
    r1, c1, v1 = s1.factor_coo()
    key = np.lexsort((c1, r1))
    mesh = mesh_mod.make_mesh(devices=[torch.device("cuda", 0)] * 4)
    for forced in (None, 16):
        monkeypatch.setattr(frontal, "ROOT_DIST_MIN", forced)
        sD = SparseCholesky(s1.plan, s1.rows, s1.cols, s1.vals, mesh=mesh)
        assert frontal.level_paths(sD.fplan, mesh, frontal.root_spec(
            sD.fplan, mesh))[0] == ("replicated" if forced is None
                                    else "root-1d")
        rD, cD, vD = sD.factor_coo()
        kD = np.lexsort((cD, rD))
        assert np.array_equal(rD[kD], r1[key])
        assert np.array_equal(cD[kD], c1[key])
        assert np.abs(vD[kD] - v1[key]).max() <= 1e-12 * np.abs(v1).max()


@pytest.mark.cuda
def test_chol_inv_and_a_two_card_mesh_off_card_zero():
    """The kernel on cuda:1 (its first launch on a card other than
    cuda:0: the wrapper's device guard and the kernel's per-device
    shared-memory limit), a solver on cuda:1, and a 2-card mesh, each
    against the plain version or the single-card solve."""
    _require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (torch.cuda.device_count() < 2)")
    from cholesky_tpu_torch.parallel import mesh as mesh_mod

    d = torch.from_numpy(_blocks(64))
    l_k, m_k = hk.chol_inv(d.to("cuda:1"))
    assert l_k.device == torch.device("cuda", 1)
    l_p, m_p = hk.chol_inv_ref(d.double())
    assert _rel(l_k, l_p) <= F64_REL and _rel(m_k, m_p) <= 1e-4
    n, r, c, v, o, cl, b = generate_problem((30, 30, 30), 7)
    rule = (hk.MIN_B, hk.W_PER_B)
    hk.MIN_B, hk.W_PER_B = 1, 1 << 20
    try:
        xs = []
        for kw in (dict(device="cuda:0"), dict(device="cuda:1"),
                   dict(mesh=mesh_mod.make_mesh(2))):
            s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                        **kw)
            before = hk.LAUNCHES["chol_inv"]
            xs.append(s.solve(b))
            assert hk.LAUNCHES["chol_inv"] > before
            assert s.residual(b, xs[-1]) <= TOL
    finally:
        hk.MIN_B, hk.W_PER_B = rule
    for x in xs[1:]:
        assert np.linalg.norm(x - xs[0]) <= 1e-8 * np.linalg.norm(xs[0])


@pytest.mark.cuda
def test_panels_oracle_on_card_matches_cpu():
    """The panel oracle engine (cuSOLVER / cuBLAS through torch ops) on
    the card against the same engine on the CPU at 14^3 L4, f64: factored
    panels and solutions within 1e-12 relative, residual at the
    contract."""
    _require_cuda()
    from cholesky_tpu_torch.verify.oracle import PanelsOracle

    n, r, c, v, o, cl, b = generate_problem((14, 14, 14), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    card = PanelsOracle(s.plan, s.rows, s.cols, s.vals, device="cuda")
    host = PanelsOracle(s.plan, s.rows, s.cols, s.vals, device="cpu")
    x, x_h = card.solve(b), host.solve(b)
    assert all(p.device.type == "cuda" for p in card.panels)
    for p, q in zip(card.panels, host.panels):
        assert _rel(p, q) <= 1e-12
    assert np.abs(x - x_h).max() <= 1e-12 * np.abs(x_h).max()
    assert s.residual(b, x) <= TOL


@pytest.mark.cuda
def test_gp_variance_example_on_card():
    """examples/torch/gp_variance.py at its default size on the card (its
    default device), in process: the coverage line tests/test_examples.py
    asserts of the JAX twin."""
    _require_cuda()
    import contextlib
    import io
    import os
    import re
    import runpy
    import sys

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch", "gp_variance.py")
    argv, syspath, out = sys.argv, list(sys.path), io.StringIO()
    sys.argv = [path]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv, sys.path[:] = argv, syspath
    m = re.search(r"coverage of truth: ([0-9.]+)%", out.getvalue())
    assert m, out.getvalue()[-2000:]
    assert float(m.group(1)) >= 80.0


@pytest.mark.cuda
def test_profile_factor_on_card():
    """The panel engine's stage profiler on the card at 14^3 L4, f64: one
    record per POTRF / TRSM / UPDATE stage, leaves to root, a device time
    each, the caller's NumPy panels untouched."""
    _require_cuda()
    from cholesky_tpu_torch.numeric import assemble, profile

    n, r, c, v, o, cl, _ = generate_problem((14, 14, 14), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    host = assemble.assemble_panels(s.plan, s.rows, s.cols, s.vals,
                                    dtype=np.float64)
    before = [p.copy() for p in host]
    lines = []
    recs = profile.profile_factor(s.plan, host, emit=lines.append)
    assert [r["level"] for r in recs if r["op"] == "POTRF"] == [3, 2, 1, 0]
    assert {r["op"] for r in recs} == {"POTRF", "TRSM", "UPDATE"}
    assert len(lines) == len(recs)
    assert all(r["time_us"] >= 0 for r in recs)
    assert all(np.array_equal(p, q) for p, q in zip(host, before))


@pytest.mark.cuda
def test_bench_front_kernels_on_card():
    """tools/torch/bench_front_kernels.py on two classes on the card: at
    both rungs the kernel route launches factor_slab once and chol_inv
    once a panel and agrees with cuSOLVER + TRSM (`slab_err` within
    SLAB_REL, TF32 SLAB_TF32_REL); the three routes are timed, the kernel
    and the composite in turns; the rule routes [128, 1440, 864]
    to the kernel."""
    _require_cuda()
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = _bench_tool()["main"](
            ["--classes", "128,1440,864", "512,256,128", "--reps", "2"])
    assert res["card"] and res["device"] == "cuda"
    for row in res["classes"]:
        for flag, tol in (("ieee", SLAB_REL), ("tf32", SLAB_TF32_REL)):
            r = row["rungs"][flag]
            assert r["factor_slab_launches"] == 1
            assert r["chol_inv_launches"] == -(-row["W"] // 128)
            assert r["max_rel_diff"] <= tol
            assert min(r["kernel_ms"], r["composite_ms"],
                       r["library_ms"]) > 0
            assert len(r["kernel_ms_rounds"]) == res["rounds"]
            assert len(r["composite_ms_rounds"]) == res["rounds"]
            assert 0 <= r["kernel_ahead_rounds"] <= res["rounds"]
            assert r["executed_tflops"] > 0 and 0 < r["share"] < 1
    assert res["classes"][0]["routed"] == "kernel"


@pytest.mark.cuda
def test_spans_carry_device_extents_on_the_card():
    """Under torch.profiler a cycle on the card records the solver's spans
    (`cholesky_tpu_torch.trace`) with a device extent each: a level's and
    an application's extents are positive and the factorization's holds
    its levels'; the profiler's device-side annotations of the spans are
    user annotations, not kernels; off, nothing is recorded."""
    _require_cuda()
    from torch.profiler import ProfilerActivity, profile

    from cholesky_tpu_torch import trace

    n, r, c, v, o, cl, b = generate_problem((16, 16, 16), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cuda")
    s.factorize()
    s.solve(b)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.update_values(v * 2.0)
        s.factorize()
        x = s.solve(b)
        torch.cuda.synchronize()
    assert s.residual(b, x) <= TOL
    spans = trace.spans()
    dev = {sp.name: 0.0 for sp in spans}
    for sp in spans:
        assert sp.device_ms is not None and sp.device_ms >= 0, sp.name
        dev[sp.name] += sp.device_ms
    levels = [sp for sp in spans if sp.name.startswith("chol.level.")]
    assert len(levels) == s.fplan.levels
    assert all(sp.device_ms > 0 for sp in levels)
    assert dev["chol.factorize"] >= sum(sp.device_ms for sp in levels)
    assert dev["chol.refine.apply"] > 0 and dev["chol.solve.inv_pivots"] > 0
    rows = [e for e in prof.key_averages() if e.key.startswith("chol.")
            and str(e.device_type).endswith("CUDA")]
    assert rows and all(e.is_user_annotation for e in rows)
    trace.clear()
    s.solve(b)
    assert trace.spans() == []

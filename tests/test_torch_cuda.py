"""The port on the card: the hand-written CUDA kernel against its plain
PyTorch version, the slice with every wide level forced through it, and
the matmul-precision ladder's flag (TF32 or IEEE cuBLAS products).

Every test is marked `cuda` and skips when torch.cuda.is_available() is
False. This file imports neither jax nor tests.conftest, so it also runs
where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import devmem, regimes
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
    too) and the ELL planes come from the pool of long-lived state
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

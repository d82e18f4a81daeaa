"""The port's collective dense Cholesky (cholesky_tpu_torch/parallel/
dist_cholesky.py) on an 8-slot CPU mesh, mirroring
tests/test_dist_cholesky.py: the 1-D and 2-D block-cyclic schemes against
NumPy's Cholesky and the JAX package's on its 8 virtual CPU devices, the
padding of a size no grid divides, a bf16 input, the scheme routing, the
bytes the steps send, and the collective root inside the solver.

Inputs: seeded NumPy SPD matrices, F <= 1024. Tolerances: f64 factors
1e-10 relative to NumPy and the JAX package; a bf16 input 2e-2 (its own
rounding); solver solutions 1e-9 against the mesh-free port (as the JAX
tests), residuals <= 1e-10.
"""

import numpy as np
import pytest
import torch

import cholesky_tpu
from cholesky_tpu.parallel import dist_cholesky as jdc
from cholesky_tpu.parallel import mesh as jmesh
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import frontal
from cholesky_tpu_torch.parallel import dist_cholesky as dc
from cholesky_tpu_torch.parallel import mesh as tmesh

F64_REL = 1e-10
BF16_REL = 2e-2
X_REL = 1e-9
TOL = 1e-10


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(devices=[torch.device("cpu")] * 8)


def _spd(F, seed):
    g = np.random.default_rng(seed).standard_normal((F, F)) / np.sqrt(F)
    return g @ g.T + 4.0 * np.eye(F)


def _rel(x, ref):
    x = np.asarray(x.double() if torch.is_tensor(x) else x, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("scheme,F,block", [
    ("1d", 512, 64), ("1d", 1000, 96), ("2d", 512, 64), ("2d", 1000, 64)])
def test_schemes_match_numpy_and_jax(scheme, F, block, mesh):
    """Both schemes at a divisible and a padded size (1000 pads to the
    grid's multiple with unit pivots): NumPy's factor, zeros above the
    diagonal, and (at 512) the JAX package's same scheme on 8 devices."""
    a = _spd(F, F)
    fn = dc.distributed_cholesky if scheme == "1d" \
        else dc.distributed_cholesky_2d
    jfn = jdc.distributed_cholesky if scheme == "1d" \
        else jdc.distributed_cholesky_2d
    L = fn(torch.from_numpy(a), mesh, block=block)
    assert L.shape == (F, F) and L.dtype == torch.float64
    ref = np.linalg.cholesky(a)
    assert _rel(L, ref) <= F64_REL
    assert torch.count_nonzero(torch.triu(L, 1)) == 0
    if F == 512:        # one JAX shard_map program per scheme
        jl = np.asarray(jfn(a, jmesh.make_mesh(8), block=block))
        assert _rel(L, jl) <= F64_REL


@pytest.mark.parametrize("scheme", ["1d", "2d"])
def test_bf16_input_computes_in_f32(scheme, mesh):
    a = _spd(512, 5)
    fn = dc.distributed_cholesky if scheme == "1d" \
        else dc.distributed_cholesky_2d
    L = fn(torch.from_numpy(a).to(torch.bfloat16), mesh, block=128)
    assert L.dtype == torch.bfloat16
    ref = np.linalg.cholesky(np.asarray(
        torch.from_numpy(a).to(torch.bfloat16).double()))
    assert _rel(L, ref) <= BF16_REL


def test_scheme_routing_matches_jax(mesh, monkeypatch):
    """`_grid_for` and `_pick_scheme` give the JAX package's answers on a
    table of (F, ndev, block); ROOT_SCHEME forces either scheme, as
    CHOLESKY_TPU_ROOT_SCHEME does there; the routed factor is NumPy's."""
    for ndev in (2, 4, 6, 7, 8, 16, 64):
        assert dc._grid_for(ndev) == jdc._grid_for(ndev)
    for F, ndev, block in ((1024, 8, 256), (8192, 8, 256), (65536, 7, 256),
                           (8192, 4, 256), (2504, 4, 256), (4096, 16, 64)):
        assert dc._pick_scheme(F, ndev, block) == jdc._pick_scheme(
            F, ndev, block), (F, ndev, block)
    assert dc._pick_scheme(2504, 4, 256, mesh) == "1d"   # 50^3 on 4 slots
    monkeypatch.setattr(dc, "ROOT_SCHEME", "2d")
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_SCHEME", "2d")
    assert dc._pick_scheme(64, 8, 256) == jdc._pick_scheme(64, 8, 256) \
        == "2d"
    a = _spd(768, 10)
    L = dc.collective_cholesky(torch.from_numpy(a), mesh, block=128)
    assert _rel(L, np.linalg.cholesky(a)) <= F64_REL


def test_bytes_sent_follow_the_wire_model(mesh):
    """The 1-D steps send each panel (rows k block and below) to the 7
    other slots; the 4 x 2 grid sends less (~(1/pr + 1/pc) of it plus the
    diagonal tiles); the final gather moves the 7 other slots' columns."""
    F, block = 1024, 64
    a = torch.from_numpy(_spd(F, 3))
    one, two = {}, {}
    dc.distributed_cholesky(a, mesh, block=block, stats=one)
    dc.distributed_cholesky_2d(a, mesh, block=block, stats=two)
    panels = sum((F - k * block) * block for k in range(F // block))
    assert one["bytes"] == 7 * panels * 8
    assert one["gather_bytes"] == 7 * F * (F // 8) * 8
    assert two["bytes"] < one["bytes"]


@pytest.mark.parametrize("scheme", ["1d", "2d"])
def test_collective_root_in_solver(scheme, mesh, monkeypatch):
    """The collective root forced on in a mesh solve (ROOT_DIST_MIN
    monkeypatched, as CHOLESKY_TPU_ROOT_DIST_MIN in the JAX tests): a spy
    sees the scheme run once on the [W0, W0] root, the solution equals the
    mesh-free port's and the JAX package's with the same knobs, and the f32
    solve refines to 1e-10."""
    name = "distributed_cholesky" if scheme == "1d" \
        else "distributed_cholesky_2d"
    calls = []
    real = getattr(dc, name)

    def spy(a, m, block=256, stats=None):
        calls.append(tuple(a.shape))
        return real(a, m, block=block, stats=stats)

    monkeypatch.setattr(dc, name, spy)
    monkeypatch.setattr(frontal, "ROOT_DIST_MIN", 16)
    monkeypatch.setattr(dc, "ROOT_SCHEME", scheme)
    monkeypatch.setattr(dc, "ROOT_BLOCK", 16)
    for k, v in (("ROOT_DIST_MIN", "16"), ("ROOT_SCHEME", scheme),
                 ("ROOT_BLOCK", "16")):
        monkeypatch.setenv("CHOLESKY_TPU_" + k, v)
    n, r, c, v, o, cl, b = generate_problem((20, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh)
    assert frontal.level_paths(s.fplan, mesh, frontal.root_spec(
        s.fplan, mesh))[0] == "root-" + scheme
    x = s.solve(b)
    W0 = s.fplan.W[0]
    assert calls == [(W0, W0)]
    assert s.residual(b, x) <= TOL
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    assert _rel(x, s1.solve(b)) <= X_REL
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              mesh=jmesh.make_mesh(8))
    assert _rel(x, js.solve(b)) <= X_REL
    s32 = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh,
                                  dtype=np.float32)
    assert s32.residual(b, s32.solve(b, tol=TOL)) <= TOL
    assert len(calls) == 2

"""The port's multislice mesh (2 slices x 4 slots of CPU) against the JAX
package's on its 8 virtual CPU devices, mirroring tests/test_multislice.py:
mesh construction, the placement policy, the forced 2-D root scheme, the
solver and a family on the mesh, and the CLI's --slices.

Inputs: `generate_problem` and seeded NumPy SPD matrices. Tolerances: f64
factors 1e-10 relative to NumPy, f64 solutions 1e-12 against the
mesh-free port and the JAX package's multislice solve, residuals <= 1e-10.
"""

import numpy as np
import pytest
import torch

import cholesky_tpu
from cholesky_tpu.parallel import dist_cholesky as jdc
from cholesky_tpu.parallel import mesh as jmesh
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.io import mmio
from cholesky_tpu_torch.numeric import frontal
from cholesky_tpu_torch.parallel import dist_cholesky as dc
from cholesky_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

F64_REL = 1e-10
X_REL = 1e-12
TOL = 1e-10
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def msmesh():
    return tmesh.make_multislice_mesh(2, 4, devices=CPU8)


def _rel(x, ref):
    x = np.asarray(x.double() if torch.is_tensor(x) else x, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def test_mesh_construction(msmesh):
    assert msmesh.axis_names == (tmesh.DCN_AXIS, tmesh.TREE_AXIS)
    assert msmesh.devices.shape == (2, 4) and msmesh.size == 8
    assert msmesh.shape == {"slice": 2, "tree": 4}
    assert tmesh.slot_axes(msmesh) == (tmesh.DCN_AXIS, tmesh.TREE_AXIS)
    assert dc._is_multislice(msmesh)
    assert tmesh.make_multislice_mesh(4, devices=CPU8).devices.shape == (4, 2)
    with pytest.raises(ValueError):
        tmesh.make_multislice_mesh(3, devices=CPU8)
    assert not dc._is_multislice(tmesh.make_mesh(devices=CPU8))
    assert not dc._is_multislice(
        tmesh.make_multislice_mesh(8, 1, devices=CPU8))
    assert dc._is_multislice(msmesh) == jdc._is_multislice(
        jmesh.make_multislice_mesh(2, 4))


def test_sharding_policy_multislice(msmesh):
    """Slot-sharded levels split over the (slice, tree) axes slice-major,
    narrow levels by row groups inside a slice, as the JAX package's."""
    jm = jmesh.make_multislice_mesh(2, 4)
    for lvl in range(6):
        tp, jp = tmesh.panel_sharding(msmesh, lvl), jmesh.panel_sharding(
            jm, lvl)
        assert tuple(tp.spec) == tuple(jp.spec), lvl
        assert tuple(tmesh.rhs_sharding(msmesh, lvl).spec) == tuple(
            jmesh.rhs_sharding(jm, lvl).spec)
    s3 = tmesh.panel_sharding(msmesh, 3)
    # slots [0..3] (slice 0) hold blocks [0..3]
    assert [s3.batch_range(s, 8)[0] // 4 for s in range(8)] == [0] * 4 + [1] * 4
    s1 = tmesh.panel_sharding(msmesh, 1)
    assert [s1.batch_range(s, 2)[0] for s in range(8)] == [0] * 4 + [1] * 4


def test_multislice_forces_the_2d_root(msmesh, monkeypatch):
    flat = tmesh.make_mesh(devices=CPU8)
    assert dc._pick_scheme(2048, 8, 256, flat) == "1d"
    assert dc._pick_scheme(2048, 8, 256, msmesh) == "2d"
    monkeypatch.setattr(dc, "ROOT_SCHEME", "1d")
    assert dc._pick_scheme(2048, 8, 256, msmesh) == "1d"
    for F, blk in ((512, 64), (1000, 64)):
        g = np.random.default_rng(F).standard_normal((F, F)) / np.sqrt(F)
        a = g @ g.T + 4.0 * np.eye(F)
        ref = np.linalg.cholesky(a)
        L2 = dc.distributed_cholesky_2d(torch.from_numpy(a), msmesh,
                                        block=blk)
        L1 = dc.distributed_cholesky(torch.from_numpy(a), msmesh, block=blk)
        assert _rel(L2, ref) <= F64_REL and _rel(L1, ref) <= F64_REL


def test_solver_and_family_on_multislice(msmesh, monkeypatch):
    """The solver on the multislice mesh, with the collective root forced
    on (the 2-D scheme on the slice grid): the mesh-free port's and the
    JAX package's multislice solution; and a family of 8 systems, one per
    slot."""
    monkeypatch.setattr(frontal, "ROOT_DIST_MIN", 16)
    monkeypatch.setattr(dc, "ROOT_BLOCK", 16)
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_DIST_MIN", "16")
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_BLOCK", "16")
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=msmesh)
    assert frontal.level_paths(s.fplan, msmesh, frontal.root_spec(
        s.fplan, msmesh)) == ["root-2d", "rows", "rows", "slot", "slot"]
    x = s.solve(b)
    assert s.residual(b, x) <= TOL
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    assert _rel(x, s1.solve(b)) <= X_REL
    js = cholesky_tpu.SparseCholesky.from_coo(
        n, r, c, v, o, cl, mesh=jmesh.make_multislice_mesh(2, 4))
    assert _rel(x, js.solve(b)) <= X_REL
    rng = np.random.default_rng(7)
    vals = (1.0 + rng.uniform(0, 2, size=8))[:, None] * s.vals[None, :]
    fam = s.factorize_many(vals)
    assert [len(f.parts) for f in fam.factors] == [8] * s.fplan.levels
    B = rng.standard_normal((8, n))
    X = fam.solve(B)
    assert np.all(fam.residual(B, X) <= TOL)
    assert _rel(X, s1.factorize_many(vals).solve(B)) <= X_REL


def test_cli_multislice(tmp_path, capsys, port_fixtures):
    """--slices 2 --devices 8 --device cpu through the port's CLI on the
    port's lapl_400x400 fixture: the solution meets the residual contract
    and SciPy's direct solve."""
    import scipy.linalg

    from cholesky_tpu_torch import cli

    p = port_fixtures("lapl_400x400")
    sol = str(tmp_path / "solution.txt")
    assert cli.main(["-i", p["mat"], "-s", p["separators"], "-c",
                     p["clusters"], "-b", p["b"], "-o", sol, "--slices", "2",
                     "--devices", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Done solve." in out
    a = mmio.read_dense(p["mat"])
    bb = mmio.read_array(p["b"])
    x = np.genfromtxt(sol).reshape(bb.shape)
    assert np.allclose(x, scipy.linalg.solve(a, bb), rtol=1e-6, atol=1e-6)

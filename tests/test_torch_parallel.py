"""The port's single-process mesh (cholesky_tpu_torch/parallel/, the
mesh-aware level loop and solves of numeric/frontal.py) against its own
mesh-free path and against the JAX package on conftest's 8 virtual CPU
devices, mirroring tests/test_parallel.py.

The port's mesh is 8 logical CPU slots (`make_mesh(devices=[cpu] * 8)`).
Inputs come from `generate_problem` (seeded). Tolerances: f64 solutions
1e-12 relative (the same operations, sums in another order), f64 factors
1e-12, f32 factors 1e-6 (as tests/test_parallel.py), f32 factors of a
forced regime against the same regime mesh-free 1e-6, and against the JAX
package's default f32 mesh factor 1e-6, or 1e-2 where the regime stores
or updates in bf16; every residual <= 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

import cholesky_tpu
from cholesky_tpu.parallel import dist_level as jdist_level
from cholesky_tpu.parallel import mesh as jmesh
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import frontal, regimes
from cholesky_tpu_torch.numeric.assemble import FrontAssembler, MeshAssembler
from cholesky_tpu_torch.parallel import dist_level
from cholesky_tpu_torch.parallel import mesh as tmesh

F64_REL = 1e-12
F32_REL = 1e-6
BF16_REL = 1e-2
TOL = 1e-10
BIG = 1 << 40
CPU8 = [torch.device("cpu")] * 8


def _f64(x) -> np.ndarray:
    """A level (sharded, bf16, host-resident), a tensor or an array as f64
    NumPy."""
    x = tmesh.local(x) if isinstance(x, tmesh.Sharded) else x
    return np.asarray(x.double().cpu() if torch.is_tensor(x) else x,
                      np.float64)


def _rel(x, ref):
    x, ref = _f64(x), _f64(ref)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


def _spec(s):
    return tuple(s.spec)


@pytest.fixture(scope="module")
def meshes():
    return tmesh.make_mesh(devices=CPU8), jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def grid24():
    """24^2 L5 (levels 3, 4 slot-sharded, 1, 2 row groups on 8 slots):
    the port with and without the mesh and the JAX package on its mesh,
    f64, factored."""
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    tm, jm = tmesh.make_mesh(devices=CPU8), jmesh.make_mesh(8)
    t1 = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    tD = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=tm)
    jD = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=jm)
    for s in (t1, tD, jD):
        s.factorize()
    return dict(problem=(n, r, c, v, o, cl, b), t1=t1, tD=tD, jD=jD)


def test_sharding_policy_matches_jax(meshes):
    """Every level of a 24^2 L5 plan (and past it): the port's placement
    spec is JAX's PartitionSpec, and each slot holds the blocks (and rows)
    that JAX's sharding gives its device."""
    tm, jm = meshes
    for lvl in range(7):
        tp, jp = tmesh.panel_sharding(tm, lvl), jmesh.panel_sharding(jm, lvl)
        assert _spec(tp) == tuple(jp.spec), lvl
        assert _spec(tmesh.rhs_sharding(tm, lvl)) == tuple(
            jmesh.rhs_sharding(jm, lvl).spec)
        B, H = 1 << lvl, 16
        if tp.kind == "replicated":
            continue
        idx = jp.devices_indices_map((B, H, 4))
        order = list(jp.mesh.devices.reshape(-1))
        for s, dev in enumerate(order):
            want = idx[dev]
            assert tp.batch_range(s, B) == (want[0].start or 0,
                                            want[0].stop or B), (lvl, s)
            assert tp.row_range(s, H) == (want[1].start or 0,
                                          want[1].stop or H), (lvl, s)
    for k in (5, 8, 16):
        assert _spec(tmesh.family_sharding(tm, k)) == tuple(
            jmesh.family_sharding(jm, k).spec)


def test_level_paths_match_jax_dispatch(grid24, meshes):
    """The port's per-level path equals the JAX package's dispatch: row
    groups exactly where `dist_level.eligible` holds, slot-sharded where
    the placement is, the root replicated (the port's ROOT_DIST_MIN is
    unset; the JAX package's root replicates below its 2048)."""
    tm, jm = meshes
    fp, jfp = grid24["tD"].fplan, grid24["jD"].fplan
    paths = frontal.level_paths(fp, tm, frontal.root_spec(fp, tm))
    assert paths == ["replicated", "rows", "rows", "slot", "slot"]
    for lvl in range(1, fp.levels):
        assert (paths[lvl] == "rows") == jdist_level.eligible(
            jfp, lvl, 1 << lvl, jm), lvl
    assert [type(p).__name__ for p in grid24["tD"].panels] == [
        "Tensor", "Sharded", "Sharded", "Sharded", "Sharded"]


def test_mesh_assembly_places_each_slots_part(grid24):
    """Each slot's part assembled on its own device (`MeshAssembler`)
    equals the slot's part of the slabs assembled whole and then placed
    (`distribute_panels` / `distribute_family`): slot-sharded blocks, row
    groups, the replicated root, and a K = 8 family's systems."""
    tD = grid24["tD"]
    whole = FrontAssembler(tD.fplan, tD.rows, tD.cols, "cpu")
    asm = MeshAssembler(tD.fplan, tD.rows, tD.cols, tD.mesh)
    vals = np.stack([tD.vals * (1 + k) for k in range(8)])
    for got, want in (
            (asm(tD.vals, np.float64), tmesh.distribute_panels(
                whole(tD.vals, np.float64), tD.mesh)),
            (asm(vals, np.float64, family=8), tmesh.distribute_family(
                whole(vals, np.float64), tD.mesh, 8))):
        assert [type(g) for g in got] == [type(w) for w in want]
        for g, w in zip(got, want):
            if isinstance(w, tmesh.Sharded):
                assert g.kind == w.kind and g.shape == w.shape
                assert all(torch.equal(a, b)
                           for a, b in zip(g.parts, w.parts))
            else:
                assert torch.equal(g, w)


def test_mesh_factor_and_solve_match_mesh_free_and_jax(grid24):
    n, r, c, v, o, cl, b = grid24["problem"]
    t1, tD, jD = grid24["t1"], grid24["tD"], grid24["jD"]
    for lvl in range(tD.fplan.levels):
        assert _rel(tD.panels[lvl], np.asarray(jD.panels[lvl])) <= F64_REL
        assert _rel(tD.panels[lvl], t1.panels[lvl]) <= F64_REL
    x1, xD, xj = t1.solve(b), tD.solve(b), jD.solve(b)
    assert tD.last_solve["engine"] == "banded"
    assert _rel(xD, x1) <= F64_REL and _rel(xD, xj) <= F64_REL
    assert tD.residual(b, xD) <= TOL
    # the solve without pivot inverses, one rhs and a block
    B = np.random.default_rng(1).standard_normal((n, 3))
    tD._want_inv_pivots = lambda: False
    try:
        assert _rel(tD.solve(b), x1) <= F64_REL
        X = tD.solve(B)
        assert tD.last_solve["engine"] == "plain"
    finally:
        del tD._want_inv_pivots
    assert _rel(X, t1.solve(B)) <= F64_REL and tD.residual(B, X) <= TOL


def test_mesh_companions_on_the_gathered_factor(grid24):
    """Selected inversion, logdet, sampling, the Schur complement, factor
    export and a checkpoint round trip on a mesh-factored solver give the
    mesh-free port's results."""
    n, r, c, v, o, cl, b = grid24["problem"]
    t1, tD = grid24["t1"], grid24["tD"]
    assert _rel(tD.inv_diag(), t1.inv_diag()) <= 1e-11
    assert _rel(tD.inv_entries(r[:40], c[:40]),
                t1.inv_entries(r[:40], c[:40])) <= 1e-11
    assert abs(tD.logdet() - t1.logdet()) <= F64_REL * abs(t1.logdet())
    z = np.random.default_rng(2).standard_normal((n, 2))
    assert _rel(tD.sample(z), t1.sample(z)) <= F64_REL
    assert _rel(tD.whiten(z), t1.whiten(z)) <= F64_REL
    assert _rel(tD.schur_complement(), t1.schur_complement()) <= F64_REL
    assert _rel(tD.condense_rhs(b), t1.condense_rhs(b)) <= F64_REL
    assert _rel(tD.factor_dense(), t1.factor_dense()) <= F64_REL


def test_mesh_checkpoint_round_trip(grid24, tmp_path):
    n, r, c, v, o, cl, b = grid24["problem"]
    tD = grid24["tD"]
    path = tD.save_factor(str(tmp_path / "ck"))
    t2 = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=tD.mesh)
    t2.load_factor(path)
    assert isinstance(t2.panels[4], tmesh.Sharded)
    assert _rel(t2.solve(b), tD.solve(b)) <= F64_REL


def test_narrow_level_distribution(monkeypatch, meshes):
    """Narrow levels (1 < B < 8) factor by row groups: a spy sees levels
    [1, 2], both come back row-sharded over all 8 slots, the f32 factor
    equals the mesh-free one to 1e-6 and the refined solve meets 1e-10;
    the kill switch DIST_MID = False replicates them."""
    tm, _ = meshes
    calls = []
    real = dist_level.factor_level_sharded

    def spy(fp, lvl, piv, U, mesh, update_dtype, stats=None):
        calls.append(lvl)
        return real(fp, lvl, piv, U, mesh, update_dtype, stats)

    monkeypatch.setattr(dist_level, "factor_level_sharded", spy)
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    sD = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=tm,
                                 dtype=np.float32)
    sD.factorize()
    assert sorted(set(calls)) == [1, 2]
    for lvl in (1, 2):
        p = sD.panels[lvl]
        assert p.kind == "rows" and len(p.parts) == 8
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 device="cpu")
    s1.factorize()
    for lvl in range(s1.fplan.levels):
        assert _rel(sD.panels[lvl], s1.panels[lvl]) <= F32_REL, lvl
    x = sD.solve(b, tol=TOL)
    assert sD.residual(b, x) <= TOL and sD.last_solve["loop"] == "device"
    calls.clear()
    monkeypatch.setattr(dist_level, "DIST_MID", False)
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=tm,
                                 dtype=np.float32)
    s2.factorize()
    assert calls == []
    assert isinstance(s2.panels[1], torch.Tensor)
    assert s2.residual(b, s2.solve(b)) <= TOL


def _family(shape=(12, 12), levels=3, k=8, seed=11):
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    rng = np.random.default_rng(seed)
    vals = (1.0 + rng.uniform(0, 2, size=k))[:, None] * v[None, :]
    vals[:, r == c] += rng.uniform(0, 1, size=(k, int((r == c).sum())))
    return (n, r, c, v, o, cl), vals, rng.standard_normal((k, n))


def test_family_shards_over_mesh(meshes):
    """factorize_many on the mesh: K / 8 systems per slot at every level,
    factors and solutions equal to the mesh-free port's and the JAX
    package's mesh family; K = 5 pads to 8 with copies of the last system
    and cuts every result back to 5; an f32 family refines to 1e-10."""
    tm, jm = meshes
    (n, r, c, v, o, cl), vals, B = _family()
    t1 = SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu")
    tD = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=tm)
    jD = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=jm)
    f1, fD, fj = (s.factorize_many(vals) for s in (t1, tD, jD))
    assert all(isinstance(f, tmesh.Sharded) and len(f.parts) == 8
               for f in fD.factors)
    for lvl in range(tD.fplan.levels):
        ref = np.asarray(fj.factors[lvl])              # [K, B, F, W]
        assert _rel(fD.factors[lvl], ref.reshape((-1,) + ref.shape[2:])) \
            <= F64_REL
    xD = fD.solve(B)
    assert _rel(xD, f1.solve(B)) <= F64_REL
    assert _rel(xD, fj.solve(B)) <= F64_REL
    assert np.all(fD.residual(B, xD) <= TOL)
    assert np.allclose(fD.logdet(), f1.logdet(), rtol=F64_REL)
    f5 = tD.factorize_many(vals[:5])
    assert f5.pad == 3 and f5.factors[0].shape[0] == 8
    x5 = f5.solve(B[:5])
    assert x5.shape == (5, n) and np.all(f5.residual(B[:5], x5) <= TOL)
    assert f5.logdet().shape == (5,)
    t32 = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=tm,
                                  dtype=np.float32)
    f32 = t32.factorize_many(vals)
    X = f32.solve(B, tol=TOL)
    assert np.all(f32.residual(B, X) <= TOL)


@pytest.fixture(scope="module")
def regime_case():
    """26 x 22 L6 f32 (levels 3-5 slot-sharded on 8 slots): the JAX
    package's mesh factor and the port's mesh-free factor under each
    forced regime."""
    n, r, c, v, o, cl, b = generate_problem((26, 22), 6)
    jD = cholesky_tpu.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, mesh=jmesh.make_mesh(8))
    jD.factorize()
    return (n, r, c, v, o, cl, b), [np.asarray(p) for p in jD.panels]


REGIMES = {
    "two-piece": (dict(two_piece=True), F32_REL),
    "bf16-updates": (dict(two_piece=True, update_dtype=torch.bfloat16),
                     BF16_REL),
    "chunked": (dict(two_piece=True, chunks={5: 2, 4: 2}), F32_REL),
    "bf16-store": (dict(store_dtype=torch.bfloat16), BF16_REL),
    "offload": (dict(offload=True, reupload=False), F32_REL),
    "offload-reupload": (dict(store_dtype=torch.bfloat16, offload=True,
                              reupload=True), BF16_REL),
    "combined": (dict(two_piece=True, chunks={5: 2},
                      store_dtype=torch.bfloat16, offload=True, spill=True,
                      reupload=False), BF16_REL)}


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_capacity_regimes_under_the_mesh(name, regime_case, meshes):
    """Each capacity regime forced on one slot's plan: the mesh factor
    equals the same regime mesh-free, stays within the regime's tolerance
    of the JAX package's mesh factor, the refined solve meets 1e-10, and
    an offloaded level stays sharded (on its slots again after the
    re-upload)."""
    tm, _ = meshes
    (n, r, c, v, o, cl, b), jfac = regime_case
    force, tol = REGIMES[name]
    out = {}
    for tag, kw in (("mesh", dict(mesh=tm)), ("free", dict(device="cpu"))):
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    **kw)
        s._plan_override = regimes.plan_regimes(
            s.fplan, s.dtype, BIG, mesh=kw.get("mesh"), **force)
        s.factorize()
        out[tag] = s
    sD, s1 = out["mesh"], out["free"]
    for lvl in range(sD.fplan.levels):
        assert _rel(sD.panels[lvl], s1.panels[lvl]) <= F32_REL, lvl
        assert _rel(sD.panels[lvl], jfac[lvl]) <= tol, lvl
    wide = sD.panels[sD.fplan.levels - 1]
    assert isinstance(wide, tmesh.Sharded) and len(wide.parts) == 8
    assert wide.dtype == sD.regimes.levels[-1].store_dtype
    x = sD.solve(b, tol=TOL)
    assert sD.residual(b, x) <= TOL


def test_quasi_definite_on_mesh(meshes):
    """LDL^T on the mesh: the wide level slot-sharded, the rest on the
    first slot; f64 solution equal to the mesh-free port's and the JAX
    package's mesh solve, slogdet and inertia the same."""
    tm, jm = meshes
    n, r, c, v, o, cl, b = generate_problem((16, 16), 4)
    rng = np.random.default_rng(3)
    sg = np.where(rng.random(n) < 0.4, -1.0, 1.0)
    d = r == c
    vq = v.copy()
    vq[d] = sg[r[d]] * (np.abs(v[d]) + 1.0)
    t1 = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=sg, device="cpu")
    tD = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=sg, mesh=tm)
    jD = cholesky_tpu.SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=sg,
                                              mesh=jm)
    tD.factorize()
    paths = frontal.level_paths(tD.fplan, tm, rows=False)
    assert paths == ["replicated"] * 3 + ["slot"]
    assert [isinstance(p, tmesh.Sharded) for p in tD.panels] == [
        x == "slot" for x in paths]
    xD = tD.solve(b)
    assert tD.residual(b, xD) <= TOL
    assert _rel(xD, t1.solve(b)) <= F64_REL
    assert _rel(xD, jD.solve(b)) <= F64_REL
    (sg1, ld1), (sgD, ldD) = jD.slogdet(), tD.slogdet()
    assert sg1 == sgD and abs(ld1 - ldD) <= F64_REL * abs(ld1)
    assert tD.inertia() == jD.inertia()
    t32 = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=sg, mesh=tm,
                                  dtype=np.float32)
    assert t32.residual(b, t32.solve(b, tol=TOL)) <= TOL


def test_per_slot_bytes_scale_with_the_mesh(grid24, meshes):
    """The widest level's working set on one slot is at most 0.2 of the
    mesh-free level's (16 blocks on 8 slots: 1/8, as
    tests/test_parallel.py:305-327 requires of the JAX package), and every
    slot's stored part of every level is within `slot_bytes`."""
    tm, _ = meshes
    fp = grid24["tD"].fplan
    lvl = fp.levels - 1
    one = regimes.slot_bytes(fp, lvl, None)
    eight = regimes.slot_bytes(fp, lvl, tm)
    assert 0 < eight <= 0.2 * one, (eight, one)
    for lvl, p in enumerate(grid24["tD"].panels):
        need = regimes.slot_bytes(fp, lvl, tm, dtype=torch.float64)
        held = (p.slot_nbytes() if isinstance(p, tmesh.Sharded)
                else [p.numel() * p.element_size()])
        assert max(held) <= need, (lvl, held, need)
    plan = regimes.plan_regimes(fp, torch.float32, BIG, mesh=tm)
    assert not plan.lazy and plan.mesh is tm


def test_make_mesh_needs_the_cards_it_names():
    """Without devices= the mesh is of CUDA cards: asking for more than
    the machine has raises ValueError naming how many it has."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"has {have}"):
        tmesh.make_mesh(have + 1)
    m = tmesh.make_mesh(devices=CPU8[:4])
    assert m.size == 4 and m.axis_names == ("tree",) and hash(m) == hash(
        tmesh.make_mesh(devices=CPU8[:4]))
    with pytest.raises(AttributeError):
        m.devices = None
    assert tmesh.panel_sharding(m, 1).spec == tuple(P("fb", "rg", None))

"""CPU tests of the Q1 elasticity operator (`operators/elasticity_q1.py`),
its plain reference, the step counts (`stepwork.py`), and the solver under
test against the reference at small meshes.

    python -m pytest cholbench/tests/test_cholbench_elasticity.py -q

The count of the ne = 64 configuration reads its 32 M entries (~25 s,
~3 GB); everything else runs at ne = 1 ... 5.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from cholbench import harness, stepwork, yardstick  # noqa: E402
from cholbench.operators import elasticity_q1 as op  # noqa: E402

SEED = 3_000_000_037
CONFIG = os.path.join(REPO, "cholbench/configs/elast_q1_64.json")


def _cfg(ne, levels=3):
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["operator"] = dict(cfg["operator"], ne=ne)
    cfg.update(n=3 * (ne + 1) * ne * (ne + 1), levels=levels)
    return cfg


def _assembled(cfg):
    """K as a symmetric SciPy matrix from the lower triangle `coo` gives."""
    n, r, c, v = op.coo(cfg)
    L = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    return (L + L.T - sp.diags(L.diagonal())).tocsr()


def _newmark_shift(rng, ne):
    """A shift of the cell's traffic at h = 1 / ne: 4.8 h / alpha^2, alpha
    log-uniform on [1, 100]."""
    return 4.8 / ne / np.exp(rng.uniform(0.0, np.log(100.0))) ** 2


# ------------------------------------------------------- the element matrix

@pytest.mark.parametrize("h", [1.0, 1.0 / 3, 1.0 / 64])
def test_element_matrix_symmetric_with_the_rigid_modes_as_null_space(h):
    Ke = op.element_stiffness(h, 1.0, 0.25)
    assert Ke.shape == (24, 24)
    assert np.abs(Ke - Ke.T).max() <= 1e-15 * np.abs(Ke).max()
    ev = np.linalg.eigvalsh(Ke)
    tiny = np.abs(ev) <= 1e-12 * ev.max()
    assert tiny.sum() == 6 and ev[~tiny].min() > 0
    # the six rigid modes: three translations, three rotations
    xyz = op._corner_offsets() * h
    modes = []
    for d in range(3):
        t = np.zeros((8, 3))
        t[:, d] = 1.0
        modes.append(t)
        w = np.zeros(3)
        w[d] = 1.0
        modes.append(np.cross(w, xyz))
    for m in modes:
        assert np.abs(Ke @ m.reshape(-1)).max() <= 1e-12 * np.abs(Ke).max()


@pytest.mark.parametrize("E,nu", [(1.0, 0.25), (2.5, 0.3)])
def test_element_matrix_diagonal(E, nu):
    h = 0.125
    lam, mu = op.lame(E, nu)
    Ke = op.element_stiffness(h, E, nu)
    assert np.allclose(np.diag(Ke), (lam + 4 * mu) * h / 9, rtol=1e-14)
    if (E, nu) == (1.0, 0.25):
        assert lam == pytest.approx(0.4) and mu == pytest.approx(0.4)


def test_patch_test_on_eight_bricks():
    """A linear displacement field leaves no force on the centre node of a
    2 x 2 x 2 patch of bricks."""
    h = 0.5
    Ke = op.element_stiffness(h, 1.0, 0.25)
    rng = np.random.default_rng(1)
    G, c = rng.standard_normal((3, 3)), rng.standard_normal(3)
    corners = op._corner_offsets()
    force = np.zeros(3)
    for o in corners:                    # the 8 bricks around (1, 1, 1)
        pos = (o + corners) * h
        u = (pos @ G.T + c).reshape(-1)
        a = int(np.flatnonzero((o + corners == 1).all(axis=1))[0])
        force += (Ke @ u)[3 * a:3 * a + 3]
    assert np.abs(force).max() <= 1e-13 * np.abs(Ke).max()


def test_patch_test_in_the_reference():
    """u = y g vanishes on the clamped face: the reference's force is zero
    on every node off the free boundary (x, z in {0, 1}, y = 1)."""
    ne = 4
    ref = op.Reference(_cfg(ne))
    shape = op.node_shape(_cfg(ne))
    x, y, z = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    y = (y + 1) / ne
    g = np.array([0.3, -1.1, 0.7])
    u = (y.reshape(-1, 1) * g).reshape(-1)
    f = ref.matvec(u, 0.0).reshape(-1, 3)
    inner = ((x > 0) & (x < ne) & (y < 1) & (z > 0) & (z < ne)).reshape(-1)
    assert inner.sum() == 3 * 3 * 3
    assert np.abs(f[inner]).max() <= 1e-14
    assert np.abs(f[~inner]).max() > 1e-3


# ------------------------------------------------- the matrix and reference

@pytest.mark.parametrize("ne", [1, 3, 4, 5])
def test_coo_pattern(ne):
    cfg = _cfg(ne)
    n, r, c, v = op.coo(cfg)
    assert n == cfg["n"] and (r >= c).all()
    assert len(np.unique(r * n + c)) == len(r)
    # every pair of nodes within one step in each axis, whole 3 x 3 blocks
    counts = [3 * (ne + 1) - 2, 3 * ne - 2, 3 * (ne + 1) - 2]
    assert 2 * len(r) - n == 9 * int(np.prod(counts))
    # the widest row: 27 nodes, 3 dofs each (from ne = 2 on)
    deg = np.bincount(r, minlength=n) + np.bincount(c[r != c], minlength=n)
    assert deg.max() == (81 if ne >= 2 else 3 * 8 - 3 * 4)
    assert np.linalg.eigvalsh(_assembled(cfg).toarray()).min() > 0


@pytest.mark.parametrize("ne", [3, 4, 5])
def test_reference_matvec_equals_the_assembled_matrix(ne):
    cfg = _cfg(ne)
    K = _assembled(cfg)
    ref = op.Reference(cfg)
    rng = np.random.default_rng(ne)
    shift = _newmark_shift(rng, ne)
    for x in (rng.standard_normal(cfg["n"]),
              rng.standard_normal((cfg["n"], 3))):
        want = K @ x + shift * x
        got = ref.matvec(x, shift)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    A = K + shift * sp.eye(cfg["n"])
    want = abs(A).sum(axis=1).max()
    assert ref.norm_inf(shift) == pytest.approx(want, rel=1e-13)


def test_reference_imports_nothing_of_the_solver():
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from cholbench.operators import elasticity_q1 as op\n"
        "cfg = {'operator': {'ne': 3, 'E': 1.0, 'nu': 0.25}, 'levels': 3}\n"
        "ref = op.Reference(cfg)\n"
        "ref.matvec(np.ones(ref.n), 0.1); ref.norm_inf(0.1)\n"
        "op.coo(cfg); op.separators(cfg)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'jax', 'jaxlib', 'cholesky_tpu', 'cholesky_tpu_torch'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_sets_no_tf32():
    # set through the legacy flags alone (a read of them after the port's
    # `fp32_precision` was set would raise), and left as the reference
    # leaves them: off
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    op.Reference(_cfg(1))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("ne,levels", [(3, 3), (4, 4), (6, 5)])
def test_separators_cover_the_dofs_node_by_node(ne, levels):
    cfg = _cfg(ne, levels)
    seps = op.separators(cfg)
    nodes = op.node_separators(cfg)
    assert sorted(seps) == list(range(1, 2 ** levels))
    order = np.concatenate([seps[s] for s in sorted(seps)])
    assert np.array_equal(np.sort(order), np.arange(cfg["n"]))
    for s, d in seps.items():
        assert np.array_equal(d.reshape(-1, 3),
                              3 * nodes[s][:, None] + np.arange(3))


# ------------------------------------------------------------- the counts

@pytest.fixture(scope="module")
def ne64():
    with open(CONFIG) as f:
        cfg = json.load(f)
    return cfg, yardstick.count_work(cfg), stepwork.count_step_work(cfg)


def test_stored_work_is_the_count(ne64):
    cfg, work, steps = ne64
    assert cfg["work"] == work
    assert cfg["step_work"] == steps
    assert work["matrix_entries"] == 32_253_495 and cfg["n"] == 811_200
    assert cfg["levels"] == int(np.ceil(np.log2(cfg["n"] / 64))) + 1


def test_pivot_and_schur_flops_are_the_work(ne64):
    cfg, _, _ = ne64
    sw = cfg["step_work"]
    assert sw["pivot_flops"] + sw["schur_flops"] == pytest.approx(
        cfg["work"]["flops"], rel=1e-15)


@pytest.mark.parametrize("ne,levels", [(3, 3), (4, 4)])
def test_step_work_by_hand(ne, levels):
    cfg = _cfg(ne, levels)
    n, r, c, _ = op.coo(cfg)
    p, m = yardstick.front_sizes(n, r, c, op.separators(cfg))
    got = stepwork.step_work(p, m)
    want = {k: 0 for k in got}
    for pi, mi in zip(p.tolist(), m.tolist()):
        want["pivot_flops"] += pi ** 3 / 3 + mi * pi * pi
        want["pivot_bytes"] += 8 * (pi * (pi + 1) // 2 + mi * pi)
        want["schur_flops"] += mi * mi * pi
        want["schur_bytes"] += 4 * (mi * pi + mi * mi)
        want["extadd_bytes"] += 12 * mi * mi
    assert got == pytest.approx(want, rel=1e-14)
    flops, entries = yardstick.front_work(p, m)
    assert got["pivot_flops"] + got["schur_flops"] == pytest.approx(flops)
    assert got["pivot_bytes"] == 8 * entries


# ------------------------------------------- the solver against the reference

def _solver(ne, levels):
    cfg = _cfg(ne, levels)
    solver, vals = op.build(cfg, "cpu")
    return cfg, solver, vals


@pytest.mark.parametrize("ne,levels", [(3, 3), (4, 4)])
def test_refined_solve_meets_the_contract(ne, levels):
    cfg, s, vals = _solver(ne, levels)
    ref = op.Reference(cfg)
    rng = np.random.default_rng(SEED + ne)
    diag = s.rows == s.cols
    K = _assembled(cfg).toarray()
    for _ in range(3):
        shift = _newmark_shift(rng, ne)
        b = rng.standard_normal(cfg["n"])
        v = vals.copy()
        v[diag] += shift
        s.update_values(v)
        s.factorize()
        x = s.solve(b, tol=1e-10)
        resid = np.linalg.norm(b - ref.matvec(x, shift)) / np.linalg.norm(b)
        assert resid <= 1e-10
        A = torch.from_numpy(K + shift * np.eye(cfg["n"]))
        xd = torch.linalg.solve(A, torch.from_numpy(b)).numpy()
        cond = float(torch.linalg.cond(A))
        err = np.linalg.norm(x - xd) / np.linalg.norm(xd)
        assert err <= 2 * cond * 1e-10
        # one unrefined application of the f32 factor misses the contract
        x0 = s.solve(b, refine="never")
        r0 = np.linalg.norm(b - ref.matvec(x0, shift)) / np.linalg.norm(b)
        assert r0 > 1e-10


def bench_copy(tmp_path, ne=3, levels=3, name="elast_t"):
    """BENCHMARK.json and cholbench/ copied to tmp_path, plus a small
    copy `name` of the elasticity configuration and its cell
    `<name>.newmark`, every metric that lists the elasticity cell listing
    it too."""
    root = tmp_path / "bench"
    shutil.copytree(os.path.join(REPO, "cholbench"), root / "cholbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    cfg = _cfg(ne, levels)
    cfg["name"] = name
    cfg["work"] = yardstick.count_work(cfg)
    cfg["step_work"] = stepwork.count_step_work(cfg)
    with open(root / "cholbench/configs" / f"{name}.json", "w") as f:
        json.dump(cfg, f)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"cholbench/configs/{name}.json",
                             "reduced": ["ne"], "why": "test"})
    bench["workloads"].append({"name": f"{name}.newmark", "config": name,
                               "traffic": "newmark", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "elast_q1_64.newmark" in m.get("workloads", []):
            m["workloads"].append(f"{name}.newmark")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_copy_of_the_cell_is_correct(tmp_path, trace):
    root = bench_copy(tmp_path)
    res, checks = harness.run(str(root), "elast_t.newmark", SEED, 0.3, trace,
                              "cpu", time.perf_counter())
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert checks["resid_max"]["value"] <= 1e-10
    assert 0 < checks["factor_eta"]["value"] <= checks["factor_eta"]["limit"]
    if trace:
        assert res["metrics"]["factor_ms.cycle"]["value"] > 0
        for name in ("pivot_ms.cycle", "schur_roofline_pct.cycle"):
            assert name not in res["metrics"]     # no device extent here
    else:
        assert res["metrics"]["cycle_ms"]["value"] > 0

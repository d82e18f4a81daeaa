"""The hybrid u-p elasticity operator of the benchmark
(`cholbench/operators/elasticity_q1p0.py`: Q1 displacements, one pressure a
brick, nu = 0.4999) and the port's signed LDL^T on it, on the CPU at
ne <= 4: the COO against the plain reference, the pressures' elimination
against the mean-dilatation brick, the inertia, the pressures' place in the
separator tree, the solver against a dense solve, and the signed column
loop's counters.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cholbench.operators import elasticity_q1 as q1  # noqa: E402
from cholbench.operators import elasticity_q1p0 as op  # noqa: E402

CONFIG = os.path.join(REPO, "cholbench/configs/elast_q1p0_48.json")
SEED = 3_000_000_041


def _cfg(ne, levels=3, dtype="float32"):
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["operator"] = dict(cfg["operator"], ne=ne)
    cfg.update(n=3 * (ne + 1) * ne * (ne + 1) + ne ** 3, levels=levels,
               dtype=dtype)
    return cfg


def _dense(cfg):
    n, r, c, v = op.coo(cfg)
    L = sp.coo_matrix((v, (r, c)), shape=(n, n)).toarray()
    return L + L.T - np.diag(np.diag(L))


def _ancestor_or_self(t, s, levels):
    """Whether separator t is s or an ancestor of s in the separator tree
    (heap index h = 2^levels - s, parent h // 2)."""
    ht, hs = (1 << levels) - t, (1 << levels) - s
    while hs >= ht:
        if hs == ht:
            return True
        hs //= 2
    return False


@pytest.mark.parametrize("ne", [1, 2, 3])
def test_coo_is_the_reference_on_the_identity(ne):
    cfg = _cfg(ne)
    n, r, c, v = op.coo(cfg)
    assert n == cfg["n"] and (r >= c).all()
    assert len(np.unique(r * n + c)) == len(r)
    ref = op.Reference(cfg)
    M = _dense(cfg)
    assert np.abs(ref.matvec(np.eye(n), 0.0) - M).max() <= (
        1e-14 * np.abs(M).max())
    x = np.random.default_rng(SEED + ne).standard_normal((n, 2))
    assert np.allclose(ref.matvec(x, 0.25), M @ x + 0.25 * x, rtol=0,
                       atol=1e-13 * np.abs(M @ x).max())
    for shift in (0.0, 0.25):
        want = np.abs(M + shift * np.eye(n)).sum(axis=1).max()
        assert ref.norm_inf(shift) == pytest.approx(want, rel=1e-13)


@pytest.mark.parametrize("ne", [2, 3])
def test_eliminating_the_pressures_gives_the_mean_dilatation_brick(ne):
    """A + B^T C^-1 B equals the stiffness assembled from the 2 mu part of
    `element_stiffness` plus the volumetric part by one-point integration,
    lambda h^3 g g^T with g the divergence at the brick's centre."""
    cfg = _cfg(ne)
    n_u, n_p = op.counts(cfg)
    M = _dense(cfg)
    A, Bt, C = M[:n_u, :n_u], M[:n_u, n_u:], -M[n_u:, n_u:]
    assert np.array_equal(C, np.diag(np.diag(C))) and (np.diag(C) > 0).all()
    schur = A + Bt @ np.linalg.solve(C, Bt.T)
    h = 1.0 / ne
    lam, mu = q1.lame(1.0, 0.4999)
    corners = q1._corner_offsets()
    g = (np.where(corners == 1, 1.0, -1.0) / (4 * h)).reshape(-1)
    Ke = q1.element_stiffness(h, 2 * mu, 0.0) + lam * h ** 3 * np.outer(g, g)
    K = np.zeros((n_u + 1, n_u + 1))
    for ex in range(ne):
        for ey in range(ne):
            for ez in range(ne):
                x, y, z = (corners + [ex, ey, ez]).T
                node = (x * ne + (y - 1)) * (ne + 1) + z
                dof = (3 * node[:, None] + np.arange(3)).reshape(-1)
                dof[np.repeat(y == 0, 3)] = n_u         # clamped: dropped
                K[np.ix_(dof, dof)] += Ke
    K = K[:n_u, :n_u]
    assert np.abs(schur - K).max() <= 1e-10 * np.abs(K).max()


@pytest.mark.parametrize("ne", [2, 3])
def test_inertia_is_the_signature(ne):
    cfg = _cfg(ne, levels=2)
    n_u, n_p = op.counts(cfg)
    w = np.linalg.eigvalsh(_dense(cfg))
    assert ((w > 0).sum(), (w < 0).sum(), (w == 0).sum()) == (n_u, n_p, 0)
    s = op.signs(cfg)
    assert np.array_equal(s, np.r_[np.ones(n_u), -np.ones(n_p)])
    solver, _ = op.build(cfg, "cpu")
    assert solver.inertia() == (n_u, n_p, 0)
    sign, _ = solver.slogdet()
    assert sign == (-1) ** n_p


@pytest.mark.parametrize("ne,levels", [(3, 3), (4, 4)])
def test_each_pressure_in_the_deepest_separator_of_its_nodes(ne, levels):
    cfg = _cfg(ne, levels)
    n_u, n_p = op.counts(cfg)
    seps = op.separators(cfg)
    order = np.concatenate([seps[s] for s in sorted(seps)])
    assert np.array_equal(np.sort(order), np.arange(cfg["n"]))
    sep_of = np.empty(cfg["n"], dtype=np.int64)
    for s, d in seps.items():
        sep_of[d] = s
        # the separator's displacements, then its pressures
        assert (np.diff((d >= n_u).astype(int)) >= 0).all()
    n, r, c, _ = op.coo(cfg)
    B = (r >= n_u) & (c < n_u)
    for e in range(n_p):
        nodes = sep_of[c[B & (r == n_u + e)]]
        assert sep_of[n_u + e] == nodes.min()
        assert all(_ancestor_or_self(t, sep_of[n_u + e], levels)
                   for t in nodes)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_signed_solver_meets_the_contract(dtype):
    cfg = _cfg(4, levels=4, dtype=dtype)
    s, vals = op.build(cfg, "cpu")
    ref = op.Reference(cfg)
    M = torch.from_numpy(ref.matvec(np.eye(cfg["n"]), 0.0))
    rng = np.random.default_rng(SEED)
    for _ in range(2):
        s.update_values(vals)
        s.factorize()
        b = rng.standard_normal(cfg["n"])
        x = s.solve(b, tol=1e-10)
        resid = np.linalg.norm(b - ref.matvec(x, 0.0)) / np.linalg.norm(b)
        assert resid <= 1e-10
        xd = torch.linalg.solve(M, torch.from_numpy(b)).numpy()
        assert np.linalg.norm(b - M.numpy() @ xd) <= 1e-10 * np.linalg.norm(b)
        cond = float(torch.linalg.cond(M))
        err = np.linalg.norm(x - xd) / np.linalg.norm(xd)
        assert err <= 2 * cond * 1e-10
    if dtype == "float32":
        assert s.last_solve["loop"] == "device"
        assert s.last_solve["sweeps"] >= 1


def test_signed_counters_are_the_plans_padded_widths():
    cfg = _cfg(4, levels=4)
    s, _ = op.build(cfg, "cpu")
    s.factorize()
    W = [int(w) for w in s.fplan.W]
    assert s.factor_stats["signed_columns"] == sum(W)
    assert s.factor_stats["signed_panels"] == sum(-(-w // 32) for w in W)
    assert "schur_syrk_launches" not in s.factor_stats


def test_reference_imports_nothing_of_the_solver_and_clears_tf32():
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "from cholbench.operators import elasticity_q1p0 as op\n"
        "cfg = {'operator': {'ne': 3, 'E': 1.0, 'nu': 0.4999},"
        " 'levels': 3}\n"
        "ref = op.Reference(cfg)\n"
        "ref.matvec(np.ones(ref.n), 0.0); ref.norm_inf(0.0)\n"
        "op.coo(cfg); op.separators(cfg); op.signs(cfg)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'jax', 'jaxlib', 'cholesky_tpu', 'cholesky_tpu_torch'))\n"
        "print(bad, torch.backends.cuda.matmul.allow_tf32,"
        " torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[] False False"

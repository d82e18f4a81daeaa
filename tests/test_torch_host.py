"""The port's own copies of the host modules (cholesky_tpu_torch/io,
symbolic, utils) against the JAX package's originals, on the CPU: the same
files and generator arguments must give identical arrays."""

import dataclasses

import numpy as np
import pytest

from cholesky_tpu.io import mmio as jmmio
from cholesky_tpu.io import ordering as jord
from cholesky_tpu.symbolic import plan as jplan
from cholesky_tpu.utils import laplacian as jlap
from cholesky_tpu.utils import round_up as jround_up
from cholesky_tpu_torch import convert
from cholesky_tpu_torch.io import mmio as tmmio
from cholesky_tpu_torch.io import ordering as tord
from cholesky_tpu_torch.symbolic import plan as tplan
from cholesky_tpu_torch.utils import laplacian as tlap
from cholesky_tpu_torch.utils import round_up as tround_up
from tests.conftest import FIXTURES
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

GENERATED = "generated_6x6x6_L3"
CASES = sorted(FIXTURES) + [GENERATED]
PLAN_ARRAYS = ("sep_sizes", "perm", "iperm", "sep_offset", "sep_of_dof",
               "loc_of_dof", "S", "H", "row_off", "u_off")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_ordering(t, j):
    assert (t.levels, t.num_separators) == (j.levels, j.num_separators)
    assert sorted(t.dofs) == sorted(j.dofs)
    for s in j.dofs:
        _same(t.dofs[s], j.dofs[s])


def _same_clusters(t, j):
    if j is None:
        assert t is None
        return
    assert (t.levels, t.num_separators) == (j.levels, j.num_separators)
    assert sorted(t.intervals) == sorted(j.intervals)
    for s, ivs in j.intervals.items():
        assert len(t.intervals[s]) == len(ivs)
        for a, b in zip(t.intervals[s], ivs):
            _same(a, b)


def _same_plan(t, j):
    assert type(t) is tplan.SolvePlan
    assert (t.tree.levels, t.tree.num_separators) == (
        j.tree.levels, j.tree.num_separators)
    assert t.n == j.n
    for f in PLAN_ARRAYS:
        _same(getattr(t, f), getattr(j, f))
    _same_clusters(t.clusters, j.clusters)
    # every field of the JAX plan is covered above
    assert {f.name for f in dataclasses.fields(j)} == set(PLAN_ARRAYS) | {
        "tree", "n", "clusters"}


def _orderings(case, paths):
    """(port ordering, port clusters, JAX ordering, JAX clusters)."""
    if case == GENERATED:
        t = tlap.generate_problem((6, 6, 6), 3)
        j = jlap.generate_problem((6, 6, 6), 3)
        return t[4], t[5], j[4], j[5]
    p = paths(case)
    return (tord.parse_ordering(p["separators"]),
            tord.parse_clusters(p["clusters"]),
            jord.parse_ordering(p["separators"]),
            jord.parse_clusters(p["clusters"]))


def _coo(case, paths):
    """(port (r, c, v), JAX (r, c, v)) as read or generated."""
    if case == GENERATED:
        t = tlap.generate_problem((6, 6, 6), 3)
        j = jlap.generate_problem((6, 6, 6), 3)
        return t[1:4], j[1:4]
    path = paths(case)["mat"]
    tb, *t = tmmio.read_coo(path)
    jb, *j = jmmio.read_coo(path)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    return t, j


@pytest.mark.parametrize("case", CASES)
def test_parse_ordering_and_clusters_identical(case, port_fixtures):
    to, tc, jo, jc = _orderings(case, port_fixtures)
    _same_ordering(to, jo)
    _same_clusters(tc, jc)
    _same(to.sizes(), jo.sizes())


@pytest.mark.parametrize("case", CASES)
def test_read_coo_and_dedup_lower_identical(case, port_fixtures):
    t, j = _coo(case, port_fixtures)
    for a, b in zip(t, j):
        _same(a, b)
    td = tmmio.dedup_lower(*t)
    jd = jmmio.dedup_lower(*j)
    for a, b in zip(td, jd):
        _same(a, b)
    for a, b in zip(tmmio.symmetrize_coo(*td), jmmio.symmetrize_coo(*jd)):
        _same(a, b)


@pytest.mark.parametrize("case", CASES)
def test_build_plan_identical(case, port_fixtures):
    to, tc, jo, jc = _orderings(case, port_fixtures)
    for pad_to in (8, 1):
        j = jplan.build_plan(jo, jc, pad_to=pad_to)
        t = tplan.build_plan(to, tc, pad_to=pad_to)
        _same_plan(t, j)
        for lvl in range(j.levels):
            assert t.tree.level_seps(lvl) == j.tree.level_seps(lvl)


@pytest.mark.parametrize("case", CASES)
def test_plan_from_jax_matches_own_plan(case, port_fixtures):
    """The JAX plan converted field by field equals the port's own, and
    shares no array with the original."""
    to, tc, jo, jc = _orderings(case, port_fixtures)
    j = jplan.build_plan(jo, jc)
    conv = convert.plan_from_jax(j)
    _same_plan(conv, j)
    _same_plan(conv, tplan.build_plan(to, tc))
    for f in PLAN_ARRAYS:
        assert not np.shares_memory(getattr(conv, f), getattr(j, f))


@pytest.mark.parametrize("shape,levels,cluster_size,seed", [
    ((6, 6, 6), 3, None, 0), ((15, 15, 15), 5, None, 0),
    ((9, 8, 7), 4, 5, 3), ((20, 20), 5, None, 1), ((3, 3), 2, 2, 0)])
def test_generate_problem_identical(shape, levels, cluster_size, seed):
    t = tlap.generate_problem(shape, levels, cluster_size, seed=seed)
    j = jlap.generate_problem(shape, levels, cluster_size, seed=seed)
    assert t[0] == j[0]
    for a, b in zip(t[1:4] + (t[6],), j[1:4] + (j[6],)):
        _same(a, b)
    _same_ordering(t[4], j[4])
    _same_clusters(t[5], j[5])


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_read_array_identical(case, port_fixtures):
    path = port_fixtures(case)["b"]
    _same(tmmio.read_array(path), jmmio.read_array(path))


@pytest.mark.parametrize("x,m", [(0, 8), (1, 8), (8, 8), (9, 8), (1255, 128)])
def test_round_up_identical(x, m):
    assert tround_up(x, m) == jround_up(x, m)

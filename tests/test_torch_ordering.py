"""The port's ordering modules (`cholesky_tpu_torch/symbolic/{nd,mdtree,
quality}.py`, `utils/problems.py`) against the JAX package's on the same
inputs: identical arrays everywhere (no tolerance: these are integer
algorithms and NumPy generators)."""

import numpy as np
import pytest

from cholesky_tpu.symbolic import mdtree as jmd, nd as jnd, quality as jq
from cholesky_tpu.utils import problems as jproblems
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch.symbolic import mdtree as tmd, nd as tnd, quality as tq
from cholesky_tpu_torch.utils import problems as tproblems

GALLERY = sorted(jproblems.make_gallery(1))


def _same_ordering(a, b):
    (oa, ca), (ob, cb) = a, b
    assert (oa.levels, oa.num_separators) == (ob.levels, ob.num_separators)
    assert sorted(oa.dofs) == sorted(ob.dofs)
    for s in oa.dofs:
        assert np.array_equal(oa.dofs[s], ob.dofs[s]), s
    assert (ca.levels, ca.num_separators) == (cb.levels, cb.num_separators)
    for s in ca.intervals:
        assert len(ca.intervals[s]) == len(cb.intervals[s])
        for x, y in zip(ca.intervals[s], cb.intervals[s]):
            assert np.array_equal(x, y), s


def _shuffled_grid(shape, seed):
    n, r, c, v, _, _, _ = generate_problem(shape, 2)
    p = np.random.default_rng(seed).permutation(n)
    return n, p[r], p[c]


def _disconnected():
    """Two grids and three isolated vertices, no edge between the parts."""
    n1, r1, c1 = _shuffled_grid((9, 9), 1)
    n2, r2, c2 = _shuffled_grid((5, 5, 5), 2)
    n = n1 + n2 + 3
    return n, np.concatenate([r1, r2 + n1]), np.concatenate([c1, c2 + n1])


@pytest.mark.parametrize("name", GALLERY)
def test_gallery_generators_identical(name):
    a = jproblems.make_gallery(1)[name]()
    b = tproblems.make_gallery(1)[name]()
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", GALLERY)
def test_nested_dissection_matches_jax_python_path(name):
    n, r, c, _ = jproblems.make_gallery(1)[name]()
    info = {}
    port = tnd.nested_dissection_graph(n, r, c, info=info)
    _same_ordering(port, jnd.nested_dissection_graph(n, r, c, native=False))
    assert info["chosen"] in ("nd", "md") and info["md_tried"]
    assert sum(len(d) for d in port[0].dofs.values()) == n


@pytest.mark.parametrize("name", GALLERY)
def test_nested_dissection_matches_jax_default_path(name):
    """The JAX package's default (its native core where the library
    loads, its Python path otherwise)."""
    n, r, c, _ = jproblems.make_gallery(1)[name]()
    _same_ordering(tnd.nested_dissection_graph(n, r, c),
                   jnd.nested_dissection_graph(n, r, c))


@pytest.mark.parametrize("case", ["shuffled2d", "shuffled3d", "disconnected",
                                  "n1", "n2", "n3", "levels3", "md", "nd"])
def test_nested_dissection_edge_cases(case):
    kw = {}
    if case == "shuffled2d":
        n, r, c = _shuffled_grid((24, 24), 3)
    elif case == "shuffled3d":
        n, r, c = _shuffled_grid((9, 9, 9), 4)
    elif case == "disconnected":
        n, r, c = _disconnected()
    elif case in ("n1", "n2", "n3"):
        n = int(case[1])
        r = np.arange(n)
        c = np.maximum(r - 1, 0)            # a path (and the diagonal at 0)
    else:
        n, r, c = _shuffled_grid((16, 16), 5)
        kw = {"levels": 3} if case == "levels3" else {"method": case}
    _same_ordering(tnd.nested_dissection_graph(n, r, c, **kw),
                   jnd.nested_dissection_graph(n, r, c, native=False, **kw))


def test_md_thresholds_are_keywords():
    """md_small / md_max gate the minimum-degree candidate as the JAX
    package's environment knobs do."""
    n, r, c = _shuffled_grid((16, 16), 6)
    info = {}
    tnd.nested_dissection_graph(n, r, c, md_small=10, info=info)
    assert not info["md_tried"]
    tnd.nested_dissection_graph(n, r, c, md_max=10, info=info)
    assert not info["md_tried"]
    tnd.nested_dissection_graph(n, r, c, info=info)
    assert info["md_tried"] and info["nd_flops"] > 0 and info["md_flops"] > 0


@pytest.mark.parametrize("name", ["random", "circuit", "imbalanced",
                                  "aniso3d"])
def test_min_degree_and_tree_match_jax(name):
    n, r, c, _ = jproblems.make_gallery(1)[name]()
    perm = tmd.min_degree_perm(n, r, c)
    assert np.array_equal(perm, jmd.min_degree_perm(n, r, c, native=False))
    assert np.array_equal(perm, jmd.min_degree_perm(n, r, c))
    assert np.array_equal(tmd.etree(n, r, c, perm), jmd.etree(n, r, c, perm))
    levels = 5
    dofs = tmd.tree_from_elimination(n, r, c, perm, levels)
    ref = jmd.tree_from_elimination(n, r, c, perm, levels)
    assert sorted(dofs) == sorted(ref)
    for h in dofs:
        assert np.array_equal(dofs[h], ref[h])
    tmd.check_separator_tree(n, r, c, dofs, levels)
    assert tq.permuted_cost(n, r, c, perm) == jq.permuted_cost(n, r, c, perm)
    assert tq.fill_flops(n, r, c) == jq._fill_flops_python(n, r, c)


def test_min_degree_exact_matches_jax():
    n, r, c = _shuffled_grid((10, 10), 7)
    assert np.array_equal(tmd.min_degree_perm(n, r, c, exact=True),
                          jmd.min_degree_perm(n, r, c, exact=True))


def test_check_separator_tree_rejects_a_crossing_edge():
    n, r, c = _shuffled_grid((8, 8), 8)
    perm = tmd.min_degree_perm(n, r, c)
    dofs = tmd.tree_from_elimination(n, r, c, perm, 3)
    a, b = dofs[4], dofs[7]                 # leaves of different subtrees
    assert len(a) and len(b)
    with pytest.raises(AssertionError, match="crosses"):
        tmd.check_separator_tree(n, np.append(r, a[0]), np.append(c, b[0]),
                                 dofs, 3)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("name", ["random", "circuit", "aniso3d",
                                  "elasticity"])
def test_engines_identical_to_jax(name, engine):
    """Each engine of the port (its native core, `native=False`'s Python
    paths) against the JAX package's same engine: identical orderings,
    minimum-degree permutations and FLOP counts, and `info["engine"]`
    names the one that ran."""
    native = engine == "native"
    n, r, c, _ = jproblems.make_gallery(1)[name]()
    info = {}
    port = tnd.nested_dissection_graph(n, r, c, info=info, native=native)
    assert info["engine"] == engine and info["order_s"] > 0
    _same_ordering(port, jnd.nested_dissection_graph(n, r, c, native=native))
    perm = tmd.min_degree_perm(n, r, c, native=native)
    assert np.array_equal(perm, jmd.min_degree_perm(n, r, c, native=native))
    assert tq.permuted_cost(n, r, c, perm, native=native) \
        == jq.permuted_cost(n, r, c, perm)
    with pytest.raises(IndexError):
        tnd.nested_dissection_graph(5, np.arange(1, 6), np.arange(5),
                                    levels=2, native=native)

"""The port's ordering-quality costs (`symbolic/quality.py`: `nd_cost`,
`rcm_cost`, `superlu_cost`) against the JAX package's on the CPU, and the
quality bands tests/test_nd.py and tests/test_mdtree.py hold the JAX
package's orderings to, for the port's.

FLOPs and nnz(L) must be equal, not close: both packages order the same
pattern identically (tests/test_torch_ordering.py) and count its fill with
the same exact symbolic elimination."""

import numpy as np
import pytest

from cholesky_tpu.symbolic import quality as jquality
from cholesky_tpu.utils import problems as jproblems
from cholesky_tpu_torch.symbolic import mdtree, quality
from cholesky_tpu_torch.utils import problems

GALLERY = problems.make_gallery(1)


@pytest.mark.parametrize("name", sorted(GALLERY))
def test_costs_equal_the_jax_package(name):
    n, r, c, v = GALLERY[name]()
    jn, jr, jc, jv = jproblems.make_gallery(1)[name]()
    assert jn == n and np.array_equal(jr, r) and np.array_equal(jc, c)
    assert quality.nd_cost(n, r, c) == jquality.nd_cost(n, r, c)
    assert (quality.nd_cost(n, r, c, levels=8)
            == jquality.nd_cost(n, r, c, levels=8))
    assert quality.rcm_cost(n, r, c, v) == jquality.rcm_cost(n, r, c, v)
    for spec in ("MMD_AT_PLUS_A", "COLAMD"):
        assert (quality.superlu_cost(n, r, c, v, spec)
                == jquality.superlu_cost(n, r, c, v, spec)), spec


def test_nd_vs_rcm_on_irregular_graphs():
    """tests/test_nd.py::test_nd_vs_rcm_on_irregular_graphs for the
    port: the deep ND ordering beats RCM by at least the banded margin."""
    bands = {"random": 0.75, "circuit": 0.70,
             "dense_rows": 0.25, "imbalanced": 0.60}
    for name, band in bands.items():
        n, r, c, v = problems.GALLERY[name]()
        f_nd, _ = quality.nd_cost(n, r, c, levels=8)
        f_rcm, _ = quality.rcm_cost(n, r, c, v)
        assert f_nd <= band * f_rcm, (name, f_nd / f_rcm)


def test_nd_vs_mmd_bands():
    """tests/test_nd.py::test_nd_vs_mmd_bands for the port: within the
    bands of SuperLU's MMD_AT_PLUS_A."""
    bands = {"aniso2d": 1.30, "random": 1.10, "circuit": 1.10,
             "dense_rows": 1.20, "imbalanced": 1.35}
    for name, band in bands.items():
        n, r, c, v = problems.GALLERY[name]()
        f_nd, _ = quality.nd_cost(n, r, c, levels=8)
        f_mmd, _ = quality.superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        assert f_nd <= band * f_mmd, (name, f_nd / f_mmd)


def test_nd_vs_mmd_3d_scaling():
    """tests/test_nd.py::test_nd_vs_mmd_3d_scaling for the port: on 3-D
    problems deep ND beats MMD, by more as n grows."""
    ratios = {}
    for scale in (1, 2):
        n, r, c, v = problems.make_gallery(scale)["aniso3d"]()
        f_nd, _ = quality.nd_cost(n, r, c, levels=8)
        f_mmd, _ = quality.superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        ratios[scale] = f_nd / f_mmd
    assert ratios[1] <= 0.85, ratios
    assert ratios[2] <= 0.55, ratios
    assert ratios[2] < ratios[1], ratios


def test_md_quality_near_superlu_mmd():
    """tests/test_mdtree.py::test_md_quality_near_superlu_mmd for the
    port's minimum degree: within 10% of SuperLU's MMD."""
    for name in ("random", "circuit"):
        n, r, c, v = problems.GALLERY[name]()
        md = mdtree.min_degree_perm(n, r, c)
        f_md, _ = quality.permuted_cost(n, r, c, md)
        f_mmd, _ = quality.superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        assert f_md <= 1.10 * f_mmd, (name, f_md / f_mmd)


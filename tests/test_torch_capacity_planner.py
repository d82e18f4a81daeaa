"""The port's copy of the capacity planner (`cholesky_tpu_torch/utils/
capacity.py`) against `cholesky_tpu/utils/capacity.py` on the same plans:
each estimator gives the same number (exactly: the same integer and float
arithmetic on identical plans), `grid_plan_table` the same rows and
`main` the same printed table. The plans: grids of the repo's nested
dissection in 2-D and 3-D, and a gallery matrix ordered through
`from_matrix`."""

import numpy as np
import pytest

import cholesky_tpu
from cholesky_tpu.utils import capacity as jcap
from cholesky_tpu.utils import problems
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.utils import capacity as tcap

PLANS = {"grid 20^2 L5": ((20, 20), 5), "grid 6^3 L3": ((6, 6, 6), 3),
         "grid 15^3 L5": ((15, 15, 15), 5), "gallery wathen": None}


def _solvers(name):
    if PLANS[name] is None:
        n, r, c, v = problems.make_gallery(1)["wathen"]()
        return (cholesky_tpu.SparseCholesky.from_matrix(n, r, c, v),
                SparseCholesky.from_matrix(n, r, c, v, device="cpu"))
    n, r, c, v, o, cl, _ = generate_problem(*PLANS[name])
    return (cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl),
            SparseCholesky.from_coo(n, r, c, v, o, cl, device="cpu"))


@pytest.mark.parametrize("name", list(PLANS))
def test_estimators_equal_the_jax_module(name):
    js, ts = _solvers(name)
    assert np.array_equal(ts.plan.perm, js.plan.perm)
    assert tcap.frontal_flops(ts.fplan) == jcap.frontal_flops(js.fplan)
    assert tcap.plan_flops(ts.plan) == jcap.plan_flops(js.plan)
    for nbytes in (4, 8):
        assert (tcap.plan_memory_bytes(ts.plan, nbytes)
                == jcap.plan_memory_bytes(js.plan, nbytes))
        assert (tcap.selinv_memory_bytes(ts.fplan, nbytes)
                == jcap.selinv_memory_bytes(js.fplan, nbytes))
    useful = 0.4 * jcap.frontal_flops(js.fplan)
    assert (tcap.padding_efficiency(ts.fplan, useful)
            == jcap.padding_efficiency(js.fplan, useful))
    assert tcap.frontal_flops(ts.fplan) > 0


@pytest.mark.parametrize("dim", [50, 64, 65, 1000, 125000])
def test_depth_leaf_size_subregions(dim):
    for max_size in (16, 64):
        assert tcap.depth(dim, max_size) == jcap.depth(dim, max_size)
    lv = tcap.depth(dim)
    assert tcap.leaf_size(dim, lv) == jcap.leaf_size(dim, lv)
    assert tcap.subregions(lv) == jcap.subregions(lv)


@pytest.mark.parametrize("shape", [(20, 20), (12, 12, 12)])
def test_grid_plan_table_equals_the_jax_module(shape):
    assert tcap.grid_plan_table(shape) == jcap.grid_plan_table(shape)
    assert (tcap.grid_plan_table(shape, range(2, 5), dtype_bytes=8)
            == jcap.grid_plan_table(shape, range(2, 5), dtype_bytes=8))


def test_main_prints_the_jax_modules_table(capsys):
    assert tcap.main(["16,16,16"]) == 0
    port = capsys.readouterr().out
    assert jcap.main(["16,16,16"]) == 0
    assert port == capsys.readouterr().out
    assert port.splitlines()[0].split() == [
        "levels", "leaf_dofs", "separators", "panel_GiB", "dense_GFLOP"]

"""Private copies of the conftest fixtures for the port's tests.

`tests/conftest.py` writes generated fixtures into one shared directory and
rewrites all four files of a fixture whenever the last one is missing, so
under several pytest-xdist workers one worker can truncate a file while
another reads it. The port's tests take their fixtures from `port_fixtures`
instead: the reference checkout when it is mounted, otherwise the same
`generate_problem` fixtures written into a directory of this worker's own
(`tmp_path_factory`), which no other worker writes.

Use: `from tests.test_torch_fixtures import port_fixtures` in a test module,
then take `port_fixtures` as a test argument and call it with a fixture
name.
"""

import numpy as np
import pytest

from cholesky_tpu.io import mmio, ordering as ordio
from cholesky_tpu.utils.laplacian import generate_problem
from tests.conftest import (FIXTURES, HAS_REFERENCE, REFERENCE_TESTS,
                            _GENERATED_SPECS)


def _write_fixture(d, name):
    """The conftest fixture `name`, generated into directory d."""
    mtx, ordf, clustf, bf = FIXTURES[name]
    d.mkdir(parents=True, exist_ok=True)
    shape, levels = _GENERATED_SPECS[name]
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    mmio.write_coo(str(d / mtx), r, c, v, (n, n), symmetry="hermitian")
    ordio.write_ordering(str(d / ordf), o)
    ordio.write_clusters(str(d / clustf), cl)
    with open(d / bf, "w") as f:
        f.write("%%MatrixMarket matrix array integer general\n%\n")
        f.write(f"{n} 1\n")
        for x in b.astype(int):
            f.write(f"{x}\n")


@pytest.fixture(scope="session")
def port_fixtures(tmp_path_factory):
    """name -> {"mat", "separators", "clusters", "b"}: paths that no other
    test worker writes."""
    root = None if HAS_REFERENCE else tmp_path_factory.mktemp("fixtures")
    made = {}

    def paths(name):
        mtx, ordf, clustf, bf = FIXTURES[name]
        if root is None:
            d = REFERENCE_TESTS / name
        else:
            d = root / name
            if name not in made:
                _write_fixture(d, name)
                made[name] = True
        return {"mat": str(d / mtx), "separators": str(d / ordf),
                "clusters": str(d / clustf), "b": str(d / bf)}

    return paths


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_private_fixture_is_complete(port_fixtures, name):
    p = port_fixtures(name)
    banner, r, c, v = mmio.read_coo(p["mat"])
    o = ordio.parse_ordering(p["separators"])
    b = mmio.read_array(p["b"]).reshape(-1)
    assert banner.rows == banner.cols == b.shape[0]
    assert sum(len(x) for x in o.dofs.values()) == banner.rows
    assert ordio.parse_clusters(p["clusters"]) is not None
    assert len(v) and np.all(np.isfinite(v))

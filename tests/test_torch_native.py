"""The port's native host core (`cholesky_tpu_torch/native/`) against the JAX
package's (`cholesky_tpu.native.ext`) on the same seeded inputs: every
binding gives identical integers, orderings and bytes (np.array_equal,
no tolerance), and the guards raise as there. Mirrors tests/test_native.py.

Both libraries are loaded in this one process, each with ctypes' default
RTLD_LOCAL, so neither one's C symbols reach the other.
"""

import ctypes
import math
import os
import warnings

import numpy as np
import pytest

from cholesky_tpu.native import ext as jext
from cholesky_tpu.numeric import assemble as jasm
from cholesky_tpu.symbolic import fill as jfill
from cholesky_tpu.symbolic.plan import build_plan as jbuild_plan
from cholesky_tpu.utils import problems as jproblems
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch.io import mmio, ordering as ordio
from cholesky_tpu_torch.native import build, ext
from cholesky_tpu_torch.symbolic import fill as tfill
from cholesky_tpu_torch.symbolic.plan import build_plan
from cholesky_tpu_torch.utils.laplacian import generate_problem as tgenerate_problem
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

KEYS = [0, 1, 7, 12345, 2**40 + 17, 2**63 - 1,
        *np.random.default_rng(0).integers(0, 2**63 - 1, 4).tolist()]
HASHES = ("hash_sax", "hash_fnv", "hash_ber", "hash_oat", "hash_jen",
          "hash_sfh")


def _shuffled(shape, seed):
    n, r, c, _, _, _, _ = generate_problem(shape, 2)
    p = np.random.default_rng(seed).permutation(n)
    return n, np.maximum(p[r], p[c]), np.minimum(p[r], p[c])


def test_library_builds_into_the_hashed_build_dir():
    assert ext.available() and ext.build_error() is None
    lib = build.library_path()
    assert os.path.dirname(lib) == build.BUILD_DIR
    assert os.path.basename(lib).startswith("libmndio_")
    assert os.path.exists(lib)
    assert build.build() == lib and build.BUILD_INFO["cached"]
    # the copy is the JAX package's source, byte for byte
    jsrc = os.path.join(os.path.dirname(jext.__file__), "src", "mndio.cc")
    assert open(build.SRC, "rb").read() == open(jsrc, "rb").read()


def test_both_libraries_stay_out_of_the_global_namespace():
    assert ext.available()
    jext.hash_sax(1)
    with pytest.raises(AttributeError):
        ctypes.CDLL(None).mnd_hash_sax     # RTLD_LOCAL: not global


@pytest.mark.parametrize("key", KEYS)
def test_hash_functions_match_jax(key):
    for name in HASHES:
        assert getattr(ext, name)(key) == getattr(jext, name)(key), name


def test_read_coo_body_three_columns_matches_jax(port_fixtures):
    p = port_fixtures("lapl_400x400")["mat"]
    banner = mmio.read_banner(p)
    got = ext.read_coo_body(p, banner.nnz)
    want = jext.read_coo_body(p, banner.nnz)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    _, r, c, v = mmio.read_coo(p, native=False)
    assert np.array_equal(got[0], r) and np.array_equal(got[1], c)
    assert np.array_equal(got[2], v)


def test_read_coo_body_pattern_two_columns(tmp_path):
    p = str(tmp_path / "pat.mtx")
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n"
                "4 4 3\n3 1\n4 2\n4 4\n")
    r, c, v = ext.read_coo_body(p, 3)
    assert r.tolist() == [2, 3, 3] and c.tolist() == [0, 1, 3]
    assert v.tolist() == [1.0, 1.0, 1.0]
    for x, y in zip((r, c, v), jext.read_coo_body(p, 3)):
        assert np.array_equal(x, y)
    with pytest.raises(IOError, match="expected 4"):
        ext.read_coo_body(p, 4)
    with pytest.raises(IOError, match="cannot read"):
        ext.read_coo_body(str(tmp_path / "missing.mtx"), 3)


def test_write_coo_round_trip_and_bytes(tmp_path):
    rng = np.random.default_rng(1)
    rows = np.sort(rng.integers(0, 50, 200)).astype(np.int64)
    cols = rng.integers(0, 50, 200).astype(np.int64)
    vals = rng.standard_normal(200) * 10.0 ** rng.integers(-20, 20, 200)
    vals[:3] = [1.5, -2.25, 1e-17]
    banner = "%%MatrixMarket matrix coordinate real hermitian"
    files = {k: str(tmp_path / f"{k}.mtx") for k in ("t", "j", "py", "auto")}
    ext.write_coo(files["t"], banner, 50, 50, rows, cols, vals)
    jext.write_coo(files["j"], banner, 50, 50, rows, cols, vals)
    mmio.write_coo(files["py"], rows, cols, vals, (50, 50), native=False)
    mmio.write_coo(files["auto"], rows, cols, vals, (50, 50))
    texts = {k: open(f).read() for k, f in files.items()}
    assert texts["t"] == texts["j"] == texts["py"] == texts["auto"]
    banner_, r, c, v = mmio.read_coo(files["t"])
    assert (banner_.rows, banner_.nnz) == (50, 200)
    assert np.array_equal(r, rows) and np.array_equal(c, cols)
    assert np.array_equal(v, vals)
    with pytest.raises(IOError, match="cannot write"):
        ext.write_coo(str(tmp_path / "no" / "dir.mtx"), banner, 1, 1,
                      rows[:1], cols[:1], vals[:1])
    with pytest.raises(ValueError, match="differ in length"):
        ext.write_coo(files["t"], banner, 50, 50, rows[:5], cols, vals)


def test_hash_table_matches_jax(port_fixtures):
    p = port_fixtures("lapl_25x25")["mat"]
    banner, r, c, v = mmio.read_coo(p)
    cap = int(math.ceil(banner.nnz / 0.75))          # mmat.rg:1125
    ti, tv = ext.build_hash_table(r, c, v, banner.cols, cap)
    jti, jtv = jext.build_hash_table(r, c, v, banner.cols, cap)
    assert np.array_equal(ti, jti) and np.array_equal(tv, jtv)
    for i, j, val in zip(r, c, v):
        assert ext.hash_lookup(ti, tv, banner.cols, int(i), int(j)) == val
    assert ext.hash_lookup(ti, tv, banner.cols, 0, 24) == 0.0


def test_hash_table_capacity_guard():
    r = np.array([0, 1, 2], dtype=np.int64)
    v = np.array([1.0, 2.0, 3.0])
    ti, tv = ext.build_hash_table(r, r, v, 3)        # ceil(3 / 0.75) = 4
    assert len(tv) == 4 and ext.hash_lookup(ti, tv, 3, 2, 2) == 3.0
    for cap in (3, 0):          # a full table would probe forever
        with pytest.raises(ValueError, match="must exceed"):
            ext.build_hash_table(r, r, v, 3, capacity=cap)


@pytest.mark.parametrize("case", ["lapl_9x9", "generated"])
def test_assemble_panels_matches_jax(case, port_fixtures):
    if case == "generated":
        n, r, c, v, o, cl, _ = tgenerate_problem((13, 11, 7), 5)
    else:
        p = port_fixtures(case)
        o = ordio.parse_ordering(p["separators"])
        _, r, c, v = mmio.read_coo(p["mat"])
    plan, jplan = build_plan(o), jbuild_plan(o)
    panels = jasm.empty_panels(jplan, dtype=np.float64)   # identity padding
    ext.assemble_panels(r, c, v, plan.sep_of_dof, plan.loc_of_dof,
                        plan.num_separators, plan.levels, plan.row_off,
                        panels)
    want = jasm.assemble_panels_numpy(jplan, r, c, v)
    native = jasm.assemble_panels(jplan, r, c, v)
    for a, b, d in zip(panels, want, native):
        assert np.array_equal(a, b) and np.array_equal(a, d)


@pytest.mark.parametrize("shape,levels", [((20, 20), 5), ((13, 11, 7), 5),
                                          ((9, 9, 9), 4)])
def test_fill_initial_and_analyze_match_jax(shape, levels):
    """fill_initial + fill_analyze through both packages' native fill
    analyses: the same blocks, bounds and filled flags at every label."""
    n, r, c, v, o, cl, _ = tgenerate_problem(shape, levels)
    jn, jr, jc, jv, jo, jcl, _ = generate_problem(shape, levels)
    calls = dict(ext.CALLS)
    fa = tfill._analyze_fill_native(build_plan(o, cl), r, c, v)
    assert ext.CALLS["fill_initial"] == calls.get("fill_initial", 0) + 1
    assert ext.CALLS["fill_analyze"] == calls.get("fill_analyze", 0) + 1
    ja = jfill._analyze_fill_native(jbuild_plan(jo, jcl), jr, jc, jv)
    assert fa.engine == "native" and len(fa.snapshots) == len(ja.snapshots)
    for sp, sj in zip(fa.snapshots, ja.snapshots):
        assert list(sp) == list(sj)
        for k in sp:
            for f in ("filled", "row_bounds", "col_bounds"):
                assert np.array_equal(getattr(sp[k], f), getattr(sj[k], f))


@pytest.mark.parametrize("threads", [1, 4])
def test_nd_order_matches_jax(threads):
    """Above 2^16 vertices a depth is split across threads; the output is
    the serial one for every thread count."""
    n, r, c = _shuffled((42, 42, 42), 3)
    got = ext.nd_order(n, r, c, 8, threads=threads)
    assert np.array_equal(got, jext.nd_order(n, r, c, 8, threads=1))
    assert got.min() == 1 and got.max() == 255


def test_nd_order_default_threads_small_graphs():
    for shape, levels, seed in (((20, 20), 5, 1), ((9, 10, 11), 6, 2)):
        n, r, c = _shuffled(shape, seed)
        assert np.array_equal(ext.nd_order(n, r, c, levels),
                              jext.nd_order(n, r, c, levels, threads=1))


@pytest.mark.parametrize("name", ["random", "circuit", "imbalanced"])
def test_md_order_matches_jax(name):
    n, r, c, _ = jproblems.make_gallery(1)[name]()
    assert np.array_equal(ext.md_order(n, r, c), jext.md_order(n, r, c))


def test_col_counts_match_jax():
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(12):                       # random sparse patterns
        n = int(rng.integers(4, 80))
        m = int(rng.integers(n, 5 * n))
        cases.append((n, rng.integers(0, n, m), rng.integers(0, n, m)))
    for name in ("random", "circuit", "wathen", "imbalanced"):
        n, r, c, _ = jproblems.make_gallery(1)[name]()
        cases.append((n, r, c))
    for n, r, c in cases:
        assert np.array_equal(ext.col_counts(n, r, c),
                              jext.col_counts(n, r, c))


@pytest.mark.parametrize("fn", ["nd_order", "md_order", "col_counts"])
def test_one_based_indices_raise(fn):
    rows = np.array([1, 2, 3, 4, 5])
    cols = np.array([0, 1, 2, 3, 4])
    args = (5, rows, cols) + ((2,) if fn == "nd_order" else ())
    with pytest.raises(IndexError, match="0-based"):
        getattr(ext, fn)(*args)
    with pytest.raises(IndexError):
        getattr(jext, fn)(*args)


def test_unbuildable_library_warns_once_and_never_falls_back_unseen(
        monkeypatch):
    """A failed build: one RuntimeWarning with the compiler's message, the
    auto-selected paths report the Python engine, native=True raises."""
    from cholesky_tpu_torch.symbolic import nd

    def fail():
        raise RuntimeError("g++ failed for mndio.cc (1):\nerror: boom")

    monkeypatch.setattr(ext, "_LIB", None)
    monkeypatch.setattr(ext, "_ERROR", None)
    monkeypatch.setattr(build, "build", fail)
    with pytest.warns(RuntimeWarning, match="error: boom"):
        assert not ext.available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not ext.available() and "boom" in ext.build_error()
        assert ext.use_native(None) is False
        assert ext.use_native(False) is False
        with pytest.raises(RuntimeError, match="boom"):
            ext.use_native(True)
        with pytest.raises(RuntimeError, match="boom"):
            ext.hash_sax(1)
        n, r, c = _shuffled((9, 9), 4)
        info = {}
        nd.nested_dissection_graph(n, r, c, info=info)
        assert info["engine"] == "python"

"""The port's cluster fill analysis, schedule, structure log and replay oracle
(`cholesky_tpu_torch/symbolic/fill.py`, `verify/`) against the JAX
package's on the same inputs: identical snapshots on both engines, the same
schedule Op for Op, a byte-identical log and dumps, `debug_factor` accepting
either package's output, and the port's f64 factor against the replay.
Mirrors tests/test_fill_replay.py on the lapl 9x9 / 25x25 / 400x400
stand-ins and one gallery matrix through `from_matrix`."""

import dataclasses
import os

import numpy as np
import pytest
import scipy.linalg

import cholesky_tpu
from cholesky_tpu.io import mmio as jmmio
from cholesky_tpu.symbolic import fill as jfill
from cholesky_tpu.symbolic.plan import permute_matrix_dense as jpermute
from cholesky_tpu.utils import problems as jproblems
from cholesky_tpu.verify import debuglog as jdebuglog, replay as jreplay
from cholesky_tpu.verify import schedule as jschedule
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.io import mmio
from cholesky_tpu_torch.symbolic import fill
from cholesky_tpu_torch.symbolic.plan import permute_matrix_dense
from cholesky_tpu_torch.verify import debuglog, replay, schedule
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

NAMES = ["lapl_9x9", "lapl_25x25", "lapl_400x400"]
REPLAY_TOL = 1e-12        # f64 replay vs SciPy's Cholesky
FACTOR_TOL = 1e-11        # the port's f64 factor vs the replay
ORACLE_TOL = 1e-10        # debug_factor's rtol / atol


def _setup(p):
    """(port solver, JAX solver, permuted dense matrix) of fixture p."""
    s = SparseCholesky.from_files(p["mat"], p["separators"], p["clusters"],
                                  device="cpu")
    js = cholesky_tpu.SparseCholesky.from_files(p["mat"], p["separators"],
                                                p["clusters"])
    pmat = permute_matrix_dense(s.plan, mmio.read_dense(p["mat"]))
    assert np.array_equal(pmat, jpermute(js.plan, jmmio.read_dense(p["mat"])))
    return s, js, pmat


def _same_fill(a, b):
    assert len(a.snapshots) == len(b.snapshots)
    for sa, sb in zip(a.snapshots, b.snapshots):
        assert list(sa) == list(sb)
        for k in sa:
            for f in ("filled", "row_bounds", "col_bounds"):
                assert np.array_equal(getattr(sa[k], f), getattr(sb[k], f))


def _ops(ops):
    return [dataclasses.astuple(op) for op in ops]


def _logs(s, js, d):
    """Both packages' fill analyses, schedules and logs under directory d."""
    fa = fill.analyze_fill(s.plan, s.rows, s.cols, s.vals)
    ja = jfill.analyze_fill(js.plan, js.rows, js.cols, js.vals)
    ops, jops = schedule.generate_schedule(fa), jschedule.generate_schedule(ja)
    log = debuglog.write_structure_log(s.plan, str(d / "t"), fa, ops)
    jlog = jdebuglog.write_structure_log(js.plan, str(d / "j"), ja, jops)
    return fa, ja, ops, jops, log, jlog


@pytest.mark.parametrize("name", NAMES)
def test_fill_analysis_engines_match_jax(name, port_fixtures):
    s, js, _ = _setup(port_fixtures(name))
    native = fill.analyze_fill(s.plan, s.rows, s.cols, s.vals)
    python = fill.analyze_fill(s.plan, s.rows, s.cols, s.vals, native=False)
    assert (native.engine, python.engine) == ("native", "python")
    _same_fill(native, python)
    _same_fill(native, jfill.analyze_fill(js.plan, js.rows, js.cols,
                                          js.vals))
    assert [native.interval_for_level(lvl) for lvl in range(s.plan.levels)] \
        == [max(0, s.plan.levels - 2 - lvl) for lvl in range(s.plan.levels)]


@pytest.mark.parametrize("name", NAMES)
def test_schedule_and_log_match_jax(name, port_fixtures, tmp_path):
    s, js, _ = _setup(port_fixtures(name))
    fa, ja, ops, jops, log, jlog = _logs(s, js, tmp_path)
    assert _ops(ops) == _ops(jops) and len(ops) > 0
    assert schedule.schedule_flops(ops) == jschedule.schedule_flops(jops)
    root_n = int(s.plan.sep_sizes[s.plan.num_separators])
    assert schedule.schedule_flops(ops) > root_n ** 3 / 3.0
    assert os.path.basename(log) == "output"
    assert open(log, "rb").read() == open(jlog, "rb").read()
    blocks, clusters, parsed = replay.parse_log(log)
    assert len(parsed) == len(ops) and blocks and clusters
    assert parsed == jreplay.parse_log(jlog)[2]


@pytest.mark.parametrize("name", NAMES)
def test_replay_matches_scipy_and_the_port_factor(name, port_fixtures,
                                                  tmp_path):
    s, js, pmat = _setup(port_fixtures(name))
    _, _, ops, _, log, _ = _logs(s, js, tmp_path)
    replayed = replay.replay_schedule(pmat, ops)
    lref = scipy.linalg.cholesky(pmat + np.tril(pmat, -1).T, lower=True)
    assert np.allclose(np.tril(replayed), lref, rtol=REPLAY_TOL,
                       atol=REPLAY_TOL)
    assert np.array_equal(replay.replay_log(pmat, log), replayed)
    s.factorize()
    assert np.allclose(s.factor_dense(), np.tril(replayed), rtol=FACTOR_TOL,
                       atol=FACTOR_TOL)


def _dumps(s, pmat, ops, d):
    replay.replay_schedule(pmat, ops, dump_dir=d)
    s.factorize()
    fr, fc, fv = s.factor_coo()
    fac = os.path.join(d, "factored.mtx")
    mmio.write_coo(fac, fr, fc, fv, (s.plan.n, s.plan.n))
    return fac


@pytest.mark.parametrize("name", ["lapl_25x25", "lapl_400x400"])
def test_debug_factor_crosses_both_ways(name, port_fixtures, tmp_path):
    """The port's log and dumps pass the JAX package's debug_factor, and
    the JAX package's pass the port's; the dumps are the same files."""
    p = port_fixtures(name)
    s, js, pmat = _setup(p)
    _, _, ops, jops, log, jlog = _logs(s, js, tmp_path)
    tdir, jdir = os.path.dirname(log), os.path.dirname(jlog)
    fac = _dumps(s, pmat, ops, tdir)
    jreplay.replay_schedule(pmat, jops, dump_dir=jdir)
    jfr, jfc, jfv = js.factor_coo()
    jfac = os.path.join(jdir, "factored.mtx")
    jmmio.write_coo(jfac, jfr, jfc, jfv, (js.plan.n, js.plan.n))
    dumps = sorted(f for f in os.listdir(tdir) if f.endswith("mtx")
                   and f != "factored.mtx")
    assert dumps and dumps == sorted(
        f for f in os.listdir(jdir) if f.endswith("mtx")
        and f != "factored.mtx")
    assert dumps == sorted({replay.op_dump_filename(op) for op in ops})
    for f in dumps:
        assert open(os.path.join(tdir, f), "rb").read() == open(
            os.path.join(jdir, f), "rb").read(), f
    kw = dict(rtol=ORACLE_TOL, atol=ORACLE_TOL)
    assert jreplay.debug_factor(p["mat"], p["separators"], fac, log,
                                directory=tdir, **kw)
    assert replay.debug_factor(p["mat"], p["separators"], jfac, jlog,
                               directory=jdir, **kw)
    assert replay.debug_factor(p["mat"], p["separators"], fac, log,
                               directory=tdir, **kw)


def test_debug_factor_catches_corruption(port_fixtures, tmp_path):
    """The oracle fails when a dump is corrupted (the bisection bisects)."""
    p = port_fixtures("lapl_9x9")
    s, js, pmat = _setup(p)
    _, _, ops, _, log, _ = _logs(s, js, tmp_path)
    dbg = os.path.dirname(log)
    fac = _dumps(s, pmat, ops, dbg)
    victim = next(f for f in sorted(os.listdir(dbg)) if f.startswith("potrf"))
    path = os.path.join(dbg, victim)
    txt = open(path).read().splitlines()
    txt[-1] = txt[-1].rsplit(" ", 1)[0] + " 999.0"
    open(path, "w").write("\n".join(txt) + "\n")
    for oracle in (replay, jreplay):
        with pytest.raises(AssertionError, match="diverges"):
            oracle.debug_factor(p["mat"], p["separators"], fac, log,
                                directory=dbg)


def test_gallery_matrix_through_from_matrix(tmp_path):
    """A matrix with no ordering files: the port's from_matrix (native
    ordering) and the JAX package's give the same plan, fill, schedule and
    log; the port's factor matches the replay."""
    n, r, c, v = jproblems.make_gallery(1)["wathen"]()
    s = SparseCholesky.from_matrix(n, r, c, v, device="cpu")
    js = cholesky_tpu.SparseCholesky.from_matrix(n, r, c, v)
    assert s.ordering_info["engine"] == "native"
    assert np.array_equal(s.plan.perm, js.plan.perm)
    fa, ja, ops, jops, log, jlog = _logs(s, js, tmp_path)
    _same_fill(fa, ja)
    assert _ops(ops) == _ops(jops)
    assert open(log, "rb").read() == open(jlog, "rb").read()
    replayed = replay.replay_schedule(s.permuted_dense(), ops)
    s.factorize()
    assert np.allclose(s.factor_dense(), np.tril(replayed), rtol=FACTOR_TOL,
                       atol=FACTOR_TOL)

"""The port's panel-engine stage profiler (`numeric/profile.profile_factor`)
against the JAX package's (`cholesky_tpu/numeric/profile.py:163-253`) on
the CPU, on panels from each package's `assemble_panels`: the same record
sequence (op / level / batch / n / m / k), reference-format lines that
`ast.literal_eval` reads, the assertions of tests/test_utils_profile.py's
`test_profile_panels_emits`, and the caller's panels (NumPy or tensors)
left bit-identical."""

import ast
import functools

import numpy as np
import pytest
import torch

import cholesky_tpu
from cholesky_tpu.numeric import assemble as jassemble
from cholesky_tpu.numeric import profile as jprofile
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import SparseCholesky
from cholesky_tpu_torch.numeric import assemble as tassemble
from cholesky_tpu_torch.numeric import factor as tfactor
from cholesky_tpu_torch.numeric import profile as tprofile

KEYS = ("op", "level", "batch", "n", "m", "k")
CASES = {"10x10-L3-f32": ((10, 10), 3, np.float32),
         "8x8x8-L4-f64": ((8, 8, 8), 4, np.float64)}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port solver, the port's assembled NumPy panels, the JAX records)."""
    shape, levels, dtype = CASES[name]
    n, r, c, v, o, cl, _ = generate_problem(shape, levels)
    ts = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                 device="cpu")
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
    jpanels = jassemble.assemble_panels(js.plan, js.rows, js.cols, js.vals,
                                        dtype=dtype)
    jrecs = jprofile.profile_factor(js.plan, jpanels, iters=1,
                                    emit=lambda line: None)
    panels = tassemble.assemble_panels(ts.plan, ts.rows, ts.cols, ts.vals,
                                       dtype=dtype)
    return ts, panels, tuple(jrecs)


def _key(rec):
    return tuple(rec.get(k) for k in KEYS)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_profile_factor_matches_jax(name, kind):
    ts, host, jrecs = _case(name)
    panels = ([p.copy() for p in host] if kind == "numpy"
              else [torch.from_numpy(p.copy()) for p in host])
    before = [np.array(p, copy=True) for p in panels]
    lines = []
    recs = tprofile.profile_factor(ts.plan, panels, iters=1,
                                   emit=lines.append, device="cpu")
    assert [_key(r) for r in recs] == [_key(r) for r in jrecs]
    # tests/test_utils_profile.py::test_profile_panels_emits
    assert any(rec["op"] == "POTRF" for rec in recs)
    assert len(lines) == len(recs)
    for line in lines:
        assert line.startswith("BLAS: {")
        d = ast.literal_eval(line[len("BLAS: "):])
        assert "op" in d and "Time" in d
    assert [ast.literal_eval(line[6:])["op"] for line in lines] == [
        "GEMM" if r["op"] == "UPDATE" else r["op"] for r in recs]
    for rec in recs:
        assert rec["time_us"] >= 0 and rec["gflops"] >= 0
    for p, b in zip(panels, before):
        assert np.array_equal(np.asarray(p), b)     # the caller's, untouched


def test_profile_factor_stages_are_the_oracle_factorization(monkeypatch):
    """The stages factor a working copy exactly as `factor_panels` does:
    capture the copy the profiler factors and compare it with the oracle's
    factor of the same panels, bit for bit."""
    ts, host, _ = _case("8x8x8-L4-f64")
    seen = []
    real = tfactor._on

    def spy(arrays, device, copy=False):
        out = real(arrays, device, copy)
        seen.append(out)
        return out

    monkeypatch.setattr(tfactor, "_on", spy)
    tprofile.profile_factor(ts.plan, host, iters=1, emit=lambda line: None,
                            device="cpu")
    ref = tfactor.factor_panels(ts.plan, [torch.from_numpy(p.copy())
                                          for p in host])
    for got, want in zip(seen[0], ref):
        assert torch.equal(got, want)


def test_profile_factor_needs_a_card_for_cuda():
    ts, host, _ = _case("10x10-L3-f32")
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        tprofile.profile_factor(ts.plan, host, emit=lambda line: None)

"""Factor checkpoints across the two packages: `save_factor` / `load_factor`
of the port against the JAX package's, on the CPU. Both write the same
`.npz` layout (version 2: per-level panels, bf16 levels as uint16 bit
patterns, a sha256 fingerprint of matrix, ordering and dtype), so a
checkpoint written by either loads in the other and solves to the 1e-10
residual contract; f32 and f64 levels round-trip bit for bit. The meta
record names the matmul rung the factor was built at (`"precision"`), and
a loader without an explicit rung pins it, in both directions."""

import json

import numpy as np
import pytest
import torch

import cholesky_tpu
import cholesky_tpu.api as japi
import cholesky_tpu_torch
import cholesky_tpu_torch.api as tapi
from cholesky_tpu.io import mmio
from cholesky_tpu.numeric import frontal as jfrontal
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch.numeric import regimes
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

TOL = 1e-10


def _solvers(paths, name, dtype):
    p = paths(name)
    files = (p["mat"], p["separators"], p["clusters"])
    b = mmio.read_array(p["b"]).reshape(-1).astype(np.float64)
    js = cholesky_tpu.SparseCholesky.from_files(*files, dtype=dtype)
    ts = cholesky_tpu_torch.SparseCholesky.from_files(*files, dtype=dtype,
                                                      device="cpu")
    return js, ts, b


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["lapl_400x400", "lapl_3375x3375"])
def test_jax_checkpoint_loads_in_the_port(name, dtype, tmp_path,
                                          port_fixtures):
    js, ts, b = _solvers(port_fixtures, name, dtype)
    assert ts._factor_fingerprint() == js._factor_fingerprint()
    path = js.save_factor(str(tmp_path / "jax_factor"))
    ts.load_factor(str(tmp_path / "jax_factor"))      # .npz is appended
    assert path.endswith(".npz") and ts.factored
    for p, q in zip(ts.panels, js.panels):
        assert np.array_equal(p.numpy(), np.asarray(q))
    x = ts.solve(b)
    assert ts.residual(b, x) <= TOL
    B = np.stack([b, b[::-1]], axis=1)
    assert ts.residual(B, ts.solve(B)) <= TOL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["lapl_400x400", "lapl_3375x3375"])
def test_port_checkpoint_loads_in_jax(name, dtype, tmp_path, port_fixtures):
    js, ts, b = _solvers(port_fixtures, name, dtype)
    ts.factorize()
    path = ts.save_factor(str(tmp_path / "port_factor.npz"))
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"].tobytes()).decode())
    assert meta["version"] == 2 and meta["storage"] == "bits"
    # the resolved rung: AUTO gives an f32 factor of these small plans
    # "highest", an f64 one None (as the JAX package writes)
    assert meta["precision"] == ts.precision == js.precision
    assert meta["precision"] == ("highest" if dtype == np.float32 else None)
    assert meta["panel_dtypes"] == [np.dtype(dtype).name] * ts.plan.levels
    js.load_factor(path)
    assert js.factored
    for p, q in zip(ts.panels, js.panels):
        assert np.array_equal(p.numpy(), np.asarray(q))
    assert js.residual(b, js.solve(b)) <= TOL
    # and back into a fresh port solver
    _, ts2, _ = _solvers(port_fixtures, name, dtype)
    ts2.load_factor(path)
    assert ts2.residual(b, ts2.solve(b)) <= TOL


def test_bf16_checkpoint_from_jax(tmp_path, monkeypatch):
    """A JAX factor stored bf16 in host memory: saved as bit patterns,
    loaded in the port as bf16, solved to the contract."""
    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setenv("CHOLESKY_TPU_OFFLOAD", "1")
    monkeypatch.setattr(jfrontal, "_F32_STORE_BYTES", 0)
    monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", "1")
    n, r, c, v, o, cl, b = generate_problem((16, 15), 4)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    js.factorize()
    path = js.save_factor(str(tmp_path / "bf16"))
    ts = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu")
    ts.load_factor(path)
    assert all(p.dtype == torch.bfloat16 for p in ts.panels)
    for p, q in zip(ts.panels, js.panels):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(q).astype(np.float32))
    assert ts.residual(b, ts.solve(b)) <= TOL


def test_bf16_checkpoint_from_the_port(tmp_path):
    """A port factor stored bf16 and offloaded: saved from host memory as
    bit patterns; the JAX package loads and solves it; a port solver whose
    budget plan offloads keeps the loaded levels in host memory."""
    n, r, c, v, o, cl, b = generate_problem((16, 15), 4)
    force = dict(store_dtype=torch.bfloat16, offload=True, reupload=False,
                 lazy=True)

    def port():
        s = cholesky_tpu_torch.SparseCholesky.from_coo(
            n, r, c, v, o, cl, dtype=np.float32, device="cpu")
        s._plan_override = regimes.plan_regimes(s.fplan, s.dtype, 600 << 20,
                                                **force)
        return s

    ts = port()
    ts.factorize()
    path = ts.save_factor(str(tmp_path / "bf16_port"))
    with np.load(path) as data:
        assert all(data[f"panel_{i}"].dtype == np.uint16
                   for i in range(ts.plan.levels))
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    js.load_factor(path)
    for p, q in zip(ts.panels, js.panels):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(q).astype(np.float32))
    assert js.residual(b, js.solve(b)) <= TOL
    ts2 = port()
    ts2.load_factor(path)
    assert all(p.dtype == torch.bfloat16 for p in ts2.panels)
    assert ts2.regimes is ts2._plan_override
    assert ts2.residual(b, ts2.solve(b)) <= TOL
    assert ts2.last_solve["engine"] == "plain"


@pytest.mark.parametrize("what", ["value", "dtype", "ordering"])
def test_both_loaders_refuse_a_changed_problem(what, tmp_path,
                                               port_fixtures):
    js, ts, _ = _solvers(port_fixtures, "lapl_400x400", np.float64)
    ts.factorize()
    path = ts.save_factor(str(tmp_path / "ck"))
    if what == "value":
        vals = ts.vals.copy()
        vals[3] *= 1.0 + 1e-12
        ts.update_values(vals)
        js.update_values(vals)
    elif what == "dtype":
        js, ts, _ = _solvers(port_fixtures, "lapl_400x400", np.float32)
    else:
        n, r, c, v, o, cl, _ = generate_problem((20, 20), 4)
        js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl)
        ts = cholesky_tpu_torch.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                                        device="cpu")
    with pytest.raises(ValueError, match="does not match") as port:
        ts.load_factor(path)
    with pytest.raises(ValueError, match="does not match") as ref:
        js.load_factor(path)
    assert str(port.value) == str(ref.value)
    assert not ts.factored


def _rung_solver(pkg, rung):
    n, r, c, v, o, cl, b = generate_problem((8, 8, 8), 4)
    kw = {"device": "cpu"} if pkg is cholesky_tpu_torch else {}
    return pkg.SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                       precision=rung, **kw), b


def _meta(path):
    with np.load(path) as data:
        return json.loads(bytes(data["meta"].tobytes()).decode())


@pytest.mark.parametrize("rung", ["highest", "high", "default", None])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_pins_the_rung_in_the_other_package(writer, rung,
                                                       tmp_path,
                                                       monkeypatch):
    """A factor saved at a rung loads pinned at that rung in an AUTO solver
    of the other package (and of its own), though AUTO would answer
    otherwise there: the loading process's threshold is moved so that it
    would."""
    pkgs = (cholesky_tpu, cholesky_tpu_torch)
    src, dst = pkgs if writer == "jax" else pkgs[::-1]
    w, b = _rung_solver(src, rung)
    w.factorize()
    path = w.save_factor(str(tmp_path / "ck"))
    saved = _meta(path)["precision"]
    assert saved == w.precision == (None if rung == "default" else
                                    "highest" if rung is None else rung)
    flip = 0.0 if saved == "highest" else 1e30
    monkeypatch.setattr(japi, "_AUTO_HIGHEST_FLOPS", flip)
    monkeypatch.setattr(tapi, "_AUTO_HIGHEST_FLOPS", flip)
    for pkg in (dst, src):
        s, _ = _rung_solver(pkg, None)
        assert s.precision != saved             # AUTO here answers otherwise
        s.load_factor(path)
        assert s.factored and s.precision == saved
        assert s.residual(b, s.solve(b)) <= TOL
        assert s.precision == saved


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_checkpoint_without_the_key_resolves_auto(reader, tmp_path):
    """A checkpoint written before the meta key existed: the loader takes
    AUTO's answer on its plan, resolved while unfactored."""
    w, b = _rung_solver(cholesky_tpu_torch, None)
    w.factorize()
    path = w.save_factor(str(tmp_path / "ck"))
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = _meta(path)
    del meta["precision"]
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    s, _ = _rung_solver(cholesky_tpu if reader == "jax"
                        else cholesky_tpu_torch, None)
    s.load_factor(path)
    assert s.precision == "highest"
    assert s.residual(b, s.solve(b)) <= TOL

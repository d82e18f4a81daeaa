"""The port's matmul-precision ladder against the JAX package's, on the CPU.

`precision=` on every constructor, on `factorize` and through `spsolve`;
the `precision` property (explicit rungs, "default" as None, f64 and
signed solvers as None, AUTO from `capacity.frontal_flops` against
`_AUTO_HIGHEST_FLOPS`, the pin once factored, the setter, update_values)
resolved to the JAX solver's answer on the same inputs; the flag
`torch.backends.cuda.matmul.fp32_precision` inside the factorization, the
solves, selected inversion and every method that applies the factor
("ieee" at "highest", "tf32" at the one-pass rung), put back after each,
also after an exception; no other precision setting touched. CPU products
do not read the flag, so CPU results are bit-identical across rungs and
the double-float residual is the same under both flags; every rung solves
to the 1e-10 residual contract."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.overrides import TorchFunctionMode

import cholesky_tpu
import cholesky_tpu.api as japi
import cholesky_tpu_torch
import cholesky_tpu_torch.api as tapi
from cholesky_tpu.io import mmio
from cholesky_tpu.utils.laplacian import generate_problem
from cholesky_tpu_torch import convert
from cholesky_tpu_torch.numeric import (frontal, ldlt, precision, refine,
                                        selinv)
from cholesky_tpu_torch.numeric.precision import PRECISIONS
from tests.test_torch_fixtures import port_fixtures  # noqa: F401

TOL = 1e-10
RUNGS = (None,) + PRECISIONS
CONSTRUCTORS = ("init", "from_coo", "from_files", "from_matrix",
                "from_scipy")
# the torch functions that are products (cuBLAS GEMMs and their kin on
# the card): a method that applies the factor must run at least one
PRODUCTS = {"matmul", "bmm", "mm", "baddbmm", "addmm", "einsum",
            "linalg_solve_triangular", "linalg_cholesky_ex"}


@pytest.fixture(autouse=True)
def _no_env_rung(monkeypatch):
    """The JAX package also reads its rung from the environment; the port
    reads none. Every test ends with the flag as it found it."""
    for k in ("CHOLESKY_TPU_PRECISION", "CHOLESKY_TPU_AUTO_HIGHEST_FLOPS",
              "CHOLESKY_TPU_APPLY_PRECISION"):
        monkeypatch.delenv(k, raising=False)
    before = torch.backends.cuda.matmul.fp32_precision
    yield
    assert torch.backends.cuda.matmul.fp32_precision == before


def _problem(shape=(6, 6, 6), levels=3):
    return generate_problem(shape, levels)


def _build(pkg, how, dtype=np.float32, paths=None, **kw):
    """A solver of package `pkg` (the JAX one or the port) built by
    constructor `how` on the 6^3 problem (the 15^3 fixture for
    from_files); the port's on the CPU."""
    if pkg is cholesky_tpu_torch:
        kw["device"] = "cpu"
    S = pkg.SparseCholesky
    if how == "from_files":
        p = paths("lapl_3375x3375")
        return S.from_files(p["mat"], p["separators"], p["clusters"],
                            dtype=dtype, **kw)
    n, r, c, v, o, cl, _ = _problem()
    if how == "from_matrix":
        return S.from_matrix(n, r, c, v, dtype=dtype, **kw)
    if how == "from_scipy":
        a = sp.csr_matrix((v, (r, c)), shape=(n, n)).astype(dtype)
        return S.from_scipy(a, **kw)
    if how == "init":
        plan = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl).plan
        if pkg is cholesky_tpu_torch:
            plan = convert.plan_from_jax(plan)
        r2, c2, v2 = mmio.dedup_lower(r, c, v)
        return S(plan, r2, c2, v2, dtype=dtype, **kw)
    return S.from_coo(n, r, c, v, o, cl, dtype=dtype, **kw)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("how", CONSTRUCTORS)
def test_every_name_at_every_constructor(how, rung, port_fixtures):
    js = _build(cholesky_tpu, how, paths=port_fixtures, precision=rung)
    ts = _build(cholesky_tpu_torch, how, paths=port_fixtures,
                precision=rung)
    assert ts.precision == js.precision
    assert ts.precision == (None if rung == "default" else
                            "highest" if rung is None else rung)


@pytest.mark.parametrize("how", CONSTRUCTORS + ("factorize", "spsolve"))
def test_unknown_name_raises_value_error(how, port_fixtures):
    n, r, c, v, *_ = _problem()
    errors = []
    for pkg in (cholesky_tpu, cholesky_tpu_torch):
        with pytest.raises(ValueError, match="precision") as e:
            if how == "factorize":
                _build(pkg, "from_coo").factorize(precision="f16")
            elif how == "spsolve":
                kw = {"device": "cpu"} if pkg is cholesky_tpu_torch else {}
                pkg.spsolve(sp.csr_matrix((v, (r, c)), shape=(n, n)),
                            np.ones(n), precision="f16", **kw)
            else:
                _build(pkg, how, paths=port_fixtures, precision="f16")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("rung", RUNGS)
def test_spsolve_takes_every_rung(rung):
    n, r, c, v, *_ = _problem()
    a = sp.csr_matrix((v, (r, c)), shape=(n, n)).astype(np.float32)
    b = np.random.default_rng(0).standard_normal(n)
    x = cholesky_tpu_torch.spsolve(a, b, precision=rung, device="cpu")
    full = (a + sp.tril(a, -1).T).astype(np.float64)
    assert np.linalg.norm(full @ x - b) / np.linalg.norm(b) <= TOL


@pytest.mark.parametrize("case", ["f64", "signs", "auto", "auto_low",
                                  "default"])
def test_property_resolves_as_the_jax_package(case, monkeypatch):
    n, r, c, v, o, cl, _ = _problem()
    kw = {"dtype": np.float64 if case == "f64" else np.float32}
    if case == "signs":
        kw["signs"] = np.where(np.arange(n) % 5 == 0, -1.0, 1.0)
    if case == "default":
        kw["precision"] = "default"
    if case == "auto_low":
        monkeypatch.setattr(japi, "_AUTO_HIGHEST_FLOPS", 0.0)
        monkeypatch.setattr(tapi, "_AUTO_HIGHEST_FLOPS", 0.0)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl, **kw)
    ts = cholesky_tpu_torch.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                                    device="cpu", **kw)
    want = "highest" if case == "auto" else None
    assert js.precision == want and ts.precision == want


def test_pin_survives_a_threshold_flip_and_the_setter_clears_it(
        monkeypatch):
    n, r, c, v, o, cl, b = _problem()
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    ts = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu")
    js.factorize()
    ts.factorize()
    monkeypatch.setattr(japi, "_AUTO_HIGHEST_FLOPS", 0.0)
    monkeypatch.setattr(tapi, "_AUTO_HIGHEST_FLOPS", 0.0)
    assert js.precision == ts.precision == "highest"        # pinned
    # update_values unpins: AUTO re-resolves from the same plan (here
    # under the moved threshold), in both packages alike
    js.update_values(2.0 * js.vals)
    ts.update_values(2.0 * ts.vals)
    assert js.precision is None and ts.precision is None
    monkeypatch.setattr(japi, "_AUTO_HIGHEST_FLOPS", 1e12)
    monkeypatch.setattr(tapi, "_AUTO_HIGHEST_FLOPS", 1e12)
    assert js.precision == ts.precision == "highest"
    ts.factorize()
    js.factorize()
    js.precision = "high"
    ts.precision = "high"
    assert js.precision == ts.precision == "high"
    js.precision = None                 # the setter clears the pin
    ts.precision = None
    assert js._precision_resolved is None and ts._precision_resolved is None
    assert js.precision == ts.precision      # factored: the cleared pin
    assert ts.residual(b, ts.solve(b)) <= TOL


@pytest.mark.parametrize("rung", [None, "high", "default"])
def test_state_from_jax_pins_the_jax_rung(rung):
    n, r, c, v, o, cl, b = _problem()
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32,
                                              precision=rung)
    js.factorize()
    ts = convert.state_from_jax(js, device="cpu")
    assert ts.factored and ts.precision == js.precision
    assert ts.residual(b, ts.solve(b)) <= TOL


@pytest.mark.parametrize("rung", PRECISIONS)
def test_factorize_precision_is_sticky(rung):
    n, r, c, v, o, cl, b = _problem()
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, v, o, cl,
                                              dtype=np.float32)
    ts = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu")
    js.factorize(precision=rung)
    ts.factorize(precision=rung)
    assert ts.precision == js.precision
    ts.factorize()                      # no argument: the rung stays
    assert ts.precision == js.precision
    assert ts.residual(b, ts.solve(b)) <= TOL


def _probe(monkeypatch, module, name, seen):
    fn = getattr(module, name)

    def probe(*args, **kwargs):
        seen.append((name, torch.backends.cuda.matmul.fp32_precision))
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, probe)


@pytest.mark.parametrize("rung", RUNGS)
def test_flag_inside_factor_solve_and_selinv(rung, monkeypatch):
    """The flag read inside the level loop, the banded solve chain and
    selected inversion's per-level step."""
    seen = []
    for module, name in ((frontal, "_factor_level"),
                         (frontal, "_solve_banded_core"),
                         (frontal, "invert_pivots"),
                         (selinv, "_selinv_core")):
        _probe(monkeypatch, module, name, seen)
    n, r, c, v, o, cl, b = _problem()
    ts = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu", precision=rung)
    ts.factorize()
    assert ts.residual(b, ts.solve(b)) <= TOL
    ts.inv_diag()
    want = precision.fp32_flag(ts.precision)
    assert want == ("ieee" if rung in ("highest", "float32", None)
                    else "tf32")
    assert {name for name, _ in seen} == {
        "_factor_level", "_solve_banded_core", "invert_pivots",
        "_selinv_core"}
    assert {flag for _, flag in seen} == {want}
    assert torch.backends.cuda.matmul.fp32_precision == "none"


@pytest.mark.parametrize("rung", [None, "highest"])
def test_quasi_definite_factor_runs_at_its_rung(rung, monkeypatch):
    """A signed factor resolves AUTO to None, the one-pass rung (TF32 on
    the card), as the JAX package's does; an explicit rung is kept."""
    seen = []
    _probe(monkeypatch, ldlt, "_factor_level_qd", seen)
    _probe(monkeypatch, ldlt, "solve_qd", seen)
    n, r, c, v, o, cl, b = _problem()
    signs = np.where(np.arange(n) % 5 == 0, -1.0, 1.0)
    vq = np.where(r == c, signs[r] * (np.abs(v) + 0.5), v)
    kw = dict(dtype=np.float32, signs=signs, precision=rung)
    js = cholesky_tpu.SparseCholesky.from_coo(n, r, c, vq, o, cl, **kw)
    ts = cholesky_tpu_torch.SparseCholesky.from_coo(n, r, c, vq, o, cl,
                                                    device="cpu", **kw)
    assert ts.precision == js.precision == rung
    ts.factorize()
    x = ts.solve(b)
    assert ts.residual(b, x) <= TOL
    assert {name for name, _ in seen} >= {"_factor_level_qd"}
    assert {flag for _, flag in seen} == {"ieee" if rung else "tf32"}


class _FlagRecorder(TorchFunctionMode):
    """Records the flag at every torch function call, and whether a product
    ran."""

    def __init__(self):
        super().__init__()
        self.flags, self.products = set(), 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.flags.add(torch.backends.cuda.matmul.fp32_precision)
        if getattr(func, "__name__", "").strip("_") in PRODUCTS:
            self.products += 1
        return func(*args, **(kwargs or {}))


# each method the JAX package runs under the solver's rung, with arguments
# for a solver of n dofs
METHODS = {
    "solve": lambda s, n, b: s.solve(b),
    "solve_block": lambda s, n, b: s.solve(np.stack([b, 2 * b], axis=1)),
    "inv_diag": lambda s, n, b: s.inv_diag(),
    "inv_entries": lambda s, n, b: s.inv_entries(s.rows[:5], s.cols[:5]),
    "schur_complement": lambda s, n, b: s.schur_complement(),
    "condense_rhs": lambda s, n, b: s.condense_rhs(b),
    "expand_solution": lambda s, n, b: s.expand_solution(
        b, np.zeros(len(s.schur_dofs()))),
    "sample": lambda s, n, b: s.sample(np.ones(n)),
    "whiten": lambda s, n, b: s.whiten(np.ones(n)),
    "logdet_grad": lambda s, n, b: s.logdet_grad(),
    "solve_grad": lambda s, n, b: s.solve_grad(b, np.ones(n)),
    "quadform_grad": lambda s, n, b: s.quadform_grad(b),
    "solve_updated": lambda s, n, b: s.solve_updated(b, np.eye(n)[:, :2]),
    "solve_perturbed": lambda s, n, b: s.solve_perturbed(
        b, np.array([0]), np.array([0]), np.array([0.1])),
    "logdet_updated": lambda s, n, b: s.logdet_updated(np.eye(n)[:, :2]),
    "eigsh": lambda s, n, b: s.eigsh(k=2),
    "condest": lambda s, n, b: s.condest(iters=3),
    "factorize_many": lambda s, n, b: s.factorize_many(
        np.stack([s.vals, 2.0 * s.vals])),
    "family_solve": None,               # BatchedFactors.solve, below
}


@pytest.fixture(scope="module")
def factored():
    """One factored 6^3 solver per rung, shared by the method cases."""
    n, r, c, v, o, cl, b = _problem()
    out = {}
    for rung in ("highest", "default"):
        s = cholesky_tpu_torch.SparseCholesky.from_coo(
            n, r, c, v, o, cl, dtype=np.float32, device="cpu",
            precision=rung)
        s.factorize()
        out[rung] = s
    return out, n, b


@pytest.mark.parametrize("rung", ["highest", "default"])
@pytest.mark.parametrize("method", list(METHODS))
def test_every_factor_application_runs_at_the_rung(method, rung, factored):
    solvers, n, b = factored
    s = solvers[rung]
    fam = s.factorize_many(np.stack([s.vals, s.vals])) \
        if method == "family_solve" else None
    rec = _FlagRecorder()
    with rec:
        if fam is not None:
            fam.solve(b)
        else:
            METHODS[method](s, n, b)
    assert rec.flags == {"ieee" if rung == "highest" else "tf32"}
    assert rec.products > 0
    assert torch.backends.cuda.matmul.fp32_precision == "none"


def test_other_methods_run_at_the_process_flag(factored):
    """A method the JAX package does not run under the rung (logdet) sees
    whatever the process has set, and the port does not change it."""
    solvers, _, _ = factored
    matmul = torch.backends.cuda.matmul
    for outer in ("tf32", "ieee"):
        matmul.fp32_precision = outer
        try:
            rec = _FlagRecorder()
            with rec:
                solvers["highest"].logdet()
            assert rec.flags == {outer}
        finally:
            matmul.fp32_precision = "none"


@pytest.mark.parametrize("outer", ["none", "ieee", "tf32"])
def test_flag_restored_after_an_exception_and_after_nesting(outer,
                                                            monkeypatch):
    matmul = torch.backends.cuda.matmul
    matmul.fp32_precision = outer
    try:
        with precision.precision_ctx("highest"):
            with precision.precision_ctx("highest"):
                assert matmul.fp32_precision == "ieee"
            assert matmul.fp32_precision == "ieee"
            with precision.precision_ctx("default"):
                assert matmul.fp32_precision == "tf32"
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == outer
        n, r, c, v, o, cl, b = _problem()
        ts = cholesky_tpu_torch.SparseCholesky.from_coo(
            n, r, c, v, o, cl, dtype=np.float32, device="cpu",
            precision="high")

        def boom(*args, **kwargs):
            assert matmul.fp32_precision == "tf32"
            raise RuntimeError("boom")
        monkeypatch.setattr(frontal, "factor", boom)
        with pytest.raises(RuntimeError, match="boom"):
            ts.factorize()
        assert matmul.fp32_precision == outer
        assert not ts.factored
    finally:
        matmul.fp32_precision = "none"


def test_no_other_precision_setting_is_touched(monkeypatch):
    """oneDNN's flag and the generic one keep their values inside the
    factorization; the legacy getter reads as before afterwards."""
    mkl = torch.backends.mkldnn.matmul.fp32_precision
    generic = torch.backends.fp32_precision
    legacy = torch.get_float32_matmul_precision()
    seen = []
    factor = frontal.factor

    def probe(*args, **kwargs):
        seen.append((torch.backends.mkldnn.matmul.fp32_precision,
                     torch.backends.fp32_precision))
        return factor(*args, **kwargs)
    monkeypatch.setattr(frontal, "factor", probe)
    n, r, c, v, o, cl, b = _problem()
    for rung in ("highest", "default"):
        ts = cholesky_tpu_torch.SparseCholesky.from_coo(
            n, r, c, v, o, cl, dtype=np.float32, device="cpu",
            precision=rung)
        ts.factorize()
        ts.solve(b)
        assert torch.backends.mkldnn.matmul.fp32_precision == mkl
        assert torch.backends.fp32_precision == generic
        assert torch.get_float32_matmul_precision() == legacy
    assert seen == [(mkl, generic)] * 2


def test_cpu_results_bit_identical_across_rungs():
    n, r, c, v, o, cl, b = _problem((8, 8, 8), 4)
    B = np.random.default_rng(1).standard_normal((n, 3))
    outs = []
    for rung in PRECISIONS:
        ts = cholesky_tpu_torch.SparseCholesky.from_coo(
            n, r, c, v, o, cl, dtype=np.float32, device="cpu",
            precision=rung)
        ts.factorize()
        outs.append(([p.clone() for p in ts.panels], ts.solve(b),
                     ts.solve(B), ts.inv_diag()))
    for panels, x, X, d in outs[1:]:
        assert all(torch.equal(p, q) for p, q in zip(panels, outs[0][0]))
        assert np.array_equal(x, outs[0][1])
        assert np.array_equal(X, outs[0][2])
        assert np.array_equal(d, outs[0][3])


def test_double_float_residual_does_not_read_the_flag():
    rng = np.random.default_rng(2)
    n, K = 200, 7
    idx = torch.from_numpy(rng.integers(0, n + 1, (n, K)))
    a_hi = torch.from_numpy(rng.standard_normal((n, K)).astype(np.float32))
    a_lo = a_hi * 1e-8
    x_hi = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
    x_lo = x_hi * 1e-8
    x_hi[-1] = x_lo[-1] = 0.0
    X_hi = torch.stack([x_hi, 2 * x_hi], 1)
    X_lo = torch.stack([x_lo, 2 * x_lo], 1)
    outs = []
    for rung in ("highest", "default"):
        rec = _FlagRecorder()
        with precision.precision_ctx(rung), rec:
            outs.append(refine.df_matvec(idx, a_hi, a_lo, x_hi, x_lo)
                        + refine.df_matvec_multi(idx, a_hi, a_lo, X_hi,
                                                 X_lo))
        assert rec.products == 0          # gathers and FMAs, no GEMM
    assert all(torch.equal(p, q) for p, q in zip(*outs))


@pytest.mark.parametrize("rung", ["highest", "default"])
def test_demote_apply_runs_the_inner_solve_at_the_one_pass_rung(
        rung, monkeypatch):
    n, r, c, v, o, cl, b = _problem()
    ts = cholesky_tpu_torch.SparseCholesky.from_coo(
        n, r, c, v, o, cl, dtype=np.float32, device="cpu", precision=rung)
    ts.factorize()
    ell = ts._ell_device(True)
    perm, iperm = ts._perm_device()
    bp = torch.from_numpy(b.astype(np.float64))[perm]
    results = {}
    for demote in (False, True):
        seen = []
        _probe(monkeypatch, frontal, "_solve_banded_core", seen)
        with precision.precision_ctx(ts.precision):
            results[demote] = refine.solve_refined_df(
                ts.fplan, ts.panels, ts._inv_pivots(), bp, ell,
                tol=TOL / 3, demote_apply=demote)
        monkeypatch.undo()
        want = "tf32" if demote else precision.fp32_flag(ts.precision)
        assert {flag for _, flag in seen} == {want}
    for demote, (x, sweeps, rn) in results.items():
        assert rn <= TOL
        assert torch.equal(x, results[False][0])      # the CPU ignores it


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("name", ["lapl_400x400", "lapl_3375x3375"])
def test_residual_at_every_rung(name, rung, port_fixtures):
    p = port_fixtures(name)
    ts = cholesky_tpu_torch.SparseCholesky.from_files(
        p["mat"], p["separators"], p["clusters"], dtype=np.float32,
        device="cpu", precision=rung)
    b = mmio.read_array(p["b"]).reshape(-1).astype(np.float64)
    x = ts.solve(b)
    assert ts.residual(b, x) <= TOL
    assert ts.last_solve["loop"] == "device"

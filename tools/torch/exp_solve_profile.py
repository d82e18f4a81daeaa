"""Decompose the solve wall into a constant, a cost per refinement sweep
and the host's pre / post work. The `cholesky_tpu_torch` counterpart of
tools/exp_solve_profile.py.

On a dim^3 grid Laplacian under `levels` levels of nested dissection, f32
factor (default 50^3 L8), runs the device refinement loop
(`refine.solve_refined_df`, the banded engine with pivot inverses) at
each sweep budget max_iter = 1 ... 6 with tol = 0, so that only the budget
or the double-float floor (a sweep that does not halve the residual)
stops it, and records the sweeps it ran and its wall (the least of 6 runs
after a warm-up, between two CUDA events; the loop reads one norm a sweep
on the host, so the events span the host's part too). A least-squares
line through (sweeps, wall) gives the constant (the first solve and
residual) and the cost per sweep. The same at budgets 1 and 4 without
pivot inverses (`frontal.frontal_solve` inside the loop). Then
`SparseCholesky.solve(b, tol=1e-10)`: its wall, sweeps and residual, and
what the line leaves of it, the host's pre / post work (upload,
permutation, download).

    python tools/torch/exp_solve_profile.py [--dim 50] [--levels 8]
        [--device cuda]

Prints one line per budget, then one JSON line of the results (with the
card's name and power limit, or "cpu").
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

BUDGETS = (1, 2, 3, 4, 5, 6)


def fit(points):
    """(constant, per-sweep slope) of the least-squares line through
    (sweeps, ms); the slope is None with fewer than two distinct sweep
    counts."""
    x = np.array([p["sweeps"] for p in points], dtype=np.float64)
    y = np.array([p["ms"] for p in points])
    if len(set(x)) < 2:
        return float(y.mean()), None
    slope, const = np.polyfit(x, y, 1)
    return float(const), float(slope)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import refine
    from cholesky_tpu_torch.numeric.profile import _timed, card
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    label = card(args.device)
    print(f"# {label}", flush=True)
    n, r, c, v, o, cl, b = generate_problem((args.dim,) * 3, args.levels)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device=args.device)
    device = s.device
    t0 = time.perf_counter()
    s.factorize()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"tool": "exp_solve_profile", "device": str(device), "card": label,
           "problem": f"{args.dim}^3 L{args.levels}", "n": n,
           "factorize_first_s": time.perf_counter() - t0}
    fp, factors = s.fplan, s.panels
    b64 = torch.from_numpy(b[s.plan.perm]).to(device)

    def runs(inv, ell, budgets):
        rows = []
        for mi in budgets:
            def loop(_mi=mi):
                return refine.solve_refined_df(fp, factors, inv, b64, ell,
                                               tol=0.0, max_iter=_mi)

            (_, sweeps, rn), t = _timed(loop, 6, device)
            rows.append({"max_iter": mi, "sweeps": sweeps, "rn_rel": rn,
                         "ms": t * 1e3})
            print(f"{'banded' if inv is not None else 'plain':<6} max_iter "
                  f"{mi}: {sweeps} sweeps, {t * 1e3:.3f} ms, "
                  f"rn_rel {rn:.2e}", flush=True)
        return rows

    out["banded"] = runs(s._inv_pivots(), s._ell_device(True), BUDGETS)
    out["plain"] = runs(None, s._ell_device(False), (1, 4))
    out["constant_ms"], out["per_sweep_ms"] = fit(out["banded"])
    out["plain_constant_ms"], out["plain_per_sweep_ms"] = fit(out["plain"])

    x = s.solve(b, tol=1e-10)
    _, t = _timed(lambda: s.solve(b, tol=1e-10), 6, device)
    sweeps = s.last_solve["sweeps"]
    a = s._matrix_csr()
    out.update(api_solve_ms=t * 1e3, api_sweeps=sweeps,
               api_engine=s.last_solve["engine"],
               residual=float(np.linalg.norm(a @ x - b) / np.linalg.norm(b)))
    if out["per_sweep_ms"] is not None:
        out["host_pre_post_ms"] = out["api_solve_ms"] - (
            out["constant_ms"] + sweeps * out["per_sweep_ms"])
    print(f"constant {out['constant_ms']:.3f} ms, per sweep "
          f"{out['per_sweep_ms']} ms; api solve {out['api_solve_ms']:.3f} ms "
          f"({sweeps} sweeps, residual {out['residual']:.2e}); host pre / "
          f"post {out.get('host_pre_post_ms')} ms", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""Profile the solve path stage by stage. The `cholesky_tpu_torch`
counterpart of tools/prof_solve.py.

Stages, on a dim^3 grid Laplacian under `levels` levels of nested
dissection, f32 factor (default 50^3 L8):

  solve1  one inner solve with pivot inverses (`frontal._solve_banded`,
          the JAX package's `frontal_solve(inv_pivots=)`), and
          `frontal.invert_pivots` on its own;
  refine  `refine.solve_refined_df` with its sweeps (the banded engine);
  api     `SparseCholesky.solve` (upload, permutation, the device loop,
          download);
  resid   `refine.df_matvec` alone, the double-float residual's matvec.

Each time is the least of 5 runs after a warm-up, between two CUDA events
(a stage that reads a norm or a result on the host each sweep synchronizes
itself, so its events span the host's part too).

    python tools/torch/prof_solve.py [stage ...] [--dim 50] [--levels 8]
        [--device cuda]

Default stages: refine api, as in the JAX tool. Prints one line per
stage, then one JSON line of the results (with the card's name and power
limit, or "cpu").
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

STAGES = ("solve1", "refine", "api", "resid")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stages", nargs="*", default=["refine", "api"],
                    choices=STAGES)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import frontal, refine
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
    out = {"tool": "prof_solve", "device": str(device), "card": label,
           "problem": f"{args.dim}^3 L{args.levels}", "n": n,
           "factorize_first_s": time.perf_counter() - t0}
    print(f"factorize (first): {out['factorize_first_s']:.2f}s", flush=True)
    fp, factors = s.fplan, s.panels
    inv = s._inv_pivots()
    ell = s._ell_device(True)               # padded planes (banded engine)
    b64 = torch.from_numpy(b[s.plan.perm]).to(device)

    def ms(fn):
        return _timed(fn, 5, device)[1] * 1e3

    if "solve1" in args.stages:
        bp = b64.to(torch.float32)
        out["solve1_ms"] = ms(lambda: frontal._solve_banded(
            fp, factors, inv, bp))
        out["invert_pivots_ms"] = ms(lambda: frontal.invert_pivots(
            fp, factors))
        print(f"_solve_banded (pivot inverses) 1x: {out['solve1_ms']:.3f} ms; "
              f"invert_pivots: {out['invert_pivots_ms']:.3f} ms", flush=True)
    if "refine" in args.stages:
        def full():
            return refine.solve_refined_df(fp, factors, inv, b64, ell)

        _, sweeps, rn = full()
        out.update(refine_sweeps=sweeps, refine_rn_rel=rn,
                   refine_ms=ms(full))
        print(f"solve_refined_df: {sweeps} sweeps, rn_rel={rn:.2e}, "
              f"{out['refine_ms']:.3f} ms", flush=True)
    if "api" in args.stages:
        out["api_ms"] = ms(lambda: s.solve(b))
        out["api_sweeps"] = s.last_solve["sweeps"]
        print(f"api solve: {out['api_ms']:.3f} ms "
              f"({out['api_sweeps']} sweeps)", flush=True)
    if "resid" in args.stages:
        idx, a_hi, a_lo = ell
        x_hi = torch.randn(idx.shape[0], generator=torch.Generator(
            device=device).manual_seed(0), device=device)
        x_hi[-1] = 0.0                      # the sentinel slot
        x_lo = torch.zeros_like(x_hi)
        out["resid_ms"] = ms(lambda: refine.df_matvec(idx, a_hi, a_lo, x_hi,
                                                      x_lo))
        print(f"df_matvec 1x: {out['resid_ms']:.3f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

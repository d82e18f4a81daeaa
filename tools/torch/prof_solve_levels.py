"""Per-level timing of the banded solve chain, the inner solve of the
refinement loop. The `cholesky_tpu_torch` counterpart of
tools/prof_solve_levels.py.

On a real factor and its pivot inverses (dim^3 grid Laplacian, `levels`
levels of nested dissection, f32), times each level's forward step
(`frontal._banded_forward` restricted to that level: a slice, the inverse
apply, the boundary product and its scatter-add) and backward step
(`frontal._banded_backward`: the boundary gather and product, the inverse
apply, the slice write), each R calls between two CUDA events on a work
vector refreshed outside the timed region, the least of 3 runs after a
warm-up. Then the whole chain (`frontal._solve_banded`, the levels'
steps with the entry and exit gathers) and `frontal.frontal_solve` (the
solve without pivot inverses), each one call between two events and as
a synchronized host wall. The gap between the chain's wall and the sum
of its levels is what the host adds by launching the steps one by one.
(The JAX tool's last table, whether a level's pivot rows are contiguous,
has no counterpart: the banded basis makes each level's pivot rows one
slice.)

    python tools/torch/prof_solve_levels.py [dim levels] [--device cuda]
        [--reps R]

Prints the table, then one JSON line of the results (with the card's name
and power limit, or "cpu").
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dim", type=int, nargs="?", default=50)
    ap.add_argument("levels", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=100,
                    help="calls between two CUDA events")
    args = ap.parse_args(argv)

    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.numeric import frontal
    from cholesky_tpu_torch.numeric.frontal_plan import _banded_maps
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
    factor_s = time.perf_counter() - t0
    print(f"factorize (first): {factor_s:.2f}s", flush=True)
    fp, factors = s.fplan, s.panels
    inv = frontal.invert_pivots(fp, factors)
    n_pad = _banded_maps(fp)[0]
    gen = torch.Generator(device=device).manual_seed(0)
    g0 = torch.randn(n_pad + 1, 1, generator=gen, device=device)
    g0[-1] = 0.0                                   # the sentinel slot
    levels = fp.levels

    def row(name, lvl, us):
        B = fp.front_rows[lvl].shape[0]
        print(f"{name:<4} lvl {lvl} B={B:<4d} W={fp.W[lvl]:<5d} "
              f"F={fp.F[lvl]:<6d} {us:>9.1f} us", flush=True)
        return {"level": lvl, "B": B, "W": fp.W[lvl], "F": fp.F[lvl],
                "us": us}

    fwd, bwd = [], []
    for lvl in range(levels - 1, -1, -1):
        _, t = _timed(
            lambda a, _l=lvl: frontal._banded_forward(
                fp, factors, inv, a[0], a[1], [_l], {}, None), 3, device,
            prep=lambda: (g0.clone(), [None] * levels), reps=args.reps)
        fwd.append(row("fwd", lvl, t * 1e6))
    ys = [None] * levels                    # every level's forward result
    frontal._banded_forward(fp, factors, inv, g0.clone(), ys,
                            range(levels - 1, -1, -1), {}, None)
    for lvl in range(levels):
        _, t = _timed(
            lambda xg, _l=lvl: frontal._banded_backward(
                fp, factors, inv, xg, ys, [_l], {}), 3, device,
            prep=g0.clone, reps=args.reps)
        bwd.append(row("bwd", lvl, t * 1e6))
    sum_f = sum(x["us"] for x in fwd) / 1e3
    sum_b = sum(x["us"] for x in bwd) / 1e3

    bp = torch.from_numpy(b[s.plan.perm].astype(np.float32)).to(device)

    def wall(fn):
        """(least device ms of one call, least synchronized host ms)."""
        _, t = _timed(fn, 3, device)
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            host.append(time.perf_counter() - t0)
        return t * 1e3, min(host) * 1e3

    chain_ms, chain_host_ms = wall(
        lambda: frontal._solve_banded(fp, factors, inv, bp))
    plain_ms, plain_host_ms = wall(
        lambda: frontal.frontal_solve(fp, factors, bp))
    print(f"sum fwd {sum_f:.3f} ms + bwd {sum_b:.3f} ms = "
          f"{sum_f + sum_b:.3f} ms", flush=True)
    print(f"banded chain (_solve_banded): {chain_ms:.3f} ms "
          f"(host wall {chain_host_ms:.3f} ms); frontal_solve without "
          f"inverses: {plain_ms:.3f} ms (host wall {plain_host_ms:.3f} ms)",
          flush=True)

    out = {"tool": "prof_solve_levels", "device": str(device), "card": label,
           "problem": f"{args.dim}^3 L{args.levels}", "n": n,
           "reps": args.reps, "factorize_first_s": factor_s,
           "fwd": fwd, "bwd": bwd, "sum_fwd_ms": sum_f, "sum_bwd_ms": sum_b,
           "sum_levels_ms": sum_f + sum_b, "banded_chain_ms": chain_ms,
           "banded_chain_host_ms": chain_host_ms,
           "frontal_solve_ms": plain_ms,
           "frontal_solve_host_ms": plain_host_ms,
           "chain_minus_levels_ms": chain_ms - (sum_f + sum_b)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""Microbenchmark: gather layouts of the double-float ELL matvec. The
`cholesky_tpu_torch` counterpart of tools/bench_matvec.py.

The refinement loop's residual is one sparse matvec in double-float
(`refine.df_matvec`); its cost is dominated by gathering x at the ELL
column indices. On the symmetrized, permuted dim^3 grid Laplacian under
`levels` levels of nested dissection (default 50^3 L8), compares:

  stacked2  the port's `refine.df_matvec`: ONE [n, K, 2] gather from the
            stacked [n + 1, 2] (hi, lo) operand;
  two_flat  two [n, K] gathers (hi, lo) from the flat [n + 1] operands;
  transp    the ELL planes transposed to [K, n]: K gathers of [n] each.

The two alternatives live here, not in the package. All three run the
same TwoProd / TwoSum arithmetic in the same order; they are first held
against each other (the largest difference of hi + lo, relative to the
largest |y|, at most 1e-12) and against SciPy's f64 product, then each is
timed: R calls between two CUDA events, the least of 3 runs after a
warm-up, in ms per call.

    python tools/torch/bench_matvec.py [--dim 50] [--levels 8]
        [--device cuda] [--reps R]

Prints one line per layout, then one JSON line of the results (with the
card's name and power limit, or "cpu").
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

AGREE_REL = 1e-12           # layouts against each other, hi + lo in f64


def fold(p, e_all, two_sum):
    """The TwoSum accumulation of `refine.df_matvec` over a list of
    [n] product planes and their error planes."""
    s, c = p[0], e_all[0]
    for k in range(1, len(p)):
        s, se = two_sum(s, p[k])
        c = c + (se + e_all[k])
    return s, c


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls between two CUDA events")
    args = ap.parse_args(argv)

    import scipy.sparse
    import torch

    from cholesky_tpu_torch.io import mmio
    from cholesky_tpu_torch.numeric import refine
    from cholesky_tpu_torch.numeric.profile import _timed, card
    from cholesky_tpu_torch.symbolic.plan import build_plan
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    label = card(args.device)
    device = torch.device(args.device)
    n, r, c, v, o, cl, _ = generate_problem((args.dim,) * 3, args.levels)
    plan = build_plan(o, cl)
    rr, cc, vv = mmio.symmetrize_coo(r, c, v)
    pr, pc = plan.iperm[rr], plan.iperm[cc]
    idx, a_hi, a_lo = refine.build_ell(n, pr, pc, vv)
    K = idx.shape[1]
    print(f"# {label}; n={n} K={K}", flush=True)

    x64 = np.random.default_rng(0).standard_normal(n)
    x_hi, x_lo = refine.split_f64(x64)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    xh = on(np.append(x_hi, np.float32(0.0)))   # the sentinel slot n
    xl = on(np.append(x_lo, np.float32(0.0)))
    idx_d, ah, al = on(idx.astype(np.int64)), on(a_hi), on(a_lo)
    idx_t, ah_t, al_t = idx_d.T.contiguous(), ah.T.contiguous(), \
        al.T.contiguous()
    two_sum, two_prod = refine._two_sum, refine._two_prod

    def stacked2():
        return refine.df_matvec(idx_d, ah, al, xh, xl)

    def two_flat():
        xgh, xgl = xh[idx_d], xl[idx_d]
        p, pe = two_prod(ah, xgh)
        e_all = pe + (ah * xgl + al * xgh)
        return fold(p.unbind(1), e_all.unbind(1), two_sum)

    def transp():
        ps, es = [], []
        for k in range(K):
            xgh, xgl = xh[idx_t[k]], xl[idx_t[k]]
            p, pe = two_prod(ah_t[k], xgh)
            ps.append(p)
            es.append(pe + (ah_t[k] * xgl + al_t[k] * xgh))
        return fold(ps, es, two_sum)

    layouts = {"stacked2": stacked2, "two_flat": two_flat, "transp": transp}
    ys = {name: fn() for name, fn in layouts.items()}
    y64 = {name: y[0].double() + y[1].double() for name, y in ys.items()}
    ref = scipy.sparse.csr_matrix((vv, (pr, pc)), shape=(n, n)) @ x64
    scale = float(y64["stacked2"].abs().max())
    out = {"tool": "bench_matvec", "device": str(device), "card": label,
           "problem": f"{args.dim}^3 L{args.levels}", "n": n, "K": K,
           "reps": args.reps, "agree_limit": AGREE_REL, "layouts": {}}
    for name, fn in layouts.items():
        _, t = _timed(fn, 3, device, reps=args.reps)
        got = y64[name].cpu().numpy()
        row = {"ms": t * 1e3,
               "rel_diff_vs_stacked2": float(
                   (y64[name] - y64["stacked2"]).abs().max()) / scale,
               "bit_identical_to_stacked2": bool(
                   torch.equal(ys[name][0], ys["stacked2"][0])
                   and torch.equal(ys[name][1], ys["stacked2"][1])),
               "rel_err_vs_scipy_f64": float(
                   np.abs(got - ref).max() / np.abs(ref).max())}
        out["layouts"][name] = row
        print(f"{name:<9} {row['ms']:>9.4f} ms  diff vs stacked2 "
              f"{row['rel_diff_vs_stacked2']:.1e}  err vs f64 "
              f"{row['rel_err_vs_scipy_f64']:.1e}", flush=True)
    out["agree"] = all(row["rel_diff_vs_stacked2"] <= AGREE_REL
                       for row in out["layouts"].values())
    print(json.dumps(out), flush=True)
    if not out["agree"]:
        raise SystemExit(f"the layouts disagree beyond {AGREE_REL}")
    return out


if __name__ == "__main__":
    main()

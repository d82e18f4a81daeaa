"""Ordering-quality comparison: this package's graph nested dissection
against SuperLU's MMD / COLAMD, reverse Cuthill-McKee and the natural
ordering. The `cholesky_tpu_torch` counterpart of tools/nd_quality.py.

For each gallery problem, the scalar sparse-Cholesky cost (FLOPs, nnz(L))
of the permutation produced by (a) `symbolic/nd.py`'s graph nested
dissection, at the automatic depth (with the expander depth-collapse
policy) and at a forced deep tree, (b) SuperLU's MMD_AT_PLUS_A and
COLAMD, (c) SciPy's reverse Cuthill-McKee and (d) the natural order, by
exact symbolic elimination (`symbolic/quality.py`). Ratios below 1 mean
ND is cheaper. Host only (NumPy and SciPy): it takes no device.

    python tools/torch/nd_quality.py [scale]

Prints the table (GFLOP), then one JSON line of `compare()`'s rows.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def compare(names=None, scale=1, deep_levels=8):
    from cholesky_tpu_torch.symbolic.quality import (fill_flops, nd_cost,
                                                     rcm_cost, superlu_cost)
    from cholesky_tpu_torch.utils import problems

    gallery = problems.make_gallery(scale)
    out = {}
    for name in (names or gallery):
        n, r, c, v = gallery[name]()
        f_auto, z_auto = nd_cost(n, r, c)
        f_deep, z_deep = nd_cost(n, r, c, levels=deep_levels)
        f_rcm, z_rcm = rcm_cost(n, r, c, v)
        f_mmd, z_mmd = superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        f_cola, z_cola = superlu_cost(n, r, c, v, "COLAMD")
        f_nat, _ = fill_flops(n, r, c)
        out[name] = {"n": n, "nd_auto_flops": f_auto,
                     "nd_deep_flops": f_deep, "rcm_flops": f_rcm,
                     "mmd_flops": f_mmd, "colamd_flops": f_cola,
                     "nat_flops": f_nat, "nd_deep_nnz": z_deep,
                     "rcm_nnz": z_rcm, "mmd_nnz": z_mmd,
                     "deep_vs_rcm": f_deep / f_rcm,
                     "deep_vs_mmd": f_deep / f_mmd,
                     "nnz_vs_rcm": z_deep / z_rcm,
                     "nnz_vs_mmd": z_deep / z_mmd}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scale", type=int, nargs="?", default=1)
    args = ap.parse_args(argv)
    rows = compare(scale=args.scale)
    print(f"{'problem':<12} {'n':>7} {'ND-auto':>9} {'ND-deep':>9} "
          f"{'MMD':>9} {'COLAMD':>9} {'RCM':>9} {'natural':>9} "
          f"{'deep/MMD':>9} {'nnzD/MMD':>9}   (GFLOP)")
    for name, d in rows.items():
        print(f"{name:<12} {d['n']:>7} {d['nd_auto_flops']/1e9:>9.3f} "
              f"{d['nd_deep_flops']/1e9:>9.3f} {d['mmd_flops']/1e9:>9.3f} "
              f"{d['colamd_flops']/1e9:>9.3f} {d['rcm_flops']/1e9:>9.3f} "
              f"{d['nat_flops']/1e9:>9.3f} {d['deep_vs_mmd']:>9.3f} "
              f"{d['nnz_vs_mmd']:>9.3f}")
    out = {"tool": "nd_quality", "scale": args.scale, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

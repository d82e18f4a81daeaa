"""Per-level-class shoot-out of the two routes of the partial front
factorization: the kernel route (`hopper_kernels.factor_slab`, the
hand-written `chol_inv` Cholesky / inverse kernel on each 128-wide diagonal
block, its GEMMs on cuBLAS) against the library route (cuSOLVER's Cholesky
and cuBLAS's TRSM, as `frontal._factor_slab` writes them). The
`cholesky_tpu_torch` counterpart of tools/bench_front_kernels.py.

For each (B, F, W) level class of the 50^3 L8 tree, its root and two
deep-tree leaf classes, both routes factor the same SPD slab: pivot
G G^T / W + F I, boundary 1e-3 * N(0, 1), from a seeded torch.Generator.
Each route is forced, whatever `slab_kernel_eligible` would pick; the
table reports per class both times, the winner, the route the rule takes
(`routed`), the bound of the work (`hopper_kernels.factor_slab_bound` at
the IEEE f32 and TF32 peaks), the kernel's share of the IEEE bound, the
routes' largest difference relative to the largest entry, and the
`chol_inv` launches of one kernel-route call. The products run at the
IEEE f32 rung ("highest"). A time is R calls between two CUDA events,
the least of 3 runs after a warm-up.

    python tools/torch/bench_front_kernels.py [--device cuda]
        [--classes B,F,W ...] [--reps R]

Prints the table, then one JSON line of the results (with the card's name
and power limit, or "cpu"). --device cpu runs the routes' plain CPU
versions (the kernel route through `chol_inv_ref`).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# level classes (B, F, W): the 50^3 L8 plan's levels, then deep-tree leaves
CLASSES = [
    (128, 1440, 864),      # 50^3 leaf level
    (64, 1008, 384),
    (32, 1488, 512),
    (16, 2160, 640),
    (8, 2512, 768),
    (4, 3136, 1024),
    (2, 3760, 1280),
    (1, 2504, 2504),       # root: pivot only
    (256, 512, 256),       # deep-tree small-leaf classes
    (512, 256, 128),
]


def spd_slab(B, F, W, gen, device):
    """[B, F, W] f32: pivot G G^T / W + F I, boundary 1e-3 N(0, 1)."""
    import torch

    g = torch.randn(B, W, W, generator=gen, device=device) / W ** 0.5
    slab = torch.empty(B, F, W, device=device)
    slab[:, :W] = g @ g.mT + F * torch.eye(W, device=device)
    slab[:, W:] = 1e-3 * torch.randn(B, F - W, W, generator=gen,
                                     device=device)
    return slab


def shoot_out(B, F, W, reps, device, gen):
    import torch

    from cholesky_tpu_torch.numeric import frontal
    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric.profile import _timed

    slab = spd_slab(B, F, W, gen, device)
    lib, t_lib = _timed(lambda: frontal._factor_slab_library(slab, W), 3,
                        device, reps=reps)
    row = {"B": B, "F": F, "W": W, "R": reps, "library_ms": t_lib * 1e3,
           "kernel_ms": None, "chol_inv_launches": 0, "max_rel_diff": None,
           "routed": ("kernel" if hk.slab_kernel_eligible(B, W, torch.float32)
                      else "library")}
    for name, peak in (("ieee", hk.FP32_FLOPS), ("tf32", hk.TF32_FLOPS)):
        row[f"bound_{name}_ms"], row[f"bound_{name}_by"] = (
            hk.factor_slab_bound(B, F, W, peak))
    if W >= hk.BS:
        before = hk.LAUNCHES["chol_inv"]
        ker = hk.factor_slab(slab, W)
        row["chol_inv_launches"] = hk.LAUNCHES["chol_inv"] - before
        row["max_rel_diff"] = float((ker.double() - lib.double()).abs().max()
                                    / lib.double().abs().max())
        del ker
        _, t_ker = _timed(lambda: hk.factor_slab(slab, W), 3, device,
                          reps=reps)
        row["kernel_ms"] = t_ker * 1e3
        row["share_ieee"] = row["bound_ieee_ms"] / row["kernel_ms"]
    times = {"library": row["library_ms"], "kernel": row["kernel_ms"]}
    row["winner"] = min((v, k) for k, v in times.items() if v is not None)[1]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--classes", nargs="+", default=None,
                    help="level classes B,F,W (default: the 10 of the table)")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls between two CUDA events")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from cholesky_tpu_torch.numeric.precision import precision_ctx
    from cholesky_tpu_torch.numeric.profile import card

    label = card(args.device)
    device = torch.device(args.device)
    classes = ([tuple(int(x) for x in c.split(",")) for c in args.classes]
               if args.classes else CLASSES)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    print(f"# {label}", flush=True)
    print(f"{'B':>4} {'F':>5} {'W':>5} {'R':>4} {'lib_ms':>9} "
          f"{'kernel_ms':>9} {'bound_ms':>9} {'share':>6} {'winner':>8} "
          f"{'routed':>8} {'rel_diff':>9}", flush=True)
    rows = []
    with precision_ctx("highest"):
        for B, F, W in classes:
            r = shoot_out(B, F, W, args.reps, device, gen)
            rows.append(r)
            ker = "-" if r["kernel_ms"] is None else f"{r['kernel_ms']:.3f}"
            share = ("-" if r["kernel_ms"] is None
                     else f"{r['share_ieee']:.3f}")
            diff = ("-" if r["max_rel_diff"] is None
                    else f"{r['max_rel_diff']:.1e}")
            print(f"{B:>4} {F:>5} {W:>5} {r['R']:>4} {r['library_ms']:>9.3f} "
                  f"{ker:>9} {r['bound_ieee_ms']:>9.3f} {share:>6} "
                  f"{r['winner']:>8} {r['routed']:>8} {diff:>9}", flush=True)
    out = {"tool": "bench_front_kernels", "device": str(device),
           "card": label, "precision": "highest", "classes": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

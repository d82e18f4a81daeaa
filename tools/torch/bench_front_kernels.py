"""Per-level-class shoot-out of the three ways to run the partial front
factorization: the kernel route (`hopper_kernels.factor_slab`, the
hand-written kernels of `kernels/csrc/factor_slab.cu` around `chol_inv`),
the composite it replaced (`hopper_kernels.factor_slab_ref` with
`block_fn=chol_inv`: cuBLAS GEMMs, copies and the `chol_inv` kernel) and
the library route (cuSOLVER's Cholesky and cuBLAS's TRSM, as
`frontal._factor_slab` writes them); beside them the kernels' plain
version (`factor_slab_ref`, no hand kernel at all). The `cholesky_tpu_torch` counterpart
of tools/bench_front_kernels.py.

For each (B, F, W) level class — the JAX tool's ten classes, the routed
levels 6 and 5 of the 50^3 L8 tree and the five routed levels of 140^3 L14
— the three routes factor the same slab, made with a known partial
factor (`known_slab`, from a seeded torch.Generator). Each route is
forced, whatever `slab_kernel_eligible` would pick, at both rungs of the
matmul-precision ladder ("highest": IEEE f32, "tensorfloat32": TF32; the
kernel follows the flag as cuBLAS does). Per class and rung the table
reports the three times and the plain version's, the winner, the kernel's
share of the bound (`hopper_kernels.factor_slab_bound` at the rung's peak)
and its rate of executed flops (`factor_slab_flops` over its time), the
largest difference from the library route (`slab_err`: each part of the
result relative to its own largest entry), and the `factor_slab` and
`chol_inv` launches of one kernel-route call; per class the route the rule
takes (`routed`). A time is R calls between two CUDA events, the least of
3 runs after a warm-up. The kernel and the composite are timed in ROUNDS
turns (kernel first in even rounds, composite first in odd ones): their
times are the medians of the rounds, beside each round's reading and the
rounds in which the kernel was the faster. The library and the plain
version are timed once, after them.

    python tools/torch/bench_front_kernels.py [--device cuda]
        [--classes B,F,W ...] [--reps R]

Prints the table, then one JSON line of the results (with the card's name
and power limit, or "cpu"). --device cpu runs the routes' plain CPU
versions (the flag does not change CPU products).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# level classes (B, F, W): the JAX tool's (the first eight are levels of a
# 50^3 L8 tree, the last two deep-tree leaves), 50^3 L8's own routed
# levels 6 and 5, then the routed levels 13, 10, 9, 8, 7 of 140^3 L14
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
    (64, 1008, 144),       # 50^3 L8 level 6
    (32, 1488, 144),       # 50^3 L8 level 5
    (8192, 512, 256),      # 140^3 L14 levels 13, 10, 9, 8, 7
    (1024, 1264, 136),
    (512, 2032, 296),
    (256, 3192, 296),
    (128, 5224, 600),
]

# turns of kernel and composite timings: one reading can land in a slower
# mode of the card's memory system
ROUNDS = 3

# (rung of the precision ladder, the value of the flag it sets)
RUNGS = (("highest", "ieee"), ("tensorfloat32", "tf32"))


def known_slab(B, F, W, gen, device):
    """A [B, F, W] f32 slab whose partial factor is known: pivot L L^T and
    boundary Y L^T, made in f64 and rounded once, with L lower triangular
    (diagonal U(1, 2), N(0, 1 / W) below it: condition ~5) and Y N(0, 1).
    Returns the slab and that factor, [B, F, W] f64: L over Y.
    Every entry below the pivot's diagonal and in the boundary strip is
    about half the past columns' update, so a kernel that skips or
    misapplies an update, or leaves a part unwritten, is off by O(1) of
    that part's scale (see `slab_err`)."""
    import torch

    slab = torch.empty(B, F, W, device=device)
    exact = torch.empty(B, F, W, dtype=torch.float64, device=device)
    chunk = max(1, (1 << 27) // (F * W))       # ~1 GiB of f64 at a time
    for b0 in range(0, B, chunk):
        n = min(chunk, B - b0)
        L = torch.randn(n, W, W, dtype=torch.float64, generator=gen,
                        device=device).tril_(-1) / W ** 0.5
        L.diagonal(dim1=1, dim2=2).copy_(1.0 + torch.rand(
            n, W, dtype=torch.float64, generator=gen, device=device))
        Y = torch.randn(n, F - W, W, dtype=torch.float64, generator=gen,
                        device=device)
        slab[b0:b0 + n, :W] = L @ L.mT
        slab[b0:b0 + n, W:] = Y @ L.mT
        exact[b0:b0 + n, :W] = L
        exact[b0:b0 + n, W:] = Y
        del L, Y
    return slab, exact


def slab_err(x, ref, W) -> float:
    """The largest difference between two partial factors [B, F, W] of a
    slab, each part relative to ref's largest entry in that part: the
    pivot's diagonal, the pivot below it, the boundary strip (rows W:).
    Measured against the whole result's largest entry, the parts below the
    diagonal would sit under any tolerance: their entries are far smaller
    than the diagonal's."""
    import torch

    d = (x.float() - ref.float()).abs()
    r = ref.float().abs()
    parts = [(d[:, :W].diagonal(dim1=1, dim2=2),
              r[:, :W].diagonal(dim1=1, dim2=2)),
             (torch.tril(d[:, :W], -1), torch.tril(r[:, :W], -1)),
             (d[:, W:], r[:, W:])]
    return max(float(dp.max() / rp.max()) for dp, rp in parts
               if rp.numel() and float(rp.max()) > 0)


def _fmt(x, spec: str) -> str:
    return "-" if x is None else format(x, spec)


def shoot_out(slab, W, reps, device, flag):
    """One rung of one class: the three routes' times (the kernel and the
    composite in ROUNDS turns), the kernel's bound, share, rate and
    launches, its difference from the library."""
    import statistics

    from cholesky_tpu_torch.numeric import frontal
    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric.profile import _timed

    B, F, _ = slab.shape
    lib, t_lib = _timed(lambda: frontal._factor_slab_library(slab, W), 3,
                        device, reps=reps)
    row = {"library_ms": t_lib * 1e3, "kernel_ms": None,
           "composite_ms": None, "plain_ms": None, "factor_slab_launches": 0,
           "chol_inv_launches": 0, "max_rel_diff": None}
    peak = hk.FP32_FLOPS if flag == "ieee" else hk.TF32_FLOPS
    row["bound_ms"], row["bound_by"] = hk.factor_slab_bound(B, F, W, peak)
    if W >= hk.BS:
        before = dict(hk.LAUNCHES)
        ker = hk.factor_slab(slab, W)
        for k in ("factor_slab", "chol_inv"):
            row[f"{k}_launches"] = hk.LAUNCHES[k] - before[k]
        row["max_rel_diff"] = slab_err(ker, lib, W)
        del ker
        routes = {"kernel": lambda: hk.factor_slab(slab, W),
                  "composite": lambda: hk.factor_slab_ref(
                      slab, W, block_fn=hk.chol_inv)}
        times = {name: [] for name in routes}
        for i in range(ROUNDS):
            for name in (("kernel", "composite") if i % 2 == 0
                         else ("composite", "kernel")):
                times[name].append(_timed(routes[name], 3, device,
                                          reps=reps)[1] * 1e3)
        for name, t in times.items():
            row[f"{name}_ms"] = statistics.median(t)
            row[f"{name}_ms_rounds"] = t
        row["kernel_ahead_rounds"] = sum(
            k < c for k, c in zip(times["kernel"], times["composite"]))
        _, t_plain = _timed(lambda: hk.factor_slab_ref(slab, W), 3, device,
                            reps=reps)
        row["plain_ms"] = t_plain * 1e3
        row["share"] = row["bound_ms"] / row["kernel_ms"]
        row["executed_tflops"] = (hk.factor_slab_flops(B, F, W)
                                  / row["kernel_ms"] / 1e9)
    del lib
    times = {"library": row["library_ms"], "kernel": row["kernel_ms"],
             "composite": row["composite_ms"]}
    row["winner"] = min((v, k) for k, v in times.items() if v is not None)[1]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--classes", nargs="+", default=None,
                    help="level classes B,F,W (default: the 17 of CLASSES)")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls between two CUDA events")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from cholesky_tpu_torch.numeric import hopper_kernels as hk
    from cholesky_tpu_torch.numeric.precision import precision_ctx
    from cholesky_tpu_torch.numeric.profile import card

    label = card(args.device)
    device = torch.device(args.device)
    classes = ([tuple(int(x) for x in c.split(",")) for c in args.classes]
               if args.classes else CLASSES)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    print(f"# {label}", flush=True)
    print(f"{'B':>4} {'F':>5} {'W':>5} {'rung':>4} {'kernel_ms':>9} "
          f"{'comp_ms':>9} {'ahead':>5} {'lib_ms':>9} {'bound_ms':>9} "
          f"{'share':>6} {'TFLOP/s':>7} {'winner':>9} {'routed':>7} "
          f"{'rel_diff':>8}", flush=True)
    rows = []
    for B, F, W in classes:
        slab, _ = known_slab(B, F, W, gen, device)
        row = {"B": B, "F": F, "W": W, "R": args.reps,
               "routed": ("kernel" if hk.slab_kernel_eligible(
                   B, W, torch.float32) else "library"),
               "executed_flops": hk.factor_slab_flops(B, F, W),
               "rungs": {}}
        for name, peak in (("ieee", hk.FP32_FLOPS), ("tf32", hk.TF32_FLOPS)):
            row[f"bound_{name}_ms"], row[f"bound_{name}_by"] = (
                hk.factor_slab_bound(B, F, W, peak))
        for rung, flag in RUNGS:
            with precision_ctx(rung):
                r = shoot_out(slab, W, args.reps, device, flag)
            row["rungs"][flag] = r
            print(f"{B:>4} {F:>5} {W:>5} {flag:>4} "
                  f"{_fmt(r['kernel_ms'], '9.3f')} "
                  f"{_fmt(r['composite_ms'], '9.3f')} "
                  f"{r.get('kernel_ahead_rounds', '-'):>3}/{ROUNDS} "
                  f"{r['library_ms']:>9.3f} {r['bound_ms']:>9.3f} "
                  f"{_fmt(r.get('share'), '6.3f')} "
                  f"{_fmt(r.get('executed_tflops'), '7.1f')} "
                  f"{r['winner']:>9} {row['routed']:>7} "
                  f"{_fmt(r['max_rel_diff'], '8.1e')}", flush=True)
        # the IEEE rung's figures at the top level of the row
        ieee = row["rungs"]["ieee"]
        for k in ("kernel_ms", "composite_ms", "plain_ms", "library_ms",
                  "max_rel_diff", "factor_slab_launches", "chol_inv_launches",
                  "winner"):
            row[k] = ieee[k]
        rows.append(row)
        del slab
    out = {"tool": "bench_front_kernels", "device": str(device),
           "card": label, "rungs": [r for r, _ in RUNGS],
           "rounds": ROUNDS, "classes": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

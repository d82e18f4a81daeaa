"""Microbenchmark the primitives the solve chain's level steps are made of.
The `cholesky_tpu_torch` counterpart of tools/prof_scatter.py.

A level step of the banded solve (`frontal._banded_forward` /
`_banded_backward`) moves little data: it is a slice of the work vector,
two batched matvecs, a scatter-add into the boundary rows (forward) or a
gather from them (backward). This times each primitive alone at a level's
shape, B fronts of W pivots and Fb boundary rows over a vector of n
entries: gathers, index sets (random, sorted and a slice), `index_add_`,
the batched matvecs (`torch.bmm`), a whole forward step as the port writes
it, and the floor of one dependent launch. Each is R calls between two
CUDA events, the least of 3 runs after a warm-up, in µs per call.

    python tools/torch/prof_scatter.py [n B W Fb] [--device cuda] [--reps R]

Defaults 125000 512 32 200. Prints one line per primitive, then one JSON
line of the results (with the card's name and power limit, or "cpu").
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=125000)
    ap.add_argument("B", type=int, nargs="?", default=512)
    ap.add_argument("W", type=int, nargs="?", default=32)
    ap.add_argument("Fb", type=int, nargs="?", default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=200,
                    help="calls between two CUDA events")
    args = ap.parse_args(argv)

    import torch

    from cholesky_tpu_torch.numeric.profile import _timed, card

    label = card(args.device)
    device = torch.device(args.device)
    n, B, W, Fb = args.n, args.B, args.W, args.Fb
    if B * W > n:
        raise SystemExit(f"B * W = {B * W} pivots exceed n = {n}")
    print(f"# {label}; n={n} B={B} W={W} Fb={Fb}", flush=True)
    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(a).to(device)

    piv = on(rng.choice(n, size=B * W, replace=False).astype(np.int64))
    piv_sorted = piv.sort().values
    bnd = on(rng.integers(0, n, size=B * Fb).astype(np.int64))
    bg = on(rng.standard_normal(n + 1).astype(np.float32))
    # scaled so that repeated steps keep the work vector's magnitude
    M = on(rng.standard_normal((B, Fb, W)).astype(np.float32)) / W ** 0.5
    Minv = on(rng.standard_normal((B, W, W)).astype(np.float32)) / W ** 0.5
    vals = on(rng.standard_normal(B * W).astype(np.float32))
    contrib = on(rng.standard_normal(B * Fb).astype(np.float32))
    perm = on(rng.permutation(n + 1).astype(np.int64))
    flip = torch.arange(n, -1, -1, device=device)
    y = vals.view(B, W, 1)

    def fwd_step(g):
        """A forward level step as `frontal._banded_forward` writes it: a
        slice, the inverse apply, the boundary product, the scatter-add."""
        yy = torch.bmm(Minv, g[:B * W].view(B, W, 1))
        g.index_add_(0, bnd, torch.bmm(M, yy).reshape(-1), alpha=-1)
        return yy

    # each case gets a fresh copy of the work vector g every run, made
    # outside the timed region (the index sets and adds write into it)
    cases = [
        ("gather [B,W]", lambda g: g[piv]),
        ("gather [B,Fb]", lambda g: g[bnd]),
        ("index set [B,W]", lambda g: g.index_put_((piv,), vals)),
        ("index set [B,W] sorted", lambda g: g.index_put_((piv_sorted,),
                                                          vals)),
        ("slice set [B*W] (banded basis)", lambda g: g[:B * W].copy_(vals)),
        ("index_add_ [B,Fb]", lambda g: g.index_add_(0, bnd, contrib)),
        ("bmm [B,Fb,W]x[B,W] (X apply)", lambda g: torch.bmm(M, y)),
        ("bmm [B,W,W]x[B,W] (inv apply)", lambda g: torch.bmm(Minv, y)),
        ("bmm^T [B,W,Fb]x[B,Fb] (backward X^T)",
         lambda g: torch.bmm(M.transpose(1, 2), g[bnd].view(B, Fb, 1))),
        ("full fwd step (slice+inv+X+add)", fwd_step),
        ("dependent trivial op (g *= c)", lambda g: g.mul_(1.0000001)),
        ("1-D gather [n] (entry/exit relabel)", lambda g: g[flip]),
        ("1-D gather [n] random", lambda g: g[perm]),
        ("bmm inv apply B=2", lambda g: torch.bmm(Minv[:2], y[:2])),
    ]
    rows = []
    for name, fn in cases:
        _, t = _timed(fn, 3, device, prep=bg.clone, reps=args.reps)
        rows.append({"op": name, "us": t * 1e6})
        print(f"{name:<42} {t * 1e6:>9.2f} us/op", flush=True)
    out = {"tool": "prof_scatter", "device": str(device), "card": label,
           "n": n, "B": B, "W": W, "Fb": Fb, "reps": args.reps, "ops": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

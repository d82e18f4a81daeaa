#!/usr/bin/env python3
"""Host walls of the port's factorize() and solve() on one GPU, so that two
trees of the port can be compared in one run on the same card.

    python3 torch_walls.py [--tree DIR] [--shape 50] [--levels 8]
                           [--repeat 30] [--rhs K] [--cli]

`--tree DIR` puts DIR first on the import path: a checkout of another
commit (unpacked with `git archive` into a directory that .gitignore
lists) is then timed by this same script. Run the two trees alternately
(A, B, B, A) and compare within the run. Prints one JSON line: the
package's path, the problem, the cold factor wall, every warm factor wall
and their median, the median solve wall, and the seconds of the regime
plan per factorization where the tree records them. `--rhs K` (K > 1)
solves a seeded [n, K] block instead of one right-hand side (a tree whose
solve takes no block fails there). Exits nonzero when there is no CUDA
device.

`--cli` times the tree's command-line interface instead, as subprocesses
on the card on a --shape^3 L--levels problem written to files: the process
wall of building the kernels (and the native core, where the tree has
one), of importing the package, of a first run (`-o -m --profile
--save-factor --inv-diag --bench`), of the same run without `-m` (the
factor file), and of a run resumed with `--load-factor`, with the
`FACTOR:` / `SOLVE:` / `INVDIAG:` seconds each run prints.
"""

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--shape", type=int, default=50)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=30)
    ap.add_argument("--rhs", type=int, default=1)
    ap.add_argument("--cli", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_walls: no CUDA device", file=sys.stderr)
        return 2
    if args.cli:
        return cli_walls(args)
    import cholesky_tpu_torch
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem((args.shape,) * 3, args.levels,
                                            seed=0)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                device="cuda")
    walls, plan_s = [], []
    for _ in range(1 + args.repeat):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.factorize()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        plan_s.append(getattr(s, "factor_stats", {}).get("plan_s"))
    if args.rhs > 1:
        b = np.random.default_rng(0).standard_normal((n, args.rhs))
    solves = []
    for _ in range(1 + args.repeat // 3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.solve(b)
        torch.cuda.synchronize()
        solves.append(time.perf_counter() - t)
    print(json.dumps({
        "package": os.path.dirname(cholesky_tpu_torch.__file__),
        "problem": f"{args.shape}^3 L{args.levels}", "n": n,
        "factor_wall_cold_s": walls[0], "factor_wall_warm_s": walls[1:],
        "factor_wall_warm_median_s": statistics.median(walls[1:]),
        "plan_regimes_s": plan_s,
        "rhs": args.rhs,
        "solve_wall_median_s": statistics.median(solves[1:]),
        "last_solve": getattr(s, "last_solve", None),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def cli_walls(args) -> int:
    """Process walls of the tree's CLI on one problem (see the module's
    docstring); one JSON line."""
    import ast
    import subprocess
    import tempfile

    import torch

    from cholesky_tpu_torch.io import mmio, ordering as ordio
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    tree = os.path.abspath(args.tree)
    n, r, c, v, o, cl, b = generate_problem((args.shape,) * 3, args.levels,
                                            seed=0)
    env = dict(os.environ, PYTHONPATH=tree)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        f = {k: os.path.join(d, k) for k in (
            "m.mtx", "ord.txt", "clust.txt", "b.mtx", "sol.txt", "factor.mtx",
            "ck.npz", "diag.txt")}
        mmio.write_coo(f["m.mtx"], r, c, v, (n, n), symmetry="hermitian")
        ordio.write_ordering(f["ord.txt"], o)
        ordio.write_clusters(f["clust.txt"], cl)
        mmio.write_array(f["b.mtx"], b)
        cli = [sys.executable, "-m", "cholesky_tpu_torch.cli", "-i",
               f["m.mtx"], "-s", f["ord.txt"], "-c", f["clust.txt"], "-b",
               f["b.mtx"], "--dtype", "float32", "--device", "cuda", "-o",
               f["sol.txt"]]
        first = ["--profile", "--save-factor", f["ck.npz"], "--inv-diag",
                 f["diag.txt"], "--bench"]
        build = ("from cholesky_tpu_torch.kernels import build; "
                 "build.load('chol_inv'); import importlib.util as u; "
                 "u.find_spec('cholesky_tpu_torch.native') and __import__("
                 "'cholesky_tpu_torch.native.ext', fromlist=['ext'])"
                 ".available()")
        runs = (("build", [sys.executable, "-c", build]),
                ("import", [sys.executable, "-c",
                            "import torch, cholesky_tpu_torch.api"]),
                ("first", cli + ["-m", f["factor.mtx"]] + first),
                ("first_without_m", cli + first),
                ("resumed", cli + ["--load-factor", f["ck.npz"]]))
        for name, cmd in runs:
            t = time.perf_counter()
            p = subprocess.run(cmd, cwd=d, env=env, capture_output=True,
                               text=True, timeout=900)
            wall = time.perf_counter() - t
            if p.returncode != 0:
                print(p.stderr[-3000:], file=sys.stderr)
                return 1
            tagged = {ln.split(": ", 1)[0]: ast.literal_eval(
                ln.split(": ", 1)[1])["time_s"]
                for ln in p.stdout.splitlines()
                if ln.startswith(("FACTOR: ", "SOLVE: ", "INVDIAG: "))}
            out[name] = {"wall_s": wall, **tagged}
    print(json.dumps({
        "package": tree, "problem": f"{args.shape}^3 L{args.levels}",
        "n": n, "cli": out, "device": torch.cuda.get_device_name(0)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""First-use cost of a fresh process. The `cholesky_tpu_torch` counterpart
of the JAX package's tools/warm_start.py.

A fresh interpreter times what a production caller pays from its start:
importing torch and the port, loading the hand-written kernels (built by
nvcc at first use, else loaded from `kernels/_build`) and the native host
core (g++ at first use, else cached), the host plan, the first and a warm
`factorize()`, the first and a warm `solve()`, and the residual. Every
timer stops after a device synchronize. `cached_kernel_libraries` counts
the kernel libraries already built before this process began loading
them: a later process finds them, as the JAX package's persistent compile
cache serves a later process.

tools/torch/bench.py spawns it after the parent freed its solvers, with
the parent's shape, levels, dtype, cluster size and device:

    python tools/torch/warm_start.py [--shape 50,50,50] [--levels 8]
        [--dtype float32] [--cluster-size 16] [--device cuda]

Prints a table on stderr and, last, one JSON line on stdout; the exit code
is 1 when the residual misses 1e-10. It runs on the card unless --device
cpu is given; without a card it raises.
"""
import time

T_START = time.perf_counter()

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

TOL = 1e-10


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="50,50,50",
                    type=lambda s: tuple(int(x) for x in s.split(",")))
    ap.add_argument("--levels", default=8, type=int)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--cluster-size", default=16, type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    import numpy as np
    import torch

    import cholesky_tpu_torch  # noqa: F401
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.api import _resolve_device
    from cholesky_tpu_torch.kernels import build as kbuild
    from cholesky_tpu_torch.native import build as nbuild
    from cholesky_tpu_torch.native import ext
    from cholesky_tpu_torch.numeric.profile import card
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    import_s = time.perf_counter() - t0
    label = card(args.device)           # raises without a card
    device = _resolve_device(args.device)
    cuda = device.type == "cuda"

    def timed(fn):
        if cuda:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t, out

    # the kernels run on the card only: on the CPU the wrappers take their
    # plain versions and nothing is built
    cached = len(glob.glob(os.path.join(kbuild.BUILD_DIR, "lib*.so")))
    kernels = {}
    for name in (kbuild.KERNELS if cuda else ()):
        s, _ = timed(lambda: kbuild.load(name))
        kernels[name] = {"load_s": s,
                         "cached": kbuild.BUILD_INFO[name]["cached"],
                         "nvcc_s": kbuild.BUILD_INFO[name]["seconds"]}
    native_s, native_ok = timed(ext.available)
    native = {"load_s": native_s, "available": native_ok,
              **{k: nbuild.BUILD_INFO.get(k) for k in ("cached", "seconds")}}

    dtype = np.dtype(args.dtype)
    plan_s, (solver, b) = timed(lambda: _plan(
        SparseCholesky, generate_problem, args, dtype, device))

    def factorize():        # returns nothing: panels kept alive here would
        solver.factorize()  # sit on the device beside the next factor's

    factor_first_s, _ = timed(factorize)
    factor_warm_s, _ = timed(factorize)
    solve_first_s, _ = timed(lambda: solver.solve(b, tol=TOL))
    solve_warm_s, x = timed(lambda: solver.solve(b, tol=TOL))
    res = float(solver.residual(b, x))
    out = {"tool": "warm_start",
           "key": "x".join(map(str, args.shape)) + f"_L{args.levels}",
           "n": int(solver.plan.n), "dtype": args.dtype,
           "cluster_size": args.cluster_size, "device": str(device),
           "card": label, "cached_kernel_libraries": cached,
           "import_s": import_s, "kernels": kernels, "native": native,
           "plan_s": plan_s, "factor_first_s": factor_first_s,
           "factor_warm_s": factor_warm_s, "solve_first_s": solve_first_s,
           "solve_warm_s": solve_warm_s,
           "sweeps": solver.last_solve["sweeps"]
           + solver.last_solve["host_sweeps"],
           "residual": res, "residual_ok": res <= TOL}
    out["process_total_s"] = time.perf_counter() - T_START
    log(f"# {label}: {out['key']} n={out['n']}")
    for k in ("import_s", "plan_s", "factor_first_s", "factor_warm_s",
              "solve_first_s", "solve_warm_s", "process_total_s"):
        log(f"{k:<16} {out[k]:10.4f}")
    log(f"kernels {kernels} (cached libraries {cached}); native {native}; "
        f"residual {res:.3e}")
    print(json.dumps(out), flush=True)
    return out


def _plan(cls, generate_problem, args, dtype, device):
    """The solver of the parent's problem with its host plan built, and the
    right-hand side."""
    n, r, c, v, o, cl, b = generate_problem(
        args.shape, args.levels, cluster_size=args.cluster_size)
    solver = cls.from_coo(n, r, c, v, o, cl, dtype=dtype, device=device)
    solver.fplan
    return solver, b


if __name__ == "__main__":
    sys.exit(0 if main()["residual_ok"] else 1)

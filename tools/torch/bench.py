#!/usr/bin/env python
"""Benchmark of the port's sparse Cholesky factorization on the card. The
`cholesky_tpu_torch` counterpart of the JAX package's bench.py.

The headline is `factor_gflops`: the useful FLOPs of the cluster-level
schedule (`verify/schedule.schedule_flops`, what a per-cluster BLAS
implementation of the reference executes) over the median synchronized
wall of warm `factorize()` calls, on a grid Laplacian under geometric
nested dissection (default 50^3 L8, 125,000 dofs), f32 factor with
mixed-precision refinement to the 1e-10 residual contract.

Rows:
  primary     the factor chain at precision="default" (TF32 on the card):
              `--iters` warm factorizations (median, least and quartiles of
              the host walls, each stopped after a device synchronize; the
              median of CUDA-event times around the same calls), the
              launches of one warm factorization, warm solves at tol=1e-10
              with their sweeps, one factor + solve pair, the f64 host
              residual, the peak device bytes; then the production row at
              the AUTO rung (IEEE at 50^3): its factor and solve walls and
              residual. Executed FLOPs (`utils/capacity.frontal_flops`) and
              padding efficiency beside the useful ones.
  peak        library yardsticks at the IEEE and TF32 flags, by CUDA
              events: a 4096^3 matmul, the 50^3 root front's X X^T at
              2504 x 1256 (and, with --kernel-rates, cholesky_ex at 2504).
  fixture_3375  the reference's 15^3 L5 fixture read through from_files
              (`--fixture-dir`, else a stand-in generated into a
              temporary directory with the port's writers) at AUTO.
  irregular_elasticity  vector_laplacian(44^3, 3) (255,552 dofs) through
              from_matrix (ordering on the native core) at AUTO, with the
              regime plan and its peak estimate beside the measured peak.
  warm_start  tools/torch/warm_start.py in a fresh interpreter on the
              same problem (shape, levels, dtype, cluster size, device),
              after this process freed its solvers.

    python tools/torch/bench.py [--shape 50,50,50] [--levels 8]
        [--dtype float32] [--iters 10] [--quick] [--cluster-size 16]
        [--measure-baseline] [--kernel-rates] [--no-extras]
        [--fixture-dir DIR] [--device cuda]

--quick: 20^3 L5 and no extras. --measure-baseline replays the schedule
with NumPy on the host (`verify/replay.replay_schedule`) and reports its
GFLOP/s. --kernel-rates reports the library yardsticks alone.

Prints a table on stderr and, last, one JSON line on stdout. A row that
raises is recorded as {"error", "traceback_tail"} and the other rows still
run; the exit code is 1 when a row failed or missed its residual. It runs
on the card unless --device cpu is given; without a card it raises.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

TOL = 1e-10                        # the solver's relative-residual contract
TAIL = 12                          # lines of a traceback or stderr kept
WARM_START_TIMEOUT_S = 900
DENSE_REPLAY_MAX_GIB = 32          # --measure-baseline's dense host matrix

# Host schedule-replay GFLOP/s, measured with --measure-baseline on the
# host of an NVIDIA H100 80GB HBM3 machine (NumPy + its BLAS executing the
# per-cluster op schedule, the reference's execution model), PINNED_HOST_CPU
# as lscpu names it. 50^3 cannot be replayed densely (a 125,000^2 matrix),
# so its key reuses the 20^3 rate, as the JAX package's bench.py does. A
# key without a rate gives vs_baseline null.
PINNED_HOST_BASELINE_GFLOPS = {
    "50x50x50_L8": 2.4462197447550063,
    "27x27x27_L6": 3.4535635298867198,
    "20x20x20_L5": 2.4462197447550063,
}
PINNED_HOST_CPU = ("Model name: unknown; Vendor ID: GenuineIntel; "
                   "CPU family: 6; Model: 207; CPU(s): 8")

FIXTURE_FILES = ("lapl_15_3.mtx", "lapl_15_3_ord_5.txt",
                 "lapl_15_3_clust_5.txt", "B_3375x1.mtx")
FIXTURE_SPEC = ((15, 15, 15), 5)   # what the stand-in generates
IRREGULAR = ((44, 44, 44), 3)      # vector_laplacian(shape, ncomp)

GEMM_N = 4096                      # the matmul peak's square product
ROOT_MK = (2504, 1256)             # the 50^3 L8 root front's Schur shape
POTRF_N = 2504


def parse_shape(s):
    return tuple(int(x) for x in s.split(","))


def problem_key(args):
    """"50x50x50_L8": the key of PINNED_HOST_BASELINE_GFLOPS."""
    return "x".join(map(str, args.shape)) + f"_L{args.levels}"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_calls(fn, n, device):
    """n calls of fn: their host walls (each stopped after a device
    synchronize) and, on a card, the CUDA-event seconds around the same
    calls (None on the CPU)."""
    import torch

    cuda = device.type == "cuda"
    walls, events = [], []
    for _ in range(n):
        _sync(device)
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t = time.perf_counter()
        fn()
        if cuda:
            e1.record()
        _sync(device)
        walls.append(time.perf_counter() - t)
        if cuda:
            events.append(e0.elapsed_time(e1) / 1e3)
    return walls, (events if cuda else None)


def spread(xs, name):
    """{name}_s (median), _min_s, _q1_s, _q3_s of the samples xs."""
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return {f"{name}_s": float(med), f"{name}_min_s": float(min(xs)),
            f"{name}_q1_s": float(q1), f"{name}_q3_s": float(q3)}


def median(xs):
    return None if xs is None else float(np.median(xs))


def once(fn, device):
    """Seconds of one synchronized call of fn. Its result is dropped: a
    factorization's panels kept alive here would sit on the device beside
    the next one's."""
    _sync(device)
    t = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t


def first_factorization(solver, device):
    """Seconds of a solver's first factorization and its peak device bytes
    above what was allocated when it began (None on the CPU); the peak
    statistic is reset before it, so a later read covers the row."""
    reset_peak(device)
    seconds = once(solver.factorize, device)
    peak = peak_bytes(device)
    return seconds, (None if peak is None
                     else peak - solver.factor_stats["allocated_at_start"])


def useful_flops(solver):
    """(the cluster schedule's useful FLOPs, its op list) of a solver's
    plan and matrix."""
    from cholesky_tpu_torch.symbolic.fill import analyze_fill
    from cholesky_tpu_torch.verify import schedule

    ops = schedule.generate_schedule(analyze_fill(
        solver.plan, solver.rows, solver.cols, solver.vals))
    return schedule.schedule_flops(ops), ops


def rung(solver):
    """The rung a solver resolves, as "<name> ([auto, ]<flag>)": "auto"
    where the solver was given no rung, the float32 flag it sets (f64
    products read none)."""
    from cholesky_tpu_torch.numeric.precision import fp32_flag

    p = solver.precision
    flag = fp32_flag(p) if solver.dtype == np.float32 else "float64"
    auto = "auto, " if solver._precision is None else ""
    return f"{p or 'default'} ({auto}{flag})"


def regime_plan(solver):
    """Per level the front batch, widths and the regime plan's entry."""
    fp = solver.fplan
    plan = solver.regimes.describe()
    return [{"B": 1 << lvl, "F": int(fp.F[lvl]), "W": int(fp.W[lvl]),
             **plan[lvl]} for lvl in range(fp.levels)]


def peak_bytes(device):
    import torch

    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def reset_peak(device):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def factor_and_solve(solver, b, iters, device, name=""):
    """The factor / solve timings of one solver, already factored once:
    the spread of `iters` warm factorizations, their CUDA-event median,
    the launches of one warm factorization, a first and `iters` warm
    solves, the residual. Keys carry `name` as a suffix."""
    from cholesky_tpu_torch.numeric import hopper_kernels as hk

    walls, events = timed_calls(solver.factorize, iters, device)
    before = dict(hk.LAUNCHES)
    once(solver.factorize, device)
    launches = {k: hk.LAUNCHES[k] - before[k] for k in hk.LAUNCHES}
    first = once(lambda: solver.solve(b, tol=TOL), device)
    swalls, _ = timed_calls(lambda: solver.solve(b, tol=TOL), iters, device)
    x = solver.solve(b, tol=TOL)
    sweeps = solver.last_solve["sweeps"] + solver.last_solve["host_sweeps"]
    res = float(solver.residual(b, x))
    return {**{k + name: v for k, v in spread(walls, "factor_wall").items()},
            f"factor_walls_s{name}": walls,
            f"factor_device_s{name}": median(events),
            f"launches{name}": launches,
            f"solve_first_s{name}": first,
            f"solve_wall_s{name}": median(swalls),
            f"solve_sweeps{name}": sweeps,
            f"residual{name}": res}


def bench_solver_row(solver, b, iters, device):
    """A solver's row at its own rung: the schedule's useful FLOPs beside
    the executed ones, the first factorization (seconds, peak beside the
    plan's estimate), factor_and_solve, factor_gflops, the row's peak and
    the regime plan."""
    from cholesky_tpu_torch.utils import capacity

    t0 = time.perf_counter()
    useful, ops = useful_flops(solver)
    schedule_s = time.perf_counter() - t0
    executed = capacity.frontal_flops(solver.fplan)
    precision = rung(solver)            # resolve AUTO before factoring
    first, factor_peak = first_factorization(solver, device)
    out = {"n": solver.plan.n, "levels": int(solver.plan.levels),
           "useful_flops": useful, "useful_gflop": round(useful / 1e9, 1),
           "executed_flops": executed,
           "padding_efficiency": capacity.padding_efficiency(solver.fplan,
                                                             useful),
           "schedule_ops": len(ops), "schedule_s": schedule_s,
           "precision": precision, "factor_first_s": first,
           "factor_peak_bytes": factor_peak,
           "plan_peak_estimate_bytes": solver.regimes.peak_bytes}
    out.update(factor_and_solve(solver, b, iters, device))
    out["max_memory_allocated"] = peak_bytes(device)
    out["factor_gflops"] = useful / out["factor_wall_s"] / 1e9
    out["residual_ok"] = out["residual"] <= TOL
    out["regime_plan"] = regime_plan(solver)
    return out


def bench_primary(args, device, base):
    """The primary row: the factor chain at precision="default", then the
    production row at the AUTO rung (see the module docstring)."""
    import torch

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    key = problem_key(args)
    dtype = np.dtype(args.dtype)
    t0 = time.perf_counter()
    n, r, c, v, o, cl, b = generate_problem(
        args.shape, args.levels, cluster_size=args.cluster_size)
    solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                     device=device, precision="default")
    fp = solver.fplan
    plan_s = time.perf_counter() - t0
    out = {"key": key, "dtype": args.dtype, "iters": args.iters,
           "plan_s": plan_s, **bench_solver_row(solver, b, args.iters,
                                                device)}
    out["factor_precision"] = out.pop("precision")
    out["t_pair_wall_s"] = once(
        lambda: (solver.factorize(), solver.solve(b, tol=TOL)), device)
    out["value"] = out.pop("factor_gflops")
    out["vs_baseline"] = out["value"] / base if base else None
    log(f"# problem {key}: n={n}, levels={out['levels']}, plan "
        f"{plan_s:.2f}s; schedule {out['schedule_ops']} ops, "
        f"{out['useful_flops'] / 1e9:.1f} GFLOP useful, "
        f"{out['executed_flops'] / 1e9:.1f} GFLOP executed "
        f"({out['schedule_s']:.2f}s)")
    log(f"# factor ({out['factor_precision']}): median "
        f"{out['factor_wall_s'] * 1e3:.2f} ms of {args.iters} (min "
        f"{out['factor_wall_min_s'] * 1e3:.2f}), device "
        f"{fmt_ms(out['factor_device_s'])}, {out['value']:.1f} GFLOP/s; "
        f"launches {out['launches']}")
    log(f"# solve {out['solve_wall_s'] * 1e3:.2f} ms "
        f"({out['solve_sweeps']} sweeps), residual {out['residual']:.3e}")

    # the production row: the AUTO rung on the same plan, after the
    # default chain's factor is freed
    del solver
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prod = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                   device=device)
    prod._fplan = fp               # the plan measured above
    out["solve_precision"] = rung(prod)
    if prod.precision is None:          # AUTO is the default chain's rung
        out["residual_production"] = out["residual"]
        return out
    out["factor_first_s_production"] = once(prod.factorize, device)
    out.update(factor_and_solve(prod, b, args.iters, device, "_production"))
    out["residual_ok"] = bool(out["residual_ok"]
                              and out["residual_production"] <= TOL)
    log(f"# production ({out['solve_precision']}): factor "
        f"{out['factor_wall_s_production'] * 1e3:.2f} ms, solve "
        f"{out['solve_wall_s_production'] * 1e3:.2f} ms "
        f"({out['solve_sweeps_production']} sweeps), residual "
        f"{out['residual_production']:.3e}")
    return out


def fmt_ms(s):
    return "not measured" if s is None else f"{s * 1e3:.2f} ms"


def write_stand_in(directory, shape, levels_):
    """The four fixture files of a grid Laplacian, as the repo's test
    fixtures generate them when the reference's are absent: matrix,
    ordering, clusters and an integer right-hand side. Returns their
    paths."""
    from cholesky_tpu_torch.io import mmio
    from cholesky_tpu_torch.io import ordering as ordio
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem(shape, levels_)
    paths = [os.path.join(directory, f) for f in (
        "A.mtx", "ord.txt", "clust.txt", "B.mtx")]
    mmio.write_coo(paths[0], r, c, v, (n, n), symmetry="hermitian")
    ordio.write_ordering(paths[1], o)
    ordio.write_clusters(paths[2], cl)
    mmio.write_array(paths[3], b, field="integer")
    return paths


def bench_fixture(device, dtype, iters, fixture_dir=None,
                  spec=FIXTURE_SPEC):
    """The fixture row: the reference's lapl_3375x3375 files from
    `fixture_dir` when they are all there, else the stand-in of `spec`
    (shape, levels) written to a temporary directory; read back through
    from_files and run at AUTO, with the default rung's solve beside it
    where AUTO differs."""
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.io import mmio

    with tempfile.TemporaryDirectory() as tmp:
        paths = ([os.path.join(fixture_dir, f) for f in FIXTURE_FILES]
                 if fixture_dir else None)
        if paths and all(os.path.isfile(p) for p in paths):
            source = os.path.abspath(fixture_dir)
        else:
            paths = write_stand_in(tmp, *spec)
            source = (f"generated stand-in: {'x'.join(map(str, spec[0]))} "
                      f"L{spec[1]} grid Laplacian")
        mtx, ordf, clustf, rhs = paths
        b = mmio.read_array(rhs).reshape(-1)
        solver = SparseCholesky.from_files(mtx, ordf, clustf, dtype=dtype,
                                           device=device)
        out = {"source": source,
               **bench_solver_row(solver, b, iters, device)}
        if solver.precision is not None:
            sd = SparseCholesky.from_files(mtx, ordf, clustf, dtype=dtype,
                                           device=device,
                                           precision="default")
            sd.factorize()
            sd.solve(b, tol=TOL)
            walls, _ = timed_calls(lambda: sd.solve(b, tol=TOL), iters,
                                   device)
            out["solve_wall_s_default"] = median(walls)
            out["residual_default"] = float(sd.residual(
                b, sd.solve(b, tol=TOL)))
    return out


def bench_irregular(device, dtype, iters, shape=IRREGULAR[0],
                    ncomp=IRREGULAR[1]):
    """The irregular row: a vector-elasticity-type operator with no
    ordering files, ordered by from_matrix (nested dissection or minimum
    degree on the native core), factored and solved at AUTO."""
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils import problems

    n, r, c, v = problems.vector_laplacian(shape, ncomp)
    b = np.random.default_rng(7).standard_normal(n)
    t0 = time.perf_counter()
    solver = SparseCholesky.from_matrix(n, r, c, v, dtype=dtype,
                                        device=device)
    ordering_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.fplan
    plan_s = time.perf_counter() - t0
    return {"problem": f"vector_laplacian({'x'.join(map(str, shape))}, "
                       f"{ncomp}) elasticity-type",
            "ordering_wall_s": ordering_s,
            "ordering": dict(solver.ordering_info),
            "plan_s": plan_s, **bench_solver_row(solver, b, iters, device)}


def library_rates(device, potrf=False, gemm_n=GEMM_N, root_mk=ROOT_MK,
                  potrf_n=POTRF_N, iters=10):
    """Library yardsticks in TFLOP/s at the IEEE and TF32 flags: a
    gemm_n^3 torch.matmul (2 n^3), the root front's X X^T by torch.matmul
    (2 m^2 k), and with `potrf` torch.linalg.cholesky_ex of an SPD
    [potrf_n, potrf_n] (n^3 / 3). A time is the median of 5 runs of
    `iters` calls between CUDA events (host walls on the CPU) after a
    warm-up."""
    import torch

    from cholesky_tpu_torch.numeric.precision import precision_ctx

    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(gemm_n, gemm_n, device=device, generator=gen)
    m, k = root_mk
    x = torch.randn(m, k, device=device, generator=gen)
    y = torch.randn(potrf_n, potrf_n, device=device, generator=gen)
    spd = y @ y.T + potrf_n * torch.eye(potrf_n, device=device)

    def seconds(fn):
        fn()
        runs = []
        for _ in range(5):
            walls, events = timed_calls(
                lambda: [fn() for _ in range(iters)], 1, device)
            runs.append((events or walls)[0] / iters)
        return median(runs)

    out = {}
    for flag, name in (("ieee", "highest"), ("tf32", "default")):
        with precision_ctx(name):
            gemm = 2.0 * gemm_n ** 3 / seconds(lambda: a @ a) / 1e12
            syrk = 2.0 * m * m * k / seconds(lambda: x @ x.T) / 1e12
            out[f"gemm_peak_tflops_{flag}"] = gemm
            out[f"syrk_root_tflops_{flag}"] = syrk
            out[f"peak_fraction_{flag}"] = syrk / gemm
            if potrf:
                out[f"potrf_{potrf_n}_tflops_{flag}"] = (
                    potrf_n ** 3 / 3.0
                    / seconds(lambda: torch.linalg.cholesky_ex(spd)) / 1e12)
    return out


def host_replay(solver, ops):
    """The schedule replayed on the host with NumPy in f64 on the dense
    permuted lower triangle of the solver's matrix: (the factor, seconds
    of the replay)."""
    import scipy.sparse

    from cholesky_tpu_torch.verify import replay

    n = solver.plan.n
    off = solver.rows != solver.cols
    full = scipy.sparse.coo_matrix(
        (np.concatenate([solver.vals, solver.vals[off]]),
         (np.concatenate([solver.rows, solver.cols[off]]),
          np.concatenate([solver.cols, solver.rows[off]]))),
        shape=(n, n)).toarray()
    perm = solver.plan.perm
    pmat = np.tril(full[np.ix_(perm, perm)])
    del full
    t0 = time.perf_counter()
    mat = replay.replay_schedule(pmat, ops)
    return mat, time.perf_counter() - t0


LSCPU_FIELDS = ("Model name", "Vendor ID", "CPU family", "Model", "CPU(s)")


def host_cpu():
    """The host's CPU as `lscpu` names it: LSCPU_FIELDS joined, "; "
    between them (None without lscpu)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    return "; ".join(f"{k}: {fields[k].strip()}" for k in LSCPU_FIELDS
                     if k in fields) or None


def measure_baseline(args, device):
    """--measure-baseline: the host replay's GFLOP/s on the problem."""
    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.utils.laplacian import generate_problem

    key = problem_key(args)
    n, r, c, v, o, cl, _ = generate_problem(
        args.shape, args.levels, cluster_size=args.cluster_size)
    dense_gib = n * n * 8 / 2 ** 30
    if dense_gib > DENSE_REPLAY_MAX_GIB:
        raise ValueError(
            f"--measure-baseline replays a dense {n}^2 matrix "
            f"({dense_gib:.0f} GiB) on the host: use --quick or a smaller "
            f"--shape")
    solver = SparseCholesky.from_coo(n, r, c, v, o, cl, device=device)
    useful, ops = useful_flops(solver)
    _, wall = host_replay(solver, ops)
    out = {"metric": "cpu_baseline_factor_gflops",
           "value": useful / wall / 1e9, "unit": "GFLOP/s",
           "vs_baseline": 1.0, "key": key, "n": n, "useful_flops": useful,
           "wall_s": wall, "host_cpu": host_cpu()}
    log(f"# host replay {key}: {len(ops)} ops in {wall:.3f}s, "
        f"{out['value']:.3f} GFLOP/s on {out['host_cpu']}")
    return out


def warm_start_cmd(args):
    """The command of the fresh-process row: tools/torch/warm_start.py on
    this run's problem and device."""
    return [sys.executable,
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "warm_start.py"),
            "--shape", ",".join(map(str, args.shape)),
            "--levels", str(args.levels), "--dtype", args.dtype,
            "--cluster-size", str(args.cluster_size),
            "--device", args.device]


def spawn_warm_start(cmd, timeout=WARM_START_TIMEOUT_S):
    """Run cmd, a fresh interpreter, and return the JSON line it printed
    last, with its return code and process wall; on a nonzero return code
    or no JSON line, an error with the return code and the tail of its
    stderr."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        return {"error": f"warm_start exited {proc.returncode}"
                         + ("" if lines else " without a JSON line"),
                "returncode": proc.returncode, "process_wall_s": wall,
                "stderr_tail": proc.stderr.strip().splitlines()[-TAIL:]}
    return {**json.loads(lines[-1]), "returncode": 0,
            "process_wall_s": wall}


def row(name, fn, failed):
    """fn()'s row; an exception is recorded as the row's error with the
    tail of its traceback. `name` joins `failed` when the row errs, misses
    its residual or its process failed."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — one row never stops the others
        out = {"error": f"{type(e).__name__}: {e}",
               "traceback_tail": traceback.format_exc().strip()
               .splitlines()[-TAIL:]}
    if ("error" in out or out.get("residual_ok") is False
            or out.get("returncode", 0) != 0):
        failed.append(name)
        log(f"# {name} FAILED: {out.get('error', out)}")
    return out


def exit_code(result) -> int:
    return 1 if result.get("failed") else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="50,50,50", type=parse_shape)
    ap.add_argument("--levels", default=8, type=int)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--iters", default=10, type=int,
                    help="warm factorizations and solves timed (>= 10)")
    ap.add_argument("--quick", action="store_true",
                    help="20^3 L5 and no extras")
    ap.add_argument("--measure-baseline", action="store_true",
                    help="replay the schedule on the host and report its "
                         "GFLOP/s")
    ap.add_argument("--cluster-size", default=16, type=int,
                    help="interval-0 cluster granularity for FLOP "
                         "accounting")
    ap.add_argument("--kernel-rates", action="store_true",
                    help="library yardsticks alone (with cholesky_ex)")
    ap.add_argument("--no-extras", action="store_true",
                    help="skip the peak, fixture, irregular and warm-start "
                         "rows")
    ap.add_argument("--fixture-dir", default=None,
                    help="a directory holding the reference's "
                         "lapl_3375x3375 files (else a generated stand-in)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.iters < 10:
        ap.error("--iters must be at least 10")
    if args.quick:
        args.shape, args.levels = (20, 20, 20), 5
        args.no_extras = True

    import torch

    from cholesky_tpu_torch.api import _resolve_device
    from cholesky_tpu_torch.numeric.profile import card

    label = card(args.device)           # raises without a card
    device = _resolve_device(args.device)
    log(f"# {label}")
    head = {"device": str(device), "card": label,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    if args.kernel_rates:
        rates = library_rates(device, potrf=True)
        result = {"metric": "kernel_rates", "unit": "TFLOP/s",
                  "value": rates["syrk_root_tflops_tf32"],
                  "vs_baseline": None, **rates, **head}
        for k, x in rates.items():
            log(f"# {k}: {x:.2f}")
    elif args.measure_baseline:
        result = {**measure_baseline(args, device), **head}
    else:
        result = run(args, device, head)
    print(json.dumps(result), flush=True)
    return result


def run(args, device, head):
    """The primary row, then (unless --no-extras) the peak, fixture,
    irregular and warm-start rows."""
    import gc

    import torch

    key = problem_key(args)
    base = PINNED_HOST_BASELINE_GFLOPS.get(key)
    failed = []
    dtype = np.dtype(args.dtype)
    primary = row("primary", lambda: bench_primary(args, device, base),
                  failed)
    result = {"metric": "factor_gflops", "value": primary.get("value"),
              "unit": "GFLOP/s", "vs_baseline": primary.get("vs_baseline"),
              **head, "host_baseline_gflops": base,
              "host_baseline_cpu": PINNED_HOST_CPU,
              **{k: x for k, x in primary.items()
                 if k not in ("value", "vs_baseline")}}
    if not args.no_extras:
        result["peak"] = row("peak", lambda: library_rates(device), failed)
        log(f"# peak: {result['peak']}")
        result["fixture_3375"] = row("fixture_3375", lambda: bench_fixture(
            device, dtype, args.iters, args.fixture_dir), failed)
        result["irregular_elasticity"] = row(
            "irregular_elasticity",
            lambda: bench_irregular(device, dtype, args.iters), failed)
        for name in ("fixture_3375", "irregular_elasticity"):
            r = result[name]
            if "error" not in r:
                log(f"# {name}: n={r['n']}, factor "
                    f"{r['factor_wall_s'] * 1e3:.2f} ms "
                    f"({r['factor_gflops']:.1f} GFLOP/s), solve "
                    f"{r['solve_wall_s'] * 1e3:.2f} ms, {r['precision']}, "
                    f"residual {r['residual']:.3e}")
        # a fresh process on this run's problem; this one's solvers are
        # gone (each row's were locals) and its cache is returned first
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        result["warm_start"] = row(
            "warm_start", lambda: spawn_warm_start(warm_start_cmd(args)),
            failed)
        log(f"# warm_start: {result['warm_start']}")
    result["failed"] = failed
    return result


if __name__ == "__main__":
    sys.exit(exit_code(main()))

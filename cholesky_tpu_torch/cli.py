"""Command-line interface of the port, flag-compatible with the reference solver
binary and with `python -m cholesky_tpu.cli`.

The reference is driven as `regent.py mmat.rg -i M.mtx -s ord.txt -c clust.txt
-b B.mtx -o sol.txt -m factor.mtx [-p perm.mtx] [-d dbgdir] [--iterations N]`
plus Legion/Realm runtime flags (mmat.rg:1072-1093; test_matrices.py:23-35).
It accepts the same flags; Legion-specific runtime flags (-ll:cpu,
-ll:csize, -fflow, -fcuda, -lg:*) are accepted and ignored so the reference's
test harness command lines work verbatim. It prints the JAX package's CLI lines
(`Iterations:`, `M: N: nz: typecode:`, `levels:`, `separators:`,
`Done fill.`, `Done factoring Iteration:`, `FACTOR: {...}`, `Done solve.`,
`SOLVE: {...}`, and the `--bench` JSON).

Of its own: `--device cuda|cpu` (default cuda: without a card the run fails,
it never computes on the CPU unasked) and `--budget BYTES` (the
factorization's memory budget, `numeric/regimes.py`).

The `FACTOR:` and `SOLVE:` times are synchronized walls: the device is
synchronized before each clock read. `FACTOR:` covers what `factorize()`
does: the assembly of the fronts on the device and the factorization.

`--inv-diag FILE` writes diag(A^-1) in original dof order, one value per
line, and prints an `INVDIAG:` line (selected inversion, as the JAX CLI).

`--signs FILE` (one +1 / -1 per dof, read with `np.loadtxt`) solves a
symmetric quasi-definite matrix by the signed LDL^T (`numeric/ldlt.py`) and
prints the JAX CLI's `signature:` line.

`-d DIR` writes the reference-format structure log `DIR/output` (Block,
Cluster and Fill lines, then the POTRF / TRSM / GEMM schedule of the
cluster fill analysis, `symbolic/fill.py`, `verify/`) and prints `debug
log: ...`; with `--debug-dumps` it also replays that schedule on the
permuted matrix in f64 on the host and writes the matrix after each op
group under the reference's dump names, for `verify/replay.debug_factor`.
The log and the dumps are the JAX CLI's, byte for byte; `--debug-dumps`
without `-d` does nothing, as there.

The native host core (`native/`) reads and writes the matrix files, orders
and analyses fill when it can be built; the CLI prints `ordering engine:
native|python` when it orders and `fill engine: native|python` with `-d`.

`--devices N` distributes over a mesh of N slots (`parallel/mesh.py`) and
`--slices S [--devices S*C]` over a multislice mesh of S slices, as the
JAX CLI does, with its error line when S does not divide N. On `--device
cpu` the slots are N logical CPU devices (S without `--devices`); on the
card they are N distinct cards (S without `--devices`: every card), and
the CLI exits 2 with one line when the machine has fewer.

Run: python -m cholesky_tpu_torch.cli -i M.mtx [-s ord.txt -c clust.txt]
     -b B.mtx -o sol.txt [-d DIR [--debug-dumps]] [--device cuda|cpu]
     [--devices N] [--slices S]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


_LEGION_PREFIXES = ("-ll:", "-lg:", "-level", "-logfile")
_LEGION_FLAGS_WITH_ARG = {"-fflow", "-fcuda", "-fopenmp", "-fjobs"}


def parse_args(argv):
    """Hand-rolled argv scan mirroring mmat.rg:1072-1093."""
    opts = {
        "matrix_file": "", "separator_file": "", "clusters_file": "",
        "b_file": "", "solution_file": "", "factor_file": "",
        "permuted_matrix_file": "", "debug_path": "", "debug": False,
        "iterations": 1, "dtype": "float64", "devices": 0, "slices": 0,
        "bench": False,
        "profile": False, "debug_dumps": False,
        "save_factor": "", "load_factor": "", "inv_diag_file": "",
        "signs_file": "", "device": "cuda", "budget": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            opts["matrix_file"] = argv[i + 1]; i += 2
        elif a == "-s":
            opts["separator_file"] = argv[i + 1]; i += 2
        elif a == "-c":
            opts["clusters_file"] = argv[i + 1]; i += 2
        elif a == "-m":
            opts["factor_file"] = argv[i + 1]; i += 2
        elif a == "-p":
            opts["permuted_matrix_file"] = argv[i + 1]; i += 2
        elif a == "-o":
            opts["solution_file"] = argv[i + 1]; i += 2
        elif a == "-b":
            opts["b_file"] = argv[i + 1]; i += 2
        elif a == "-d":
            opts["debug_path"] = argv[i + 1]; opts["debug"] = True; i += 2
        elif a == "--iterations":
            opts["iterations"] = int(argv[i + 1]); i += 2
        elif a == "--dtype":
            opts["dtype"] = argv[i + 1]; i += 2
        elif a == "--devices":
            opts["devices"] = int(argv[i + 1]); i += 2
        elif a == "--slices":
            opts["slices"] = int(argv[i + 1]); i += 2
        elif a == "--profile":
            opts["profile"] = True; i += 1
        elif a == "--debug-dumps":
            opts["debug_dumps"] = True; i += 1
        elif a == "--save-factor":
            opts["save_factor"] = argv[i + 1]; i += 2
        elif a == "--load-factor":
            opts["load_factor"] = argv[i + 1]; i += 2
        elif a == "--bench":
            opts["bench"] = True; i += 1
        elif a == "--inv-diag":
            opts["inv_diag_file"] = argv[i + 1]; i += 2
        elif a == "--signs":
            opts["signs_file"] = argv[i + 1]; i += 2
        elif a == "--device":
            opts["device"] = argv[i + 1]; i += 2
        elif a == "--budget":
            opts["budget"] = int(argv[i + 1]); i += 2
        elif a in _LEGION_FLAGS_WITH_ARG or a.startswith(_LEGION_PREFIXES):
            # Legion runtime passthroughs — accepted, ignored. Consume a
            # following value only when it is not itself a flag: zero-arg
            # Legion flags (-lg:spy, -ll:show_rsrv, ...) must not swallow
            # the next real option.
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 2
            else:
                i += 1
        else:
            i += 1
    return opts


def _mesh(opts):
    """The mesh of --devices / --slices (None without either), on CPU
    slots for --device cpu and on distinct cards otherwise. Raises
    ValueError with the line to print when it cannot be built."""
    import torch

    from cholesky_tpu_torch.parallel import mesh as mesh_mod

    n, S = opts["devices"], opts["slices"]
    if n <= 1 and S <= 1:
        return None
    if S > 1 and n > 1 and n % S:
        # the JAX CLI's line, where make_multislice_mesh would truncate
        raise ValueError(f"Error: --devices {n} is not divisible by "
                         f"--slices {S}")
    if torch.device(opts["device"]).type == "cpu":
        devices = [torch.device("cpu")] * (n if n > 1 else S)
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        want = n if n > 1 else S
        if len(devices) < want:
            raise ValueError(f"Error: --devices {want} needs {want} CUDA "
                             f"cards; this machine has {len(devices)}")
        if n > 1:
            devices = devices[:n]
    if S > 1:
        return mesh_mod.make_multislice_mesh(
            S, (n // S) if n > 1 else None, devices=devices)
    return mesh_mod.make_mesh(devices=devices)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_args(argv)

    if not opts["matrix_file"]:
        print("usage: python -m cholesky_tpu_torch.cli -i matrix.mtx "
              "[-s ord.txt] [-c clust.txt] [-b B.mtx] [-o solution.txt] "
              "[-m factor.mtx] [-p permuted.mtx] [-d debug_dir] "
              "[--debug-dumps] [--iterations N] "
              "[--dtype float64|float32] [--device cuda|cpu] "
              "[--budget BYTES] [--devices N] [--slices S] [--profile] "
              "[--save-factor ckpt.npz] "
              "[--load-factor ckpt.npz] [--inv-diag diag.txt] "
              "[--signs signs.txt] [--bench]\n"
              "Without -s, a nested-dissection ordering is computed from the "
              "matrix sparsity graph.")
        return 2
    import torch

    try:
        mesh = _mesh(opts)
    except ValueError as e:
        print(e)
        return 2

    from cholesky_tpu_torch import SparseCholesky
    from cholesky_tpu_torch.io import mmio

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    print(f"Iterations: {opts['iterations']}")
    banner = mmio.read_banner(opts["matrix_file"])
    print(f"M: {banner.rows} N: {banner.cols} nz: {banner.nnz} "
          f"typecode: {banner.typecode}")

    dtype = np.dtype(opts["dtype"])
    signs = None
    if opts["signs_file"]:
        # one +1/-1 per dof: symmetric quasi-definite LDL^T (numeric/ldlt)
        signs = np.loadtxt(opts["signs_file"], dtype=np.float64).reshape(-1)
        print(f"signature: {int((signs > 0).sum())} positive, "
              f"{int((signs < 0).sum())} negative (quasi-definite LDL^T)")
    common = dict(dtype=dtype, device=opts["device"], budget=opts["budget"],
                  signs=signs, mesh=mesh)
    if opts["separator_file"]:
        solver = SparseCholesky.from_files(
            opts["matrix_file"], opts["separator_file"],
            opts["clusters_file"] or None, **common)
    else:
        # no ordering provided: compute nested dissection from the sparsity
        # graph (capability beyond the reference, which requires ord files)
        print("No separator file; computing nested-dissection ordering.")
        _, r, c_, v = mmio.read_coo(opts["matrix_file"])
        solver = SparseCholesky.from_matrix(banner.rows, r, c_, v, **common)
        print(f"ordering engine: {solver.ordering_info['engine']}")
    device = solver.device
    plan = solver.plan
    print(f"levels: {plan.levels}")
    print(f"separators: {plan.num_separators}")

    if opts["debug"]:
        from cholesky_tpu_torch.symbolic import fill as fillmod
        from cholesky_tpu_torch.verify import debuglog, schedule

        fa = fillmod.analyze_fill(plan, solver.rows, solver.cols, solver.vals)
        print(f"fill engine: {fa.engine}")
        ops = schedule.generate_schedule(fa)
        log_path = debuglog.write_structure_log(
            plan, opts["debug_path"], fa, ops)
        print(f"debug log: {log_path}")
        if opts["debug_dumps"]:
            # per-op matrix snapshots for the bisecting oracle
            # (write_blocks parity, mmat.rg:174-218)
            from cholesky_tpu_torch.verify import replay as replaymod

            replaymod.replay_schedule(solver.permuted_dense(), ops,
                                      dump_dir=opts["debug_path"])
            print(f"debug dumps: {opts['debug_path']}/")

    if opts["permuted_matrix_file"]:
        pmat = solver.permuted_dense()
        print(f"saving matrix to: {opts['permuted_matrix_file']}\n")
        mmio.write_dense_coo(opts["permuted_matrix_file"], pmat,
                             symmetry=banner.symmetry)

    print("Done fill.")

    if opts["profile"]:
        from cholesky_tpu_torch.numeric import profile as prof

        from cholesky_tpu_torch.parallel.mesh import local

        # the profiler times the single-device stages: a mesh's slabs
        # gathered onto its first slot
        prof.profile_frontal(solver.fplan,
                             [local(p, solver.device)
                              for p in solver.assemble()])
        solver.panels = None

    factor_times = []
    if opts["load_factor"]:
        # resume a checkpointed factorization (fingerprint-verified)
        solver.load_factor(opts["load_factor"])
        print(f"Loaded factor: {opts['load_factor']}")
    else:
        for iteration in range(opts["iterations"]):
            t0 = clock()
            solver.factorize()
            dt = clock() - t0
            factor_times.append(dt)
            print(f"Done factoring Iteration: {iteration}.")
            print(f"FACTOR: {{'op': 'factor', 'iteration': {iteration}, "
                  f"'time_s': {dt:.6f}}}")
    if opts["save_factor"]:
        print(f"Saved factor: {solver.save_factor(opts['save_factor'])}")

    if opts["factor_file"]:
        fr, fc, fv = solver.factor_coo()
        print(f"saving matrix to: {opts['factor_file']}\n")
        mmio.write_coo(opts["factor_file"], fr, fc, fv,
                       (banner.rows, banner.cols), symmetry=banner.symmetry)

    if opts["b_file"]:
        b = mmio.read_array(opts["b_file"]).reshape(-1)
        t0 = clock()
        x = solver.solve(b)
        solve_t = clock() - t0
        print("Done solve.")
        print(f"SOLVE: {{'op': 'solve', 'time_s': {solve_t:.6f}, "
              f"'residual': {solver.residual(b, x):.3e}}}")
        if opts["solution_file"]:
            print(f"Saving solution to: {opts['solution_file']}")
            with open(opts["solution_file"], "w") as f:
                for v in x:
                    f.write(f"{v:.17g}\n")

    if opts["inv_diag_file"]:
        # selected inversion: diag(A^-1) in original dof order, one value
        # per line (numeric/selinv.py)
        t0 = clock()
        d = solver.inv_diag()
        print(f"INVDIAG: {{'op': 'inv_diag', "
              f"'time_s': {clock() - t0:.6f}}}")
        with open(opts["inv_diag_file"], "w") as f:
            for v in d:
                f.write(f"{v:.17g}\n")
        print(f"Saved diag(A^-1) to: {opts['inv_diag_file']}")

    if opts["bench"]:
        if factor_times:
            print(json.dumps({"metric": "factor_wall_s",
                              "value": min(factor_times), "unit": "s"}))
        else:
            print(json.dumps({"metric": "factor_wall_s", "value": None,
                              "unit": "s", "note": "--iterations 0"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

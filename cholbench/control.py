"""Readings of the numbers that decide `correct`, over many seeds in one
process: the solver as a configuration states it, with the configuration's
control switched on (`--control`: the step a degraded build would take, one
precision below the stated one; `control` in the configuration's file
names the matmul rung), or with a fault planted (`--fault <name>`, one of
`faults.FAULTS`). The benchmark's own runs never run either.

    python3 cholbench/control.py --workload lapl7_50.refactor \
        --seeds 11,12,13 --seconds 5 [--control | --fault stale_factor]

Prints per seed one JSON line (`seed`, `correct`, `checks`, `requests`)
and last a summary: the largest and smallest reading of each number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def apply_control(solver, cfg):
    """Switch the configuration's control on in a solver not yet
    factored."""
    solver.precision = cfg["control"]["precision"]


def readings(workload, seeds, seconds, control, device, root=ROOT,
             fault=None):
    """[(seed, result, checks)] of one run a seed, the control switched on
    or not, the fault `fault` planted or none."""
    from cholbench import faults, harness

    prepare = (apply_control if control
               else faults.FAULTS[fault] if fault else None)
    out = []
    for seed in seeds:
        result, checks = harness.run(
            root, workload, seed, seconds, False, device,
            time.perf_counter(), prepare=prepare)
        out.append((seed, result, checks))
        print(json.dumps({"seed": seed, "control": control, "fault": fault,
                          "correct": result["correct"],
                          "requests": result["attempted"],
                          "checks": checks}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    runs = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds, args.control, "cuda:0", fault=args.fault)
    summary = {}
    for name in runs[0][2]:
        vals = [c[name]["value"] for _, _, c in runs]
        summary[name] = {"max": max(vals), "min": min(vals),
                         "limit": runs[0][2][name]["limit"]}
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "fault": args.fault,
                      "seeds": len(runs),
                      "correct": [r["correct"] for _, r, _ in runs],
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

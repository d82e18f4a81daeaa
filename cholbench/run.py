"""Run one cell of the benchmark once, on the card of the machine it is
started on:

    python3 cholbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`: each number compared with
its limit, which also close standard error). Without a card, with fewer
cards than the cell asks for, or when a module of the JAX package (or JAX
itself) is loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the solver's kernel caches stay inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".cholbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # this directory's modules are imported as the package `cholbench`
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)

    import torch

    from cholbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        harness.log(f"unknown workload {args.workload!r}")
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                    f"torch.cuda.is_available() = "
                    f"{torch.cuda.is_available()}, device_count() = "
                    f"{torch.cuda.device_count()}")
        return 3
    result, checks = harness.run(ROOT, args.workload, args.seed,
                                 args.seconds, bool(args.trace), "cuda:0",
                                 T_START)
    from cholbench import yardstick

    result["power"] = yardstick.power_limit()
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}")
        return 4
    result["checks"] = checks
    for name, c in checks.items():
        harness.log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

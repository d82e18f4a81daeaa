"""The benchmark's yardsticks: published H100 peaks, the work of a
multifrontal Cholesky of a configuration's ordering, and the least time of
a partial front factorization. Plain NumPy, independent of the solver
under test.

    python cholbench/yardstick.py cholbench/configs/<config>.json

prints the configuration's fixed work counts (the `work` entry of its
file) as one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"ieee": 67e12,       # float32 outside the tensor cores
              "tf32": 495e12}      # TF32 on the tensor cores
VALUE_BYTES = 4                    # the factor is float32

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path, name):
    """The module at `path` under the name `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operator(cfg, root=HERE):
    """The operator module a configuration names (`operators/<kind>.py`)."""
    kind = cfg["operator"]["kind"]
    return load_module(os.path.join(root, "operators", kind + ".py"),
                       f"cholbench_operator_{kind}")


def front_sizes(n, rows, cols, seps):
    """(pivots, boundary) per separator of a nested-dissection ordering, in
    separator order: a front's pivots are its separator's dofs, its
    boundary the later-eliminated dofs that its subtree couples to (the
    row structure of the factor below the separator's columns).

    `rows`, `cols`: the matrix's lower-triangle pattern; `seps`: {s: dofs}
    for s = 1 .. 2^levels - 1, eliminated in that order, separator s's
    parent being the one at heap index h // 2 (h = 2^levels - s)."""
    nsep = len(seps)
    order = np.concatenate([np.asarray(seps[s], dtype=np.int64)
                            for s in range(1, nsep + 1)])
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    # the symmetric pattern as CSR, off-diagonal only
    off = rows != cols
    r = np.concatenate([rows[off], cols[off]])
    c = np.concatenate([cols[off], rows[off]])
    srt = np.argsort(r, kind="stable")
    indices = c[srt]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])

    pivots = np.array([len(seps[s]) for s in range(1, nsep + 1)])
    ends = np.cumsum(pivots)
    struct = {}
    boundary = np.zeros(nsep, dtype=np.int64)
    for s in range(1, nsep + 1):
        d = np.asarray(seps[s], dtype=np.int64)
        starts, stops = indptr[d], indptr[d + 1]
        lens = stops - starts
        flat = (np.repeat(starts - np.cumsum(lens) + lens, lens)
                + np.arange(int(lens.sum())))
        nb = indices[flat]
        parts = [nb[pos[nb] >= ends[s - 1]]]
        h = (1 << (nsep.bit_length())) - s
        for ch in (2 * h, 2 * h + 1):
            cs = (1 << nsep.bit_length()) - ch
            if ch <= nsep and cs in struct:
                kid = struct.pop(cs)
                parts.append(kid[pos[kid] >= ends[s - 1]])
        st = np.unique(np.concatenate(parts))
        boundary[s - 1] = len(st)
        struct[s] = st
    return pivots, boundary


def front_work(pivots, boundary):
    """(flops, factor entries) of dense fronts with p pivots and m boundary
    rows: the pivot Cholesky p^3/3, the boundary's triangular solve m p^2,
    the symmetric Schur update m^2 p; p(p+1)/2 + m p factor entries."""
    p = pivots.astype(np.float64)
    m = boundary.astype(np.float64)
    flops = float(np.sum(p ** 3 / 3.0 + m * p * p + m * m * p))
    entries = int(np.sum(pivots * (pivots + 1) // 2 + boundary * pivots))
    return flops, entries


def count_work(cfg, root=HERE):
    """The fixed work of one factorization of a configuration: FLOPs of
    its multifrontal Cholesky, the bytes of the factor written once and
    the matrix's lower triangle read once (float32 values), and the
    factor's entries."""
    op = operator(cfg, root)
    n, rows, cols, _ = op.coo(cfg)
    pivots, boundary = front_sizes(n, rows, cols, op.separators(cfg))
    flops, entries = front_work(pivots, boundary)
    return {"flops": flops,
            "bytes": (entries + len(rows)) * VALUE_BYTES,
            "factor_entries": entries,
            "matrix_entries": int(len(rows))}


def least_seconds(flops, nbytes, rung):
    """The least time the card could take for `flops` and `nbytes` at a
    rung's published peak, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[rung]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def slab_bound_seconds(B, F, W, rung):
    """Least time of a partial factorization of B [F, W] float32 slabs:
    the slab read once and the factor written once (B F W values each);
    B (W^3/3 + (F - W) W^2) flops (the pivot Cholesky and the boundary
    strip's triangular solve)."""
    nbytes = B * F * W * VALUE_BYTES * 2
    flops = B * (W ** 3 / 3.0 + (F - W) * W * W)
    return least_seconds(flops, nbytes, rung)[0]


def power_limit():
    """(card name, power limit) as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(count_work(json.load(f))))

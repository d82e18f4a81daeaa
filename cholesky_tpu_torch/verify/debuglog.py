"""Reference-format structured debug log writer (the `-d` subsystem).

Emits the exact printf formats of the reference so its replay tooling (and
ours, verify/replay.py) consume either solver's logs interchangeably:

  Block:   partition_matrix, mmat.rg:331-332
  Cluster: partition_separator, mmat.rg:432-439
  Fill:    compute_filled_clusters, mmat.rg:1010-1012
  POTRF:   fused_dpotrf, blas.rg:308-310
  TRSM:    fused_dtrsm, blas.rg:340-343
  GEMM:    fused_dsyrk/fused_dgemm, blas.rg:405-409, 422-426, 490-494
           (SYRK is logged as a GEMM line with A == B, as the reference does)

The port's copy of `cholesky_tpu/verify/debuglog.py`, line for line: on the
same plan both packages write the same log, byte for byte.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, TextIO

from cholesky_tpu_torch.symbolic.fill import FillAnalysis
from cholesky_tpu_torch.symbolic.plan import SolvePlan
from cholesky_tpu_torch.verify.schedule import Op


def format_block_lines(plan: SolvePlan):
    t = plan.tree
    for lvl in range(t.levels):
        for s in t.level_seps(lvl):
            lo_r, lo_c, hi_r, hi_c = plan.block_bounds(s, s)
            yield (f"Block: {{'Block': ({s}, {s}), 'Lo': ({lo_r}, {lo_c}), "
                   f"'Hi': ({hi_r}, {hi_c})}}")
            for desc_lvl in range(lvl + 1, t.levels):
                for c in t.level_seps(desc_lvl):
                    if t.ancestor_at(c, lvl) != s:
                        continue
                    lo_r, lo_c, hi_r, hi_c = plan.block_bounds(s, c)
                    yield (f"Block: {{'Block': ({s}, {c}), "
                           f"'Lo': ({lo_r}, {lo_c}), 'Hi': ({hi_r}, {hi_c})}}")


def format_cluster_lines(plan: SolvePlan, fill: FillAnalysis):
    t = plan.tree
    for lbl, snap in enumerate(fill.snapshots):
        lvl = plan.levels - 1 - lbl
        for (rs, cs), bc in snap.items():
            if t.level_of(cs) > lvl:
                continue
            nc = bc.nc
            for r in range(bc.nr):
                for c in range(nc):
                    lo_r, lo_c, hi_r, hi_c = bc.cluster_rect(plan, r, c)
                    sz_r = hi_r - lo_r + 1
                    sz_c = hi_c - lo_c + 1
                    z = r * nc + c
                    yield (f"Cluster: {{'Block': ({rs}, {cs}), "
                           f"'color': ({rs}, {cs}, {z}), "
                           f"'Lo': ({lo_r}, {lo_c}), 'Hi': ({hi_r}, {hi_c}), "
                           f"'size': ({sz_r}, {sz_c}), 'vol': {sz_r * sz_c}, "
                           f"'Interval': {lbl}}}")


def format_fill_lines(plan: SolvePlan, fill: FillAnalysis):
    t = plan.tree
    for lbl, snap in enumerate(fill.snapshots):
        lvl = plan.levels - 1 - lbl
        for (rs, cs), bc in snap.items():
            if t.level_of(cs) > lvl:
                # levels-1 and levels-2 share interval 0: skip blocks of
                # separators already eliminated at this label (same filter
                # as format_cluster_lines; the reference only logs blocks
                # reachable from the active level, mmat.rg:1000-1016)
                continue
            nc = bc.nc
            for r in range(bc.nr):
                for c in range(nc):
                    if not bc.filled[r, c]:
                        continue
                    lo_r, lo_c, hi_r, hi_c = bc.cluster_rect(plan, r, c)
                    sz_r = hi_r - lo_r + 1
                    sz_c = hi_c - lo_c + 1
                    z = r * nc + c
                    yield (f"Fill: {{'Level': {lvl}, 'Interval': {lbl}, "
                           f"'Block': ({rs}, {cs}), "
                           f"'Cluster': ({rs}, {cs}, {z}), 'Filled': 0, "
                           f"'Lo': ({lo_r}, {lo_c}), 'Hi': ({hi_r}, {hi_c}), "
                           f"'Size': ({sz_r}, {sz_c})}}")


def format_op_line(op: Op) -> str:
    def rect(r):
        return (f"'Lo': ({r[0]}, {r[1]}), 'Hi': ({r[2]}, {r[3]})",
                r[2] - r[0] + 1, r[3] - r[1] + 1)

    blk = op.block
    if op.kind == "POTRF":
        lo_hi, m, n = rect(op.a_rect)
        lo_hi = lo_hi.replace("'Lo'", "'A_Lo'").replace("'Hi'", "'A_Hi'")
        return (f"POTRF: {{'A': {op.a}, {lo_hi}, 'SizeA': ({m}, {n}), "
                f"'Block': ({blk[0]}, {blk[1]}), 'Level': {op.level}, "
                f"'Interval': {op.interval}}}")
    if op.kind == "TRSM":
        a_lohi, am, an = rect(op.a_rect)
        a_lohi = a_lohi.replace("'Lo'", "'A_Lo'").replace("'Hi'", "'A_Hi'")
        b_lohi, bm, bn = rect(op.b_rect)
        b_lohi = b_lohi.replace("'Lo'", "'B_Lo'").replace("'Hi'", "'B_Hi'")
        return (f"TRSM: {{'A': {op.a}, {a_lohi}, 'SizeA': ({am}, {an}), "
                f"'B': {op.b}, {b_lohi}, 'SizeB': ({bm}, {bn}), "
                f"'Block': ({blk[0]}, {blk[1]}), 'Level': {op.level}, "
                f"'Interval': {op.interval}}}")
    # SYRK logged as GEMM (reference prints "GEMM:" in fused_dsyrk too)
    a_lohi, am, an = rect(op.a_rect)
    a_lohi = a_lohi.replace("'Lo'", "'A_Lo'").replace("'Hi'", "'A_Hi'")
    b_lohi, bm, bn = rect(op.b_rect)
    b_lohi = b_lohi.replace("'Lo'", "'B_Lo'").replace("'Hi'", "'B_Hi'")
    c_lohi, cm, cn = rect(op.c_rect)
    c_lohi = c_lohi.replace("'Lo'", "'C_Lo'").replace("'Hi'", "'C_Hi'")
    return (f"GEMM: {{'A': {op.a}, {a_lohi}, 'sizeA': ({am}, {an}), "
            f"'B': {op.b}, {b_lohi}, 'sizeB': ({bm}, {bn}), "
            f"'C': {op.c}, {c_lohi}, 'sizeC': ({cm}, {cn}), "
            f"'Block': ({blk[0]}, {blk[1]}), 'Level': {op.level}, "
            f"'Interval': {op.interval}}}")


def write_structure_log(plan: SolvePlan, debug_path: str,
                        fill: Optional[FillAnalysis] = None,
                        ops: Optional[Iterable[Op]] = None,
                        stream: Optional[TextIO] = None) -> str:
    """Write the full structured log; returns the log file path. `debug_path`
    is a directory (created if missing), log file is `<debug_path>/output`
    matching the reference harness's stdout capture usage."""
    os.makedirs(debug_path, exist_ok=True)
    path = os.path.join(debug_path, "output")
    with open(path, "w") as f:
        for line in format_block_lines(plan):
            f.write(line + "\n")
        if fill is not None:
            for line in format_cluster_lines(plan, fill):
                f.write(line + "\n")
            for line in format_fill_lines(plan, fill):
                f.write(line + "\n")
            if ops is not None:
                for op in ops:
                    f.write(format_op_line(op) + "\n")
    return path

"""Op-by-op NumPy replay oracle.

Re-execution of the factorization schedule on the dense permuted matrix with
SciPy/NumPy — the rebuild of verify.py:40-58 (potrf/trsm/gemm golden ops) and
verify.py:216-275 (debug_factor log replay). Used two ways:

  1. `replay_schedule` executes our own generated schedule — an independent
     check that the port's batched device factor is the same factor.
  2. `replay_log` parses a reference-format debug log (POTRF:/TRSM:/GEMM:
     dict lines) and executes it, so our logs (or the reference's!) can be
     verified interchangeably.

The port's copy of `cholesky_tpu/verify/replay.py`, NumPy and SciPy only:
the log, the dump file names and the dumps are those of the JAX package,
so either package's `debug_factor` checks the other's output.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

import numpy as np
import scipy.linalg

from cholesky_tpu_torch.verify.schedule import Op


def _sl(lo, hi):
    return slice(lo, hi + 1)


def apply_potrf(mat: np.ndarray, a_rect) -> None:
    lo_r, lo_c, hi_r, hi_c = a_rect
    blk = mat[_sl(lo_r, hi_r), _sl(lo_c, hi_c)]
    mat[_sl(lo_r, hi_r), _sl(lo_c, hi_c)] = scipy.linalg.cholesky(
        np.tril(blk) + np.tril(blk, -1).T, lower=True)


def apply_trsm(mat: np.ndarray, a_rect, b_rect) -> None:
    # B := B A^{-T}, A lower (cblas_dtrsm Right/Lower/Trans/NonUnit, blas.rg:99)
    lo_r, lo_c, hi_r, hi_c = a_rect
    A = np.tril(mat[_sl(lo_r, hi_r), _sl(lo_c, hi_c)])
    lo_r, lo_c, hi_r, hi_c = b_rect
    B = mat[_sl(lo_r, hi_r), _sl(lo_c, hi_c)]
    mat[_sl(lo_r, hi_r), _sl(lo_c, hi_c)] = scipy.linalg.solve_triangular(
        A, B.T, lower=True).T


def apply_gemm(mat: np.ndarray, a_rect, b_rect, c_rect, syrk: bool) -> None:
    # C -= A B^T (alpha=-1, beta=1, NoTrans x Trans — blas.rg:139,187);
    # SYRK only updates the lower triangle (CblasLower, blas.rg:187)
    A = mat[_sl(a_rect[0], a_rect[2]), _sl(a_rect[1], a_rect[3])]
    B = mat[_sl(b_rect[0], b_rect[2]), _sl(b_rect[1], b_rect[3])]
    upd = A @ B.T
    C = mat[_sl(c_rect[0], c_rect[2]), _sl(c_rect[1], c_rect[3])]
    if syrk:
        C -= np.tril(upd)
    else:
        C -= upd


def op_dump_filename(op: Op) -> str:
    """Per-op matrix dump name in the reference's scheme (gen_filename,
    mmat.rg:149-172; consumed by verify.py:78-93 find_file)."""
    a = f"a{op.a[0]}{op.a[1]}"
    if op.kind == "POTRF":
        return f"potrf_lvl{op.level}_{a}.mtx"
    b = f"b{op.b[0]}{op.b[1]}"
    if op.kind == "TRSM":
        return f"trsm_lvl{op.level}_{a}_{b}.mtx"
    c = f"c{op.c[0]}{op.c[1]}"
    return f"gemm_lvl{op.level}_{a}_{b}_{c}.mtx"


def replay_schedule(pmat: np.ndarray, ops: Iterable[Op],
                    dump_dir: str = None) -> np.ndarray:
    """Execute the schedule on a copy of the permuted matrix (lower-triangular
    storage); returns the factored matrix. With dump_dir, writes the whole
    matrix after each op under the reference's per-op filenames
    (write_blocks, mmat.rg:174-218) so the reference's debug_factor-style
    bisection works against our dumps."""
    import os

    from cholesky_tpu_torch.io import mmio

    mat = np.array(pmat, dtype=np.float64)
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
    for op in ops:
        if op.kind == "POTRF":
            apply_potrf(mat, op.a_rect)
        elif op.kind == "TRSM":
            apply_trsm(mat, op.a_rect, op.b_rect)
        else:
            apply_gemm(mat, op.a_rect, op.b_rect, op.c_rect,
                       syrk=op.kind == "SYRK")
        if dump_dir:
            mmio.write_dense_coo(
                os.path.join(dump_dir, op_dump_filename(op)), mat,
                symmetry="hermitian")
    return mat


# ---------------------------------------------------------------------------
# Log parsing / replay (reference format)


def parse_log(path: str) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    """Parse a debug log into (blocks, clusters, ops) dict lists — the same
    three streams verify.py:233-262 extracts."""
    blocks, clusters, ops = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            for tag, dest in (("Block:", blocks), ("Cluster:", clusters)):
                if line.startswith(tag):
                    dest.append(ast.literal_eval(line[len(tag):].strip()))
                    break
            else:
                for tag in ("POTRF:", "TRSM:", "GEMM:"):
                    if line.startswith(tag):
                        d = ast.literal_eval(line[len(tag):].strip())
                        d["op"] = tag[:-1]
                        ops.append(d)
                        break
    return blocks, clusters, ops


def replay_log(pmat: np.ndarray, log_path: str) -> np.ndarray:
    """Execute a reference-format debug log against the permuted matrix
    (the semantics of verify.py:debug_factor's op loop, verify.py:246-273:
    a logged GEMM with identical A and B bounds is the SYRK case and
    re-tril's C)."""
    mat = np.array(pmat, dtype=np.float64)
    _, _, ops = parse_log(log_path)
    for d in ops:
        if d["op"] == "POTRF":
            apply_potrf(mat, _rect(d, "A"))
        elif d["op"] == "TRSM":
            apply_trsm(mat, _rect(d, "A"), _rect(d, "B"))
        else:
            syrk = d["A_Lo"] == d["B_Lo"] and d["A_Hi"] == d["B_Hi"]
            apply_gemm(mat, _rect(d, "A"), _rect(d, "B"), _rect(d, "C"), syrk)
    return mat


def _rect(d, key):
    lo = d[f"{key}_Lo"]
    hi = d[f"{key}_Hi"]
    return (lo[0], lo[1], hi[0], hi[1])


def debug_factor(matrix_file: str, separator_file: str, factored_mat: str,
                 log_file: str, directory: str = "",
                 rtol: float = 1e-4, atol: float = 1e-4) -> bool:
    """The reference's op-by-op bisecting oracle (verify.py:216-275): replay
    every op from a debug log against the permuted matrix, compare the state
    after each op with the solver's per-op dump file when present, and
    finally check the factored matrix against scipy's Cholesky."""
    import os

    import scipy.io
    import scipy.linalg

    from cholesky_tpu_torch.io import mmio, ordering as ordio
    from cholesky_tpu_torch.symbolic.plan import build_plan, permute_matrix_dense

    plan = build_plan(ordio.parse_ordering(separator_file))
    a = mmio.read_dense(matrix_file)
    pmat = permute_matrix_dense(plan, a)
    mat = np.array(pmat)

    _, _, ops = parse_log(log_file)
    names = []
    for d in ops:
        if d["op"] == "POTRF":
            names.append(f"potrf_lvl{d['Level']}_a{d['A'][0]}{d['A'][1]}.mtx")
        elif d["op"] == "TRSM":
            names.append(f"trsm_lvl{d['Level']}_a{d['A'][0]}{d['A'][1]}"
                         f"_b{d['B'][0]}{d['B'][1]}.mtx")
        else:
            names.append(f"gemm_lvl{d['Level']}_a{d['A'][0]}{d['A'][1]}"
                         f"_b{d['B'][0]}{d['B'][1]}_c{d['C'][0]}{d['C'][1]}.mtx")
    for i, d in enumerate(ops):
        if d["op"] == "POTRF":
            apply_potrf(mat, _rect(d, "A"))
        elif d["op"] == "TRSM":
            apply_trsm(mat, _rect(d, "A"), _rect(d, "B"))
        else:
            syrk = d["A_Lo"] == d["B_Lo"] and d["A_Hi"] == d["B_Hi"]
            apply_gemm(mat, _rect(d, "A"), _rect(d, "B"), _rect(d, "C"), syrk)
        # dumps carry one snapshot per op-group filename (same-name ops are
        # consecutive; the file holds the state after the group's LAST op —
        # the reference compares at block transitions, verify.py:266-271)
        fname = names[i]
        if i + 1 < len(ops) and names[i + 1] == fname:
            continue
        path = os.path.join(directory, fname) if directory else None
        if path and os.path.exists(path):
            dumped = np.tril(scipy.io.mmread(path).toarray())
            if not np.allclose(np.tril(mat), dumped, rtol=rtol, atol=atol):
                raise AssertionError(f"op state diverges at {fname}")

    lref = scipy.linalg.cholesky(pmat + np.tril(pmat, -1).T, lower=True)
    lfile = np.tril(scipy.io.mmread(factored_mat).toarray())
    return bool(np.allclose(lref, lfile, rtol=rtol, atol=atol))

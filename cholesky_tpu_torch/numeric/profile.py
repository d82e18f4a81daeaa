"""Per-stage, per-level profiling of the factorization: the port of
`profile_frontal` (`cholesky_tpu/numeric/profile.py:42-160`).

Each level's stages run one by one, each timed on its own, and each emits
one structured line in the reference's dormant format
(`BLAS: {'op': ..., 'Level': ..., 'Time': ...}`, microseconds) and one
record dict:

  * EXTADD      the extend-add the port runs on the square path
                (`frontal._extend_add_fused_`);
  * FACTOR_SLAB the blocked partial factorization through
                `hopper_kernels.factor_slab` (the hand-written Cholesky /
                inverse kernel on the card) on the levels that
                `slab_kernel_eligible` routes there: it fuses POTRF and the
                boundary TRSM;
  * POTRF, TRSM `cholesky_ex` and `solve_triangular` on the other levels;
  * SYRK        the Schur complement X X^T minus the front's trailing block.

The routing is `factorize()`'s own. On a CUDA device a stage is timed with
a pair of `torch.cuda.Event`s around it (device time, no host round trip in
it); on the CPU with `perf_counter`. The least of `iters` runs after one
warm-up is kept. The stages run the in-core square path level by level
whatever regime `factorize()` would plan: profile sizes that fit the card
that way.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import torch

from cholesky_tpu_torch.numeric import frontal as fr
from cholesky_tpu_torch.numeric import hopper_kernels as hk


def _timed(fn, iters: int, device, prep=None):
    """(fn's last result, least seconds of fn over `iters` runs after one
    warm-up). `prep()`, when given, makes fn's argument outside the timed
    region (a fresh buffer for a stage that writes in place)."""
    cuda = torch.device(device).type == "cuda"
    times = []
    out = None
    for i in range(iters + 1):
        arg = prep() if prep is not None else None
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(arg) if prep is not None else fn()
            e1.record()
            e1.synchronize()
            dt = e0.elapsed_time(e1) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(arg) if prep is not None else fn()
            dt = time.perf_counter() - t0
        if i:                               # run 0 is the warm-up
            times.append(dt)
        del arg
    return out, min(times)


def profile_frontal(fp, fronts: Sequence[torch.Tensor], iters: int = 3,
                    emit=print) -> List[dict]:
    """Stage-by-stage timing of the multifrontal engine (extend-add, then
    FACTOR_SLAB or POTRF + TRSM, then the Schur complement, per level,
    leaves to root). `fronts` are the assembled per-level pivot slabs
    [B, F, W] on the device to profile on; they are not modified (a
    family's folded slabs with `fp` its `frontal.FamilyView`). Returns the
    records and emits one `BLAS:` line per stage."""
    records = []
    device = fronts[0].device
    U = None
    for lvl in range(fp.levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        piv = fronts[lvl]
        B = piv.shape[0]            # 2^lvl, or K 2^lvl for a family view

        def padded():
            full = piv.new_zeros((B, Fl + 1, Fl))     # row Fl: sentinel
            full[:, :Fl, :Wl] = piv
            return full

        if U is not None and U.shape[1] > 0:
            def extadd(full, _U=U, _lvl=lvl):
                fr._extend_add_fused_(fp, full, _U, _lvl + 1)
                return full

            full, t = _timed(extadd, iters, device, prep=padded)
            rec = {"op": "EXTEND_ADD", "level": lvl, "batch": B,
                   "time_us": int(t * 1e6)}
            records.append(rec)
            emit(f"BLAS: {{'op': 'EXTADD', 'Level': {lvl}, 'Batch': {B}, "
                 f"'F': {Fl}, 'Time': {rec['time_us']}}}")
        else:
            full = padded()
        del U

        slab = full[:, :Fl, :Wl]
        m = Fl - Wl
        use_kernel = hk.slab_kernel_eligible(B, Wl, slab.dtype)
        if use_kernel:
            LX, t = _timed(lambda: hk.factor_slab(slab, Wl), iters, device)
            fl = B * (Wl ** 3 / 3 + m * Wl * Wl)
            rec = {"op": "FACTOR_SLAB", "level": lvl, "batch": B, "n": Wl,
                   "m": m, "time_us": int(t * 1e6),
                   "gflops": fl / max(t, 1e-12) / 1e9}
            records.append(rec)
            emit(f"BLAS: {{'op': 'FACTOR_SLAB', 'Level': {lvl}, "
                 f"'Batch': {B}, 'N': {Wl}, 'M': {m}, "
                 f"'Time': {rec['time_us']}}}")
            X = LX[:, Wl:, :]
        else:
            Ld, t = _timed(lambda: fr._cholesky(slab[:, :Wl, :]), iters,
                           device)
            rec = {"op": "POTRF", "level": lvl, "batch": B, "n": Wl,
                   "time_us": int(t * 1e6),
                   "gflops": B * Wl ** 3 / 3 / max(t, 1e-12) / 1e9}
            records.append(rec)
            emit(f"BLAS: {{'op': 'POTRF', 'Level': {lvl}, 'Batch': {B}, "
                 f"'N': {Wl}, 'Time': {rec['time_us']}}}")

        if Fl > Wl:
            if not use_kernel:
                X, t = _timed(lambda: fr._solve_lower_t(Ld, slab[:, Wl:, :]),
                              iters, device)
                rec = {"op": "TRSM", "level": lvl, "batch": B, "m": m,
                       "n": Wl, "time_us": int(t * 1e6),
                       "gflops": B * m * Wl * Wl / max(t, 1e-12) / 1e9}
                records.append(rec)
                emit(f"BLAS: {{'op': 'TRSM', 'Level': {lvl}, 'Batch': {B}, "
                     f"'M': {m}, 'N': {Wl}, 'Time': {rec['time_us']}}}")
            if lvl > 0:
                U, t = _timed(
                    lambda: torch.baddbmm(full[:, Wl:Fl, Wl:], X,
                                          X.transpose(1, 2), beta=-1.0),
                    iters, device)
                rec = {"op": "SYRK", "level": lvl, "batch": B, "m": m,
                       "k": Wl, "time_us": int(t * 1e6),
                       "gflops": B * m * m * Wl / max(t, 1e-12) / 1e9}
                records.append(rec)
                emit(f"BLAS: {{'op': 'SYRK', 'Level': {lvl}, 'Batch': {B}, "
                     f"'M': {m}, 'K': {Wl}, 'Time': {rec['time_us']}}}")
            else:
                U = None
        else:
            U = piv.new_zeros((B, 0, 0)) if lvl > 0 else None
        del full, slab
    return records

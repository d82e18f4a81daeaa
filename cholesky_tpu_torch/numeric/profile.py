"""Per-stage, per-level profiling of the factorization: the port of
`profile_frontal` (`cholesky_tpu/numeric/profile.py:42-160`) and of
`profile_factor` (`:163-253`), the panel oracle engine's stage profiler
(POTRF, TRSM and the per-ancestor UPDATE of `numeric/factor.py` per level).

Each level's stages run one by one, each timed on its own, and each emits
one structured line in the reference's dormant format
(`BLAS: {'op': ..., 'Level': ..., 'Time': ...}`, microseconds) and one
record dict:

  * EXTADD      the square fronts formed from the pivot slabs and the
                children's updates (`frontal._form_front`: on the card the
                kernel of `form_front.cu`);
  * FACTOR_SLAB the blocked partial factorization through
                `hopper_kernels.factor_slab` (the hand-written kernels of
                `factor_slab.cu` and `chol_inv.cu` on the card) on the
                levels that
                `slab_kernel_eligible` routes there: it fuses POTRF and the
                boundary TRSM;
  * POTRF, TRSM `cholesky_ex` and `solve_triangular` on the other levels;
  * SYRK        the Schur complement X X^T minus the front's trailing block
                (`frontal._schur_update_cast`, the level loop's: on the card
                in f32 at IEEE products the kernel of `schur_syrk.cu`).

The routing is `factorize()`'s own. On a CUDA device a stage is timed with
a pair of `torch.cuda.Event`s around it (device time, no host round trip in
it); on the CPU with `perf_counter`. The least of `iters` runs after one
warm-up is kept. The stages run the in-core square path level by level
whatever regime `factorize()` would plan: profile sizes that fit the card
that way.
"""

from __future__ import annotations

import subprocess
import time
from typing import List, Sequence

import torch

from cholesky_tpu_torch.numeric import factor as nfactor
from cholesky_tpu_torch.numeric import frontal as fr
from cholesky_tpu_torch.numeric import hopper_kernels as hk
from cholesky_tpu_torch.symbolic.plan import SolvePlan


def _timed(fn, iters: int, device, prep=None, reps: int = 1):
    """(fn's last result, least seconds of one fn over `iters` runs after
    one warm-up). A run is `reps` calls of fn back to back between two
    CUDA events (on the CPU, `perf_counter` readings), its time divided by
    `reps`. `prep()`, when given, makes fn's argument outside the timed
    region, once a run (a fresh buffer for a stage that writes in
    place)."""
    cuda = torch.device(device).type == "cuda"
    times = []
    out = None
    for i in range(iters + 1):
        out = None                          # free the last run's result
        arg = prep() if prep is not None else None
        call = (lambda: fn(arg)) if prep is not None else fn
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                out = call()
            e1.record()
            e1.synchronize()
            dt = e0.elapsed_time(e1) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = call()
            dt = time.perf_counter() - t0
        if i:                               # run 0 is the warm-up
            times.append(dt / reps)
        del arg, call
    return out, min(times)


def card(device) -> str:
    """The card a timing ran on, as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives it, for a CUDA device; "cpu" for the
    CPU. "cuda" raises without a card."""
    from cholesky_tpu_torch.api import _resolve_device

    device = _resolve_device(device)
    if device.type != "cuda":
        return device.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index]


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

        if U is not None:
            full, t = _timed(lambda: fr._form_front(fp, piv, U, lvl + 1),
                             iters, device)
            rec = {"op": "EXTEND_ADD", "level": lvl, "batch": B,
                   "time_us": int(t * 1e6)}
            records.append(rec)
            emit(f"BLAS: {{'op': 'EXTADD', 'Level': {lvl}, 'Batch': {B}, "
                 f"'F': {Fl}, 'Time': {rec['time_us']}}}")
        else:
            full = fr._form_front(fp, piv, U, lvl + 1)  # row Fl: sentinel
        U = None

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
                # row-major, as the level loop writes it into its factor
                X = X.contiguous()
                rec = {"op": "TRSM", "level": lvl, "batch": B, "m": m,
                       "n": Wl, "time_us": int(t * 1e6),
                       "gflops": B * m * Wl * Wl / max(t, 1e-12) / 1e9}
                records.append(rec)
                emit(f"BLAS: {{'op': 'TRSM', 'Level': {lvl}, 'Batch': {B}, "
                     f"'M': {m}, 'N': {Wl}, 'Time': {rec['time_us']}}}")
            if lvl > 0:
                ext = fr._extents(fp, lvl, device)
                U, t = _timed(
                    lambda: fr._schur_update_cast(X, full[:, Wl:Fl, Wl:],
                                                  X.dtype, beta=-1.0,
                                                  ext=ext),
                    iters, device)
                rec = {"op": "SYRK", "level": lvl, "batch": B, "m": m,
                       "k": Wl, "time_us": int(t * 1e6),
                       "gflops": B * m * m * Wl / max(t, 1e-12) / 1e9}
                records.append(rec)
                emit(f"BLAS: {{'op': 'SYRK', 'Level': {lvl}, 'Batch': {B}, "
                     f"'M': {m}, 'K': {Wl}, 'Time': {rec['time_us']}}}")
        del full, slab
    return records


def profile_factor(plan: SolvePlan, panels: Sequence, iters: int = 3,
                   emit=print, device="cuda") -> List[dict]:
    """Run the panel engine's factorization (`numeric/factor.py`) stage by
    stage on `device`, leaves to root, timing each: per level the POTRF of
    the pivot blocks, the TRSM of the boundary rows (when H > W) and the
    UPDATE of every ancestor's panels (`factor.update_ancestors`, one
    product at a time). Returns one record per stage and emits one
    reference-format `BLAS:` line each (the UPDATE as 'GEMM', as the JAX
    package emits it). The stages work on a copy of `panels` (NumPy arrays
    or tensors) made once on `device`; the caller's panels are not
    written. The UPDATE writes in place, so each timed run gets fresh
    copies of its targets, made outside the timed region. `device`: "cpu"
    or "cuda[:i]"; "cuda" raises without a card."""
    from cholesky_tpu_torch.api import _resolve_device

    device = _resolve_device(device)
    S, H, _ = nfactor._level_meta(plan)
    panels = nfactor._on(panels, device, copy=True)
    records = []
    for lvl in range(plan.levels - 1, -1, -1):
        W = S[lvl]
        B = 1 << lvl
        A = panels[lvl]

        Ld, t = _timed(lambda: fr._cholesky(A[:, :W]), iters, device)
        rec = {"op": "POTRF", "level": lvl, "batch": B, "n": W,
               "time_us": int(t * 1e6),
               "gflops": B * W ** 3 / 3 / max(t, 1e-12) / 1e9}
        records.append(rec)
        emit(f"BLAS: {{'op': 'POTRF', 'Level': {lvl}, 'Batch': {B}, "
             f"'N': {W}, 'Time': {rec['time_us']}}}")
        A[:, :W] = Ld
        del Ld
        if H[lvl] == W:
            continue
        m = H[lvl] - W
        X, t = _timed(lambda: fr._solve_lower_t(A[:, :W], A[:, W:]), iters,
                      device)
        rec = {"op": "TRSM", "level": lvl, "batch": B, "m": m, "n": W,
               "time_us": int(t * 1e6),
               "gflops": B * m * W * W / max(t, 1e-12) / 1e9}
        records.append(rec)
        emit(f"BLAS: {{'op': 'TRSM', 'Level': {lvl}, 'Batch': {B}, "
             f"'M': {m}, 'N': {W}, 'Time': {rec['time_us']}}}")
        A[:, W:] = X
        del X
        if lvl == 0:
            continue

        def update(targets, _lvl=lvl, _X=A[:, W:]):
            nfactor.update_ancestors(plan, targets, _X, _lvl)
            return targets

        targets, t = _timed(update, iters, device, prep=lambda _lvl=lvl: [
            p.clone() for p in panels[:_lvl]])
        panels[:lvl] = targets
        del targets
        rec = {"op": "UPDATE", "level": lvl, "batch": B, "m": m, "k": W,
               "time_us": int(t * 1e6),
               "gflops": B * (m * (m + 1) / 2) * W * 2 / max(t, 1e-12) / 1e9}
        records.append(rec)
        emit(f"BLAS: {{'op': 'GEMM', 'Level': {lvl}, 'Batch': {B}, "
             f"'M': {m}, 'K': {W}, 'Time': {rec['time_us']}}}")
    return records

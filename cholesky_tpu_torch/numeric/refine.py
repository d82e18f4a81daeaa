"""Mixed-precision iterative refinement with a double-float (f32-pair)
compensated sparse residual — the port of `cholesky_tpu/numeric/refine.py`:
the single-RHS loop (`:65-413`) and the block loop (`df_matvec_multi`,
`solve_refined_df_multi`, `:433-533`), each with both inner solve engines:
"banded" (explicit pivot inverses, the level chain in the padded basis) and
"plain" (no inverses: `frontal.frontal_solve` in the permuted basis,
`refine.py:316-350`), which also reads bf16 and host-resident factor
levels. Both loops refine a quasi-definite signed factor too (`signs`:
the inner solve applies S between its substitutions, `numeric/ldlt.py`).
A same-pattern family (`solve_refined_df_family`) runs the block
loop's rule over K systems at once: one ELL index, a value plane per
system, the family's solve without inverses. Every loop takes a mesh's
factor (`parallel/`) as it is: the inner solves of `numeric/frontal.py`
run its slot-sharded levels per slot, and the residual (`df_matvec`) and
the loop's vectors stay on the mesh's first slot's device.

An fp32 factor reaches the 1e-10 residual contract when the residual is
computed to ~1e-14: every value is an (hi, lo) pair of f32, products use
Dekker's TwoProd and sums Knuth's TwoSum. The matrix is held in ELL form
([n, K] column indices + f32 hi/lo value planes, rows padded with a sentinel
column whose x is 0).

Each Dekker/Knuth step is its own eager tensor op. Do not run these under
`torch.compile` or any fusing compiler: a fused multiply-add breaks TwoProd.
The residual is gathers and elementwise products, no GEMM, so it does not
depend on the matmul rung (`numeric/precision.py`); the inner solve applies
the factor at the ambient rung, the factor's own (the JAX package's
"ambient" apply mode). `solve_refined_df(demote_apply=True)` applies it at
the one-pass rung instead, the JAX package's default on the TPU, kept for
measuring both.

Each loop (`_iterate`; the single-RHS, the block and the family loop) is a
Python loop with one host read of the residual norm per sweep. It stops on the tolerance or on stagnation (a sweep that does not
halve the residual norm: the double-float floor is reached). The two loops
differ by design in what the tolerance means: the single-RHS loop takes an
absolute tol * ||b||; the block loop stops on the worst column's RELATIVE
residual (a shared absolute tolerance would over- or under-solve columns of
different scale). When touching the stagnation rule or the scaled norm,
change both.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cholesky_tpu_torch import trace
from cholesky_tpu_torch.numeric import frontal, ldlt, regimes
from cholesky_tpu_torch.numeric.frontal_plan import FrontalPlan, _banded_maps
from cholesky_tpu_torch.numeric.precision import precision_ctx

_SPLIT = 4097.0                    # Dekker split constant for f32: 2^12 + 1

# beyond this max row degree the ELL form is too padded to be worthwhile;
# the caller then refines on the host
ELL_MAX_K = regimes.ELL_MAX_K


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def split_f64(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split an f64 array into an (hi, lo) f32 pair with hi+lo == x64 to
    f32(lo) rounding (~2^-49 relative)."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _rhs_on_device(b64, device):
    """(f64 tensor on `device`, whether the caller gave NumPy) of a
    right-hand side given as an f64 NumPy array or a tensor."""
    if isinstance(b64, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(
            b64, dtype=np.float64)).to(device), True
    return b64.to(device=device, dtype=torch.float64), False


def _split_rhs(fp: FrontalPlan, b64: torch.Tensor, banded: bool):
    """The (hi, lo) f32 planes of a permuted f64 rhs [n] or [n, k] on its
    device (`split_f64`'s arithmetic), for the banded engine gathered into
    the padded basis with the zero sentinel slot appended."""
    if banded:
        zero = b64.new_zeros((1,) + tuple(b64.shape[1:]))
        inv_map = frontal._device_index(fp, "inv_map", None, b64.device)
        b64 = torch.cat([torch.cat([b64, zero])[inv_map], zero])
    hi = b64.to(torch.float32)
    return hi, (b64 - hi.to(torch.float64)).to(torch.float32)


def _join_solution(fp: FrontalPlan, x_hi, x_lo, banded: bool, as_numpy: bool):
    """x_hi + x_lo in f64 in the permuted basis (out of the padded one for
    the banded engine): a NumPy array when the caller gave one, else a
    tensor on the device."""
    if banded:
        pad_of = frontal._device_index(fp, "pad_of", None, x_hi.device)
        x_hi, x_lo = x_hi[pad_of], x_lo[pad_of]
    x = x_hi.to(torch.float64) + x_lo.to(torch.float64)
    return x.cpu().numpy() if as_numpy else x


def ell_slots(n: int, rows: np.ndarray, cols: np.ndarray):
    """The ELL layout of a symmetrized COO pattern: (idx [n, K] int32 with
    sentinel n, the slot of each entry in its row). None when the max row
    degree exceeds ELL_MAX_K."""
    counts = np.bincount(rows, minlength=n)
    K = int(counts.max()) if len(counts) else 0
    if K > ELL_MAX_K:
        return None
    order = np.argsort(rows, kind="stable")
    slot = np.empty(len(rows), dtype=np.int64)
    slot[order] = np.arange(len(rows)) - np.concatenate(
        [[0], np.cumsum(counts)])[rows[order]]
    idx = np.full((n, K), n, dtype=np.int32)
    idx[rows, slot] = cols.astype(np.int32)
    return idx, slot


def build_ell(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """Pack a symmetrized COO matrix into ELL planes for the double-float
    matvec: (idx [n, K] int32 with sentinel n, a_hi [n, K] f32, a_lo [n, K]
    f32). Returns None when the max row degree exceeds ELL_MAX_K."""
    lay = ell_slots(n, rows, cols)
    if lay is None:
        return None
    idx, slot = lay
    a64 = np.zeros(idx.shape, dtype=np.float64)
    a64[rows, slot] = vals
    a_hi, a_lo = split_f64(a64)
    return idx, a_hi, a_lo


def pad_rows(fp: FrontalPlan, plane: np.ndarray, fill) -> np.ndarray:
    """The rows of an [n, K] plane of the PERMUTED basis at their positions
    in the banded padded basis (`frontal_plan._banded_maps`): `fill` in
    the pad rows and in one extra row n_pad, so the refinement loop's
    state vectors carry their zero slot inline."""
    n_pad, _, inv_map, _, _ = _banded_maps(fp)
    out = np.full((n_pad + 1,) + plane.shape[1:], fill, dtype=plane.dtype)
    real = inv_map < plane.shape[0]                    # [n_pad]
    out[:-1][real] = plane[inv_map[real]]
    return out


def pad_ell_index(fp: FrontalPlan, idx: np.ndarray) -> np.ndarray:
    """An ELL index of the permuted matrix in the banded padded basis: rows
    at their padded positions, column ids relabeled, sentinel n_pad (pad
    rows and the extra row all-sentinel)."""
    n_pad, _, _, pad_of, _ = _banded_maps(fp)
    pad_ext = np.concatenate([pad_of, [n_pad]]).astype(np.int32)  # sent n
    return pad_rows(fp, pad_ext[idx], n_pad)


def pad_ell(fp: FrontalPlan, ell):
    """Relabel ELL planes of the symmetrized PERMUTED matrix into the banded
    padded basis: the index by `pad_ell_index`, the value planes by
    `pad_rows` (pad rows and the extra row n_pad zero)."""
    idx, a_hi, a_lo = ell
    return (pad_ell_index(fp, idx), pad_rows(fp, a_hi, 0),
            pad_rows(fp, a_lo, 0))


def df_matvec(idx, a_hi, a_lo, x_hi, x_lo):
    """y = A @ x in double-float. One 2-D gather per call fetches all
    [n, K] operands, then the products and the TwoSum accumulation fold are
    elementwise. `idx` is int64; x planes are length n+1 with a trailing
    zero (the sentinel slot). A family's K systems go through at once: x
    planes [K, n + 1] and value planes [K, n, K_ell] (one index shared) give
    y planes [K, n]."""
    K = idx.shape[1]
    if K == 0:
        z = x_hi.new_zeros(x_hi.shape[:-1] + idx.shape[:1])
        return z, z
    xg = torch.stack([x_hi, x_lo], dim=-1)[..., idx, :]  # [(K,) n, K_ell, 2]
    xh = xg[..., 0]
    xl = xg[..., 1]
    p, pe = _two_prod(a_hi, xh)
    # cross terms are O(eps * |a x|); their own rounding is O(eps^2)
    cross = a_hi * xl + a_lo * xh
    e_all = pe + cross
    s = p[..., 0]
    c = e_all[..., 0]
    for k in range(1, K):
        s, se = _two_sum(s, p[..., k])
        c = c + (se + e_all[..., k])
    return s, c


def _df_add(a_hi, a_lo, b_hi, b_lo):
    """(a) + (b) in double-float with renormalization."""
    s, e = _two_sum(a_hi, b_hi)
    lo = e + (a_lo + b_lo)
    hi, lo = _two_sum(s, lo)
    return hi, lo


def _rnorm(r_hi: torch.Tensor) -> float:
    """Scaled 2-norm: residual entries underflow f32 squares near
    convergence, so normalize by the max magnitude first. The one host read
    of a sweep."""
    m = torch.clamp(r_hi.abs().max(), min=1e-30)
    return float(m * torch.linalg.vector_norm(r_hi / m))


def _traced(name: str, fn, device):
    """`fn` inside the span `name` (`trace.span`) at each call."""
    def call(*args):
        with trace.span(name, device):
            return fn(*args)
    return call


def _iterate(solve, resid, b_hi, norm, tol: float, max_iter: int):
    """The refinement loop of every solve here: x = solve(b), then, while
    norm(r) is above tol and each sweep at least halves it, x += solve(r)
    with x kept as a double-float pair. Each application, residual and
    norm is a span (`chol.refine.apply`, `.resid`, `.norm`). Returns
    (x_hi, x_lo, sweeps, the last norm)."""
    solve = _traced("chol.refine.apply", solve, b_hi.device)
    resid = _traced("chol.refine.resid", resid, b_hi.device)
    norm = _traced("chol.refine.norm", norm, b_hi.device)
    x0 = solve(b_hi)
    x_hi, x_lo = _two_sum(x0, torch.zeros_like(x0))
    r_hi, _ = resid(x_hi, x_lo)
    rn, prev, sweeps = norm(r_hi), math.inf, 0
    while sweeps < max_iter and rn > tol and rn < 0.5 * prev:
        dx = solve(r_hi)
        x_hi, x_lo = _df_add(x_hi, x_lo, dx, torch.zeros_like(dx))
        r_hi, _ = resid(x_hi, x_lo)
        prev, rn = rn, norm(r_hi)
        sweeps += 1
    return x_hi, x_lo, sweeps, rn


def _inner_solve(fp: FrontalPlan, factors, inv_pivots, signs):
    """The solve a refinement loop applies: the banded chain with pivot
    inverses (in the padded basis) or the sweeps without them (in the
    permuted basis); with `signs` (an `ldlt.DeviceSigns`) the quasi-
    definite solve of a signed factor, S applied between the two
    substitutions."""
    if inv_pivots is not None:
        pad = None if signs is None else signs.padded
        return lambda rhs: frontal._solve_banded_core(fp, factors,
                                                      inv_pivots, rhs, pad)
    if signs is not None:
        return lambda rhs: ldlt.solve_qd(fp, factors, signs, rhs)
    return lambda rhs: frontal.frontal_solve(fp, factors, rhs)


def solve_refined_df(fp: FrontalPlan, factors: Sequence[torch.Tensor],
                     inv_pivots: Optional[Sequence[torch.Tensor]],
                     b64: np.ndarray, ell, tol: float = 1e-12,
                     max_iter: int = 40, signs=None,
                     demote_apply: bool = False):
    """IR with f32 solves and double-float residuals. `b64` is the PERMUTED
    f64 RHS [n]: a NumPy array, or a tensor (then everything but the norms
    read per sweep stays on the device, the result too). With `inv_pivots`
    the whole loop runs in the banded padded basis and `ell` is the
    `pad_ell` planes; with inv_pivots=None the inner solve is
    `frontal.frontal_solve` in the permuted basis and `ell` is the
    `build_ell` planes of the permuted matrix. Either way `ell` lies on the
    solve's device (idx as int64). `signs` (an `ldlt.DeviceSigns`): the
    factor is a quasi-definite signed one. `demote_apply`: every inner
    solve runs at the one-pass rung (TF32 on the card) whatever the ambient
    rung (`cholesky_tpu/numeric/refine.py:266,329-343`); the api never
    sets it. Returns (x_perm64, sweeps, rn_rel): the f64 solution in
    permuted order, the sweep count, and the loop's own (double-float)
    estimate of the final RELATIVE residual."""
    idx, a_hi, a_lo = ell
    device = idx.device
    b64, as_numpy = _rhs_on_device(b64, device)
    bnorm = float(torch.linalg.vector_norm(b64))
    banded = inv_pivots is not None
    b_hi, b_lo = _split_rhs(fp, b64, banded)
    tol_abs = float(np.float32(tol * bnorm))

    solve = _inner_solve(fp, factors, inv_pivots, signs)
    if demote_apply:
        ambient = solve

        def solve(rhs):
            with precision_ctx(None):
                return ambient(rhs)

    def resid(x_hi, x_lo):
        # banded: the state vectors carry their zero sentinel slot inline
        # and the padded ELL has an all-sentinel last row, so r keeps it at
        # 0; plain: the sentinel slot n is appended for the matvec
        if not banded:
            z = x_hi.new_zeros(1)
            x_hi, x_lo = torch.cat([x_hi, z]), torch.cat([x_lo, z])
        y_hi, y_lo = df_matvec(idx, a_hi, a_lo, x_hi, x_lo)
        return _df_add(b_hi, b_lo, -y_hi, -y_lo)

    x_hi, x_lo, sweeps, rn = _iterate(solve, resid, b_hi, _rnorm, tol_abs,
                                      max_iter)
    return (_join_solution(fp, x_hi, x_lo, banded, as_numpy), sweeps,
            rn / bnorm if bnorm else 0.0)


# ---------------------------------------------------------------------------
# A block of right-hand sides [n, k]: the same loop, one for the whole block.


def df_matvec_multi(idx, a_hi, a_lo, x_hi, x_lo):
    """Y = A @ X in double-float for X planes [n + 1, k] (sentinel row n = 0)
    through one [n, K, k]-operand gather. Returns (y_hi, y_lo), each
    [n, k]."""
    K = idx.shape[1]
    if K == 0:
        z = x_hi.new_zeros((idx.shape[0], x_hi.shape[1]))
        return z, z
    xg = torch.stack([x_hi, x_lo], dim=-1)[idx]         # [n, K, k, 2]
    xh = xg[..., 0]
    xl = xg[..., 1]
    ah = a_hi[:, :, None]
    al = a_lo[:, :, None]
    p, pe = _two_prod(ah, xh)
    cross = ah * xl + al * xh
    e_all = pe + cross
    s = p[:, 0, :]
    c = e_all[:, 0, :]
    for j in range(1, K):
        s, se = _two_sum(s, p[:, j, :])
        c = c + (se + e_all[:, j, :])
    return s, c


def _rel_norms(r_hi: torch.Tensor, bnorms: torch.Tensor) -> torch.Tensor:
    """Per-column scaled 2-norms of r_hi [., k] over bnorms [k] (see
    `_rnorm`)."""
    m = torch.clamp(r_hi.abs().amax(dim=0), min=1e-30)
    return m * torch.linalg.vector_norm(r_hi / m[None, :], dim=0) / bnorms


def solve_refined_df_multi(fp: FrontalPlan, factors: Sequence[torch.Tensor],
                           inv_pivots: Optional[Sequence[torch.Tensor]],
                           B64: np.ndarray, ell, tol: float = 1e-12,
                           max_iter: int = 40, signs=None):
    """IR for a block of right-hand sides: `B64` is the PERMUTED f64 [n, k]
    block (NumPy or tensor, as in `solve_refined_df`); engines, `ell` and
    `signs` as there. Sweeps are shared across columns (every column gets
    the correction each round); the loop stops on the worst column's relative
    residual, with a zero column guarded by a unit norm. The block is split,
    normed and joined on the device: the host sees one upload, one read
    per sweep and one download. Returns (X_perm64 [n, k], sweeps,
    rn_rel_max)."""
    idx, a_hi, a_lo = ell
    device = idx.device
    B64, as_numpy = _rhs_on_device(B64, device)
    k = B64.shape[1]
    bnorms = torch.linalg.vector_norm(B64, dim=0)
    bnorms_safe = torch.where(bnorms > 0, bnorms,
                              torch.ones_like(bnorms)).to(torch.float32)
    banded = inv_pivots is not None
    b_hi, b_lo = _split_rhs(fp, B64, banded)
    del B64
    tol_rel = float(np.float32(tol))

    solve = _inner_solve(fp, factors, inv_pivots, signs)

    def resid(x_hi, x_lo):
        if not banded:
            z = x_hi.new_zeros((1, k))
            x_hi, x_lo = torch.cat([x_hi, z]), torch.cat([x_lo, z])
        y_hi, y_lo = df_matvec_multi(idx, a_hi, a_lo, x_hi, x_lo)
        return _df_add(b_hi, b_lo, -y_hi, -y_lo)

    def worst(r_hi):
        return float(_rel_norms(r_hi, bnorms_safe).max())

    x_hi, x_lo, sweeps, rn = _iterate(solve, resid, b_hi, worst, tol_rel,
                                      max_iter)
    return _join_solution(fp, x_hi, x_lo, banded, as_numpy), sweeps, rn


# ---------------------------------------------------------------------------
# A same-pattern family: one system per row of [K, n], the same loop.


def solve_refined_df_family(fp, factors: Sequence[torch.Tensor],
                            B64: torch.Tensor, ell, tol: float = 1e-12,
                            max_iter: int = 40):
    """IR for a family of K systems (`frontal.FamilyView` `fp`, folded
    factors): `B64` the PERMUTED f64 right-hand sides [K, n] on the
    device, one per system; `ell` (idx [n, K_ell] int64 shared by the
    family, a_hi / a_lo [K, n, K_ell] f32 value planes of the permuted
    matrices). The inner solve is `frontal.solve_many_systems` (no pivot
    inverses). Sweeps are shared by the family; the loop stops on the
    worst system's relative residual, or on stagnation, as the block loop
    does. Returns (X_perm64 [K, n] on the device, sweeps, rn_rel_max)."""
    idx, a_hi, a_lo = ell
    K, n = B64.shape
    bnorms = torch.linalg.vector_norm(B64, dim=1)
    bnorms_safe = torch.where(bnorms > 0, bnorms,
                              torch.ones_like(bnorms)).to(torch.float32)
    b_hi = B64.to(torch.float32)
    b_lo = (B64 - b_hi.to(torch.float64)).to(torch.float32)
    tol_rel = float(np.float32(tol))
    zero = b_hi.new_zeros((K, 1))

    def resid(x_hi, x_lo):
        y_hi, y_lo = df_matvec(idx, a_hi, a_lo, torch.cat([x_hi, zero], 1),
                               torch.cat([x_lo, zero], 1))
        return _df_add(b_hi, b_lo, -y_hi, -y_lo)

    def worst(r_hi):
        return float(_rel_norms(r_hi.T, bnorms_safe).max())

    x_hi, x_lo, sweeps, rn = _iterate(
        lambda rhs: frontal.solve_many_systems(fp, factors, rhs), resid,
        b_hi, worst, tol_rel, max_iter)
    return x_hi.to(torch.float64) + x_lo.to(torch.float64), sweeps, rn

"""The factorization's hand-written Hopper kernels and their plain versions
— the port's counterpart of `cholesky_tpu/numeric/pallas_kernels.py`.

  * `chol_inv`   <- `chol_inv_lanes` (`pallas_kernels.py:92-116`, kernel
                    body `:66-89`): batched Cholesky + inv(L) of [B, 128, 128]
                    f32 blocks, by the CUDA kernel `kernels/csrc/chol_inv.cu`.
  * `chol_inv_ref` the plain PyTorch version of the same function.
  * `chol_inv_blocked_ref` the kernel's blocked schedule written out in
                    PyTorch, for the tests (nothing on the main path calls it).
  * `factor_slab` <- `factor_slab_lanes` (`:119-170`): the left-looking
                    blocked partial factorization of a pivot slab, by the
                    CUDA kernels of `kernels/csrc/factor_slab.cu` (per
                    128-wide panel: the diagonal tile's update, `chol_inv`,
                    then the panel's update and inv(L) product in one pass).
  * `factor_slab_ref` the plain version: per panel a GEMM of the past
                    column blocks, `block_fn` (Cholesky + inverse) on the
                    diagonal block, a GEMM with its inverse. With
                    `block_fn=chol_inv` it is the cuBLAS composite the
                    kernels replaced, which the tools time beside them.
  * `slab_kernel_eligible` <- `lanes_eligible` (`:191-211`): which levels
                    route through `factor_slab`.
  * `form_front`  replaces no TPU kernel: a level's square fronts
                    [B, F + 1, F] formed in one pass from the pivot slabs
                    and both children's updates, by the CUDA kernel
                    `kernels/csrc/form_front.cu` (the port's torch
                    indexing for it reached ~8% of the memory rate).
  * `form_front_ref` its plain version, the same output-stationary
                    algorithm and subtraction order in PyTorch, by the
                    masked gathers `rows_gather` and `cols_gather`, which
                    the level loop's two-piece extend-add and the selected
                    inversion read too.
  * `schur_syrk`  replaces no TPU kernel: the Schur update U = X X^T + s E
                    of a level's fronts on the 128 x 128 lower tiles inside
                    each front's own extent (m_b boundary rows, p_b pivots),
                    mirrored to the upper tiles, by the CUDA kernel
                    `kernels/csrc/schur_syrk.cu` (cuBLAS's padded baddbmm
                    computed the full product of the level's widest front).
  * `schur_syrk_ref` its plain version: the same elements written, the same
                    contraction, front by front in PyTorch (the reference
                    the kernel is tested against; the CPU runs one batched
                    product instead).
  * `schur_syrk_flops` the flops the kernel's tiles execute.
  * `signed_panel` replaces no TPU kernel: one panel (at most 32 columns)
                    of the blocked signed Cholesky of a level's
                    quasi-definite fronts, the diagonal block's signed
                    factor and the panel's solve below it, by the CUDA
                    kernel `kernels/csrc/signed_panel.cu` (the JAX package
                    runs the algorithm through XLA, a `lax.scan` over
                    columns; the port's PyTorch column loop took ~5
                    launches a column).
  * `signed_panel_ref` its plain version: the column loop, the triangular
                    solve and the sign scale in PyTorch.
  * `chol_inv_bound`, `factor_slab_bound` the least time the card could
                    take for each function's work, from the H100's
                    published peaks below; `factor_slab_flops` the flops
                    the kernels' schedule executes.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(the CPU tests run the same control flow as the card), a CUDA tensor always
launches the kernel, and a build or launch failure raises. The products of
`factor_slab` follow `torch.backends.cuda.matmul.fp32_precision` as cuBLAS
does: TF32 tensor cores under "tf32", IEEE f32 otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

BS = 128                        # panel width = the kernel's block size

# Routing constants, kept from the JAX package so that the same levels
# route in both packages: a batch of at least MIN_B fronts, and
# B * W_PER_B >= W (the TPU's measured crossover). They are to be refitted
# from timings on the card.
MIN_B = 32
W_PER_B = 16

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W),
# the denominators of the bounds below.
HBM_BYTES_PER_S = 3.35e12          # memory rate
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
TF32_FLOPS = 495e12                # TF32 on the tensor cores

# Launches of each kernel, counted where the kernel is launched
# (`factor_slab`: one per call, which launches two kernels per panel).
LAUNCHES = {"chol_inv": 0, "factor_slab": 0, "form_front": 0,
            "schur_syrk": 0, "signed_panel": 0}

_FNS: dict = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "chol_inv_f32": ("chol_inv", [_P, _P, _P, _L, _P]),
    "factor_slab_diag_f32": ("factor_slab", [_P, _L, _L, _P, _I, _I, _I, _I,
                                             _L, _P, _I, _P]),
    "factor_slab_panel_f32": ("factor_slab", [_P, _L, _L, _P, _I, _I, _I,
                                              _I, _L, _P, _P, _I, _P]),
    "form_front": ("form_front", [_P, _P, _L, _L, _L, _P, _L, _L, _L, _P,
                                  _L, _L, _L, _I, _I, _I, _I, _I, _P]),
    "schur_syrk_f32": ("schur_syrk", [_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                      _P, _L, _I, _I, ctypes.c_float, _P]),
    "signed_panel": ("signed_panel", [_P, _L, _L, _P, _L, _P, _P, _L, _I, _I,
                                      _I, _I, _P]),
}

# dtype codes of form_front's C interface (the front's, the updates') and
# of signed_panel's
_FRONT_CODES = {torch.float32: 0, torch.float64: 1}
_UPDATE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _fn(name: str):
    """The C entry point `name` of its kernel's library, built at first
    use."""
    fn = _FNS.get(name)
    if fn is None:
        from cholesky_tpu_torch.kernels import build

        lib, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def chol_inv_ref(d: torch.Tensor):
    """Plain PyTorch Cholesky + lower-triangular inverse of a batch of SPD
    blocks (lower triangle read). Returns (L, inv(L)), both lower."""
    L, _ = torch.linalg.cholesky_ex(d)
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def chol_inv_blocked_ref(d: torch.Tensor, panel: int = 32):
    """The CUDA kernel's schedule in plain PyTorch, with the panel width as a
    parameter (the kernel's is 32 at N = 128; N / panel must be a power of
    two). Per panel p: the diagonal tile's column recurrence
    (a_i[k] -= a_i[j] a_k[j] / d_j, then column j scaled by rsqrt(d_j)); the
    tiles below by forward substitution, L[i,p] = A[i,p] inv(L_pp)^T; the
    update of the trailing lower tiles. inv(L) from the diagonal tiles'
    inverses (forward substitution) by the 2x2 block formula
        inv([[P, 0], [C, Q]]) = [[inv P, 0], [-inv Q C inv P, inv Q]]
    on halves of halves. Reads the lower triangle of d; returns (L, inv(L)),
    both lower."""
    N = d.shape[-1]
    nt = N // panel
    if N % panel or nt & (nt - 1):
        raise ValueError(f"panel {panel} must divide N = {N} into a power "
                         "of two of tiles")
    a = torch.tril(d).clone()
    m = torch.zeros_like(a)

    def tiles(x, i0, i1, j0, j1):
        return x[..., i0 * panel:i1 * panel, j0 * panel:j1 * panel]

    def forward(ld, b):
        """x with ld x = b for each column of b (ld lower, panel x panel)."""
        x = torch.empty_like(b)
        for i in range(panel):
            x[..., i, :] = (b[..., i, :] - (ld[..., i, None, :i]
                                            @ x[..., :i, :])[..., 0, :]
                            ) / ld[..., i, i, None]
        return x

    eye = torch.eye(panel, dtype=d.dtype, device=d.device)
    for p in range(nt):
        t = tiles(a, p, p + 1, p, p + 1)
        for j in range(panel):
            r = torch.rsqrt(t[..., j, j].clone())
            col = t[..., :, j].clone()
            t[..., j + 1:, j + 1:] -= (
                (col[..., j + 1:, None] * (r * r)[..., None, None])
                * col[..., None, j + 1:])
            t[..., :, j] = col * r[..., None]
        t.copy_(torch.tril(t))
        tiles(m, p, p + 1, p, p + 1).copy_(forward(t, eye.expand_as(t)))
        below = tiles(a, p + 1, nt, p, p + 1)
        below.copy_(forward(t, below.transpose(-1, -2)).transpose(-1, -2))
        for i in range(p + 1, nt):
            for j in range(p + 1, i + 1):
                tiles(a, i, i + 1, j, j + 1).sub_(
                    tiles(a, i, i + 1, p, p + 1)
                    @ tiles(a, j, j + 1, p, p + 1).transpose(-1, -2))
    a = torch.tril(a)
    size = 1
    while size < nt:
        for lo in range(0, nt, 2 * size):
            mid, hi = lo + size, lo + 2 * size
            tiles(m, mid, hi, lo, mid).copy_(
                -(tiles(m, mid, hi, mid, hi)
                  @ (tiles(a, mid, hi, lo, mid) @ tiles(m, lo, mid, lo, mid))))
        size *= 2
    return a, m


def chol_inv(d: torch.Tensor):
    """Batched Cholesky + lower-triangular inverse of [B, 128, 128] SPD
    blocks. Returns (L, inv(L)), both [B, 128, 128] lower with zeros above
    the diagonal. CUDA tensors go to the hand-written kernel (f32,
    contiguous, 16-byte aligned); CPU tensors to `chol_inv_ref`."""
    if d.device.type == "cpu":
        return chol_inv_ref(d)
    if d.device.type != "cuda":
        raise ValueError(f"chol_inv: unsupported device {d.device}")
    if d.dtype != torch.float32:
        raise ValueError(f"chol_inv: kernel takes float32, got {d.dtype}")
    if d.dim() != 3 or tuple(d.shape[1:]) != (BS, BS):
        raise ValueError(f"chol_inv: expected [B, {BS}, {BS}], got "
                         f"{tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("chol_inv: input must be contiguous")
    if d.data_ptr() % 16:
        raise ValueError("chol_inv: input must be 16-byte aligned")
    fn = _fn("chol_inv_f32")
    l = torch.empty_like(d)
    m = torch.empty_like(d)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(d.data_ptr(), l.data_ptr(), m.data_ptr(), d.shape[0],
                 stream)
    if err != 0:
        raise RuntimeError(f"chol_inv: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["chol_inv"] += 1
    return l, m


def factor_slab_ref(a: torch.Tensor, W: int,
                    block_fn=chol_inv_ref) -> torch.Tensor:
    """Blocked LEFT-looking partial factorization of the pivot-column slab
    [B, F, W] in plain PyTorch: rows [:W] become the pivot Cholesky, rows
    [W:] the solved boundary strip. Per 128-wide panel: one batched GEMM of
    all past column blocks, the diagonal block through `block_fn` (Cholesky
    + inverse), then `below @ inv(d)^T`. A tail panel narrower than 128 is
    identity-padded to 128 (the Cholesky of blockdiag(d, I) is
    blockdiag(chol(d), I), exactly).

    The factored column blocks are written straight into the output, so
    `out[:, c0:, :c0]` is the JAX version's concatenation of past blocks.
    `block_fn=chol_inv` on a CUDA tensor is the composite of cuBLAS GEMMs,
    copies and the `chol_inv` kernel that `factor_slab` replaced."""
    B, F, Wc = a.shape
    if Wc != W:
        raise ValueError(f"factor_slab: slab width {Wc} != W {W}")
    out = torch.zeros_like(a)
    for c0 in range(0, W, BS):
        w = min(BS, W - c0)
        pan = a[:, c0:, c0:c0 + w]
        if c0 > 0:
            past = out[:, c0:, :c0]
            pan = pan - past @ past[:, :w, :].transpose(1, 2)
        if w == BS:
            ld, dinv = block_fn(pan[:, :w, :w].contiguous())
        else:
            d_pad = torch.eye(BS, dtype=a.dtype, device=a.device).repeat(
                B, 1, 1)
            d_pad[:, :w, :w] = pan[:, :w, :w]
            ld, dinv = block_fn(d_pad)
            ld, dinv = ld[:, :w, :w], dinv[:, :w, :w]
        out[:, c0:c0 + w, c0:c0 + w] = ld
        out[:, c0 + w:, c0:c0 + w] = pan[:, w:, :] @ dinv.transpose(1, 2)
    return out


def _tf32() -> bool:
    """Whether cuBLAS's float32 products run on TF32 tensor cores: the
    flag the precision ladder sets, or the global one it defaults to."""
    flag = torch.backends.cuda.matmul.fp32_precision
    if flag == "none":
        flag = torch.backends.fp32_precision
    return flag == "tf32"


def factor_slab(a: torch.Tensor, W: int) -> torch.Tensor:
    """Partial factorization of pivot slabs [B, F, W]: rows [:W] the pivot
    Cholesky (zeros above the diagonal), rows [W:] the boundary strip
    solved against it. A CPU tensor takes `factor_slab_ref`; a CUDA f32
    tensor the kernels of `kernels/csrc/factor_slab.cu`, per 128-wide panel
    slab_diag, `chol_inv`, slab_panel, with TF32 or IEEE products as
    `torch.backends.cuda.matmul.fp32_precision` says. The slab is read in
    place (a strided view such as `full[:, :F, :W]` is fine); its last
    stride must be 1 and its other strides, base and W multiples of 16
    bytes. Anything else raises."""
    if a.device.type == "cpu":
        return factor_slab_ref(a, W)
    if a.device.type != "cuda":
        raise ValueError(f"factor_slab: unsupported device {a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"factor_slab: kernel takes float32, got {a.dtype}")
    if a.dim() != 3 or a.shape[2] != W or a.shape[1] < W:
        raise ValueError(f"factor_slab: expected [B, F >= {W}, {W}], got "
                         f"{tuple(a.shape)}")
    sb, sr, sc = a.stride()
    if sc != 1 or sr % 4 or sb % 4 or W % 4 or a.data_ptr() % 16:
        raise ValueError(f"factor_slab: the kernel reads rows of 16-byte "
                         f"aligned float4s; got strides {a.stride()}, W = "
                         f"{W}, base {a.data_ptr()} mod 16 = "
                         f"{a.data_ptr() % 16}")
    B, F, _ = a.shape
    out = torch.empty((B, F, W), dtype=a.dtype, device=a.device)
    if B == 0:
        return out
    diag_fn = _fn("factor_slab_diag_f32")
    panel_fn = _fn("factor_slab_panel_f32")
    d = torch.empty((B, BS, BS), dtype=a.dtype, device=a.device)
    tf32 = int(_tf32())
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for c0 in range(0, W, BS):
            w = min(BS, W - c0)
            err = diag_fn(a.data_ptr(), sb, sr, out.data_ptr(), F, W, c0, w,
                          B, d.data_ptr(), tf32, stream)
            if err != 0:
                raise RuntimeError(f"factor_slab: slab_diag launch failed "
                                   f"with CUDA error {err}")
            ld, dinv = chol_inv(d)
            err = panel_fn(a.data_ptr(), sb, sr, out.data_ptr(), F, W, c0, w,
                           B, ld.data_ptr(), dinv.data_ptr(), tf32, stream)
            if err != 0:
                raise RuntimeError(f"factor_slab: slab_panel launch failed "
                                   f"with CUDA error {err}")
    LAUNCHES["factor_slab"] += 1
    return out


def rows_gather(U: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[j, i] = U[j, idx[j, i]] for U [B2, n, C], idx [B2, r]; rows with
    the sentinel idx >= n read zero (a masked gather instead of a padded
    copy of U)."""
    n = U.shape[1]
    ar = torch.arange(U.shape[0], device=U.device)[:, None]
    g = U[ar, idx.clamp(max=n - 1)]
    g.masked_fill_((idx >= n)[:, :, None], 0)
    return g


def cols_gather(G: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[j, :, i] = G[j, :, idx[j, i]] for G [B2, r, n]; sentinel columns
    idx >= n read zero."""
    B2, r, _ = G.shape
    out = torch.gather(G, 2, idx.clamp(max=n - 1)[:, None, :].expand(
        B2, r, idx.shape[1]))
    out.masked_fill_((idx >= n)[:, None, :], 0)
    return out


def form_front_ref(piv: torch.Tensor, U: Optional[torch.Tensor],
                   inv: Optional[torch.Tensor], Fl: int,
                   Wl: int) -> torch.Tensor:
    """The square fronts of a level in plain PyTorch, by the algorithm of
    `form_front`: the output [B, Fl + 1, Fl] in the pivot slabs' dtype
    starts as the slabs piv [B, Fl, Wl] padded with zeros (row Fl, the
    sentinel, stays zero), then, chunk of parent rows by chunk, each
    sibling's update U[2b + s] (s = 0, then 1) is gathered into parent
    coordinates through inv [2B, Fl] (entries >= Kc read zero) and
    subtracted in the front's dtype. U None or with Kc = 0 leaves the
    padded slabs. A chunk takes half the rows `regimes.fused_rows` gives
    the square path's extend-add, so its gathers ([B, r, Kc] and
    [B, r, Fl], Kc <= Fl) take at most half the temporaries the capacity
    planner budgets for it: the slabs, which stay alive here, fit beside
    them."""
    from cholesky_tpu_torch.numeric import regimes

    B = piv.shape[0]
    out = piv.new_zeros((B, Fl + 1, Fl))
    out[:, :Fl, :Wl] = piv
    if U is None or U.shape[1] == 0:
        return out
    Kc = U.shape[1]
    ch = max(1, regimes.fused_rows(2 * B, Kc, Fl, U.element_size(),
                                   out.element_size()) // 2)
    for r0 in range(0, Fl, ch):
        rows = out[:, r0:min(r0 + ch, Fl)]
        for s in (0, 1):
            Us, inv_s = U[s::2], inv[s::2]
            rows.sub_(cols_gather(rows_gather(Us, inv_s[:, r0:r0 + ch]),
                                  inv_s, Kc).to(out.dtype))
    return out


def form_front(piv: torch.Tensor, U: Optional[torch.Tensor],
               inv: Optional[torch.Tensor], Fl: int,
               Wl: int) -> torch.Tensor:
    """A level's square fronts [B, Fl + 1, Fl] (row Fl the sentinel, zero)
    from its pivot slabs piv [B, Fl, Wl] and the children's updates U
    [2B, Kc, Kc] (None, or Kc = 0: no update) mapped by inv [2B, Fl]
    (int64, the row of child c's update at parent row f, Kc where none):

        out[b, f, g] = (g < Wl ? piv[b, f, g] : 0)
                       - U[2b, inv[2b, f], inv[2b, g]]   (both < Kc)
                       - U[2b+1, inv[2b+1, f], inv[2b+1, g]]

    in piv's dtype (f32 or f64; U f32, bf16 or f64). A CPU tensor takes
    `form_front_ref`; a CUDA tensor the kernel of
    `kernels/csrc/form_front.cu`, one launch, bitwise equal to
    `form_front_ref` on the same inputs. piv and U are read through their
    strides. Anything the kernel does not take raises."""
    if piv.device.type == "cpu":
        return form_front_ref(piv, U, inv, Fl, Wl)
    if piv.device.type != "cuda":
        raise ValueError(f"form_front: unsupported device {piv.device}")
    if piv.dtype not in _FRONT_CODES:
        raise ValueError(f"form_front: fronts are float32 or float64, got "
                         f"{piv.dtype}")
    B = piv.shape[0]
    if piv.dim() != 3 or tuple(piv.shape[1:]) != (Fl, Wl) or Wl > Fl:
        raise ValueError(f"form_front: expected pivot slabs [B, {Fl}, "
                         f"{Wl}], got {tuple(piv.shape)}")
    Kc = 0 if U is None else U.shape[1]
    if Kc > 0:
        if U.dtype not in _UPDATE_CODES:
            raise ValueError(f"form_front: updates are float32, bfloat16 or "
                             f"float64, got {U.dtype}")
        if U.dim() != 3 or tuple(U.shape) != (2 * B, Kc, Kc):
            raise ValueError(f"form_front: expected updates [{2 * B}, K, K],"
                             f" got {tuple(U.shape)}")
        if (inv is None or inv.dtype != torch.int64
                or tuple(inv.shape) != (2 * B, Fl)):
            got = None if inv is None else (inv.dtype, tuple(inv.shape))
            raise ValueError(f"form_front: expected an int64 map "
                             f"[{2 * B}, {Fl}], got {got}")
        if U.device != piv.device or inv.device != piv.device:
            raise ValueError("form_front: slabs, updates and map on "
                             "different devices")
    out = torch.empty((B, Fl + 1, Fl), dtype=piv.dtype, device=piv.device)
    if B == 0:
        return out
    fn = _fn("form_front")
    u_args = ((U.data_ptr(), *U.stride(), inv.data_ptr(), *inv.stride())
              if Kc > 0 else (None, 0, 0, 0, None, 0, 0))
    with torch.cuda.device(piv.device):
        stream = torch.cuda.current_stream(piv.device).cuda_stream
        err = fn(out.data_ptr(), piv.data_ptr(), *piv.stride(), *u_args, B,
                 Fl, Wl, Kc, _FRONT_CODES[piv.dtype],
                 _UPDATE_CODES[U.dtype] if Kc > 0 else 0, stream)
    if err != 0:
        raise RuntimeError(f"form_front: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["form_front"] += 1
    return out


SYRK_TILE = 128                 # schur_syrk's output tile side
SYRK_K = 32                     # its K chunk: p_b is rounded up to it


def schur_syrk_ref(X: torch.Tensor, E: Optional[torch.Tensor] = None,
                   sign: float = -1.0, ext: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`schur_syrk` in plain PyTorch: per front b, with (m, p) = ext[b]
    (every front K x W without ext),

        out[b, :m, :m] = X[b, :m, :p] X[b, :m, :p]^T + sign E[b, :m, :m],

    front by front into out's extent, so that nothing else is written and
    nothing is allocated beside out (a new [B, K, K] tensor when out is
    None, whose padding is left as allocated; out may be E itself)."""
    B, K, W = X.shape
    if out is None:
        out = torch.empty((B, K, K), dtype=X.dtype, device=X.device)
    inplace = (E is not None and out.data_ptr() == E.data_ptr()
               and out.stride() == E.stride())
    sizes = [(K, W)] * B if ext is None else ext.tolist()
    for b, (m, p) in enumerate(sizes):
        if m == 0:
            continue
        x, o = X[b, :m, :p], out[b, :m, :m]
        if E is not None and not inplace:
            o.copy_(E[b, :m, :m])
        o.addmm_(x, x.T, beta=0 if E is None else sign)
    return out


def _schur_syrk_cpu(X, E, sign, ext, out):
    """`schur_syrk` on the CPU: one batched product of X zeroed outside
    each front's m_b rows and p_b columns, so that inside the extents it
    is the kernel's contraction."""
    if ext is not None:
        K, W = X.shape[1:]
        m, p = ext[:, :1, None], ext[:, 1:, None]
        X = torch.where((torch.arange(K)[:, None] < m)
                        & (torch.arange(W) < p), X, 0)
    Xt = X.transpose(1, 2)
    if E is None:
        return torch.bmm(X, Xt, out=out)
    if out is not None and out.data_ptr() == E.data_ptr():
        return out.baddbmm_(X, Xt, beta=sign)
    return torch.baddbmm(E, X, Xt, beta=sign, out=out)


def schur_syrk(X: torch.Tensor, E: Optional[torch.Tensor] = None,
               sign: float = -1.0, ext: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Schur update of a level's fronts inside their extents: for X
    [B, K, W] (the boundary strips), E [B, K, K] or None (the trailing
    blocks, symmetric inside each extent), sign -1 or +1, and ext [B, 2]
    int64 (m_b, p_b) per front (None: K and W for all),

        out[b, :m_b, :m_b] = X[b, :m_b, :p_b] X[b, :m_b, :p_b]^T
                             + sign E[b, :m_b, :m_b];

    a new tensor when out is None; out may be E itself, the update in
    place. A CUDA tensor takes the kernel of `kernels/csrc/schur_syrk.cu`,
    one launch: the lower 128 x 128 tiles of each extent (E read there
    only), contracted over p_b rounded up to SYRK_K in IEEE f32, each
    mirrored to its upper tile; out outside the extents is not written. X,
    E and out are read and written through their strides (last stride 1;
    16-byte aligned rows are copied 16 bytes at a time). Anything the
    kernel does not take raises. A CPU tensor takes one batched product
    over the padded [K, K] of X zeroed outside each extent, which writes
    sign E outside the extents, where no caller reads."""
    if X.device.type == "cpu":
        return _schur_syrk_cpu(X, E, sign, ext, out)
    if X.device.type != "cuda":
        raise ValueError(f"schur_syrk: unsupported device {X.device}")
    if X.dtype != torch.float32 or X.dim() != 3:
        raise ValueError(f"schur_syrk: X is a float32 [B, K, W], got "
                         f"{X.dtype} {tuple(X.shape)}")
    B, K, W = X.shape
    sb, sr, sc = X.stride()
    if sc != 1:
        raise ValueError(f"schur_syrk: X's last stride is 1, got strides "
                         f"{X.stride()}")
    if sign not in (-1.0, 1.0):
        raise ValueError(f"schur_syrk: sign is -1 or +1, got {sign}")
    for name, t in (("E", E), ("out", out)):
        if t is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, K, K)
                or t.stride(2) != 1 or t.device != X.device):
            raise ValueError(f"schur_syrk: {name} is a float32 [{B}, {K}, "
                             f"{K}] with unit last stride on {X.device}, "
                             f"got {t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()} on {t.device}")
    if ext is not None and (ext.dtype != torch.int64
                            or tuple(ext.shape) != (B, 2)
                            or not ext.is_contiguous()
                            or ext.device != X.device):
        raise ValueError(f"schur_syrk: ext is a contiguous int64 [{B}, 2] "
                         f"on {X.device}, got {ext.dtype} "
                         f"{tuple(ext.shape)} on {ext.device}")
    if out is None:
        out = torch.empty((B, K, K), dtype=X.dtype, device=X.device)
    if B == 0 or K == 0:
        return out
    fn = _fn("schur_syrk_f32")
    e_args = (E.data_ptr(), E.stride(0), E.stride(1)) if E is not None \
        else (None, 0, 0)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), sb, sr, *e_args, out.data_ptr(),
                 out.stride(0), out.stride(1),
                 None if ext is None else ext.data_ptr(), B, K, W, sign,
                 stream)
    if err != 0:
        raise RuntimeError(f"schur_syrk: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["schur_syrk"] += 1
    return out


def schur_syrk_flops(m, p) -> np.ndarray:
    """Flops that `schur_syrk`'s tiles execute on each front of m boundary
    rows and p pivots (arrays, one entry a front): T (T + 1) / 2 lower
    tiles of SYRK_TILE^2, T = ceil(m / SYRK_TILE), each 2 SYRK_TILE^2
    round_up(p, SYRK_K)."""
    m = np.asarray(m, dtype=np.int64)
    p = np.asarray(p, dtype=np.int64)
    t = -(-m // SYRK_TILE)
    k = -(-p // SYRK_K) * SYRK_K
    return (t * (t + 1) // 2 * k) * (2.0 * SYRK_TILE ** 2)


SIGNED_PANEL = 32               # signed_panel's widest panel


def signed_panel_ref(work: torch.Tensor, s: torch.Tensor, c0: int, c1: int,
                     xbuf: torch.Tensor) -> None:
    """`signed_panel` in plain PyTorch, in place: the column loop on the
    diagonal blocks D = work[:, c0:c1, c0:c1] (per column j: l_jj =
    sqrt(s_j d_jj); the column below becomes l = col / (s_j l_jj); the
    block below and right of it loses s_j l l^T = (col / l_jj) l^T; the
    strict upper triangle is left with the rank-1 updates' values), then
    X = work[:, c1:, c0:c1] L~11^-T by a triangular solve, X into xbuf
    [B, W - c1, c1 - c0] and L~21 = X S over the panel. A signature
    violation (s_j d_jj < 0) gives NaN, which the later columns carry
    on."""
    D = work[:, c0:c1, c0:c1]
    sp = s[:, c0:c1]
    w = c1 - c0
    for j in range(w):
        sj = sp[:, j]
        ljj = D[:, j, j].mul_(sj).sqrt_()               # in place: L~[j, j]
        if j + 1 == w:
            break
        col = D[:, j + 1:, j]
        u = col / ljj[:, None]                          # s_j l
        torch.mul(u, sj[:, None], out=col)              # l
        D[:, j + 1:, j + 1:].addcmul_(u[:, :, None], col[:, None, :],
                                      value=-1)
    if c1 == work.shape[1]:
        return
    x = torch.linalg.solve_triangular(D.transpose(1, 2), work[:, c1:, c0:c1],
                                      upper=True, left=False)
    xbuf.copy_(x)
    torch.mul(x, sp[:, None, :], out=work[:, c1:, c0:c1])


def signed_panel(work: torch.Tensor, s: torch.Tensor, c0: int, c1: int,
                 xbuf: torch.Tensor,
                 tickets: Optional[torch.Tensor] = None) -> None:
    """One panel, columns c0:c1 (at most SIGNED_PANEL of them), of the
    blocked signed Cholesky of the fronts work [B, W, W] with signature s
    [B, W] (+-1 in work's dtype), in place: the lower triangle of
    work[:, c0:c1, c0:c1] becomes L~11 with L~11 S11 L~11^T = that block;
    work[:, c1:, c0:c1] becomes L~21 = X S, X = work[:, c1:, c0:c1]
    L~11^-T, and X goes into xbuf, a contiguous [B, W - c1, c1 - c0]; the
    block's strict upper triangle is not read and is left for the caller's
    `tril_`. A signature violation gives NaN.

    A CPU tensor takes `signed_panel_ref`. A CUDA tensor takes the kernel
    of `kernels/csrc/signed_panel.cu`, one launch for every front (f32 or
    f64, IEEE division and square root). `tickets` is its int32 [B] scratch
    (zero, and left zero by every launch): the caller allocates it once
    for all the panels of a factorization; None allocates one here. work
    is read through its strides (last stride 1), s through its row stride
    (last stride 1). Anything the kernel does not take raises."""
    if work.device.type == "cpu":
        signed_panel_ref(work, s, c0, c1, xbuf)
        return
    if work.device.type != "cuda":
        raise ValueError(f"signed_panel: unsupported device {work.device}")
    if work.dtype not in _FRONT_CODES:
        raise ValueError(f"signed_panel: fronts are float32 or float64, got "
                         f"{work.dtype}")
    if work.dim() != 3 or work.shape[1] != work.shape[2]:
        raise ValueError(f"signed_panel: expected fronts [B, W, W], got "
                         f"{tuple(work.shape)}")
    B, W, _ = work.shape
    if not 0 <= c0 < c1 <= min(W, c0 + SIGNED_PANEL):
        raise ValueError(f"signed_panel: panel {c0}:{c1} is not 1 to "
                         f"{SIGNED_PANEL} columns of {W}")
    if tickets is None:
        tickets = torch.zeros(B, dtype=torch.int32, device=work.device)
    for name, t, shape, dtype in (
            ("s", s, (B, W), work.dtype),
            ("xbuf", xbuf, (B, W - c1, c1 - c0), work.dtype),
            ("tickets", tickets, (B,), torch.int32)):
        if (t.device != work.device or t.dtype != dtype
                or tuple(t.shape) != shape):
            raise ValueError(f"signed_panel: {name} is a {dtype} {list(shape)}"
                             f" on {work.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if work.stride(2) != 1 or s.stride(1) != 1:
        raise ValueError(f"signed_panel: work and s need a last stride of 1, "
                         f"got {work.stride()} and {s.stride()}")
    if not (xbuf.is_contiguous() and tickets.is_contiguous()):
        raise ValueError("signed_panel: xbuf and tickets must be contiguous")
    if B == 0:
        return
    fn = _fn("signed_panel")
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream(work.device).cuda_stream
        err = fn(work.data_ptr(), work.stride(0), work.stride(1),
                 s.data_ptr(), s.stride(0), xbuf.data_ptr(),
                 tickets.data_ptr(), B, W, c0, c1 - c0,
                 _FRONT_CODES[work.dtype], stream)
    if err != 0:
        raise RuntimeError(f"signed_panel: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["signed_panel"] += 1


def signed_panel_bytes(B: int, W: int) -> int:
    """Bytes the `signed_panel` launches of one blocked signed factorization
    of [B, W, W] f32 fronts move at the least: per panel (c0, w) each
    front's (W - c0) x w panel read once and written once, and X ((W - c0 -
    w) x w) written once."""
    total = 0
    for c0 in range(0, W, SIGNED_PANEL):
        w = min(SIGNED_PANEL, W - c0)
        total += 2 * (W - c0) * w + (W - c0 - w) * w
    return B * total * 4


def slab_kernel_eligible(B: int, W: int, dtype) -> bool:
    """Route a level through `factor_slab`: f32, at least one full
    128-panel, and a batch of at least max(MIN_B, W / W_PER_B) fronts. The
    rule does not depend on the device."""
    return (dtype == torch.float32 and W >= BS and B >= MIN_B
            and B * W_PER_B >= W)


def chol_inv_bound(B: int, n: int = 128):
    """Least time in ms of chol_inv on B blocks, and what bounds it
    ("bytes" or "operations"): the lower triangle of each input read once
    (n(n+1)/2 floats, all the function reads), L and inv(L) written once
    (2 n^2 floats); ~n^3/3 flops for the Cholesky and ~n^3/3 for the
    triangular inverse per block, at the fp32 rate."""
    bytes_ms = B * (n * (n + 1) // 2 + 2 * n * n) * 4 / HBM_BYTES_PER_S * 1e3
    flops_ms = B * 2 * n ** 3 / 3 / FP32_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def factor_slab_bound(B: int, F: int, W: int, flops_per_s: float):
    """Least time in ms of factor_slab on a [B, F, W] f32 slab at a peak
    rate (the rung's: FP32_FLOPS or TF32_FLOPS), and what bounds it: the
    slab read once and the factor written once (B F W f32 each); B (W^3/3
    + K W^2) flops with K = F - W (the pivot Cholesky and the boundary
    strip's triangular solve)."""
    bytes_ms = B * F * W * 4 * 2 / HBM_BYTES_PER_S * 1e3
    flops_ms = B * (W ** 3 / 3 + (F - W) * W * W) / flops_per_s * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def factor_slab_flops(B: int, F: int, W: int) -> float:
    """Flops the kernels of `factor_slab` execute on a [B, F, W] slab, the
    padding included: per 128-wide panel (c0, w) the diagonal tile's
    update 2 128^2 c0, `chol_inv`'s 2 128^3 / 3, and for the m = F - c0 - w
    rows below, in 128-row tiles, the update 2 m' n c0 and the product
    with inv(L_kk) 2 m' n w' (m' = m rounded up to 128, n = 32 for a tail
    of at most 32 columns else 128, w' = w rounded up to 8)."""
    total = 0.0
    for c0 in range(0, W, BS):
        w = min(BS, W - c0)
        m = -(-(F - c0 - w) // BS) * BS
        n = 32 if w <= 32 else BS
        total += (2 * BS * BS * c0 + 2 * BS ** 3 / 3 + 2 * m * n * c0
                  + 2 * m * n * (-(-w // 8) * 8))
    return B * total

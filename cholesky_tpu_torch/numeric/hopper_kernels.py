"""The factorization's hand-written Hopper kernel and the composite around it
— the port's counterpart of `cholesky_tpu/numeric/pallas_kernels.py`.

  * `chol_inv`   <- `chol_inv_lanes` (`pallas_kernels.py:92-116`, kernel
                    body `:66-89`): batched Cholesky + inv(L) of [B, 128, 128]
                    f32 blocks, by the CUDA kernel `kernels/csrc/chol_inv.cu`.
  * `chol_inv_ref` the plain PyTorch version of the same function.
  * `chol_inv_blocked_ref` the kernel's blocked schedule written out in
                    PyTorch, for the tests (nothing on the main path calls it).
  * `factor_slab` <- `factor_slab_lanes` (`:119-170`): the left-looking
                    blocked partial factorization of a pivot slab.
  * `slab_kernel_eligible` <- `lanes_eligible` (`:191-211`): which levels
                    route through `factor_slab`.

Dispatch is by the tensor's device: a CPU tensor takes `chol_inv_ref` (the
CPU tests run the same control flow as the card), a CUDA tensor always
launches the kernel, and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

BS = 128                        # panel width = the kernel's block size

# Routing constants, kept from the JAX package so that the same levels
# route in both packages: a batch of at least MIN_B fronts, and
# B * W_PER_B >= W (the TPU's measured crossover). They are to be refitted
# from timings on the card.
MIN_B = 32
W_PER_B = 16

# Launches of each kernel, counted where the kernel is launched.
LAUNCHES = {"chol_inv": 0}

_FN = None


def _chol_inv_fn():
    global _FN
    if _FN is None:
        from cholesky_tpu_torch.kernels import build

        fn = build.load("chol_inv").chol_inv_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    fn = _chol_inv_fn()
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


def factor_slab(a: torch.Tensor, W: int, block_fn=chol_inv) -> torch.Tensor:
    """Blocked LEFT-looking partial factorization of the pivot-column slab
    [B, F, W]: rows [:W] become the pivot Cholesky, rows [W:] the solved
    boundary strip. Per 128-wide panel: one batched GEMM of all past column
    blocks, the diagonal block through `block_fn` (Cholesky + inverse), then
    `below @ inv(d)^T`. A tail panel narrower than 128 is identity-padded to
    128 (the Cholesky of blockdiag(d, I) is blockdiag(chol(d), I), exactly).

    The factored column blocks are written straight into the output, so
    `out[:, c0:, :c0]` is the JAX version's concatenation of past blocks.
    `block_fn=chol_inv_ref` gives the plain composite."""
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


def slab_kernel_eligible(B: int, W: int, dtype) -> bool:
    """Route a level through `factor_slab`: f32, at least one full
    128-panel, and a batch of at least max(MIN_B, W / W_PER_B) fronts. The
    rule does not depend on the device."""
    return (dtype == torch.float32 and W >= BS and B >= MIN_B
            and B * W_PER_B >= W)

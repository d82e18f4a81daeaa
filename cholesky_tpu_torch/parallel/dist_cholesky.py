"""Collective dense Cholesky of a large root front over a mesh — the port of
`cholesky_tpu/parallel/dist_cholesky.py`.

The elimination-tree placement (`mesh.py`) replicates the root, where the
FLOPs of a deep tree peak. A root front wide enough to amortize the
per-step traffic factors cooperatively instead, with the JAX package's
right-looking blocked algorithms; its `shard_map` bodies become per-slot
torch operations issued from one thread, and its collectives peer copies:

  * `distributed_cholesky` (1-D block-cyclic): column block k (width
    `block`) is owned by slot k % ndev. Per step the owner's panel (rows
    k block and below) is sent to every slot (JAX's masked `psum`); every
    slot factors the [block, block] diagonal block redundantly and solves
    the panel below it; the owner stores the factored panel; each slot
    updates only the columns it owns, with one GEMM.
  * `distributed_cholesky_2d` (2-D block-cyclic, the ScaLAPACK layout):
    tile (i, j) is owned by grid slot (i mod pr, j mod pc). Per step the
    diagonal tile goes to every slot; the column-k owners solve their
    panel rows; a row broadcast inside each grid row and a column
    broadcast of the L[j, k] tiles inside each grid column; one GEMM
    updates each slot's trailing tiles. On a multislice mesh the grid is
    (rows = the slots of a slice, columns = the slices).
  * `collective_cholesky` routes between them by `_pick_scheme`.

JAX's depth-1 lookahead (issuing the next panel's collective before the
trailing matmul) exists to overlap XLA's collectives with compute; here the
copies and the GEMMs of distinct cards are asynchronous on their own
devices' streams, so the step order is the plain one.

Each function returns the [F, F] lower factor, un-permuted, on the mesh's
first device, in the input's dtype (a bf16 input is computed in f32). With
`stats` (a dict), `stats["bytes"]` counts the bytes sent between slots by
the steps and `stats["gather_bytes"]` those of the final gather onto the
first slot (on logical slots of one card nothing crosses a link).

The knobs of the JAX package's environment are module constants here:
ROOT_SCHEME (CHOLESKY_TPU_ROOT_SCHEME: None, "1d" or "2d") and ROOT_BLOCK
(CHOLESKY_TPU_ROOT_BLOCK).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cholesky_tpu_torch.parallel.mesh import DCN_AXIS, TREE_AXIS, Mesh, _send

ROOT_SCHEME: Optional[str] = None   # "1d" / "2d" force the root's scheme
ROOT_BLOCK = 256                    # column block of the collective root


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _is_multislice(mesh: Mesh) -> bool:
    """A (slice, tree) mesh with >= 2 slices of >= 2 slots each (1-slot
    slices route like a flat mesh)."""
    return (mesh.axis_names == (DCN_AXIS, TREE_AXIS)
            and mesh.devices.shape[0] >= 2 and mesh.devices.shape[1] >= 2)


def _cyclic_perm(Fp: int, ndev: int, block: int) -> np.ndarray:
    """Global column -> block-cyclic storage position: column c of block
    k = c // block moves to owner d = k % ndev, local block j = k // ndev;
    its storage position is d (Fp / ndev) + j block + (c % block)."""
    k = np.arange(Fp) // block
    within = np.arange(Fp) % block
    d = k % ndev
    j = k // ndev
    return d * (Fp // ndev) + j * block + within


def _grid_for(ndev: int) -> tuple:
    """Near-square 2-D process grid (pr, pc) with pr pc = ndev, pr >= pc."""
    pr = int(np.sqrt(ndev))
    while ndev % pr:
        pr -= 1
    return max(pr, ndev // pr), min(pr, ndev // pr)


def _pick_scheme(F: int, ndev: int, block: int, mesh: Mesh = None) -> str:
    """The JAX package's routing: 1-D moves ~2 F^2 4 bytes per slot over
    the factorization, the (pr, pc) grid ~2 F^2 4 (1/pr + 1/pc); 2-D wins
    once 1/pr + 1/pc < 1 and the panel is tall (F >= 4 ndev block). A
    multislice mesh forces 2-D; ROOT_SCHEME overrides everything."""
    if ROOT_SCHEME in ("1d", "2d"):
        return ROOT_SCHEME
    if mesh is not None and _is_multislice(mesh):
        return "2d"
    pr, pc = _grid_for(ndev)
    if pc < 2:
        return "1d"
    if 1.0 / pr + 1.0 / pc >= 1.0:
        return "1d"
    if F < 4 * ndev * block:
        return "1d"
    return "2d"


def _chol(d: torch.Tensor) -> torch.Tensor:
    """Cholesky of one diagonal block; all NaN when it is not positive
    definite (as `frontal._cholesky`)."""
    L, info = torch.linalg.cholesky_ex(d)
    return L.masked_fill_(info != 0, float("nan"))


def _trsm(ld: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b @ inv(ld)^T."""
    return torch.linalg.solve_triangular(ld.T, b, upper=True, left=False)


def _padded(a: torch.Tensor, Fp: int, device) -> torch.Tensor:
    """`a` in its compute dtype on `device`, padded to [Fp, Fp] with a unit
    diagonal."""
    cdt = torch.float32 if a.dtype == torch.bfloat16 else a.dtype
    F = a.shape[0]
    out = torch.zeros((Fp, Fp), dtype=cdt, device=device)
    out[:F, :F] = a.to(device, cdt)
    idx = torch.arange(F, Fp, device=device)
    out[idx, idx] = 1.0
    return out


def _count(stats: Optional[dict], key: str, t: torch.Tensor) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + t.numel() * t.element_size()


def distributed_cholesky(a: torch.Tensor, mesh: Mesh, block: int = 256,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """Cholesky of an SPD [F, F] (lower triangle read) over all of `mesh`'s
    slots (slice-major on a multislice mesh) with 1-D block-cyclic column
    ownership. Returns L (zeros above the diagonal)."""
    devs = mesh.flat
    ndev = len(devs)
    F = a.shape[0]
    Fp = _round_up(F, ndev * block)
    nb, nl = Fp // block, Fp // (ndev * block)
    src = _padded(a, Fp, devs[0])
    # slot d holds column blocks d, d + ndev, ... (block-cyclic storage)
    cyc = src.view(Fp, nl, ndev, block)
    local = [cyc[:, :, d, :].reshape(Fp, nl * block).to(devs[d], copy=True)
             for d in range(ndev)]
    del src, cyc
    for k in range(nb):
        o, j = k % ndev, k // ndev
        kb, ke = k * block, (k + 1) * block
        # the owner's panel, rows kb and below (the owner overwrites its
        # columns below, so the slots read a copy)
        panel = local[o][kb:, j * block:(j + 1) * block].clone()
        for d in range(ndev):
            p = _send(panel, devs[d], stats, d != o)
            ld = _chol(p[:block])
            x = _trsm(ld, p[block:])                  # rows ke .. Fp
            if d == o:
                local[o][kb:ke, j * block:(j + 1) * block] = ld
                local[o][ke:, j * block:(j + 1) * block] = x
            # my column blocks right of the panel: k' = j' ndev + d > k
            j0 = max(0, -(-(k + 1 - d) // ndev))
            if j0 >= nl or x.shape[0] == 0:
                continue
            kp = torch.arange(j0, nl, device=x.device) * ndev + d
            xb = x.view(nb - k - 1, block, block)[kp - k - 1]
            local[d][ke:, j0 * block:].sub_(
                x @ xb.reshape(-1, block).T)
    out = torch.empty((Fp, Fp), dtype=local[0].dtype, device=devs[0])
    view = out.view(Fp, nl, ndev, block)
    for d in range(ndev):
        if d != 0:
            _count(stats, "gather_bytes", local[d])
        view[:, :, d, :] = local[d].to(devs[0]).view(Fp, nl, block)
    return out.tril_()[:F, :F].to(a.dtype)


def _grid(mesh: Mesh):
    """(pr, pc, device of grid slot (dr, dc)) of the 2-D scheme."""
    if _is_multislice(mesh):
        n_slices, per_slice = mesh.devices.shape
        return per_slice, n_slices, lambda dr, dc: mesh.devices[dc, dr]
    pr, pc = _grid_for(mesh.size)
    grid = mesh.devices.reshape(pr, pc)
    return pr, pc, lambda dr, dc: grid[dr, dc]


def distributed_cholesky_2d(a: torch.Tensor, mesh: Mesh, block: int = 256,
                            stats: Optional[dict] = None) -> torch.Tensor:
    """Cholesky of an SPD [F, F] over a 2-D block-cyclic (pr, pc) grid of
    `mesh`'s slots (near-square; (slots per slice, slices) on a multislice
    mesh). Per-slot wire volume ~2 F^2 4 (1/pr + 1/pc) bytes against the
    1-D scheme's ~2 F^2 4. Returns L (zeros above the diagonal)."""
    pr, pc, dev = _grid(mesh)
    F = a.shape[0]
    lcm = pr * pc // int(np.gcd(pr, pc))
    Fp = _round_up(F, lcm * block)
    nb = Fp // block
    nbr, nbc = nb // pr, nb // pc
    Fr, Fc = Fp // pr, Fp // pc
    first = dev(0, 0)
    src = _padded(a, Fp, first)
    tiles = src.view(nbr, pr, block, nbc, pc, block)
    local = {(r, c): tiles[:, r, :, :, c, :].reshape(Fr, Fc).to(
        dev(r, c), copy=True) for r in range(pr) for c in range(pc)}
    del src, tiles

    def first_after(k, d, p):
        """First local block index whose global block (i p + d) is > k."""
        return max(0, -(-(k + 1 - d) // p))

    for k in range(nb):
        kr, kc = k % pr, k % pc
        rk, ck = (k // pr) * block, (k // pc) * block
        # 1) the diagonal tile to every slot; each factors it
        tile = local[(kr, kc)][rk:rk + block, ck:ck + block]
        lds = {(r, c): _chol(_send(tile, dev(r, c), stats, (r, c) != (kr, kc)))
               for r in range(pr) for c in range(pc)}
        # 2) the column-k owners solve their panel rows below the tile
        i0 = [first_after(k, r, pr) for r in range(pr)]
        pk = {}
        for r in range(pr):
            col = local[(r, kc)]
            x = _trsm(lds[(r, kc)], col[i0[r] * block:, ck:ck + block])
            col[i0[r] * block:, ck:ck + block] = x
            if r == kr:
                col[rk:rk + block, ck:ck + block] = lds[(r, kc)]
            pk[(r, kc)] = x
        # 3) row broadcast: each grid row's panel rows to its slots
        for r in range(pr):
            for c in range(pc):
                if c != kc:
                    pk[(r, c)] = _send(pk[(r, kc)], dev(r, c), stats)
        # 4) column broadcast: the L[j, k] tiles of my column blocks j > k,
        #    each from the grid row that holds row block j
        for c in range(pc):
            j0 = first_after(k, c, pc)
            if j0 >= nbc:
                continue
            jg = np.arange(j0, nbc) * pc + c           # global column blocks
            for r in range(pr):
                if pk[(r, c)].shape[0] == 0:
                    continue
                yk = torch.empty(((nbc - j0) * block, block),
                                 dtype=pk[(r, c)].dtype, device=dev(r, c))
                for g in range(pr):
                    sel = np.flatnonzero(jg % pr == g)
                    if sel.size == 0:
                        continue
                    src_rows = ((jg[sel] // pr - i0[g])[:, None] * block
                                + np.arange(block)).reshape(-1)
                    got = pk[(g, c)][torch.from_numpy(src_rows).to(
                        pk[(g, c)].device)]
                    if g != r:
                        _count(stats, "bytes", got)
                    dst = (sel[:, None] * block + np.arange(block)).reshape(-1)
                    yk[torch.from_numpy(dst).to(yk.device)] = got.to(
                        yk.device)
                # 5) trailing update of my tiles: one GEMM
                local[(r, c)][i0[r] * block:, j0 * block:].sub_(
                    pk[(r, c)] @ yk.T)
    out = torch.empty((Fp, Fp), dtype=local[(0, 0)].dtype, device=first)
    view = out.view(nbr, pr, block, nbc, pc, block)
    for (r, c), t in local.items():
        if (r, c) != (0, 0):
            _count(stats, "gather_bytes", t)
        view[:, r, :, :, c, :] = t.to(first).view(nbr, block, nbc, block)
    return out.tril_()[:F, :F].to(a.dtype)


def collective_cholesky(a: torch.Tensor, mesh: Mesh,
                        block: Optional[int] = None,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """Route a root-front factorization to the 1-D or the 2-D scheme by
    (F, ndev, block) (`_pick_scheme`); `block` defaults to ROOT_BLOCK."""
    block = ROOT_BLOCK if block is None else block
    if _pick_scheme(int(a.shape[0]), mesh.size, block, mesh) == "2d":
        return distributed_cholesky_2d(a, mesh, block=block, stats=stats)
    return distributed_cholesky(a, mesh, block=block, stats=stats)

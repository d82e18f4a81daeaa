"""Device memory of the solver's long-lived state.

The plan's index maps, the assembler's scatter indices and the refinement's
ELL planes live as long as the solver; a level's fronts and updates live
for one level. Both come from PyTorch's caching allocator. A long-lived
tensor made after a level freed its fronts is carved out of one of their
cached segments and pins it: the next factorization can then not reuse
that segment for a front of the same size, and the driver has no room for
a new one. At 140^3 L14 on an 80 GB card, index maps made by two solves
pinned such segments, and the next factorization failed to allocate
17.26 GiB with 36 GiB reserved but unallocated.

`persistent(device)` routes the allocations of long-lived state to a
private pool of the caching allocator (`torch.cuda.MemPool`), whose
segments no front ever uses: with no factor alive, no large segment of the
common pool holds a live block. (A factorization's own slabs, factors and
updates still fragment the segments that the previous one left cached;
`SparseCholesky.factorize` returns those to the driver first when it
needs them.) The long-lived state then also survives that release: it is
not dropped and uploaded again. On the CPU `persistent` does nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

_POOLS: Dict[int, "torch.cuda.MemPool"] = {}    # device index -> pool


def persistent(device):
    """Context in which the current thread's allocations on `device` come
    from the pool of long-lived state (a null context off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    pool = _POOLS.get(index)
    if pool is None:
        with torch.cuda.device(index):
            pool = _POOLS[index] = torch.cuda.MemPool()
    return torch.cuda.use_mem_pool(pool, device=index)

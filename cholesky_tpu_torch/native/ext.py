"""ctypes bindings of the port's native host core (`src/mndio.cc`).

The same symbols, argument types and guards as `cholesky_tpu/native/ext.py`:
the uthash hash functions, the MatrixMarket body reader and writer, the
reference's open-addressing COO table, the cluster fill analysis
(`fill_initial`, `fill_analyze`), panel assembly, nested dissection,
minimum degree and column counts. Four things differ:

- Importing this module builds nothing and never fails. The library is
  built (`build.py`) and loaded at the first call; `available()` says
  whether that worked and `build_error()` why not. The first failure
  emits one `RuntimeWarning` with the compiler's message, so a caller that
  falls back to a Python path never does so unseen.
- `nd_order(threads=None)` uses min(os.cpu_count(), 8) threads; no
  environment variable is read.
- The library is loaded with ctypes' default mode (RTLD_LOCAL), so its C
  symbols never collide with the JAX package's copy in the same process.
- The bindings that pass COO arrays check that rows, cols and vals have
  one length, since the core reads len(vals) entries of each.

`CALLS[name]` counts the calls of each binding, so a caller can see that
a path ran natively.
"""

from __future__ import annotations

import collections
import ctypes
import math
import os
import threading
import warnings
from typing import Optional

import numpy as np

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_dbl = ctypes.c_double
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_dblp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

# symbol -> (restype, argtypes)
_SIGNATURES = {
    "mnd_hash_sax": (_u64, [_u64]),
    "mnd_hash_fnv": (_u64, [_u64]),
    "mnd_hash_ber": (_u64, [_u64]),
    "mnd_hash_oat": (_u64, [_u64]),
    "mnd_hash_jen": (_u64, [_u64]),
    "mnd_hash_sfh": (_u64, [_u64]),
    "mm_read_coo_body": (_i64, [ctypes.c_char_p, _i64, _i64p, _i64p, _dblp]),
    "mm_write_coo": (_i64, [ctypes.c_char_p, ctypes.c_char_p, _i64, _i64,
                            _i64, _i64p, _i64p, _dblp]),
    "mnd_build_hash_table": (None, [_i64p, _i64p, _dblp, _i64, _u64, _i64,
                                    _i64p, _dblp]),
    "mnd_hash_lookup": (_dbl, [_i64p, _dblp, _i64, _u64, _i64, _i64]),
    "assemble_panels": (None, [_i64p, _i64p, _dblp, _i64, _i64p, _i64p,
                               _i64, _i64, _i64p, _i64p, _i64p,
                               ctypes.POINTER(ctypes.c_void_p)]),
    "fill_analyze": (_i64, [_i64, _i64, _i64, _i64p, _u8p, _i64p, _i64p,
                            _i64p, _i64p, _i64p, _i64p,
                            ctypes.POINTER(ctypes.c_void_p), _i64p]),
    "fill_initial": (None, [_i64, _i64, _i64p, _i64p, _dblp, _i64p, _i64p,
                            _i64p, _i64p, _i64p, _i64p, _u8p, _i64p, _i64p]),
    "nd_order_mt": (_i64, [_i64, _i64, _i64p, _i64p, _i64, _i64p, _i64]),
    "md_order": (_i64, [_i64, _i64, _i64p, _i64p, _i64p]),
    "col_counts": (_i64, [_i64, _i64, _i64p, _i64p, _i64p]),
}

CALLS: collections.Counter = collections.Counter()

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None
_LOCK = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None or _ERROR is not None:
            return _LIB
        try:
            from cholesky_tpu_torch.native.build import build

            lib = ctypes.CDLL(build())
            for sym, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, sym)
                fn.restype = res
                fn.argtypes = args
            _LIB = lib
        except Exception as e:  # noqa: BLE001 — any build or load failure
            _ERROR = f"{type(e).__name__}: {e}"
            warnings.warn(
                "cholesky_tpu_torch: the native host core (libmndio) is "
                f"unavailable, the Python paths run instead:\n{_ERROR}",
                RuntimeWarning, stacklevel=3)
    return _LIB


def available() -> bool:
    """Whether the library is built and loaded (building it at first
    call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _load()
    return _ERROR


def use_native(native: Optional[bool]) -> bool:
    """Resolve a caller's `native` argument: None takes the library when
    it is available, True requires it (raises RuntimeError with the build
    error), False never takes it."""
    if native is None:
        return available()
    if native and not available():
        raise RuntimeError(f"native host core unavailable: {_ERROR}")
    return bool(native)


def _lib(name: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host core unavailable: {_ERROR}")
    CALLS[name] += 1
    return lib


def hash_sax(key: int) -> int:
    return int(_lib("hash_sax").mnd_hash_sax(_u64(key)))


def hash_fnv(key: int) -> int:
    return int(_lib("hash_fnv").mnd_hash_fnv(_u64(key)))


def hash_ber(key: int) -> int:
    return int(_lib("hash_ber").mnd_hash_ber(_u64(key)))


def hash_oat(key: int) -> int:
    return int(_lib("hash_oat").mnd_hash_oat(_u64(key)))


def hash_jen(key: int) -> int:
    return int(_lib("hash_jen").mnd_hash_jen(_u64(key)))


def hash_sfh(key: int) -> int:
    return int(_lib("hash_sfh").mnd_hash_sfh(_u64(key)))


def read_coo_body(path: str, nnz: int):
    """The nnz entries after a MatrixMarket coordinate header, 0-based
    (3-column bodies, or 2-column pattern bodies with values 1.0)."""
    lib = _lib("read_coo_body")
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    got = lib.mm_read_coo_body(path.encode(), _i64(nnz), rows, cols, vals)
    if got < 0:
        raise IOError(f"cannot read {path}")
    if got != nnz:
        raise IOError(f"{path}: expected {nnz} entries, read {got}")
    return rows, cols, vals


def _same_length(rows, cols, vals) -> None:
    # the C++ core reads len(vals) entries of each array
    if not len(rows) == len(cols) == len(vals):
        raise ValueError(f"rows, cols and vals differ in length: "
                         f"{len(rows)}, {len(cols)}, {len(vals)}")


def write_coo(path: str, banner: str, m: int, n: int, rows, cols, vals):
    """Write banner, size line and 1-based `%.17g` entries."""
    _same_length(rows, cols, vals)
    lib = _lib("write_coo")
    got = lib.mm_write_coo(path.encode(), banner.encode(), _i64(m), _i64(n),
                           _i64(len(vals)), rows, cols, vals)
    if got < 0:
        raise IOError(f"cannot write {path}")


def build_hash_table(rows, cols, vals, ncols: int, capacity=None):
    """The reference's open-addressing COO table (mnd.c:152-199): returns
    (tbl_idx [cap, 2], tbl_val [cap]) with hash_sax + linear probing.
    capacity defaults to the reference's ceil(nz / 0.75) (mnd.c:168)."""
    vals = np.ascontiguousarray(vals, np.float64)
    _same_length(rows, cols, vals)
    if capacity is None:
        capacity = int(math.ceil(len(vals) / 0.75))
    stored = int(np.count_nonzero(vals))
    if capacity <= stored:
        # a full table would make the linear-probe insert spin forever
        # (zero values are the empty-slot marker, so only nonzeros occupy)
        raise ValueError(
            f"hash capacity {capacity} must exceed the {stored} nonzero "
            f"entries (reference uses ceil(nz/0.75), mnd.c:168)")
    lib = _lib("build_hash_table")
    tbl_idx = np.empty((capacity, 2), dtype=np.int64)
    tbl_val = np.empty(capacity, dtype=np.float64)
    lib.mnd_build_hash_table(
        np.ascontiguousarray(rows, np.int64),
        np.ascontiguousarray(cols, np.int64),
        vals,
        _i64(len(vals)), _u64(ncols), _i64(capacity),
        tbl_idx.reshape(-1), tbl_val)
    return tbl_idx, tbl_val


def hash_lookup(tbl_idx, tbl_val, ncols: int, i: int, j: int) -> float:
    """Probe the table (search, mmat.rg:502-527)."""
    return float(_lib("hash_lookup").mnd_hash_lookup(
        np.ascontiguousarray(tbl_idx.reshape(-1), np.int64),
        np.ascontiguousarray(tbl_val, np.float64),
        _i64(len(tbl_val)), _u64(ncols), _i64(i), _i64(j)))


def fill_initial(nsep, rows, cols, vals, sep_of, loc_of, base, bounds0,
                 b0_off, b0_len, arena, cur_off, cur_nc) -> None:
    """Interval-0 filled flags from the COO lower triangle (fill_block
    reporting parity, mmat.rg:614-616). Mutates `arena` in place."""
    _same_length(rows, cols, vals)
    _lib("fill_initial").fill_initial(
        _i64(int(nsep)), _i64(len(vals)),
        np.ascontiguousarray(rows, np.int64),
        np.ascontiguousarray(cols, np.int64),
        np.ascontiguousarray(vals, np.float64),
        np.ascontiguousarray(sep_of, np.int64),
        np.ascontiguousarray(loc_of, np.int64),
        base, bounds0, b0_off, b0_len, arena, cur_off, cur_nc)


def fill_analyze(levels, nsep, nblocks, base, arena, cur_off, cur_nr, cur_nc,
                 nclus, merge_off, merge_data, snap_arenas, snap_off) -> None:
    """The interval-scheduled fill propagation + merge loop
    (compute_filled_clusters / merge_filled_clusters parity). Mutates
    `arena`, `cur_*` and fills the per-label `snap_arenas`."""
    lib = _lib("fill_analyze")
    ptrs = (ctypes.c_void_p * len(snap_arenas))()
    for i, a in enumerate(snap_arenas):
        assert a.dtype == np.uint8 and a.flags["C_CONTIGUOUS"]
        ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.fill_analyze(
        _i64(int(levels)), _i64(int(nsep)), _i64(int(nblocks)),
        base, arena, cur_off, cur_nr, cur_nc, nclus, merge_off, merge_data,
        ptrs, snap_off)
    if rc == -1:
        raise ValueError(
            "separator not merged to a single cluster at its elimination "
            "interval (reference invariant, mmat.rg:365-451)")
    if rc != 0:
        raise RuntimeError(f"fill_analyze failed with code {rc}")


def assemble_panels(rows, cols, vals, sep_of, loc_of, nsep, levels, row_off,
                    panels) -> None:
    """Scatter COO entries into the per-level [B, H, S] f64 panel buffers
    in place (the JAX package's panel engine; no caller in the port)."""
    _same_length(rows, cols, vals)
    lib = _lib("assemble_panels")
    ptrs = (ctypes.c_void_p * len(panels))()
    H = np.empty(len(panels), dtype=np.int64)
    S = np.empty(len(panels), dtype=np.int64)
    for i, p in enumerate(panels):
        assert p.dtype == np.float64 and p.flags["C_CONTIGUOUS"]
        ptrs[i] = p.ctypes.data_as(ctypes.c_void_p)
        H[i] = p.shape[1]
        S[i] = p.shape[2]
    lib.assemble_panels(
        np.ascontiguousarray(rows, np.int64),
        np.ascontiguousarray(cols, np.int64),
        np.ascontiguousarray(vals, np.float64),
        _i64(len(vals)),
        np.ascontiguousarray(sep_of, np.int64),
        np.ascontiguousarray(loc_of, np.int64),
        _i64(int(nsep)), _i64(int(levels)),
        np.ascontiguousarray(row_off, np.int64), H, S, ptrs)


def _check_range(n: int, rows, cols) -> None:
    # The C++ core indexes CSR/workspace arrays with these values; an
    # out-of-range dof (e.g. 1-based input) must fail like the Python
    # path's IndexError, not corrupt the heap.
    for name, arr in (("rows", rows), ("cols", cols)):
        if len(arr) and (arr.min() < 0 or arr.max() >= n):
            raise IndexError(
                f"{name} contains dof indices outside [0, {n}) "
                f"(min {arr.min()}, max {arr.max()}) — COO indices must be "
                f"0-based")


def nd_order(n: int, rows: np.ndarray, cols: np.ndarray,
             levels: int, threads: Optional[int] = None) -> np.ndarray:
    """Native nested-dissection core (a statement-level mirror of
    `symbolic/nd.py`'s Python path). Returns sep_of [n]: the heap index h
    (1 .. 2^levels - 1) of the separator or leaf owning each dof.

    `threads=None` uses min(os.cpu_count(), 8). The output is identical
    for every thread count: a tree depth's parts are disjoint subgraphs
    split by workers with private workspaces."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    _check_range(n, rows, cols)
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    lib = _lib("nd_order")
    sep_of = np.zeros(int(n), dtype=np.int64)
    rc = lib.nd_order_mt(_i64(int(n)), _i64(len(rows)), rows, cols,
                         _i64(int(levels)), sep_of, _i64(int(threads)))
    if rc != 0:
        raise RuntimeError(f"nd_order failed: rc={rc}")
    return sep_of


def md_order(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Native minimum-degree core (a statement-level mirror of
    `symbolic/mdtree.min_degree_perm`'s default approximate-degree mode).
    Returns perm [n] with perm[k] = original dof eliminated k-th, identical
    to the Python path (the lazy (deg, v) heap fixes the pop order)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _lib("md_order")
    perm = np.zeros(int(n), dtype=np.int64)
    rc = lib.md_order(_i64(int(n)), _i64(len(rows)), rows, cols, perm)
    if rc == 2:
        raise IndexError("rows/cols contain dof indices outside [0, n) — "
                         "COO indices must be 0-based")
    if rc != 0:
        raise RuntimeError(f"md_order failed: rc={rc}")
    return perm


def col_counts(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Exact per-column factor nonzero counts (diagonal included) of the
    symmetric pattern eliminated in natural order (Gilbert-Ng-Peyton,
    O(nnz alpha)); identical to `symbolic/quality._fill_flops_python`."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _lib("col_counts")
    cc = np.zeros(int(n), dtype=np.int64)
    rc = lib.col_counts(_i64(int(n)), _i64(len(rows)), rows, cols, cc)
    if rc == 2:
        raise IndexError("rows/cols contain dof indices outside [0, n) — "
                         "COO indices must be 0-based")
    if rc != 0:
        raise RuntimeError(f"col_counts failed: rc={rc}")
    return cc

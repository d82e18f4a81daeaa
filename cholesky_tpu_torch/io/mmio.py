"""MatrixMarket I/O.

The port's copy of `cholesky_tpu/io/mmio.py` (`read_banner`, `read_coo`,
`read_array`, `read_dense`, `symmetrize_coo`, `dedup_lower`, and the writers
`write_array`, `write_coo`, `write_dense_coo`), line for line. As in the
JAX package, `read_coo` parses the body of a non-pattern file and
`write_coo` writes with the native library (`native/`: `read_coo_body`,
`write_coo`) when it is available; `native=False` takes the NumPy paths,
whose output is the same, byte for byte.

Reference: the vendored NIST mmio library (mmio.c:96 `mm_read_banner`,
mmio.c:189 `mm_read_mtx_crd_size`, typecode macros mmio.h:33-75).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class MMBanner:
    """Parsed MatrixMarket banner + size line (reference: MMatBanner, mmat.rg:32-37)."""

    rows: int
    cols: int
    nnz: int
    # typecode fields, mirroring mmio.h's MM_typecode quadruple
    object: str = "matrix"          # matrix
    format: str = "coordinate"      # coordinate | array
    field: str = "real"             # real | integer | pattern | complex
    symmetry: str = "general"       # general | symmetric | hermitian | skew-symmetric

    @property
    def typecode(self) -> str:
        return f"%%MatrixMarket {self.object} {self.format} {self.field} {self.symmetry}"


class MMIOError(RuntimeError):
    pass


def read_banner(path: str) -> MMBanner:
    """Parse banner + size line only (reference: read_matrix_banner, mmat.rg:76-100)."""
    with open(path, "r") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise MMIOError(f"{path}: missing MatrixMarket banner")
        parts = header.strip().split()
        if len(parts) != 5:
            raise MMIOError(f"{path}: malformed banner: {header!r}")
        _, obj, fmt, field, sym = parts
        line = f.readline()
        while line.startswith("%") or line.strip() == "":
            if line == "":        # EOF — readline() returns '' forever
                raise MMIOError(f"{path}: missing size line")
            line = f.readline()
        toks = line.split()
        if fmt == "coordinate":
            rows, cols, nnz = int(toks[0]), int(toks[1]), int(toks[2])
        else:  # array
            rows, cols = int(toks[0]), int(toks[1])
            nnz = rows * cols
        return MMBanner(rows, cols, nnz, obj.lower(), fmt.lower(), field.lower(), sym.lower())


def read_coo(path: str, native: Optional[bool] = None):
    """Read a coordinate MatrixMarket file.

    Returns (banner, row_idx[int64], col_idx[int64], vals[float64]); indices are
    0-based. Symmetric/hermitian files are returned as stored (lower triangle),
    NOT expanded — expansion is the caller's choice. `native`: None takes the
    native body parser when the library is available, True requires it,
    False parses with NumPy.
    """
    banner = read_banner(path)
    if banner.format != "coordinate":
        raise MMIOError(f"{path}: expected coordinate format, got {banner.format}")
    if banner.field == "complex":
        # 4-column bodies: the 3-column parsers would silently mis-read them
        raise MMIOError(f"{path}: complex matrices are not supported")
    if banner.field != "pattern":      # native fscanf path needs 3 columns
        from cholesky_tpu_torch.native import ext

        if ext.use_native(native):
            rows, cols, vals = ext.read_coo_body(path, banner.nnz)
            return banner, rows, cols, vals
    # NumPy path
    with open(path, "r") as f:
        lines = f.read().split("\n")
    # skip banner/comments/size line
    i = 0
    while lines[i].startswith("%") or lines[i].strip() == "":
        i += 1
    i += 1  # size line
    body = [ln for ln in lines[i:] if ln.strip() and not ln.startswith("%")]
    if len(body) < banner.nnz:
        raise MMIOError(
            f"{path}: expected {banner.nnz} entries, found {len(body)}")
    data = np.loadtxt(body[:banner.nnz], dtype=np.float64, ndmin=2)
    if data.shape[1] == 2:  # pattern
        rows, cols = data[:, 0], data[:, 1]
        vals = np.ones(len(rows))
    else:
        rows, cols, vals = data[:, 0], data[:, 1], data[:, 2]
    return banner, rows.astype(np.int64) - 1, cols.astype(np.int64) - 1, vals


def read_array(path: str) -> np.ndarray:
    """Read a dense array MatrixMarket file (used for RHS B_*.mtx fixtures;
    reference: read_vector, mnd.c:201-229 skips 3 header lines then reads N values)."""
    banner = read_banner(path)
    if banner.format != "array":
        raise MMIOError(f"{path}: expected array format, got {banner.format}")
    with open(path, "r") as f:
        toks = []
        for line in f:
            if line.startswith("%"):
                continue
            toks.extend(line.split())
    # first two tokens are the size line
    vals = np.array(toks[2:2 + banner.rows * banner.cols], dtype=np.float64)
    # MatrixMarket array format is column-major
    return vals.reshape((banner.cols, banner.rows)).T


def symmetrize_coo(rows, cols, vals):
    """Expand a lower-triangle COO set to the full symmetric matrix:
    off-diagonal entries mirrored once. Input must be deduplicated lower
    triangle (see dedup_lower) — the single place the mirror idiom lives."""
    off = rows != cols
    return (np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]))


def dedup_lower(rows, cols, vals):
    """Normalize COO entries to the lower triangle and drop duplicate
    coordinates (keeping the first value). MatrixMarket files with
    'general' symmetry store BOTH triangles of a symmetric matrix; after
    lower-normalization each off-diagonal appears twice, and downstream
    mirroring would double it (assembly uses assignment, so it is the
    residual/refinement matvecs that would see 2x off-diagonals)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    swap = cols > rows
    r = np.where(swap, cols, rows)
    c = np.where(swap, rows, cols)
    keys = r * (max(int(c.max(initial=0)), int(r.max(initial=0))) + 1) + c
    _, first = np.unique(keys, return_index=True)
    first.sort()
    return r[first], c[first], vals[first]


def read_dense(path: str) -> np.ndarray:
    """Read any MatrixMarket file to a dense ndarray with symmetry expanded
    (equivalent of scipy.io.mmread(...).toarray() as used by verify.py:129-130)."""
    banner = read_banner(path)
    if banner.format == "array":
        return read_array(path)
    _, r, c, v = read_coo(path)
    a = np.zeros((banner.rows, banner.cols))
    a[r, c] = v
    if banner.symmetry in ("symmetric", "hermitian"):
        off = r != c
        a[c[off], r[off]] = v[off]
    elif banner.symmetry == "skew-symmetric":
        off = r != c
        a[c[off], r[off]] = -v[off]
    return a


def write_array(path: str, arr: np.ndarray, field: str = "real") -> None:
    """Write a dense array MatrixMarket file (column-major body) — what
    scipy.io.mmwrite emits for the reference's RHS fixtures
    (generate_b, verify.py:305-308)."""
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix array {field} general\n")
        f.write(f"{a.shape[0]} {a.shape[1]}\n")
        for j in range(a.shape[1]):
            for i in range(a.shape[0]):
                if field == "integer":
                    f.write(f"{int(a[i, j])}\n")
                else:
                    f.write(f"{a[i, j]:.17g}\n")


def write_coo(path: str, rows, cols, vals, shape, symmetry: str = "hermitian",
              field: str = "real", precision: int = 17,
              native: Optional[bool] = None) -> None:
    """Write a coordinate MatrixMarket file with 1-based indices
    (reference: write_matrix, mmat.rg:103-147 — banner, nnz count, then entries).
    `native`: None takes the native writer when the library is available,
    True requires it, False writes with Python. The native writer prints 17
    significant digits; another `precision` takes the Python writer."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if precision == 17:
        from cholesky_tpu_torch.native import ext

        if ext.use_native(native):
            ext.write_coo(path,
                          f"%%MatrixMarket matrix coordinate {field} {symmetry}",
                          shape[0], shape[1],
                          np.ascontiguousarray(rows, dtype=np.int64),
                          np.ascontiguousarray(cols, dtype=np.int64),
                          np.ascontiguousarray(vals, dtype=np.float64))
            return
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{shape[0]} {shape[1]} {len(vals)}\n")
        for i, j, v in zip(rows, cols, vals):
            f.write(f"{i + 1} {j + 1} {v:.{precision}g}\n")


def write_dense_coo(path: str, mat: np.ndarray, symmetry: str = "hermitian",
                    tol: float = 0.0) -> None:
    """Write the nonzero entries of a dense matrix as a coordinate file
    (the reference dumps its whole dense region this way, mmat.rg:114-144)."""
    r, c = np.nonzero(np.abs(mat) > tol)
    write_coo(path, r, c, mat[r, c], mat.shape, symmetry=symmetry)

"""Build the port's native host core (`src/mndio.cc`) with g++.

`src/mndio.cc` is a byte-for-byte copy of `cholesky_tpu/native/src/mndio.cc`,
so both packages run the same core: MatrixMarket parsing and writing, the
reference's hashed COO table, the cluster fill analysis, nested dissection,
minimum degree and column counts.

At first use it is compiled with the JAX package's command (`g++ -O3
-pthread -shared -fPIC`; no `-march=native`, so the library runs on any
x86-64 host that builds it) into `_build/libmndio_<hash>.so`, named by a
hash of the source and the flags. The compiler writes a temporary file
that is then renamed into place, so several processes may build at once.
A build that fails raises with the compiler's output. `BUILD_INFO` keeps
the build seconds, whether the library was cached, and its path.

Run: python -m cholesky_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src", "mndio.cc")
BUILD_DIR = os.path.join(HERE, "_build")

CXX_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")

BUILD_INFO: dict = {}


def compiler() -> str:
    """The C++ compiler: `g++` on the PATH."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on the PATH")
    return cxx


def library_path() -> str:
    """Where the library for this exact source and flag set lives."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmndio_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile src/mndio.cc unless a library for this exact source and flag
    set exists; return the library's path."""
    lib = library_path()
    if os.path.exists(lib):
        BUILD_INFO.update(seconds=0.0, cached=True, path=lib)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, SRC]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=seconds, cached=False, path=lib)
    return lib


if __name__ == "__main__":
    print(build())

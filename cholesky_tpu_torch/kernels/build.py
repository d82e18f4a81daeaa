"""Build the port's CUDA kernels and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
with `nvcc` for Hopper (`sm_90a`) into a shared library under `_build/`,
named by a hash of its source and flags, and loaded with `ctypes`. The
source includes no PyTorch header, so a build takes seconds. A build that
fails raises; nothing falls back to another implementation.

`nvcc` is found through `CUDA_HOME`, else through PyTorch's own guess
(`torch.utils.cpp_extension.CUDA_HOME`). `BUILD_INFO[name]` keeps the build
time and `-Xptxas -v` report (registers, shared memory, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("chol_inv", "factor_slab", "form_front", "schur_syrk",
           "signed_panel")

BUILD_INFO: dict = {}
_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if not home:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME")
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a library for this exact source and
    flag set exists; return the library's path."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    log = lib + ".log"
    if os.path.exists(lib):
        with open(log) as f:
            report = f.read()
        BUILD_INFO[name] = {"seconds": 0.0, "cached": True, "ptxas": report,
                            "path": lib}
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{report}")
    with open(log, "w") as f:
        f.write(report)
    os.replace(tmp, lib)
    BUILD_INFO[name] = {"seconds": seconds, "cached": False, "ptxas": report,
                        "path": lib}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build(name))
        return lib

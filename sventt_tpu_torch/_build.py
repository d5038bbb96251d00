"""Build and load the port's CUDA kernels.

``load()`` compiles ``csrc/*.cu`` with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, at first use, and loads it with
``ctypes``.  The library is named by a hash of its sources and flags, so an
edited source builds anew; it is written to a temporary name and renamed,
so concurrent first uses do not see a half-written file.  A build that
fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
#: Build outputs (listed in .gitignore).
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: What the last build in this process did: seconds and the compiler's
#: output (``-Xptxas -v`` prints each kernel's registers and spills).
LAST_BUILD: dict = {}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_shared(cmd_prefix: list[str], sources: list[str], deps: list[str],
                   name: str) -> str:
    """Compile ``sources`` with ``cmd_prefix`` into BUILD_DIR/lib<name>_<hash>.so
    unless it exists; return its path.  ``deps`` also enter the hash."""
    h = hashlib.sha256(" ".join(cmd_prefix).encode())
    for path in sorted(set(sources) | set(deps)):
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        LAST_BUILD.update(seconds=0.0, log="(cached)", path=out)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    r = subprocess.run(
        [*cmd_prefix, *sources, "-o", tmp], capture_output=True, text=True,
        timeout=600,
    )
    if r.returncode != 0:
        raise RuntimeError(
            f"build of {name} failed ({r.returncode}):\n{r.stdout}\n{r.stderr}"
        )
    os.replace(tmp, out)
    LAST_BUILD.update(
        seconds=time.perf_counter() - t0, log=r.stdout + r.stderr, path=out
    )
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            from .ops import ntt_mxu

            sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
            deps = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
            path = compile_shared([nvcc(), *NVCC_FLAGS], sources, deps, "sventt_kernels")
            lib = ctypes.CDLL(path)
            lib.sventt_mxu_ntt.restype = ctypes.c_int
            lib.sventt_mxu_ntt.argtypes = ntt_mxu._ARGTYPES
            _lib = lib
        return _lib

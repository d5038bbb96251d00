"""Build and load the port's CUDA kernels.

``load()`` compiles ``csrc/*.cu`` with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, at first use, and loads it with
``ctypes``.  Each source compiles to an object in its own ``nvcc`` process,
all started together, and the objects are linked into one library.  The
library is named by a hash of its sources and flags, so an edited source
builds anew; it is written to a temporary name and renamed, so concurrent
first uses do not see a half-written file.  A build that fails raises with
the compiler's output.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: What the last build in this process did: seconds and the compilers'
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


def _run(cmds: list[list[str]], name: str) -> str:
    """Run ``cmds`` all at once; return their joined output, raise on failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate(timeout=600)
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {p.returncode}\n{out}")
    if failed:
        raise RuntimeError(f"build of {name} failed:\n" + "\n".join(failed))
    return "".join(logs)


def compile_shared(compile_cmd: list[str], link_cmd: list[str], sources: list[str],
                   deps: list[str], name: str) -> str:
    """Build ``sources`` into BUILD_DIR/lib<name>_<hash>.so unless it exists;
    return its path.  Each source is compiled with ``compile_cmd ... -c`` in
    its own process (all at once), then ``link_cmd`` links the objects.
    ``deps`` (headers) also enter the hash."""
    h = hashlib.sha256(" ".join(compile_cmd + ["|"] + link_cmd).encode())
    for path in sorted(set(sources) | set(deps)):
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        LAST_BUILD.update(seconds=0.0, log="(cached)", path=out)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [
        os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in sources
    ]
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        log = _run([[*compile_cmd, "-c", s, "-o", o] for s, o in zip(sources, objs)], name)
        log += _run([[*link_cmd, *objs, "-o", tmp]], name)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)
    LAST_BUILD.update(seconds=time.perf_counter() - t0, log=log, path=out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            from .ops import inter_step, ntt_mxu, ntt_pallas, transpose
            from .parallel import ring

            sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
            deps = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
            path = compile_shared(
                [nvcc(), *NVCC_FLAGS], [nvcc(), *NVCC_FLAGS[:2], "-shared"], sources, deps,
                "sventt_kernels",
            )
            lib = ctypes.CDLL(path)
            for fn, argtypes in (
                (lib.sventt_mxu_ntt, ntt_mxu._ARGTYPES),
                (lib.sventt_mxu_ntt_tc, ntt_mxu._TC_ARGTYPES),
                (lib.sventt_mxu_ntt_tc_u7, ntt_mxu._TC_ARGTYPES),
                (lib.sventt_butterfly_ntt, ntt_pallas._ARGTYPES),
                (lib.sventt_radix2_ntt, ntt_pallas._RADIX2_ARGTYPES),
                (lib.sventt_grouped_ntt, ntt_pallas._GROUPED_REG_ARGTYPES),
                (lib.sventt_grouped_ntt_ranks, ntt_pallas._GROUPED_ARGTYPES),
                (lib.sventt_inter_step_mul, inter_step._ARGTYPES),
                (lib.sventt_transpose, transpose._ARGTYPES),
                (lib.sventt_ring_all_to_all, ring._ARGTYPES),
                (lib.sventt_enable_peer_access, ring._PEER_ARGTYPES),
            ):
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
        return _lib

"""The native C++ golden oracle.

``native_src/host_golden.cc`` (an exact radix-2 NTT over ``unsigned
__int128``; the port's own copy of the JAX package's oracle source) is
compiled with ``c++`` at first use into the port's build directory and
loaded with ``ctypes``.  Unlike the JAX package's loader, a failed build
raises: a check against the oracle never passes for want of one.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import _build
from .field.modulus import Modulus

SOURCE = os.path.join(_build._HERE, "native_src", "host_golden.cc")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The oracle library, built first if needed; raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(SOURCE):
                raise RuntimeError(f"oracle source missing: {SOURCE}")
            path = _build.compile_shared(
                ["c++", "-O3", "-fPIC"], ["c++", "-shared"], [SOURCE], [],
                "sventt_golden",
            )
            lib = ctypes.CDLL(path)
            p64 = ctypes.POINTER(ctypes.c_uint64)
            u64 = ctypes.c_uint64
            for fn in (lib.sventt_golden_forward, lib.sventt_golden_inverse):
                fn.restype = ctypes.c_int
                fn.argtypes = [p64, u64, u64, u64]
            _lib = lib
        return _lib


def _run(fn_name: str, data, modulus: int, generator: int) -> np.ndarray:
    out = np.ascontiguousarray(np.asarray(data, dtype=np.uint64)).copy()
    m = out.shape[0]
    if out.ndim != 1:
        raise ValueError("the oracle transforms one vector")
    omega = Modulus(modulus, generator).get_root_forward(m)
    rc = getattr(load(), fn_name)(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), m, modulus, omega
    )
    if rc != 0:
        raise ValueError(f"{fn_name} failed (m must be a power of two)")
    return out


def golden_forward(data, modulus: int, generator: int) -> np.ndarray:
    """Golden DIF forward (bit-reversed out) of canonical uint64 residues."""
    return _run("sventt_golden_forward", data, modulus, generator)


def golden_inverse(data, modulus: int, generator: int) -> np.ndarray:
    """Golden DIT inverse (bit-reversed in, natural order out)."""
    return _run("sventt_golden_inverse", data, modulus, generator)

"""The native C++ host library: the golden oracle and the q-series generators.

``native_src/host_golden.cc`` (an exact radix-2 NTT over ``unsigned
__int128``) and ``native_src/series.cc`` (the magic-series pipeline's
streaming generators: the q-Pochhammer product, the restricted-partition
stream and the Rothe-segment numerator), the port's own copies of the JAX
package's sources, are compiled with ``c++`` at first use into one library
in the port's build directory and loaded with ``ctypes``.  Unlike the JAX
package's loader, a failed build raises: a check against the oracle never
passes for want of one, and no generator falls back to numpy unasked.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import _build
from .field.modulus import Modulus

SOURCE = os.path.join(_build._HERE, "native_src", "host_golden.cc")
SERIES_SOURCE = os.path.join(_build._HERE, "native_src", "series.cc")
SOURCES = (SOURCE, SERIES_SOURCE)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The host library, built first if needed; raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            for src in SOURCES:
                if not os.path.exists(src):
                    raise RuntimeError(f"native source missing: {src}")
            path = _build.compile_shared(
                ["c++", "-O3", "-fPIC"], ["c++", "-shared"], list(SOURCES), [],
                "sventt_host",
            )
            lib = ctypes.CDLL(path)
            p64 = ctypes.POINTER(ctypes.c_uint64)
            u64 = ctypes.c_uint64
            for fn, res, args in (
                (lib.sventt_golden_forward, ctypes.c_int, [p64, u64, u64, u64]),
                (lib.sventt_golden_inverse, ctypes.c_int, [p64, u64, u64, u64]),
                (lib.sventt_qpochhammer, ctypes.c_int, [p64, u64, u64, u64]),
                (lib.sventt_rp_create, ctypes.c_void_p, [u64, u64]),
                (lib.sventt_rp_destroy, None, [ctypes.c_void_p]),
                (lib.sventt_rp_next, ctypes.c_int, [ctypes.c_void_p, p64, u64]),
                (lib.sventt_gauss_numerator_range, ctypes.c_int, [p64, u64, u64, u64, u64, u64]),
            ):
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _unsigned(**args: int) -> None:
    """Refuse a negative argument: ctypes would pass it as a huge u64."""
    for name, v in args.items():
        if v < 0:
            raise ValueError(f"{name} must be >= 0, got {v}")


def _run(fn_name: str, data, modulus: int, generator: int) -> np.ndarray:
    out = np.ascontiguousarray(np.asarray(data, dtype=np.uint64)).copy()
    m = out.shape[0]
    if out.ndim != 1:
        raise ValueError("the oracle transforms one vector")
    omega = Modulus(modulus, generator).get_root_forward(m)
    rc = getattr(load(), fn_name)(_ptr(out), m, modulus, omega)
    if rc != 0:
        raise ValueError(f"{fn_name} failed (m must be a power of two)")
    return out


def golden_forward(data, modulus: int, generator: int) -> np.ndarray:
    """Golden DIF forward (bit-reversed out) of canonical uint64 residues."""
    return _run("sventt_golden_forward", data, modulus, generator)


def golden_inverse(data, modulus: int, generator: int) -> np.ndarray:
    """Golden DIT inverse (bit-reversed in, natural order out)."""
    return _run("sventt_golden_inverse", data, modulus, generator)


def qpochhammer(k: int, degree: int, modulus: int) -> np.ndarray:
    """Coefficients [0..degree] of (q;q)_k = prod_{i=1}^{k} (1 - q^i) mod N."""
    _unsigned(k=k, degree=degree)
    out = np.empty(degree + 1, dtype=np.uint64)
    if load().sventt_qpochhammer(_ptr(out), degree + 1, k, modulus) != 0:
        raise ValueError("qpochhammer failed")
    return out


class RestrictedPartitionStream:
    """Streaming coefficients of 1/(q;q)_k, i.e. p(n | parts <= k) mod N,
    with O(k^2) state: ``next(count)`` returns the next ``count``
    coefficients, however far the stream has gone.  A context manager."""

    def __init__(self, k: int, modulus: int):
        _unsigned(k=k)
        self._lib = load()
        self._h = self._lib.sventt_rp_create(k, modulus)
        if not self._h:
            raise MemoryError("rp_create failed")
        self.k = k
        self.modulus = modulus
        self.position = 0

    def next(self, count: int) -> np.ndarray:
        _unsigned(count=count)
        out = np.empty(count, dtype=np.uint64)
        if self._lib.sventt_rp_next(self._h, _ptr(out), count) != 0:
            raise ValueError("rp_next failed")
        self.position += count
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sventt_rp_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def restricted_partition_stream(k: int, modulus: int) -> RestrictedPartitionStream:
    """A new ``RestrictedPartitionStream`` of 1/(q;q)_k mod N."""
    return RestrictedPartitionStream(k, modulus)


def gauss_numerator_range(lo: int, count: int, n: int, k: int, modulus: int) -> np.ndarray:
    """Coefficients [lo, lo+count) of prod_{i=n-k+1}^{n} (1 - q^i) mod N,
    from its k+1 Rothe segments, never the whole polynomial."""
    _unsigned(lo=lo, count=count, n=n, k=k)
    out = np.empty(count, dtype=np.uint64)
    rc = load().sventt_gauss_numerator_range(_ptr(out), lo, count, n, k, modulus)
    if rc == 2:
        raise MemoryError("gauss_numerator_range: scratch allocation failed")
    if rc != 0:
        raise ValueError("gauss_numerator_range failed (requires k <= n)")
    return out

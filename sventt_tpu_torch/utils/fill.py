"""Deterministic full-range inputs, made on the host or on the device.

The counterpart of ``sventt_tpu/utils/fill.py``: a splitmix64 mix of the
indices 1..n, masked to ``2^(bit_width(N)-1) - 1`` so every value is below
N.  ``host_fill`` (numpy uint64) and ``device_fill`` (int64 tensor on the card
by default, or on the device given) give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.limb import _shr, s64
from .device import resolve_device

_C1 = 0x9E3779B97F4A7C15
_C2 = 0xBF58476D1CE4E5B9
_C3 = 0x94D049BB133111EB


def _mask(modulus: int) -> int:
    return (1 << (modulus.bit_length() - 1)) - 1


def host_fill(n: int, modulus: int) -> np.ndarray:
    """The splitmix64 fill as numpy uint64 (bit-identical to device_fill)."""
    old = np.seterr(over="ignore")
    try:
        z = (np.arange(1, n + 1, dtype=np.uint64)) * np.uint64(_C1)
        z ^= z >> np.uint64(30)
        z *= np.uint64(_C2)
        z ^= z >> np.uint64(27)
        z *= np.uint64(_C3)
        z ^= z >> np.uint64(31)
        return z & np.uint64(_mask(modulus))
    finally:
        np.seterr(**old)


def device_fill(n: int, modulus: int, device=None) -> torch.Tensor:
    """``host_fill``'s values as an int64 tensor made on ``device`` (None:
    the CUDA card)."""
    device = resolve_device(device)
    z = torch.arange(1, n + 1, dtype=torch.int64, device=device) * s64(_C1)
    z = z ^ _shr(z, 30)
    z = z * s64(_C2)
    z = z ^ _shr(z, 27)
    z = z * s64(_C3)
    z = z ^ _shr(z, 31)
    return z & _mask(modulus)

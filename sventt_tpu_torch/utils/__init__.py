"""Utilities of the PyTorch port."""

from .cache import cached_ntt, clear_ntt_cache
from .device import resolve_device
from .fill import device_fill, host_fill
from .profiling import phase_breakdown, span, trace
from .timing import time_chained

__all__ = [
    "cached_ntt",
    "clear_ntt_cache",
    "device_fill",
    "host_fill",
    "phase_breakdown",
    "resolve_device",
    "span",
    "time_chained",
    "trace",
]

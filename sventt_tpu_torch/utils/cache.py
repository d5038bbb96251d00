"""Instance cache: one NTT per (config, device) per process.

The counterpart of ``sventt_tpu/utils/cache.py``: table preparation takes
host work and device memory, so repeated construction (applications,
benchmarks, notebooks) reuses the prepared tables.  The key is the config
and the resolved device, so the same config on the CPU and on the card are
two entries.
"""

from __future__ import annotations

import threading

import torch

from ..plan.config import NttConfig
from ..plan.wrapper import NTT
from .device import resolve_device

#: Guards the dicts only -- NEVER held across NTT construction (table prep
#: takes seconds; unrelated configs must not serialize on it).
_lock = threading.Lock()
_cache: dict[tuple[NttConfig, torch.device], NTT] = {}
_building: dict[tuple[NttConfig, torch.device], threading.Lock] = {}


def cached_ntt(
    config: NttConfig, enable_forward: bool = True, enable_inverse: bool = True,
    *, device=None,
) -> NTT:
    """The process-wide NTT instance for this config on ``device`` (None:
    the card), constructed once.

    Cached instances are always built with both directions enabled, so any
    combination of the ``enable_*`` flags is satisfied by the same entry
    (the flags exist for signature parity with ``NTT``).  Construction runs
    under a per-key lock: two threads warming different configs build
    concurrently, two threads racing the same config build it once.
    """
    key = (config, resolve_device(device))
    with _lock:
        ntt = _cache.get(key)
        if ntt is not None:
            return ntt
        keylock = _building.setdefault(key, threading.Lock())
    with keylock:
        with _lock:
            ntt = _cache.get(key)
        if ntt is None:
            ntt = NTT(config, enable_forward=True, enable_inverse=True, device=key[1])
            with _lock:
                _cache[key] = ntt
        return ntt


def clear_ntt_cache() -> None:
    with _lock:
        _cache.clear()
        _building.clear()

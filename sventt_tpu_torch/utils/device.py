"""The device default of the port's entry points and public table builders.

``device=None`` means the current CUDA card; ``device="cpu"`` is the
explicit CPU route, on which every kernel wrapper runs its plain PyTorch
version.  Asking for a card where there is none raises ``RuntimeError``.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, None meaning the current CUDA card."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested (the default is the CUDA card) but "
                "CUDA is not available; pass device='cpu' for the CPU route"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index`` (launch geometry)."""
    return torch.cuda.get_device_properties(index).multi_processor_count

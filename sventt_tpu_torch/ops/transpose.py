"""Transposes of the six-step schedule.

The counterpart of ``sventt_tpu/ops/transpose.py::transpose01_u64`` on its
XLA path (the only one the default schedules take): a copy of the tensor
with its two leading axes swapped.  The blocked Pallas transpose (kernels
K9a/K9b) is not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch


def transpose01(x: torch.Tensor) -> torch.Tensor:
    """Swap the two leading axes into a new contiguous tensor."""
    return x.transpose(0, 1).contiguous()

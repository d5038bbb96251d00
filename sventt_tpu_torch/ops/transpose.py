"""Transpose strategies for the six-step decomposition.

The counterpart of ``sventt_tpu/ops/transpose.py``, with its two
strategies:

* ``xla`` -- ``transpose_xla`` (alias ``transpose01``): a contiguous copy
  with the two leading axes swapped, the torch op the JAX package's
  ``jnp.transpose`` becomes.  The planner's fallback transposes take it,
  because ``NttConfig.transpose`` allows "auto" / "xla" only.
* ``pallas`` -- the blocked 2-D transpose, on the card the kernel
  ``csrc/transpose.cu`` (K9a ``transpose_pallas`` for one 4- or 8-byte
  plane, K9b ``transpose_u64`` for a u64, which the JAX package holds as
  two limb planes and the port as one int64 word).  ``br`` / ``bc`` keep
  their meaning at this API -- they must divide the shape -- and the kernel
  picks its own shared-memory tile.  On a CPU tensor it runs the plain
  version ``transpose_pallas_plain``.

``LAUNCHES`` / ``PLAIN_CALLS`` count the blocked transpose per entry:
"plane" (K9a) and "pair" (K9b).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span

LAUNCHES = {"plane": 0, "pair": 0}
#: The host span of each entry's launch (``utils.profiling.span``).
LAUNCH_SPANS = {k: f"sventt.launch.{k}" for k in LAUNCHES}
PLAIN_CALLS = {"plane": 0, "pair": 0}


def transpose_xla(x: torch.Tensor) -> torch.Tensor:
    """Swap the two leading axes into a new contiguous tensor (any trailing
    batch dims)."""
    return x.transpose(0, 1).contiguous()


#: The planner's name for the torch copy.
transpose01 = transpose_xla


def transpose_pallas_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of the blocked transpose of a 2-D tensor."""
    return x.t().contiguous()


def _blocked(x: torch.Tensor, entry: str, br: int = 256, bc: int = 256) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"the blocked transpose takes a 2-D tensor, got {x.dim()}-D")
    r, c = x.shape
    if r % br or c % bc:
        raise ValueError(
            f"shape ({r}, {c}) not divisible by blocks ({br}, {bc}); "
            "a floor-divided grid would silently drop the remainder"
        )
    if x.element_size() not in (4, 8):
        raise TypeError(f"the blocked transpose takes 4- or 8-byte elements, got {x.dtype}")
    if x.is_cuda:
        from .. import _build

        with span(LAUNCH_SPANS[entry]):
            xc = x.contiguous()
            out = torch.empty((c, r), dtype=x.dtype, device=x.device)
            rc = _build.load().sventt_transpose(
                xc.data_ptr(), out.data_ptr(), r, c, x.element_size(),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
            if rc != 0:
                raise RuntimeError(f"transpose kernel launch failed: CUDA error {rc}")
        LAUNCHES[entry] += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"the blocked transpose runs on cpu or cuda tensors, got {x.device}")
    PLAIN_CALLS[entry] += 1
    return transpose_pallas_plain(x)


def transpose_pallas(x: torch.Tensor, br: int = 256, bc: int = 256) -> torch.Tensor:
    """Blocked 2-D transpose of an (R, C) plane -> (C, R) (K9a).

    Requires R % br == 0 and C % bc == 0; int32 / int64 (any 4- or 8-byte
    element type).
    """
    return _blocked(x, "plane", br, bc)


def transpose_u64(x: torch.Tensor, strategy: str = "xla", **kw) -> torch.Tensor:
    """Transpose an int64 tensor of u64 bit patterns with the chosen
    strategy: "xla" swaps the two leading axes; "pallas" is the blocked
    2-D kernel (K9b), ``kw`` its ``br`` / ``bc``."""
    if x.dtype != torch.int64:
        raise TypeError(f"expected an int64 tensor of u64 bit patterns, got {x.dtype}")
    if strategy == "xla":
        return transpose_xla(x)
    if strategy == "pallas":
        return _blocked(x, "pair", **kw)
    raise ValueError(f"unknown transpose strategy {strategy!r}")


def transpose01_u64(x: torch.Tensor, strategy: str | None = None, block: int = 256) -> torch.Tensor:
    """Swap the two leading axes of a u64 tensor with a configurable
    strategy, dispatched as the JAX package does: "pallas" takes the
    blocked kernel when the shape is 2-D with block-divisible axes, and
    everything else (3-D, indivisible, None, "auto", "xla") the torch
    copy."""
    if (
        strategy == "pallas"
        and x.dim() == 2
        and x.shape[0] % block == 0
        and x.shape[1] % block == 0
    ):
        return transpose_u64(x, "pallas", br=block, bc=block)
    return transpose_xla(x)


def reset_counts() -> None:
    """Set every launch and plain-call count to zero."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ctypes signature of the C entry in csrc/transpose.cu
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]

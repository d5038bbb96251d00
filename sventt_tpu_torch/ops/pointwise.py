"""The pointwise product of two spectra as a pass of its own.

The counterpart of the middle step of ``sventt_tpu/apps/convolve.py::
cyclic_convolve``: ``b`` moved into the Montgomery domain by a Montgomery
product with R^2 mod N, then the Montgomery product with ``a``, normalized
when lazy, so the result is ``a * b mod N`` in the plain domain.  The JAX
package leaves this step to XLA, which fuses it into one pass; on the card
it is the elementwise kernel ``csrc/pointwise.cu``, on a CPU tensor its
plain version ``mont_product_plain``.  The two agree bit for bit.
``LAUNCHES`` / ``PLAIN_CALLS`` count them.
"""

from __future__ import annotations

import ctypes

import torch

from ..field.limb import FieldConsts, s64
from ..utils.profiling import span

LAUNCHES = {"pointwise": 0}
PLAIN_CALLS = {"pointwise": 0}


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"operands must be int64, got {a.dtype} and {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def mont_product_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor, r2: int) -> torch.Tensor:
    """The product as plain torch ops on any device."""
    b_mont = fc.mont_mul_full(b, torch.full_like(b, s64(r2)))  # to Montgomery domain
    prod = fc.mont_mul_full(a, b_mont)
    return fc.normalize(prod) if fc.lazy else prod


def mont_product(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor, r2: int) -> torch.Tensor:
    """``a * b mod N`` elementwise, for int64 words ``a`` and ``b`` of one
    shape on one device, canonical (or below 2N when ``fc.lazy``); ``r2``
    is R^2 mod N (``Modulus.montgomery_r2``).  The result is canonical, of
    ``a``'s shape (contiguous from the kernel)."""
    _check(a, b)
    if a.is_cuda:
        from .. import _build

        with span("sventt.launch.pointwise"):
            ac, bc = a.contiguous(), b.contiguous()
            out = torch.empty(ac.shape, dtype=torch.int64, device=ac.device)
            if out.numel() == 0:
                return out
            with torch.cuda.device(a.device):
                rc = _build.load().sventt_pointwise_mont_mul(
                    ac.data_ptr(), bc.data_ptr(), out.data_ptr(), out.numel(), int(fc.lazy),
                    fc.modulus, fc.montgomery_inverse, r2,
                    torch.cuda.current_stream(a.device).cuda_stream,
                )
            if rc != 0:
                raise RuntimeError(f"pointwise kernel launch failed: CUDA error {rc}")
        LAUNCHES["pointwise"] += 1
        return out
    if a.device.type != "cpu":
        raise ValueError(f"pointwise product runs on cpu or cuda tensors, got {a.device}")
    PLAIN_CALLS["pointwise"] += 1
    return mont_product_plain(fc, a, b, r2)


def reset_counts() -> None:
    """Set the launch and plain-call counts to zero."""
    LAUNCHES["pointwise"] = PLAIN_CALLS["pointwise"] = 0


# ctypes signature of the C entry in csrc/pointwise.cu
_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_ulonglong] * 3
    + [ctypes.c_void_p]
)

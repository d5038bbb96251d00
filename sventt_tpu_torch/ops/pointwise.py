"""The pointwise product of two spectra as a pass of its own.

The counterpart of the middle step of ``sventt_tpu/apps/convolve.py::
cyclic_convolve``: ``b`` moved into the Montgomery domain by a Montgomery
product with R^2 mod N, then the Montgomery product with ``a``, normalized
when lazy, so the result is ``a * b mod N`` in the plain domain.  The JAX
package leaves this step to XLA, which fuses it into one pass; on the card
it is the elementwise kernel ``csrc/pointwise.cu``, on a CPU tensor its
plain version ``mont_product_plain``.  The two agree bit for bit.
``LAUNCHES`` / ``PLAIN_CALLS`` count them.

Stacked limbs (``fc`` a ``LimbConsts``, operands (L, ...) with limb l at
row l) take each limb's N, N^-1 and R^2 from the limbs' constant table on
the device, in one launch for all limbs (``LIMBS`` counts the limbs
carried); on the CPU the plain version runs limb by limb.
"""

from __future__ import annotations

import ctypes

import torch

from ..field.limb import FieldConsts, LimbConsts, s64
from ..utils.profiling import span

LAUNCHES = {"pointwise": 0}
PLAIN_CALLS = {"pointwise": 0}
#: Limbs carried, summed over the launches (1 a single-modulus launch).
LIMBS = {"pointwise": 0}


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


def mont_product(
    fc: FieldConsts | LimbConsts, a: torch.Tensor, b: torch.Tensor, r2: int | None
) -> torch.Tensor:
    """``a * b mod N`` elementwise, for int64 words ``a`` and ``b`` of one
    shape on one device, canonical (or below 2N when ``fc.lazy``); ``r2``
    is R^2 mod N (``Modulus.montgomery_r2``).  The result is canonical, of
    ``a``'s shape (contiguous from the kernel).  ``fc`` a ``LimbConsts``:
    row l of (L, ...) operands mod limb l's N, ``r2`` None (each limb's
    is its own)."""
    _check(a, b)
    if isinstance(fc, LimbConsts):
        return _limbs_product(fc, a, b)
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
        LIMBS["pointwise"] += 1
        return out
    if a.device.type != "cpu":
        raise ValueError(f"pointwise product runs on cpu or cuda tensors, got {a.device}")
    PLAIN_CALLS["pointwise"] += 1
    return mont_product_plain(fc, a, b, r2)


def _limbs_product(fc: LimbConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mont_product`` of stacked limbs: one launch for all L limbs (the
    kernel's grid takes the limb as its second axis), or the plain version
    limb by limb on the CPU."""
    L = len(fc)
    if a.dim() < 1 or a.shape[0] != L:
        raise ValueError(f"leading axis of {tuple(a.shape)} != {L} limbs")
    if a.is_cuda:
        from .. import _build

        with span("sventt.launch.pointwise"):
            ac, bc = a.contiguous(), b.contiguous()
            out = torch.empty(ac.shape, dtype=torch.int64, device=ac.device)
            if out.numel() == 0:
                return out
            with torch.cuda.device(a.device):
                rc = _build.load().sventt_pointwise_mont_mul_limbs(
                    ac.data_ptr(), bc.data_ptr(), out.data_ptr(), out.numel() // L, L,
                    int(fc.lazy), fc.table(a.device).data_ptr(),
                    torch.cuda.current_stream(a.device).cuda_stream,
                )
            if rc != 0:
                raise RuntimeError(f"pointwise limb kernel launch failed: CUDA error {rc}")
        LAUNCHES["pointwise"] += 1
        LIMBS["pointwise"] += L
        return out
    if a.device.type != "cpu":
        raise ValueError(f"pointwise product runs on cpu or cuda tensors, got {a.device}")
    PLAIN_CALLS["pointwise"] += 1
    return torch.stack([mont_product_plain(f, x, y, pow(2, 128, f.modulus))
                        for f, x, y in zip(fc.limbs, a, b)])


def reset_counts() -> None:
    """Set the launch, plain-call and limb counts to zero."""
    LAUNCHES["pointwise"] = PLAIN_CALLS["pointwise"] = LIMBS["pointwise"] = 0


# ctypes signatures of the C entries in csrc/pointwise.cu
_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_ulonglong] * 3
    + [ctypes.c_void_p]
)
_LIMB_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 2
)

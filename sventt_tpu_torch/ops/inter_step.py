"""The six-step inter-step twiddle multiply as a pass of its own.

The counterpart of ``sventt_tpu/plan/planner.py::_mont_mul_bcast``:
(m0, m1, batch...) data times an (m0, m1) twiddle matrix broadcast over the
batch (``twiddle.inter_step_mul``): Solinas on plain twiddles under the
Solinas engine, else Montgomery with the companion table or computing it
in flight.  The planner runs it
only on its transpose fallback (a grouped inner row step, a row subtree);
the fused row kernels multiply the twiddle in their own prologue or
epilogue.  The JAX package leaves this pass to XLA; on the card it is the
elementwise kernel ``csrc/inter_step.cu``, on a CPU tensor its plain
version ``inter_step_mul``.  ``LAUNCHES`` / ``PLAIN_CALLS`` count them.
"""

from __future__ import annotations

import ctypes

import torch

from ..field.limb import FieldConsts
from ..utils.profiling import span
from .twiddle import MontPair, check_companion, inter_step_mul

LAUNCHES = {"inter_step": 0}
PLAIN_CALLS = {"inter_step": 0}


def _check(x: torch.Tensor, tw: MontPair) -> None:
    if x.dim() < 2:
        raise ValueError(f"expected (m0, m1, batch...) data, got shape {tuple(x.shape)}")
    for v in tw:
        if v is None:
            continue
        if tuple(v.shape) != tuple(x.shape[:2]):
            raise ValueError(f"twiddle shape {tuple(v.shape)} != {tuple(x.shape[:2])}")
        if v.device != x.device:
            raise ValueError(f"twiddles on {v.device}, data on {x.device}")
        if v.dtype != torch.int64:
            raise TypeError("twiddles must be int64")
    if x.dtype != torch.int64:
        raise TypeError("data must be int64")


def mont_mul_bcast(fc: FieldConsts, x: torch.Tensor, tw: MontPair) -> torch.Tensor:
    """``x`` (m0, m1, batch...) times the (m0, m1) inter-step twiddles
    ``tw`` (companion optional; refused under Solinas), broadcast over the
    batch."""
    _check(x, tw)
    check_companion(fc, tw)
    rows = x.shape[0] * x.shape[1]
    B = x.numel() // rows
    if x.is_cuda:
        from .. import _build

        with span("sventt.launch.inter_step"):
            xc = x.contiguous()
            w = tw.w.contiguous()
            wp = None if tw.wp is None else tw.wp.contiguous()
            mode = 3 if fc.modmul == "solinas" else (2 if wp is None else 1)
            out = torch.empty_like(xc)
            rc = _build.load().sventt_inter_step_mul(
                xc.data_ptr(), out.data_ptr(), w.data_ptr(), None if wp is None else wp.data_ptr(),
                rows, B, mode, int(fc.lazy), fc.modulus, fc.montgomery_inverse,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
            if rc != 0:
                raise RuntimeError(f"inter-step kernel launch failed: CUDA error {rc}")
        LAUNCHES["inter_step"] += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"inter-step multiply runs on cpu or cuda tensors, got {x.device}")
    PLAIN_CALLS["inter_step"] += 1
    shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
    return inter_step_mul(
        fc, x, MontPair(tw.w.reshape(shape), None if tw.wp is None else tw.wp.reshape(shape))
    )


def reset_counts() -> None:
    """Set the launch and plain-call counts to zero."""
    LAUNCHES["inter_step"] = PLAIN_CALLS["inter_step"] = 0


# ctypes signature of the C entry in csrc/inter_step.cu
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 2
    + [ctypes.c_ulonglong] * 2
    + [ctypes.c_void_p]
)

"""K11: the round-4 fused prototype of the matrix NTT, as a library function.

The counterpart of ``experimental/mxu_fused_kernel.py`` (``mxu_ntt``, body
``kernel``): a forward length-R NTT (R = 128 there) of (R, B) data, in
bit-reversed order and canonical, as ONE product with the u7 planes of the
Montgomery-lifted DFT matrix -- ten unsigned 7-bit planes of the matrix and
of the data, 19 product planes recombined, the top word folded, a Montgomery
REDC.  The JAX file builds its tables and data and times itself when it is
imported; here the pieces are functions, and importing this module computes
nothing.

On a CUDA tensor ``mxu_fused_ntt`` launches the kernel that
``ops.ntt_mxu.kernel_for("u7", "lead")`` names, the u7 lead form of the
int8 tensor-core matrix kernel (``csrc/ntt_mxu_tc_u7.cu``) at m = R with no
twiddle, counted under ``LAUNCHES["fused"]`` (and under
``ntt_mxu.KERNEL_LAUNCHES``); on a CPU tensor it runs the u7 plain version
(``ops.ntt_mxu._mxu_plain``), counted under ``PLAIN_CALLS["fused"]``.  The
tables of a stack (its copy in the kernel's tile layout) are built at its
first call and kept for the last few stacks.

K11's own tail differs from ``_mxu_body``'s: it drops the carry out of the
high word after the fold and always does two conditional subtracts.  The
port takes ``_mxu_body``'s exact tail, which folds that carry back.  The two
agree unless the carry is taken, which needs the high word within about R
of 2^64: no random input reaches it, a constructed one does (ROADMAP Queue
3; ``tests/test_torch_mxu_fused.py``).
"""

from __future__ import annotations

import torch

from ..field.limb import FieldConsts
from ..field.modulus import Modulus
from ..ops import ntt_mxu
from ..utils.profiling import span

#: K11's transform length.
R_FUSED = 128

#: Kernel launches (where the kernel launches) and plain-version calls.
LAUNCHES = {"fused": 0}
PLAIN_CALLS = {"fused": 0}

#: (id(stack), stack._version, N) -> (stack, its tables), the last few
#: stacks' (the entry holds the stack, so its id is not reused meanwhile).
_TABLES: dict = {}
_TABLES_KEPT = 4


def make_fused_stack(mod: Modulus, R: int = R_FUSED, device=None) -> torch.Tensor:
    """The (10R, R) int8 u7 stack: 7-bit plane k of M[p, j] = R64 *
    omega^(bitrev(p) * j) at rows [kR, (k+1)R).  ``device`` None is the
    CUDA card.  The same planes as ``make_mxu_tables(mod, R, inverse=False,
    scheme="u7")``."""
    return ntt_mxu.make_mxu_tables(mod, R, inverse=False, scheme="u7", device=device).planes


def _direction(stack: torch.Tensor, mod: Modulus) -> ntt_mxu.MxuDirection:
    R = stack.shape[-1]
    if stack.dtype != torch.int8 or tuple(stack.shape) != (ntt_mxu.NL * R, R):
        raise ValueError(f"expected a (10R, R) int8 stack, got {stack.dtype} {tuple(stack.shape)}")
    N = mod.modulus
    key = (id(stack), stack._version, N)
    if key not in _TABLES:
        if len(_TABLES) >= _TABLES_KEPT:
            del _TABLES[next(iter(_TABLES))]
        _TABLES[key] = (stack, ntt_mxu.MxuDirection(
            R, False, stack.contiguous(), None, N, pow(2, 128, N), pow(N, -1, 1 << 64), "u7"
        ))
    return _TABLES[key][1]


def _as3(x: torch.Tensor, R: int) -> torch.Tensor:
    if x.dim() != 2 or x.shape[0] != R:
        raise ValueError(f"expected (R, B) = ({R}, B) data, got {tuple(x.shape)}")
    return x.reshape(1, R, x.shape[1]).contiguous()


def mxu_fused_ntt(x: torch.Tensor, stack: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """Forward length-R NTT of each column of (R, B) int64 data in [0, N),
    bit-reversed order, canonical: K11's function."""
    t = _direction(stack, mod)
    x3 = _as3(x, t.m)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    if x.is_cuda:
        with span("sventt.launch.fused"):
            out = ntt_mxu._launch_kernel(x3, t, fc, None, "lead")
        LAUNCHES["fused"] += 1
    elif x.device.type == "cpu":
        PLAIN_CALLS["fused"] += 1
        out = ntt_mxu._mxu_plain(x3, t, fc, None)
    else:
        raise ValueError(f"K11 runs on cpu or cuda tensors, got {x.device}")
    return out.reshape(x.shape)


def mxu_fused_plain(x: torch.Tensor, stack: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """The plain version of ``mxu_fused_ntt`` on a tensor on any device;
    counts nothing.  The reference K11 is held against on the card."""
    t = _direction(stack, mod)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    return ntt_mxu._mxu_plain(_as3(x, t.m), t, fc, None).reshape(x.shape)


def reset_counts() -> None:
    """Set the launch and plain-call counts to zero (``ntt_mxu``'s own
    ``reset_counts`` sets its ``KERNEL_LAUNCHES``)."""
    LAUNCHES["fused"] = 0
    PLAIN_CALLS["fused"] = 0

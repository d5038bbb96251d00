"""NTT-based convolution: the forward/pointwise/inverse composition.

The counterpart of ``sventt_tpu/apps/convolve.py``: forward NTT both
operands, convert one spectrum to the Montgomery domain, multiply
pointwise, inverse NTT.  The forward output is bit-reversed and the inverse
consumes exactly that order, so the pointwise product needs no reordering.
The pointwise step is ``ops.pointwise.mont_product``: one kernel launch
(``csrc/pointwise.cu``) on card tensors, plain torch ops on CPU ones.
Duck-typed over ``plan.NTT`` (one tensor) and ``parallel.DistributedNTT``
(a list of shards, the pointwise steps run shard by shard, each on its
shard's device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.limb import from_numpy, to_numpy
from ..ops.pointwise import mont_product
from ..plan import NTT, NttConfig
from ..utils.profiling import span


def _next_pow2(x: int) -> int:
    return 1 << max(1, (x - 1).bit_length())


def make_convolver(modulus: int, generator: int, n: int, *, device=None, **cfg_kw) -> NTT:
    """An NTT sized for length-n cyclic convolutions (``device`` None: the
    CUDA card)."""
    return NTT(NttConfig(modulus, generator, n, **cfg_kw), device=device)


def cyclic_convolve(ntt, a, b):
    """Length-n cyclic convolution of two vectors in the plain domain: int64
    tensors on the NTT's device, or shard lists of a DistributedNTT; on an
    NTT of L limbs, (L, n) tensors multiplied limb by limb, each step one
    launch for all limbs.  Spans
    ``sventt.convolve`` around the product, ``sventt.convolve.pointwise``
    around its pointwise step (every shard's)."""
    with span("sventt.convolve"):
        # an NTT of several limbs has no one modulus: each limb's R^2 is its own
        fc, r2 = ntt.fc, None if ntt.mod is None else ntt.mod.montgomery_r2
        fa = ntt.compute_forward(a)
        fb = ntt.compute_forward(b)
        with span("sventt.convolve.pointwise"):
            if isinstance(fa, torch.Tensor):
                prod = mont_product(fc, fa, fb, r2)
            else:
                prod = [mont_product(fc, x, y, r2) for x, y in zip(fa, fb)]
        return ntt.compute_inverse(prod)


def poly_multiply(
    a: np.ndarray,
    b: np.ndarray,
    modulus: int,
    generator: int,
    *,
    out_len: int | None = None,
    ntt=None,
    device=None,
) -> np.ndarray:
    """Linear convolution (polynomial product) of coefficient arrays mod N.

    Zero-pads to the next power of two >= the full product length, runs
    the cyclic pipeline on ``ntt`` (default: a new NTT on ``device``),
    returns canonical uint64 coefficients (truncated to ``out_len``)."""
    la, lb = len(a), len(b)
    full = la + lb - 1
    n = _next_pow2(full)
    if ntt is not None:
        if ntt.get_m() < full:
            raise ValueError("provided NTT is too short for the product")
        n = ntt.get_m()
    else:
        ntt = make_convolver(modulus, generator, n, device=device)
    pa = np.zeros(n, dtype=np.uint64)
    pb = np.zeros(n, dtype=np.uint64)
    pa[:la] = a
    pb[:lb] = b
    if hasattr(ntt, "shard"):
        out = ntt.gather(cyclic_convolve(ntt, ntt.shard(pa), ntt.shard(pb)))
    else:
        out = cyclic_convolve(ntt, from_numpy(pa, ntt.device), from_numpy(pb, ntt.device))
    res = to_numpy(ntt.fc.normalize(out))[:full]
    return res[:out_len] if out_len is not None else res

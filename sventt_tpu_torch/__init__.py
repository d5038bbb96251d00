"""sventt_tpu_torch: the PyTorch + CUDA port of sventt_tpu.

Field elements are int64 tensors holding u64 bit patterns.  The matrix
engine ("mxu", plane schemes s8, u7 and s8b; K11, its fused u7 prototype,
in ``experimental``), the butterfly engine ("pallas", radix-2 or radix-2^R
grouped), the blocked transpose and the ring all-to-all of the
multi-device six-step (``parallel``) run their hand-written CUDA kernels
(``csrc/``, built with nvcc at first use) on CUDA tensors and their plain
PyTorch versions on CPU tensors; entry points run on the CUDA card unless
given ``device="cpu"``.
The portable engine ("jnp", plain torch ops) runs anywhere; the
magic-series applications are in ``apps``.

The top-level exports are the JAX package's, less ``U64``: the JAX package
carries a u64 as a pair of uint32 limb arrays, the port as one int64
tensor of its bit pattern (``field.limb.from_numpy`` / ``to_numpy``), so
there is no pair type to export.
This package imports no JAX; ``sventt_tpu`` stays the reference it is
tested against.
"""

from .field.golden import GoldenNTT
from .field.limb import FieldConsts
from .field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from .plan import NTT, NttConfig

__all__ = [
    "FieldConsts",
    "FLAGSHIP_GENERATOR",
    "FLAGSHIP_MODULUS",
    "GOLDILOCKS_MODULUS",
    "GoldenNTT",
    "NTT",
    "TEST_GENERATOR",
    "TEST_MODULUS",
    "Modulus",
    "NttConfig",
]

"""sventt_tpu_torch: the PyTorch + CUDA port of sventt_tpu.

Field elements are int64 tensors holding u64 bit patterns.  The matrix
engine ("mxu", plane schemes s8, u7 and s8b; K11, its fused u7 prototype,
in ``experimental``), the butterfly engine ("pallas", radix-2 or radix-2^R
grouped), the blocked transpose and the ring all-to-all of the
multi-device six-step (``parallel``) run their hand-written CUDA kernels
(``csrc/``, built with nvcc at first use) on CUDA tensors and their plain
PyTorch versions on CPU tensors; entry points run on the CUDA card unless
given ``device="cpu"``.
This package imports no JAX; ``sventt_tpu`` stays the reference it is
tested against.
"""

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
    "FLAGSHIP_GENERATOR",
    "FLAGSHIP_MODULUS",
    "GOLDILOCKS_MODULUS",
    "NTT",
    "TEST_GENERATOR",
    "TEST_MODULUS",
    "Modulus",
    "NttConfig",
]

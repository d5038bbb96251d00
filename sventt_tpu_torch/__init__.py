"""sventt_tpu_torch: the PyTorch + CUDA port of sventt_tpu.

Field elements are int64 tensors holding u64 bit patterns.  The matrix NTT
engine runs its hand-written CUDA kernel (``csrc/``, built with nvcc at
first use) on CUDA tensors and its plain PyTorch version on CPU tensors.
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

"""Prime-field layer of the PyTorch port: host constants, golden model and
the u64 arithmetic on int64 tensors."""

from .golden import GoldenNTT, bitreverse, bitreverse_permutation, naive_dft
from .limb import FieldConsts, from_limbs, from_numpy, to_limbs, to_numpy
from .modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
    find_generator,
    find_ntt_prime,
)

__all__ = [
    "FLAGSHIP_GENERATOR",
    "FLAGSHIP_MODULUS",
    "GOLDILOCKS_MODULUS",
    "TEST_GENERATOR",
    "TEST_MODULUS",
    "FieldConsts",
    "GoldenNTT",
    "Modulus",
    "bitreverse",
    "bitreverse_permutation",
    "find_generator",
    "find_ntt_prime",
    "from_limbs",
    "from_numpy",
    "naive_dft",
    "to_limbs",
    "to_numpy",
]

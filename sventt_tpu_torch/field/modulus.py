"""Host-side prime-field arithmetic over Z/NZ for 60-64-bit prime moduli.

A copy of ``sventt_tpu/field/modulus.py``: importing that module pulls in
JAX through its package, and the PyTorch port imports no JAX.

TPU-native re-design of the reference's compile-time ``Modulus<N, g>``
(reference: include/sventt/modulus.hpp:14-133).  The reference computes all
field constants with ``constexpr`` C++ over ``unsigned __int128``; here the
same role is played by plain Python integers at *plan time* (before tracing),
so every constant the device kernels consume is baked in as a static array or
literal, mirroring the reference's "everything static at compile time"
philosophy (SURVEY.md section 6, config system).

All functions operate on Python ints and are exact.  Nothing in this module
touches JAX.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1

#: The flagship 64-bit modulus ``2^64 - 1827*2^31 + 1`` with generator 3
#: (reference README.md:18-19); ``N - 1`` is divisible by ``2^31`` so it
#: supports power-of-two transforms up to ``2^31`` points.
FLAGSHIP_MODULUS = 0xFFFF_FC6E_8000_0001
FLAGSHIP_GENERATOR = 3

#: 62-bit test modulus used by the reference's kernel test matrix
#: (reference tests/ntt-tests/*.hpp); 2-adicity 57.
TEST_MODULUS = 0x3A00_0000_0000_0001
TEST_GENERATOR = 3

#: Goldilocks prime, used in the reference's example test matrix
#: (reference examples/magic-series/test-magic-series.cpp:22-39).
GOLDILOCKS_MODULUS = 0xFFFF_FFFF_0000_0001


def is_probable_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@dataclass(frozen=True)
class Modulus:
    """Prime-field constant bundle for modulus ``N`` and generator ``g``.

    Equivalent surface to reference include/sventt/modulus.hpp:14-133:
    ``reduce/negate/add/subtract/multiply/divide/power/invert``,
    ``get_root_forward/get_root_inverse`` (primitive roots of a given order),
    ``montgomery_inverse`` (= N^-1 mod 2^64, reference :36-68) and
    ``shoup_inverse`` (= floor(2^128 / N), reference :25-34).
    """

    modulus: int
    generator: int = 0

    def __post_init__(self):
        if not (2 < self.modulus < (1 << 64)):
            raise ValueError("modulus must be a 64-bit integer > 2")

    # -- basic field ops (exact, host-side) --------------------------------
    def reduce(self, a: int) -> int:
        return a % self.modulus

    def negate(self, a: int) -> int:
        return (-a) % self.modulus

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def subtract(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def multiply(self, a: int, b: int) -> int:
        return a * b % self.modulus

    def power(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def invert(self, a: int) -> int:
        # Fermat's little theorem, like reference modulus.hpp:111-113.
        return pow(a, self.modulus - 2, self.modulus)

    def divide(self, a: int, b: int) -> int:
        return self.multiply(a, self.invert(b))

    # -- roots of unity -----------------------------------------------------
    def get_root_forward(self, order: int) -> int:
        """g^((N-1)/order): primitive ``order``-th root of unity.

        Raises if ``order`` does not divide ``N - 1``
        (reference modulus.hpp:115-122 throws the same way).
        """
        if self.generator == 0:
            raise ValueError("modulus has no generator configured")
        if (self.modulus - 1) % order != 0:
            raise ValueError("the field has no such root")
        return pow(self.generator, (self.modulus - 1) // order, self.modulus)

    def get_root_inverse(self, order: int) -> int:
        """Inverse primitive ``order``-th root (reference modulus.hpp:124-132)."""
        return self.invert(self.get_root_forward(order))

    # -- precomputed engine constants ---------------------------------------
    @functools.cached_property
    def montgomery_inverse(self) -> int:
        """N^-1 mod 2^64 (reference modulus.hpp:36-68 computes this via a
        Newton/Goldschmidt ladder; Python just inverts exactly)."""
        return pow(self.modulus, -1, 1 << 64)

    @functools.cached_property
    def neg_montgomery_inverse(self) -> int:
        """-N^-1 mod 2^64, the constant used by the limb-level Montgomery
        reduction in the device kernels."""
        return (-self.montgomery_inverse) % (1 << 64)

    @functools.cached_property
    def shoup_inverse(self) -> int:
        """floor(2^128 / N), split hi/lo by callers (reference modulus.hpp:25-34)."""
        if self.modulus & (self.modulus - 1) == 0:
            return 1 << (128 - (self.modulus.bit_length() - 1))
        return ((1 << 128) - 1) // self.modulus

    @functools.cached_property
    def montgomery_r(self) -> int:
        """R = 2^64 mod N: the Montgomery domain factor."""
        return (1 << 64) % self.modulus

    @functools.cached_property
    def montgomery_r2(self) -> int:
        """R^2 mod N: multiply by this (Montgomery-multiplied) to enter the
        Montgomery domain."""
        return self.montgomery_r * self.montgomery_r % self.modulus

    @property
    def bit_width(self) -> int:
        return self.modulus.bit_length()

    @property
    def two_adicity(self) -> int:
        """Largest t with 2^t | N-1: the max power-of-two transform length."""
        return ((self.modulus - 1) & -(self.modulus - 1)).bit_length() - 1

    # -- Montgomery-domain helpers (host-side, exact) ------------------------
    def to_montgomery(self, b: int) -> int:
        """b * 2^64 mod N (reference modmul/scalar/p-adic-64.hpp:16-19)."""
        return b * self.montgomery_r % self.modulus

    def from_montgomery(self, b: int) -> int:
        """b * 2^-64 mod N (reference modmul/scalar/p-adic-64.hpp:21-24)."""
        return b * self.invert(self.montgomery_r) % self.modulus

    def montgomery_precompute(self, b: int) -> int:
        """b * N^-1 mod 2^64 -- the companion operand ``bp`` stored next to
        every twiddle (reference modmul/scalar/p-adic-64.hpp:26-29)."""
        return b * self.montgomery_inverse & MASK64

    def montgomery_multiply(
        self, a: int, b: int, bp: int | None = None, lazy: bool | None = None
    ) -> int:
        """Bit-exact model of the device Montgomery multiply.

        ``lazy`` (default: the FieldConsts gate, bit_width(N) <= 62) selects
        the representative exactly as the device engine does: the lazy path
        returns ``hi64(a*b) - hi64(lo64(a*bp)*N) + N`` in (0, 2N) -- the
        lazy/redundant range (reference modmul/scalar/p-adic-64.hpp:35-45,
        sve/p-adic-64.hpp:88-89); the canonical path applies +N only on
        borrow, the min-trick's [0, N) result (reference
        modmul/sve/p-adic-64.hpp:90-92, 101-115).  Computed mod 2^64 exactly
        as the hardware does so tests can check the *representative*, not
        just the residue.
        """
        if bp is None:
            bp = self.montgomery_precompute(b)
        if lazy is None:
            # must match FieldConsts.from_modulus: 63-bit moduli run the
            # canonical device path (4N < 2^64 fails), not the lazy one
            lazy = self.bit_width <= 62
        q = a * bp & MASK64
        ab1 = a * b >> 64
        qn1 = q * self.modulus >> 64
        if lazy:
            return (ab1 - qn1 + self.modulus) & MASK64
        c = (ab1 - qn1) & MASK64
        if ab1 < qn1:
            c = (c + self.modulus) & MASK64
        return c

    def shoup_precompute(self, b: int) -> int:
        """floor(b * 2^64 / N), the Shoup companion of a constant b in [0, N)
        (reference modmul/scalar/fixed-point-64.hpp:24-40 computes the same
        quantity from the stored floor(2^128/N) with a +1 correction; host
        Python just takes the exact floor)."""
        if not 0 <= b < self.modulus:
            raise ValueError("shoup operand must be canonical in [0, N)")
        return (b << 64) // self.modulus

    def shoup_multiply(self, a: int, b: int, bp: int | None = None) -> int:
        """a*b - hi64(a*bp)*N, in [0, 2N) for any a < 2^64, b in [0, N).

        Requires bit_width(N) <= 63 so [0, 2N) fits in 64 bits
        (reference modmul/scalar/fixed-point-64.hpp:48-55).
        """
        if self.bit_width > 63:
            raise ValueError("Shoup multiply requires bit_width(N) <= 63")
        if bp is None:
            bp = self.shoup_precompute(b)
        hi = a * bp >> 64
        return (a * b - hi * self.modulus) & MASK64


def find_generator(modulus: int) -> int:
    """Find the smallest primitive root of a prime modulus.

    TPU-native analogue of the reference's sympy parameter generator
    (reference examples/magic-series-kinnaes/generate-parameters.py), using
    pure Python (no sympy dependency).
    """
    if not is_probable_prime(modulus):
        raise ValueError("modulus must be prime")
    phi = modulus - 1
    # factor phi (64-bit => Pollard rho is fast enough)
    factors = _factorize(phi)
    for g in range(2, modulus):
        if all(pow(g, phi // p, modulus) != 1 for p in factors):
            return g
    raise ValueError("no generator found")


@functools.lru_cache(maxsize=None)
def is_generator(modulus: int, g: int) -> bool:
    """Whether ``g`` generates the multiplicative group of the prime field
    Z/modulus: g^((N-1)/p) != 1 for every prime p dividing N - 1."""
    phi = modulus - 1
    return g % modulus != 0 and all(pow(g, phi // p, modulus) != 1 for p in _factorize(phi))


def find_ntt_prime(bits: int, two_adicity: int, *, start: int | None = None) -> tuple[int, int]:
    """Find a prime N < 2^bits with 2^two_adicity | N-1, and its generator.

    Mirrors the role of reference generate-parameters.py (parameter search for
    the Kinnaes test matrix).
    """
    step = 1 << two_adicity
    hi = (1 << bits) - 1
    n = (start if start is not None else hi) // step * step + 1
    while n > step:
        if n <= hi and is_probable_prime(n):
            return n, find_generator(n)
        n -= step
    raise ValueError("no suitable prime found")


def _factorize(n: int) -> set[int]:
    """Prime factors of n (trial division + Pollard rho)."""
    import math
    import random

    factors: set[int] = set()

    def rho(n: int) -> int:
        if n % 2 == 0:
            return 2
        while True:
            x = random.randrange(2, n)
            y, c, d = x, random.randrange(1, n), 1
            while d == 1:
                x = (x * x + c) % n
                y = (y * y + c) % n
                y = (y * y + c) % n
                d = math.gcd(abs(x - y), n)
            if d != n:
                return d

    def rec(n: int):
        if n == 1:
            return
        if is_probable_prime(n):
            factors.add(n)
            return
        for p in (2, 3, 5, 7, 11, 13):
            if n % p == 0:
                factors.add(p)
                while n % p == 0:
                    n //= p
                rec(n)
                return
        d = rho(n)
        rec(d)
        rec(n // d)

    rec(n)
    return factors

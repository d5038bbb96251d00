"""Golden-model NTT: the bit-exactness anchor for every device kernel.

A copy of ``sventt_tpu/field/golden.py``, for the same reason as
``modulus.py`` beside it.

Independent naive implementation replicating the numerical contract of the
reference's ``NTTReference`` (reference tests/ntt-reference.hpp:11-84):

* ``forward`` is a decimation-in-frequency (Gentleman-Sande) radix-2 NTT
  WITHOUT a final bit-reversal pass, so the output is in **bit-reversed
  order**: ``forward(x)[p] == DFT(x)[bitreverse(p)]``
  (reference tests/ntt-reference.hpp:43-61).
* ``inverse`` consumes that bit-reversed order (decimation-in-time) and
  returns natural order, pre-scaled by ``m^-1``
  (reference tests/ntt-reference.hpp:63-83).
* All values are canonical, in ``[0, N)``.

Implemented with exact Python integers (the analogue of the reference's
``unsigned __int128`` arithmetic).  A faster C++ path is provided by
``sventt_tpu.runtime`` when the native extension is built; this module is the
always-available fallback and the primary test oracle.
"""

from __future__ import annotations

from .modulus import Modulus


def bitreverse(x: int, bits: int) -> int:
    """Reverse the low ``bits`` bits of ``x``.

    Semantics of reference include/sventt/utility.hpp:12-23 restricted to a
    given width (the reference reverses all 64 bits then shifts; callers there
    always combine it with ``>> (65 - bit_width(m))`` which equals this).
    """
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def bitreverse_permutation(m: int) -> list[int]:
    """Permutation p with p[i] = bitreverse(i, log2 m)."""
    log2m = m.bit_length() - 1
    if 1 << log2m != m:
        raise ValueError("m must be a power of two")
    perm = [0] * m
    for i in range(1, m):
        perm[i] = (perm[i >> 1] >> 1) | ((i & 1) << (log2m - 1))
    return perm


def naive_dft(src: list[int], mod: Modulus, omega: int | None = None) -> list[int]:
    """O(m^2) DFT straight from the definition: X[k] = sum_j x[j] w^(jk).

    Used to validate the golden model itself (the role of reference
    tests/test-ntt-reference.cpp:45-80).  Natural order output.
    """
    m = len(src)
    N = mod.modulus
    w = mod.get_root_forward(m) if omega is None else omega
    out = []
    wk = 1
    for _ in range(m):
        acc, wkj = 0, 1
        for x in src:
            acc = (acc + x * wkj) % N
            wkj = wkj * wk % N
        out.append(acc)
        wk = wk * w % N
    return out


class GoldenNTT:
    """Exact-reference NTT over Python ints (reference tests/ntt-reference.hpp)."""

    def __init__(self, m: int, mod: Modulus):
        if m & (m - 1):
            raise ValueError("Transform length must be a power of two for now")
        self.m = m
        self.log2m = m.bit_length() - 1
        self.mod = mod
        self.N = mod.modulus
        self.omega_m = mod.get_root_forward(m)
        self.omegainv_m = mod.invert(self.omega_m)
        self.minv = mod.invert(m)

    def forward(self, src: list[int]) -> list[int]:
        """DIF forward; output bit-reversed order, canonical [0, N)."""
        N, m = self.N, self.m
        dst = [x % N for x in src]
        omega_2l = self.omega_m
        for i in range(self.log2m - 1, -1, -1):
            l = 1 << i
            omega_2l_j = 1
            for j in range(l):
                for k in range(j, m, l * 2):
                    x0, x1 = dst[k], dst[k + l]
                    dst[k] = (x0 + x1) % N
                    dst[k + l] = (x0 - x1) * omega_2l_j % N
                omega_2l_j = omega_2l_j * omega_2l % N
            omega_2l = omega_2l * omega_2l % N
        return dst

    def inverse(self, src: list[int]) -> list[int]:
        """DIT inverse consuming bit-reversed order; natural order out."""
        N, m = self.N, self.m
        dst = [x * self.minv % N for x in src]
        for i in range(self.log2m):
            l = 1 << i
            omegainv_2l = pow(self.omegainv_m, 1 << (self.log2m - i - 1), N)
            omegainv_2l_j = 1
            for j in range(l):
                for k in range(j, m, l * 2):
                    x0 = dst[k]
                    x1 = dst[k + l] * omegainv_2l_j % N
                    dst[k] = (x0 + x1) % N
                    dst[k + l] = (x0 - x1) % N
                omegainv_2l_j = omegainv_2l_j * omegainv_2l % N
        return dst

    def cyclic_convolve(self, a: list[int], b: list[int]) -> list[int]:
        """Length-m cyclic convolution via forward/pointwise/inverse --
        the end-to-end identity the applications rely on
        (reference examples/magic-series/gaussian-polynomial.hpp:148-244)."""
        N = self.N
        fa, fb = self.forward(a), self.forward(b)
        return self.inverse([x * y % N for x, y in zip(fa, fb)])

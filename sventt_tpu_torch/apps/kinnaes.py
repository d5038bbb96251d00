"""Kinnaes closed-form magic-series count: an NTT-free roots-of-unity sum.

The counterpart of ``sventt_tpu/apps/kinnaes.py``.  It evaluates

    M(m) = ( 2 * sum_{j=1}^{n/2} T_j  +  C(m^2, m) ) / n   (mod N)

    T_j = prod_{l=1}^{m} (w^{j(m^2-m+l)} - 1)
          ---------------------------------------   with w a primitive n-th
          w^{j r} * prod_{l=1}^{m} (w^{j l} - 1)    root of unity, r = m^2(m-1)/2

which samples the Gaussian binomial at every n-th root of unity and
averages out every exponent but r: exact when n > r, with the pairing
j <-> n-j folded into the half-range sum.

On the device the n/2 values of j lie along one int64 vector (a lane per
j): w^j per lane by binary powering, an m-step loop of elementwise
Montgomery products, and a log-depth fraction-free reduction of the
terms.  The JAX package runs the same loop as plain jnp, so here it is
plain torch ops on ``device`` (None: the CUDA card), with no kernel of
its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..field.limb import FieldConsts, s64, u64
from ..field.modulus import Modulus, find_generator, is_probable_prime
from ..utils.device import resolve_device


def _small_primes(limit: int):
    sieve = np.ones(limit + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(limit**0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return np.flatnonzero(sieve)


def kinnaes_length(m: int) -> int:
    """Smallest odd n > r = m^2(m-1)/2 whose prime factors all exceed m:
    n > r makes the closed form exact, and no prime factor <= m keeps every
    denominator factor (w^{jl} - 1, l <= m) nonzero for j != 0."""
    r = m * m * (m - 1) // 2
    primes = _small_primes(max(m, 3))
    n = r + 1
    if n % 2 == 0:
        n += 1
    while not all(n % int(p) for p in primes):
        n += 2
    return n


def kinnaes_parameters(m: int, bits: int = 62, skip: int = 0) -> tuple[int, int, int]:
    """(N, generator, n) for the closed form: n = ``kinnaes_length(m)`` and
    N = k*n + 1 the largest prime of that form below 2^bits, or with
    ``skip`` the (skip+1)-th largest (several moduli per width)."""
    n = kinnaes_length(m)
    k = ((1 << bits) - 2) // n
    while k > 0:
        N = k * n + 1
        if is_probable_prime(N):
            if skip == 0:
                return N, find_generator(N), n
            skip -= 1
        k -= 1
    raise ValueError("no prime found")


def kinnaes_magic_series_count_host(m: int, modulus: int, generator: int, n: int) -> int:
    """Exact host evaluation of the closed form with Python ints (the
    tests' oracle)."""
    N = modulus
    w = Modulus(N, generator).get_root_forward(n)
    r = m * m * (m - 1) // 2
    total = 0
    for j in range(1, n // 2 + 1):
        wj = pow(w, j, N)
        num = den = 1
        t_num = pow(wj, m * m - m + 1, N)
        t_den = wj
        for _ in range(m):
            num = num * (t_num - 1) % N
            den = den * (t_den - 1) % N
            t_num = t_num * wj % N
            t_den = t_den * wj % N
        den = den * pow(wj, r, N) % N
        total = (total + num * pow(den, N - 2, N)) % N
    comb = math.comb(m * m, m) % N
    return (2 * total + comb) * pow(n, N - 2, N) % N


# -- device implementation ----------------------------------------------------


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    """The u64 ``value`` as a 0-d int64 tensor on ``like``'s device."""
    return torch.tensor(s64(value), dtype=torch.int64, device=like.device)


def _pow_by_lane_index(
    fc: FieldConsts, mod: Modulus, base: int, jd: torch.Tensor, bits: int
) -> torch.Tensor:
    """base^jd per lane in Montgomery form, by binary powering over the
    ``bits`` low bits of the int64 lane indices ``jd`` (each below 2^31, so
    the arithmetic shift reads them as unsigned): one ``mont_mul_full`` a
    bit, the squared base a host int lifted to Montgomery form."""
    N = mod.modulus
    result = torch.full_like(jd, s64(mod.montgomery_r))
    sq = base % N
    for b in range(bits):
        mult = fc.mont_mul_full(result, _const(mod.to_montgomery(sq), jd))
        result = torch.where(((jd >> b) & 1) != 0, mult, result)
        sq = sq * sq % N
    return result


def _reduce_fractions(fc: FieldConsts, num: torch.Tensor, den: torch.Tensor, mul):
    """Fraction-free log-depth sum of num[i]/den[i]: each level halves the
    vector, (n1, d1) + (n2, d2) -> (n1*d2 + n2*d1, d1*d2), an odd last
    element carried to the next level."""
    n = num.shape[0]
    while n > 1:
        half = n // 2
        n1, d1 = num[:half], den[:half]
        n2, d2 = num[half:2 * half], den[half:2 * half]
        ns = fc.add(mul(n1, d2), mul(n2, d1))
        ds = mul(d1, d2)
        if n % 2:
            ns = torch.cat([ns, num[2 * half:]])
            ds = torch.cat([ds, den[2 * half:]])
            n = half + 1
        else:
            n = half
        num, den = ns, ds
    return num, den


def kinnaes_magic_series_count(
    m: int,
    modulus: int | None = None,
    generator: int | None = None,
    n: int | None = None,
    *,
    device=None,
) -> int:
    """Device evaluation of the Kinnaes closed form; exact when M(m) < N.

    Every lane value stays in the Montgomery domain, so each product is one
    ``mont_mul_full`` and the R factors cancel in the final num/den ratio.
    Without a modulus, ``kinnaes_parameters(m)`` chooses (N, g, n).
    """
    if m == 1:
        return 1  # the lane layout below needs n > 1
    r = m * m * (m - 1) // 2
    if modulus is None:
        modulus, generator, n = kinnaes_parameters(m)
    N = modulus
    mod = Modulus(N, generator)
    if (N - 1) % n:
        raise ValueError("n must divide N - 1")
    if n <= r:
        raise ValueError("need n > r for exactness")
    fc = FieldConsts.from_modulus(mod, lazy=False)
    w = mod.get_root_forward(n)
    bits = (n // 2).bit_length()  # the largest lane index is n // 2
    mul = fc.mont_mul_full  # Montgomery-domain product (aR * bR -> abR)

    jd = torch.arange(1, n // 2 + 1, dtype=torch.int64, device=resolve_device(device))
    wj = _pow_by_lane_index(fc, mod, w, jd, bits)  # w^j, Montgomery form
    t_num = _pow_by_lane_index(fc, mod, pow(w, m * m - m + 1, N), jd, bits)
    one = torch.full_like(jd, s64(mod.montgomery_r))
    num, den, t_den = one, one, wj
    for _ in range(m):
        num = mul(num, fc.sub(t_num, one))
        den = mul(den, fc.sub(t_den, one))
        t_num = mul(t_num, wj)
        t_den = mul(t_den, wj)
    den = mul(den, _pow_by_lane_index(fc, mod, pow(w, r, N), jd, bits))
    s_num, s_den = _reduce_fractions(fc, num, den, mul)

    # both sides carry the same power of R (the same number of Montgomery
    # products level for level), so the ratio is exact mod N
    s_num, s_den = u64(int(s_num[0])), u64(int(s_den[0]))
    s_int = s_num * pow(s_den, N - 2, N) % N
    comb = math.comb(m * m, m) % N
    return (2 * s_int + comb) * pow(n, N - 2, N) % N

"""q-series generators and the magic-series count by NTT convolution.

The counterpart of ``sventt_tpu/apps/series.py``:

* ``q_pochhammer_coeffs`` -- coefficients of (q;q)_k;
* ``restricted_partition_series`` -- the power series of 1/(q;q)_k, whose
  n-th coefficient is p(n | parts <= k);
* ``gaussian_binomial_coefficient`` -- [q^r] qbinom(n, k) as numerator x
  1/(q;q)_k, the product by NTT convolution on the card: one padded
  transform, or (``chunk``) a block convolution reusing one fixed-size NTT;
* ``magic_series_count`` -- M(m) = [q^(m^2(m-1)/2)] qbinom(m^2, m), the
  end-to-end proof that forward, pointwise product and inverse compose.

The series come from the native C++ generators (``native``:
``native_src/series.cc``); ``use_native=False`` runs the numpy models
instead, which are the tests' oracle.  Where the JAX package falls back to
numpy when its native library cannot be built, the port raises.  The
convolutions run on ``device`` (None: the CUDA card; ``"cpu"`` runs every
kernel's plain version).  Every coefficient vector is canonical uint64
residues mod N.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS
from .convolve import make_convolver, poly_multiply


def _mod_add_u64(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """(a + b) mod N elementwise for residues < N <= 2^64, in uint64: a sum
    that wrapped (s < a) or reached N takes one wrapping subtract of N."""
    N = np.uint64(modulus)
    s = a + b
    return np.where((s < a) | (s >= N), s - N, s)


def _mod_sub_u64(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """(a - b) mod N elementwise for residues < N <= 2^64, in uint64."""
    N = np.uint64(modulus)
    s = a - b
    return np.where(a < b, s + N, s)


def q_pochhammer_coeffs(
    k: int, degree: int, modulus: int, *, use_native: bool = True
) -> np.ndarray:
    """Coefficients [0..degree] of (q;q)_k = prod_{i=1}^{k} (1 - q^i) mod N,
    by iterated multiplication by (1 - q^i), truncated at ``degree``."""
    if use_native:
        return native.qpochhammer(k, degree, modulus)
    coeff = np.zeros(degree + 1, dtype=np.uint64)
    coeff[0] = 1
    for i in range(1, min(k, degree) + 1):
        coeff[i:] = _mod_sub_u64(coeff[i:], coeff[: degree + 1 - i], modulus)
    return coeff


def restricted_partition_series(
    k: int, degree: int, modulus: int, *, use_native: bool = True
) -> np.ndarray:
    """Coefficients [0..degree] of 1/(q;q)_k mod N (p(n | parts <= k)).

    Native: the streaming generator with O(k^2) rolling state.  numpy:
    each factor 1/(1 - q^i) as the telescoping product of (1 + q^(i*2^t))
    mod q^(degree+1), k*log2(degree) shifted adds.
    """
    if use_native:
        with native.restricted_partition_stream(k, modulus) as stream:
            return stream.next(degree + 1)
    c = np.zeros(degree + 1, dtype=np.uint64)
    c[0] = 1
    for i in range(1, k + 1):
        t = i
        while t <= degree:
            c[t:] = _mod_add_u64(c[t:], c[: degree + 1 - t], modulus)
            t *= 2
    return c


def _qbinom_numerator(
    n: int, k: int, degree: int, modulus: int, *, use_native: bool = True
) -> np.ndarray:
    """Coefficients [0..degree] of prod_{i=n-k+1}^{n} (1 - q^i) mod N: from
    its k+1 Rothe segments (native, k <= n), else the truncated product."""
    if use_native and k <= n:
        return native.gauss_numerator_range(0, degree + 1, n, k, modulus)
    coeff = np.zeros(degree + 1, dtype=np.uint64)
    coeff[0] = 1
    for i in range(n - k + 1, n + 1):
        if i > degree:
            continue
        coeff[i:] = _mod_sub_u64(coeff[i:], coeff[: degree + 1 - i], modulus)
    return coeff


def gaussian_binomial_coefficient(
    n: int,
    k: int,
    r: int,
    modulus: int = FLAGSHIP_MODULUS,
    generator: int = FLAGSHIP_GENERATOR,
    *,
    ntt=None,
    chunk: int | None = None,
    device=None,
) -> int:
    """[q^r] of the Gaussian binomial qbinom(n, k) mod N.

    qbinom(n, k) = numerator / (q;q)_k as power series: the division is a
    product with the restricted-partition series, by NTT convolution on
    ``ntt`` (default: a new one on ``device``).  ``chunk`` runs the block
    convolution: numerator blocks of ``chunk`` coefficients, streamed from
    the Rothe segments (k <= n), each against the window of the series
    that reaches coefficient r, on one NTT of 2^ceil(log2(2*chunk - 1))
    points.
    """
    inv = restricted_partition_series(k, r, modulus)
    if chunk is None:
        num = _qbinom_numerator(n, k, r, modulus)
        prod = poly_multiply(num, inv, modulus, generator, out_len=r + 1, ntt=ntt, device=device)
        return int(prod[r])
    if k <= n:

        def num_block(start: int) -> np.ndarray:
            return native.gauss_numerator_range(start, min(chunk, r + 1 - start), n, k, modulus)

    else:
        num = _qbinom_numerator(n, k, r, modulus)

        def num_block(start: int) -> np.ndarray:
            return num[start : start + chunk]

    if ntt is None:
        size = 1 << max(2, (2 * chunk - 1).bit_length())
        ntt = make_convolver(modulus, generator, size, device=device)
    acc = 0
    for start in range(0, r + 1, chunk):
        num_blk = num_block(start)
        if not num_blk.any():
            continue
        # the window of the series that reaches coefficient r via this block
        w_hi = r - start
        w_lo = max(0, r - (start + len(num_blk) - 1))
        prod = poly_multiply(num_blk, inv[w_lo : w_hi + 1], modulus, generator, ntt=ntt)
        idx = r - start - w_lo
        if 0 <= idx < len(prod):
            acc = (acc + int(prod[idx])) % modulus
    return acc


def magic_series_count(
    m: int,
    modulus: int = FLAGSHIP_MODULUS,
    generator: int = FLAGSHIP_GENERATOR,
    **kw,
) -> int:
    """Number of magic series of order m, mod N: M(m) = [q^(m^2(m-1)/2)]
    qbinom(m^2, m), exact as an integer whenever M(m) < N.  ``kw``: ``ntt``,
    ``chunk`` and ``device`` of ``gaussian_binomial_coefficient``."""
    if m == 1:
        return 1
    r = m * m * (m - 1) // 2
    return gaussian_binomial_coefficient(m * m, m, r, modulus, generator, **kw)


def magic_series_count_exact(m: int) -> int:
    """Exact M(m) by integer dynamic programming over the defining
    generating function prod_{i=1}^{m^2} (1 + z q^i) at z^m,
    q^(m(m^2+1)/2): no code shared with the NTT pipeline.  Feasible for
    small m (m <= 12 in seconds)."""
    target = m * (m * m + 1) // 2
    # dp[j][s] = number of j-subsets of {1..i} with sum s
    dp = [[0] * (target + 1) for _ in range(m + 1)]
    dp[0][0] = 1
    for i in range(1, m * m + 1):
        for j in range(min(m, i), 0, -1):
            row, prev = dp[j], dp[j - 1]
            for s in range(target, i - 1, -1):
                if prev[s - i]:
                    row[s] += prev[s - i]
    return dp[m][target]

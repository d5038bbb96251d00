"""Reference-scale magic-series check: M(100) and M(101), exactly.

Derives the exact counts two independent ways with this package:

1. the NTT convolution pipeline (``apps.series``) for M(m) mod K
   independently generated 62-bit NTT primes;
2. CRT reconstruction of the exact integer (K chosen so that the product
   of the moduli exceeds the count's bit bound);
3. a check of the reconstruction against held-out pipeline moduli it was
   not built from;
4. the device Kinnaes closed form (``apps.kinnaes``) against the
   reconstructed integer over a matrix of (N, g, n): widths 64 to 61, two
   primes each.

    python -m sventt_tpu_torch.examples.magic_series_reference_scale [m ...] [--device cpu]

(default m: 100 101; each pipeline run is a 2^20-point convolution, about
a second of host generators and device work on the card, minutes on the
CPU).
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from sventt_tpu_torch.apps.kinnaes import kinnaes_magic_series_count, kinnaes_parameters
from sventt_tpu_torch.apps.series import magic_series_count
from sventt_tpu_torch.field.modulus import find_ntt_prime


def crt_pair(r1: int, n1: int, r2: int, n2: int) -> tuple[int, int]:
    """Combine x = r1 (mod n1) and x = r2 (mod n2) for coprime moduli."""
    inv = pow(n1, -1, n2)
    x = r1 + n1 * ((r2 - r1) * inv % n2)
    return x % (n1 * n2), n1 * n2


def exact_magic_series(m: int, device=None, margin_bits: int = 80, holdout: int = 2) -> int:
    """Exact M(m) by CRT over independently generated NTT primes."""
    r = m * m * (m - 1) // 2
    two_adicity = (2 * r).bit_length()  # the linear convolution's length
    # M(m) < C(m^2, m) < (e*m)^m
    bound_bits = int(m * math.log2(math.e * m)) + margin_bits
    primes: list[tuple[int, int]] = []
    start = 1 << 62
    while sum(p.bit_length() for p, _ in primes) < bound_bits + 64 * holdout:
        N, g = find_ntt_prime(62, two_adicity, start=start)
        primes.append((N, g))
        start = N - 2  # the next search strictly below this prime
    residues = []
    for i, (N, g) in enumerate(primes):
        t0 = time.perf_counter()
        residues.append(magic_series_count(m, N, g, device=device))
        print(f"  pipeline M({m}) mod prime {i + 1}/{len(primes)} "
              f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    # reconstruct from all but the hold-outs, then check the hold-outs
    x, mod = residues[0] % primes[0][0], primes[0][0]
    for (N, _), res in list(zip(primes, residues))[1 : len(primes) - holdout]:
        x, mod = crt_pair(x, mod, res, N)
    if mod.bit_length() <= bound_bits:
        raise RuntimeError("CRT modulus product too small for the M(m) bit bound")
    for (N, _), res in list(zip(primes, residues))[len(primes) - holdout :]:
        if x % N != res:
            raise RuntimeError(f"hold-out modulus {N:#x} disagrees")
    return x


def kinnaes_matrix(m: int, exact: int, device=None, widths=(64, 63, 62, 61), per_width=2):
    """The device Kinnaes closed form over a matrix of (N, g, n) against
    the exact count."""
    for bits in widths:
        for skip in range(per_width):
            N, g, n = kinnaes_parameters(m, bits=bits, skip=skip)
            t0 = time.perf_counter()
            got = kinnaes_magic_series_count(m, N, g, n, device=device)
            ok = got == exact % N
            print(f"  kinnaes m={m} N={N:#x} g={g} n={n}: "
                  f"{'OK' if ok else 'MISMATCH'} ({time.perf_counter() - t0:.1f}s)")
            if not ok:
                raise RuntimeError(f"Kinnaes mismatch: m={m} N={N:#x}: {got} != {exact % N}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="*", default=[100, 101])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    for m in args.m:
        t0 = time.perf_counter()
        exact = exact_magic_series(m, args.device)
        print(f"M({m}) = {exact}")
        print(f"  ({len(str(exact))} digits, reconstructed and checked in "
              f"{time.perf_counter() - t0:.1f}s)", file=sys.stderr)
        kinnaes_matrix(m, exact, args.device)


if __name__ == "__main__":
    main()

"""Cross-check: the magic series of order m two independent ways under ONE
prime, so the two counts must be equal.

The modulus satisfies both algorithms at once: 2-adicity for the NTT
convolution pipeline (a 2^ceil(log2(2r+1))-point transform, r =
m^2(m-1)/2) and an odd n | N - 1, n > r, with every prime factor above m,
for the Kinnaes roots-of-unity sum.  At m = 30 (N = 0x3ffffffea6928001)
both give M(30) mod N = 2818567648502317936.  The Kinnaes side is the
exact host closed form in Python ints, which takes minutes at m = 30.

    python -m sventt_tpu_torch.examples.magic_series_crosscheck [m] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from sventt_tpu_torch.apps.kinnaes import kinnaes_length, kinnaes_magic_series_count_host
from sventt_tpu_torch.apps.series import magic_series_count
from sventt_tpu_torch.field.modulus import find_generator, is_probable_prime


def shared_modulus(m: int, bits: int = 62, two_adicity: int | None = None):
    """Prime N with 2^two_adicity | N - 1 and the Kinnaes n | N - 1.
    ``two_adicity`` defaults to what the pipeline needs: the linear
    convolution length 2r + 1 rounded up to a power of two."""
    r = m * m * (m - 1) // 2
    if two_adicity is None:
        two_adicity = (2 * r).bit_length()
    n = kinnaes_length(m)
    step = n << two_adicity
    j = ((1 << bits) - 2) // step
    while j > 0:
        N = j * step + 1
        if is_probable_prime(N):
            return N, find_generator(N), n
        j -= 1
    raise ValueError("no prime found")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=30)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    m = args.m
    N, g, n = shared_modulus(m)
    print(f"m={m}  N={hex(N)}  generator={g}  n={n}")
    t0 = time.time()
    via_ntt = magic_series_count(m, N, g, device=args.device)
    print(f"NTT convolution pipeline: {via_ntt}  ({time.time() - t0:.1f}s)")
    t0 = time.time()
    via_kin = kinnaes_magic_series_count_host(m, N, g, n)
    print(f"Kinnaes closed form:      {via_kin}  ({time.time() - t0:.1f}s)")
    if via_ntt != via_kin:
        raise SystemExit("cross-check FAILED")
    print("cross-check: MATCH")


if __name__ == "__main__":
    main()

"""Magic-series counting demo, two independent ways.

Counts the magic series of order m (sets of m distinct values in [1, m^2]
summing to the magic constant) by the NTT convolution pipeline,
M(m) = [q^(m^2(m-1)/2)] qbinom(m^2, m), and by the Kinnaes closed form over
roots of unity.

    python -m sventt_tpu_torch.examples.magic_series [m] [--device cpu]
"""

from __future__ import annotations

import argparse

from sventt_tpu_torch import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu_torch.apps import (
    kinnaes_magic_series_count,
    kinnaes_parameters,
    magic_series_count,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=10)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    m = args.m
    via_ntt = magic_series_count(m, TEST_MODULUS, TEST_GENERATOR, device=args.device)
    print(f"M({m}) mod {hex(TEST_MODULUS)} via NTT convolution: {via_ntt}")
    N, g, n = kinnaes_parameters(m)
    via_kinnaes = kinnaes_magic_series_count(m, N, g, n, device=args.device)
    print(f"M({m}) mod {hex(N)} via Kinnaes closed form:  {via_kinnaes}")
    # different moduli: the residues agree iff M(m) is below both
    print("cross-check under one prime: sventt_tpu_torch.examples.magic_series_crosscheck")


if __name__ == "__main__":
    main()

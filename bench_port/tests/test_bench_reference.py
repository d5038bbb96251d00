"""The plain reference against the definition, at small n on the CPU."""

import random

import pytest
import torch

from bench_port.reference.ntt import ReferenceNTT, mulhi, s64

FLAGSHIP = 0xFFFF_FC6E_8000_0001
GOLDILOCKS = 0xFFFF_FFFF_0000_0001
FIELDS = [(FLAGSHIP, 3), (GOLDILOCKS, 7), (998244353, 3)]


def bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def naive_dft(x: list[int], w: int, N: int) -> list[int]:
    n = len(x)
    return [sum(v * pow(w, j * k, N) for j, v in enumerate(x)) % N for k in range(n)]


def words(values) -> torch.Tensor:
    return torch.tensor([s64(v) for v in values], dtype=torch.int64)


def values(t: torch.Tensor) -> list[int]:
    return [int(v) % (1 << 64) for v in t.reshape(-1)]


@pytest.mark.parametrize("N,g", FIELDS)
@pytest.mark.parametrize("n", [2, 4, 32, 128])
def test_forward_is_the_bit_reversed_dft(N, g, n):
    rng = random.Random(n)
    x = [rng.randrange(N) for _ in range(n)]
    w = pow(g, (N - 1) // n, N)
    want = naive_dft(x, w, N)
    got = values(ReferenceNTT(N, g, n, "cpu").forward(words(x)))
    bits = n.bit_length() - 1
    assert got == [want[bitrev(p, bits)] for p in range(n)]


@pytest.mark.parametrize("N,g", FIELDS)
@pytest.mark.parametrize("n", [2, 8, 64])
def test_inverse_of_bit_reversed_spectrum(N, g, n):
    """The inverse of a bit-reversed spectrum is the naive inverse DFT
    (root w^-1, scaled by 1/n) in natural order."""
    rng = random.Random(7 * n)
    spec = [rng.randrange(N) for _ in range(n)]
    bits = n.bit_length() - 1
    natural = [spec[bitrev(k, bits)] for k in range(n)]
    winv = pow(pow(g, (N - 1) // n, N), -1, N)
    ninv = pow(n, -1, N)
    want = [v * ninv % N for v in naive_dft(natural, winv, N)]
    assert values(ReferenceNTT(N, g, n, "cpu").inverse(words(spec))) == want


def test_batched_columns_transform_alone():
    n, b, N = 64, 5, FLAGSHIP
    rng = random.Random(3)
    x = torch.tensor([[s64(rng.randrange(N)) for _ in range(b)] for _ in range(n)])
    ref = ReferenceNTT(N, 3, n, "cpu")
    y = ref.forward(x)
    assert y.shape == (n, b)
    for c in range(b):
        assert torch.equal(y[:, c], ref.forward(x[:, c].contiguous()))
    assert torch.equal(ref.inverse(y), x)


def test_polymul_is_the_cyclic_convolution():
    n, N = 32, FLAGSHIP
    rng = random.Random(5)
    a = [rng.randrange(N) for _ in range(n // 2)] + [0] * (n // 2)
    b = [rng.randrange(N) for _ in range(n // 2)] + [0] * (n // 2)
    want = [sum(a[j] * b[(k - j) % n] for j in range(n)) % N for k in range(n)]
    assert values(ReferenceNTT(N, 3, n, "cpu").polymul(words(a), words(b))) == want


def test_mulhi_extremes():
    top = (1 << 64) - 1
    cases = [(top, top), (top, 1), (1 << 63, 1 << 63), (FLAGSHIP - 1, FLAGSHIP - 2), (0, top)]
    a = words([c[0] for c in cases])
    b = words([c[1] for c in cases])
    assert values(mulhi(a, b)) == [(x * y) >> 64 for x, y in cases]


def test_outputs_are_canonical_near_the_modulus():
    n, N = 16, FLAGSHIP
    x = words([N - 1 - i for i in range(n)])
    ref = ReferenceNTT(N, 3, n, "cpu")
    y = values(ref.forward(x))
    assert all(0 <= v < N for v in y)
    assert values(ref.inverse(ref.forward(x))) == values(x)


def test_the_control_is_wrong_at_a_64_bit_modulus():
    n, N = 256, FLAGSHIP
    rng = random.Random(1)
    x = words([rng.randrange(N) for _ in range(n)])
    exact = ReferenceNTT(N, 3, n, "cpu").forward(x)
    control = ReferenceNTT(N, 3, n, "cpu", arithmetic="float64").forward(x)
    assert (exact != control).sum().item() > n // 2


def test_rejects_a_length_the_field_lacks():
    with pytest.raises(ValueError):
        ReferenceNTT(998244353, 3, 1 << 24, "cpu")
    with pytest.raises(ValueError):
        ReferenceNTT(FLAGSHIP, 3, 48, "cpu")

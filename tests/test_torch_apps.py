"""PyTorch port, the applications: ``apps/series.py`` and ``apps/kinnaes.py``
against sventt_tpu's apps on the CPU, at m <= 12.

Mirrors ``tests/test_apps.py`` function for function: each generator and
count of the port is held against the JAX package's result and against the
exact value that test checks (OEIS A052456, the exact dynamic programme,
the host closed form), compared as Python ints, tolerance zero.  The port's
convolutions run on ``device="cpu"`` (every kernel's plain version);
m = 100 and 101 run on the card in ``chip_smoke.py``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from sventt_tpu import apps as japps
from sventt_tpu.apps import kinnaes as jkinnaes
from sventt_tpu.apps import series as jseries
from sventt_tpu_torch import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu_torch.apps import (
    kinnaes_magic_series_count,
    kinnaes_parameters,
    magic_series_count,
    poly_multiply,
    q_pochhammer_coeffs,
    restricted_partition_series,
)
from sventt_tpu_torch.apps import kinnaes, series
from sventt_tpu_torch.apps.convolve import make_convolver
from sventt_tpu_torch.apps.kinnaes import kinnaes_magic_series_count_host
from sventt_tpu_torch.apps.series import (
    gaussian_binomial_coefficient,
    magic_series_count_exact,
)
from sventt_tpu_torch.ops import ntt_mxu

N, G = TEST_MODULUS, TEST_GENERATOR
CPU = dict(device="cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent

#: OEIS A052456 (number of magic series of order m).
MAGIC_SERIES = {1: 1, 2: 2, 3: 8, 4: 86, 5: 1394, 6: 32134}


def _ints(a) -> list[int]:
    return [int(v) for v in a]


def _poly_mul_exact(a, b, N):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + int(x) * int(y)) % N
    return out


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_q_pochhammer_small(use_native):
    # (q;q)_3 = (1-q)(1-q^2)(1-q^3) = 1 - q - q^2 + q^4 + q^5 - q^6
    got = _ints(q_pochhammer_coeffs(3, 6, N, use_native=use_native))
    assert got == [1, N - 1, N - 1, 0, 1, 1, N - 1]
    assert got == _ints(jseries.q_pochhammer_coeffs(3, 6, N, use_native=use_native))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_restricted_partition_counts(use_native):
    # p(n | parts <= 3) for n = 0..8: 1,1,2,3,4,5,7,8,10
    got = _ints(restricted_partition_series(3, 8, N, use_native=use_native))
    assert got == [1, 1, 2, 3, 4, 5, 7, 8, 10]
    assert got == _ints(jseries.restricted_partition_series(3, 8, N, use_native=use_native))


def test_pochhammer_times_inverse_is_one():
    d = 40
    poch = q_pochhammer_coeffs(6, d, N)
    inv = restricted_partition_series(6, d, N)
    assert _poly_mul_exact(poch, inv, N)[: d + 1] == [1] + [0] * d
    assert _ints(poch) == _ints(jseries.q_pochhammer_coeffs(6, d, N))
    assert _ints(inv) == _ints(jseries.restricted_partition_series(6, d, N))


def test_poly_multiply_matches_exact(rng):
    a = rng.integers(0, N, 37, dtype=np.uint64)
    b = rng.integers(0, N, 23, dtype=np.uint64)
    got = _ints(poly_multiply(a, b, N, G, **CPU))
    assert got == _poly_mul_exact(a, b, N)
    assert got == _ints(japps.poly_multiply(a, b, N, G))


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_magic_series_via_ntt(m):
    got = magic_series_count(m, N, G, **CPU)
    assert got == MAGIC_SERIES[m] == jseries.magic_series_count(m, N, G)


def test_magic_series_exact_oracle():
    for m, v in MAGIC_SERIES.items():
        assert magic_series_count_exact(m) == v == jseries.magic_series_count_exact(m)


@pytest.mark.parametrize("chunk", [16, 64])
def test_magic_series_chunked_matches_direct(chunk):
    """The block convolution (numerator blocks streamed from the Rothe
    segments, one 2^ceil(log2(2 chunk - 1))-point NTT reused) equals the
    direct count, M(5) and M(8)."""
    assert magic_series_count(5, N, G, chunk=chunk, **CPU) == MAGIC_SERIES[5]
    assert magic_series_count(8, N, G, chunk=chunk, **CPU) == magic_series_count(8, N, G, **CPU)


@pytest.mark.parametrize("engine", ["mxu", "pallas", "jnp"])
def test_magic_series_via_engine(engine):
    """The pipeline over each engine's convolver (JAX tests the mxu one):
    forward, Montgomery pointwise product, inverse reproduce M(5)."""
    ntt = make_convolver(N, G, 256, engine=engine, **CPU)
    assert ntt.engine == engine
    ntt_mxu.reset_counts()
    assert magic_series_count(5, N, G, ntt=ntt) == MAGIC_SERIES[5]
    assert (sum(ntt_mxu.PLAIN_CALLS.values()) > 0) == (engine == "mxu")


def test_gaussian_binomial_limit_is_binomial():
    # qbinom(4, 2) = 1 + q + 2q^2 + q^3 + q^4
    got = [gaussian_binomial_coefficient(4, 2, r, N, G, **CPU) for r in range(5)]
    assert got == [1, 1, 2, 1, 1]
    assert got == [jseries.gaussian_binomial_coefficient(4, 2, r, N, G) for r in range(5)]
    # k > n: the numerator is the plain truncated product, direct and chunked
    assert gaussian_binomial_coefficient(2, 3, 1, N, G, **CPU) == 0
    assert gaussian_binomial_coefficient(2, 3, 1, N, G, chunk=4, **CPU) == 0


#: The moduli of ``tests/test_apps.py``'s matrix: Goldilocks with two
#: generators, the 64-bit flagship, 63/61/60-bit NTT primes, the 62-bit
#: test modulus and the Fermat prime F4 = 2^16 + 1.
MODULI_MATRIX = [
    (0xFFFF_FFFF_0000_0001, 7),
    (0xFFFF_FFFF_0000_0001, 823543),
    (0xFFFF_FC6E_8000_0001, 3),
    (0x7FFF_FFFF_FEF0_0001, 10),
    (0x3A00_0000_0000_0001, 3),
    (0x1FFF_FFFF_FFE0_0001, 37),
    (0x0FFF_FFFF_FE40_0001, 17),
    (0x0000_0000_0001_0001, 3),
]


@pytest.mark.parametrize("Nm,g", MODULI_MATRIX, ids=[f"{n:#x}-{g}" for n, g in MODULI_MATRIX])
def test_magic_series_moduli_matrix(Nm, g):
    """M(5) and M(6) through the pipeline on every matrix modulus (exact on
    each, F4 included), and the port's series equal JAX's on it."""
    assert magic_series_count(5, Nm, g, **CPU) == MAGIC_SERIES[5]
    assert magic_series_count(6, Nm, g, **CPU) == MAGIC_SERIES[6]
    r = 6 * 6 * 5 // 2
    assert _ints(restricted_partition_series(6, r, Nm)) == _ints(
        jseries.restricted_partition_series(6, r, Nm)
    )
    assert _ints(series._qbinom_numerator(36, 6, r, Nm)) == _ints(
        jseries._qbinom_numerator(36, 6, r, Nm)
    )


@pytest.mark.parametrize("m", [3, 4])
def test_kinnaes_host_and_device(m):
    Np, g, n = kinnaes_parameters(m, bits=61)
    assert (Np, g, n) == jkinnaes.kinnaes_parameters(m, bits=61)
    assert kinnaes_magic_series_count_host(m, Np, g, n) == MAGIC_SERIES[m]
    assert kinnaes_magic_series_count(m, Np, g, n, **CPU) == MAGIC_SERIES[m]
    assert jkinnaes.kinnaes_magic_series_count(m, Np, g, n) == MAGIC_SERIES[m]


def test_kinnaes_device_mid_scale():
    """m = 12 (r = 792, n/2 = 397 lanes): powering, the product loop and an
    odd-length reduction tree with real depth, against the host closed
    form, JAX's device count and the pipeline count."""
    m = 12
    Np, g, n = kinnaes_parameters(m, bits=61)
    dev = kinnaes_magic_series_count(m, Np, g, n, **CPU)
    assert dev == kinnaes_magic_series_count_host(m, Np, g, n)
    assert dev == jkinnaes.kinnaes_magic_series_count(m, Np, g, n)
    assert dev == magic_series_count(m, N, G, **CPU)  # exact: M(12) < both moduli


def test_kinnaes_pieces_match_jax(rng):
    """The lane powering and the fraction reduction of odd and even
    lengths equal JAX's, value for value."""
    import jax.numpy as jnp

    from sventt_tpu.field.limb import FieldConsts as JFieldConsts
    from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
    from sventt_tpu.field.modulus import Modulus as JModulus
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
    from sventt_tpu_torch.field.modulus import Modulus

    Np, g, n = kinnaes_parameters(12, bits=64)
    mod, jmod = Modulus(Np, g), JModulus(Np, g)
    fc, jfc = FieldConsts.from_modulus(mod, lazy=False), JFieldConsts.from_modulus(jmod, lazy=False)
    jd = np.arange(1, 398, dtype=np.uint32)
    base = mod.get_root_forward(n)
    got = kinnaes._pow_by_lane_index(fc, mod, base, from_numpy(jd.astype(np.uint64)), 9)
    want = jkinnaes._pow_by_lane_index(jfc, jmod, base, jnp.asarray(jd), 9)
    np.testing.assert_array_equal(to_numpy(got), u64_to_numpy(want))
    for length in (1, 2, 7, 397):
        a, b = (rng.integers(0, Np, length, dtype=np.uint64) for _ in range(2))
        gn, gd = kinnaes._reduce_fractions(fc, from_numpy(a), from_numpy(b), fc.mont_mul_full)
        wn, wd = jkinnaes._reduce_fractions(
            jfc, u64_from_numpy(a), u64_from_numpy(b), jfc.mont_mul_full
        )
        assert _ints(to_numpy(gn)) == _ints(u64_to_numpy(wn))
        assert _ints(to_numpy(gd)) == _ints(u64_to_numpy(wd))


@pytest.mark.parametrize("skip", [0, 1])
def test_kinnaes_parameters_skip(skip):
    Np, g, n = kinnaes_parameters(6, bits=61, skip=skip)
    assert (Np - 1) % n == 0 and n == 91
    assert (Np, g, n) == jkinnaes.kinnaes_parameters(6, bits=61, skip=skip)
    if skip:
        N0, _, _ = kinnaes_parameters(6, bits=61, skip=0)
        assert Np < N0
    for m in range(2, 13):
        assert kinnaes.kinnaes_length(m) == jkinnaes.kinnaes_length(m)


@pytest.mark.parametrize("m", [6, 8])
def test_three_way_cross_check(m):
    """Exact DP vs NTT convolution vs the Kinnaes closed form, host and
    device: independent counters that must agree."""
    exact = magic_series_count_exact(m)
    assert magic_series_count(m, N, G, **CPU) == exact % N
    Np, g, n = kinnaes_parameters(m, bits=61)
    assert kinnaes_magic_series_count_host(m, Np, g, n) == exact % Np
    assert kinnaes_magic_series_count(m, Np, g, n, **CPU) == exact % Np


@pytest.mark.parametrize("m", [11, 12])
@pytest.mark.parametrize("bits", [64, 62])
def test_kinnaes_widths(m, bits):
    """The device closed form at the widths of the reference-scale matrix
    (64-bit moduli, canonical arithmetic) against the exact count, at the
    largest m the CPU run takes (m = 100 and 101 run on the card)."""
    Np, g, n = kinnaes_parameters(m, bits=bits)
    assert Np.bit_length() == bits
    assert kinnaes_magic_series_count(m, Np, g, n, **CPU) == magic_series_count_exact(m) % Np


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pipeline_mid_scale_and_reference_counts():
    """The pipeline at m = 12 (r = 792, a 2^11-point convolution), direct
    and chunked, against the exact count; and chip_smoke.py's own copy of
    the exact M(100) and M(101) equals the JAX test's."""
    exact = magic_series_count_exact(12)
    assert magic_series_count(12, N, G, **CPU) == exact % N
    assert magic_series_count(12, N, G, chunk=128, **CPU) == exact % N
    smoke = _load(REPO / "chip_smoke.py", "chip_smoke_counts")
    japps_test = _load(REPO / "tests" / "test_apps.py", "jax_test_apps_counts")
    assert smoke.M100 == japps_test.M100 and smoke.M101 == japps_test.M101

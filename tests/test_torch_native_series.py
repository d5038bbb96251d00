"""PyTorch port, the native q-series generators (``native_src/series.cc``
through ``sventt_tpu_torch/native.py``) against the numpy models of
``apps/series.py`` and against sventt_tpu's native generators.

Mirrors ``tests/test_native_series.py`` function for function; values are
compared as uint64 words, tolerance zero.  Unlike the JAX loader, the
port's raises where the library cannot be built, so nothing here skips.
"""

from __future__ import annotations

import numpy as np
import pytest

from sventt_tpu import native as jnative
from sventt_tpu.apps import series as jseries
from sventt_tpu_torch import native
from sventt_tpu_torch.apps import series

N64 = 0xFFFFFC6E80000001  # flagship (64-bit)
N62 = 0x3A00000000000001  # test modulus (62-bit)


@pytest.mark.parametrize("modulus", [N64, N62], ids=["N64", "N62"])
@pytest.mark.parametrize("k,degree", [(1, 10), (5, 64), (31, 500)])
def test_qpochhammer_matches_numpy(modulus, k, degree):
    got = native.qpochhammer(k, degree, modulus)
    want = series.q_pochhammer_coeffs(k, degree, modulus, use_native=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.qpochhammer(k, degree, modulus))


@pytest.mark.parametrize("modulus", [N64, N62], ids=["N64", "N62"])
@pytest.mark.parametrize("k,degree", [(1, 32), (7, 300), (40, 1200)])
def test_restricted_partition_stream_matches_numpy(modulus, k, degree):
    want = series.restricted_partition_series(k, degree, modulus, use_native=False)
    np.testing.assert_array_equal(
        want, jseries.restricted_partition_series(k, degree, modulus, use_native=False)
    )
    with native.restricted_partition_stream(k, modulus) as s:
        # uneven blocks exercise the ring-buffer state
        parts, left = [], degree + 1
        for blk in (1, k, 3 * k + 1):
            take = min(blk, left)
            parts.append(s.next(take))
            left -= take
        if left:
            parts.append(s.next(left))
    assert s.position == degree + 1
    np.testing.assert_array_equal(np.concatenate(parts), want)


def test_restricted_partition_plain_integers():
    # p(n | parts <= 2) = 1,1,2,2,3,3,... ; p(n | parts <= 1) = all ones
    with native.restricted_partition_stream(2, N64) as s:
        assert [int(v) for v in s.next(10)] == [1, 1, 2, 2, 3, 3, 4, 4, 5, 5]
    with native.restricted_partition_stream(1, N62) as s:
        assert [int(v) for v in s.next(6)] == [1] * 6
    with pytest.raises(MemoryError):
        native.restricted_partition_stream(0, N62)  # k = 0: no stream


@pytest.mark.parametrize("modulus", [N64, N62], ids=["N64", "N62"])
@pytest.mark.parametrize("n,k", [(9, 3), (25, 5), (64, 8), (100, 100)])
def test_gauss_numerator_range_matches_numpy(modulus, n, k):
    deg = min(n * k, 900)
    want = series._qbinom_numerator(n, k, deg, modulus, use_native=False)
    got = native.gauss_numerator_range(0, deg + 1, n, k, modulus)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.gauss_numerator_range(0, deg + 1, n, k, modulus))
    lo = deg // 3  # an interior window
    np.testing.assert_array_equal(
        native.gauss_numerator_range(lo, deg - lo, n, k, modulus), want[lo:deg]
    )


def test_gauss_numerator_rejects_k_above_n():
    with pytest.raises(ValueError):
        native.gauss_numerator_range(0, 4, 3, 5, N64)
    # a negative argument would reach the library as a huge u64: refused
    with pytest.raises(ValueError, match="lo"):
        native.gauss_numerator_range(-1, 4, 9, 3, N64)
    with pytest.raises(ValueError, match="k"):
        native.restricted_partition_stream(-1, N64)
    with pytest.raises(ValueError, match="k"):
        native.qpochhammer(-2, 4, N64)


def test_series_public_functions_use_native_consistently():
    """The public functions give the same values from either backend, and
    the JAX package's."""
    for fn, jfn, args in [
        (series.q_pochhammer_coeffs, jseries.q_pochhammer_coeffs, (9, 200, N64)),
        (series.restricted_partition_series, jseries.restricted_partition_series, (9, 200, N64)),
    ]:
        a = fn(*args, use_native=True)
        np.testing.assert_array_equal(a, fn(*args, use_native=False))
        np.testing.assert_array_equal(a, jfn(*args))
    a = series._qbinom_numerator(81, 9, 300, N62, use_native=True)
    np.testing.assert_array_equal(a, series._qbinom_numerator(81, 9, 300, N62, use_native=False))
    np.testing.assert_array_equal(a, jseries._qbinom_numerator(81, 9, 300, N62))


def test_magic_series_chunked_with_streamed_numerator():
    """The chunked path (numerator blocks streamed from the Rothe segments)
    reproduces M(4) = 86 on the CPU."""
    assert series.magic_series_count(4, N62, 3, chunk=16, device="cpu") == 86


def test_failed_build_raises(monkeypatch, tmp_path):
    """A library that cannot be built raises; no generator returns None or
    falls back to numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCES", (str(tmp_path / "missing.cc"),))
    with pytest.raises(RuntimeError, match="missing"):
        native.qpochhammer(3, 6, N62)
    with pytest.raises(RuntimeError):
        series.restricted_partition_series(3, 8, N62)

"""PyTorch port, inter-step twiddle tables: bitwise against sventt_tpu.ops.twiddle.

The host tables and the device generator (both orientations, both
directions, with and without the Montgomery companion) must equal the JAX
package's tables word for word; the tolerance is zero.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import twiddle as jtw
from sventt_tpu_torch.field.limb import to_numpy
from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, Modulus
from sventt_tpu_torch.ops import twiddle

MOD = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
JMOD = JModulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)


def _assert_pair(port, jax_pair):
    np.testing.assert_array_equal(to_numpy(port.w), u64_to_numpy(jax_pair.w))
    if jax_pair.wp is None:
        assert port.wp is None
    else:
        np.testing.assert_array_equal(to_numpy(port.wp), u64_to_numpy(jax_pair.wp))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_host_row_twiddles(inverse):
    n0, n1 = 16, 32
    if inverse:
        want = jtw.sixstep_row_twiddles_inverse(JMOD, n0, n1)
        got = twiddle.sixstep_row_twiddles_inverse(MOD, n0, n1, device="cpu")
    else:
        want = jtw.sixstep_row_twiddles(JMOD, n0, n1)
        got = twiddle.sixstep_row_twiddles(MOD, n0, n1, device="cpu")
    _assert_pair(got, want)


@pytest.mark.parametrize("shape", [(16, 32), (256, 256)], ids=["16x32", "256x256"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("transposed", [False, True], ids=["natural", "transposed"])
def test_device_row_twiddles(shape, inverse, transposed):
    n0, n1 = shape
    for with_companion in (True, False):
        kw = dict(inverse=inverse, with_companion=with_companion, transposed=transposed)
        want = jtw.sixstep_row_twiddles_device(JMOD, n0, n1, **kw)
        got = twiddle.sixstep_row_twiddles_device(MOD, n0, n1, device="cpu", **kw)
        _assert_pair(got, want)


def test_device_generator_equals_host_tables():
    """The doubling generator gives the host recurrence's values."""
    got = twiddle.sixstep_row_twiddles_device(MOD, 32, 64, inverse=True, device="cpu")
    want = twiddle.sixstep_row_twiddles_inverse(MOD, 32, 64, device="cpu")
    np.testing.assert_array_equal(to_numpy(got.w), to_numpy(want.w))
    np.testing.assert_array_equal(to_numpy(got.wp), to_numpy(want.wp))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_solinas_twiddles_match_jax(inverse):
    """The Solinas inter-step tables: plain canonical values, companion-
    free, host-built and from the device generator (both orientations),
    equal JAX's word for word; the companion is dropped whatever
    ``with_companion`` says."""
    n0, n1 = 16, 32
    want = jtw.sixstep_row_twiddles_plain(JMOD, n0, n1, inverse=inverse)
    _assert_pair(twiddle.sixstep_row_twiddles_plain(MOD, n0, n1, inverse=inverse, device="cpu"), want)
    for transposed in (False, True):
        kw = dict(inverse=inverse, modmul="solinas", transposed=transposed)
        want = jtw.sixstep_row_twiddles_device(JMOD, n0, n1, **kw)
        _assert_pair(twiddle.sixstep_row_twiddles_device(MOD, n0, n1, device="cpu", **kw), want)
    _assert_pair(twiddle.montgomery_scalar(MOD, 12345, device="cpu"), jtw.montgomery_scalar(JMOD, 12345))


@pytest.mark.parametrize("modmul", ["montgomery", "solinas"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_device_row_twiddle_column_blocks(inverse, modmul):
    """``columns=(start, count)`` builds exactly those columns of the whole
    matrix (a distributed shard's block), companion included."""
    n0, n1 = 16, 64
    kw = dict(inverse=inverse, modmul=modmul)
    full = twiddle.sixstep_row_twiddles_device(MOD, n0, n1, device="cpu", **kw)
    for start, count in ((0, 16), (16, 16), (48, 16), (32, 32), (0, 64)):
        block = twiddle.sixstep_row_twiddles_device(MOD, n0, n1, columns=(start, count),
                                                    device="cpu", **kw)
        cols = slice(start, start + count)
        np.testing.assert_array_equal(to_numpy(block.w), to_numpy(full.w)[:, cols])
        if modmul == "solinas":
            assert block.wp is None
        else:
            np.testing.assert_array_equal(to_numpy(block.wp), to_numpy(full.wp)[:, cols])
    with pytest.raises(ValueError, match="block"):
        twiddle.sixstep_row_twiddles_device(MOD, n0, n1, columns=(8, 24), device="cpu")


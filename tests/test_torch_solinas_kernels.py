"""PyTorch port, the Solinas branch of each kernel's plain version, bitwise
against the JAX package's Pallas kernels in interpret mode: K4 (leaf),
K1 / K2 (the matrix kernel's fused twiddle) and the inter-step pass of
the transpose fallback here; K5 and K6 in test_torch_solinas_rows.py.

Inputs are made with numpy from a seed; the data of every forward
twiddle multiply holds JAX's corner values of the Solinas fold (0, 1,
N - 1, N, 2^63, 2^64 - 1: the multiply accepts any word), the twiddles
hold N - 1.  Solinas is canonical, so outputs are compared bit for bit,
tolerance zero.  The JAX kernels are traced at m <= 32: each length is a
separate trace, and K4 at m = 64 alone takes about a minute.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import ntt_mxu as jmxu
from sventt_tpu.ops import ntt_pallas as jpal
from sventt_tpu.ops.twiddle import MontPair as JMontPair
from sventt_tpu.plan.planner import _mont_mul_bcast
from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import inter_step, ntt_mxu, ntt_pallas
from sventt_tpu_torch.ops.twiddle import MontPair

MODULI = [
    pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, id="flagship"),
    pytest.param(GOLDILOCKS_MODULUS, 7, id="goldilocks"),
]
DIRECTIONS = pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])


def _setup(N, g):
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jfc = JFieldConsts.from_modulus(jmod, modmul="solinas")
    fc = FieldConsts.from_modulus(mod, modmul="solinas")
    return jmod, mod, jfc, fc


def _data(rng, N, shape, corners: bool):
    """Residues of ``shape``, or (``corners``) any words led by the corner
    values of the fold."""
    if not corners:
        return rng.integers(0, N, shape, dtype=np.uint64)
    x = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[:12] = np.resize(np.array([0, 1, N - 1, N, 1 << 63, (1 << 64) - 1], dtype=np.uint64), 12)
    return x


def _twiddles(rng, N, shape):
    w = rng.integers(0, N, shape, dtype=np.uint64)
    w.reshape(-1)[::3] = N - 1
    return w


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), u64_to_numpy(want))


@DIRECTIONS
@pytest.mark.parametrize("N,g", MODULI)
def test_leaf_matches_jax(rng, N, g, inverse):
    """K4 on (8, 3) along the leading axis, 2-channel stage tables and the
    companion-free 1/m scale."""
    jmod, mod, jfc, fc = _setup(N, g)
    jt = jpal.make_leaf_tables(jmod, 8, inverse=inverse, modmul="solinas")
    pt = ntt_pallas.make_leaf_tables(mod, 8, inverse=inverse, modmul="solinas", device="cpu")
    x = _data(rng, N, (8, 3), False)
    x[:, 1] = N - 1
    _same(ntt_pallas.fused_ntt(from_numpy(x), pt, fc), jpal.fused_ntt(u64_from_numpy(x), jt, jfc))


@DIRECTIONS
@pytest.mark.parametrize("N,g", MODULI)
def test_mxu_lead_matches_jax(rng, N, g, inverse):
    """K1 on (16, 3) with the fused Solinas twiddle (JAX ``_tw_mul``)."""
    jmod, mod, jfc, fc = _setup(N, g)
    jt = jmxu.make_mxu_tables(jmod, 16, inverse=inverse)
    pt = ntt_mxu.make_mxu_tables(mod, 16, inverse=inverse, device="cpu")
    x = _data(rng, N, (16, 3), not inverse)
    w = _twiddles(rng, N, (16, 3))
    want = jmxu.mxu_ntt(u64_from_numpy(x), jt, jfc, tw=JMontPair(u64_from_numpy(w), None))
    _same(ntt_mxu.mxu_ntt(from_numpy(x), pt, fc, tw=MontPair(from_numpy(w), None)), want)


@DIRECTIONS
def test_mxu_mid_matches_jax(rng, inverse):
    """K2 on (4, 32, 2) with (4, 32) Solinas twiddle rows."""
    jmod, mod, jfc, fc = _setup(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    jt = jmxu.make_mxu_tables(jmod, 32, inverse=inverse)
    pt = ntt_mxu.make_mxu_tables(mod, 32, inverse=inverse, device="cpu")
    x = _data(rng, FLAGSHIP_MODULUS, (4, 32, 2), not inverse)
    w = _twiddles(rng, FLAGSHIP_MODULUS, (4, 32))
    want = jmxu.mxu_ntt_mid(u64_from_numpy(x), jt, jfc, tw=JMontPair(u64_from_numpy(w), None))
    _same(ntt_mxu.mxu_ntt_mid(from_numpy(x), pt, fc, tw=MontPair(from_numpy(w), None)), want)


@pytest.mark.parametrize("N,g", MODULI)
def test_inter_step_matches_jax(rng, N, g):
    """The inter-step pass under Solinas (``mont_mul_bcast``, the kernel
    csrc/inter_step.cu's plain version on the CPU) against JAX's
    ``_mont_mul_bcast``: batched and unbatched, companion-free (a
    companion is refused: test_companion_refused)."""
    _, _, jfc, fc = _setup(N, g)
    for shape in ((4, 8, 3), (4, 8)):
        x = _data(rng, N, shape, True)
        w = _twiddles(rng, N, shape[:2])
        want = _mont_mul_bcast(jfc, u64_from_numpy(x), JMontPair(u64_from_numpy(w), None), len(shape) - 2)
        inter_step.reset_counts()
        got = inter_step.mont_mul_bcast(fc, from_numpy(x), MontPair(from_numpy(w), None))
        assert inter_step.PLAIN_CALLS["inter_step"] == 1 and inter_step.LAUNCHES["inter_step"] == 0
        _same(got, want)


def test_companion_refused(rng):
    """Under Solinas the twiddles are plain: every wrapper that fuses or
    runs the inter-step multiply (K1 / K2, K5 / K6, the inter-step pass)
    raises on a companion table instead of dropping it, on the CPU as on
    the card, and runs nothing."""
    _, mod, _, fc = _setup(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    x = from_numpy(_data(rng, FLAGSHIP_MODULUS, (4, 8, 3), False))
    w = from_numpy(_twiddles(rng, FLAGSHIP_MODULUS, (4, 8)))
    pair = MontPair(w, w)
    mt = ntt_mxu.make_mxu_tables(mod, 8, inverse=False, device="cpu")
    lt = ntt_pallas.make_leaf_tables(mod, 8, inverse=False, modmul="solinas", device="cpu")
    rt = ntt_pallas.make_lane_tables(mod, 8, inverse=False, modmul="solinas", device="cpu")
    xl = x.reshape(12, 8)
    calls = [
        lambda: ntt_mxu.mxu_ntt_mid(x, mt, fc, pair),
        lambda: ntt_mxu.mxu_ntt(x[0], mt, fc, MontPair(x[0], x[0])),
        lambda: ntt_pallas.fused_ntt_mid(x, lt, fc, pair),
        lambda: ntt_pallas.fused_ntt_lane(xl, rt, fc, MontPair(xl, xl)),
        lambda: inter_step.mont_mul_bcast(fc, x, pair),
    ]
    for mod_ in (ntt_mxu, ntt_pallas, inter_step):
        mod_.reset_counts()
    for call in calls:
        with pytest.raises(ValueError, match="companion"):
            call()
    for mod_ in (ntt_mxu, ntt_pallas, inter_step):
        assert not any(mod_.LAUNCHES.values()) and not any(mod_.PLAIN_CALLS.values())

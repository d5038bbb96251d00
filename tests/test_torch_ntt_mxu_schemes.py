"""PyTorch port, the matrix engine's other plane schemes ("u7", "s8b"):
bitwise against sventt_tpu.ops.ntt_mxu.

On the CPU the port's wrappers run the kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode, as tests/test_ntt_mxu.py
does.  Inputs are made with numpy from a seed.  The tolerance is zero: the
outputs are compared bit for bit before normalize (a lazy-mode inverse
epilogue returns [0, 2N) representatives on both sides) and after it.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import ntt_mxu as jmxu
from sventt_tpu.ops.twiddle import MontPair as JMontPair
from sventt_tpu_torch import interop
from sventt_tpu_torch.field.golden import GoldenNTT
from sventt_tpu_torch.field.limb import FieldConsts, from_limbs, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_mxu
from sventt_tpu_torch.ops.twiddle import MontPair

SCHEMES = ["u7", "s8b"]
FLAG = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
TEST = (TEST_MODULUS, TEST_GENERATOR)


def _both(N, g, m, inverse, scheme):
    """(JAX tables, port tables, JAX FieldConsts, port FieldConsts)."""
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jt = jmxu.make_mxu_tables(jmod, m, inverse=inverse, scheme=scheme)
    pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme=scheme, device="cpu")
    jfc, fc = JFieldConsts.from_modulus(jmod), FieldConsts.from_modulus(mod)
    assert fc.lazy == jfc.lazy
    return jt, pt, jfc, fc


def _twiddles(rng, N, shape, mode):
    """Random inter-step twiddles as (JAX MontPair, port MontPair)."""
    w = rng.integers(0, N, shape, dtype=np.uint64)
    wp = None
    if mode == "pair":
        with np.errstate(over="ignore"):
            wp = w * np.uint64(pow(N, -1, 1 << 64))
    jtw = JMontPair(u64_from_numpy(w), None if wp is None else u64_from_numpy(wp))
    return jtw, MontPair(from_numpy(w), None if wp is None else from_numpy(wp))


def _assert_same(got, want, jfc, fc, msg=""):
    np.testing.assert_array_equal(to_numpy(got), want, err_msg=msg)
    want_n = u64_to_numpy(jfc.normalize(u64_from_numpy(want)))
    np.testing.assert_array_equal(to_numpy(fc.normalize(got)), want_n, err_msg=msg)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("m", [16, 128])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_scheme_tables_equal_jax(scheme, m, inverse):
    """Planes and corr equal the JAX package's element for element."""
    jt = jmxu.make_mxu_tables(JModulus(*FLAG), m, inverse=inverse, scheme=scheme)
    pt = ntt_mxu.make_mxu_tables(Modulus(*FLAG), m, inverse=inverse, scheme=scheme, device="cpu")
    assert pt.scheme == jt.scheme == scheme
    assert tuple(pt.planes.shape) == ntt_mxu._mat_dims(scheme, m) == jmxu._mat_dims(scheme, m)
    np.testing.assert_array_equal(pt.planes.numpy(), np.asarray(jt.planes))
    if scheme == "u7":
        assert pt.corr is None and jt.corr is None
    else:
        want = to_numpy(from_limbs(np.asarray(jt.corr.hi), np.asarray(jt.corr.lo))).ravel()
        np.testing.assert_array_equal(to_numpy(pt.corr), want)
    assert (pt.c128, pt.nprime, pt.modulus) == (jt.c128, jt.nprime, jt.modulus)


def test_s8b_band_holds_the_s8_digits():
    """Block (t, b) of the banded matrix is s8 digit plane t - b, zero off
    the band, and s8b keeps s8's corr; the kernel reads G's first block
    column, which is the s8 stack itself."""
    mod, m = Modulus(*FLAG), 16
    s8 = ntt_mxu.make_mxu_tables(mod, m, inverse=True, device="cpu")
    s8b = ntt_mxu.make_mxu_tables(mod, m, inverse=True, scheme="s8b", device="cpu")
    D, G = s8.planes.numpy().reshape(8, m, m), s8b.planes.numpy()
    for t in range(15):
        for b in range(8):
            blk = G[t * m:(t + 1) * m, b * m:(b + 1) * m]
            want = D[t - b] if 0 <= t - b < 8 else np.zeros((m, m), np.int8)
            np.testing.assert_array_equal(blk, want, err_msg=f"block ({t}, {b})")
    np.testing.assert_array_equal(to_numpy(s8b.corr), to_numpy(s8.corr))
    assert s8b.kernel_planes.is_contiguous() and s8.kernel_planes is s8.planes
    np.testing.assert_array_equal(s8b.kernel_planes.numpy(), s8.planes.numpy())


@pytest.mark.parametrize("m,scheme", [(16, "u8"), (1024, "s8b"), (12, "u7")],
                         ids=["unknown-scheme", "s8b-1024", "u7-not-pow2"])
def test_scheme_errors_match_jax(m, scheme):
    with pytest.raises(ValueError) as je:
        jmxu.make_mxu_tables(JModulus(*FLAG), m, inverse=False, scheme=scheme)
    with pytest.raises(ValueError) as pe:
        ntt_mxu.make_mxu_tables(Modulus(*FLAG), m, inverse=False, scheme=scheme, device="cpu")
    assert str(pe.value) == str(je.value)


LEAD_CASES = [
    pytest.param(FLAG, False, ("none", "pair", "w"), id="flagship-fwd"),
    pytest.param(FLAG, True, ("none", "pair", "w"), id="flagship-inv"),
    pytest.param(TEST, False, ("pair",), id="test62-fwd"),
    pytest.param(TEST, True, ("pair", "w"), id="test62-inv-lazy"),
]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mod_gen,inverse,modes", LEAD_CASES)
def test_scheme_mxu_ntt_matches_jax(rng, scheme, mod_gen, inverse, modes):
    """Lead orientation, (32, 3) with an N-1 column, per twiddle mode,
    against the JAX kernel with the same scheme (interpret mode)."""
    N, g = mod_gen
    m = 32
    jt, pt, jfc, fc = _both(N, g, m, inverse, scheme)
    x = rng.integers(0, N, (m, 3), dtype=np.uint64)
    x[:, 1] = N - 1  # maximal-carry column
    for mode in modes:
        jtw, ptw = (None, None) if mode == "none" else _twiddles(rng, N, (m, 3), mode)
        want = u64_to_numpy(jmxu.mxu_ntt(u64_from_numpy(x), jt, jfc, tw=jtw))
        got = ntt_mxu.mxu_ntt(from_numpy(x), pt, fc, tw=ptw)
        _assert_same(got, want, jfc, fc, mode)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mode", ["pair", "w"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_scheme_mxu_ntt_mid_matches_jax(rng, scheme, inverse, mode):
    """Mid orientation on (4, 16, 2) with (4, 16) twiddle rows, lazy TEST
    modulus."""
    N, g = TEST
    jt, pt, jfc, fc = _both(N, g, 16, inverse, scheme)
    x = rng.integers(0, N, (4, 16, 2), dtype=np.uint64)
    jtw, ptw = _twiddles(rng, N, (4, 16), mode)
    want = u64_to_numpy(jmxu.mxu_ntt_mid(u64_from_numpy(x), jt, jfc, tw=jtw))
    got = ntt_mxu.mxu_ntt_mid(from_numpy(x), pt, fc, tw=ptw)
    _assert_same(got, want, jfc, fc)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_scheme_mxu_ntt_lane_matches_jax(rng, scheme, inverse):
    """Lane orientation on (5, 16) rows (JAX pads them to 32), with an N-1
    row."""
    N, g = FLAG
    jt, pt, jfc, fc = _both(N, g, 16, inverse, scheme)
    x = rng.integers(0, N, (5, 16), dtype=np.uint64)
    x[2] = N - 1
    want = u64_to_numpy(jmxu.mxu_ntt_lane(u64_from_numpy(x), jt, jfc))
    got = ntt_mxu.mxu_ntt_lane(from_numpy(x), pt, fc)
    _assert_same(got, want, jfc, fc)


def test_u7_small_modulus_f4(rng):
    """u7 with the F4 prime 2^16+1 takes the Barrett branch: equal to the
    JAX kernel, to the golden model, and an exact roundtrip."""
    N, g, m = 65537, 3, 16
    mod = Modulus(N, g)
    jmod = JModulus(N, g)
    jfc, fc = JFieldConsts.from_modulus(jmod, lazy=False), FieldConsts.from_modulus(mod, lazy=False)
    assert ntt_mxu._reduce_consts(N) == (1, True)
    x = rng.integers(0, N, (m, 3), dtype=np.uint64)
    x[:, 1] = N - 1
    out = x
    for inverse in (False, True):
        jt = jmxu.make_mxu_tables(jmod, m, inverse=inverse, scheme="u7")
        pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme="u7", device="cpu")
        want = u64_to_numpy(jmxu.mxu_ntt(u64_from_numpy(out), jt, jfc))
        got = to_numpy(ntt_mxu.mxu_ntt(from_numpy(out), pt, fc))
        np.testing.assert_array_equal(got, want)
        if not inverse:
            golden = GoldenNTT(m, mod)
            for c in range(3):
                assert [int(v) for v in got[:, c]] == golden.forward([int(v) for v in x[:, c]])
        out = got
    np.testing.assert_array_equal(out, x)


@pytest.mark.parametrize("N,g", [FLAG, TEST], ids=["flagship", "test62"])
def test_mxu_schemes_agree(rng, N, g):
    """The port's counterpart of test_mxu_schemes_agree: s8, u7 and s8b are
    bitwise equal in every orientation and direction, with an N-1 column."""
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    m = 128
    x = rng.integers(0, N, (m, 4), dtype=np.uint64)
    x[:, 0] = N - 1  # maximal magnitudes through the signed planes
    xm = from_numpy(rng.integers(0, N, (2, m, 3), dtype=np.uint64))
    for inverse in (False, True):
        outs = []
        for scheme in ("s8", "u7", "s8b"):
            t = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme=scheme, device="cpu")
            outs.append([
                to_numpy(ntt_mxu.mxu_ntt(from_numpy(x), t, fc)),
                to_numpy(ntt_mxu.mxu_ntt_mid(xm, t, fc)),
                to_numpy(ntt_mxu.mxu_ntt_lane(from_numpy(x.T.copy()), t, fc)),
            ])
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                np.testing.assert_array_equal(b, a)
    golden = GoldenNTT(m, mod)
    assert [int(v) for v in outs[0][0][:, 0]] == golden.inverse([N - 1] * m)


def test_u7_1024_all_ones_golden():
    """u7 at m = 1024 on the all-ones word 2^64 - 1 in every point: the
    seven-bit data planes 0-8 at their largest value (127), so the 19
    product planes reach the largest sums these tables allow.  Equal to
    the golden model of x mod N, and to s8."""
    mod = Modulus(*FLAG)
    fc = FieldConsts.from_modulus(mod)
    m = 1024
    t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="u7", device="cpu")
    x = from_numpy(np.full((m, 2), (1 << 64) - 1, dtype=np.uint64))
    out = to_numpy(ntt_mxu.mxu_ntt(x, t, fc))
    want = GoldenNTT(m, mod).forward([((1 << 64) - 1) % mod.modulus] * m)
    assert [int(v) for v in out[:, 0]] == want
    np.testing.assert_array_equal(out[:, 1], out[:, 0])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_interop_scheme_tables(rng, scheme):
    """JAX tables of each scheme carried across through numpy equal the
    port's own and compute the same transform."""
    N, g = FLAG
    m = 16
    jt, pt, _, fc = _both(N, g, m, False, scheme)
    corr = None if jt.corr is None else (np.asarray(jt.corr.hi), np.asarray(jt.corr.lo))
    carried = interop.mxu_direction_from_numpy(
        Modulus(N, g), m, False, np.asarray(jt.planes), corr, device="cpu", scheme=scheme
    )
    assert carried.scheme == scheme
    np.testing.assert_array_equal(carried.planes.numpy(), pt.planes.numpy())
    assert (carried.corr is None) == (pt.corr is None)
    if pt.corr is not None:
        np.testing.assert_array_equal(to_numpy(carried.corr), to_numpy(pt.corr))
    x = from_numpy(rng.integers(0, N, (m, 3), dtype=np.uint64))
    np.testing.assert_array_equal(
        to_numpy(ntt_mxu.mxu_ntt(x, carried, fc)), to_numpy(ntt_mxu.mxu_ntt(x, pt, fc))
    )


def test_interop_rejects_mismatched_tables():
    """A scheme's planes of the wrong shape or type, a u7 corr, or a missing
    s8b corr raise."""
    mod, m = Modulus(*FLAG), 8
    u7 = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="u7", device="cpu")
    s8b = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="s8b", device="cpu")
    corr = (np.zeros((1, m), np.uint32), np.zeros((1, m), np.uint32))
    conv = interop.mxu_direction_from_numpy
    bad = [
        (u7.planes.numpy(), None, "s8"),  # (10m, m) is not s8's (8m, m)
        (u7.planes.numpy(), corr, "u7"),  # u7 has no corr
        (s8b.planes.numpy(), None, "s8b"),  # s8b needs one
        (s8b.planes.numpy().astype(np.int16), corr, "s8b"),
        (s8b.planes.numpy(), corr, "u8"),
    ]
    for planes, c, scheme in bad:
        with pytest.raises(ValueError):
            conv(mod, m, False, planes, c, device="cpu", scheme=scheme)


def test_scheme_counts_and_kernel_checks():
    """CPU tensors count plain calls under every scheme, never launches; the
    launch path's table check rejects planes that do not fit the scheme."""
    mod = Modulus(*FLAG)
    fc = FieldConsts.from_modulus(mod)
    ntt_mxu.reset_counts()
    for scheme in SCHEMES:
        t = ntt_mxu.make_mxu_tables(mod, 8, inverse=False, scheme=scheme, device="cpu")
        ntt_mxu.mxu_ntt(from_numpy(np.zeros((8, 2), np.uint64)), t, fc)
        ntt_mxu.mxu_ntt_mid(from_numpy(np.zeros((3, 8, 2), np.uint64)), t, fc)
        ntt_mxu.mxu_ntt_lane(from_numpy(np.zeros((2, 8), np.uint64)), t, fc)
    assert ntt_mxu.PLAIN_CALLS == {"lead": 2, "mid": 2, "lane": 2}
    assert ntt_mxu.LAUNCHES == {"lead": 0, "mid": 0, "lane": 0}
    u7 = ntt_mxu.make_mxu_tables(mod, 8, inverse=False, scheme="u7", device="cpu")
    s8 = ntt_mxu.make_mxu_tables(mod, 8, inverse=False, device="cpu")
    x = from_numpy(np.zeros((1, 8, 2), np.uint64))
    for t in (
        ntt_mxu.MxuDirection(8, False, u7.planes, s8.corr, u7.modulus, u7.c128, u7.nprime, "s8"),
        ntt_mxu.MxuDirection(8, False, u7.planes, s8.corr, u7.modulus, u7.c128, u7.nprime, "u7"),
        ntt_mxu.MxuDirection(8, False, s8.planes, None, s8.modulus, s8.c128, s8.nprime, "s8"),
        ntt_mxu.MxuDirection(8, False, s8.planes, s8.corr, s8.modulus, s8.c128, s8.nprime, "s9"),
    ):
        with pytest.raises(ValueError):
            ntt_mxu._check_cuda(t, x, None)
    ntt_mxu._check_cuda(u7, x, None)

"""PyTorch port, s8 matrix NTT: bitwise against sventt_tpu.ops.ntt_mxu.

On the CPU the port's wrappers run the kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode, as tests/test_ntt_mxu.py
does.  Inputs are made with numpy from a seed.  The tolerance is zero: the
outputs are compared bit for bit BEFORE normalize (a lazy-mode inverse
epilogue returns [0, 2N) representatives on both sides) and after it.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import ntt_mxu as jmxu
from sventt_tpu.ops.twiddle import MontPair as JMontPair
from sventt_tpu.plan import planner as jplanner
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
from sventt_tpu_torch.plan import planner

MODULI = [
    pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, id="flagship"),
    pytest.param(TEST_MODULUS, TEST_GENERATOR, id="test62-lazy"),
]


def _np_tables(t):
    """A JAX MxuDirection as numpy: (planes, (corr_hi, corr_lo))."""
    return np.asarray(t.planes), (np.asarray(t.corr.hi), np.asarray(t.corr.lo))


def _twiddles(rng, N, shape, mode):
    """Random inter-step twiddles as (numpy w, numpy wp or None)."""
    w = rng.integers(0, N, shape, dtype=np.uint64)
    if mode == "w":
        return w, None
    with np.errstate(over="ignore"):
        return w, w * np.uint64(pow(N, -1, 1 << 64))


def _jax_pair(w, wp):
    return JMontPair(u64_from_numpy(w), None if wp is None else u64_from_numpy(wp))


def _port_pair(w, wp):
    return MontPair(from_numpy(w), None if wp is None else from_numpy(wp))


@pytest.mark.parametrize("m", [8, 64, 256])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_tables_equal_jax(m, inverse):
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    jt = jmxu.make_mxu_tables(JModulus(mod.modulus, mod.generator), m, inverse=inverse)
    pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, device="cpu")
    planes, corr = _np_tables(jt)
    np.testing.assert_array_equal(pt.planes.numpy(), planes)
    np.testing.assert_array_equal(to_numpy(pt.corr), to_numpy(from_limbs(*corr)).ravel())
    assert (pt.c128, pt.nprime, pt.modulus) == (jt.c128, jt.nprime, jt.modulus)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("N,g", MODULI)
def test_mxu_ntt_matches_jax(rng, N, g, inverse, m):
    """Lead orientation, B = 3 with an N-1 column, twiddle modes
    none / pair / w, against the JAX kernel (interpret mode)."""
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jfc, fc = JFieldConsts.from_modulus(jmod), FieldConsts.from_modulus(mod)
    assert fc.lazy == jfc.lazy
    jt = jmxu.make_mxu_tables(jmod, m, inverse=inverse)
    pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, device="cpu")
    x = rng.integers(0, N, (m, 3), dtype=np.uint64)
    x[:, 1] = N - 1  # maximal-carry column
    for mode in ("none", "pair", "w"):
        jtw = ptw = None
        if mode != "none":
            w, wp = _twiddles(rng, N, (m, 3), mode)
            jtw, ptw = _jax_pair(w, wp), _port_pair(w, wp)
        want = u64_to_numpy(jmxu.mxu_ntt(u64_from_numpy(x), jt, jfc, tw=jtw))
        got = ntt_mxu.mxu_ntt(from_numpy(x), pt, fc, tw=ptw)
        np.testing.assert_array_equal(to_numpy(got), want, err_msg=mode)
        want_n = u64_to_numpy(jfc.normalize(u64_from_numpy(want)))
        np.testing.assert_array_equal(to_numpy(fc.normalize(got)), want_n, err_msg=mode)


@pytest.mark.parametrize("mode", ["pair", "w"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_mxu_ntt_mid_matches_jax(rng, inverse, mode):
    """Mid orientation on (4, 32, 2) with (4, 32) twiddle rows."""
    N, g = TEST_MODULUS, TEST_GENERATOR
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jfc, fc = JFieldConsts.from_modulus(jmod), FieldConsts.from_modulus(mod)
    jt = jmxu.make_mxu_tables(jmod, 32, inverse=inverse)
    pt = ntt_mxu.make_mxu_tables(mod, 32, inverse=inverse, device="cpu")
    x = rng.integers(0, N, (4, 32, 2), dtype=np.uint64)
    w, wp = _twiddles(rng, N, (4, 32), mode)
    want = u64_to_numpy(
        jmxu.mxu_ntt_mid(u64_from_numpy(x), jt, jfc, tw=_jax_pair(w, wp))
    )
    got = ntt_mxu.mxu_ntt_mid(from_numpy(x), pt, fc, tw=_port_pair(w, wp))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_mxu_1024_plane_minimizer_golden():
    """m = 1024 with the input that drives one output plane maximally
    negative (each byte sign-opposes the matching digit): the exact wrap
    case of a too-small plane bias.  Port only, against the golden model."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    m = 1024
    t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, device="cpu")
    D = t.planes.numpy().astype(np.int64).reshape(ntt_mxu.NL_S8, m, m)
    min_a = np.where(D > 0, -128 * D, 127 * D).sum(axis=2)
    worst = np.zeros((15, m), dtype=np.int64)
    for a in range(8):
        for b in range(8):
            worst[a + b] += min_a[a]
    tstar, pstar = np.unravel_index(np.argmin(worst), worst.shape)
    x = np.zeros(m, dtype=np.uint64)
    reach = 0
    for j in range(m):
        v = 0
        for b in range(8):
            a = tstar - b
            s = -128
            if 0 <= a < 8:
                d = D[a, pstar, j]
                s = 127 if d < 0 else -128
                reach += int(d) * s
            v |= (s + 128) << (8 * b)
        x[j] = v
    assert reach < -(1 << 26)  # the crafted input crosses the old fixed bias
    out = to_numpy(ntt_mxu.mxu_ntt(from_numpy(x.reshape(m, 1)), t, fc))
    want = GoldenNTT(m, mod).forward([int(v) % mod.modulus for v in x])
    assert [int(v) for v in out[:, 0]] == want


def test_mxu_small_modulus_f4(rng):
    """The F4 prime 2^16+1 takes the Barrett branch; bit-exact + roundtrip."""
    mod = Modulus(65537, 3)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    assert ntt_mxu._reduce_consts(mod.modulus) == (1, True)
    m = 64
    ft = ntt_mxu.make_mxu_tables(mod, m, inverse=False, device="cpu")
    it = ntt_mxu.make_mxu_tables(mod, m, inverse=True, device="cpu")
    x = rng.integers(0, mod.modulus, (m, 3), dtype=np.uint64)
    x[:, 1] = mod.modulus - 1
    out = to_numpy(ntt_mxu.mxu_ntt(from_numpy(x), ft, fc))
    golden = GoldenNTT(m, mod)
    for c in range(3):
        assert [int(v) for v in out[:, c]] == golden.forward([int(v) for v in x[:, c]])
    back = to_numpy(ntt_mxu.mxu_ntt(from_numpy(out), it, fc))
    np.testing.assert_array_equal(back, x)


def test_balanced8_matches_table_digits():
    """Each table entry's digits are the scalar balanced decomposition."""
    t = ntt_mxu.make_mxu_tables(
        Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR), 16, inverse=True, device="cpu"
    )
    planes = t.planes.numpy()
    for p in range(16):
        for j in range(16):
            ds = [int(planes[a * 16 + p, j]) for a in range(8)]
            assert ntt_mxu._balanced8(sum(d << (8 * a) for a, d in enumerate(ds))) == ds
    assert ntt_mxu._balanced8(jmxu.C8_PLUS) == jmxu._balanced8(jmxu.C8_PLUS)


def test_counts_and_rejects():
    """CPU tensors count plain calls, never launches; bad shapes raise."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    t = ntt_mxu.make_mxu_tables(mod, 8, inverse=False, device="cpu")
    ntt_mxu.reset_counts()
    ntt_mxu.mxu_ntt(from_numpy(np.zeros((8, 2), np.uint64)), t, fc)
    ntt_mxu.mxu_ntt_mid(from_numpy(np.zeros((3, 8, 2), np.uint64)), t, fc)
    assert ntt_mxu.PLAIN_CALLS == {"lead": 1, "mid": 1, "lane": 0}
    assert ntt_mxu.LAUNCHES == {"lead": 0, "mid": 0, "lane": 0}
    with pytest.raises(ValueError):
        ntt_mxu.mxu_ntt(from_numpy(np.zeros((4, 2), np.uint64)), t, fc)
    with pytest.raises(ValueError):
        ntt_mxu.make_mxu_tables(mod, 2 * ntt_mxu.MAX_MXU, inverse=False, device="cpu")


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_interop_plan_tables(rng, inverse):
    """JAX-built tables carried across through numpy equal the port's own,
    and drive the port's transform to the same output."""
    N, g = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR
    jmod, mod = JModulus(N, g), Modulus(N, g)
    fc = FieldConsts.from_modulus(mod)
    jplan = jplanner.build_plan(1 << 12, "mxu", 16)  # 3 levels: mid + lead steps
    plan = planner.build_plan(1 << 12, "mxu", 16)
    assert repr(plan) == repr(jplan)
    jpt = jplanner.PlanTables(jplan, jmod, JFieldConsts.from_modulus(jmod), inverse)

    def pair(tw):
        return {
            "w": (np.asarray(tw.w.hi), np.asarray(tw.w.lo)),
            "wp": None if tw.wp is None else (np.asarray(tw.wp.hi), np.asarray(tw.wp.lo)),
        }

    arrays = {
        "leaf": {
            k: {"planes": _np_tables(v)[0], "corr": _np_tables(v)[1]}
            for k, v in jpt.leaf.items()
        },
        "split_tw": {k: pair(v) for k, v in jpt.split_tw.items()},
        "split_tw_t": {k: pair(v) for k, v in jpt.split_tw_t.items()},
    }
    carried = interop.tables_from_numpy(plan, mod, fc, inverse, arrays, device="cpu")
    own = planner.PlanTables(plan, mod, fc, inverse, device="cpu")
    assert carried.leaf.keys() == own.leaf.keys()
    # JAX keeps the root's table transposed; the port, carried or built,
    # in its (m0, m1) layout, the root's included
    assert jpt.split_tw_t.keys() == {(256, 16)} and jpt.split_tw.keys() == {(16, 16)}
    assert carried.split_tw.keys() == own.split_tw.keys() == {(256, 16), (16, 16)}
    assert own.split_tw[(256, 16)].w.shape == (256, 16)
    for k in own.leaf:
        np.testing.assert_array_equal(carried.leaf[k].planes.numpy(), own.leaf[k].planes.numpy())
        np.testing.assert_array_equal(to_numpy(carried.leaf[k].corr), to_numpy(own.leaf[k].corr))
    for k, v in own.split_tw.items():
        c = carried.split_tw[k]
        np.testing.assert_array_equal(to_numpy(c.w), to_numpy(v.w))
        np.testing.assert_array_equal(to_numpy(c.wp), to_numpy(v.wp))
    x = from_numpy(rng.integers(0, N, 1 << 12, dtype=np.uint64))
    run = planner.run_inverse if inverse else planner.run_forward
    np.testing.assert_array_equal(to_numpy(run(x, plan, carried)), to_numpy(run(x, plan, own)))

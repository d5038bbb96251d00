"""PyTorch port, the Solinas engine (``modmul="solinas"``): the field layer
and the tables, bitwise against sventt_tpu.

The fold and the multiply run on JAX's corner values (0, 1, N - 1, N,
2^63, 2^64 - 1) and on random words, for the flagship modulus (eps =
1827 * 2^31 - 1) and Goldilocks (eps = 2^32 - 1, whose third fold takes
the other branch of the JAX limb chain); the stage tables, the inter-step
tables and the JAX tables carried across through ``interop`` are
companion-free and equal the JAX package's word for word.  Inputs are
made with numpy from a seed; the tolerance is zero.
"""

import jax
import numpy as np
import pytest

from sventt_tpu.field import limb as jlimb
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import ntt_pallas as jpal
from sventt_tpu.ops import twiddle as jtw
from sventt_tpu.plan import planner as jplanner
from sventt_tpu_torch import interop
from sventt_tpu_torch.field import limb
from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_pallas, twiddle
from sventt_tpu_torch.plan import planner

M64 = (1 << 64) - 1
MODULI = [
    pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, id="flagship"),
    pytest.param(GOLDILOCKS_MODULUS, 7, id="goldilocks"),
]
DIRECTIONS = pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])


def _fcs(N, g):
    jfc = jlimb.FieldConsts.from_modulus(JModulus(N, g), modmul="solinas")
    fc = FieldConsts.from_modulus(Modulus(N, g), modmul="solinas")
    assert (fc.lazy, fc.n_form, fc.n_c, fc.n_s) == (jfc.lazy, jfc.n_form, jfc.n_c, jfc.n_s)
    assert not fc.lazy and fc.n_form == "high"
    return jfc, fc


def _corner_words(N, rng, count):
    corner = np.array([0, 1, N - 1, N, 1 << 63, M64], dtype=np.uint64)
    return np.concatenate([corner, rng.integers(0, 1 << 64, count, dtype=np.uint64)])


@pytest.mark.parametrize("N,g", MODULI)
def test_reduce128_matches_jax(rng, N, g):
    """The fold of a 128-bit value gives JAX's u64 representative bit for
    bit (every fold is exact) and the residue of the value."""
    _, fc = _fcs(N, g)
    extra = np.array([2, 0xFFFF_FFFF, 1 << 32, M64 - 1, (2 * N) % (1 << 64)], dtype=np.uint64)
    his = np.concatenate([_corner_words(N, rng, 256), extra])
    los = np.concatenate([_corner_words(N, rng, 256)[::-1], extra[::-1]])
    want = u64_to_numpy(jax.jit(lambda h, l: jlimb.u64_reduce128_sparse_high(h, l, fc.n_c, fc.n_s))(
        u64_from_numpy(his), u64_from_numpy(los)))
    got = to_numpy(limb.u64_reduce128_sparse_high(from_numpy(his), from_numpy(los), fc.n_c, fc.n_s))
    np.testing.assert_array_equal(got, want)
    for h, l, r in zip(his, los, got):
        assert int(r) % N == ((int(h) << 64) | int(l)) % N


@pytest.mark.parametrize("N,g", MODULI)
def test_solinas_mul_matches_jax(rng, N, g):
    """solinas_mul(a, w) for any a < 2^64 and plain w < N (N - 1 among
    them): JAX's canonical result, a * w mod N."""
    jfc, fc = _fcs(N, g)
    a = np.tile(_corner_words(N, rng, 250), 2)
    w = rng.integers(0, N, a.size, dtype=np.uint64)
    w[: a.size // 2] = N - 1
    want = u64_to_numpy(jax.jit(jfc.solinas_mul)(u64_from_numpy(a), u64_from_numpy(w)))
    got = to_numpy(fc.solinas_mul(from_numpy(a), from_numpy(w)))
    np.testing.assert_array_equal(got, want)
    assert (got < np.uint64(N)).all()
    assert [int(v) for v in got] == [int(x) * int(y) % N for x, y in zip(a, w)]
    # twiddle_mul dispatches to it and ignores a companion
    np.testing.assert_array_equal(to_numpy(fc.twiddle_mul(from_numpy(a), from_numpy(w), None)), got)


def test_solinas_capable_matches_jax():
    for N in (FLAGSHIP_MODULUS, GOLDILOCKS_MODULUS, TEST_MODULUS, (1 << 64) - (1 << 40) + 1,
              (1 << 64) - 59):
        assert limb.solinas_capable(N) == jlimb.solinas_capable(N), hex(N)
    assert limb.solinas_capable(FLAGSHIP_MODULUS) and not limb.solinas_capable(TEST_MODULUS)


@pytest.mark.parametrize("N,g", MODULI)
def test_solinas_butterflies_match_jax(rng, N, g):
    """The radix-2 butterflies with plain twiddles and no companion (the
    last inverse one with the 1/m scale), against JAX's."""
    jfc, fc = _fcs(N, g)
    a, b, w, s = (rng.integers(0, N, 256, dtype=np.uint64) for _ in range(4))
    ja, jb, jw, js = (u64_from_numpy(v) for v in (a, b, w, s))
    pa, pb, pw, ps = (from_numpy(v) for v in (a, b, w, s))
    cases = [
        (fc.butterfly_forward(pa, pb, pw, None), jfc.butterfly_forward(ja, jb, jw, None)),
        (fc.butterfly_inverse(pa, pb, pw, None), jfc.butterfly_inverse(ja, jb, jw, None)),
        (fc.butterfly_inverse_scaled(pa, pb, ps, None, pw, None),
         jfc.butterfly_inverse_scaled(ja, jb, js, None, jw, None)),
    ]
    for got, want in cases:
        for gv, wv in zip(got, want):
            np.testing.assert_array_equal(to_numpy(gv), u64_to_numpy(wv))


@DIRECTIONS
@pytest.mark.parametrize("N,g", MODULI)
def test_stage_tables_match_jax(N, g, inverse):
    """Companion-free stage tables (the inverse scale included) equal
    JAX's plain values."""
    mod, jmod, m = Modulus(N, g), JModulus(N, g), 16
    if inverse:
        got = twiddle.inverse_tables(mod, m, 3, modmul="solinas", device="cpu")
        want = jtw.inverse_tables(jmod, m, 3, modmul="solinas")
        assert got.scale.wp is None and want.scale.wp is None
        np.testing.assert_array_equal(to_numpy(got.scale.w), u64_to_numpy(want.scale.w))
    else:
        got = twiddle.forward_tables(mod, m, modmul="solinas", device="cpu")
        want = jtw.forward_tables(jmod, m, modmul="solinas")
    assert len(got.stages) == len(want.stages)
    for gp, wp in zip(got.stages, want.stages):
        assert gp.wp is None and wp.wp is None
        np.testing.assert_array_equal(to_numpy(gp.w), u64_to_numpy(wp.w))


@DIRECTIONS
@pytest.mark.parametrize("device_built", [False, True], ids=["host", "device"])
def test_row_twiddles_match_jax(monkeypatch, inverse, device_built):
    """planner.row_twiddles under Solinas: plain values, companion-free
    whatever ``w_only`` says, natural and transposed (the mxu root's),
    from the host recurrence and from the device generator."""
    if device_built:
        monkeypatch.setattr(planner, "DEVICE_TWIDDLE_THRESHOLD", 1 << 6)
        monkeypatch.setattr(jplanner, "DEVICE_TWIDDLE_THRESHOLD", 1 << 6)
    mod, jmod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR), JModulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    for transposed in (False, True):
        kw = dict(inverse=inverse, w_only=False, modmul="solinas", transposed=transposed)
        got = planner.row_twiddles(mod, 16, 32, device="cpu", **kw)
        want = jplanner.row_twiddles(jmod, 16, 32, **kw)
        assert got.wp is None and want.wp is None
        np.testing.assert_array_equal(to_numpy(got.w), u64_to_numpy(want.w))
    # Montgomery tables (the distributed inter-step) times a Solinas fc
    # come out times 2^64: the multiply must take a Montgomery fc
    fc = FieldConsts.from_modulus(mod, modmul="solinas")
    x = from_numpy(np.full((16, 32), 5, dtype=np.uint64))
    mont = planner.row_twiddles(mod, 16, 32, inverse=inverse, device="cpu")
    plain = planner.row_twiddles(mod, 16, 32, inverse=inverse, modmul="solinas", device="cpu")
    right = twiddle.inter_step_mul(FieldConsts.from_modulus(mod), x, mont)
    np.testing.assert_array_equal(to_numpy(twiddle.inter_step_mul(fc, x, plain)), to_numpy(right))
    wrong = to_numpy(twiddle.inter_step_mul(fc, x, mont))
    R = mod.montgomery_r
    assert [int(v) for v in wrong.ravel()[:8]] == [int(v) * R % mod.modulus for v in to_numpy(right).ravel()[:8]]


def _np_pair(pair):
    if pair is None:
        return None
    return {"w": tuple(np.asarray(a) for a in pair.w),
            "wp": None if pair.wp is None else tuple(np.asarray(a) for a in pair.wp)}


@DIRECTIONS
@pytest.mark.parametrize("N,g", MODULI)
def test_interop_stage_tables(N, g, inverse):
    """The JAX package's 2-channel Solinas leaf and lane tables carried
    across equal the port's compact, companion-free tables, and JAX's
    max_r=3 request under Solinas is radix-2 in both packages."""
    mod, jmod, m = Modulus(N, g), JModulus(N, g), 16
    jleaf = jpal.make_leaf_tables(jmod, m, inverse=inverse, modmul="solinas", max_r=3)
    jlane = jpal.make_lane_tables(jmod, m, inverse=inverse, modmul="solinas", max_r=3)
    assert isinstance(jleaf, jpal.FusedDirection) and np.asarray(jlane.tw).shape[1] == 2
    leaf = dict(stage_ls=jleaf.stage_ls, tw=[[np.asarray(a) for a in st] for st in jleaf.tw],
                scale=[np.asarray(a) for a in jleaf.scale])
    lane = dict(stage_ls=jlane.stage_ls, tw=np.asarray(jlane.tw), scale_scalar=jlane.scale_scalar)
    carried = [
        interop.fused_direction_from_numpy(m, inverse, "solinas", **leaf, device="cpu"),
        interop.lane_direction_from_numpy(m, inverse, "solinas", **lane, device="cpu"),
    ]
    own = [
        ntt_pallas.make_leaf_tables(mod, m, inverse=inverse, modmul="solinas", max_r=3, device="cpu"),
        ntt_pallas.make_lane_tables(mod, m, inverse=inverse, modmul="solinas", max_r=3, device="cpu"),
    ]
    for c, o in zip(carried, own):
        assert (c.m, c.inverse, c.modmul, c.stage_ls, c.scale) == (o.m, o.inverse, o.modmul, o.stage_ls, o.scale)
        assert c.wp is None and o.wp is None
        np.testing.assert_array_equal(to_numpy(c.w), to_numpy(o.w))
    assert own[1].scale == (jlane.scale_scalar if inverse else None)
    with pytest.raises(ValueError, match="4 arrays"):
        interop.fused_direction_from_numpy(m, inverse, "montgomery", **leaf, device="cpu")


@DIRECTIONS
@pytest.mark.parametrize("engine", ["mxu", "pallas"])
def test_interop_plan_tables(rng, engine, inverse):
    """A whole JAX PlanTables of a Solinas plan carried across (leaf and
    lane tables, plain inner and root inter-step tables, the mxu root's
    transposed) equals the port's and drives the same transform."""
    from sventt_tpu.plan import NTT as JNTT
    from sventt_tpu.plan import NttConfig as JNttConfig
    from sventt_tpu_torch.plan import NTT, NttConfig

    n, kw = 1 << 12, dict(engine=engine, modmul="solinas", max_fused=16)
    jntt = JNTT(JNttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, **kw), enable_forward=not inverse,
                enable_inverse=inverse)
    ntt = NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, **kw), device="cpu")
    jt = jntt._inv_tables if inverse else jntt._fwd_tables
    own = ntt._inv_tables if inverse else ntt._fwd_tables
    arrays = {"leaf": {}, "lane": {}}
    for key, t in jt.leaf.items():
        if key[1] == "mxu":
            arrays["leaf"][key] = {"planes": np.asarray(t.planes), "corr": tuple(np.asarray(a) for a in t.corr)}
        else:
            arrays["leaf"][key] = dict(stage_ls=t.stage_ls, tw=[[np.asarray(a) for a in st] for st in t.tw],
                                       scale=[np.asarray(a) for a in t.scale])
    for m1, t in jt.lane.items():
        arrays["lane"][m1] = dict(stage_ls=t.stage_ls, tw=np.asarray(t.tw), scale_scalar=t.scale_scalar)
    for name in ("split_tw", "split_tw_t"):
        arrays[name] = {k: _np_pair(v) for k, v in getattr(jt, name).items()}
    carried = interop.tables_from_numpy(ntt.plan, ntt.mod, ntt.fc, inverse, arrays, device="cpu")
    assert carried.split_tw.keys() == own.split_tw.keys() and carried.split_tw_t.keys() == own.split_tw_t.keys()
    assert (engine == "mxu") == bool(own.split_tw_t)
    for name in ("split_tw", "split_tw_t"):
        for k, v in getattr(own, name).items():
            assert v.wp is None and getattr(carried, name)[k].wp is None
            np.testing.assert_array_equal(to_numpy(getattr(carried, name)[k].w), to_numpy(v.w))
    x = from_numpy(rng.integers(0, FLAGSHIP_MODULUS, n, dtype=np.uint64))
    run = planner.run_inverse if inverse else planner.run_forward
    np.testing.assert_array_equal(to_numpy(run(x, ntt.plan, carried)), to_numpy(run(x, ntt.plan, own)))

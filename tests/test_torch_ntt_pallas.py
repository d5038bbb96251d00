"""PyTorch port, the radix-2 leaf kernel (K4), the s8 lane kernel (K3) and
the butterfly tables: the plain versions bitwise against sventt_tpu.ops.
The mid and lane butterfly kernels (K5, K6) are in
test_torch_ntt_pallas_rows.py.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_ntt_pallas.py and tests/test_ntt_mid.py do.  Inputs are made
with numpy from a seed and hold an N-1 column.  The tolerance is zero: the
outputs are compared bit for bit BEFORE normalize (lazy representatives
included) and after it.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import ntt_mxu as jmxu
from sventt_tpu.ops import ntt_pallas as jpal
from sventt_tpu.ops.twiddle import MontPair as JMontPair
from sventt_tpu_torch import interop
from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_mxu, ntt_pallas
from sventt_tpu_torch.ops.twiddle import MontPair

# (modulus, generator, stage-multiply engine): the 64-bit flagship runs
# canonical Montgomery; the 62-bit test modulus runs lazy, both engines
ENGINES = [
    pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "montgomery", id="flagship"),
    pytest.param(TEST_MODULUS, TEST_GENERATOR, "montgomery", id="test62-mont"),
    pytest.param(TEST_MODULUS, TEST_GENERATOR, "shoup", id="test62-shoup"),
]
DIRECTIONS = pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])


def _setup(N, g, modmul):
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jfc = JFieldConsts.from_modulus(jmod, modmul=modmul)
    fc = FieldConsts.from_modulus(mod, modmul=modmul)
    assert (fc.lazy, fc.modmul) == (jfc.lazy, jfc.modmul)
    return jmod, mod, jfc, fc


def _data(rng, N, shape, axis):
    """Random residues of ``shape`` with index 1 along ``axis`` set to N-1."""
    x = rng.integers(0, N, shape, dtype=np.uint64)
    idx = [slice(None)] * len(shape)
    idx[axis] = 1
    x[tuple(idx)] = N - 1
    return x


def _twiddles(rng, N, shape, mode):
    """Random inter-step twiddles: (w, wp) for "pair", (w, None) for "w"."""
    w = rng.integers(0, N, shape, dtype=np.uint64)
    if mode == "w":
        return w, None
    with np.errstate(over="ignore"):
        return w, w * np.uint64(pow(N, -1, 1 << 64))


def _jax_pair(w, wp):
    return JMontPair(u64_from_numpy(w), None if wp is None else u64_from_numpy(wp))


def _port_pair(w, wp):
    return MontPair(from_numpy(w), None if wp is None else from_numpy(wp))


def _assert_same(got, want, jfc, fc, what=""):
    """Bitwise before normalize and after it."""
    np.testing.assert_array_equal(to_numpy(got), u64_to_numpy(want), err_msg=what)
    np.testing.assert_array_equal(
        to_numpy(fc.normalize(got)), u64_to_numpy(jfc.normalize(want)), err_msg=what
    )


def _np_fused(t):
    """A JAX FusedDirection's arrays as numpy, in interop's layout."""
    return dict(
        stage_ls=t.stage_ls,
        tw=[[np.asarray(a) for a in stage] for stage in t.tw],
        scale=[np.asarray(a) for a in t.scale],
    )


def _np_lane(t):
    return dict(stage_ls=t.stage_ls, tw=np.asarray(t.tw), scale_scalar=t.scale_scalar)


@pytest.mark.parametrize(
    "N,g,modmul,inverse,m",
    [pytest.param(*e.values, inv, 8, id=f"{e.id}-{d}-8") for e in ENGINES
     for inv, d in ((False, "fwd"), (True, "inv"))]
    + [
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "montgomery", False, 64,
                     id="flagship-fwd-64"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, "shoup", True, 64, id="test62-shoup-inv-64"),
    ],
)
def test_fused_ntt_matches_jax(rng, N, g, modmul, inverse, m):
    """K4: leaf along axis 0 of (m, 3).  m = 64 on two engines only: the
    JAX kernel takes ~20 s to trace in interpret mode at that length."""
    jmod, mod, jfc, fc = _setup(N, g, modmul)
    jt = jpal.make_leaf_tables(jmod, m, inverse=inverse, modmul=modmul)
    pt = ntt_pallas.make_leaf_tables(mod, m, inverse=inverse, modmul=modmul, device="cpu")
    x = _data(rng, N, (m, 3), 1)
    want = jpal.fused_ntt(u64_from_numpy(x), jt, jfc)
    _assert_same(ntt_pallas.fused_ntt(from_numpy(x), pt, fc), want, jfc, fc)


def test_lane_and_leaf_sequences_differ_only_in_bits(rng):
    """With a lazy modulus K6's forward (difference reduced first) and K4's
    (difference biased by +2N) give the same residues, and the port keeps
    each kernel's own bits: some points differ by exactly N."""
    N, g = TEST_MODULUS, TEST_GENERATOR
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(mod)
    assert fc.lazy
    x = rng.integers(0, 2 * N, (256, 64), dtype=np.uint64)
    leaf = ntt_pallas.make_leaf_tables(mod, 64, inverse=False, device="cpu")
    lane = ntt_pallas.make_lane_tables(mod, 64, inverse=False, device="cpu")
    by_leaf = ntt_pallas.fused_ntt(from_numpy(x).t().contiguous(), leaf, fc).t()
    by_lane = ntt_pallas.fused_ntt_lane(from_numpy(x), lane, fc)
    a, b = to_numpy(by_leaf), to_numpy(by_lane)
    diff = a != b
    assert diff.any()
    assert {abs(int(p) - int(q)) for p, q in zip(a[diff], b[diff])} == {N}
    np.testing.assert_array_equal(to_numpy(fc.normalize(by_leaf)), to_numpy(fc.normalize(by_lane)))


@pytest.mark.parametrize("m", [8, 64])
@DIRECTIONS
def test_mxu_ntt_lane_matches_jax(rng, inverse, m):
    """K3: the s8 matrix NTT along the last axis of (5, m) rows (ragged
    against the JAX kernel's 32-row blocks), on both moduli."""
    for N, g in ((FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR), (TEST_MODULUS, TEST_GENERATOR)):
        jmod, mod = JModulus(N, g), Modulus(N, g)
        jfc, fc = JFieldConsts.from_modulus(jmod), FieldConsts.from_modulus(mod)
        jt = jmxu.make_mxu_tables(jmod, m, inverse=inverse)
        pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, device="cpu")
        x = _data(rng, N, (5, m), 0)
        ntt_mxu.reset_counts()
        got = ntt_mxu.mxu_ntt_lane(from_numpy(x), pt, fc)
        assert ntt_mxu.PLAIN_CALLS["lane"] == 1 and ntt_mxu.LAUNCHES["lane"] == 0
        _assert_same(got, jmxu.mxu_ntt_lane(u64_from_numpy(x), jt, jfc), jfc, fc, hex(N))
        # the lane orientation is the lead orientation on the transposed rows
        lead = ntt_mxu.mxu_ntt(from_numpy(x).t().contiguous(), pt, fc).t()
        np.testing.assert_array_equal(to_numpy(got), to_numpy(lead))


@DIRECTIONS
@pytest.mark.parametrize("tw_layout", ["tiled", "dedup"])
@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_tables_carried_from_jax(N, g, modmul, tw_layout, inverse):
    """The JAX package's pre-broadcast leaf and lane tables, carried across
    through interop, equal the port's compact tables."""
    jmod, mod, _, _ = _setup(N, g, modmul)
    m = 32
    jleaf = jpal.make_leaf_tables(jmod, m, inverse=inverse, modmul=modmul, tw_layout=tw_layout)
    jlane = jpal.make_lane_tables(jmod, m, inverse=inverse, modmul=modmul)
    carried = [
        interop.fused_direction_from_numpy(m, inverse, modmul, **_np_fused(jleaf), device="cpu"),
        interop.lane_direction_from_numpy(m, inverse, modmul, **_np_lane(jlane), device="cpu"),
    ]
    own = [
        ntt_pallas.make_leaf_tables(mod, m, inverse=inverse, modmul=modmul, device="cpu"),
        ntt_pallas.make_lane_tables(mod, m, inverse=inverse, modmul=modmul, device="cpu"),
    ]
    for c, o in zip(carried, own):
        assert (c.m, c.inverse, c.modmul, c.stage_ls, c.scale) == (
            o.m, o.inverse, o.modmul, o.stage_ls, o.scale
        )
        np.testing.assert_array_equal(to_numpy(c.w), to_numpy(o.w))
        np.testing.assert_array_equal(to_numpy(c.wp), to_numpy(o.wp))
    assert own[1].scale == (jlane.scale_scalar if inverse else None)


def test_jax_tables_drive_port_kernels(rng):
    """JAX-built tables carried across run the port's plain kernels to the
    JAX kernels' output."""
    N, g, modmul = TEST_MODULUS, TEST_GENERATOR, "shoup"
    jmod, mod, jfc, fc = _setup(N, g, modmul)
    jt = jpal.make_leaf_tables(jmod, 16, inverse=True, modmul=modmul)
    pt = interop.fused_direction_from_numpy(16, True, modmul, **_np_fused(jt), device="cpu")
    x = _data(rng, N, (16, 3), 1)
    want = jpal.fused_ntt(u64_from_numpy(x), jt, jfc)
    _assert_same(ntt_pallas.fused_ntt(from_numpy(x), pt, fc), want, jfc, fc)


def test_stage_split_and_counts(rng):
    """stages_per_call and block_b do not change a result; CPU tensors
    count plain calls, never launches."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    x = from_numpy(_data(rng, mod.modulus, (64, 6), 1))
    one = ntt_pallas.make_leaf_tables(mod, 64, inverse=True, device="cpu")
    split = ntt_pallas.make_leaf_tables(mod, 64, inverse=True, spc=4, block_b=2, device="cpu")
    ntt_pallas.reset_counts()
    a, b = ntt_pallas.fused_ntt(x, one, fc), ntt_pallas.fused_ntt(x, split, fc)
    np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    np.testing.assert_array_equal(to_numpy(ntt_pallas.leaf_plain(x, one, fc)), to_numpy(a))
    assert ntt_pallas.PLAIN_CALLS == {"leaf": 2, "mid": 0, "lane": 0, "grouped": 0,
                                      "lane_grouped": 0}
    assert not any(ntt_pallas.LAUNCHES.values())


def test_unported_and_bad_arguments_raise():
    """max_r > 1 gives the grouped tables (ported, see
    test_torch_ntt_grouped.py), except under Solinas, which forces radix-2
    companion-free tables as in JAX (grouped tables cannot take it); bad
    knobs raise."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    grouped = ntt_pallas.make_leaf_tables(mod, 16, inverse=False, max_r=3, device="cpu")
    assert isinstance(grouped, ntt_pallas.GroupedDirection)
    assert [s.R for s in grouped.specs] == [2, 2]  # 4 stages: 2 + 2, not 3 + 1
    lane = ntt_pallas.make_lane_tables(mod, 16, inverse=False, max_r=2, device="cpu")
    assert isinstance(lane, ntt_pallas.GroupedLaneDirection)
    assert [s.R for s in lane.specs] == [2, 2]
    for build in (ntt_pallas.make_leaf_tables, ntt_pallas.make_lane_tables):
        sol = build(mod, 16, inverse=True, modmul="solinas", max_r=3, device="cpu")
        assert type(sol) in (ntt_pallas.FusedDirection, ntt_pallas.LaneDirection)
        assert sol.wp is None and sol.scale[1] is None and sol.modmul == "solinas"
    with pytest.raises(ValueError, match="companioned"):
        ntt_pallas.make_grouped_forward(mod, 16, modmul="solinas", max_r=3, device="cpu")
    with pytest.raises(ValueError):
        ntt_pallas.make_leaf_tables(mod, 16, inverse=False, tw_layout="diagonal", device="cpu")
    with pytest.raises(ValueError):
        ntt_pallas.make_leaf_tables(mod, 12, inverse=False, device="cpu")
    with pytest.raises(ValueError):
        ntt_pallas.make_lane_tables(mod, 16, inverse=False, rows=3, device="cpu")
    t = ntt_pallas.make_leaf_tables(mod, 16, inverse=False, device="cpu")
    with pytest.raises(ValueError):
        ntt_pallas.fused_ntt(from_numpy(np.zeros((8, 2), np.uint64)), t, fc)
    with pytest.raises(ValueError):
        ntt_pallas.fused_ntt_mid(from_numpy(np.zeros((2, 8, 2), np.uint64)), t, fc)

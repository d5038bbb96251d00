"""PyTorch port, the radix-2^R grouped leaf kernel (K7) and the group
structure: the plain version bitwise against sventt_tpu.ops.ntt_pallas.
The grouped lane kernel (K8) and K7 at m = 32 are in
test_torch_ntt_grouped_lane.py, the grouped transform as a whole in
test_torch_ntt_grouped_plan.py: separate files, so that ``--dist
loadfile`` gives each its own worker and each stays under a minute.

The JAX side runs its Pallas kernels in interpret mode (one kernel per
group, 5-8 s to trace at m <= 16 and ~20 s at m = 32, so JAX is called at
m <= 32 only, and each distinct group spec once per engine; larger m are
held against GoldenNTT).  Inputs are made with numpy from a seed and hold
an N-1 column; the tolerance is zero, before normalize and after it.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import u64_from_numpy
from sventt_tpu.ops import ntt_pallas as jpal
from sventt_tpu_torch import interop
from sventt_tpu_torch.field.golden import GoldenNTT
from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_pallas
from test_torch_ntt_pallas import DIRECTIONS, ENGINES, _assert_same, _data, _setup

FLAG = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "montgomery")
MONT = (TEST_MODULUS, TEST_GENERATOR, "montgomery")
SHOUP = (TEST_MODULUS, TEST_GENERATOR, "shoup")


def _specs_as_tuples(specs):
    return [(s.ls, s.L, s.span, s.consts, s.scaled) for s in specs]


def test_choose_groups_matches_jax():
    for stages in range(1, 13):
        for max_r in range(1, 5):
            assert ntt_pallas._choose_groups(stages, max_r) == jpal._choose_groups(stages, max_r)
    assert ntt_pallas._choose_groups(8, 3) == (3, 3, 2)
    assert ntt_pallas._choose_groups(8, 4) == (4, 2, 2)
    for k in range(12):
        assert ntt_pallas._bitrev(k, 4) == jpal._bitrev(k, 4)


@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_group_specs_and_values_match_jax(N, g, modmul):
    """GroupSpec fields, constants and combined-table values, both
    directions, every max_r, scale_extra included."""
    jmod, mod, _, _ = _setup(N, g, modmul)
    for m in (2, 8, 32, 256):
        for max_r in (2, 3, 4):
            want = jpal._forward_group_values(jmod, m, modmul, max_r)
            got = ntt_pallas._forward_group_values(mod, m, modmul, max_r)
            assert _specs_as_tuples(got[0]) == _specs_as_tuples(want[0])
            assert got[1] == want[1]
            for extra in (1, 7):
                want = jpal._inverse_group_values(jmod, m, modmul, extra, max_r)
                got = ntt_pallas._inverse_group_values(mod, m, modmul, extra, max_r)
                assert _specs_as_tuples(got[0]) == _specs_as_tuples(want[0])
                assert got[1] == want[1]


# (engine, m, max_r): each distinct group spec traces one JAX kernel per
# engine and direction; max_r = 4 at m = 8 and m = 16 gives the groups of
# max_r = 3 and 2 there, so it reuses their traces
CASES = [
    *[pytest.param(*e, 8, r, id=f"{name}-8-r{r}")
      for e, name in ((FLAG, "flagship"), (MONT, "test62-mont"), (SHOUP, "test62-shoup"))
      for r in (3, 4)],
    pytest.param(*SHOUP, 16, 2, id="test62-shoup-16-r2"),
    pytest.param(*SHOUP, 16, 4, id="test62-shoup-16-r4"),
]


@pytest.mark.parametrize("N,g,modmul,m,max_r", CASES)
@DIRECTIONS
def test_grouped_leaf_matches_jax(rng, N, g, modmul, m, max_r, inverse):
    """K7: leaf along axis 0 of (m, 3), against JAX fused_ntt on its
    grouped tables (one pallas_call per group)."""
    jmod, mod, jfc, fc = _setup(N, g, modmul)
    jt = jpal.make_leaf_tables(jmod, m, inverse=inverse, modmul=modmul, max_r=max_r)
    pt = ntt_pallas.make_leaf_tables(
        mod, m, inverse=inverse, modmul=modmul, max_r=max_r, device="cpu"
    )
    assert isinstance(pt, ntt_pallas.GroupedDirection)
    assert _specs_as_tuples(pt.specs) == _specs_as_tuples(jt.specs)
    x = _data(rng, N, (m, 3), 1)
    want = jpal.fused_ntt(u64_from_numpy(x), jt, jfc)
    ntt_pallas.reset_counts()
    got = ntt_pallas.fused_ntt(from_numpy(x), pt, fc)
    assert ntt_pallas.PLAIN_CALLS["grouped"] == 1 and not any(ntt_pallas.LAUNCHES.values())
    _assert_same(got, want, jfc, fc)
    np.testing.assert_array_equal(to_numpy(ntt_pallas.grouped_plain(from_numpy(x), pt, fc)),
                                  to_numpy(got))


def test_grouped_inverse_scale_extra_matches_jax(rng):
    """The inverse with scale_extra folded into the last group's table."""
    jmod, mod, jfc, fc = _setup(*SHOUP)
    jt = jpal.make_grouped_inverse(jmod, 16, scale_extra=5, modmul="shoup", max_r=2)
    pt = ntt_pallas.make_grouped_inverse(mod, 16, scale_extra=5, modmul="shoup", max_r=2,
                                         device="cpu")
    assert pt.specs[-1].scaled and not pt.specs[0].scaled
    x = _data(rng, TEST_MODULUS, (16, 3), 1)
    _assert_same(ntt_pallas.fused_ntt(from_numpy(x), pt, fc),
                 jpal.fused_ntt(u64_from_numpy(x), jt, jfc), jfc, fc)


@pytest.mark.parametrize("N,g,modmul", ENGINES)
@pytest.mark.parametrize("m", [64, 256])
def test_grouped_leaf_matches_golden(rng, N, g, modmul, m):
    """K7's plain version at sizes where the JAX kernel is too slow to
    trace: the forward equals GoldenNTT mod N, the inverse returns the
    input exactly, for every max_r."""
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(mod, modmul=modmul)
    golden = GoldenNTT(m, mod)
    x = _data(rng, N, (m, 2), 1)
    for max_r in (2, 3, 4):
        kw = dict(modmul=modmul, max_r=max_r, device="cpu")
        fwd = ntt_pallas.fused_ntt(
            from_numpy(x), ntt_pallas.make_leaf_tables(mod, m, inverse=False, **kw), fc
        )
        out = to_numpy(fc.normalize(fwd))
        for c in range(2):
            assert [int(v) for v in out[:, c]] == golden.forward([int(v) for v in x[:, c]])
        back = ntt_pallas.fused_ntt(fwd, ntt_pallas.make_leaf_tables(mod, m, inverse=True, **kw), fc)
        np.testing.assert_array_equal(to_numpy(fc.normalize(back)), x)


@DIRECTIONS
def test_leaf_and_lane_grouped_differ_only_in_bits(rng, inverse):
    """With a lazy modulus K7 (difference biased by +2N where a constant
    follows; no table multiply where the combined exponent is 0) and K8
    (difference reduced; every point multiplied) give the same residues,
    and the port keeps each kernel's own bits: some points differ by
    exactly N."""
    N, g = TEST_MODULUS, TEST_GENERATOR
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(mod)
    assert fc.lazy
    x = rng.integers(0, 2 * N, (256, 64), dtype=np.uint64)
    kw = dict(inverse=inverse, max_r=3, device="cpu")
    leaf = ntt_pallas.make_leaf_tables(mod, 64, **kw)
    lane = ntt_pallas.make_lane_tables(mod, 64, **kw)
    by_leaf = ntt_pallas.fused_ntt(from_numpy(x).t().contiguous(), leaf, fc).t()
    by_lane = ntt_pallas.fused_ntt_lane(from_numpy(x), lane, fc)
    a, b = to_numpy(by_leaf), to_numpy(by_lane)
    diff = a != b
    assert diff.any()
    assert {abs(int(p) - int(q)) for p, q in zip(a[diff], b[diff])} == {N}
    np.testing.assert_array_equal(to_numpy(fc.normalize(by_leaf)), to_numpy(fc.normalize(by_lane)))


@DIRECTIONS
@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_grouped_tables_carried_from_jax(N, g, modmul, inverse):
    """The JAX package's pre-broadcast grouped leaf and lane tables,
    carried across through interop, equal the port's compact tables, and
    the constant tensor holds the specs' constants."""
    jmod, mod, _, _ = _setup(N, g, modmul)
    m = 32
    jleaf = jpal.make_leaf_tables(jmod, m, inverse=inverse, modmul=modmul, max_r=3)
    jlane = jpal.make_lane_tables(jmod, m, inverse=inverse, modmul=modmul, max_r=3)
    carried = [
        interop.grouped_direction_from_numpy(
            m, inverse, modmul, jleaf.specs, [[np.asarray(a) for a in grp] for grp in jleaf.tw],
            device="cpu",
        ),
        interop.grouped_lane_direction_from_numpy(
            m, inverse, modmul, jlane.specs, np.asarray(jlane.tw), device="cpu"
        ),
    ]
    kw = dict(inverse=inverse, modmul=modmul, max_r=3, device="cpu")
    own = [ntt_pallas.make_leaf_tables(mod, m, **kw), ntt_pallas.make_lane_tables(mod, m, **kw)]
    for c, o in zip(carried, own):
        assert type(c) is type(o)
        assert _specs_as_tuples(c.specs) == _specs_as_tuples(o.specs)
        for name in ("w", "wp", "consts", "const_mask"):
            np.testing.assert_array_equal(getattr(c, name).numpy(), getattr(o, name).numpy())
    spec = own[0].specs[0]
    for s, row in enumerate(spec.consts):
        for low, pair in enumerate(row):
            assert bool(own[0].const_mask[0, s, low]) == (pair is not None)
            if pair is not None:
                assert [int(v) for v in to_numpy(own[0].consts[0, s, low])] == list(pair)


def test_grouped_arguments():
    """The knobs are validated as for per-stage tables; max_r above 4 and
    grouped tables in the mid orientation are refused."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    with pytest.raises(ValueError):
        ntt_pallas.make_leaf_tables(mod, 16, inverse=False, max_r=3, block_b=3, device="cpu")
    with pytest.raises(ValueError):
        ntt_pallas.make_lane_tables(mod, 16, inverse=False, max_r=3, rows=3, device="cpu")
    with pytest.raises(ValueError):
        ntt_pallas.make_grouped_forward(mod, 64, max_r=5, device="cpu")
    with pytest.raises(ValueError):
        ntt_pallas.make_leaf_tables(mod, 12, inverse=False, max_r=2, device="cpu")
    t = ntt_pallas.make_leaf_tables(mod, 16, inverse=False, max_r=3, block_b=64, spc=2,
                                    tw_layout="dedup", device="cpu")
    bare = ntt_pallas.make_leaf_tables(mod, 16, inverse=False, max_r=3, device="cpu")
    assert _specs_as_tuples(t.specs) == _specs_as_tuples(bare.specs)
    np.testing.assert_array_equal(t.w.numpy(), bare.w.numpy())
    with pytest.raises(TypeError, match="FusedDirection"):
        ntt_pallas.fused_ntt_mid(from_numpy(np.zeros((2, 16, 3), np.uint64)), t, fc)
    with pytest.raises(ValueError):
        ntt_pallas.fused_ntt(from_numpy(np.zeros((8, 2), np.uint64)), t, fc)

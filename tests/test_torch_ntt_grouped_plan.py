"""PyTorch port, the grouped butterfly slice as a whole:
NTT(engine="pallas", max_r > 1) against sventt_tpu's NTT with the same
config.  Split levels whose row is a subtree (the transpose fallback at
the root) are in test_torch_transpose.py.

The JAX side runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions (``device="cpu"``).  Inputs are made with numpy
from a seed.  Outputs are compared bit for bit (tolerance zero), and the
roundtrip must return the input exactly.  ``max_fused=8`` keeps every JAX
grouped leaf at m <= 8, where it traces in seconds.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu.plan import planner as jplanner
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
from sventt_tpu_torch.ops import inter_step, ntt_pallas, transpose
from sventt_tpu_torch.plan import NTT, NttConfig, planner
from test_torch_ntt_grouped import _specs_as_tuples


def _reset():
    for mod in (ntt_pallas, inter_step, transpose):
        mod.reset_counts()


@pytest.mark.parametrize(
    "N,g,log2n,kw",
    [
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 9, dict(max_r=3), id="flagship-2^9-r3"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, 9, dict(max_r=3, modmul="shoup"),
                     id="test62-shoup-2^9-r3"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, 10, dict(max_r=2), id="test62-mont-2^10-r2"),
    ],
)
def test_grouped_ntt_matches_jax(rng, N, g, log2n, kw):
    """Three or four levels: the K7 column leaf, the inner rows by the
    transpose fallback (inter-step multiply, transpose, K7, transpose) and
    the K8 lane root all run; describe() is the JAX text, its "mid-axis"
    line for the fallback rows included."""
    n = 1 << log2n
    cfg = dict(engine="pallas", max_fused=8, **kw)
    ref = JNTT(JNttConfig(N, g, n, **cfg))
    ntt = NTT(NttConfig(N, g, n, **cfg), device="cpu")
    assert repr(ntt.plan) == repr(ref.plan)
    assert ntt.fc.modmul == ref.fc.modmul == kw.get("modmul", "montgomery")
    for batched in (False, True):
        assert ntt.describe(batched).splitlines() == ref.describe(batched).splitlines()
    x = rng.integers(0, N, n, dtype=np.uint64)
    x[1] = N - 1
    _reset()
    for run, jrun in ((ntt.compute_forward, ref.compute_forward),
                      (ntt.compute_inverse, ref.compute_inverse)):
        got = run(from_numpy(x))
        want = jrun(u64_from_numpy(x))
        np.testing.assert_array_equal(to_numpy(got), u64_to_numpy(want))
    plain = ntt_pallas.PLAIN_CALLS
    assert plain["grouped"] > 0 and plain["lane_grouped"] == 2, plain
    assert plain["leaf"] == plain["mid"] == plain["lane"] == 0, plain
    assert inter_step.PLAIN_CALLS["inter_step"] > 0
    assert not any(ntt_pallas.LAUNCHES.values()) and not inter_step.LAUNCHES["inter_step"]
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


@pytest.mark.parametrize(
    "N,g", [(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR), (TEST_MODULUS, TEST_GENERATOR)],
    ids=["flagship", "test62"],
)
def test_grouped_ntt_max_r4_matches_golden(rng, N, g):
    """max_r = 4 differs from 3 only from m = 32 on (5 stages: groups 4 +
    1, not 3 + 2; 4 stages are 2 + 2 for both), where the JAX kernel is
    slow to trace: 2^10 = 32 x 32 with max_fused 32 (the m = 32 root row
    runs K8 on a vector and K7 by the fallback on a batch) against
    GoldenNTT, with an exact roundtrip."""
    n = 1 << 10
    ntt = NTT(NttConfig(N, g, n, engine="pallas", max_fused=32, max_r=4), device="cpu")
    assert [s.R for s in ntt._fwd_tables.lane[32].specs] == [4, 1]
    x = rng.integers(0, N, (n, 2), dtype=np.uint64)
    golden = GoldenNTT(n, ntt.mod)
    batched = to_numpy(ntt.normalize(ntt.compute_forward(from_numpy(x))))
    for c in range(2):
        fwd = ntt.forward_numpy(x[:, c].copy())
        assert [int(v) for v in fwd] == golden.forward([int(v) for v in x[:, c]])
        np.testing.assert_array_equal(batched[:, c], fwd)
        np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x[:, c])


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_interop_grouped_plan_tables(rng, inverse):
    """A JAX grouped PlanTables carried across through numpy equals the
    port's own and drives the port's transform to the same output."""
    N, g = TEST_MODULUS, TEST_GENERATOR
    jmod, mod = JModulus(N, g), Modulus(N, g)
    fc = FieldConsts.from_modulus(mod, modmul="shoup")
    plan = planner.build_plan(1 << 9, "pallas", 8)
    jplan = jplanner.build_plan(1 << 9, "pallas", 8)
    assert repr(plan) == repr(jplan)
    jpt = jplanner.PlanTables(jplan, jmod, JFieldConsts.from_modulus(jmod, modmul="shoup"),
                              inverse, max_r=3)

    def pair(tw):
        return {
            "w": (np.asarray(tw.w.hi), np.asarray(tw.w.lo)),
            "wp": None if tw.wp is None else (np.asarray(tw.wp.hi), np.asarray(tw.wp.lo)),
        }

    arrays = {
        "leaf": {k: dict(specs=v.specs, tw=[[np.asarray(a) for a in grp] for grp in v.tw])
                 for k, v in jpt.leaf.items()},
        "lane": {k: dict(specs=v.specs, tw=np.asarray(v.tw)) for k, v in jpt.lane.items()},
        "split_tw": {k: pair(v) for k, v in jpt.split_tw.items()},
        "split_tw_t": {k: pair(v) for k, v in jpt.split_tw_t.items()},
    }
    carried = interop.tables_from_numpy(plan, mod, fc, inverse, arrays, device="cpu")
    own = planner.PlanTables(plan, mod, fc, inverse, max_r=3, device="cpu")
    assert carried.device == own.device
    assert not jpt.split_tw_t  # a pallas root keeps the (m0, m1) layout
    for name in ("leaf", "lane", "split_tw"):
        assert getattr(carried, name).keys() == getattr(own, name).keys(), name
    for name in ("leaf", "lane"):
        for k, o in getattr(own, name).items():
            c = getattr(carried, name)[k]
            assert type(c) is type(o)
            assert isinstance(o, (ntt_pallas.GroupedDirection, ntt_pallas.GroupedLaneDirection))
            assert _specs_as_tuples(c.specs) == _specs_as_tuples(o.specs)
            for field in ("w", "wp", "consts", "const_mask"):
                np.testing.assert_array_equal(getattr(c, field).numpy(), getattr(o, field).numpy())
    x = from_numpy(rng.integers(0, N, 1 << 9, dtype=np.uint64))
    run = planner.run_inverse if inverse else planner.run_forward
    np.testing.assert_array_equal(to_numpy(run(x, plan, carried)), to_numpy(run(x, plan, own)))


def test_mid_orientation_rejects_grouped_tables():
    """The JAX planner never sends grouped tables to the mid kernel; the
    port's fused_ntt_mid refuses them, and a batched grouped row takes the
    fallback instead."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    ntt = NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 9, engine="pallas",
                        max_fused=8, max_r=3), device="cpu")
    t = ntt._fwd_tables.leaf[(8, "pallas")]
    assert isinstance(t, ntt_pallas.GroupedDirection)
    assert not planner._mid_row(ntt.plan.col, ntt._fwd_tables)
    with pytest.raises(TypeError):
        ntt_pallas.fused_ntt_mid(from_numpy(np.zeros((2, 8, 3), np.uint64)), t, ntt.fc)
    x = np.random.default_rng(3).integers(0, mod.modulus, (1 << 9, 2), dtype=np.uint64)
    _reset()
    got = ntt.normalize(ntt.compute_forward(from_numpy(x)))
    assert inter_step.PLAIN_CALLS["inter_step"] == 2 and ntt_pallas.PLAIN_CALLS["mid"] == 0
    for c in range(2):
        np.testing.assert_array_equal(to_numpy(got)[:, c], ntt.forward_numpy(x[:, c].copy()))

"""PyTorch port, the butterfly-engine slice as a whole: NTT(engine="pallas")
against sventt_tpu's NTT(engine="pallas").

The JAX side runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions (``device="cpu"``).  Inputs are made with numpy
from a seed.  Outputs are compared bit for bit (tolerance zero) before
normalize and after it, and the roundtrip must return the input exactly.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu.plan import planner as jplanner
from sventt_tpu.plan import wrapper as jwrapper
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
from sventt_tpu_torch.plan import NTT, NttConfig, planner, wrapper


@pytest.mark.parametrize(
    "N,g,log2n,kw",
    [
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 12, {}, id="flagship-2^12"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, 10, dict(modmul="shoup"), id="test62-shoup-2^10"),
    ],
)
def test_pallas_ntt_matches_jax(rng, N, g, log2n, kw):
    """Three levels (max_fused=16): the K4 leaf, a K5 mid row step and the
    K6 lane root step all run."""
    n = 1 << log2n
    cfg = dict(engine="pallas", max_fused=16, **kw)
    ref = JNTT(JNttConfig(N, g, n, **cfg))
    ntt = NTT(NttConfig(N, g, n, **cfg), device="cpu")
    assert repr(ntt.plan) == repr(ref.plan)
    assert isinstance(ntt.plan.col, planner.Split)
    assert ntt.fc.modmul == ref.fc.modmul == kw.get("modmul", "montgomery")
    for batched in (False, True):
        assert ntt.describe(batched).splitlines() == ref.describe(batched).splitlines()
    x = rng.integers(0, N, n, dtype=np.uint64)
    x[1] = N - 1
    ntt_pallas.reset_counts()
    for run, jrun in ((ntt.compute_forward, ref.compute_forward),
                      (ntt.compute_inverse, ref.compute_inverse)):
        got = run(from_numpy(x))
        want = jrun(u64_from_numpy(x))
        np.testing.assert_array_equal(to_numpy(got), u64_to_numpy(want))
    plain = ntt_pallas.PLAIN_CALLS
    assert all(plain[k] > 0 for k in ("leaf", "mid", "lane")), plain
    assert plain["grouped"] == plain["lane_grouped"] == 0, plain
    assert not any(ntt_pallas.LAUNCHES.values())
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


@pytest.mark.parametrize(
    "spec,log2n",
    [("pallas:16,mxu:16,mxu", 10), ("mxu:16,pallas:8,pallas", 9)],
)
def test_mixed_plan_spec_matches_golden(rng, spec, log2n):
    """Mixed engines in one tree: a pallas lane root over mxu levels, and an
    mxu root between transposes over a pallas mid step and leaf."""
    n = 1 << log2n
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, plan_spec=spec)
    ntt = NTT(cfg, device="cpu")
    x = rng.integers(0, cfg.modulus, n, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    golden = GoldenNTT(n, cfg.mod)
    assert [int(v) for v in fwd] == golden.forward([int(v) for v in x])
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


def test_resolve_modmul_matches_jax():
    for N, g in ((FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR), (TEST_MODULUS, TEST_GENERATOR)):
        for n in (1 << 10, 1 << 22, 1 << 24):
            for kw in ({}, dict(lazy=False), dict(modmul="montgomery")):
                if N == FLAGSHIP_MODULUS and "lazy" in kw:
                    continue
                got = wrapper._resolve_modmul(NttConfig(N, g, n, **kw))
                assert got == jwrapper._resolve_modmul(JNttConfig(N, g, n, **kw)), (N, n, kw)
    assert wrapper._resolve_modmul(NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 22)) == "shoup"


def test_mxu_output_does_not_depend_on_modmul(rng):
    """The matrix engine has no stage twiddles: Shoup, which ``auto`` picks
    for lazy moduli from 2^22 on, gives the Montgomery bits exactly."""
    n = 1 << 10
    x = from_numpy(rng.integers(0, TEST_MODULUS, n, dtype=np.uint64))
    outs = []
    for modmul in ("montgomery", "shoup"):
        ntt = NTT(NttConfig(TEST_MODULUS, TEST_GENERATOR, n, max_fused=16, modmul=modmul),
                  device="cpu")
        assert ntt.engine == "mxu" and ntt.fc.modmul == modmul
        outs.append((ntt.compute_forward(x), ntt.compute_inverse(x)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))


def test_knobs_and_batch(rng):
    """stages_per_call, block_b and lane_rows change launches, not values;
    a batched input takes the mid path at the root and equals the columns'
    transforms mod N (the lane root's lazy representatives differ from the
    mid step's, as in the JAX package)."""
    N, g, n = TEST_MODULUS, TEST_GENERATOR, 1 << 10
    base = NTT(NttConfig(N, g, n, engine="pallas", max_fused=16), device="cpu")
    tuned = NTT(NttConfig(N, g, n, engine="pallas", max_fused=16, stages_per_call=2,
                          block_b=4, lane_rows=2, tw_layout="dedup"), device="cpu")
    x = rng.integers(0, N, (n, 3), dtype=np.uint64)
    a = to_numpy(base.compute_forward(from_numpy(x)))
    np.testing.assert_array_equal(a, to_numpy(tuned.compute_forward(from_numpy(x))))
    assert base.describe(batched=True).splitlines()[0].endswith("mid-axis pallas m1=16 (no transposes)")
    a = to_numpy(base.normalize(from_numpy(a)))
    for c in range(3):
        np.testing.assert_array_equal(a[:, c], base.forward_numpy(x[:, c].copy()))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_interop_pallas_plan_tables(rng, inverse):
    """A JAX pallas PlanTables carried across through numpy equals the
    port's own (the root table in its natural layout) and drives the port's
    transform to the same output."""
    N, g = TEST_MODULUS, TEST_GENERATOR
    jmod, mod = JModulus(N, g), Modulus(N, g)
    fc = FieldConsts.from_modulus(mod, modmul="shoup")
    plan = planner.build_plan(1 << 12, "pallas", 16)
    jplan = jplanner.build_plan(1 << 12, "pallas", 16)
    assert repr(plan) == repr(jplan)
    jpt = jplanner.PlanTables(jplan, jmod, JFieldConsts.from_modulus(jmod, modmul="shoup"), inverse)

    def pair(tw):
        return {
            "w": (np.asarray(tw.w.hi), np.asarray(tw.w.lo)),
            "wp": None if tw.wp is None else (np.asarray(tw.wp.hi), np.asarray(tw.wp.lo)),
        }

    arrays = {
        "leaf": {
            k: dict(stage_ls=v.stage_ls, tw=[[np.asarray(a) for a in st] for st in v.tw],
                    scale=[np.asarray(a) for a in v.scale])
            for k, v in jpt.leaf.items()
        },
        "lane": {
            k: dict(stage_ls=v.stage_ls, tw=np.asarray(v.tw), scale_scalar=v.scale_scalar)
            for k, v in jpt.lane.items()
        },
        "split_tw": {k: pair(v) for k, v in jpt.split_tw.items()},
        "split_tw_t": {k: pair(v) for k, v in jpt.split_tw_t.items()},
    }
    carried = interop.tables_from_numpy(plan, mod, fc, inverse, arrays, device="cpu")
    own = planner.PlanTables(plan, mod, fc, inverse, device="cpu")
    assert not jpt.split_tw_t  # a pallas root keeps the (m0, m1) layout
    for name in ("leaf", "lane", "split_tw"):
        assert getattr(carried, name).keys() == getattr(own, name).keys(), name
    for name in ("leaf", "lane"):
        for k, o in getattr(own, name).items():
            c = getattr(carried, name)[k]
            assert (c.stage_ls, c.scale) == (o.stage_ls, o.scale)
            np.testing.assert_array_equal(to_numpy(c.w), to_numpy(o.w))
            np.testing.assert_array_equal(to_numpy(c.wp), to_numpy(o.wp))
    for k, v in own.split_tw.items():
        np.testing.assert_array_equal(to_numpy(carried.split_tw[k].w), to_numpy(v.w))
        np.testing.assert_array_equal(to_numpy(carried.split_tw[k].wp), to_numpy(v.wp))
    x = from_numpy(rng.integers(0, N, 1 << 12, dtype=np.uint64))
    run = planner.run_inverse if inverse else planner.run_forward
    np.testing.assert_array_equal(to_numpy(run(x, plan, carried)), to_numpy(run(x, plan, own)))



def _card_rule(monkeypatch):
    """Make ``NTT`` resolve "auto" as on a CUDA card while it runs on the
    CPU (the plain versions)."""
    rule = wrapper._resolve_engine
    monkeypatch.setattr(wrapper, "_resolve_engine", lambda config, device: rule(config, "cuda"))


def test_auto_plan_on_a_card():
    """engine="auto" on a card: the butterfly plan with leaves of up to 512
    points -- 256 x 512 at 2^17, (256 x 256) x 256 at 2^24 -- in the
    shapes, so with the levels and launches, of the matrix plan that "auto"
    gives on the CPU (and "mxu" anywhere), at 2^10 .. 2^26; an explicit
    "pallas" keeps the JAX package's plan (leaves of up to 256), and a
    ``max_fused`` the caller sets is kept."""
    F, G = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR

    def plan(cfg, device):
        return wrapper.build_config_plan(cfg, wrapper._resolve_engine(cfg, device))

    for log2n in range(10, 27):
        cfg = NttConfig(F, G, 1 << log2n)
        mxu = plan(cfg, "cpu")
        assert mxu == plan(cfg.with_(engine="mxu"), "cuda")
        assert repr(plan(cfg, "cuda")) == repr(mxu).replace("'mxu'", "'pallas'"), log2n
    L = planner.Leaf
    assert plan(NttConfig(F, G, 1 << 17), "cuda") == planner.Split(
        1 << 17, 256, 512, L(256, "pallas"), L(512, "pallas"))
    assert plan(NttConfig(F, G, 1 << 24), "cuda") == planner.Split(
        1 << 24, 1 << 16, 256,
        planner.Split(1 << 16, 256, 256, L(256, "pallas"), L(256, "pallas")), L(256, "pallas"))
    for log2n in (17, 24):
        cfg = NttConfig(F, G, 1 << log2n, engine="pallas")
        assert repr(plan(cfg, "cuda")) == repr(jplanner.build_plan(1 << log2n, "pallas"))
    assert plan(NttConfig(F, G, 1 << 17, max_fused=64), "cuda") == plan(
        NttConfig(F, G, 1 << 17, engine="pallas", max_fused=64), "cuda")


@pytest.mark.parametrize("log2n", [10, 12])
def test_auto_plan_on_a_card_matches_jax_and_golden(rng, monkeypatch, log2n):
    """The plan that "auto" builds on a card -- the JAX package's butterfly
    plan at leaves of up to 512 points -- run through the butterfly
    engine's plain versions, equals the JAX package's transform and the
    golden model, forward and inverse, and its roundtrip is exact.  The
    flagship's residues are canonical, so every JAX engine gives the same
    words: its portable one is compared, as its interpreted Pallas kernels
    take a minute at these shapes."""
    _card_rule(monkeypatch)
    n, N = 1 << log2n, FLAGSHIP_MODULUS
    ntt = NTT(NttConfig(N, FLAGSHIP_GENERATOR, n), device="cpu")
    ref = JNTT(JNttConfig(N, FLAGSHIP_GENERATOR, n, engine="jnp"))
    assert ntt.engine == "pallas"
    assert repr(ntt.plan) == repr(jplanner.build_plan(n, "pallas", 512))
    x = rng.integers(0, N, n, dtype=np.uint64)
    x[1] = N - 1
    ntt_pallas.reset_counts()
    fwd, inv = ntt.forward_numpy(x), ntt.inverse_numpy(x)
    plain = dict(ntt_pallas.PLAIN_CALLS)
    assert plain["leaf"] > 0 and plain["lane"] > 0, plain
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    np.testing.assert_array_equal(inv, ref.inverse_numpy(x))
    golden = GoldenNTT(n, ntt.mod)
    assert [int(v) for v in fwd] == golden.forward([int(v) for v in x])
    assert [int(v) for v in inv] == golden.inverse([int(v) for v in x])
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)

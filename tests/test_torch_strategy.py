"""PyTorch port, the wrapper's strategies and the local plans' tables:
``NTT(strategy="six_step" | "iterative")`` against sventt_tpu's NTT, and
the port's PlanTables against the JAX ``PlanTables(root_lead=False)``.

The JAX side runs its ``engine="auto"`` (jnp off the TPU); the port runs
its plain versions on the CPU.  Inputs are made with numpy from a seed;
outputs are compared bit for bit after ``normalize`` (tolerance zero).
"""

import numpy as np
import pytest
import torch

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu.plan import planner as jplanner
from sventt_tpu_torch import interop
from sventt_tpu_torch.field.limb import FieldConsts, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.plan import NTT, NttConfig, planner

N, G = TEST_MODULUS, TEST_GENERATOR


@pytest.mark.parametrize(
    "strategy,n,kw",
    [
        pytest.param("six_step", 1 << 10, {}, id="six_step-mxu"),
        pytest.param("six_step", 1 << 10, dict(engine="pallas", max_fused=8), id="six_step-pallas-subtrees"),
        pytest.param("iterative", 1 << 8, {}, id="iterative-mxu"),
        pytest.param("iterative", 1 << 8, dict(engine="pallas", max_r=3), id="iterative-grouped"),
    ],
)
def test_ntt_strategies_match_jax(rng, strategy, n, kw):
    """NTT(strategy=...) against the JAX NTT of the same config (its
    engine "auto" is jnp on the CPU; the plans' shapes agree)."""
    x = rng.integers(0, N, n, dtype=np.uint64)
    jkw = {k: v for k, v in kw.items() if k == "max_fused"}
    ref = JNTT(JNttConfig(N, G, n, strategy=strategy, **jkw))
    ntt = NTT(NttConfig(N, G, n, strategy=strategy, **kw), device="cpu")
    shape = repr(ntt.plan).replace("'mxu'", "'E'").replace("'pallas'", "'E'")
    assert shape == repr(ref.plan).replace("'jnp'", "'E'")
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(x), ref.inverse_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


def test_six_step_plan_shapes():
    """The six_step plan is Split(n, n0, n1, build_plan(n0), build_plan(n1))
    from ``config.split``; a row subtree takes the transpose fallback."""
    cfg = NttConfig(N, G, 1 << 12, strategy="six_step", engine="pallas", n0=1 << 4, n1=1 << 8,
                    max_fused=16)
    ntt = NTT(cfg, enable_forward=False, enable_inverse=False, device="cpu")
    assert ntt.plan == planner.Split(
        1 << 12, 16, 256, planner.Leaf(16, "pallas"), planner.build_plan(256, "pallas", 16)
    )
    assert ntt.describe().splitlines()[0] == "split 4096 = 16 x 256: transposed row subtree m1=256"
    auto = NTT(NttConfig(N, G, 1 << 12, engine="pallas"), enable_forward=False,
               enable_inverse=False, device="cpu")
    assert auto.plan == planner.build_plan(1 << 12, "pallas")


def test_iterative_leaf_above_cap_raises():
    """A leaf above an engine's limit raises, as in the JAX package."""
    args = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 11)
    with pytest.raises(ValueError, match="mxu"):
        JNTT(JNttConfig(*args, strategy="iterative", engine="mxu"))
    with pytest.raises(ValueError, match="mxu"):
        NTT(NttConfig(*args, strategy="iterative", engine="mxu"), device="cpu")


def _pair(tw):
    return {
        "w": (np.asarray(tw.w.hi), np.asarray(tw.w.lo)),
        "wp": None if tw.wp is None else (np.asarray(tw.wp.hi), np.asarray(tw.wp.lo)),
    }


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_root_lead_false_tables_match_jax(rng, inverse):
    """The port keeps an mxu-row root's table in its (m0, m1) layout, as
    the JAX root_lead=False tables do (carried across through interop),
    and the JAX root_lead=True tables' transposed root table is carried
    back into that layout; batched runs of the three agree."""
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    jmod = JModulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    plan = planner.build_plan(1 << 12, "mxu", 16)  # (256 = 16 x 16) x 16
    jpt = jplanner.PlanTables(jplanner.build_plan(1 << 12, "mxu", 16), jmod,
                              JFieldConsts.from_modulus(jmod), inverse, root_lead=False)
    arrays = {
        "leaf": {
            k: {"planes": np.asarray(v.planes), "corr": (np.asarray(v.corr.hi), np.asarray(v.corr.lo))}
            for k, v in jpt.leaf.items()
        },
        "split_tw": {k: _pair(v) for k, v in jpt.split_tw.items()},
        "split_tw_t": {k: _pair(v) for k, v in jpt.split_tw_t.items()},
    }
    carried = interop.tables_from_numpy(plan, mod, fc, inverse, arrays, device="cpu")
    own = planner.PlanTables(plan, mod, fc, inverse, device="cpu")
    jlead = jplanner.PlanTables(jplanner.build_plan(1 << 12, "mxu", 16), jmod,
                                JFieldConsts.from_modulus(jmod), inverse)
    assert not jpt.split_tw_t and jlead.split_tw_t.keys() == {(256, 16)}
    lead = interop.tables_from_numpy(plan, mod, fc, inverse, {
        **arrays, "split_tw": {k: _pair(v) for k, v in jlead.split_tw.items()},
        "split_tw_t": {k: _pair(v) for k, v in jlead.split_tw_t.items()},
    }, device="cpu")
    assert not hasattr(own, "split_tw_t")
    assert own.split_tw.keys() == carried.split_tw.keys() == lead.split_tw.keys() == {(256, 16), (16, 16)}
    for k, v in own.split_tw.items():
        for c in (carried, lead):
            np.testing.assert_array_equal(to_numpy(c.split_tw[k].w), to_numpy(v.w))
            np.testing.assert_array_equal(to_numpy(c.split_tw[k].wp), to_numpy(v.wp))
    x = torch.from_numpy(rng.integers(0, FLAGSHIP_MODULUS, (1 << 12, 2), dtype=np.uint64).view(np.int64))
    run = planner.run_inverse if inverse else planner.run_forward
    got = run(x, plan, own)
    assert torch.equal(got, run(x, plan, carried)) and torch.equal(got, run(x, plan, lead))

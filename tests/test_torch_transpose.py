"""PyTorch port, the transposes: the blocked transpose (K9a
``transpose_pallas``, K9b ``transpose_u64`` / ``transpose01_u64`` with
strategy "pallas") and the torch copy, against sventt_tpu.ops.transpose;
and the planner's transpose fallback at a split whose row is a subtree,
against sventt_tpu's NTT.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions (CPU tensors).  Inputs are made with numpy from a seed and
compared bit for bit.
"""

import numpy as np
import pytest
import torch

from sventt_tpu.field.limb import U64, u64_from_numpy, u64_to_numpy
from sventt_tpu.ops import transpose as jtr
from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
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


def _plane(rng, shape):
    """A random u32 plane: (numpy uint32, the port's int32 tensor)."""
    a = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    return a, torch.from_numpy(a.view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _reset():
    for mod in (ntt_pallas, inter_step, transpose):
        mod.reset_counts()


def test_transpose_xla_with_batch(rng):
    a = rng.integers(0, 1 << 64, (8, 16, 3), dtype=np.uint64)
    got = transpose.transpose_xla(from_numpy(a))
    assert got.is_contiguous()
    want = u64_to_numpy(U64(*(jtr.transpose_xla(p) for p in u64_from_numpy(a))))
    np.testing.assert_array_equal(to_numpy(got), want)
    assert transpose.transpose01 is transpose.transpose_xla


@pytest.mark.parametrize("shape,block", [((16, 32), 8), ((64, 16), 16)])
def test_transpose_pallas_matches_jax(rng, shape, block):
    """K9a on one u32 plane, the shapes of tests/test_transpose.py."""
    a, t = _plane(rng, shape)
    transpose.reset_counts()
    got = transpose.transpose_pallas(t, block, block)
    assert transpose.PLAIN_CALLS == {"plane": 1, "pair": 0}
    assert not any(transpose.LAUNCHES.values())
    np.testing.assert_array_equal(_u32(got), np.asarray(jtr.transpose_pallas(a, block, block)))
    # 8-byte elements take the same kernel
    wide = from_numpy(a.astype(np.uint64))
    np.testing.assert_array_equal(to_numpy(transpose.transpose_pallas(wide, block, block)),
                                  a.T.astype(np.uint64))


def test_transpose_u64_strategies_match_jax(rng):
    a = rng.integers(0, 1 << 64, (16, 16), dtype=np.uint64)
    x = from_numpy(a)
    for strategy, kw in (("xla", {}), ("pallas", dict(br=8, bc=8))):
        want = u64_to_numpy(jtr.transpose_u64(u64_from_numpy(a), strategy, **kw))
        np.testing.assert_array_equal(to_numpy(transpose.transpose_u64(x, strategy, **kw)), want)
    with pytest.raises(ValueError, match="strategy"):
        transpose.transpose_u64(x, "gather")
    with pytest.raises(TypeError):
        transpose.transpose_u64(x.to(torch.int32), "pallas")


def test_transpose_pallas_pair_rect_matches_jax(rng):
    """K9b with the rectangular tiles of tests/test_transpose.py: the
    port's one int64 word against the JAX pair kernel's two u32 planes."""
    a = rng.integers(0, 1 << 64, (64, 512), dtype=np.uint64)
    hi, lo = (a >> np.uint64(32)).astype(np.uint32), a.astype(np.uint32)
    for br, bc in [(64, 512), (8, 512), (64, 256), (32, 128)]:
        oh, ol = jtr._transpose_pallas_pair(hi, lo, br, bc)
        got = transpose.transpose_u64(from_numpy(a), "pallas", br=br, bc=bc)
        np.testing.assert_array_equal(to_numpy(got), u64_to_numpy(U64(oh, ol)))


def test_transpose_pallas_rejects_bad_input():
    """Indivisible shapes raise (a floor-divided grid would drop the
    remainder), as in the JAX package; so do 3-D and 2-byte inputs."""
    with pytest.raises(ValueError, match="not divisible"):
        transpose.transpose_pallas(torch.zeros((300, 256), dtype=torch.int32))
    with pytest.raises(ValueError, match="not divisible"):
        transpose.transpose_u64(torch.zeros((256, 300), dtype=torch.int64), "pallas")
    with pytest.raises(ValueError, match="2-D"):
        transpose.transpose_pallas(torch.zeros((8, 8, 8), dtype=torch.int32), 8, 8)
    with pytest.raises(TypeError):
        transpose.transpose_pallas(torch.zeros((8, 8), dtype=torch.int16), 8, 8)


def test_transpose01_u64_dispatch_matches_jax(rng):
    """The transform paths' entry point: "pallas" takes the blocked kernel
    on block-divisible 2-D shapes; 3-D, indivisible shapes and the other
    strategies take the torch copy, as in the JAX package."""
    a = rng.integers(0, 1 << 64, (256, 512), dtype=np.uint64)
    x = from_numpy(a)
    for strategy in (None, "auto", "xla", "pallas"):
        transpose.reset_counts()
        got = transpose.transpose01_u64(x, strategy)
        want = u64_to_numpy(jtr.transpose01_u64(u64_from_numpy(a), strategy))
        np.testing.assert_array_equal(to_numpy(got), want)
        assert transpose.PLAIN_CALLS["pair"] == (strategy == "pallas")
    transpose.reset_counts()
    x3 = x.reshape(256, 256, 2)
    got = transpose.transpose01_u64(x3, "pallas")
    want = u64_to_numpy(jtr.transpose01_u64(u64_from_numpy(a.reshape(256, 256, 2)), "pallas"))
    np.testing.assert_array_equal(to_numpy(got), want)
    got = transpose.transpose01_u64(x[:100], "pallas")
    np.testing.assert_array_equal(to_numpy(got), a[:100].T)
    assert not any(transpose.PLAIN_CALLS.values())


def test_pallas_transpose_stays_off_the_config():
    """NttConfig(transpose="pallas") is rejected, as in the JAX package:
    the blocked kernel is an ops-level strategy only."""
    for cfg in (NttConfig, JNttConfig):
        with pytest.raises(ValueError, match="bench_transpose"):
            cfg(TEST_MODULUS, TEST_GENERATOR, 1 << 10, transpose="pallas")


@pytest.mark.parametrize(
    "N,g,modmul,max_r",
    [
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "montgomery", 3, id="flagship-r3"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, "shoup", 1, id="test62-shoup-r1"),
    ],
)
def test_row_subtree_matches_jax(rng, N, g, modmul, max_r):
    """A split whose row is a subtree (the JAX six_step strategy at 2^10,
    max_fused 8: 32 x 32, each side Split(32 = 4 x 8)) takes the transpose
    fallback at the root, and within the row subtree the batched rows run
    mid-axis (radix-2) or by the fallback again (grouped)."""
    n = 1 << 10
    ref = JNTT(JNttConfig(N, g, n, strategy="six_step", engine="pallas", max_fused=8,
                          modmul=modmul, max_r=max_r))
    sub = planner.build_plan(32, "pallas", 8)
    plan = planner.Split(n, 32, 32, sub, sub)
    assert repr(plan) == repr(ref.plan)
    mod = Modulus(N, g)
    fc = FieldConsts.from_modulus(mod, modmul=modmul)
    x = rng.integers(0, N, n, dtype=np.uint64)
    _reset()
    outs = []
    for inverse, jrun in ((False, ref.compute_forward), (True, ref.compute_inverse)):
        tables = planner.PlanTables(plan, mod, fc, inverse, max_r=max_r, device="cpu")
        run = planner.run_inverse if inverse else planner.run_forward
        got = run(from_numpy(x), plan, tables)
        np.testing.assert_array_equal(to_numpy(got), u64_to_numpy(jrun(u64_from_numpy(x))))
        outs.append((run, tables, got))
    assert inter_step.PLAIN_CALLS["inter_step"] >= 2
    fwd = fc.normalize(outs[0][2])
    golden = GoldenNTT(n, mod).forward([int(v) for v in x])
    assert [int(v) for v in to_numpy(fwd)] == golden
    run, tables, _ = outs[1]
    np.testing.assert_array_equal(to_numpy(fc.normalize(run(fwd, plan, tables))), x)
    # describe: the NTT of another plan, shown with this one (describe
    # reads nothing but the plan)
    ntt = NTT(NttConfig(N, g, n, engine="pallas", max_fused=8, modmul=modmul, max_r=max_r),
              enable_forward=False, enable_inverse=False, device="cpu")
    ntt.plan = plan
    assert ntt.describe().splitlines() == ref.describe().splitlines()
    assert ntt.describe().splitlines()[0] == "split 1024 = 32 x 32: transposed row subtree m1=32"

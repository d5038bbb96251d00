"""PyTorch port, the Solinas slice as a whole: ``NTT(modmul="solinas")`` on
the matrix and butterfly engines against sventt_tpu's NTT of the same
config (its Pallas kernels in interpret mode) and the golden model, the
``max_r`` rule, and ``DistributedNTT`` under Solinas on CPU logical shards
against sventt_tpu's on its 8-device CPU mesh.

Sizes: an iterative one (one leaf) and a six-step one (a three-level plan
at a small ``max_fused``: leaf, mid and root row steps); the JAX butterfly
kernels are traced at m <= 8, each length and orientation a trace of its
own.  Inputs are made with numpy from a seed and hold N - 1; Solinas is
canonical, so outputs are compared bit for bit, tolerance zero, and the
roundtrip must return the input exactly.
"""

import jax
import numpy as np
import pytest

from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.parallel import DistributedNTT as JDistributedNTT
from sventt_tpu.parallel import make_ntt_mesh as jmake_ntt_mesh
from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu_torch.field.golden import GoldenNTT
from sventt_tpu_torch.field.limb import to_numpy
from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS
from sventt_tpu_torch.ops import inter_step, ntt_mxu, ntt_pallas
from sventt_tpu_torch.parallel import DistributedNTT, make_ntt_mesh
from sventt_tpu_torch.plan import NTT, NttConfig

N, G = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR


def _x(rng, n):
    x = rng.integers(0, N, n, dtype=np.uint64)
    x[1] = N - 1
    return x


@pytest.mark.parametrize(
    "engine,log2n,max_fused",
    [
        pytest.param("mxu", 5, None, id="mxu-iterative-2^5"),
        pytest.param("mxu", 10, 16, id="mxu-six_step-2^10"),
        pytest.param("pallas", 3, None, id="pallas-iterative-2^3"),
        pytest.param("pallas", 6, 4, id="pallas-six_step-2^6"),
    ],
)
def test_solinas_ntt_matches_jax(rng, engine, log2n, max_fused):
    n = 1 << log2n
    kw = dict(engine=engine, modmul="solinas", max_fused=max_fused)
    ref = JNTT(JNttConfig(N, G, n, **kw))
    ntt = NTT(NttConfig(N, G, n, **kw), device="cpu")
    assert ntt.fc.modmul == "solinas" and not ntt.fc.lazy
    assert repr(ntt.plan) == repr(ref.plan)
    x = _x(rng, n)
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(x), ref.inverse_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)
    assert [int(v) for v in fwd] == GoldenNTT(n, ntt.mod).forward([int(v) for v in x])


def test_solinas_max_r_is_radix2(rng):
    """``engine="pallas", max_r=3, modmul="solinas"`` runs radix-2, as in
    JAX: per-stage tables everywhere, K4/K5/K6 run and K7/K8 never do;
    equal to the port's plain Solinas transform and to JAX's."""
    n, kw = 1 << 10, dict(engine="pallas", modmul="solinas", max_fused=16)
    ntt = NTT(NttConfig(N, G, n, max_r=3, **kw), device="cpu")
    t = ntt._fwd_tables
    assert all(isinstance(v, ntt_pallas.FusedDirection) for v in t.leaf.values())
    assert all(isinstance(v, ntt_pallas.LaneDirection) for v in t.lane.values())
    x = _x(rng, n)
    ntt_pallas.reset_counts()
    fwd = ntt.forward_numpy(x)
    calls = ntt_pallas.PLAIN_CALLS
    assert calls["grouped"] == calls["lane_grouped"] == 0
    assert calls["leaf"] > 0 and calls["mid"] > 0 and calls["lane"] > 0
    np.testing.assert_array_equal(fwd, NTT(NttConfig(N, G, n, **kw), device="cpu").forward_numpy(x))
    np.testing.assert_array_equal(fwd, JNTT(JNttConfig(N, G, n, max_r=3, **kw)).forward_numpy(x))


def test_solinas_row_subtree_runs_inter_step(rng):
    """A six-step plan whose row is a subtree takes the transpose fallback:
    the inter-step pass multiplies the plain Solinas table."""
    n = 1 << 10
    ntt = NTT(NttConfig(N, G, n, strategy="six_step", engine="pallas", modmul="solinas",
                        max_fused=16), device="cpu")
    assert "transposed row subtree" in ntt.describe()
    assert all(tw.wp is None for tw in ntt._fwd_tables.split_tw.values())
    x = _x(rng, n)
    inter_step.reset_counts()
    fwd = ntt.forward_numpy(x)
    assert inter_step.PLAIN_CALLS["inter_step"] > 0
    assert [int(v) for v in fwd] == GoldenNTT(n, ntt.mod).forward([int(v) for v in x])
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


def test_distributed_solinas_matches_jax(rng):
    """DistributedNTT under Solinas on 8 CPU logical shards: Solinas local
    tables, Montgomery inter-step tables multiplied by a Montgomery
    FieldConsts (as JAX's mont_mul / mont_mul_full), equal to JAX's
    shard_map transform (mirroring tests/test_parallel.py's Solinas case),
    to the single-device port and, for its inter-step blocks, to JAX's
    tables word for word; exact roundtrip."""
    n = 1 << 12
    kw = dict(strategy="six_step", modmul="solinas", engine="mxu")
    jd = JDistributedNTT(JNttConfig(N, G, n, **kw), jmake_ntt_mesh(8))
    dntt = DistributedNTT(NttConfig(N, G, n, **kw), make_ntt_mesh(devices=["cpu"] * 8))
    assert (dntt.fc.modmul, dntt.tw_fc.modmul) == ("solinas", "montgomery")
    x = _x(rng, n)
    xd = jax.device_put(u64_from_numpy(x), jd.sharding())
    want = u64_to_numpy(jd.fc.normalize(jd.compute_forward(xd)))
    fwd = dntt.compute_forward(dntt.shard(x))
    got = to_numpy(dntt.gather(fwd))
    np.testing.assert_array_equal(got, want)
    single = NTT(NttConfig(N, G, n, **kw), enable_inverse=False, device="cpu")
    np.testing.assert_array_equal(got, single.forward_numpy(x))
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.compute_inverse(fwd))), x)
    jw = u64_to_numpy(jd._fwd_tw.w)
    np.testing.assert_array_equal(np.concatenate([to_numpy(t.w) for t in dntt._forward.tw], axis=1), jw)
    assert ntt_mxu.LAUNCHES["lead"] == ntt_mxu.LAUNCHES["mid"] == 0


def test_distributed_solinas_pallas(rng):
    """The butterfly engine's distributed Solinas transform (D = 8 ring on
    CPU shards, K10's plain exchange) equals the single-device port's and
    the golden model; exact roundtrip."""
    n = 1 << 10
    kw = dict(strategy="six_step", modmul="solinas", engine="pallas")
    dntt = DistributedNTT(NttConfig(N, G, n, **kw), make_ntt_mesh(devices=["cpu"] * 8), comm="ring")
    x = _x(rng, n)
    fwd = dntt.compute_forward(dntt.shard(x))
    got = to_numpy(dntt.gather(fwd))
    np.testing.assert_array_equal(got, NTT(NttConfig(N, G, n, **kw), device="cpu").forward_numpy(x))
    assert [int(v) for v in got] == GoldenNTT(n, dntt.mod).forward([int(v) for v in x])
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.compute_inverse(fwd))), x)

"""PyTorch port, the all-to-all of the distributed six-step:
``parallel.ring`` against sventt_tpu's ring kernel and ``lax.all_to_all``.

The port's shards are eight CPU logical shards (``["cpu"] * 8``), so its
exchange runs the plain version of K10; the JAX side runs its ring kernel
in interpret mode inside ``shard_map`` on the 8-device CPU mesh.  Data is
made with numpy from a seed and compared bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sventt_tpu.field.limb import U64
from sventt_tpu.parallel import make_ntt_mesh as jmake_ntt_mesh
from sventt_tpu.parallel.ring import ring_all_to_all as jring_all_to_all
from sventt_tpu_torch.field.limb import from_limbs, to_limbs
from sventt_tpu_torch.field.modulus import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu_torch.parallel import DistributedNTT, make_ntt_mesh
from sventt_tpu_torch.parallel import ring
from sventt_tpu_torch.parallel.mesh import make_mesh
from sventt_tpu_torch.plan import NttConfig

D = 8


def _jax_all_to_all(x: U64, split: int, concat: int, via_ring: bool) -> U64:
    mesh = jmake_ntt_mesh(D)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P("shard"), out_specs=P("shard"), check_vma=False
    )
    def run(a):
        if via_ring:
            return jring_all_to_all(a, ("shard",), split, concat)
        return U64(*(
            jax.lax.all_to_all(v, "shard", split_axis=split, concat_axis=concat, tiled=True)
            for v in a
        ))

    return run(x)


@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1)])
def test_ring_matches_jax(rng, split, concat):
    """Both orientations at r, c = 16, 64 (the JAX package's own case):
    the port's ring (plain version on CPU shards) and its torch-copy
    exchange equal JAX's ring kernel and ``lax.all_to_all``."""
    r, c = 16, 64
    hi = rng.integers(0, 1 << 32, (D * r, c), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, (D * r, c), dtype=np.uint64).astype(np.uint32)
    x = U64(jax.numpy.asarray(hi), jax.numpy.asarray(lo))
    shards = list(from_limbs(hi, lo, "cpu").split(r))
    ring.reset_counts()
    got = ring.ring_all_to_all(shards, split, concat)
    assert ring.PLAIN_CALLS["ring"] == 1 and ring.LAUNCHES["ring"] == 0
    copied = ring.copy_all_to_all(shards, split, concat)
    want_shape = (D * r, c // D) if split == 1 else (r // D, D * c)
    assert all(tuple(g.shape) == want_shape and g.device.type == "cpu" for g in got)
    flat = torch.cat(got)
    for via_ring in (True, False):
        want = _jax_all_to_all(x, split, concat, via_ring)
        w = from_limbs(np.asarray(want.hi), np.asarray(want.lo), "cpu")
        assert torch.equal(flat, w)
    assert torch.equal(torch.cat(copied), flat)
    # the limb pair at the test boundary round-trips
    h2, l2 = to_limbs(flat)
    np.testing.assert_array_equal(h2, np.asarray(want.hi))
    np.testing.assert_array_equal(l2, np.asarray(want.lo))


def test_canonical_plain_matches_numpy_loop(rng):
    """The canonical exchange at D = 3 with ragged (5, 7) slabs:
    out_d[o] = in_o[d]."""
    slabs = [rng.integers(0, 1 << 63, (3, 5, 7), dtype=np.uint64) for _ in range(3)]
    want = np.empty((3, 3, 5, 7), dtype=np.uint64)
    for d in range(3):
        for o in range(3):
            want[d, o] = slabs[o][d]
    ring.reset_counts()
    got = ring.canonical_all_to_all([torch.from_numpy(s.view(np.int64)) for s in slabs])
    assert ring.PLAIN_CALLS["ring"] == 1 and ring.LAUNCHES["ring"] == 0
    for d in range(3):
        np.testing.assert_array_equal(got[d].numpy().view(np.uint64), want[d])


@pytest.mark.parametrize("D_", [1, 2, 4])
def test_ring_small_meshes_match_copy(rng, D_):
    """D = 1, 2 and 4 shards, both orientations: the ring equals the
    torch-copy exchange (D = 1 is a copy of the shard)."""
    for split, concat in ((1, 0), (0, 1)):
        shards = [torch.from_numpy(rng.integers(0, 1 << 62, (8, 12))) for _ in range(D_)]
        got = ring.ring_all_to_all(shards, split, concat)
        for g, w in zip(got, ring.copy_all_to_all(shards, split, concat)):
            assert torch.equal(g, w)
        if D_ == 1:
            assert torch.equal(got[0], shards[0]) and got[0].data_ptr() != shards[0].data_ptr()


def test_ring_rejects_bad_input():
    shards = [torch.zeros((8, 12), dtype=torch.int64) for _ in range(3)]
    with pytest.raises(ValueError, match="single mesh axis"):
        ring.ring_all_to_all(shards, 0, 1, axes=("dcn", "ici"))
    with pytest.raises(ValueError, match="divisible"):
        ring.ring_all_to_all(shards, 0, 1)  # 8 rows over 3 shards
    with pytest.raises(ValueError, match="unsupported"):
        ring.ring_all_to_all(shards, 1, 1)
    with pytest.raises(TypeError):
        ring.ring_all_to_all([s.int() for s in shards], 1, 0)
    with pytest.raises(ValueError, match="one shape"):
        ring.ring_all_to_all([shards[0], shards[1][:4]], 1, 0)
    with pytest.raises(ValueError, match=r"\(D, R, C\)"):
        ring.canonical_all_to_all([torch.zeros((2, 5, 7), dtype=torch.int64)] * 3)


def test_ring_rejects_hierarchical_mesh():
    """Hierarchical (dcn, ici) meshes must use comm='xla', as in JAX."""
    mesh2 = make_mesh((2, 4), ("dcn", "ici"), devices=["cpu"] * 8)
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step")
    with pytest.raises(ValueError, match="ring"):
        DistributedNTT(cfg, mesh2, axis=("dcn", "ici"), comm="ring")


def test_ring_rejects_partial_mesh():
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step")
    mesh2 = make_mesh((2, 4), ("a", "b"), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="ring"):
        DistributedNTT(cfg, mesh2, axis="a", comm="ring")
    # the copy exchange over part of a mesh (shards replicated over the
    # rest) is not ported: it raises instead of running on a subset
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DistributedNTT(cfg, mesh2, axis="a")


def test_ring_dntt_on_one_axis_mesh():
    """A 1-D mesh named otherwise than "shard" takes the ring."""
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, strategy="six_step")
    mesh = make_ntt_mesh(axis="x", devices=["cpu"] * 4)
    dntt = DistributedNTT(cfg, mesh, axis="x", comm="ring")
    assert dntt.D == 4 and dntt.devices == (torch.device("cpu"),) * 4

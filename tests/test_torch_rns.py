"""Multi-modular (RNS) transforms of the PyTorch port on the CPU: an
``NttConfig`` of tuples of L moduli, ``NTT`` on (L, n) data and
``cyclic_convolve`` limb by limb, the plain versions of the kernels' limb
axis.

Held word for word against the benchmark's plain reference
(``bench_port/reference/rns.py``) and against the single-modulus ``NTT``
of each limb; a 1-tuple configuration against the int one (outputs, route
and counters); the tables built for every limb at once against the
single-modulus tables, bit for bit; and every refusal.  The primes are
the first of the benchmark's ``rns32-2p17`` configuration (64 bits), and a
pair of 62-bit ones for the lazy mode.  No JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from sventt_tpu_torch import NTT, NttConfig
from sventt_tpu_torch.apps.convolve import cyclic_convolve
from sventt_tpu_torch.field.limb import FieldConsts, LimbConsts
from sventt_tpu_torch.field.modulus import FLAGSHIP_MODULUS, Modulus
from sventt_tpu_torch.ops import ntt_mxu, pointwise
from sventt_tpu_torch.ops.twiddle import sixstep_row_twiddles_limbs
from sventt_tpu_torch.parallel import DistributedNTT, make_ntt_mesh
from sventt_tpu_torch.plan import planner, wrapper
from sventt_tpu_torch.utils.profiling import span

from bench_port.reference.rns import ReferenceRNS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "bench_port", "configs", "rns32-2p17.json")) as f:
    _CELL = json.load(f)
PRIMES = tuple(_CELL["moduli"][:4])
GENS = tuple(_CELL["generators"][:4])
#: 62-bit primes: lazy [0, 2N) arithmetic, 2-adicity 57 and 40
LAZY = ((0x3A00_0000_0000_0001, 3), (0x3FFF_C000_0000_0001, 11))


def data(shape, seed, below=1 << 62):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, below, shape, generator=g, dtype=torch.int64)


def rns(L, n, **kw):
    return NTT(NttConfig(PRIMES[:L], GENS[:L], n, **kw), device="cpu")


@pytest.mark.parametrize("L,n", [(2, 16), (3, 512), (4, 1024), (2, 4096)])
def test_forward_inverse_and_product_equal_the_reference(L, n):
    ntt = rns(L, n)
    ref = ReferenceRNS(PRIMES[:L], GENS[:L], n, "cpu")
    x, y = data((L, n), 1), data((L, n), 2)
    fx = ntt.compute_forward(x)
    assert torch.equal(fx, ref.forward(x))
    assert torch.equal(ntt.compute_inverse(fx), x)
    assert torch.equal(ntt.compute_inverse(y), ref.inverse(y))
    assert torch.equal(cyclic_convolve(ntt, x, y), ref.polymul(x, y))


@pytest.mark.parametrize("n,batch", [(1024, ()), (1024, (3,)), (64, (2, 2)), (1 << 17, ())])
def test_each_limb_is_its_single_modulus_transform(n, batch):
    """Each limb of an "auto" RNS transform -- at 2^17 the plan (32 x 64) x
    64 -- is its single-modulus ``NTT`` (the matrix engine's own plan, 256
    x 512 at 2^17), and the whole is the RNS ``engine="mxu"`` plan's."""
    L = 3
    ntt, own = rns(L, n), rns(L, n, engine="mxu")
    x, y = data((L, n) + batch, 3), data((L, n) + batch, 4)
    fx, ix, c = ntt.compute_forward(x), ntt.compute_inverse(x), cyclic_convolve(ntt, x, y)
    assert torch.equal(fx, own.compute_forward(x)) and torch.equal(ix, own.compute_inverse(x))
    assert torch.equal(c, cyclic_convolve(own, x, y))
    for i in range(L):
        one = NTT(NttConfig(PRIMES[i], GENS[i], n), device="cpu")
        assert torch.equal(fx[i], one.compute_forward(x[i]))
        assert torch.equal(ix[i], one.compute_inverse(x[i]))
        assert torch.equal(c[i], cyclic_convolve(one, x[i], y[i]))


def test_lazy_limbs_normalize_limb_by_limb():
    n = 1024
    ntt = NTT(NttConfig(tuple(q for q, _ in LAZY), tuple(g for _, g in LAZY), n), device="cpu")
    assert ntt.fc.lazy and ntt.fc.modmul == "montgomery"
    x = data((2, n), 5, below=1 << 61)
    fx = ntt.normalize(ntt.compute_forward(x))
    assert torch.equal(ntt.normalize(ntt.compute_inverse(fx)), x)
    for i, (q, g) in enumerate(LAZY):
        one = NTT(NttConfig(q, g, n), device="cpu")
        assert torch.equal(fx[i], one.normalize(one.compute_forward(x[i])))


def counts():
    return (dict(ntt_mxu.LAUNCHES), dict(ntt_mxu.PLAIN_CALLS), dict(ntt_mxu.KERNEL_LAUNCHES),
            dict(ntt_mxu.LIMBS), dict(pointwise.LAUNCHES), dict(pointwise.PLAIN_CALLS),
            dict(pointwise.LIMBS))


def routed(ntt, x, y):
    """The outputs of a forward, an inverse and a product, and the counts of
    each."""
    outs, seen = [], []
    for call in (lambda: ntt.compute_forward(x), lambda: ntt.compute_inverse(x),
                 lambda: cyclic_convolve(ntt, x, y)):
        ntt_mxu.reset_counts()
        pointwise.reset_counts()
        outs.append(call())
        seen.append(counts())
    return outs, seen


@pytest.mark.parametrize("n", [512, 1 << 12])
def test_a_one_tuple_config_is_the_int_config(n):
    """A 1-tuple configuration is the int one cut as "auto" cuts an RNS
    plan (``RNS_MAX_FUSED``): the same plan, outputs and counts."""
    one = NTT(NttConfig(PRIMES[:1], GENS[:1], n), device="cpu")
    ref = NTT(NttConfig(PRIMES[0], GENS[0], n, max_fused=wrapper.RNS_MAX_FUSED), device="cpu")
    assert one.limbs == 1 and ref.limbs is None
    assert one.fc == ref.fc and one.mod == ref.mod and one.describe() == ref.describe()
    x, y = data((n,), 6), data((n,), 7)
    (a, seen_a) = routed(one, x[None], y[None])
    (b, seen_b) = routed(ref, x, y)
    for u, v in zip(a, b):
        assert u.shape == (1, n) and torch.equal(u[0], v)
    assert seen_a == seen_b
    step, tables = one.forward_step()
    assert torch.equal(step(x[None], *tables), a[0])


#: mid calls of an "auto" RNS forward: 2^12 = 64 x 64, 2^17 = (32 x 64) x 64
MIDS = {1 << 12: 0, 1 << 17: 1}


@pytest.mark.parametrize("n", [1 << 12, 1 << 17])
def test_a_limb_call_is_one_call_a_level(n):
    """Every plan level is one kernel call for all limbs: a 4-limb forward
    makes the calls of a 1-limb one (the plain versions here; on the card
    the launches, each carrying 4 limbs: ``chip_smoke.py``)."""
    x1, x4 = data((1, n), 8), data((4, n), 9)
    _, seen1 = routed(rns(1, n), x1, x1)
    _, seen4 = routed(rns(4, n), x4, x4)
    assert seen1 == seen4
    assert seen4[0][1] == {"lead": 1, "mid": MIDS[n], "lane": 1}
    assert seen4[2][5] == {"pointwise": 1}


def test_reset_counts_clears_the_limb_counts():
    ntt_mxu.LIMBS["tensor_core"] = 7
    pointwise.LIMBS["pointwise"] = 3
    ntt_mxu.reset_counts()
    pointwise.reset_counts()
    assert ntt_mxu.LIMBS == {"tensor_core": 0} and pointwise.LIMBS == {"pointwise": 0}


def test_a_limb_call_records_the_single_modulus_spans():
    ntt = rns(3, 1 << 12)
    x = data((3, 1 << 12), 10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("bench.polymul"):
            cyclic_convolve(ntt, x, x)
    names = {e.name for e in prof.events()}
    assert {"sventt.convolve", "sventt.forward", "sventt.inverse", "sventt.row.L0",
            "sventt.leaf", "sventt.convolve.pointwise"} <= names


MODS = [Modulus(q, g) for q, g in zip(PRIMES, GENS)] + [Modulus(*LAZY[0])]


@pytest.mark.parametrize("m", [2, 64, 256, 512])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_the_limb_tables_are_each_limbs_bit_for_bit(m, inverse):
    t = ntt_mxu.make_mxu_limb_tables(MODS, m, inverse=inverse, device="cpu")
    assert t.planes.shape == (len(MODS), 8 * m, m) and t.corr.shape == (len(MODS), m)
    for i, mod in enumerate(MODS):
        planes, corr = ntt_mxu._host_tables(mod.modulus, mod.generator, m, inverse, 1, "s8")
        assert torch.equal(t.planes[i], torch.from_numpy(planes))
        assert np.array_equal(t.corr[i].numpy().view(np.uint64), corr)
        one = t.limb(i)
        assert (one.modulus, one.c128, one.nprime) == (mod.modulus, pow(2, 128, mod.modulus),
                                                       pow(mod.modulus, -1, 1 << 64))


@pytest.mark.parametrize("m", [256, 512])
def test_the_limb_tiles_are_each_limbs(m):
    t = ntt_mxu.make_mxu_limb_tables(MODS[:2], m, inverse=False, device="cpu")
    tiles = ntt_mxu.tc_plane_tiles(t.planes, m).reshape(2, -1)
    assert tiles.shape[1] == ntt_mxu.tc_plane_tile_bytes(m)
    for i in range(2):
        assert torch.equal(tiles[i], ntt_mxu.tc_plane_tiles(t.planes[i], m))


@pytest.mark.parametrize("n0,n1", [(4, 8), (32, 32), (256, 512)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_the_limb_twiddles_are_each_limbs_bit_for_bit(n0, n1, inverse):
    tw = sixstep_row_twiddles_limbs(MODS, n0, n1, inverse=inverse, device="cpu")
    w_only = sixstep_row_twiddles_limbs(MODS, n0, n1, inverse=inverse, with_companion=False,
                                        device="cpu")
    assert w_only.wp is None and torch.equal(w_only.w, tw.w)
    for i, mod in enumerate(MODS):
        one = planner.row_twiddles(mod, n0, n1, inverse=inverse, w_only=False, device="cpu")
        assert torch.equal(tw.w[i], one.w) and torch.equal(tw.wp[i], one.wp)


def test_the_plan_tables_hold_every_limb():
    """The tables of the "auto" plan at 2^17, (32 x 64) x 64, hold all 3
    limbs: both leaves, and the twiddles of both splits."""
    ntt = rns(3, 1 << 17)
    for tables, inverse in ((ntt._fwd_tables, False), (ntt._inv_tables, True)):
        assert tables.limbs == 3
        assert tables.leaf.keys() == {(32, "mxu"), (64, "mxu")}
        assert isinstance(tables.leaf[(32, "mxu")], ntt_mxu.MxuLimbs)
        assert tables.split_tw[(32, 64)].w.shape == (3, 32, 64)
        assert tables.split_tw[(2048, 64)].w.shape == (3, 2048, 64)
        mxu = tables.leaf[(64, "mxu")]
        assert torch.equal(mxu.planes[2], ntt_mxu.make_mxu_tables(
            MODS[2], 64, inverse=inverse, device="cpu").planes)


def test_the_geometry_of_a_limb_call():
    with pytest.raises(ValueError):
        ntt_mxu.tc_geometry(512, 256, 32, form="lane")
    g = ntt_mxu.tc_geometry(512, 256, 32, form="lane", limbs=True)
    assert g == ntt_mxu.tc_geometry(512, 256 * 32, 1, form="lane")


REFUSED = [
    (dict(engine="pallas"), "engine='pallas'"),
    (dict(engine="jnp"), "engine='jnp'"),
    (dict(tune=True), "tune=True"),
    (dict(modmul="solinas"), "solinas"),
]


@pytest.mark.parametrize("kw,what", REFUSED, ids=[w for _, w in REFUSED])
def test_unsupported_options_are_refused(kw, what):
    with pytest.raises(ValueError, match="not supported on an RNS config") as e:
        NttConfig(PRIMES[:2], GENS[:2], 1024, **kw)
    assert what in str(e.value)


@pytest.mark.parametrize("moduli,gens,match", [
    ((PRIMES[0], PRIMES[1] + 2), (GENS[0], 3), "limb 1: modulus .* is not prime"),
    ((PRIMES[0], FLAGSHIP_MODULUS), (GENS[0], 2), "limb 1: 2 does not generate"),
    ((PRIMES[0], 0x3A00_0000_0000_0001), (GENS[0], 1), "limb 1: 1 does not generate"),
    ((PRIMES[1], 97), (GENS[1], 5), "limb 1: modulus 0x61 lacks 2-adicity 10"),
    ((PRIMES[0],), (GENS[0], GENS[1]), "tuples of one length"),
    ((), (), "non-empty"),
    ((PRIMES[0], 1 << 64), (GENS[0], 3), "limb 1: .* in \\(2, 2\\^64\\)"),
], ids=["not-prime", "not-a-generator", "one", "2-adicity", "lengths", "empty", "too-big"])
def test_a_bad_limb_is_refused_by_index(moduli, gens, match):
    with pytest.raises(ValueError, match=match):
        NttConfig(moduli, gens, 1024)


def test_limbs_of_two_lazy_modes_are_refused():
    mods = (PRIMES[0], LAZY[0][0])
    with pytest.raises(ValueError, match="limb 1 .* resolves to lazy=True"):
        NTT(NttConfig(mods, (GENS[0], LAZY[0][1]), 1024), device="cpu")
    with pytest.raises(ValueError, match="limb 0 .*shoup engine requires lazy"):
        NTT(NttConfig(mods, (GENS[0], LAZY[0][1]), 1024, modmul="shoup"), device="cpu")


def test_other_paths_refuse_an_rns_config():
    cfg = NttConfig(PRIMES[:2], GENS[:2], 1 << 12)
    with pytest.raises(ValueError, match="DistributedNTT is not supported on an RNS config"):
        DistributedNTT(cfg, make_ntt_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="a modulus a limb"):
        cfg.mod
    with pytest.raises(ValueError, match="fused mxu rows only"):
        NTT(NttConfig(PRIMES[:2], GENS[:2], 1 << 12, strategy="six_step", n0=4, n1=1024),
            device="cpu")
    with pytest.raises(ValueError, match="mxu leaves only"):
        NTT(NttConfig(PRIMES[:2], GENS[:2], 1 << 12, plan_spec="mxu:64,pallas"), device="cpu")
    ntt = rns(2, 1024)
    with pytest.raises(ValueError, match=r"takes \(L, n, ...\)"):
        ntt.compute_forward(data((3, 1024), 1))
    with pytest.raises(ValueError, match="LimbConsts of their own moduli"):
        ntt_mxu.mxu_ntt(data((2, 64, 1), 1),
                        ntt_mxu.make_mxu_limb_tables(MODS[:2], 64, inverse=False, device="cpu"),
                        LimbConsts.from_moduli(MODS[1:3]))


def test_limb_consts_name_the_limb_that_differs():
    fcs = [FieldConsts.from_modulus(m) for m in MODS]
    with pytest.raises(ValueError, match="limb 4 .* resolves to lazy=True"):
        LimbConsts(tuple(fcs))
    lc = LimbConsts(tuple(fcs[:4]))
    assert lc.moduli == PRIMES and len(lc) == 4 and lc[2] is fcs[2]
    table = lc.table("cpu").numpy().view(np.uint64)
    assert table.shape == (4, 8)
    for row, q in zip(table, PRIMES):
        assert [int(v) for v in row] == [q, pow(q, -1, 1 << 64), pow(2, 128, q), (1 << 64) // q,
                                         1, 0, pow(2, 128, q), 0]

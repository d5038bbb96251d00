"""PyTorch port, the s8 matrix NTT on the int8 tensor cores
(csrc/ntt_mxu_tc.cu): its routing, its launch geometry and its arithmetic
(the u7 planes' instantiations: tests/test_torch_ntt_mxu_tc_u7.py).

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there, bitwise).  Here, on the CPU: which kernel each scheme
and orientation launches (a pure function); the launch geometry the wrapper
passes to the C entry, for every m and form (the lane forms of K3
included); and an emulation of the kernel's accumulation -- 32-deep K
steps, K zero-padded to the geometry's ``kp``, each (digit plane a, byte
plane b) product added straight into plane a + b in the kernel's order --
against ``_plane_products`` (the plain version's planes) and, through the
plain tail, against the JAX package's kernel in interpret mode.  K3 with
the fused twiddle (``mxu_ntt_lane(tw=)``) is held to the JAX package's mxu
root step, a transpose, ``mxu_ntt`` with the transposed table and a
transpose back, and the port's unbatched mxu plans, whose roots run it, to
the JAX plans.  Inputs are made with numpy from a seed; every comparison
is exact.
"""

import numpy as np
import pytest
import torch

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import ntt_mxu as jmxu
from sventt_tpu.ops.twiddle import MontPair as JMontPair
from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu_torch.field.limb import FieldConsts, _shr, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_mxu
from sventt_tpu_torch.ops.twiddle import MontPair
from sventt_tpu_torch.plan import NTT, NttConfig, planner

#: Byte planes the kernel holds in registers at once (csrc/ntt_mxu_tc.cu BG):
#: the order in which it adds the (a, b) products.
BG = 4


def _tc_planes(x3: torch.Tensor, t: ntt_mxu.MxuDirection):
    """The kernel's 15 product planes of (A, m, B) data, accumulated as it
    does, and the largest |partial sum| any plane held on the way."""
    A, m, B = x3.shape
    kp = ntt_mxu.tc_geometry(m, B, A).kp
    D = torch.zeros(ntt_mxu.NL_S8, m, kp, dtype=torch.int64)
    D[:, :, :m] = t.kernel_planes.to(torch.int64).reshape(ntt_mxu.NL_S8, m, m)
    S = torch.zeros(ntt_mxu.NL_S8, A, kp, B, dtype=torch.int64)  # zero past m
    for b in range(ntt_mxu.NL_S8):
        S[b, :, :m] = (_shr(x3, 8 * b) & 0xFF) - 128  # the offset byte
    acc = [torch.zeros(A, m, B, dtype=torch.int64) for _ in range(15)]
    worst = 0
    for k0 in range(0, kp, 32):
        for b0 in range(0, ntt_mxu.NL_S8, BG):
            for a in range(ntt_mxu.NL_S8):
                for b in range(b0, b0 + BG):
                    acc[a + b] += D[a, :, k0:k0 + 32] @ S[b, :, k0:k0 + 32]
                    worst = max(worst, int(acc[a + b].abs().max()))
    return acc, worst


def _flagship():
    return Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)


@pytest.mark.parametrize("orientation", ["lead", "mid", "lane"])
@pytest.mark.parametrize("scheme", ntt_mxu.SCHEMES)
def test_kernel_routing(scheme, orientation):
    """Every scheme runs on the tensor cores in every orientation, K3 lane
    included: s8 and s8b on the s8 digit stack's instantiations, u7 on its
    own; the __dp4a kernel is only the A/B point."""
    assert ntt_mxu.kernel_for(scheme, orientation) == "tensor_core"


def test_tc_form():
    """Lead and mid run the strided form; the lane orientation runs the
    staged epilogue for the inverse with the pair twiddle (the only lane
    form the kernel builds it for), else the stores from the fragment."""
    z = torch.zeros(1, dtype=torch.int64)
    pair, w = MontPair(z, z), MontPair(z, None)
    for inverse in (False, True):
        for tw in (None, pair, w):
            assert ntt_mxu.tc_form("lead", inverse, tw) == ntt_mxu.tc_form("mid", inverse, tw) == "strided"
            want = "lane_staged" if inverse and tw is pair else "lane"
            assert ntt_mxu.tc_form("lane", inverse, tw) == want


def test_kernel_routing_rejects():
    for scheme, orientation in (("s9", "lead"), ("s8", "row")):
        with pytest.raises(ValueError):
            ntt_mxu.kernel_for(scheme, orientation)


def test_tc_geometry_every_m():
    """For every m the kernel takes: K padded to a multiple of 32 (one
    32-step at most past m), a byte-plane row stride that is an odd
    multiple of 16 (ldmatrix's 8 rows in 8 bank groups), the shared memory
    within a block's 232,448 bytes, and a row split of at least 1 that
    leaves no block without a row group."""
    for m in range(2, ntt_mxu.MAX_MXU + 1):
        for B, A in ((1, 1), (300, 1), (65536, 1), (256, 256), (8, 70000)):
            g = ntt_mxu.tc_geometry(m, B, A)
            assert g.kp % 32 == 0 and m <= g.kp < m + 32, (m, g)
            assert g.rs == g.kp + 16 and (g.rs // 16) % 2 == 1, (m, g)
            assert g.smem == ntt_mxu.NL_S8 * (g.nt * g.rs + ntt_mxu.TC_STAGES * g.rg * 32)
            assert g.smem <= 232448, (m, g)  # a block's shared memory on sm_90
            n_rg = -(-m // g.rg)
            per = -(-n_rg // g.split)
            assert 1 <= g.split <= n_rg and (g.split - 1) * per < n_rg, (m, B, A, g)
            assert (g.nt // ntt_mxu.TC_WARP_COLS) * (g.rg // 16) == ntt_mxu.TC_WARPS


def test_tc_geometry_lane_forms():
    """The lane forms (K3, A = 1, the rows as the B columns): the same
    block as the strided form, the staged epilogue's rg + 2 words a column
    on top (its 8-byte stores from the fragment in 16 distinct 8-byte bank
    slots a half-warp), within a block's shared memory for every m, two
    blocks an SM at m <= 256 where the byte planes allow; a lane form
    refuses A > 1 and an unknown form."""
    for m in range(2, ntt_mxu.MAX_MXU + 1):
        for B in (1, 37, 256, 65536, 131072):
            s, lane, staged = (ntt_mxu.tc_geometry(m, B, 1, form=f) for f in ntt_mxu.TC_FORMS)
            assert lane == s, (m, B)
            assert staged.smem == s.smem + 8 * s.nt * (s.rg + 2) <= 232448, (m, B)
            assert staged.nt * staged.rg == 1024  # two 16-byte copies a thread
            if m <= 256:
                assert 2 * (staged.smem + 1024) <= 233472, m
    # the fragment's half-warp: rows lane >> 2 (0-3), columns 2 (lane & 3) + e
    for rg in (16, 32, 64, 128):
        sw = rg + 2
        for e in (0, 1):
            slots = {((2 * (ln & 3) + e) * sw + (ln >> 2)) % 16 for ln in range(16)}
            assert len(slots) == 16, rg
    with pytest.raises(ValueError):
        ntt_mxu.tc_geometry(256, 256, 2, form="lane")
    with pytest.raises(ValueError):
        ntt_mxu.tc_geometry(256, 256, form="row")


def test_tc_geometry_lane_roots():
    """The mxu plans' roots on K3: the 2^17 root (256 rows of 512) splits
    its row groups to fill the card; the 2^24 root (65536 x 256) and the
    2^26 root (131072 x 512, the planner's mxu split) fill it unsplit."""
    roots = {}
    for log2n in (17, 24, 26):
        plan = planner.build_plan(1 << log2n, "mxu")
        roots[log2n] = (plan.m0, plan.m1)
    assert roots == {17: (256, 512), 24: (65536, 256), 26: (131072, 512)}
    g17 = ntt_mxu.tc_geometry(512, 256, form="lane")
    assert g17.split == -(-512 // g17.rg) == 16 and -(-256 // g17.nt) * g17.split >= 128
    for rows, m in (roots[24], roots[26]):
        g = ntt_mxu.tc_geometry(m, rows, form="lane")
        assert g.split == 1 and -(-rows // g.nt) >= 2 * 132, (rows, m)


def test_tc_geometry_main_path():
    """The 2^24 plan's launches fill the card without a split; the 2^17
    plan's (16 and 8 column blocks) split their row groups."""
    for m, B, A in ((256, 1 << 16, 1), (256, 256, 256)):
        g = ntt_mxu.tc_geometry(m, B, A)
        assert g.split == 1 and -(-B // g.nt) * A >= 2 * 132
    for m, B in ((256, 512), (512, 256)):
        g = ntt_mxu.tc_geometry(m, B)
        assert g.split == -(-m // g.rg) > 1
        assert -(-B // g.nt) * g.split >= 128


@pytest.mark.parametrize("m", [2, 6, 48, 256])
def test_tc_plane_tiles_layout(rng, m):
    """The digit stack in the kernel's ring-tile layout: tile (row group,
    32-point step) holds, per digit plane, rg rows of 32 bytes -- the
    stack's bytes, 0 past m -- with the two 16-byte halves swapped in rows
    4-7 of every 8 (the kernel's a_slot)."""
    planes = rng.integers(-128, 128, (ntt_mxu.NL_S8 * m, m)).astype(np.int8)
    tiles = ntt_mxu.tc_plane_tiles(torch.from_numpy(planes), m).numpy()
    g = ntt_mxu.tc_geometry(m, 1)
    n_rg, ks_n = -(-m // g.rg), g.kp // 32
    D = np.zeros((ntt_mxu.NL_S8, n_rg * g.rg, g.kp), np.int8)
    D[:, :m, :m] = planes.reshape(ntt_mxu.NL_S8, m, m)
    assert tiles.size == D.size
    T = tiles.reshape(n_rg, ks_n, ntt_mxu.NL_S8, g.rg, 32)
    for r in range(n_rg):
        for s in range(ks_n):
            for row in range(g.rg):
                want = D[:, r * g.rg + row, 32 * s:32 * s + 32]
                if (row >> 2) & 1:
                    want = np.concatenate([want[:, 16:], want[:, :16]], axis=1)
                np.testing.assert_array_equal(T[r, s, :, row], want)


@pytest.mark.parametrize("m", [8, 48, 64])
def test_tc_accumulation_matches_plane_products(rng, m):
    """The kernel's K-chunked accumulation equals the plain version's
    planes on (2, m, 70) data (70 columns: not a multiple of the block's
    32), every partial sum within the planes' bound m << 17 (so int32
    accumulation never wraps).  m = 48 is no transform length: its digit
    planes are random int8 in [-128, 127], which the bound covers too."""
    mod = _flagship()
    if m == 48:
        planes = rng.integers(-128, 128, (ntt_mxu.NL_S8 * m, m)).astype(np.int8)
        t = ntt_mxu.MxuDirection(
            m, False, torch.from_numpy(planes), torch.zeros(m, dtype=torch.int64),
            mod.modulus, pow(2, 128, mod.modulus), pow(mod.modulus, -1, 1 << 64),
        )
    else:
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, device="cpu")
    x = from_numpy(rng.integers(0, 1 << 64, (2, m, 70), dtype=np.uint64))
    got, worst = _tc_planes(x, t)
    want, step, bias = ntt_mxu._plane_products(x, t)
    assert (step, bias) == (8, m << 17)
    for tt in range(15):
        assert torch.equal(got[tt], want[tt]), tt
    assert worst <= m << 17 < 2**31


def test_tc_accumulation_crafted_1024():
    """m = 1024 with the input that drives one plane maximally negative
    (each byte sign-opposes its digit, as chip_smoke.py's crafted_1024):
    the partial sums reach past 2^26 yet stay within m << 17 < 2^28, and
    the planes equal the plain version's."""
    mod = _flagship()
    m = 1024
    t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, device="cpu")
    D = t.planes.numpy().astype(np.int64).reshape(ntt_mxu.NL_S8, m, m)
    min_a = np.where(D > 0, -128 * D, 127 * D).sum(axis=2)
    worst_plane = np.zeros((15, m), dtype=np.int64)
    for a in range(8):
        for b in range(8):
            worst_plane[a + b] += min_a[a]
    tstar, pstar = np.unravel_index(np.argmin(worst_plane), worst_plane.shape)
    x = np.zeros(m, dtype=np.uint64)
    for j in range(m):
        v = 0
        for b in range(8):
            a = tstar - b
            s = 127 if 0 <= a < 8 and D[a, pstar, j] < 0 else -128
            v |= (s + 128) << (8 * b)
        x[j] = v
    x3 = from_numpy(x.reshape(1, m, 1))
    got, worst = _tc_planes(x3, t)
    want, _, _ = ntt_mxu._plane_products(x3, t)
    for tt in range(15):
        assert torch.equal(got[tt], want[tt]), tt
    assert abs(int(got[tstar][0, pstar, 0])) > 1 << 26
    assert worst <= m << 17


@pytest.mark.parametrize(
    "N,g,inverse,mode",
    [
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, False, "pair", id="flagship-fwd-pair"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, True, "w", id="test62-lazy-inv-w"),
    ],
)
def test_tc_accumulation_through_tail_matches_jax(rng, monkeypatch, N, g, inverse, mode):
    """The kernel's planes through the plain recombination tail equal the
    JAX kernel (interpret mode) bit for bit: lead orientation, m = 64, 37
    columns, a fused twiddle, forward on the flagship and a lazy inverse."""
    m = 64
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jfc, fc = JFieldConsts.from_modulus(jmod), FieldConsts.from_modulus(mod)
    jt = jmxu.make_mxu_tables(jmod, m, inverse=inverse)
    pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, device="cpu")
    x = rng.integers(0, N, (m, 37), dtype=np.uint64)
    x[:, 0] = N - 1
    w = rng.integers(0, N, (m, 37), dtype=np.uint64)
    wp = None
    if mode == "pair":
        with np.errstate(over="ignore"):
            wp = w * np.uint64(pow(N, -1, 1 << 64))
    jtw = JMontPair(u64_from_numpy(w), None if wp is None else u64_from_numpy(wp))
    ptw = MontPair(from_numpy(w), None if wp is None else from_numpy(wp))
    want = u64_to_numpy(jmxu.mxu_ntt(u64_from_numpy(x), jt, jfc, tw=jtw))
    monkeypatch.setattr(
        ntt_mxu, "_plane_products", lambda x3, t: (_tc_planes(x3, t)[0], 8, t.m << 17)
    )
    got = ntt_mxu.mxu_ntt(from_numpy(x), pt, fc, tw=ptw)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_cpu_counts_and_ab_point():
    """On the CPU the wrappers run the plain version and launch nothing;
    the __dp4a and staged-epilogue A/B points and the tensor-core launcher
    refuse what they do not take before touching a card."""
    mod = _flagship()
    fc = FieldConsts.from_modulus(mod)
    t = ntt_mxu.make_mxu_tables(mod, 8, inverse=False, device="cpu")
    tu = ntt_mxu.make_mxu_tables(mod, 8, inverse=False, scheme="u7", device="cpu")
    x = from_numpy(np.zeros((8, 3), np.uint64))
    ntt_mxu.KERNEL_LAUNCHES["dp4a"] = 5
    ntt_mxu.reset_counts()
    assert ntt_mxu.KERNEL_LAUNCHES == {"tensor_core": 0, "dp4a": 0}
    ntt_mxu.mxu_ntt(x, t, fc)
    ntt_mxu.mxu_ntt_mid(x.reshape(1, 8, 3), t, fc)
    ntt_mxu.mxu_ntt_lane(x.t(), t, fc, tw=MontPair(x.t(), None))
    assert ntt_mxu.PLAIN_CALLS == {"lead": 1, "mid": 1, "lane": 1}
    assert ntt_mxu.KERNEL_LAUNCHES == {"tensor_core": 0, "dp4a": 0}
    with pytest.raises(ValueError):
        ntt_mxu.mxu_ntt_lane(x.t(), t, fc, tw=MontPair(x, None))  # not the data's layout
    with pytest.raises(ValueError):
        ntt_mxu._launch_dp4a(x, t, fc)  # a CPU tensor
    with pytest.raises(ValueError):
        ntt_mxu._launch_dp4a(x.t(), tu, fc, lane=True)
    with pytest.raises(ValueError):
        ntt_mxu._launch_lane_form(x.t(), t, fc, "lane_staged")
    # u7 tables take the tensor-core route too; tables built on the CPU
    # hold no tile copy, and the launcher refuses them before any card
    assert t.tc_planes is None and tu.tc_planes is None
    for tables in (t, tu):
        with pytest.raises(ValueError, match="CUDA device"):
            ntt_mxu._launch_tc(x.reshape(1, 8, 3), tables, fc, None)
    ntt_mxu.reset_counts()


def _jax_root_step(x, jt, jfc, w, wp):
    """The JAX package's mxu root step on (rows, m) data with an (rows, m)
    table: a transpose, ``mxu_ntt`` with the transposed table, a transpose
    back (``sventt_tpu/plan/planner.py:563-574``, ``:623-634``)."""
    jtw = JMontPair(u64_from_numpy(np.ascontiguousarray(w.T)),
                    None if wp is None else u64_from_numpy(np.ascontiguousarray(wp.T)))
    y = jmxu.mxu_ntt(u64_from_numpy(np.ascontiguousarray(x.T)), jt, jfc, tw=jtw)
    return np.ascontiguousarray(u64_to_numpy(y).T)


@pytest.mark.parametrize(
    "N,g,mode,rows,emulate",
    [
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "pair", 37, True, id="flagship-pair-37-kernel"),
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "w", 64, False, id="flagship-w-64"),
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, "solinas", 37, False, id="flagship-solinas-37"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, "pair", 37, True, id="test62-lazy-pair-37-kernel"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, "w", 64, False, id="test62-lazy-w-64"),
        pytest.param(GOLDILOCKS_MODULUS, 7, "solinas", 37, False, id="goldilocks-solinas-37"),
    ],
)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_lane_twiddle_matches_jax_root(rng, monkeypatch, N, g, mode, rows, emulate, inverse):
    """``mxu_ntt_lane(x, tw=)`` (K3 with the level's (rows, m) table fused:
    prologue forward, epilogue inverse) equals the JAX package's root step
    bit for bit, lazy representatives included, before and after
    ``normalize``: m = 32, 37 (ragged) or 64 rows, every twiddle mode --
    pair, w, Solinas -- on the flagship, the lazy test modulus and
    Goldilocks.  ``emulate``: the planes come from the emulation of the
    kernel's K-chunked accumulation instead of the plain planes."""
    m = 32
    modmul = "solinas" if mode == "solinas" else "montgomery"
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jfc = JFieldConsts.from_modulus(jmod, modmul=modmul)
    fc = FieldConsts.from_modulus(mod, modmul=modmul)
    jt = jmxu.make_mxu_tables(jmod, m, inverse=inverse)
    pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, device="cpu")
    x = rng.integers(0, N, (rows, m), dtype=np.uint64)
    x[1] = N - 1
    w = rng.integers(0, N, (rows, m), dtype=np.uint64)
    w[:, 0] = N - 1
    wp = None
    if mode == "pair":
        with np.errstate(over="ignore"):
            wp = w * np.uint64(pow(N, -1, 1 << 64))
    want = _jax_root_step(x, jt, jfc, w, wp)
    if emulate:
        monkeypatch.setattr(
            ntt_mxu, "_plane_products", lambda x3, t: (_tc_planes(x3, t)[0], 8, t.m << 17)
        )
    ntt_mxu.reset_counts()
    got = ntt_mxu.mxu_ntt_lane(from_numpy(x), pt, fc, tw=MontPair(
        from_numpy(w), None if wp is None else from_numpy(wp)))
    assert ntt_mxu.PLAIN_CALLS == {"lead": 0, "mid": 0, "lane": 1}
    np.testing.assert_array_equal(to_numpy(got), want)
    want_n = u64_to_numpy(jfc.normalize(u64_from_numpy(want)))
    np.testing.assert_array_equal(to_numpy(fc.normalize(got)), want_n)


@pytest.mark.parametrize(
    "kw",
    [
        pytest.param(dict(), id="64x64"),
        pytest.param(dict(plan_spec="mxu:16,mxu:16,mxu"), id="spec-16x16x16"),
    ],
)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_unbatched_mxu_plan_matches_jax(rng, monkeypatch, kw, inverse):
    """The port's unbatched mxu plans at n = 2^12 (64 x 64; a three-level
    plan by ``plan_spec``), forward and inverse,
    equal the JAX package's plans elementwise: the root runs K3 with its
    table fused (``PLAIN_CALLS["lane"]``) and no transpose."""
    n = 1 << 12
    N, g = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR
    jntt = JNTT(JNttConfig(N, g, n, **kw), enable_forward=not inverse, enable_inverse=inverse)
    ntt = NTT(NttConfig(N, g, n, **kw), enable_forward=not inverse, enable_inverse=inverse,
              device="cpu")
    assert ntt.describe().splitlines()[0].endswith(
        "lane-axis mxu m1=%d (fused twiddle, no transposes)" % ntt.plan.m1)
    transposes = []
    inner = planner.transpose01
    monkeypatch.setattr(planner, "transpose01", lambda v: transposes.append(1) or inner(v))
    x = rng.integers(0, N, n, dtype=np.uint64)
    ntt_mxu.reset_counts()
    if inverse:
        got, want = ntt.inverse_numpy(x), jntt.inverse_numpy(x)
    else:
        got, want = ntt.forward_numpy(x), jntt.forward_numpy(x)
    levels = 2 if not kw else 3
    assert ntt_mxu.PLAIN_CALLS == {"lead": 1, "mid": levels - 2, "lane": 1}
    assert not transposes
    np.testing.assert_array_equal(got, np.asarray(want))

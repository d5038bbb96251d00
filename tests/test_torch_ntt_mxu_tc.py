"""PyTorch port, the s8 matrix NTT on the int8 tensor cores
(csrc/ntt_mxu_tc.cu): its routing, its launch geometry and its arithmetic.

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there, bitwise).  Here, on the CPU: which kernel each scheme
and orientation launches (a pure function); the launch geometry the wrapper
passes to the C entry, for every m; and an emulation of the kernel's
accumulation -- 32-deep K steps, K zero-padded to the geometry's ``kp``,
each (digit plane a, byte plane b) product added straight into plane a + b
in the kernel's order -- against ``_plane_products`` (the plain version's
planes) and, through the plain tail, against the JAX package's kernel in
interpret mode.  Inputs are made with numpy from a seed; every comparison
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
from sventt_tpu_torch.field.limb import FieldConsts, _shr, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_mxu
from sventt_tpu_torch.ops.twiddle import MontPair

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
    """s8 and s8b lead / mid run on the tensor cores; lane and u7 on
    __dp4a."""
    want = "tensor_core" if scheme != "u7" and orientation != "lane" else "dp4a"
    assert ntt_mxu.kernel_for(scheme, orientation) == want


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
    the __dp4a A/B point and the tensor-core launcher refuse what they do
    not take before touching a card."""
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
    assert ntt_mxu.PLAIN_CALLS == {"lead": 1, "mid": 1, "lane": 0}
    assert ntt_mxu.KERNEL_LAUNCHES == {"tensor_core": 0, "dp4a": 0}
    with pytest.raises(ValueError):
        ntt_mxu._launch_dp4a_s8(x, t, fc)  # a CPU tensor
    with pytest.raises(ValueError):
        ntt_mxu._launch_tc(x.reshape(1, 8, 3), tu, fc, None)  # u7 planes
    ntt_mxu.reset_counts()

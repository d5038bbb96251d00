"""PyTorch port, the u7 matrix NTT on the int8 tensor cores
(csrc/ntt_mxu_tc_u7.cu, the kernel body csrc/mxu_tc.cuh): its tile layout,
its launch geometry and its arithmetic, K11 included.

The kernel runs only on the card (chip_smoke.py holds it against the plain
version there, bitwise).  Here, on the CPU: the u7 planes in the kernel's
ring-tile layout; the launch geometry ``tc_geometry(..., scheme="u7")``
for every m and form; and an emulation of the kernel's u7 accumulation --
32-deep K steps, K zero-padded to the geometry's ``kp``, the 10 data
planes held at once (BG = 10), each (matrix plane a, data plane b)
product added straight into plane a + b in the kernel's order --
against ``_plane_products`` (the plain version's planes), every partial
sum within 10 * m * 127^2 < 2^31, and, through the plain tail, against the
JAX package's ``mxu_ntt`` / ``mxu_ntt_mid`` / ``mxu_ntt_lane`` with u7
tables in interpret mode and K11's own Pallas body.  Inputs are made with
numpy from a seed; every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_mxu_fused import _k11_namespace

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.field.modulus import Modulus as JModulus
from sventt_tpu.ops import ntt_mxu as jmxu
from sventt_tpu.ops.twiddle import MontPair as JMontPair
from sventt_tpu_torch.experimental import mxu_fused_kernel as fused
from sventt_tpu_torch.field.golden import GoldenNTT
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

#: Data planes the kernel holds in registers at once under u7
#: (csrc/mxu_tc.cuh Tc<true>::BG): the order in which it adds the products.
BG = 10

#: An SM's shared memory less the 1 KB reserved per block: blocks fit while
#: blocks * (smem + 1024) stays within it.
SM_SMEM = 233472


def _bound(m: int) -> int:
    """The largest u7 plane (and partial sum): 10 pairs of 7-bit planes."""
    return 10 * m * 127 * 127


def _u7_tc_planes(x3: torch.Tensor, t: ntt_mxu.MxuDirection):
    """The kernel's 19 product planes of (A, m, B) data, accumulated as it
    does, and the largest partial sum any plane held on the way."""
    A, m, B = x3.shape
    kp = ntt_mxu.tc_geometry(m, B, A, scheme="u7").kp
    D = torch.zeros(ntt_mxu.NL, m, kp, dtype=torch.int64)
    D[:, :, :m] = t.kernel_planes.to(torch.int64).reshape(ntt_mxu.NL, m, m)
    S = torch.zeros(ntt_mxu.NL, A, kp, B, dtype=torch.int64)  # zero past m
    for b in range(ntt_mxu.NL):
        S[b, :, :m] = _shr(x3, 7 * b) & 0x7F
    acc = [torch.zeros(A, m, B, dtype=torch.int64) for _ in range(2 * ntt_mxu.NL - 1)]
    worst = 0
    for k0 in range(0, kp, 32):
        for b0 in range(0, ntt_mxu.NL, BG):
            for a in range(ntt_mxu.NL):
                for b in range(b0, b0 + BG):
                    acc[a + b] += D[a, :, k0:k0 + 32] @ S[b, :, k0:k0 + 32]
                    worst = max(worst, int(acc[a + b].max()))
    return acc, worst


def _emulated(monkeypatch):
    """Run the plain tail on the emulated kernel planes."""
    monkeypatch.setattr(ntt_mxu, "_plane_products", lambda x3, t: (_u7_tc_planes(x3, t)[0], 7, 0))


def _flagship():
    return Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)


@pytest.mark.parametrize("m", [2, 6, 48, 256])
def test_u7_plane_tiles_layout(rng, m):
    """The u7 planes (10m, m) in the kernel's ring-tile layout: tile (row
    group, 32-point step) holds, per plane, rg rows of 32 bytes -- the
    planes' bytes, 0 past m -- with the two 16-byte halves swapped in rows
    4-7 of every 8 (the kernel's a_slot); ``tc_plane_tile_bytes`` is its
    size."""
    planes = rng.integers(0, 128, (ntt_mxu.NL * m, m)).astype(np.int8)
    tiles = ntt_mxu.tc_plane_tiles(torch.from_numpy(planes), m, "u7").numpy()
    g = ntt_mxu.tc_geometry(m, 1, scheme="u7")
    n_rg, ks_n = -(-m // g.rg), g.kp // 32
    D = np.zeros((ntt_mxu.NL, n_rg * g.rg, g.kp), np.int8)
    D[:, :m, :m] = planes.reshape(ntt_mxu.NL, m, m)
    assert tiles.size == D.size == ntt_mxu.tc_plane_tile_bytes(m, "u7")
    T = tiles.reshape(n_rg, ks_n, ntt_mxu.NL, g.rg, 32)
    for r in range(n_rg):
        for s in range(ks_n):
            for row in range(g.rg):
                want = D[:, r * g.rg + row, 32 * s:32 * s + 32]
                if (row >> 2) & 1:
                    want = np.concatenate([want[:, 16:], want[:, :16]], axis=1)
                np.testing.assert_array_equal(T[r, s, :, row], want)


def test_u7_tables_carry_no_tile_copy_on_the_cpu():
    """u7 tables built on the CPU hold no tile copy (the card's hold the
    layout above, as s8's do); s8's tile bytes are unchanged by u7's."""
    t = ntt_mxu.make_mxu_tables(_flagship(), 16, inverse=False, scheme="u7", device="cpu")
    assert t.tc_planes is None and t.kernel_planes is t.planes
    for m in (2, 128, 256, 1024):
        g = ntt_mxu.tc_geometry(m, 1)
        assert ntt_mxu.tc_plane_tile_bytes(m) == 8 * -(-m // g.rg) * g.rg * g.kp


def test_u7_geometry_every_m():
    """For every m the kernel takes and both of u7's forms (it has no
    staged epilogue): a block of 16 or 32 columns (the two u7 builds), K
    padded to a multiple of 32, the row stride an odd multiple of 16, the
    shared memory the 10 data planes and the 3-stage ring of the 10 matrix
    planes' tiles within a block's 232,448 bytes, two blocks an SM at
    m <= 256 as the rule promises (K11's m = 128 and the 2^24 shapes'
    m = 256), and a row split of at least 1 that leaves no block without a
    row group."""
    for m in range(2, ntt_mxu.MAX_MXU + 1):
        for B, A in ((1, 1), (300, 1), (32768, 1), (65536, 1), (256, 256), (8, 70000)):
            for form in ("strided", "lane") if A == 1 else ("strided",):
                g = ntt_mxu.tc_geometry(m, B, A, form=form, scheme="u7")
                assert g.nt in (16, 32), (m, g)
                assert g.kp % 32 == 0 and m <= g.kp < m + 32, (m, g)
                assert g.rs == g.kp + 16 and (g.rs // 16) % 2 == 1, (m, g)
                smem = ntt_mxu.NL * (g.nt * g.rs + ntt_mxu.TC_STAGES * g.rg * 32)
                assert g.smem == smem <= ntt_mxu.TC_MAX_SMEM, (m, form, g)
                if m <= 256:
                    assert 2 * (g.smem + 1024) <= SM_SMEM, (m, form, g)
                n_rg = -(-m // g.rg)
                per = -(-n_rg // g.split)
                assert 1 <= g.split <= n_rg and (g.split - 1) * per < n_rg, (m, B, A, g)
                assert (g.nt // ntt_mxu.TC_WARP_COLS) * (g.rg // 16) == ntt_mxu.TC_WARPS
    # the shapes of the 2^24 calls and of K11 fill the card unsplit
    for m, B, A in ((256, 1 << 16, 1), (256, 256, 256), (128, 1 << 15, 1)):
        g = ntt_mxu.tc_geometry(m, B, A, scheme="u7")
        assert g.split == 1 and -(-B // g.nt) * A >= 2 * 132, (m, B, A, g)
    assert ntt_mxu.tc_geometry(128, 1, scheme="u7").smem == 76800
    assert ntt_mxu.tc_geometry(256, 1, scheme="u7").smem == 104960
    with pytest.raises(ValueError):
        ntt_mxu.tc_geometry(256, 256, scheme="u8")
    with pytest.raises(ValueError):
        ntt_mxu.tc_geometry(256, 256, form="lane_staged", scheme="u7")
    z = torch.zeros(1, dtype=torch.int64)
    for inverse in (False, True):
        for tw in (None, MontPair(z, z), MontPair(z, None)):
            assert ntt_mxu.tc_form("lane", inverse, tw, "u7") == "lane"


@pytest.mark.parametrize("m", [48, 128, 256, 1024])
def test_u7_block_width_binds_tiles_and_geometry(rng, m):
    """``tc_columns`` is the width ``tc_geometry`` takes by default; a block
    of the other u7 width (``nt=``, the geometry A/B point) lays its tile
    copy out for its own row group, which ``tc_plane_tiles(..., nt=)``
    builds; tables carry the width they were laid out for
    (``MxuDirection.tc_nt``); a width u7 is not built for, or a block over
    the shared memory, raises."""
    for scheme in ntt_mxu.SCHEMES:
        assert ntt_mxu.tc_geometry(m, 1, scheme=scheme).nt == ntt_mxu.tc_columns(m, scheme)
    planes = rng.integers(0, 128, (ntt_mxu.NL * m, m)).astype(np.int8)
    for nt in ntt_mxu.tc_block_columns("u7"):
        rg = 16 * ntt_mxu.TC_WARPS * ntt_mxu.TC_WARP_COLS // nt
        smem = ntt_mxu.NL * (nt * (-(-m // 32) * 32 + 16) + ntt_mxu.TC_STAGES * rg * 32)
        if smem > ntt_mxu.TC_MAX_SMEM:
            with pytest.raises(ValueError):
                ntt_mxu.tc_geometry(m, 1, scheme="u7", nt=nt)
            continue
        g = ntt_mxu.tc_geometry(m, 1 << 15, scheme="u7", nt=nt)
        assert (g.nt, g.rg, g.smem) == (nt, rg, smem), (m, g)
        tiles = ntt_mxu.tc_plane_tiles(torch.from_numpy(planes), m, "u7", nt)
        assert tiles.numel() == ntt_mxu.NL * -(-m // g.rg) * g.rg * g.kp
        if nt == ntt_mxu.tc_columns(m, "u7"):
            rule = ntt_mxu.tc_plane_tiles(torch.from_numpy(planes), m, "u7")
            assert torch.equal(tiles, rule)
    for nt in (8, 64):
        with pytest.raises(ValueError):
            ntt_mxu.tc_geometry(m, 1, scheme="u7", nt=nt)
    t = ntt_mxu.make_mxu_tables(_flagship(), 16, inverse=False, scheme="u7", device="cpu")
    other = dataclasses.replace(t, tc_nt=32)
    assert other.tc_nt == 32 and t.tc_nt is None and other.planes is t.planes


@pytest.mark.parametrize("m", [8, 48, 128])
def test_u7_accumulation_matches_plane_products(rng, m):
    """The kernel's K-chunked accumulation in its BG order equals the plain
    version's planes on (2, m, 70) full-range data (70 columns: not a
    multiple of the block's), every partial sum within 10 * m * 127^2.
    m = 48 is no transform length: its planes are random 7-bit values."""
    mod = _flagship()
    if m == 48:
        planes = rng.integers(0, 128, (ntt_mxu.NL * m, m)).astype(np.int8)
        t = ntt_mxu.MxuDirection(
            m, False, torch.from_numpy(planes), None, mod.modulus,
            pow(2, 128, mod.modulus), pow(mod.modulus, -1, 1 << 64), "u7",
        )
    else:
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="u7", device="cpu")
    x = from_numpy(rng.integers(0, 1 << 64, (2, m, 70), dtype=np.uint64))
    got, worst = _u7_tc_planes(x, t)
    want, step, bias = ntt_mxu._plane_products(x, t)
    assert (step, bias, len(want)) == (7, 0, 19)
    for tt in range(19):
        assert torch.equal(got[tt], want[tt]), tt
    assert 0 < worst <= _bound(m) < 2**31


def test_u7_accumulation_all_ones_1024():
    """m = 1024 with 2^64 - 1 in every point (data planes 0-8 at 127, plane
    9 at 1), chip_smoke.py's u7 worst case: the partial sums pass 2^26 and
    stay within 10 * m * 127^2 < 2^27.4, the planes equal the plain
    version's, and the plain tail on them gives the golden model."""
    mod = _flagship()
    m = 1024
    t = ntt_mxu.make_mxu_tables(mod, m, inverse=False, scheme="u7", device="cpu")
    x3 = from_numpy(np.full((1, m, 1), (1 << 64) - 1, dtype=np.uint64))
    got, worst = _u7_tc_planes(x3, t)
    want, _, _ = ntt_mxu._plane_products(x3, t)
    for tt in range(19):
        assert torch.equal(got[tt], want[tt]), tt
    assert 1 << 26 < worst <= _bound(m) < 1 << 28
    fc = FieldConsts.from_modulus(mod)
    out = ntt_mxu._mxu_plain(x3, t, fc, None)
    golden = GoldenNTT(m, mod).forward([((1 << 64) - 1) % mod.modulus] * m)
    assert [int(v) for v in to_numpy(out).ravel()] == golden


def _jax_tables(N, g, m, inverse):
    jmod, mod = JModulus(N, g), Modulus(N, g)
    jt = jmxu.make_mxu_tables(jmod, m, inverse=inverse, scheme="u7")
    pt = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme="u7", device="cpu")
    return jt, pt, JFieldConsts.from_modulus(jmod), FieldConsts.from_modulus(mod)


def _pair(rng, N, shape, mode):
    """Random inter-step twiddles (JAX MontPair, port MontPair); "pair"
    carries the companion."""
    w = rng.integers(0, N, shape, dtype=np.uint64)
    w.flat[0] = N - 1
    wp = None
    if mode == "pair":
        with np.errstate(over="ignore"):
            wp = w * np.uint64(pow(N, -1, 1 << 64))
    return (JMontPair(u64_from_numpy(w), None if wp is None else u64_from_numpy(wp)),
            MontPair(from_numpy(w), None if wp is None else from_numpy(wp)))


@pytest.mark.parametrize(
    "orientation,N,g,inverse,mode,shape",
    [
        pytest.param("lead", FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, False, "pair", (64, 37),
                     id="lead-flagship-fwd-pair"),
        pytest.param("mid", TEST_MODULUS, TEST_GENERATOR, True, "w", (3, 32, 37),
                     id="mid-test62-lazy-inv-w"),
        pytest.param("lane", FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, True, None, (37, 32),
                     id="lane-flagship-inv"),
    ],
)
def test_u7_accumulation_through_tail_matches_jax(rng, monkeypatch, orientation, N, g, inverse,
                                                   mode, shape):
    """The kernel's u7 planes through the plain recombination tail equal
    the JAX package's kernel (interpret mode) bit for bit, lazy
    representatives included, before and after ``normalize``: K1 with the
    pair twiddle fused, K2 with the w twiddle on the lazy test modulus, K3
    (JAX's lane kernel takes no twiddle); 37 columns or rows, ragged to
    every block."""
    m = shape[0] if orientation == "lead" else shape[1]
    jt, pt, jfc, fc = _jax_tables(N, g, m, inverse)
    x = rng.integers(0, N, shape, dtype=np.uint64)
    x.flat[0] = N - 1
    jx = u64_from_numpy(x)
    if orientation == "lead":
        jtw, ptw = _pair(rng, N, shape, mode)
        want = jmxu.mxu_ntt(jx, jt, jfc, tw=jtw)
    elif orientation == "mid":
        jtw, ptw = _pair(rng, N, shape[:2], mode)
        want = jmxu.mxu_ntt_mid(jx, jt, jfc, tw=jtw)
    else:
        ptw = None
        want = jmxu.mxu_ntt_lane(jx, jt, jfc)
    _emulated(monkeypatch)
    call = {"lead": ntt_mxu.mxu_ntt, "mid": ntt_mxu.mxu_ntt_mid, "lane": ntt_mxu.mxu_ntt_lane}
    ntt_mxu.reset_counts()
    got = call[orientation](from_numpy(x), pt, fc, ptw)
    assert ntt_mxu.PLAIN_CALLS[orientation] == 1
    want = u64_to_numpy(want)
    np.testing.assert_array_equal(to_numpy(got), want)
    want_n = u64_to_numpy(jfc.normalize(u64_from_numpy(want)))
    np.testing.assert_array_equal(to_numpy(fc.normalize(got)), want_n)


def test_k11_accumulation_matches_k11_body(rng, monkeypatch):
    """K11, the u7 lead form at m = 128: the kernel's planes through the
    plain tail equal the JAX prototype's own Pallas body (its definitions
    run as tests/test_torch_mxu_fused.py runs them, interpret mode) on a
    (128, 128) tile of random values with an N - 1 column, and the golden
    model."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    ns = _k11_namespace()
    R, N = 128, ns["N"]
    x = rng.integers(0, N, (R, R), dtype=np.uint64)
    x[:, 5] = N - 1
    call = pl.pallas_call(
        ns["kernel"],
        out_shape=[jax.ShapeDtypeStruct((R, R), jnp.uint32)] * 2,
        grid=(1,),
        in_specs=[ns["x_spec"], ns["x_spec"], ns["m_spec"]],
        out_specs=[ns["x_spec"]] * 2,
        interpret=True,
    )
    oh, ol = call(jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
                  jnp.asarray(x.astype(np.uint32)), ns["M_stack"])
    want = (np.asarray(oh).astype(np.uint64) << np.uint64(32)) | np.asarray(ol).astype(np.uint64)
    mod = _flagship()
    _emulated(monkeypatch)
    fused.reset_counts()
    got = to_numpy(fused.mxu_fused_ntt(from_numpy(x), fused.make_fused_stack(mod, device="cpu"), mod))
    assert fused.PLAIN_CALLS == {"fused": 1}
    np.testing.assert_array_equal(got, want)
    golden = GoldenNTT(R, mod)
    for col in (0, 5):
        assert [int(v) for v in got[:, col]] == golden.forward([int(v) for v in x[:, col]])

"""PyTorch port, the register schedule of the grouped kernel (K7 leaf, K8
lane; csrc/ntt_grouped.cu ``grouped_reg_kernel``): a model of it on the CPU.

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there, bitwise).  Here a torch model replays its schedule,
built from the host function the wrapper uses (``grouped_geometry``) and
the kernel's own index formulas: the copy of a tile (and its twiddles)
into the swizzled shared-memory tile, which 2^R points each thread holds
in each group (set ``q + r * tpc``, points ``base + k L``), the exchange
through that tile between groups, the staged table span and constant
slots, the presence mask and K7's first-point rule.  Run
through the field arithmetic of the plain version, it must equal
``_groups_plain`` bit for bit; every output is written once and every
exchange is a permutation of the tile.  The geometry's limits and the
tile's bank pattern are checked for every length.  No JAX here: the plain
version is held against the JAX package by test_torch_ntt_grouped*.py.
Inputs are made with numpy from a seed; every comparison is exact.
"""

import os
import re

import numpy as np
import pytest
import torch

from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, s64
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_pallas as P
from sventt_tpu_torch.ops.twiddle import MontPair

#: The kernel's tile swizzle: word w sits at w ^ SWIZZLE[(w >> 4) & 15] --
#: in the lane orientation, and in the leaf one below 16 columns a tile.
SWIZZLE = torch.tensor([0, 15, 10, 5, 12, 3, 6, 9, 8, 7, 2, 13, 4, 11, 14, 1])
KERNEL = os.path.join(os.path.dirname(P.__file__), "..", "csrc", "ntt_grouped.cu")


def _slot(w: torch.Tensor, swizzled: bool = True) -> torch.Tensor:
    return w ^ SWIZZLE[(w >> 4) & 15] if swizzled else w


def _swizzled(geo, lane: bool) -> bool:
    return lane or geo.cols < 16


def _c(geo, lane: bool, tid: torch.Tensor) -> torch.Tensor:
    """The batch entry of thread (q, c) within its tile."""
    return tid // geo.tpc if lane else tid % geo.cols


def _sets(geo, m: int, spec, lane: bool):
    """Per round r of a group: (thread ids, their set indices) of the
    threads that own a set, thread (q, c) taking sets q, q + tpc, ..."""
    tid = torch.arange(geo.threads)
    q = tid % geo.tpc if lane else tid // geo.cols
    nsets = m >> spec.R
    for r in range(-(-nsets // geo.tpc)):
        s = q + r * geo.tpc
        yield tid[s < nsets], s[s < nsets]


def _points(spec, sets: torch.Tensor):
    """(lo, points (threads, 2^R)) of the sets: base + k L."""
    log2L = spec.L.bit_length() - 1
    lo = sets & (spec.L - 1)
    base = ((sets >> log2L) << (log2L + spec.R)) + lo
    return lo, base[:, None] + torch.arange(1 << spec.R) * spec.L


def _words(geo, m: int, lane: bool, tid: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Tile slots of points j of the threads ``tid``: leaf (j, c) at j C + c,
    lane (c, j) at c m + j; swizzled where the kernel swizzles."""
    c = _c(geo, lane, tid)[:, None]
    return _slot(c * m + j if lane else j * geo.cols + c, _swizzled(geo, lane))


def _model(x3, t, fc: FieldConsts, lane: bool, tw3=None):
    """The register kernel on the contiguous (A, m, B) tensor ``x3`` (lane:
    (rows, m, 1)), as the wrapper calls it; returns the output like x3."""
    dims, (sa, sm, sb), (ta, tm, tb) = P._view(x3, lane)
    A, m, B = dims
    tw_words = 0 if tw3 is None else (1 if tw3.wp is None else 2)
    geo = P.grouped_geometry(m, t.specs, B, lane, A, tw_words)
    xf, out = x3.reshape(-1), torch.zeros(x3.numel(), dtype=torch.int64)
    writes = torch.zeros(x3.numel(), dtype=torch.int64)
    twf = None if tw3 is None else [None if v is None else v.reshape(-1) for v in tw3]
    two_n = 2 * fc.modulus  # used by a lazy modulus only (N < 2^62)
    tiles = -(-B // geo.cols)
    G = len(t.specs)
    idx = torch.arange(geo.tile_words)  # the tile's words: leaf j C + c, lane c m + j
    cj = (idx // m, idx % m) if lane else (idx % geo.cols, idx // geo.cols)

    def twiddle(v, sl):
        return P.inter_step_mul(fc, v, MontPair(TW[0][sl], None if TW[1] is None else TW[1][sl]))

    for wk in range(tiles * A):
        a, tile = divmod(wk, tiles)
        # the copy into the tile: word idx at slot(idx), zeros past B
        col = tile * geo.cols + cj[0]
        ok = col < B
        src = torch.where(ok, a * sa + cj[1] * sm + col * sb, 0)
        T = torch.zeros(geo.tile_words, dtype=torch.int64)
        T[_slot(idx, _swizzled(geo, lane))] = torch.where(ok, xf[src], 0)
        if tw3 is not None:
            tsrc = torch.where(ok, a * ta + cj[1] * tm + col * tb, 0)
            TW = [None if v is None else torch.zeros_like(T) for v in twf]
            for buf, v in zip(TW, twf):
                if v is not None:
                    buf[_slot(idx, _swizzled(geo, lane))] = torch.where(ok, v[tsrc], 0)
        for g, spec in enumerate(t.specs):
            R, L, K = spec.R, spec.L, 1 << spec.R
            first, last, scaled = g == 0, g == G - 1, t.inverse and g == G - 1
            # the block's staged copies: one table span, the constant pairs, the mask
            tw_, twp_ = t.w[g, : spec.span], t.wp[g, : spec.span]
            cs = t.consts[g].reshape(P.GROUP_CONSTS, 2)
            mask = t.const_mask[g].reshape(-1).tolist()
            written = []
            for tid, sets in _sets(geo, m, spec, lane):
                col = (tile * geo.cols + _c(geo, lane, tid))[:, None]
                valid = col < B
                lo, j = _points(spec, sets)
                lo = lo[:, None]
                gidx = torch.where(valid, a * sa + j * sm + col * sb, 0)
                slots = _words(geo, m, lane, tid, j)
                v = T[slots]
                if first and tw3 is not None and not t.inverse:
                    v = twiddle(v, slots)
                v = list(v.unbind(1))
                for s in range(R):
                    half = 1 << (s if t.inverse else R - 1 - s)
                    for k in range(K):
                        if k & half:
                            continue
                        k1, low = k + half, k & (half - 1)
                        has = mask[s * P.MAX_LOWS + low]
                        cw, cwp = cs[s * P.MAX_LOWS + low]
                        x0, x1 = v[k], v[k1]
                        tab = [(tw_[kk * L + lo[:, 0]], twp_[kk * L + lo[:, 0]]) for kk in (k, k1)]
                        if not t.inverse:
                            y0 = fc.add(x0, x1)
                            if has:
                                d = (x0 - x1 + two_n) if fc.lazy and not lane else fc.sub(x0, x1)
                                d = fc.twiddle_mul(d, cw, cwp)
                            else:
                                d = fc.sub(x0, x1)
                            if s == R - 1:
                                if lane or k != 0:
                                    y0 = fc.twiddle_mul(y0, *tab[0])
                                d = fc.twiddle_mul(d, *tab[1])
                            v[k], v[k1] = y0, d
                        else:
                            tt = x1
                            if s == 0:
                                if lane or scaled or k != 0:
                                    x0 = fc.twiddle_mul(x0, *tab[0])
                                tt = fc.twiddle_mul(x1, *tab[1])
                            elif has:
                                tt = fc.twiddle_mul(x1, cw, cwp)
                            v[k], v[k1] = fc.add(x0, tt), fc.sub(x0, tt)
                v = torch.stack(v, 1)
                if last:
                    if tw3 is not None and t.inverse:
                        v = twiddle(v, slots)
                    out[gidx[valid.expand_as(gidx)]] = v[valid.expand_as(v)]
                    writes.index_add_(0, gidx[valid.expand_as(gidx)],
                                      torch.ones(int(valid.expand_as(gidx).sum()), dtype=torch.int64))
                else:
                    T[slots] = v
                    written.append(slots.reshape(-1))
            if not last:  # the exchange writes every tile word once
                assert torch.equal(torch.cat(written).sort().values, torch.arange(geo.tile_words))
    assert torch.equal(writes, torch.ones_like(writes)), "an output written twice or never"
    return out.reshape(x3.shape)


FLAG = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
TEST = Modulus(TEST_MODULUS, TEST_GENERATOR)
# (name, modulus, modmul): canonical Montgomery; lazy Montgomery and Shoup
ENGINES = [("flagship", FLAG, "montgomery"), ("test62-mont", TEST, "montgomery"),
           ("test62-shoup", TEST, "shoup")]


def _input(rng, shape, fc: FieldConsts):
    """Values below N (below 2N for a lazy modulus), one N - 1 included."""
    top = (2 if fc.lazy else 1) * fc.modulus
    v = rng.integers(0, top, size=shape, dtype=np.uint64)
    v.reshape(-1)[0] = fc.modulus - 1
    return from_numpy(v)


def _twiddle(rng, shape, fc: FieldConsts, pair: bool) -> MontPair:
    w = from_numpy(rng.integers(0, fc.modulus, size=shape, dtype=np.uint64))
    return MontPair(w, w * s64(fc.montgomery_inverse) if pair else None)


@pytest.mark.parametrize("lane", [False, True], ids=["leaf", "lane"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("name,mod,modmul", ENGINES, ids=[e[0] for e in ENGINES])
def test_register_schedule_matches_plain(name, mod, modmul, inverse, lane):
    """m in {2, 8, 64, 256}, max_r 2..4: the model equals _groups_plain
    bitwise; the lane with a fused "pair" twiddle, the leaf also on an
    (A, m, B) view with A = 2 and a ragged batch."""
    fc = FieldConsts.from_modulus(mod, modmul=modmul)
    rng = np.random.default_rng(8 + 2 * inverse + lane)
    for m in (2, 8, 64, 256):
        for max_r in (2, 3, 4):
            kw = dict(inverse=inverse, modmul=modmul, max_r=max_r, device="cpu")
            if lane:
                t = P.make_lane_tables(mod, m, **kw)
                x3 = _input(rng, (11, m, 1), fc)
                tw = _twiddle(rng, (11, m, 1), fc, pair=m != 8)
                want = P._groups_plain(x3, t, fc, True, tw)
                assert torch.equal(_model(x3, t, fc, True, tw), want), (m, max_r)
                assert torch.equal(_model(x3, t, fc, True), P._groups_plain(x3, t, fc, True))
            else:
                t = P.make_leaf_tables(mod, m, **kw)
                for shape in ((1, m, 40), (2, m, 7)):
                    x3 = _input(rng, shape, fc)
                    want = P._groups_plain(x3, t, fc, False)
                    assert torch.equal(_model(x3, t, fc, False), want), (m, max_r, shape)


def test_tables_are_periodic_in_span():
    """The kernel stages one span of each combined table (its row period,
    ``GroupSpec.span``): the built tables repeat with it."""
    for m in (8, 64, 256, 1024):
        for max_r in (2, 3, 4):
            for inverse in (False, True):
                t = P.make_leaf_tables(FLAG, m, inverse=inverse, max_r=max_r, device="cpu")
                for g, spec in enumerate(t.specs):
                    for tab in (t.w[g], t.wp[g]):
                        assert torch.equal(tab.reshape(-1, spec.span), tab[: spec.span].expand(m // spec.span, -1))


def _all_specs():
    for log2m in range(1, 13):
        m = 1 << log2m
        for max_r in (2, 3, 4):
            for inverse in (False, True):
                fn = P._inverse_group_values if inverse else P._forward_group_values
                args = (FLAG, m, "montgomery", 1, max_r) if inverse else (FLAG, m, "montgomery", max_r)
                yield m, max_r, inverse, fn(*args)[0]


def _kernel_smem(geo, specs, tw_words: int) -> int:
    """The C entry's layout: the tile and one of each twiddle word, table
    spans, constant pairs, masks."""
    return (8 * geo.tile_words * (1 + tw_words) + 16 * sum(s.span for s in specs)
            + len(specs) * (16 * P.GROUP_CONSTS + 4))


@pytest.mark.parametrize("lane", [False, True], ids=["leaf", "lane"])
def test_geometry_limits(lane):
    """Every m in 2..4096, max_r 2..4, both directions, several batches,
    each fused twiddle: the shared memory fits a block (and equals the C
    entry's layout), a block has at most GROUPED_THREADS threads, every
    thread owns a set in every group, and the tiles cover every batch
    entry once."""
    for m, max_r, inverse, specs in _all_specs():
        for B in (1, 5, 40, 512, 65536):
            for A, tw_words in ((1, 0), (3, 0), (1, 1), (1, 2)):
                geo = P.grouped_geometry(m, specs, B, lane, A, tw_words)
                assert geo.smem <= P.MAX_SMEM and geo.smem == _kernel_smem(geo, specs, tw_words)
                assert geo.threads == geo.cols * geo.tpc <= P.GROUPED_THREADS
                assert geo.tpc <= m >> max(s.R for s in specs)
                assert geo.tile_words == geo.cols * m
                cols = torch.arange(-(-B // geo.cols))[:, None] * geo.cols + torch.arange(geo.cols)
                assert torch.equal(cols[cols < B], torch.arange(B))


def test_geometry_at_the_plans_shapes():
    """The 2^24 plan's launches (K7 256 x 65536; K8 65536 rows of 256, pair
    twiddle) take blocks of 256 threads (128 for K8 at max_r 4) whose
    shared memory lets three share an SM, as the kernel's launch bounds do for its registers where
    no group has 4 ranks (two with 4); the 2^17 plan's (K7 256 x 512, K8
    256 rows of 512) run on 128 and 256 blocks, not 16-32."""
    src = open(KERNEL).read()
    assert "__launch_bounds__(REG_THREADS, reg_blocks<RMAX, INV, LAZY, LANE, SWZ>())" in src
    assert "constexpr int REG_THREADS = 256;" in src
    assert "return RMAX <= 3 ? (LAZY || (SWZ && !LANE) ? 2 : 3)" in src
    for max_r in (2, 3, 4):
        for inverse in (False, True):
            for lane, tw_words in ((False, 0), (True, 2)):
                t = P.make_leaf_tables(FLAG, 256, inverse=inverse, max_r=max_r, device="cpu")
                geo = P.grouped_geometry(256, t.specs, 65536, lane, 1, tw_words)
                assert geo.threads >= P.GROUPED_THREADS // 2
                assert 3 * (geo.smem + 1024) <= 233472, (max_r, lane, geo)
                assert -(-65536 // geo.cols) >= 2 * 132
    t3 = P.make_leaf_tables(FLAG, 256, inverse=False, max_r=3, device="cpu")
    assert P.grouped_geometry(256, t3.specs, 65536, False) == P.GroupedGeometry(
        32, 8, 256, 8192, 256 + 32 + 4, 8 * 8192 + 16 * 292 + 3 * 516)
    k8 = P.grouped_geometry(256, t3.specs, 65536, True, 1, 2)
    assert (k8.cols, k8.tpc, k8.threads) == (8, 32, 256)
    leaf17 = P.grouped_geometry(256, t3.specs, 512, False)
    assert (leaf17.cols, -(-512 // leaf17.cols)) == (4, 128)
    t9 = P.make_lane_tables(FLAG, 512, inverse=False, max_r=3, device="cpu")
    lane17 = P.grouped_geometry(512, t9.specs, 256, True, 1, 2)
    assert (lane17.cols, lane17.tpc, -(-256 // lane17.cols)) == (1, 64, 256)


def test_exchange_is_free_of_bank_conflicts():
    """Every group that reads or writes the tile: at each point k and
    round, each half-warp's 8-byte accesses fall on 16 distinct bank pairs
    (slot mod 16) -- in the leaf orientation always (unswizzled from 16
    columns a tile on, where a half-warp is one point's row), in the lane
    orientation wherever a half-warp lies in one row (tpc >= 16, every
    lane launch of m >= 256); the lane tiles of m <= 128, where a
    half-warp spans rows, see at most four-way conflicts (no pad of the
    rows and no other linear swizzle of the word's bits 4-7 clears them
    all).  Every m and max_r, at the plans' batch sizes and at small
    ones."""
    for m, max_r, inverse, specs in _all_specs():
        if len(specs) == 1:
            continue
        for lane in (False, True):
            for B in (40, 512, 65536):
                geo = P.grouped_geometry(m, specs, B, lane)
                rows = -(-geo.threads // 16) * 16
                worst = 1
                for spec in specs:
                    for tid, sets in _sets(geo, m, spec, lane):
                        # a thread without a set takes a bank of its own
                        banks = (16 + torch.arange(rows))[:, None].repeat(1, 1 << spec.R)
                        banks[tid] = _words(geo, m, lane, tid, _points(spec, sets)[1]) & 15
                        hw = banks.reshape(rows // 16, 16, -1)
                        same = (hw[:, :, None, :] == hw[:, None, :, :]).sum(dim=2)
                        worst = max(worst, int(same.max()))
                if not lane or geo.tpc >= 16:
                    assert worst == 1, (m, max_r, inverse, lane, B)
                else:
                    assert m <= 128 and worst <= 4, (m, max_r, inverse, lane, B, worst)

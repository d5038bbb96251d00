"""PyTorch port, the register schedule of the radix-2 butterfly kernel (K4
leaf, K5 mid; csrc/ntt_radix2.cu ``radix2_reg_kernel``): a model of it on
the CPU, and of the narrow Solinas multiply every Solinas kernel shares
(csrc/field.cuh ``solinas_mul``).

The kernels run only on the card (chip_smoke.py holds them against the
plain version there, bitwise).  Here a torch model replays the register
kernel's schedule, built from the host function the wrapper uses
(``butterfly_geometry``) and the kernel's own index formulas: the split of
a stage range into groups, which 2^R points each (set, column) unit holds
in each group (``base + k L``), the first group's reads from and the last
group's writes to device memory (the fused inter-step twiddle there), the
exchange through the swizzled tile between groups, the staged slice of the
stage tables and the twiddle index ``(h + k mod h) L + lo - 1``, the
scaled last inverse stage, and the ``spc`` launches.  Run through the field
arithmetic of the plain version, it must equal ``_stages_plain`` bit for
bit in every multiply mode; every output is written once and every
exchange is a permutation of the tile.  The geometry's limits and the
exchange's bank pattern are checked at the plans' lengths.  The narrow
Solinas multiply is replayed on Python integers, its intermediate words
held to the widths it assumes.  No JAX here: the plain version is held
against the JAX package by test_torch_ntt_pallas*.py and _solinas*.py.
Inputs are made with numpy from a seed; every comparison is exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, s64
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import ntt_pallas as P
from sventt_tpu_torch.ops.twiddle import MontPair, inter_step_mul

CSRC = os.path.join(os.path.dirname(P.__file__), "..", "csrc")
#: The tile swizzle (csrc/reg_tile.cuh slot()): word w sits at
#: w ^ SWIZZLE[(w >> 4) & 15] below 16 columns a tile.
SWIZZLE = torch.tensor([0, 15, 10, 5, 12, 3, 6, 9, 8, 7, 2, 13, 4, 11, 14, 1])

FLAG = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
TEST = Modulus(TEST_MODULUS, TEST_GENERATOR)
GOLD = Modulus(GOLDILOCKS_MODULUS, 7)
# (name, modulus, modmul): canonical Montgomery; lazy Montgomery and Shoup;
# Solinas on the flagship and Goldilocks moduli
ENGINES = [("flagship", FLAG, "montgomery"), ("test62-mont", TEST, "montgomery"),
           ("test62-shoup", TEST, "shoup"), ("flagship-solinas", FLAG, "solinas"),
           ("goldilocks-solinas", GOLD, "solinas")]


def _slot(w: torch.Tensor, swizzled: bool) -> torch.Tensor:
    return w ^ SWIZZLE[(w >> 4) & 15] if swizzled else w


def _units(geo, m: int, R: int):
    """(unit ids, set, column) of a group of R stages: unit u = set * cols
    + column, thread u mod threads taking units u, u + threads, ..."""
    log2c = geo.cols.bit_length() - 1
    u = torch.arange((m >> R) << log2c)
    return u, u >> log2c, u & (geo.cols - 1)


def _points(R: int, log2L: int, sets: torch.Tensor) -> torch.Tensor:
    """(units, 2^R) points base + k L of the sets (reg_tile.cuh set_base)."""
    lo = sets & ((1 << log2L) - 1)
    base = ((sets >> log2L) << (log2L + R)) + lo
    return base[:, None] + torch.arange(1 << R) * (1 << log2L)


def _row(tw: MontPair, j: torch.Tensor) -> MontPair:
    """Entries j of a staged twiddle row."""
    return MontPair(tw.w[j], None if tw.wp is None else tw.wp[j])


def _storage(x3: torch.Tensor) -> torch.Tensor:
    """The flat storage a (possibly strided) view of offset 0 indexes."""
    return torch.as_strided(x3, (x3.untyped_storage().nbytes() // 8,), (1,), 0)


def _butterflies(v, t, fc: FieldConsts, geo, R: int, log2L: int, tb, scaled: bool, lane: bool):
    """The R stages of a group on the (units, 2^R) points ``v`` of each
    unit's set (``tb`` its table base), from the block's staged slice of
    the stage tables, as the kernel's ``butterflies``: the forward
    difference reduced (``lane``, K6) or biased by +2N when lazy (K4, K5);
    ``scaled``: the group's last rank is the last inverse stage."""
    tab_w = t.w[geo.tab_lo: geo.tab_lo + geo.tab_entries]
    tab_wp = None if t.wp is None else t.wp[geo.tab_lo: geo.tab_lo + geo.tab_entries]
    two_n = 2 * s64(fc.modulus)  # read by a lazy modulus only (N < 2^62)
    v = list(v.unbind(1))
    for s in range(R):
        h = 1 << s if t.inverse else 1 << (R - 1 - s)
        for k in range(1 << R):
            if k & h:
                continue
            i = ((h + (k & (h - 1))) << log2L) + tb
            assert int(i.min()) >= 0 and int(i.max()) < geo.tab_entries
            w, wp = tab_w[i], None if tab_wp is None else tab_wp[i]
            x0, x1 = v[k], v[k + h]
            if not t.inverse:
                y0 = fc.add(x0, x1)
                d = (x0 - x1 + two_n) if fc.lazy and not lane else fc.sub(x0, x1)
                y1 = fc.twiddle_mul(d, w, wp)
            elif scaled and s == R - 1:
                sc, scp = (None if q is None else torch.full_like(x0, s64(q)) for q in t.scale)
                a0, b1 = fc.twiddle_mul(x0, sc, scp), fc.twiddle_mul(x1, w, wp)
                y0, y1 = fc.add(a0, b1), fc.sub(a0, b1)
            else:
                tt = fc.twiddle_mul(x1, w, wp)
                y0, y1 = fc.add(x0, tt), fc.sub(x0, tt)
            v[k], v[k + h] = y0, y1
    return torch.stack(v, 1)


def _launch_model(x3, t, fc: FieldConsts, tw3, first: int, last: int):
    """One launch of the register kernel on stages [first, last) of the
    (A, m, B) view ``x3`` (its storage indexed by its strides, as the
    wrapper passes them), the (A, m, 1) twiddle ``tw3``; returns the
    output view with x3's strides."""
    (A, m, B), (sa, sm, sb), (ta, tm, _) = P._view(x3, False)
    solinas = fc.modmul == "solinas"
    tw_words = 0 if tw3 is None else (1 if tw3.wp is None else 2)
    geo = P.butterfly_geometry(m, first, last, t.inverse, B, A, solinas, tw_words, t.block_b)
    log2m, log2c = m.bit_length() - 1, geo.cols.bit_length() - 1
    swz = log2c < 4
    xf = _storage(x3)
    out = torch.zeros_like(xf)
    writes = torch.zeros_like(xf)
    twf = None if tw3 is None else [None if v is None else v.reshape(-1) for v in tw3]
    tiles = -(-B // geo.cols)
    fused = tw3 is not None and (last == log2m if t.inverse else first == 0)
    assert geo.tw_bytes == (8 * m * tw_words if fused else 0)
    for wk in range(tiles * A):
        a, tile = divmod(wk, tiles)
        c0 = tile * geo.cols
        T = torch.full((geo.tile_words,), -1, dtype=torch.int64)
        if fused:  # the block's staged twiddle row of slice a
            row = a * ta + torch.arange(m) * tm
            TW = MontPair(twf[0][row], None if twf[1] is None else twf[1][row])
        s0 = first
        for g, R in enumerate(geo.ranks):
            log2L = s0 if t.inverse else log2m - s0 - R
            from_mem, to_mem = g == 0, g == len(geo.ranks) - 1
            _, sets, c = _units(geo, m, R)
            j = _points(R, log2L, sets)
            tb = (sets & ((1 << log2L) - 1)) - 1 - geo.tab_lo
            col = c0 + c
            ok = (col < B)[:, None].expand_as(j)
            addr = a * sa + col[:, None] * sb + j * sm
            slots = _slot((j << log2c) + c[:, None], swz)
            if from_mem:
                v = torch.where(ok, xf[torch.where(ok, addr, 0)], 0)
                if fused and not t.inverse:
                    v = inter_step_mul(fc, v, _row(TW, j))
            else:
                v = T[slots]
                assert not (v == -1).any(), "a tile word read before it was written"
            scaled = t.inverse and to_mem and last == log2m
            v = _butterflies(v, t, fc, geo, R, log2L, tb, scaled, lane=False)
            if to_mem:
                if fused and t.inverse:
                    v = inter_step_mul(fc, v, _row(TW, j))
                out[addr[ok]] = v[ok]
                writes.index_add_(0, addr[ok], torch.ones(int(ok.sum()), dtype=torch.int64))
            else:  # the exchange writes every tile word once
                assert torch.equal(slots.reshape(-1).sort().values, torch.arange(geo.tile_words))
                T[slots] = v
            s0 += R
    view = torch.as_strided(writes, x3.shape, x3.stride())
    assert torch.equal(view, torch.ones_like(view)), "an output written twice or never"
    return torch.as_strided(out, x3.shape, x3.stride())


def _model(x3, t, fc: FieldConsts, tw3=None):
    """K4 / K5 as ``_run`` drives them: one launch per ``spc`` range."""
    n = len(t.stage_ls)
    step = t.spc or n
    for first in range(0, n, step):
        x3 = _launch_model(x3, t, fc, tw3, first, min(first + step, n))
    return x3


def _input(rng, shape, fc: FieldConsts):
    """Values below N (below 2N for a lazy modulus), one N - 1 included."""
    top = (2 if fc.lazy else 1) * fc.modulus
    v = rng.integers(0, top, size=shape, dtype=np.uint64)
    v.reshape(-1)[0] = fc.modulus - 1
    return from_numpy(v)


def _twiddle(rng, shape, fc: FieldConsts, mode: str | None):
    """An (A, m, 1) inter-step twiddle: "pair" Montgomery with companion,
    "w" without (plain under Solinas), None none."""
    if mode is None:
        return None
    w = from_numpy(rng.integers(0, fc.modulus, size=shape, dtype=np.uint64))
    return MontPair(w, w * s64(fc.montgomery_inverse) if mode == "pair" else None)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("name,mod,modmul", ENGINES, ids=[e[0] for e in ENGINES])
def test_register_schedule_matches_plain(name, mod, modmul, inverse):
    """m in {2, 8, 32, 64, 256}: the model equals _stages_plain bitwise --
    the leaf (1, m, 40), a ragged mid (3, m, 7) with each twiddle mode of
    the engine, a mid split into launches of 3 stages (spc) with its
    twiddle, and a strided (A, m, B) view (the batch axis outermost)."""
    fc = FieldConsts.from_modulus(mod, modmul=modmul)
    rng = np.random.default_rng(9 + 2 * ENGINES.index((name, mod, modmul)) + inverse)
    modes = ("w",) if modmul == "solinas" else ("pair", "w")
    for m in (2, 8, 32, 64, 256):
        kw = dict(inverse=inverse, modmul=modmul, device="cpu")
        t = P.make_leaf_tables(mod, m, **kw)
        x3 = _input(rng, (1, m, 40), fc)
        assert torch.equal(_model(x3, t, fc), P._stages_plain(x3, t, fc, False)), m
        for mode in (None,) + modes:
            x3 = _input(rng, (3, m, 7), fc)
            tw = _twiddle(rng, (3, m, 1), fc, mode)
            want = P._stages_plain(x3, t, fc, False, tw)
            assert torch.equal(_model(x3, t, fc, tw), want), (m, mode)
        if m >= 32:
            ts = P.make_leaf_tables(mod, m, spc=3, **kw)
            x3 = _input(rng, (2, m, 9), fc)
            tw = _twiddle(rng, (2, m, 1), fc, modes[0])
            assert torch.equal(_model(x3, ts, fc, tw), P._stages_plain(x3, t, fc, False, tw)), m
    m = 64
    t = P.make_leaf_tables(mod, m, **kw)
    base = _input(rng, (33, 5, m), fc)  # (B, A, m) in memory
    x3 = base.permute(1, 2, 0)          # (A, m, B), strides (m, 1, A m)
    assert torch.equal(_model(x3, t, fc), P._stages_plain(x3.contiguous(), t, fc, False))


def test_block_b_and_ranges():
    """block_b sets the tile (a tile wider than the block, 512 columns at
    m = 32: a thread walks columns too) and spc the launches; both leave
    the result alone."""
    fc = FieldConsts.from_modulus(TEST, modmul="shoup")
    rng = np.random.default_rng(3)
    for m, block_b, spc in ((32, 512, None), (16, 2, 3), (64, 64, 5), (256, 4, 1)):
        for inverse in (False, True):
            t = P.make_leaf_tables(TEST, m, inverse=inverse, modmul="shoup", block_b=block_b,
                                   spc=spc, device="cpu")
            x3 = _input(rng, (1, m, 600 if m == 32 else 20), fc)
            geo = P.butterfly_geometry(m, 0, min(spc or 99, m.bit_length() - 1), inverse,
                                       x3.shape[2], 1, False, 0, block_b)
            assert geo.cols == block_b
            assert torch.equal(_model(x3, t, fc), P._stages_plain(x3, t, fc, False)), (m, block_b)


def _kernel_smem(geo, m: int, solinas: bool, tw_words: int, fused: bool) -> int:
    """The C entry's layout: the exchange tile where there are two groups
    or more, the stage-table slice, and the twiddle row where the range
    multiplies the twiddle."""
    tile = 8 * geo.cols * m if len(geo.ranks) > 1 else 0
    return tile + geo.tab_entries * (8 if solinas else 16) + (8 * m * tw_words if fused else 0)


def test_geometry_limits():
    """Every m in 2..4096, every stage range of whole launches and spc
    launches, both directions, several batches and slice counts, both table
    widths: the groups add up to the range with at most RADIX2_MAX_R stages
    each, the shared memory fits a block and equals the C entry's layout,
    a block has at most 256 threads (the C entry's count), the staged slice
    holds every half-width of the range, and the tiles cover every column
    once."""
    src = open(os.path.join(CSRC, "ntt_radix2.cu")).read()
    assert "const long long tab_bytes = (long long)tab_entries * (modmul == 2 ? 8 : 16);" in src
    assert ("const long long tw_bytes = 8ll * (tw_mode == 1 ? 2 : 1) * (lane ? tile_words : 1ll "
            "<< log2m);") in src
    assert ("const long long want = 8 * tile_words + tab_bytes + (fused && (staged || !lane) ? "
            "tw_bytes : 0);") in src
    for log2m in range(1, 13):
        m = 1 << log2m
        ranges = {(0, log2m)} | {(f, min(f + spc, log2m)) for spc in (1, 3, 5)
                                 for f in range(0, log2m, spc)}
        for first, last in sorted(ranges):
            for inverse in (False, True):
                for B, A in ((1, 1), (5, 1), (40, 3), (512, 1), (65536, 1), (256, 256)):
                    for solinas, tw_words in ((False, 0), (True, 0), (False, 2), (True, 1)):
                        geo = P.butterfly_geometry(m, first, last, inverse, B, A, solinas, tw_words)
                        fused = tw_words > 0 and (last == log2m if inverse else first == 0)
                        assert sum(geo.ranks) == last - first and max(geo.ranks) <= P.RADIX2_MAX_R
                        assert len(geo.ranks) == -(-(last - first) // P.RADIX2_MAX_R)
                        assert geo.smem <= P.MAX_SMEM
                        assert geo.smem == _kernel_smem(geo, m, solinas, tw_words, fused)
                        units = geo.cols * (m >> max(geo.ranks))
                        assert geo.threads == min(256, units)
                        ls = [1 << s if inverse else m >> (s + 1) for s in range(first, last)]
                        assert geo.tab_lo == min(ls) - 1
                        assert geo.tab_lo + geo.tab_entries == 2 * max(ls) - 1
                        cols = (torch.arange(-(-B // geo.cols))[:, None] * geo.cols
                                + torch.arange(geo.cols))
                        assert torch.equal(cols[cols < B], torch.arange(B))


def test_geometry_at_the_plans_shapes():
    """The 2^24 plan's K4 (256 x 65536) and K5 (256, 256, 256) run 4 + 4
    stages on blocks of 256 threads, 32 columns, whose shared memory lets
    three share an SM; the 2^17 plan's K4 (32 x 4096) and K5 (32, 64, 64)
    and the 2^26 plan's m = 64 and 128 launches fill the card with at least
    two blocks an SM; Solinas halves the table slice."""
    for inverse in (False, True):
        for B, A, tw_words in ((65536, 1, 0), (256, 256, 2)):
            geo = P.butterfly_geometry(256, 0, 8, inverse, B, A, False, tw_words)
            assert (geo.ranks, geo.cols, geo.threads, geo.tile_words) == ((4, 4), 32, 256, 8192)
            assert geo.smem == 8 * 8192 + 16 * 255 + 8 * 256 * tw_words
            assert 3 * (geo.smem + 1024) <= 233472
            sol = P.butterfly_geometry(256, 0, 8, inverse, B, A, True, tw_words // 2)
            assert sol.smem == 8 * 8192 + 8 * 255 + 8 * 256 * (tw_words // 2)
        k4 = P.butterfly_geometry(32, 0, 5, inverse, 4096, 1)
        assert (k4.ranks, k4.cols, k4.threads, -(-4096 // k4.cols)) == ((3, 2), 8, 32, 512)
        k5 = P.butterfly_geometry(64, 0, 6, inverse, 64, 32, False, 2)
        assert (k5.ranks, k5.cols, k5.threads, 32 * -(-64 // k5.cols)) == ((3, 3), 4, 32, 512)
        for m, B, A in ((64, 1 << 20, 1), (64, 16384, 64), (128, 128, 4096)):
            geo = P.butterfly_geometry(m, 0, m.bit_length() - 1, inverse, B, A)
            assert geo.cols == 32 and geo.threads == 256 and A * -(-B // 32) >= 2 * 132


def test_exchange_is_free_of_bank_conflicts():
    """Every tile access between groups: at each point k and round, each
    half-warp's 8-byte accesses fall on 16 distinct bank pairs (slot mod
    16), unswizzled from 16 columns a tile on (a half-warp is one point's
    row of columns), swizzled below -- at the plans' lengths and batch
    sizes and at small ones, both directions."""
    for m in (8, 16, 32, 64, 128, 256, 512, 1024):
        n = m.bit_length() - 1
        for inverse in (False, True):
            for B, A in ((40, 1), (64, 32), (4096, 1), (65536, 1)):
                geo = P.butterfly_geometry(m, 0, n, inverse, B, A)
                if len(geo.ranks) == 1:
                    continue
                log2c = geo.cols.bit_length() - 1
                s0 = 0
                for R in geo.ranks:
                    log2L = s0 if inverse else n - s0 - R
                    u, sets, c = _units(geo, m, R)
                    words = _slot((_points(R, log2L, sets) << log2c) + c[:, None], log2c < 4)
                    rows = -(-geo.threads // 16) * 16
                    for r in range(-(-len(u) // geo.threads)):
                        live = u[r * geo.threads: (r + 1) * geo.threads]
                        # an idle thread takes a bank of its own
                        banks = (16 + torch.arange(rows))[:, None].repeat(1, 1 << R)
                        banks[live - r * geo.threads] = words[live] & 15
                        hw = banks.reshape(rows // 16, 16, -1)
                        same = (hw[:, :, None, :] == hw[:, None, :, :]).sum(dim=2)
                        assert int(same.max()) == 1, (m, inverse, B, A, R, r)
                    s0 += R


# ---------------------------------------------------------------------------
# the lane orientation (K6)
# ---------------------------------------------------------------------------


def _lane_units(geo, m: int, R: int):
    """(unit ids, row, set) of a lane group of R stages: unit u = row *
    (m >> R) + set, thread u mod threads taking units u, u + threads, ..."""
    log2s = m.bit_length() - 1 - R
    u = torch.arange(geo.cols << log2s)
    return u, u >> log2s, u & ((1 << log2s) - 1)


def _lane_ends(geo, m: int, inverse: bool):
    """Per group (R, log2L, through the tile at the row's contiguous end)."""
    n, s0, out = m.bit_length() - 1, 0, []
    for R in geo.ranks:
        log2L = s0 if inverse else n - s0 - R
        out.append((R, log2L, len(geo.ranks) > 1 and log2L == 0))
        s0 += R
    return out


def _lane_geometry(x3, t, fc: FieldConsts, tw3):
    tw_words = 0 if tw3 is None else (1 if tw3.wp is None else 2)
    m, B = x3.shape[1], x3.shape[0]
    return P.butterfly_geometry(m, 0, m.bit_length() - 1, t.inverse, B, 1,
                                fc.modmul == "solinas", tw_words, t.rows, lane=True)


def _stage(a: torch.Tensor, off: int, words: int, n: int) -> torch.Tensor:
    """A tile's n words of the flat array ``a`` from word ``off`` at the
    tile's slots, zeros from word ``words`` on (the kernel's cp.async)."""
    i = torch.arange(n)
    S = torch.zeros(n, dtype=torch.int64)
    S[_slot(i, True)] = torch.where(i < words, a[off + torch.where(i < words, i, 0)], 0)
    return S


def _lane_model(x, t, fc: FieldConsts, tw=None):
    """K6 as the kernel runs it, on the CPU: the (rows, m, 1) view and its
    geometry as ``_launch_regs`` makes them; per tile of C rows, one 64-bit
    offset and tile words w = r m + j; per group the (row, set) units and
    their points; the first group reading device memory (through the tile
    where it is the inverse's contiguous end, L = 1, copied in), the last
    writing it (through the tile where it is the forward's contiguous end,
    copied out); the twiddle multiplied after the first group's reads
    (forward) or before the last group's writes (inverse), the inverse's
    staged at the tile's slots where the row has two groups or more and it
    fits (``geo.tw_bytes``), else read from device memory; the exchanges through
    the swizzled tile.  Every output is written once and every exchange is
    a permutation of the tile."""
    rows_t = P._lane_rows(x, t.m)
    x3 = rows_t.unsqueeze(2)
    tw3 = None if tw is None else P._lane_tw(tw, x, rows_t)
    (A, m, B), (_, sm, sb), _ = P._view(x3, True)
    assert (A, sm, sb) == (1, 1, m)
    geo = _lane_geometry(x3, t, fc, tw3)
    tw_words = 0 if tw3 is None else (1 if tw3.wp is None else 2)
    staged = geo.tw_bytes > 0
    assert geo.tab_lo == 0 and geo.tw_bytes in (0, 8 * geo.tile_words * tw_words)
    assert t.inverse or not staged
    assert geo.smem == _lane_kernel_smem(geo, m, fc.modmul == "solinas", tw_words, t.inverse)
    log2m = m.bit_length() - 1
    xf = x3.reshape(-1)
    twf = None if tw3 is None else [None if v is None else v.reshape(-1) for v in tw3]
    out = torch.zeros_like(xf)
    writes = torch.zeros_like(xf)
    last = len(geo.ranks) - 1
    for tile in range(-(-B // geo.cols)):
        r0 = tile * geo.cols
        off, rows = r0 * m, min(geo.cols, B - r0)  # the tile's one 64-bit index
        words = rows * m
        T = torch.full((geo.tile_words,), -1, dtype=torch.int64)
        if staged:
            SW = [None if v is None else _stage(v, off, words, geo.tile_words) for v in twf]

        def twiddle(w, ok):
            """The twiddle of tile words w: staged (slot) or from memory."""
            if staged:
                sl = _slot(w, True)
                return MontPair(SW[0][sl], None if SW[1] is None else SW[1][sl])
            return _row(MontPair(*twf), off + torch.where(ok, w, 0))

        for g, (R, log2L, end) in enumerate(_lane_ends(geo, m, t.inverse)):
            copy_in = g == 0 and end
            if copy_in:  # cp.async of the tile, zeros past the rows
                T = _stage(xf, off, words, geo.tile_words)
            out_mem = g == last and not end
            _, row, sets = _lane_units(geo, m, R)
            w = (row << log2m)[:, None] + _points(R, log2L, sets)  # tile words
            ok = (row < rows)[:, None].expand_as(w)
            tb = (sets & ((1 << log2L) - 1)) - 1 - geo.tab_lo
            if g == 0 and not copy_in:
                v = torch.where(ok, xf[off + torch.where(ok, w, 0)], 0)
            else:
                v = T[_slot(w, True)]
                assert not (v[ok] == -1).any(), "a tile word read before it was written"
            if g == 0 and tw3 is not None and not t.inverse:
                v = torch.where(ok, inter_step_mul(fc, v, twiddle(w, ok)), v)
            v = _butterflies(v, t, fc, geo, R, log2L, tb, t.inverse and g == last, lane=True)
            if out_mem:
                if tw3 is not None and t.inverse:
                    v = inter_step_mul(fc, v, twiddle(w, ok))
                out[off + w[ok]] = v[ok]
                writes.index_add_(0, off + w[ok], torch.ones(int(ok.sum()), dtype=torch.int64))
            else:
                slots = _slot(w, True).reshape(-1)
                assert torch.equal(slots.sort().values, torch.arange(geo.tile_words))
                T[slots] = v.reshape(-1)
            if g == last and end:  # the copy out, along the rows
                i = torch.arange(words)
                out[off + i] = T[_slot(i, True)]
                writes.index_add_(0, off + i, torch.ones(words, dtype=torch.int64))
    assert torch.equal(writes, torch.ones_like(writes)), "an output written twice or never"
    return out.reshape(x.shape)


def _lane_twiddle(rng, shape, fc: FieldConsts, mode: str | None):
    """A lane inter-step twiddle of the data's shape (``_twiddle``'s modes)."""
    return _twiddle(rng, shape, fc, mode)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("name,mod,modmul", ENGINES, ids=[e[0] for e in ENGINES])
def test_lane_schedule_matches_plain(name, mod, modmul, inverse):
    """m in {2, 8, 32, 64, 128, 256}: the lane model equals ``lane_plain``
    bitwise on 6 rows (one a tile: the grid rule's smallest tiles), the
    twiddle modes of the engine (none, "pair" / "w", Solinas "w") taken in
    turn; at m = 256 on 9 rows in lane_rows tiles of 4 (a thread walking
    units, the last tile partial), at m = 32 on 520 rows in tiles of 512
    (the twiddle read unstaged, the last tile partial)."""
    fc = FieldConsts.from_modulus(mod, modmul=modmul)
    rng = np.random.default_rng(101 + 2 * ENGINES.index((name, mod, modmul)) + inverse)
    modes = (None, "w") if modmul == "solinas" else (None, "pair", "w")
    kw = dict(inverse=inverse, modmul=modmul, device="cpu")
    for i, m in enumerate((2, 8, 32, 64, 128, 256)):
        t = P.make_lane_tables(mod, m, **kw)
        mode = modes[i % len(modes)]
        x = _input(rng, (6, m), fc)
        tw = _lane_twiddle(rng, (6, m), fc, mode)
        assert torch.equal(_lane_model(x, t, fc, tw), P.lane_plain(x, t, fc, tw)), (m, mode)
    t = P.make_lane_tables(mod, 256, rows=4, **kw)
    x = _input(rng, (3, 3, 256), fc)  # batch dims before the row: 9 rows
    tw = _lane_twiddle(rng, (3, 3, 256), fc, modes[1])
    assert torch.equal(_lane_model(x, t, fc, tw), P.lane_plain(x, t, fc, tw))
    # a lane_rows tile whose twiddle does not fit beside it: read unstaged
    t = P.make_lane_tables(mod, 32, rows=512, **kw)
    x = _input(rng, (520, 32), fc)
    tw = _lane_twiddle(rng, (520, 32), fc, modes[-1])
    assert _lane_geometry(x.unsqueeze(2), t, fc, tw).tw_bytes == 0
    assert torch.equal(_lane_model(x, t, fc, tw), P.lane_plain(x, t, fc, tw))


def _lane_kernel_smem(geo, m: int, solinas: bool, tw_words: int, inverse: bool) -> int:
    """The C entry's lane layout: where there are two groups or more the
    exchange tile and, for the inverse where it fits in a block's shared
    memory beside it, a tile's worth of each twiddle word, staged; the
    stage-table slice."""
    tile = 8 * geo.cols * m if len(geo.ranks) > 1 else 0
    tab = geo.tab_entries * (8 if solinas else 16)
    staged = tile * tw_words if inverse else 0
    return tile + tab + (staged if tile + tab + staged <= P.MAX_SMEM else 0)


def test_lane_geometry_limits():
    """Every m in 2..4096, several row counts, both directions, both table
    widths, with and without lane_rows: the groups add up to log2 m, at most
    RADIX2_MAX_R each; the shared memory fits a block and equals the C
    entry's layout; a block has min(256, rows a tile x the widest group's
    set count) threads; the rows a tile fill LANE_THREADS unless B or the
    grid forbids (at least two blocks an SM where B allows); the tiles
    cover every row once; the ends run on the tile exactly where a
    multi-group row has L = 1, never in the group that multiplies the
    twiddle (the forward's first, the inverse's last)."""
    src = open(os.path.join(CSRC, "ntt_radix2.cu")).read()
    assert "const bool end = p.ngroups > 1 && log2L == 0;" in src
    assert ("const bool staged = lane && inverse && fused && ngroups > 1 &&\n"
            "                      8 * tile_words + tab_bytes + tw_bytes <= MAX_SMEM;") in src
    with pytest.raises(ValueError):
        P.butterfly_geometry(256, 0, 4, False, 64, 1, lane=True)
    for log2m in range(1, 13):
        m = 1 << log2m
        for inverse in (False, True):
            for B in (1, 5, 40, 512, 2048, 65536, 524288):
                for solinas, tw_words in ((False, 0), (True, 1), (False, 2)):
                    for rows in (None, 1, 64):
                        args = (m, 0, log2m, inverse, B, 1, solinas, tw_words, rows)
                        if rows is not None and 8 * rows * m > P.MAX_SMEM:
                            with pytest.raises(ValueError):  # a lane_rows tile too large
                                P.butterfly_geometry(*args, lane=True)
                            continue
                        geo = P.butterfly_geometry(*args, lane=True)
                        assert sum(geo.ranks) == log2m and max(geo.ranks) <= P.RADIX2_MAX_R
                        assert geo.smem <= P.MAX_SMEM
                        assert geo.smem == _lane_kernel_smem(geo, m, solinas, tw_words, inverse)
                        sets = m >> max(geo.ranks)
                        assert geo.threads == min(256, geo.cols * sets)
                        if rows is not None:
                            assert geo.cols == rows
                        else:  # the widest tile of at most 256 threads the rule keeps
                            def kept(c):
                                wide = dataclasses.replace(geo, cols=c)
                                smem = _lane_kernel_smem(wide, m, solinas, tw_words, inverse)
                                return c == 1 or (smem <= P.SMEM_THREE_BLOCKS
                                                  and -(-B // c) >= 2 * 132)
                            top = min(max(1, P.LANE_THREADS // sets), P._pow2_at_least(B))
                            assert geo.cols <= top and geo.cols & (geo.cols - 1) == 0
                            assert kept(geo.cols) and (geo.cols == top or not kept(2 * geo.cols))
                        r = (torch.arange(-(-B // geo.cols))[:, None] * geo.cols
                             + torch.arange(geo.cols))
                        assert torch.equal(r[r < B], torch.arange(B))
                        ends = _lane_ends(geo, m, inverse)
                        assert [e for _, _, e in ends] == [
                            len(ends) > 1 and g == (0 if inverse else len(ends) - 1)
                            for g in range(len(ends))]
                        twiddled = ends[-1] if inverse else ends[0]
                        assert not twiddled[2]


def test_lane_geometry_at_the_plans_shapes():
    """The lane roots of the radix-2 plans: 2^24 (65536 x 256, pair) 4 + 4
    stages on tiles of 8 rows, 128 threads: 20,464 bytes forward, 53,232
    for the inverse with its twiddle staged, so four blocks share an SM as
    their registers allow (Solinas, one twiddle word: 18,424 / 34,808);
    2^17 (2048 x 64) 3 + 3 in 512 tiles of 4 rows, 32 threads; 2^26
    (524288 x 128) 4 + 3 on tiles of 16 rows, 128 threads."""
    for inverse in (False, True):
        geo = P.butterfly_geometry(256, 0, 8, inverse, 65536, 1, False, 2, lane=True)
        assert (geo.ranks, geo.cols, geo.threads, geo.tile_words) == ((4, 4), 8, 128, 2048)
        assert geo.smem == 8 * 2048 + 16 * 255 + (16 * 2048 if inverse else 0)
        assert geo.smem == (53232 if inverse else 20464)
        assert 4 * (geo.smem + 1024) <= 233472
        sol = P.butterfly_geometry(256, 0, 8, inverse, 65536, 1, True, 1, lane=True)
        assert (sol.cols, sol.threads) == (8, 128)
        assert sol.smem == (34808 if inverse else 18424)
        g17 = P.butterfly_geometry(64, 0, 6, inverse, 2048, 1, False, 2, lane=True)
        assert (g17.ranks, g17.cols, g17.threads, -(-2048 // g17.cols)) == ((3, 3), 4, 32, 512)
        g26 = P.butterfly_geometry(128, 0, 7, inverse, 524288, 1, False, 2, lane=True)
        assert (g26.ranks, g26.cols, g26.threads) == ((4, 3), 16, 128)


def _lane_accesses(geo, m: int, inverse: bool):
    """Every access of a lane tile with a fused twiddle, per group and round
    of the block's threads: (kind, thread ids, words (threads, points));
    kind "mem" for device memory, "tile" for shared memory (the exchange
    tile, the staged twiddle: the same slots).  The copies -- the staging
    of the twiddle, the inverse's copy-in, the forward's copy-out -- move
    one word a thread and round along the tile; the fused group reads the
    twiddle at its points' words."""
    out, threads = [], geo.threads
    staged = geo.tw_bytes > 0

    def copy(kinds):
        for r in range(-(-geo.tile_words // threads)):
            i = torch.arange(r * threads, min((r + 1) * threads, geo.tile_words))
            out.extend((k, i - r * threads, i[:, None]) for k in kinds)

    if staged:
        copy(("mem", "tile"))
    ends = _lane_ends(geo, m, inverse)
    for g, (R, log2L, end) in enumerate(ends):
        last = g == len(ends) - 1
        if g == 0 and end:
            copy(("mem", "tile"))
        u, row, sets = _lane_units(geo, m, R)
        w = (row << (m.bit_length() - 1))[:, None] + _points(R, log2L, sets)
        kinds = {"tile" if g > 0 or end else "mem",
                 "mem" if last and not end else "tile"}
        if g == (len(ends) - 1 if inverse else 0):
            kinds.add("tile" if staged else "mem")
        for r in range(-(-len(u) // threads)):
            live = slice(r * threads, (r + 1) * threads)
            out += [(k, u[live] - r * threads, w[live]) for k in sorted(kinds)]
        if last and end:
            copy(("tile", "mem"))
    return out


def test_lane_accesses_are_coalesced_and_conflict_free():
    """At every m with more than one group (32 ... 4096) and the plans'
    row counts, both directions, staged and (a lane_rows tile too large for
    the buffers) not: each warp's device-memory access of one point (x, out
    and the twiddle at the same words) fills whole 32-byte sectors --
    neighbouring lanes on neighbouring words of a row, the copies along the
    rows -- and each half-warp's shared-memory access falls on 16 distinct
    bank pairs of the swizzled layout."""
    for log2m in range(5, 13):
        m = 1 << log2m
        for inverse in (False, True):
            for B, rows in ((40, None), (2048, None), (65536, None), (16384, 16384 >> log2m)):
                geo = P.butterfly_geometry(m, 0, log2m, inverse, B, 1, False, 2, rows, lane=True)
                assert (geo.tw_bytes > 0) == (rows is None and inverse)
                for kind, tid, words in _lane_accesses(geo, m, inverse):
                    # per (half-)warp and point: the sectors it touches (each
                    # holds at most 4 of its distinct words) or its banks
                    group = (tid // (16 if kind == "tile" else 32))[:, None]
                    at = group * words.shape[1] + torch.arange(words.shape[1])
                    if kind == "mem":
                        keys = at * (1 << 40) + (words >> 2)
                        assert len(torch.unique(keys)) * 4 == words.numel(), (m, inverse, B)
                    else:
                        keys = at * 16 + (_slot(words, True) & 15)
                        assert len(torch.unique(keys)) == words.numel(), (m, inverse, B)


# ---------------------------------------------------------------------------
# the narrow Solinas multiply (csrc/field.cuh solinas_mul), on Python ints
# ---------------------------------------------------------------------------


def _narrow_solinas(a: int, w: int, N: int) -> int:
    """field.cuh solinas_mul's PTX step by step: every 32 x 32 product and
    every 64-bit word it forms, each held below the width its register has
    (a u64, or a u32 where it multiplies 32-bit words)."""
    M32, M64 = (1 << 32) - 1, (1 << 64) - 1

    def u64(v):
        assert 0 <= v <= M64
        return v

    def u32(v):
        assert 0 <= v <= M32
        return v

    eps = (1 << 64) - N
    e0, e1 = eps & M32, eps >> 32
    a0, a1, w0, w1 = a & M32, a >> 32, w & M32, w >> 32
    p = u64(a0 * w0)
    t = u64(a1 * w0 + (p >> 32))
    u = u64(a0 * w1 + (t & M32))
    lo = ((u << 32) | (p & M32)) & M64
    hi = u64(a1 * w1 + (t >> 32) + (u >> 32))
    assert hi * (1 << 64) + lo == a * w
    # fold 1
    h0, h1 = hi & M32, hi >> 32
    p = u64(h0 * e0)
    t = u64(h1 * e0 + (p >> 32))
    u = u64(h0 * e1 + (t & M32))
    prod = (u << 32 | (p & M32)) & M64
    c = (lo + prod) >> 64
    lo = (lo + prod) & M64
    hi = u64(h1 * e1 + (t >> 32) + (u >> 32) + c)
    assert hi <= 1 << 42
    # fold 2
    h0, h1 = hi & M32, hi >> 32
    p = u64(h0 * e0)
    t = u64(h1 * e0 + u64(h0 * e1 + (p >> 32)))
    prod = ((t << 32) | (p & M32)) & M64
    c = (lo + prod) >> 64
    lo = (lo + prod) & M64
    hi = u64(u32(h1 * e1) + (t >> 32) + c)
    assert hi <= 1 << 20
    # fold 3
    h0 = u32(hi)
    prod = u64(h0 * e0 + u64(u32(h0 * e1) << 32))
    assert prod < 1 << 62
    c = (lo + prod) >> 64
    r = (lo + prod) & M64
    r = u64(r + (eps if c else 0))
    return min(r, (r - N) & M64)


@pytest.mark.parametrize("mod", [FLAG, GOLD], ids=["flagship", "goldilocks"])
def test_narrow_solinas_multiply(mod):
    """On JAX's corner values of the fold (0, 1, N - 1, N, 2^63, 2^64 - 1)
    against every twiddle corner and 4000 random pairs: each intermediate
    stays within its width, and the result equals a*w mod N and the plain
    version's ``FieldConsts.solinas_mul`` bit for bit."""
    N = mod.modulus
    fc = FieldConsts.from_modulus(mod, modmul="solinas")
    rng = np.random.default_rng(42)
    corners = [0, 1, N - 1, N, 1 << 63, (1 << 64) - 1]
    pairs = [(a, w) for a in corners for w in (0, 1, 2, N - 2, N - 1)]
    a_r = rng.integers(0, 1 << 64, size=4000, dtype=np.uint64)
    w_r = rng.integers(0, N, size=4000, dtype=np.uint64)
    pairs += list(zip(map(int, a_r), map(int, w_r)))
    got = [_narrow_solinas(a, w, N) for a, w in pairs]
    assert got == [a * w % N for a, w in pairs]
    a_t = from_numpy(np.array([a for a, _ in pairs], dtype=np.uint64))
    w_t = from_numpy(np.array([w for _, w in pairs], dtype=np.uint64))
    assert fc.solinas_mul(a_t, w_t).tolist() == [s64(v) for v in got]

#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the CUDA kernels and the native golden oracle, from this checkout;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   same card tensors, bitwise, at the main paths' shapes --
   the s8 matrix NTT (K1 lead, K2 mid, K3 lane) with every twiddle mode,
   both directions, both moduli, a ragged batch and the m = 1024 crafted
   plane-minimizer input; the radix-2 butterfly kernel (K4 leaf, K5 mid,
   K6 lane) with every twiddle mode, both directions, the flagship and the
   lazy test modulus under Montgomery and Shoup, a ragged batch and m = 2;
   the same matrix cases under the u7 and s8b plane schemes, with K1's
   2^24 shape and, for u7, the m = 1024 all-ones input (against the golden
   model too); K11 (the fused u7 prototype) at (128, 32768), with columns
   0 and 7777 against the golden model;
   the grouped kernel (K7 leaf, K8 lane) at max_r 2, 3 and 4 the same way,
   m = 2 and m = 8 included; the blocked transpose (K9a/K9b) at the 2^24
   root-row shapes with three block shapes, int64 and int32; the
   inter-step multiply kernel of the transpose fallback;
4. paths: the matrix engine (the default, ``engine="auto"``), the
   butterfly engine (``engine="pallas"``) and the grouped butterfly engine
   (``engine="pallas", max_r=3``) at n = 2^17, 2^24 and 2^26 on the
   flagship modulus, plus each butterfly engine on the lazy test modulus at
   2^24 (``modmul="auto"`` resolves to Shoup there), forward and inverse,
   elementwise against the native oracle (computed once per modulus and
   length), with an exact roundtrip; then ``mxu_ntt_lane`` (K3, which no
   plan calls) on the 2^24 root-row shape against the lead orientation
   between transposes, and ``transpose01_u64(x, "pallas")`` /
   ``transpose_pallas`` on the 2^24 root-row shapes against the torch
   copy; the u7 and s8b schemes through ``mxu_ntt`` / ``mxu_ntt_mid`` /
   ``mxu_ntt_lane`` and K11 through ``mxu_fused_ntt``, against the golden
   model, an exact roundtrip and s8.  Each path runs with the launch counts
   set to 0 just before and read just after: every kernel of the path must
   have launched, and no plain version may have run;
   Then the distributed six-step (``parallel.DistributedNTT``) on logical
   shards of the card (a mesh naming it 4 or 8 times): the ring all-to-all
   K10 against its plain version first (D = 1, 2, 3, 4, 8, both
   orientations, the 2^24 and 2^26 splits' exchanges, a ragged canonical
   case), then each distributed path forward and inverse against the same
   oracle with an exact roundtrip -- comm "xla", "ring" and "overlap" at
   2^24, the matrix and grouped engines, the lazy test modulus, 2^26, the
   (2, 4) ("dcn", "ici") mesh -- and a 2^28 run against the single-device
   six-step transform on the card, beside its memory budget.  Where the
   machine has two or more cards, the 2^24 ring path over distinct cards;
5. times: CUDA-event medians of the transforms and of each kernel alone
   beside its plain version (and, for the transpose, the PyTorch call
   ``.t().contiguous()``; for K10 the torch-copy all-to-all), and the
   least time the card could take -- the u7 and s8b kernels at K1/K2/K3's
   2^24 shapes beside s8's, K11 at (128, 32768), and the round-5 A/B level
   (mid (64, 256, 256), each scheme bare, with the pair twiddle fused, and
   with it as a separate pass); the distributed 2^24 forward at D = 4
   and 8 per comm mode, as logical shards of one card;
6. breakdown: the radix-2 and grouped butterfly engines' 2^24 forward
   transforms, the distributed 2^24 forward (D = 4 and 8 ring, D = 4
   overlap): device time by kernel (torch.profiler) and the device's busy
   share -- informational, no check rests on it.

The tolerance of every comparison is zero: the arithmetic is exact.  Any
failed check raises, so the script exits non-zero.  The line before the
last is the JSON kernel record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

TOL = 0  # exact integer arithmetic: outputs must agree bit for bit

#: H100 SXM peaks used for the least time a kernel could take: HBM bytes/s;
#: int8 tensor-core ops/s (a multiply-add is two); 32-bit integer
#: multiply-adds/s -- half the 33.5e12 float32 FMA/s behind the published
#: 67 TFLOP/s (64 int32 against 128 float32 lanes per SM).
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
IMAD_PER_S = 16.75e12
#: 32-bit multiply-adds a 64-bit product needs at least: its four (high
#: word) or three (low word) 32 x 32 partial products.
IMAD_HI, IMAD_LO = 4, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def mismatch(a, b) -> int:
    """Largest |a - b| of two u64 tensors, as a Python int (0 when equal)."""
    import torch

    if torch.equal(a, b):
        return 0
    from sventt_tpu_torch.field.limb import to_numpy

    ua, ub = to_numpy(a).ravel(), to_numpy(b).ravel()
    diff = [abs(int(p) - int(q)) for p, q in zip(ua[ua != ub][:4096], ub[ua != ub][:4096])]
    return max(diff)


def timed(fn, warmup: int, reps: int) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_graph(fn, warmup: int, reps: int) -> float:
    """Median milliseconds of one replay of ``fn`` captured in a CUDA
    graph: the device time of its kernels without the host's per-call
    work, for calls whose Python wrapper takes longer than their kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timed(graph.replay, warmup, reps)


def rand_u64(rng, shape, device, below: int | None = None):
    """Full-range u64 bit patterns (or values below ``below``) on ``device``."""
    import numpy as np

    from sventt_tpu_torch.field.limb import from_numpy

    if below is None:
        v = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    else:
        v = rng.integers(0, below, size=shape, dtype=np.uint64)
    return from_numpy(v, device)


def rand_twiddle(rng, shape, mod, mode: str, device):
    """A random inter-step MontPair of ``shape``: "pair" with its companion,
    "w" without."""
    from sventt_tpu_torch.field.limb import s64
    from sventt_tpu_torch.ops.twiddle import MontPair

    w = rand_u64(rng, shape, device, below=mod.modulus)
    return MontPair(w, w * s64(mod.montgomery_inverse) if mode == "pair" else None)


def crafted_1024(mod, t):
    """The m = 1024 input driving one output plane maximally negative: each
    byte sign-opposes the matching matrix digit (the wrap scenario that a
    fixed 2^26 bias failed)."""
    import numpy as np

    m = t.m
    D = t.planes.cpu().numpy().astype(np.int64).reshape(8, m, m)
    min_a = np.where(D > 0, -128 * D, 127 * D).sum(axis=2)
    worst = np.zeros((15, m), dtype=np.int64)
    for a in range(8):
        for b in range(8):
            worst[a + b] += min_a[a]
    tstar, pstar = np.unravel_index(np.argmin(worst), worst.shape)
    check(int(worst.min()) < -(1 << 26), "crafted input does not cross 2^26")
    x = np.zeros(m, dtype=np.uint64)
    for j in range(m):
        v = 0
        for b in range(8):
            a = tstar - b
            s = -128
            if 0 <= a < 8 and D[a, pstar, j] < 0:
                s = 127
            v |= (s + 128) << (8 * b)
        x[j] = v
    return x


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def moduli():
    from sventt_tpu_torch.field.modulus import (
        FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, TEST_GENERATOR, TEST_MODULUS, Modulus,
    )

    return Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR), Modulus(TEST_MODULUS, TEST_GENERATOR)


def mxu_kernel_cases(device, rng, scheme: str = "s8"):
    """K1/K2/K3 of one plane scheme vs plain at the main path's shapes;
    returns the largest mismatch per orientation.  s8 adds the m = 1024
    crafted plane-minimizer input, u7 the m = 1024 all-ones input; u7 and
    s8b add K1's 2^24 shape (K2's and K3's are in every scheme's list)."""
    import numpy as np

    from sventt_tpu_torch.field.golden import GoldenNTT
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
    from sventt_tpu_torch.ops import ntt_mxu

    flag, test = moduli()
    # (name, modulus, inverse, orientation, data shape, twiddle mode)
    cases = [
        ("K1 lead 256x512 none fwd", flag, False, "lead", (256, 512), None),
        ("K1 lead 512x256 pair fwd", flag, False, "lead", (512, 256), "pair"),
        ("K2 mid 256x256x256 pair fwd", flag, False, "mid", (256, 256, 256), "pair"),
        ("K2 mid 256x256x256 pair inv", flag, True, "mid", (256, 256, 256), "pair"),
        ("K1 lead 512x256 pair inv", flag, True, "lead", (512, 256), "pair"),
        ("K1 lead 512x300 w fwd (ragged)", flag, False, "lead", (512, 300), "w"),
        ("K2 mid 256x512x300 w inv (ragged)", flag, True, "mid", (256, 512, 300), "w"),
        ("K1 lead 256x300 pair fwd TEST", test, False, "lead", (256, 300), "pair"),
        ("K1 lead 256x300 pair inv TEST (lazy)", test, True, "lead", (256, 300), "pair"),
        ("K2 mid 64x256x300 w inv TEST (lazy)", test, True, "mid", (64, 256, 300), "w"),
        ("K2 mid 64x256x256 none inv TEST", test, True, "mid", (64, 256, 256), None),
        # K3: the lane orientation, no twiddle
        ("K3 lane 65536x256 fwd", flag, False, "lane", (65536, 256), None),
        ("K3 lane 65536x256 inv", flag, True, "lane", (65536, 256), None),
        ("K3 lane 300x64 fwd TEST (ragged)", test, False, "lane", (300, 64), None),
        ("K3 lane 300x64 inv TEST (ragged)", test, True, "lane", (300, 64), None),
        # off the main path: the m < 4 digit loads and a tiny ragged grid
        ("K1 lead 2x5 none fwd", flag, False, "lead", (2, 5), None),
        ("K2 mid 3x8x7 pair inv TEST (lazy)", test, True, "mid", (3, 8, 7), "pair"),
    ]
    if scheme != "s8":
        cases.append(("K1 lead 256x65536 pair fwd", flag, False, "lead", (256, 65536), "pair"))
    worst = {"lead": 0, "mid": 0, "lane": 0}
    calls = {"lead": ntt_mxu.mxu_ntt, "mid": ntt_mxu.mxu_ntt_mid}
    tag = "" if scheme == "s8" else f"{scheme} "
    for name, mod, inverse, orient, shape, mode in cases:
        fc = FieldConsts.from_modulus(mod)
        m = {"lead": shape[0], "mid": shape[1], "lane": shape[-1]}[orient]
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme=scheme, device=device)
        x = rand_u64(rng, shape, device)
        if orient == "lane":
            got = ntt_mxu.mxu_ntt_lane(x, t, fc)
            want = ntt_mxu.mxu_plain(x, t, fc, lane=True)
        else:
            tw = None
            if mode is not None:
                tw_shape = (shape[0], m) if orient == "mid" else shape
                tw = rand_twiddle(rng, tw_shape, mod, mode, device)
            got = calls[orient](x, t, fc, tw)
            want = ntt_mxu.mxu_plain(x, t, fc, tw, mid=orient == "mid")
        sync(device)
        err = mismatch(got, want)
        worst[orient] = max(worst[orient], err)
        log(f"  {tag}{name}: max_abs_err {err} (lazy={fc.lazy})")
        check(err <= TOL, f"{tag}{name}: kernel != plain")
        del x, got, want
    fc = FieldConsts.from_modulus(flag)
    if scheme == "s8":
        # m = 1024: the crafted input, kernel vs plain vs the golden model
        t = ntt_mxu.make_mxu_tables(flag, 1024, inverse=False, device=device)
        xc = crafted_1024(flag, t)
        what = "crafted plane minimizer"
    elif scheme == "u7":
        # m = 1024, 2^64 - 1 in every point: the 7-bit data planes 0-8 at
        # 127, so the 19 unsigned product planes at the largest sums the
        # tables allow (each < 2^27.4)
        t = ntt_mxu.make_mxu_tables(flag, 1024, inverse=False, scheme="u7", device=device)
        xc = np.full(1024, (1 << 64) - 1, dtype=np.uint64)
        what = "all-ones 2^64-1"
    else:
        return worst
    x = from_numpy(np.repeat(xc.reshape(1024, 1), 8, axis=1), device)
    got = ntt_mxu.mxu_ntt(x, t, fc)
    want = ntt_mxu.mxu_plain(x, t, fc)
    sync(device)
    err = mismatch(got, want)
    worst["lead"] = max(worst["lead"], err)
    golden = GoldenNTT(1024, flag).forward([int(v) % flag.modulus for v in xc])
    check(err <= TOL, f"{tag}m=1024 {what}: kernel != plain")
    got_h = to_numpy(got)
    check(all([int(v) for v in got_h[:, c]] == golden for c in range(8)), f"{tag}m=1024 {what}: != golden")
    log(f"  {tag}K1 lead 1024x8 {what}: max_abs_err {err}, == golden (x mod N)")
    return worst


def fused_cases(device, rng):
    """K11 at its own shape, (128, 32768), vs its plain version, and columns
    0 and 7777 vs the golden model (as the JAX prototype checks them);
    returns the largest mismatch."""
    from sventt_tpu_torch.experimental import mxu_fused_kernel as fused
    from sventt_tpu_torch.field.golden import GoldenNTT
    from sventt_tpu_torch.field.limb import to_numpy

    flag, _ = moduli()
    stack = fused.make_fused_stack(flag, device=device)
    x = rand_u64(rng, (128, 1 << 15), device, below=flag.modulus)
    got = fused.mxu_fused_ntt(x, stack, flag)
    want = fused.mxu_fused_plain(x, stack, flag)
    sync(device)
    err = mismatch(got, want)
    log(f"  K11 fused u7 128x32768: max_abs_err {err}")
    check(err <= TOL, "K11: kernel != plain")
    golden = GoldenNTT(128, flag)
    xh, gh = to_numpy(x), to_numpy(got)
    for col in (0, 7777):
        ok = [int(v) for v in gh[:, col]] == golden.forward([int(v) for v in xh[:, col]])
        log(f"  K11 golden col {col}: {ok}")
        check(ok, f"K11 column {col} != golden")
    return err


def pallas_kernel_cases(device, rng):
    """K4/K5/K6 vs plain at the main path's shapes and the edge cases;
    returns the largest mismatch per orientation."""
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import ntt_pallas as P

    flag, test = moduli()
    # (name, modulus, modmul, inverse, orientation, data shape, twiddle, knobs)
    cases = [
        ("K4 leaf 256x65536 fwd", flag, "montgomery", False, "leaf", (256, 65536), None, {}),
        ("K4 leaf 256x65536 inv", flag, "montgomery", True, "leaf", (256, 65536), None, {}),
        ("K4 leaf 32x4096 fwd", flag, "montgomery", False, "leaf", (32, 4096), None, {}),
        ("K4 leaf 32x4096 inv", flag, "montgomery", True, "leaf", (32, 4096), None, {}),
        ("K5 mid 256x256x256 pair fwd", flag, "montgomery", False, "mid", (256, 256, 256), "pair", {}),
        ("K5 mid 256x256x256 pair inv", flag, "montgomery", True, "mid", (256, 256, 256), "pair", {}),
        ("K6 lane 65536x256 pair fwd", flag, "montgomery", False, "lane", (65536, 256), "pair", {}),
        ("K6 lane 65536x256 pair inv", flag, "montgomery", True, "lane", (65536, 256), "pair", {}),
        ("K6 lane 4096x128 w fwd", flag, "montgomery", False, "lane", (4096, 128), "w", {}),
        ("K6 lane 4096x128 w inv", flag, "montgomery", True, "lane", (4096, 128), "w", {}),
        # the lazy test modulus, Montgomery and Shoup stage multiplies
        ("K4 leaf 256x4096 fwd TEST mont", test, "montgomery", False, "leaf", (256, 4096), None, {}),
        ("K4 leaf 256x4096 inv TEST shoup", test, "shoup", True, "leaf", (256, 4096), None, {}),
        ("K4 leaf 256x4096 fwd TEST shoup", test, "shoup", False, "leaf", (256, 4096), None, {}),
        ("K5 mid 64x256x256 pair fwd TEST shoup", test, "shoup", False, "mid", (64, 256, 256), "pair", {}),
        ("K5 mid 64x256x256 w inv TEST mont", test, "montgomery", True, "mid", (64, 256, 256), "w", {}),
        ("K6 lane 4096x256 pair fwd TEST shoup", test, "shoup", False, "lane", (4096, 256), "pair", {}),
        ("K6 lane 4096x256 pair inv TEST mont", test, "montgomery", True, "lane", (4096, 256), "pair", {}),
        ("K6 lane 4096x256 w fwd TEST mont", test, "montgomery", False, "lane", (4096, 256), "w", {}),
        # ragged batches, m = 2, a split leaf and other tiles
        ("K4 leaf 64x300 inv (ragged)", flag, "montgomery", True, "leaf", (64, 300), None, {}),
        ("K5 mid 3x64x300 pair fwd TEST shoup (ragged)", test, "shoup", False, "mid", (3, 64, 300), "pair", {}),
        ("K6 lane 300x64 w inv TEST shoup (ragged)", test, "shoup", True, "lane", (300, 64), "w", {}),
        ("K4 leaf 2x5 fwd", flag, "montgomery", False, "leaf", (2, 5), None, {}),
        ("K6 lane 5x2 pair inv TEST", test, "montgomery", True, "lane", (5, 2), "pair", {}),
        ("K4 leaf 256x1000 inv spc=3 block_b=64", flag, "montgomery", True, "leaf", (256, 1000), None,
         dict(spc=3, block_b=64)),
        ("K6 lane 1000x256 pair fwd rows=64", flag, "montgomery", False, "lane", (1000, 256), "pair",
         dict(rows=64)),
    ]
    worst = {"leaf": 0, "mid": 0, "lane": 0}
    for name, mod, modmul, inverse, orient, shape, mode, knobs in cases:
        fc = FieldConsts.from_modulus(mod, modmul=modmul)
        m = shape[-1] if orient == "lane" else shape[1] if orient == "mid" else shape[0]
        x = rand_u64(rng, shape, device, below=mod.modulus)
        tw = None
        if mode is not None:
            tw = rand_twiddle(rng, shape[:2] if orient == "mid" else shape, mod, mode, device)
        if orient == "lane":
            t = P.make_lane_tables(mod, m, inverse=inverse, modmul=modmul, device=device, **knobs)
            got, want = P.fused_ntt_lane(x, t, fc, tw), P.lane_plain(x, t, fc, tw)
        else:
            t = P.make_leaf_tables(mod, m, inverse=inverse, modmul=modmul, device=device, **knobs)
            if orient == "mid":
                got, want = P.fused_ntt_mid(x, t, fc, tw), P.mid_plain(x, t, fc, tw)
            else:
                got, want = P.fused_ntt(x, t, fc), P.leaf_plain(x, t, fc)
        sync(device)
        err = mismatch(got, want)
        worst[orient] = max(worst[orient], err)
        log(f"  {name}: max_abs_err {err} (lazy={fc.lazy})")
        check(err <= TOL, f"{name}: kernel != plain")
    return worst


def grouped_kernel_cases(device, rng):
    """K7/K8 vs plain at the grouped plans' shapes and the edge cases;
    returns the largest mismatch per orientation."""
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import ntt_pallas as P

    flag, test = moduli()
    # (name, modulus, modmul, max_r, inverse, orientation, data shape, twiddle)
    cases = [
        *[(f"K7 leaf 256x65536 r={r} {d}", flag, "montgomery", r, d == "inv", "leaf",
           (256, 65536), None) for r in (2, 3, 4) for d in ("fwd", "inv")],
        ("K8 lane 65536x256 r=3 pair fwd", flag, "montgomery", 3, False, "lane", (65536, 256), "pair"),
        ("K8 lane 65536x256 r=3 pair inv", flag, "montgomery", 3, True, "lane", (65536, 256), "pair"),
        ("K8 lane 4096x128 r=3 w fwd", flag, "montgomery", 3, False, "lane", (4096, 128), "w"),
        ("K8 lane 4096x128 r=3 w inv", flag, "montgomery", 3, True, "lane", (4096, 128), "w"),
        ("K8 lane 4096x256 r=4 none fwd", flag, "montgomery", 4, False, "lane", (4096, 256), None),
        # the lazy test modulus, Montgomery and Shoup stage multiplies
        ("K7 leaf 256x4096 r=3 fwd TEST mont", test, "montgomery", 3, False, "leaf", (256, 4096), None),
        ("K7 leaf 256x4096 r=3 inv TEST mont", test, "montgomery", 3, True, "leaf", (256, 4096), None),
        ("K7 leaf 256x4096 r=3 fwd TEST shoup", test, "shoup", 3, False, "leaf", (256, 4096), None),
        ("K7 leaf 256x4096 r=4 inv TEST shoup", test, "shoup", 4, True, "leaf", (256, 4096), None),
        ("K8 lane 4096x256 r=3 pair fwd TEST shoup", test, "shoup", 3, False, "lane", (4096, 256), "pair"),
        ("K8 lane 4096x256 r=2 pair inv TEST shoup", test, "shoup", 2, True, "lane", (4096, 256), "pair"),
        ("K8 lane 4096x256 r=3 w fwd TEST mont", test, "montgomery", 3, False, "lane", (4096, 256), "w"),
        ("K8 lane 4096x256 r=4 w inv TEST mont", test, "montgomery", 4, True, "lane", (4096, 256), "w"),
        # ragged batches, m = 2, m = 8
        ("K7 leaf 64x300 r=3 inv (ragged)", flag, "montgomery", 3, True, "leaf", (64, 300), None),
        ("K8 lane 300x64 r=3 pair fwd TEST shoup (ragged)", test, "shoup", 3, False, "lane",
         (300, 64), "pair"),
        ("K7 leaf 2x5 r=2 fwd", flag, "montgomery", 2, False, "leaf", (2, 5), None),
        ("K8 lane 5x2 r=2 pair inv TEST", test, "montgomery", 2, True, "lane", (5, 2), "pair"),
        ("K7 leaf 8x1000 r=4 inv TEST shoup", test, "shoup", 4, True, "leaf", (8, 1000), None),
        ("K8 lane 1000x8 r=3 w fwd", flag, "montgomery", 3, False, "lane", (1000, 8), "w"),
    ]
    worst = {"grouped": 0, "lane_grouped": 0}
    for name, mod, modmul, max_r, inverse, orient, shape, mode in cases:
        fc = FieldConsts.from_modulus(mod, modmul=modmul)
        x = rand_u64(rng, shape, device, below=mod.modulus)
        kw = dict(inverse=inverse, modmul=modmul, max_r=max_r, device=device)
        if orient == "lane":
            t = P.make_lane_tables(mod, shape[1], **kw)
            tw = None if mode is None else rand_twiddle(rng, shape, mod, mode, device)
            got, want = P.fused_ntt_lane(x, t, fc, tw), P.lane_grouped_plain(x, t, fc, tw)
            key = "lane_grouped"
        else:
            t = P.make_leaf_tables(mod, shape[0], **kw)
            got, want = P.fused_ntt(x, t, fc), P.grouped_plain(x, t, fc)
            key = "grouped"
        check(isinstance(t, (P.GroupedDirection, P.GroupedLaneDirection)), f"{name}: not grouped")
        sync(device)
        err = mismatch(got, want)
        worst[key] = max(worst[key], err)
        groups = [spec.R for spec in t.specs]
        log(f"  {name}: max_abs_err {err} (groups {groups}, lazy={fc.lazy})")
        check(err <= TOL, f"{name}: kernel != plain")
    return worst


def transpose_cases(device, rng):
    """K9a/K9b vs plain at the 2^24 root-row shapes with three block shapes;
    returns the largest mismatch per entry."""
    import torch

    from sventt_tpu_torch.ops import transpose as T

    worst = {"plane": 0, "pair": 0}
    for shape, blocks in (((1 << 16, 256), ((256, 256), (512, 64), (512, 8))),
                          ((256, 1 << 16), ((256, 256), (64, 512), (8, 512)))):
        x = rand_u64(rng, shape, device)
        for br, bc in blocks:
            got = T.transpose_u64(x, "pallas", br=br, bc=bc)
            err = mismatch(got, T.transpose_pallas_plain(x))
            worst["pair"] = max(worst["pair"], err)
            log(f"  K9b transpose_u64 int64 {shape[0]}x{shape[1]} blocks ({br}, {bc}): "
                f"max_abs_err {err}")
            check(err <= TOL, "K9b: kernel != plain")
    x32 = x.view(torch.int32)  # (256, 131072) int32 plane
    got = T.transpose_pallas(x32)
    err = int((got != T.transpose_pallas_plain(x32)).sum())
    worst["plane"] = err
    log(f"  K9a transpose_pallas int32 256x131072: {err} elements differ")
    check(err <= TOL, "K9a: kernel != plain")
    return worst


def inter_step_cases(device, rng):
    """The inter-step multiply kernel vs its plain version: the 2^24 inner
    row step's (256, 256, 256) shape, both twiddle modes, the lazy modulus,
    an unbatched root and a ragged batch; returns the largest mismatch."""
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import inter_step
    from sventt_tpu_torch.ops.twiddle import MontPair, inter_step_mul

    flag, test = moduli()
    worst = 0
    for name, mod, shape, mode in (
        ("256x256x256 pair", flag, (256, 256, 256), "pair"),
        ("256x256x256 w", flag, (256, 256, 256), "w"),
        ("256x256x256 pair TEST (lazy)", test, (256, 256, 256), "pair"),
        ("65536x256 w (unbatched)", flag, (1 << 16, 256), "w"),
        ("8x16x300 w TEST (ragged)", test, (8, 16, 300), "w"),
    ):
        fc = FieldConsts.from_modulus(mod)
        x = rand_u64(rng, shape, device, below=mod.modulus)
        tw = rand_twiddle(rng, shape[:2], mod, mode, device)
        got = inter_step.mont_mul_bcast(fc, x, tw)
        view = shape[:2] + (1,) * (len(shape) - 2)
        want = inter_step_mul(
            fc, x, MontPair(tw.w.reshape(view), None if tw.wp is None else tw.wp.reshape(view))
        )
        sync(device)
        err = mismatch(got, want)
        worst = max(worst, err)
        log(f"  inter-step {name}: max_abs_err {err}")
        check(err <= TOL, f"inter-step {name}: kernel != plain")
    return worst


def ring_cases(device, rng):
    """K10 vs plain on logical shards of the card: D = 1, 2, 3, 4, 8 in both
    orientations, the exchanges of the flagship 2^24 (4096 x 4096) and
    2^26 (8192 x 8192) splits at D = 8, and a ragged canonical case (D = 3,
    (5, 7) slabs: odd rows take the 8-byte path); returns the largest
    mismatch."""
    import torch

    from sventt_tpu_torch.parallel import ring

    cases = [(f"D={D} {r}x{c}", D, (r, c), orients)
             for D, r, c, orients in ((1, 16, 64, "both"), (2, 16, 64, "both"), (4, 16, 64, "both"),
                                      (8, 16, 64, "both"), (3, 6, 9, "both"))]
    cases += [
        ("2^24 comm1 D=8 512x4096", 8, (512, 4096), (1, 0)),
        ("2^24 comm2 D=8 4096x512", 8, (4096, 512), (0, 1)),
        ("2^26 comm1 D=8 1024x8192", 8, (1024, 8192), (1, 0)),
        ("2^26 comm2 D=8 8192x1024", 8, (8192, 1024), (0, 1)),
    ]
    worst = 0
    for name, D, shape, orients in cases:
        for split, concat in ((1, 0), (0, 1)) if orients == "both" else (orients,):
            shards = [rand_u64(rng, shape, device) for _ in range(D)]
            got = ring.ring_all_to_all(shards, split, concat)
            want = ring.ring_all_to_all_plain(shards, split, concat)
            sync(device)
            err = max(mismatch(g, w) for g, w in zip(got, want))
            check(all(g.data_ptr() != x.data_ptr() for g in got for x in shards), "K10 aliased")
            worst = max(worst, err)
            log(f"  K10 {name} split {split} concat {concat}: max_abs_err {err}")
            check(err <= TOL, f"K10 {name}: kernel != plain")
    slabs = [rand_u64(rng, (3, 5, 7), device) for _ in range(3)]
    got = ring.canonical_all_to_all(slabs)
    want = ring.canonical_all_to_all_plain(slabs)
    sync(device)
    err = max(mismatch(g, w) for g, w in zip(got, want))
    worst = max(worst, err)
    log(f"  K10 canonical D=3 (3, 5, 7) slabs: max_abs_err {err}")
    check(err <= TOL, "K10 canonical: kernel != plain")
    torch.cuda.empty_cache()
    return worst


def _counted_modules() -> dict:
    from sventt_tpu_torch.experimental import mxu_fused_kernel
    from sventt_tpu_torch.ops import inter_step, ntt_mxu, ntt_pallas, transpose
    from sventt_tpu_torch.parallel import ring

    return {"mxu": ntt_mxu, "pallas": ntt_pallas, "inter_step": inter_step,
            "transpose": transpose, "ring": ring, "fused": mxu_fused_kernel}


def counts():
    mods = _counted_modules()
    return {
        "launches": {k: dict(v.LAUNCHES) for k, v in mods.items()},
        "plain": {k: dict(v.PLAIN_CALLS) for k, v in mods.items()},
    }


def reset_counts() -> None:
    for mod in _counted_modules().values():
        mod.reset_counts()


def no_plain(c) -> bool:
    """No plain version ran in the counts ``c``."""
    return all(v == 0 for d in c["plain"].values() for v in d.values())


def slice_run(device, configs, oracles: dict):
    """Each (label, modulus, generator, n, config keywords) against the
    native oracle, whose outputs are cached in ``oracles`` per (modulus, n).
    Returns the NTTs and the launch and plain-call counts of the run."""
    import numpy as np

    from sventt_tpu_torch import native
    from sventt_tpu_torch.field.limb import from_numpy, to_numpy
    from sventt_tpu_torch.plan import NTT, NttConfig
    from sventt_tpu_torch.utils.fill import host_fill

    ntts = {}
    for label, N, g, n, kw in configs:
        t0 = time.perf_counter()
        ntts[label] = NTT(NttConfig(N, g, n, **kw), device=device)
        sync(device)
        log(f"  {label}: modmul {ntts[label].fc.modmul}; tables built in "
            f"{time.perf_counter() - t0:.2f} s; plan:")
        for line in ntts[label].describe().splitlines():
            log(f"    {line}")
    reset_counts()
    for label, N, g, n, _ in configs:
        ntt = ntts[label]
        x = host_fill(n, N)
        xd = from_numpy(x, device)
        t0 = time.perf_counter()
        fwd = ntt.compute_forward(xd)
        inv = ntt.compute_inverse(xd)  # x read as a bit-reversed spectrum
        back = ntt.compute_inverse(fwd)
        sync(device)
        secs = time.perf_counter() - t0
        fwd_h = to_numpy(ntt.normalize(fwd))
        inv_h = to_numpy(ntt.normalize(inv))
        back_h = to_numpy(ntt.normalize(back))
        del fwd, inv, back, xd
        t0 = time.perf_counter()
        if (N, n) not in oracles:
            oracles[(N, n)] = (native.golden_forward(x, N, g), native.golden_inverse(x, N, g))
        want_f, want_i = oracles[(N, n)]
        osecs = time.perf_counter() - t0
        bad_f = int(np.count_nonzero(fwd_h != want_f))
        bad_i = int(np.count_nonzero(inv_h != want_i))
        bad_r = int(np.count_nonzero(back_h != x))
        log(
            f"  {label}: forward {bad_f} / inverse {bad_i} elements differ from the "
            f"oracle, roundtrip {bad_r} differ (3 transforms {secs * 1e3:.1f} ms incl. "
            f"first-call set-up; oracle {osecs:.1f} s)"
        )
        check(bad_f == 0 and bad_i == 0 and bad_r == 0, f"{label}: mismatch")
    return ntts, counts()


def lane_path(device, rng):
    """``mxu_ntt_lane``, the JAX package's row step on the natural layout
    that no plan calls: the (65536, 256) rows of the 2^24 root step, both
    directions, must equal the lead orientation between two transposes.
    Returns the launch and plain-call counts of those two calls."""
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import ntt_mxu
    from sventt_tpu_torch.ops.transpose import transpose01

    flag, _ = moduli()
    fc = FieldConsts.from_modulus(flag)
    tables = [ntt_mxu.make_mxu_tables(flag, 256, inverse=inv, device=device) for inv in (False, True)]
    x = rand_u64(rng, (1 << 16, 256), device, below=flag.modulus)
    reset_counts()
    got = [ntt_mxu.mxu_ntt_lane(x, t, fc) for t in tables]
    c = counts()
    for t, g in zip(tables, got):
        want = transpose01(ntt_mxu.mxu_ntt(transpose01(x), t, fc))
        sync(device)
        err = mismatch(g, want)
        log(f"  inverse={t.inverse}: max_abs_err {err} against the lead orientation")
        check(err <= TOL, "mxu_ntt_lane != transpose + mxu_ntt + transpose")
    return c


def transpose_path(device, rng):
    """``transpose01_u64(x, "pallas")`` (K9b) on the 2^24 root-row shapes in
    both orientations and ``transpose_pallas`` (K9a) on a u32 plane of the
    same rows, each against the torch copy; then a 3-D input, which must
    take the torch copy and launch nothing.  Returns the launch and
    plain-call counts of the first three calls."""
    import torch

    from sventt_tpu_torch.ops.transpose import transpose01_u64, transpose_pallas, transpose_xla

    xs = [rand_u64(rng, (1 << 16, 256), device), rand_u64(rng, (256, 1 << 16), device)]
    plane = rand_u64(rng, (1 << 16, 128), device).view(torch.int32)  # (65536, 256) u32
    reset_counts()
    got = [transpose01_u64(x, "pallas") for x in xs]
    got_plane = transpose_pallas(plane)
    c = counts()
    for x, g in zip(xs, got):
        err = mismatch(g, transpose_xla(x))
        log(f"  transpose01_u64 {x.shape[0]}x{x.shape[1]} pallas: max_abs_err {err} "
            "against the torch copy")
        check(err <= TOL, "transpose01_u64(pallas) != the torch copy")
    bad = int((got_plane != transpose_xla(plane)).sum())
    log(f"  transpose_pallas int32 65536x256: {bad} elements differ from the torch copy")
    check(bad == 0, "transpose_pallas != the torch copy")
    x3 = xs[0].view(256, 256, 256)
    reset_counts()
    got3 = transpose01_u64(x3, "pallas")
    c3 = counts()
    check(torch.equal(got3, transpose_xla(x3)), "3-D transpose01_u64 != the torch copy")
    check(not any(c3["launches"]["transpose"].values()), "a 3-D transpose launched the kernel")
    log("  transpose01_u64 256x256x256 pallas: the torch copy, no launch")
    return c


def scheme_path(device, rng):
    """The u7 and s8b schemes through ``mxu_ntt`` / ``mxu_ntt_mid`` /
    ``mxu_ntt_lane`` (the JAX package's route to them: its ops-level entry
    points), then K11 through ``mxu_fused_ntt``, each with the launch counts
    set to 0 just before and read just after.  Per scheme at m = 256: a
    forward along the lead axis of (256, 1024) whose columns 0-3 must equal
    the golden model, its inverse along the lane axis of the transposed
    result (an exact roundtrip), and a mid forward of (4, 256, 256) with the
    pair twiddle that must equal s8's (launched after the counts are read).
    Returns the counts per scheme and for K11."""
    from sventt_tpu_torch.experimental import mxu_fused_kernel as fused
    from sventt_tpu_torch.field.golden import GoldenNTT
    from sventt_tpu_torch.field.limb import FieldConsts, to_numpy
    from sventt_tpu_torch.ops import ntt_mxu

    flag, _ = moduli()
    fc = FieldConsts.from_modulus(flag)
    golden = GoldenNTT(256, flag)
    x = rand_u64(rng, (256, 1024), device, below=flag.modulus)
    xm = rand_u64(rng, (4, 256, 256), device, below=flag.modulus)
    twm = rand_twiddle(rng, (4, 256), flag, "pair", device)
    s8 = ntt_mxu.make_mxu_tables(flag, 256, inverse=False, device=device)
    out = {}
    for scheme in ("u7", "s8b"):
        tf, ti = (ntt_mxu.make_mxu_tables(flag, 256, inverse=inv, scheme=scheme, device=device)
                  for inv in (False, True))
        reset_counts()
        f = ntt_mxu.mxu_ntt(x, tf, fc)
        back = ntt_mxu.mxu_ntt_lane(f.t().contiguous(), ti, fc)
        mid = ntt_mxu.mxu_ntt_mid(xm, tf, fc, twm)
        sync(device)
        out[scheme] = c = counts()
        xh, fh = to_numpy(x), to_numpy(f)
        ok = all([int(v) for v in fh[:, col]] == golden.forward([int(v) for v in xh[:, col]])
                 for col in range(4))
        err_mid = mismatch(mid, ntt_mxu.mxu_ntt_mid(xm, s8, fc, twm))
        log(f"  {scheme}: forward columns 0-3 == golden {ok}; lane inverse roundtrip exact "
            f"{bool((back.t() == x).all())}; mid pair max_abs_err {err_mid} against s8")
        log(f"    launches {c['launches']['mxu']}, plain calls {c['plain']}")
        check(ok and bool((back.t() == x).all()) and err_mid == 0, f"{scheme} path: mismatch")
        check(all(c["launches"]["mxu"][k] > 0 for k in ("lead", "mid", "lane")),
              f"{scheme}: an orientation never launched")
        check(no_plain(c), f"{scheme}: a plain version ran on the card")
    stack = fused.make_fused_stack(flag, device=device)
    x128 = rand_u64(rng, (128, 1 << 15), device, below=flag.modulus)
    reset_counts()
    y = fused.mxu_fused_ntt(x128, stack, flag)
    sync(device)
    out["fused"] = c = counts()
    g128 = GoldenNTT(128, flag)
    xh, yh = to_numpy(x128), to_numpy(y)
    ok = all([int(v) for v in yh[:, col]] == g128.forward([int(v) for v in xh[:, col]])
             for col in (0, 1, 32767))
    log(f"  K11 mxu_fused_ntt 128x32768: columns 0, 1, 32767 == golden {ok}; "
        f"launches {c['launches']['fused']}, plain calls {c['plain']}")
    check(ok, "K11 path: != golden")
    check(c["launches"]["fused"]["fused"] > 0 and no_plain(c), "K11 did not launch, or a plain one ran")
    return out


def logical_mesh(device, D: int, shape=None):
    """A mesh naming the card D times (logical shards): 1-D "shard", or
    ``shape`` (2, 4) with axes ("dcn", "ici")."""
    from sventt_tpu_torch.parallel import make_ntt_mesh
    from sventt_tpu_torch.parallel.mesh import make_mesh

    if shape is None:
        return make_ntt_mesh(devices=[device] * D)
    return make_mesh(shape, ("dcn", "ici"), devices=[device] * D)


def dist_run(device, paths, oracles: dict):
    """Each (label, modulus, generator, n, config keywords, mesh, comm)
    distributed path: forward and inverse of the ``host_fill`` input
    against the native oracle (``oracles`` per (modulus, n)), and an exact
    roundtrip, with the launch counts set to 0 before and read after.
    Returns the counts per label."""
    import numpy as np
    import torch

    from sventt_tpu_torch.field.limb import from_numpy, to_numpy
    from sventt_tpu_torch.parallel import DistributedNTT
    from sventt_tpu_torch.plan import NttConfig
    from sventt_tpu_torch.utils.fill import host_fill

    out = {}
    for label, N, g, n, kw, mesh, comm in paths:
        t0 = time.perf_counter()
        axes = mesh.axis_names
        dntt = DistributedNTT(NttConfig(N, g, n, strategy="six_step", **kw), mesh,
                              axis=axes[0] if len(axes) == 1 else axes, comm=comm)
        sync(device)
        build = time.perf_counter() - t0
        x = host_fill(n, N)
        shards = dntt.shard(from_numpy(x, device))
        reset_counts()
        t0 = time.perf_counter()
        fwd = dntt.compute_forward(shards)
        inv = dntt.compute_inverse(shards)  # x read as a bit-reversed spectrum
        back = dntt.compute_inverse(fwd)
        sync(device)
        secs = time.perf_counter() - t0
        c = counts()
        got = [to_numpy(torch.cat(dntt.normalize(v))) for v in (fwd, inv, back)]
        del fwd, inv, back, shards
        want_f, want_i = oracles[(N, n)]
        bad = [int(np.count_nonzero(a != b)) for a, b in zip(got, (want_f, want_i, x))]
        log(f"  {label}: D={dntt.D} comm={comm} {dntt.fc.modmul} on {len(set(dntt.devices))} "
            f"card(s); forward {bad[0]} / inverse {bad[1]} elements differ from the oracle, "
            f"roundtrip {bad[2]} differ (tables {build:.2f} s; 3 transforms {secs * 1e3:.1f} ms "
            "incl. first-call set-up)")
        log(f"    launches {c['launches']}, plain calls {c['plain']}")
        check(bad == [0, 0, 0], f"{label}: mismatch")
        k10 = c["launches"]["ring"]["ring"]
        check(k10 > 0 if comm == "ring" else k10 == 0, f"{label}: K10 launches {k10}")
        check(c["launches"]["inter_step"]["inter_step"] > 0, f"{label}: no inter-step launch")
        check(no_plain(c), f"{label}: a plain version ran on the card")
        out[label] = c
        del dntt
        torch.cuda.empty_cache()
    return out


def dist_2p28(device):
    """The 2^28 flagship transform, ``engine="pallas"``, on 8 logical
    shards with the ring: its forward equals the single-device six-step
    transform of the same split on the card (``torch.equal`` after
    ``normalize``), its roundtrip is exact; beside the memory budget and
    the card's peak allocation.  Returns the launch counts."""
    import torch

    from sventt_tpu_torch.parallel import DistributedNTT, distributed_memory_budget
    from sventt_tpu_torch.plan import NTT, NttConfig
    from sventt_tpu_torch.utils.fill import device_fill

    flag, _ = moduli()
    n = 1 << 28
    cfg = NttConfig(flag.modulus, flag.generator, n, strategy="six_step", engine="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dntt = DistributedNTT(cfg, logical_mesh(device, 8), comm="ring")
    x = device_fill(n, flag.modulus, device)
    shards = dntt.shard(x)
    reset_counts()
    fwd = dntt.compute_forward(shards)
    back = dntt.compute_inverse(fwd)
    sync(device)
    c = counts()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ok_back = torch.equal(torch.cat(dntt.normalize(back)), x)
    del back, shards
    got = torch.cat(dntt.normalize(fwd))
    del fwd, dntt
    torch.cuda.empty_cache()
    single = NTT(cfg, enable_inverse=False, device=device)
    ok_fwd = torch.equal(single.normalize(single.compute_forward(x)), got)
    sync(device)
    b = distributed_memory_budget(cfg, 8)
    card = 8 * (b.coefficients + b.transient + b.directions * b.inter_step_twiddles)
    card += b.directions * b.leaf_tables
    log(f"  2^28 D=8 ring: forward == single-device six_step {ok_fwd}, roundtrip exact {ok_back} "
        f"(tables + 2 transforms {secs:.2f} s); plan {single.plan.m0} x {single.plan.m1}")
    log(f"    budget per shard {b}: total {b.total} bytes; 8 logical shards on one card "
        f"{card} bytes; torch.cuda.max_memory_allocated() {peak} bytes")
    log(f"    launches {c['launches']}, plain calls {c['plain']}")
    check(ok_fwd and ok_back, "2^28: mismatch")
    check(c["launches"]["ring"]["ring"] > 0 and no_plain(c), "2^28: K10 did not run, or a plain one did")
    del single, got, x
    torch.cuda.empty_cache()
    return c


def multi_card(oracles: dict) -> None:
    """The 2^24 ring path over distinct cards, where there are two or
    more; otherwise one line saying it did not run."""
    import torch

    from sventt_tpu_torch.parallel import make_ntt_mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[multi-card] not run: {cards} card on this machine; cross-card peer reads "
            "and stream ordering of K10 are not verified here")
        return
    D = 1 << (min(cards, 8).bit_length() - 1)
    flag, _ = moduli()
    log(f"[multi-card] the 2^24 ring path over {D} distinct cards")
    dist_run("cuda", [(f"pallas 2^24 D={D} ring, {D} cards", flag.modulus, flag.generator,
                       1 << 24, dict(engine="pallas"), make_ntt_mesh(D), "ring")], oracles)


# ---------------------------------------------------------------------------
# the least time the card could take
# ---------------------------------------------------------------------------


def bound(bytes_moved: float, ops_time_s: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and the operations' time at their peak."""
    t_bytes = bytes_moved / HBM_BPS
    if t_bytes >= ops_time_s:
        return t_bytes * 1e3, "bytes"
    return ops_time_s * 1e3, "operations"


#: int8 multiply-adds a point per unit of m that each plane scheme's own
#: formulation takes: s8 8 x 8 planes, u7 10 x 10, s8b its banded matrix's
#: 15 x 8 blocks (the TPU's MXU multiplied the zero blocks too).  Printed
#: beside the bound, which counts the least of them.
SCHEME_MACS = {"s8": 64, "u7": 100, "s8b": 120}


def mxu_bound(points: int, m: int, tw_bytes: int, macs: int = 64) -> tuple[float, str]:
    """K1/K2/K3 and K11: every scheme computes the same length-m NTT, and
    the least work that does it, s8's, is 64 * m int8 multiply-adds a point
    on the tensor cores (``macs`` another count); 8 bytes a point in, 8 out,
    plus the twiddle table read once."""
    return bound(16 * points + tw_bytes, 2 * macs * m * points / INT8_OPS)


def butterfly_bound(points: int, m: int, inverse: bool, modmul: str, tw: str | None,
                    tw_points: int) -> tuple[float, str]:
    """K4/K5/K6: per stage, one stage multiply per butterfly (two on the
    last inverse stage); Montgomery is two high and one low 64-bit
    products, Shoup one high and two low; the inter-step multiply is
    Montgomery (mode "w" adds one low product).  Bytes: 8 a point in and 8
    out, the (tw_points,) inter-step table (8 or 16 bytes an entry) and the
    two (m-1,) stage tables read once."""
    stages = m.bit_length() - 1
    mul = 2 * IMAD_HI + IMAD_LO if modmul == "montgomery" else IMAD_HI + 2 * IMAD_LO
    muls = stages * points // 2 + (points // 2 if inverse else 0)
    imads = muls * mul
    tw_bytes = 0
    if tw is not None:
        imads += points * (2 * IMAD_HI + IMAD_LO + (IMAD_LO if tw == "w" else 0))
        tw_bytes = tw_points * (16 if tw == "pair" else 8)
    return bound(16 * points + tw_bytes + 16 * (m - 1), imads / IMAD_PER_S)


def grouped_bound(points: int, t, modmul: str, tw: str | None, tw_points: int,
                  lane: bool) -> tuple[float, str]:
    """K7/K8, counted from the tables' GroupSpecs: a stage multiply (as in
    butterfly_bound) for each butterfly of a rank whose sub-slice has a
    constant, and one for each combined-table entry the kernel multiplies
    -- every point for K8 (``lane``), for K7 the second points and the
    first points whose combined exponent is not 0 (all in a scaled group);
    the inter-step multiply as in butterfly_bound.  Bytes: 8 a point in and
    8 out, the inter-step table and the (groups, m) combined tables."""
    m = t.m
    per_col = 0
    for spec in t.specs:
        for s, h in enumerate(spec.ls):
            with_const = sum(c is not None for c in spec.consts[s])
            per_col += with_const * (m // (2 * h)) * spec.L
        h = spec.ls[0] if t.inverse else spec.ls[-1]
        if lane or spec.scaled:
            per_col += m
        else:
            firsts = [j for j in range(m) if j % (2 * h) < h]
            per_col += m // 2 + sum(1 for j in firsts if (j % spec.span) // spec.L)
    mul = 2 * IMAD_HI + IMAD_LO if modmul == "montgomery" else IMAD_HI + 2 * IMAD_LO
    imads = per_col * (points // m) * mul
    tw_bytes = 0
    if tw is not None:
        imads += points * (2 * IMAD_HI + IMAD_LO + (IMAD_LO if tw == "w" else 0))
        tw_bytes = tw_points * (16 if tw == "pair" else 8)
    return bound(16 * points + tw_bytes + 16 * m * len(t.specs), imads / IMAD_PER_S)


def inter_step_bound(points: int, tw_points: int, tw: str) -> tuple[float, str]:
    """The inter-step multiply: one Montgomery product a point (mode "w"
    one low product more); 8 bytes a point in, 8 out, the table once."""
    imads = points * (2 * IMAD_HI + IMAD_LO + (IMAD_LO if tw == "w" else 0))
    return bound(16 * points + tw_points * (16 if tw == "pair" else 8), imads / IMAD_PER_S)


def ab_level(device, fc, out: dict, bounds: dict, own: dict) -> None:
    """The round-5 A/B harnesses of the JAX package, timed by CUDA events:
    experimental/r5_s8_ab.py (s8 against u7; the pair twiddle fused into
    the level against a separate inter-step pass) and r5_banded_ab.py (s8
    against s8b).  One mid level of 2^22 points, (a, m, b) = (64, 256, 256)
    (the JAX harnesses' shape), iota data, the flagship modulus, the
    six-step row twiddles of (a, m).  Each scheme's tables first transform
    two columns (one of N-1) that must equal the golden model.  Every
    scheme's tables are built before anything is timed, so an s8b leg at
    m > 512 would fail up front (the JAX banded harness fails halfway at
    m = 1024)."""
    import numpy as np
    import torch

    from sventt_tpu_torch.field.golden import GoldenNTT
    from sventt_tpu_torch.field.limb import from_numpy, to_numpy
    from sventt_tpu_torch.ops import inter_step, ntt_mxu
    from sventt_tpu_torch.plan.planner import row_twiddles

    flag, _ = moduli()
    a, m, b = 64, 256, 256
    tables = {s: ntt_mxu.make_mxu_tables(flag, m, inverse=False, scheme=s, device=device)
              for s in SCHEME_MACS}
    xs = np.random.default_rng(5).integers(0, flag.modulus, (m, 2), dtype=np.uint64)
    xs[:, 1] = flag.modulus - 1
    golden = GoldenNTT(m, flag)
    want = [golden.forward([int(v) for v in xs[:, c]]) for c in range(2)]
    x = torch.arange(a * m * b, dtype=torch.int64, device=device).reshape(a, m, b)
    tw = row_twiddles(flag, a, m, inverse=False, w_only=False, device=device)
    tw_bytes = 16 * a * m
    for scheme, t in tables.items():
        got = to_numpy(ntt_mxu.mxu_ntt(from_numpy(xs, device), t, fc))
        check(all([int(v) for v in got[:, c]] == want[c] for c in range(2)),
              f"A/B {scheme}: != golden")
        key = f"A/B mid {a}x{m}x{b} {scheme}"
        out[key] = timed(lambda: ntt_mxu.mxu_ntt_mid(x, t, fc), 3, 10)
        out[key + " +fused-tw"] = timed(lambda: ntt_mxu.mxu_ntt_mid(x, t, fc, tw), 3, 10)
        out[key + " +separate-tw"] = timed(
            lambda: ntt_mxu.mxu_ntt_mid(inter_step.mont_mul_bcast(fc, x, tw), t, fc), 3, 10
        )
        for k, twb in ((key, 0), (key + " +fused-tw", tw_bytes), (key + " +separate-tw", tw_bytes)):
            bounds[k] = mxu_bound(a * m * b, m, twb)
            own[k] = mxu_bound(a * m * b, m, twb, SCHEME_MACS[scheme])[0]
    log(f"  A/B level (a, m, b) = ({a}, {m}, {b}): every scheme == golden on 2 columns")


def times(device, ntts, rng):
    """CUDA-event medians: transforms, and each kernel vs its plain
    version at the 2^24 plans' shapes; with each kernel's bound."""
    import torch

    from sventt_tpu_torch.experimental import mxu_fused_kernel as fused
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import inter_step, ntt_mxu
    from sventt_tpu_torch.ops import ntt_pallas as P
    from sventt_tpu_torch.ops import transpose as T
    from sventt_tpu_torch.ops.transpose import transpose01
    from sventt_tpu_torch.ops.twiddle import MontPair, inter_step_mul
    from sventt_tpu_torch.utils.fill import device_fill

    out, bounds, own = {}, {}, {}
    for label, ntt in ntts.items():
        n = ntt.get_m()
        x = device_fill(n, ntt.config.modulus, device)
        f = ntt.compute_forward(x)
        out[f"{label} fwd"] = timed(lambda: ntt.compute_forward(x), 3, 10)
        out[f"{label} inv"] = timed(lambda: ntt.compute_inverse(f), 3, 10)
        del x, f
    flag, _ = moduli()
    fc = FieldConsts.from_modulus(flag)
    n24 = 1 << 24

    def kernel(key, fn, plain, bnd, own_ms=None):
        out[key] = timed(fn, 3, 10)
        out[key + " plain"] = timed(plain, 1, 3)
        bounds[key] = bnd
        if own_ms is not None:
            own[key] = own_ms

    # matrix engine: the 2^24 plan's root row step (lead, transposed
    # twiddle), inner row step (mid, (256, 256) twiddle rows) and the lane
    # orientation that could replace the root's transpose sandwich
    t = ntt_mxu.make_mxu_tables(flag, 256, inverse=False, device=device)
    xl = rand_u64(rng, (256, 1 << 16), device, below=flag.modulus)
    twl = rand_twiddle(rng, (256, 1 << 16), flag, "pair", device)
    kernel("K1 lead 256x65536 pair", lambda: ntt_mxu.mxu_ntt(xl, t, fc, twl),
           lambda: ntt_mxu.mxu_plain(xl, t, fc, twl), mxu_bound(n24, 256, 16 * n24))
    xm = rand_u64(rng, (256, 256, 256), device, below=flag.modulus)
    twm = rand_twiddle(rng, (256, 256), flag, "pair", device)
    kernel("K2 mid 256x256x256 pair", lambda: ntt_mxu.mxu_ntt_mid(xm, t, fc, twm),
           lambda: ntt_mxu.mxu_plain(xm, t, fc, twm, mid=True), mxu_bound(n24, 256, 16 * 65536))
    xr = rand_u64(rng, (1 << 16, 256), device, below=flag.modulus)
    kernel("K3 lane 65536x256", lambda: ntt_mxu.mxu_ntt_lane(xr, t, fc),
           lambda: ntt_mxu.mxu_plain(xr, t, fc, lane=True), mxu_bound(n24, 256, 0))
    out["K1 lead 65536x256 between transposes"] = timed(
        lambda: transpose01(ntt_mxu.mxu_ntt(transpose01(xr), t, fc)), 3, 10
    )
    # the other plane schemes at the same three shapes, and K11 at its own
    for scheme in ("u7", "s8b"):
        ts = ntt_mxu.make_mxu_tables(flag, 256, inverse=False, scheme=scheme, device=device)
        macs = SCHEME_MACS[scheme]
        kernel(f"K1 lead 256x65536 pair {scheme}", lambda: ntt_mxu.mxu_ntt(xl, ts, fc, twl),
               lambda: ntt_mxu.mxu_plain(xl, ts, fc, twl), mxu_bound(n24, 256, 16 * n24),
               mxu_bound(n24, 256, 16 * n24, macs)[0])
        kernel(f"K2 mid 256x256x256 pair {scheme}", lambda: ntt_mxu.mxu_ntt_mid(xm, ts, fc, twm),
               lambda: ntt_mxu.mxu_plain(xm, ts, fc, twm, mid=True),
               mxu_bound(n24, 256, 16 * 65536), mxu_bound(n24, 256, 16 * 65536, macs)[0])
        kernel(f"K3 lane 65536x256 {scheme}", lambda: ntt_mxu.mxu_ntt_lane(xr, ts, fc),
               lambda: ntt_mxu.mxu_plain(xr, ts, fc, lane=True), mxu_bound(n24, 256, 0),
               mxu_bound(n24, 256, 0, macs)[0])
    stack = fused.make_fused_stack(flag, device=device)
    x128 = rand_u64(rng, (128, 1 << 15), device, below=flag.modulus)
    kernel("K11 fused 128x32768", lambda: fused.mxu_fused_ntt(x128, stack, flag),
           lambda: fused.mxu_fused_plain(x128, stack, flag), mxu_bound(1 << 22, 128, 0),
           mxu_bound(1 << 22, 128, 0, SCHEME_MACS["u7"])[0])
    del xl, twl, xr, x128
    ab_level(device, fc, out, bounds, own)
    # butterfly engine: the 2^24 pallas plan's leaf, inner row step and root
    lt = P.make_leaf_tables(flag, 256, inverse=False, device=device)
    kernel("K4 leaf 256x65536", lambda: P.fused_ntt(xm.view(256, 65536), lt, fc),
           lambda: P.leaf_plain(xm.view(256, 65536), lt, fc),
           butterfly_bound(n24, 256, False, "montgomery", None, 0))
    kernel("K5 mid 256x256x256 pair", lambda: P.fused_ntt_mid(xm, lt, fc, twm),
           lambda: P.mid_plain(xm, lt, fc, twm),
           butterfly_bound(n24, 256, False, "montgomery", "pair", 65536))
    rt = P.make_lane_tables(flag, 256, inverse=False, device=device)
    xr = xm.view(1 << 16, 256)
    twr = rand_twiddle(rng, (1 << 16, 256), flag, "pair", device)
    kernel("K6 lane 65536x256 pair", lambda: P.fused_ntt_lane(xr, rt, fc, twr),
           lambda: P.lane_plain(xr, rt, fc, twr),
           butterfly_bound(n24, 256, False, "montgomery", "pair", n24))
    # grouped engine (max_r = 3): the 2^24 plan's leaves (the column leaf
    # and the inner row's leaf between transposes), the inter-step multiply
    # of that row, the root
    gt = P.make_leaf_tables(flag, 256, inverse=False, max_r=3, device=device)
    kernel("K7 leaf 256x65536 r=3", lambda: P.fused_ntt(xm.view(256, 65536), gt, fc),
           lambda: P.grouped_plain(xm.view(256, 65536), gt, fc),
           grouped_bound(n24, gt, "montgomery", None, 0, False))
    gr = P.make_lane_tables(flag, 256, inverse=False, max_r=3, device=device)
    kernel("K8 lane 65536x256 r=3 pair", lambda: P.fused_ntt_lane(xr, gr, fc, twr),
           lambda: P.lane_grouped_plain(xr, gr, fc, twr),
           grouped_bound(n24, gr, "montgomery", "pair", n24, True))
    view = MontPair(twm.w.unsqueeze(2), twm.wp.unsqueeze(2))
    kernel("inter-step 256x256x256 pair", lambda: inter_step.mont_mul_bcast(fc, xm, twm),
           lambda: inter_step_mul(fc, xm, view), inter_step_bound(n24, 65536, "pair"))
    # the blocked transpose at the root-row shape: u64 (K9b), u32 plane (K9a)
    plane = xr.view(torch.int32)[:, :256].contiguous()
    for key, fn, x in (("K9b transpose_u64 65536x256 int64",
                        lambda v: T.transpose_u64(v, "pallas"), xr),
                       ("K9a transpose_pallas 65536x256 int32", T.transpose_pallas, plane)):
        kernel(key, lambda: fn(x), lambda: T.transpose_pallas_plain(x),
               bound(2 * x.numel() * x.element_size(), 0.0))
        out[key + " library"] = timed(lambda: x.t().contiguous(), 3, 10)
    del xm, xr, twm, twr, plane
    # the distributed 2^24 forward on logical shards of this card, per D
    # and comm mode; then K10 alone at the D = 8 [comm 1] exchange
    from sventt_tpu_torch.parallel import DistributedNTT, ring
    from sventt_tpu_torch.plan import NttConfig

    x24 = device_fill(n24, flag.modulus, device)
    cfg = NttConfig(flag.modulus, flag.generator, n24, strategy="six_step", engine="pallas")
    for D in (4, 8):
        for comm in ("xla", "ring", "overlap"):
            dntt = DistributedNTT(cfg, logical_mesh(device, D), comm=comm, enable_inverse=False)
            shards = dntt.shard(x24)
            out[f"distributed 2^24 D={D} {comm} fwd"] = timed(
                lambda: dntt.compute_forward(shards), 3, 10
            )
            del dntt, shards
    del x24
    # The wrappers' Python work (eight shards, ctypes, allocations) takes
    # longer than the copy, so K10, its plain version and the torch copy
    # are each also timed as one CUDA-graph replay: their device time.
    shards = [rand_u64(rng, (512, 4096), device) for _ in range(8)]
    key = "K10 ring 2^24 D=8 8x(512x4096) split 1"
    calls = {"": lambda: ring.ring_all_to_all(shards, 1, 0),
             " plain": lambda: ring.ring_all_to_all_plain(shards, 1, 0),
             " library": lambda: ring.copy_all_to_all(shards, 1, 0)}
    for suffix, fn in calls.items():
        out[key + suffix + " eager"] = timed(fn, 3, 10)
        try:
            out[key + suffix] = timed_graph(fn, 3, 10)
        except RuntimeError as e:  # a measurement only: the eager time stands in
            log(f"  {key}{suffix}: CUDA graph capture failed ({e!r}); eager time used")
            out[key + suffix] = out[key + suffix + " eager"]
    bounds[key] = bound(16 * n24, 0.0)
    return out, bounds, own


def breakdown(label: str, run, device, reps: int = 5, top: int = 12) -> None:
    """Device time of ``reps`` forward transforms (``run()``) by kernel
    (torch.profiler, CUPTI; the ``top`` largest), per transform, and the
    device's busy share of the host-clock time of the same transforms run
    back to back without the profiler.  Informational: where the profiler
    records no device time it says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync(device)
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        sync(device)
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    if not rows:
        log(f"  {label} forward: no device time recorded by the profiler (not measured)")
        return
    log(f"  {label} forward: device {busy:.4f} ms (profiler) of {wall:.4f} ms host clock per "
        f"transform without it (busy {100 * busy / wall:.1f}%)")
    for name, ms, count in rows[:top]:
        log(f"    {ms:.4f} ms {100 * ms / busy:5.1f}%  x{count:g}  {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from sventt_tpu_torch import _build, native
        from sventt_tpu_torch.field.modulus import (
            FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, TEST_GENERATOR, TEST_MODULUS,
        )
    except ImportError as e:
        print(f"chip_smoke: the sventt_tpu_torch package is missing ({e})", file=sys.stderr)
        return 1
    device = "cuda"

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"total_memory {torch.cuda.get_device_properties(0).total_memory} bytes")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    kernel_build = dict(_build.LAST_BUILD)
    native.load()
    log(f"[build] kernels + oracle in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernel_build['seconds']:.1f} s, one process per source)")
    for line in kernel_build["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    # 3. kernel vs plain
    rng = np.random.default_rng(20261016)
    log("[kernel vs plain] bitwise, tolerance 0")
    worst = {"mxu": mxu_kernel_cases(device, rng)}
    for scheme in ("u7", "s8b"):
        worst[f"mxu {scheme}"] = mxu_kernel_cases(device, rng, scheme)
    worst["fused"] = fused_cases(device, rng)
    torch.cuda.empty_cache()
    worst["pallas"] = pallas_kernel_cases(device, rng)
    worst["pallas"].update(grouped_kernel_cases(device, rng))
    worst["transpose"] = transpose_cases(device, rng)
    worst["inter_step"] = inter_step_cases(device, rng)
    worst["ring"] = ring_cases(device, rng)
    torch.cuda.empty_cache()

    # 4. the slices, each with its own counts
    F, G = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR
    oracles: dict = {}
    log("[slice mxu] NTT(engine='auto' -> mxu) vs the native oracle, elementwise")
    ntts_mxu, c_mxu = slice_run(
        device, [(f"mxu 2^{k}", F, G, 1 << k, {}) for k in (17, 24, 26)], oracles
    )
    log(f"  launches {c_mxu['launches']}, plain calls {c_mxu['plain']}")
    check(c_mxu["launches"]["mxu"]["lead"] > 0 and c_mxu["launches"]["mxu"]["mid"] > 0,
          "an mxu orientation of the path never ran")
    del ntts_mxu["mxu 2^26"]
    torch.cuda.empty_cache()
    log("[slice pallas] NTT(engine='pallas') vs the native oracle, elementwise")
    pal = dict(engine="pallas")
    ntts_pal, c_pal = slice_run(
        device,
        [(f"pallas 2^{k}", F, G, 1 << k, pal) for k in (17, 24, 26)]
        + [("pallas TEST 2^24", TEST_MODULUS, TEST_GENERATOR, 1 << 24, pal)],
        oracles,
    )
    log(f"  launches {c_pal['launches']}, plain calls {c_pal['plain']}")
    check(ntts_pal["pallas TEST 2^24"].fc.modmul == "shoup", "TEST 2^24 auto != shoup")
    check(all(c_pal["launches"]["pallas"][k] > 0 for k in ("leaf", "mid", "lane")),
          "a butterfly orientation of the path never ran")
    del ntts_pal["pallas 2^26"], ntts_pal["pallas TEST 2^24"]
    torch.cuda.empty_cache()
    log("[slice pallas max_r=3] NTT(engine='pallas', max_r=3) vs the native oracle, "
        "elementwise")
    grp = dict(engine="pallas", max_r=3)
    ntts_grp, c_grp = slice_run(
        device,
        [(f"grouped 2^{k}", F, G, 1 << k, grp) for k in (17, 24, 26)]
        + [("grouped TEST 2^24", TEST_MODULUS, TEST_GENERATOR, 1 << 24, grp)],
        oracles,
    )
    log(f"  launches {c_grp['launches']}, plain calls {c_grp['plain']}")
    check(ntts_grp["grouped TEST 2^24"].fc.modmul == "shoup", "TEST 2^24 auto != shoup")
    lg = c_grp["launches"]
    check(lg["pallas"]["grouped"] > 0 and lg["pallas"]["lane_grouped"] > 0
          and lg["inter_step"]["inter_step"] > 0, "a kernel of the grouped path never ran")
    check(not any(lg["pallas"][k] for k in ("leaf", "mid", "lane")),
          "the grouped path ran a radix-2 kernel")
    for c in (c_mxu, c_pal, c_grp):
        check(no_plain(c), "a plain version ran on the card")
    del ntts_grp["grouped 2^26"], ntts_grp["grouped TEST 2^24"]
    torch.cuda.empty_cache()
    log("[path mxu_ntt_lane] K3 on the 2^24 root-row shape vs transpose + K1 + transpose")
    c_lane = lane_path(device, rng)
    log(f"  launches {c_lane['launches']}, plain calls {c_lane['plain']}")
    check(c_lane["launches"]["mxu"]["lane"] > 0, "mxu_ntt_lane never launched")
    check(no_plain(c_lane), "a plain version ran on the card")
    log("[path transpose01_u64 pallas] K9 on the 2^24 root-row shapes vs the torch copy")
    c_tr = transpose_path(device, rng)
    log(f"  launches {c_tr['launches']}, plain calls {c_tr['plain']}")
    check(c_tr["launches"]["transpose"]["pair"] > 0 and c_tr["launches"]["transpose"]["plane"] > 0,
          "the blocked transpose never launched")
    check(no_plain(c_tr), "a plain version ran on the card")
    log("[path schemes] u7 / s8b through mxu_ntt, mxu_ntt_mid, mxu_ntt_lane; K11 through "
        "mxu_fused_ntt")
    c_schemes = scheme_path(device, rng)
    torch.cuda.empty_cache()
    log("[distributed] DistributedNTT on logical shards of this card vs the native oracle, "
        "elementwise")
    T, TG = TEST_MODULUS, TEST_GENERATOR
    pal, m4, m8 = dict(engine="pallas"), logical_mesh(device, 4), logical_mesh(device, 8)
    c_dist = dist_run(device, [
        ("pallas 2^24 D=4 xla", F, G, 1 << 24, pal, m4, "xla"),
        ("pallas 2^24 D=4 ring", F, G, 1 << 24, pal, m4, "ring"),
        ("pallas 2^24 D=4 overlap", F, G, 1 << 24, pal, m4, "overlap"),
        ("pallas 2^24 D=8 ring", F, G, 1 << 24, pal, m8, "ring"),
        ("mxu 2^24 D=4 ring", F, G, 1 << 24, {}, m4, "ring"),
        ("grouped 2^24 D=8 ring", F, G, 1 << 24, dict(engine="pallas", max_r=3), m8, "ring"),
        ("pallas TEST 2^24 D=4 ring", T, TG, 1 << 24, pal, m4, "ring"),
        ("pallas 2^26 D=8 ring", F, G, 1 << 26, pal, m8, "ring"),
        ("pallas 2^24 (2, 4) dcn x ici xla", F, G, 1 << 24, pal, logical_mesh(device, 8, (2, 4)),
         "xla"),
    ], oracles)
    check(c_dist["mxu 2^24 D=4 ring"]["launches"]["mxu"]["mid"] > 0, "the mxu path ran no K2")
    check(c_dist["grouped 2^24 D=8 ring"]["launches"]["pallas"]["grouped"] > 0,
          "the grouped path ran no K7")
    log("[distributed 2^28] 8 logical shards, ring, vs the single-device six_step transform")
    dist_2p28(device)
    multi_card(oracles)
    del oracles
    torch.cuda.empty_cache()

    # 5. times
    ms, bounds, own = times(device, {**ntts_mxu, **ntts_pal, **ntts_grp}, rng)
    log(f"[times] median ms by CUDA events on {smi} (distributed: logical shards of this "
        "card, the schedule's cost on one card's memory, not scaling):")
    for k, v in ms.items():
        extra = f"   (bound {bounds[k][0]:.4f} ms, {bounds[k][1]})" if k in bounds else ""
        if k in own:
            extra += f"   (the scheme's own products: {own[k]:.4f} ms)"
        log(f"  {k}: {v:.4f}{extra}")
    # across 8 cards each would send 7/8 of its 2^21-point shard over NVLink
    nvlink = 7 / 8 * (1 << 21) * 8 / 450e9 * 1e3
    log(f"  K10 2^24 D=8 across 8 cards: bound {nvlink:.4f} ms by NVLink bytes "
        "(450 GB/s each way per card); not measured")
    log("[breakdown] device time by kernel, torch.profiler")
    from sventt_tpu_torch.parallel import DistributedNTT
    from sventt_tpu_torch.plan import NttConfig
    from sventt_tpu_torch.utils.fill import device_fill

    runs = {}
    for label in ("pallas 2^24", "grouped 2^24"):
        ntt = {**ntts_pal, **ntts_grp}[label]
        x = device_fill(ntt.get_m(), F, device)
        runs[label] = lambda ntt=ntt, x=x: ntt.compute_forward(x)
    cfg24 = NttConfig(F, G, 1 << 24, strategy="six_step", engine="pallas")
    for D, comm in ((4, "ring"), (8, "ring"), (4, "overlap")):
        dntt = DistributedNTT(cfg24, logical_mesh(device, D), comm=comm, enable_inverse=False)
        shards = dntt.shard(device_fill(1 << 24, F, device))
        runs[f"distributed 2^24 D={D} {comm}"] = lambda dntt=dntt, s=shards: dntt.compute_forward(s)
    for label, run in runs.items():
        try:
            breakdown(label, run, device)
        except Exception as e:  # instrumentation only: the checks above decide
            log(f"  {label}: profiler failed ({e!r}); not measured")
    del runs

    def entry(name, key, src, replaces, launches, err):
        return {
            "name": name, "route": "cuda", "source": f"sventt_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms[key], "plain_ms": ms[key + " plain"], "bound_ms": bounds[key][0],
            "bound_by": bounds[key][1], "library_ms": ms.get(key + " library"),
        }

    lm, lp = dict(c_mxu["launches"]["mxu"]), dict(c_pal["launches"]["pallas"])
    lm["lane"] = c_lane["launches"]["mxu"]["lane"]
    for k in ("grouped", "lane_grouped"):
        lp[k] = c_grp["launches"]["pallas"][k]
    lt = c_tr["launches"]["transpose"]
    wm, wp, wt = worst["mxu"], worst["pallas"], worst["transpose"]
    k10_launches = c_dist["pallas 2^24 D=8 ring"]["launches"]["ring"]["ring"]
    record = {"kernels": [
        entry("K1 s8 matrix NTT, lead (mxu_ntt)", "K1 lead 256x65536 pair", "ntt_mxu.cu",
              "sventt_tpu/ops/ntt_mxu.py:574", lm["lead"], wm["lead"]),
        entry("K2 s8 matrix NTT, mid (mxu_ntt_mid)", "K2 mid 256x256x256 pair", "ntt_mxu.cu",
              "sventt_tpu/ops/ntt_mxu.py:634", lm["mid"], wm["mid"]),
        entry("K3 s8 matrix NTT, lane (mxu_ntt_lane)", "K3 lane 65536x256", "ntt_mxu.cu",
              "sventt_tpu/ops/ntt_mxu.py:487", lm["lane"], wm["lane"]),
        entry("K4 radix-2 stages, leaf (fused_ntt)", "K4 leaf 256x65536", "ntt_pallas.cu",
              "sventt_tpu/ops/ntt_pallas.py:1136", lp["leaf"], wp["leaf"]),
        entry("K5 radix-2 stages, mid (fused_ntt_mid)", "K5 mid 256x256x256 pair",
              "ntt_pallas.cu", "sventt_tpu/ops/ntt_pallas.py:1167", lp["mid"], wp["mid"]),
        entry("K6 radix-2 stages, lane (fused_ntt_lane)", "K6 lane 65536x256 pair",
              "ntt_pallas.cu", "sventt_tpu/ops/ntt_pallas.py:891", lp["lane"], wp["lane"]),
        entry("K7 radix-2^R groups, leaf (fused_ntt_grouped)", "K7 leaf 256x65536 r=3",
              "ntt_grouped.cu", "sventt_tpu/ops/ntt_pallas.py:679", lp["grouped"],
              wp["grouped"]),
        entry("K8 radix-2^R groups, lane (fused_ntt_lane, grouped)",
              "K8 lane 65536x256 r=3 pair", "ntt_grouped.cu",
              "sventt_tpu/ops/ntt_pallas.py:1107", lp["lane_grouped"], wp["lane_grouped"]),
        entry("K9a blocked transpose, one plane (transpose_pallas)",
              "K9a transpose_pallas 65536x256 int32", "transpose.cu",
              "sventt_tpu/ops/transpose.py:39", lt["plane"], wt["plane"]),
        entry("K9b blocked transpose, u64 (transpose_u64 / transpose01_u64)",
              "K9b transpose_u64 65536x256 int64", "transpose.cu",
              "sventt_tpu/ops/transpose.py:69", lt["pair"], wt["pair"]),
        entry("inter-step multiply of the transpose fallback (an XLA pass there, "
              "not a Pallas kernel)", "inter-step 256x256x256 pair", "inter_step.cu",
              "sventt_tpu/plan/planner.py:376", c_grp["launches"]["inter_step"]["inter_step"],
              worst["inter_step"]),
        entry("K10 ring all-to-all of slabs (ring_all_to_all / canonical_all_to_all)",
              "K10 ring 2^24 D=8 8x(512x4096) split 1", "ring.cu",
              "sventt_tpu/parallel/ring.py:104", k10_launches, worst["ring"]),
    ]}
    for scheme in ("u7", "s8b"):
        ls, ws = c_schemes[scheme]["launches"]["mxu"], worst[f"mxu {scheme}"]
        for k, orient, fn, key, line in (
            ("K1", "lead", "mxu_ntt", "K1 lead 256x65536 pair", 680),
            ("K2", "mid", "mxu_ntt_mid", "K2 mid 256x256x256 pair", 680),
            ("K3", "lane", "mxu_ntt_lane", "K3 lane 65536x256", 527),
        ):
            record["kernels"].append(entry(
                f"{k} {scheme} matrix NTT, {orient} ({fn}, make_mxu_tables(scheme={scheme!r}))",
                f"{key} {scheme}", "ntt_mxu.cu", f"sventt_tpu/ops/ntt_mxu.py:{line}",
                ls[orient], ws[orient]))
    record["kernels"].append(entry(
        "K11 fused u7 prototype, 128 points (mxu_fused_ntt; the u7 lead instantiation)",
        "K11 fused 128x32768", "ntt_mxu.cu", "experimental/mxu_fused_kernel.py:91",
        c_schemes["fused"]["launches"]["fused"]["fused"], worst["fused"]))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

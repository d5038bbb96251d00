#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the CUDA kernels and the native golden oracle, from this checkout,
   with each kernel's -Xptxas -v lines; fails if an instantiation of one
   of the three redesigned kernels (the tensor-core matrix kernel
   csrc/mxu_tc.cuh, its 24 s8 instantiations in csrc/ntt_mxu_tc.cu and
   its 44 u7 ones in csrc/ntt_mxu_tc_u7.cu, the grouped and the radix-2
   register kernels csrc/ntt_grouped.cu, csrc/ntt_radix2.cu) spills;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   same card tensors, bitwise, at the main paths' shapes --
   the s8 matrix NTT (K1 lead, K2 mid and K3 lane on the int8 tensor
   cores; each case checks which kernel launched) with every twiddle mode
   (K3's fused in the data's layout: pair, w, Solinas on the flagship and
   Goldilocks), both directions, both moduli, a ragged batch and the m =
   1024 crafted plane-minimizer input (lead and lane), and for the
   tensor-core kernel m = 2, 8, 32, 64, 512 and 1024, batches that are not
   a multiple of its block, the 2^17 plan's launches with their row split
   (K3 at the 2^17, 2^24 and 2^26 roots) and a mid call with A = 70000 >
   65535 slices; each K3 case also on the __dp4a A/B point and, with the
   pair inverse (the staged epilogue), on the fragment-store one; the
   radix-2 butterfly kernels (K4 leaf, K5 mid and K6 lane on the register
   kernel, csrc/ntt_radix2.cu, each case also
   on the first port's stage-by-stage kernel, the A/B point
   ``_launch_stages``) with every twiddle mode, both directions, the
   flagship and the lazy test modulus under Montgomery and Shoup, a ragged
   batch, m = 2 ... 4096, the 2^17, 2^24 and 2^26 plans' launches, spc /
   block_b / lane_rows tiles, a strided (A, m, B) view and A = 70000
   slices;
   the same matrix cases under the u7 and s8b plane schemes (on the
   tensor cores; u7 to m = 1024, s8b to 512), with K1's 2^24 shape and,
   for u7, the m = 1024 all-ones input (against the golden model too),
   each u7 case also on the __dp4a A/B point; K11 (the fused u7
   prototype, the u7 lead form) at (128, 32768) and (128, 300), also on
   the __dp4a A/B point, with columns 0 and 7777 against the golden
   model;
   the grouped kernel (K7 leaf, K8 lane) at max_r 2, 3 and 4 the same way,
   m = 2 and m = 8 included; the blocked transpose (K9a/K9b) at the 2^24
   root-row shapes with three block shapes, int64 and int32; the
   inter-step multiply kernel of the transpose fallback; every Solinas
   branch (``modmul="solinas"``) -- K1/K2's fused twiddle, K4's stages,
   K5's stages and twiddle, K6's stages and prologue / epilogue (K4-K6
   also on the A/B point), and the
   inter-step pass -- on the flagship and the Goldilocks modulus, with
   JAX's corner values of the fold (0, 1, N - 1, N, 2^63, 2^64 - 1)
   against the twiddle N - 1 and random ones; the multi-modular (RNS)
   path at the benchmark's ``rns32-2p17`` size (``rns_cases``: 32 limbs
   of 64-bit primes at 2^17, forward, inverse and product against the
   plain composition of the stacked tables and against each limb's
   single-modulus NTT, one launch a level carrying 32 limbs (``LIMBS``),
   a batched mid shape and two lazy limbs against the plain versions, and
   the limb-axis launches' graph replays beside one limb's and 32 limbs'
   single-modulus launches);
4. paths: the matrix engine (``engine="mxu"``), the butterfly engine
   (``engine="pallas"``) and the grouped butterfly engine
   (``engine="pallas", max_r=3``) at n = 2^17, 2^24 and 2^26 on the
   flagship modulus, plus each butterfly engine on the lazy test modulus at
   2^24 (``modmul="auto"`` resolves to Shoup there), forward and inverse,
   elementwise against the native oracle (computed once per modulus and
   length), with an exact roundtrip; the default route (``engine="auto"``):
   a single-modulus forward at 2^17 and 2^24 on the butterfly engine, 2 and
   3 launches of the radix-2 register kernel and none of the matrix
   kernel, and a two-limb RNS forward at 2^17 on the tensor cores, 2
   launches, each against the native oracle; the mxu paths must run every root on
   K3 (``mxu_ntt_lane``) and no transpose (the planner's ``transpose01``
   is counted); then K3 with the fused twiddle on the 2^24 root shape
   against JAX's root step on the card (a transpose, K1 with the transposed
   table, a transpose back), and ``transpose01_u64(x, "pallas")`` /
   ``transpose_pallas`` on the 2^24 root-row shapes against the torch
   copy; the u7 and s8b schemes through ``mxu_ntt`` / ``mxu_ntt_mid`` /
   ``mxu_ntt_lane`` and K11 through ``mxu_fused_ntt``, against the golden
   model, an exact roundtrip and s8, every launch on the tensor cores and
   none on __dp4a; the Solinas engine
   (``modmul="solinas"``) on both engines at 2^17, 2^24 and 2^26, with
   ``max_r=3`` at 2^24 (radix-2, as in JAX: K7/K8 launch 0 times) and a
   ``strategy="six_step"`` 2^24 plan whose row subtree runs the
   inter-step pass.  Each path runs with the launch counts
   set to 0 just before and read just after: every kernel of the path must
   have launched, and no plain version may have run; on the matrix paths
   every lead / mid / lane launch must have run the tensor-core kernel and
   none the __dp4a one (``ntt_mxu.KERNEL_LAUNCHES``); on the radix-2 butterfly
   paths (flagship, TEST, Solinas, distributed) every leaf / mid / lane
   launch the register kernel and none the stage-by-stage one
   (``ntt_pallas.KERNEL_LAUNCHES``);
   Then the distributed six-step (``parallel.DistributedNTT``) on logical
   shards of the card (a mesh naming it 4 or 8 times): the ring all-to-all
   K10 against its plain version first (D = 1, 2, 3, 4, 8, both
   orientations, the 2^24 and 2^26 splits' exchanges, a ragged canonical
   case), then each distributed path forward and inverse against the same
   oracle with an exact roundtrip -- comm "xla", "ring" and "overlap" at
   2^24, the default, matrix and grouped engines, the lazy test modulus, 2^26, the
   (2, 4) ("dcn", "ici") mesh, the Solinas engine -- and 2^28 runs
   (comm "ring" and "overlap") against the single-device six-step
   transform on the card, with the card's allocation read around each
   step and held to the port's memory budget; each distributed path's
   CUDA tables hold exactly the bytes the budget counts (``leaf_tables``,
   the tensor-core tile copy of the mxu digit planes included).  Where the
   machine has two or more cards, the 2^24 ring path over distinct cards.
   Then the applications and the portable engine: ``magic_series_count``
   at m = 100 and 101 mod TEST_MODULUS (native generators, a 2^20-point
   convolution on the default engine, K4 / K5 / K6) and M(100) through the
   chunked path (2^16 blocks on one 2^17-point NTT), against the exact
   counts mod N, every launch on the radix-2 register kernel and no plain
   call; the Kinnaes closed form
   on the card at m = 100 and 101 at 64 and 62 bits, against the same
   counts; ``engine="jnp"`` at 2^17 and 2^24 and two 2^24 ``plan_spec``
   trees with jnp rows (over K1 / K2 with a K3 root, over K4 / K5 with a
   K6 root) against the oracle, with an exact roundtrip; the jnp
   ``DistributedNTT`` at 2^24, 4 logical shards, comm "ring" (K10);
   ``forward_step`` / ``inverse_step`` of the flagship 2^17 mxu plan
   captured in a CUDA graph and replayed bitwise against the compute
   calls, and ``DistributedNTT``'s step helpers against its compute
   calls; with the seconds of each item and the replay, eager and jnp
   times.
   Then the autotuner: the full race (``plan.autotune.tune``: jnp, pallas
   and mxu, modmul, each engine's knobs, the playoff, the winner checked
   elementwise against the untuned config) of the flagship transform at
   2^17 and 2^24 into a temporary cache, failing if any candidate failed;
   a second ``tune`` must hit the cache without searching; the winner
   timed beside the untuned config (``engine="auto"``) in turns by the same timer (CUDA-
   graph replays), with each race's seconds and peak allocation; and
   ``NTT(tune=True)`` at 2^24 from the shipped cache against the oracle.
   ``donate_input``: the default and the mxu forward at 2^26 (against the
   oracle) and 2^28 (donated bitwise against kept) with and without it, the peak
   allocation of each (the saving must be one n-word buffer within 5%).
   ``phase_breakdown`` of the 2^24 mxu and pallas plans, and ``trace``
   writing its Chrome trace.  The partial collective axis: the (2, 4)
   ("dcn", "ici") logical mesh with ``axis="ici"`` at 2^24, comm "xla" and
   "overlap", every replica group's output against the oracle;
5. times: CUDA-event medians of the transforms and of each kernel alone
   beside its plain version (and, for the transpose, the PyTorch call
   ``.t().contiguous()``; for K10 the torch-copy all-to-all), and the
   least time the card could take -- K1 / K2 (pair, w, Solinas, and the
   2^17 plan's launches) on the tensor cores timed in turns with the
   __dp4a kernel at the same call (``ntt_mxu._launch_dp4a_s8``: dp4a, tc,
   tc, dp4a), with the speedup and the achieved int8 TOP/s, and K3 the
   same way as CUDA-graph replays, both directions with the pair twiddle;
   the mxu root step as JAX's sandwich (transpose, K1, transpose) against
   K3 with the twiddle fused at the 2^24 and 2^17 roots, and K3's staged
   epilogue against the stores from the fragment (the pair inverse at the
   2^24, 2^17 and 2^26 roots), each as CUDA-graph replays in turns;
   K7 / K8 on the
   grouped register kernel in turns with the rank-by-rank one
   (``ntt_pallas._launch_grouped_ranks``: ranks, registers, registers,
   ranks) at the 2^24 shapes (max_r 3 both directions, max_r 2 and 4 at
   the leaf) and the 2^17 ones, as CUDA-graph replays (device time), with
   the bound and the share of it; K4 / K5 / K6 on the radix-2 register
   kernel in turns with the stage-by-stage one (stages, registers,
   registers, stages) as CUDA-graph replays at the 2^24 shapes (both
   directions, Montgomery, Shoup on the test modulus, Solinas), the 2^17
   ones and the 2^26 ones, with the bound, the share of it and the
   Montgomery product floor; each Solinas kernel beside its
   Montgomery form at the same shape; the u7 kernels at K1/K2/K3's 2^24
   shapes and K11 at (128, 32768) as CUDA-graph replays in turns with the
   __dp4a kernel, with the share of u7's own bound and of s8's; the u7
   block's two builds (16 and 32 columns) in turns at m = 256 and 128;
   s8b at the same shapes beside s8's; and the round-5 A/B level
   (mid (64, 256, 256), each scheme bare, with the pair twiddle fused, and
   with it as a separate pass); the distributed 2^24 forward at D = 4
   and 8 per comm mode, as logical shards of one card;
6. breakdown: the matrix, radix-2 and grouped butterfly engines' 2^24
   forward transforms and the radix-2 and grouped 2^17 ones, the
   distributed 2^24 forward (D = 4 and 8 ring, D = 4 overlap): device
   time by kernel (torch.profiler) and the device's busy share --
   informational, no check rests on it.

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

#: The exact counts of magic series of order 100 and 101 (OEIS A052456 at
#: the reference's test scale): reconstructed by CRT from the convolution
#: pipeline over 17 independent 62-bit NTT primes, checked against held-out
#: moduli and the Kinnaes closed form over a (width 64..61 x 2 primes)
#: matrix (``sventt_tpu_torch.examples.magic_series_reference_scale``).
M100 = int(
    "9043007368088944265747933022406939112612349423987481545280521717243052"
    "7904558345986101135781355626074636685064666906216989017828082488599537"
    "5485156399921958991796250954308603011799192842071430359668946052264146"
    "938445899732873114858199920"
)
M101 = int(
    "6517428685211505994232177388427365631933896727256173046091895410609480"
    "7534843021101708794185168653839829071357636233748162115685478414828310"
    "4866179994202618028615736621185423913319338987817995082551755913561634"
    "157004344784632798600635226832"
)

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
#: The Montgomery product's measured rate on the H100 (products a second,
#: low and high of two runs; tools/grouped_ablation.py): the butterfly
#: kernels' product floor, printed beside their byte bound.
MONT_RATE = (0.692e12, 0.721e12)


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
    returns the largest mismatch per orientation.  Every scheme runs on
    the tensor cores: m from one padded 32-step to 1024 (s8b to 512, as in
    JAX), ragged batches, the 2^17 / 2^24 / 2^26 launches.  s8 adds the
    m = 1024 crafted plane-minimizer input, u7 the m = 1024 all-ones input
    (lead and lane, against the golden model too); u7 and s8b add K1's
    2^24 shape (K2's and K3's are in every scheme's list).  K3 takes the
    fused twiddle in every mode (pair, w, Solinas on the flagship and
    Goldilocks, the lazy inverse).  After the counts are read, every K3
    case (and every u7 case) is also held on the __dp4a A/B point and each
    call that runs the staged epilogue on the fragment-store one."""
    import numpy as np

    from sventt_tpu_torch.field.golden import GoldenNTT
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
    from sventt_tpu_torch.field.modulus import GOLDILOCKS_MODULUS, Modulus
    from sventt_tpu_torch.ops import ntt_mxu

    flag, test = moduli()
    gold = Modulus(GOLDILOCKS_MODULUS, 7)
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
        # K3: the lane orientation, the root step of every mxu plan with the
        # level's twiddle in its (m0, m1) layout
        ("K3 lane 65536x256 none fwd", flag, False, "lane", (65536, 256), None),
        ("K3 lane 65536x256 none inv", flag, True, "lane", (65536, 256), None),
        ("K3 lane 65536x256 pair fwd (2^24 root)", flag, False, "lane", (65536, 256), "pair"),
        ("K3 lane 65536x256 pair inv (2^24 root)", flag, True, "lane", (65536, 256), "pair"),
        ("K3 lane 65536x256 w fwd", flag, False, "lane", (65536, 256), "w"),
        ("K3 lane 65536x256 w inv", flag, True, "lane", (65536, 256), "w"),
        ("K3 lane 65536x256 solinas fwd", flag, False, "lane", (65536, 256), "solinas"),
        ("K3 lane 65536x256 solinas inv", flag, True, "lane", (65536, 256), "solinas"),
        ("K3 lane 300x64 none fwd TEST (ragged)", test, False, "lane", (300, 64), None),
        ("K3 lane 300x64 pair fwd TEST (ragged)", test, False, "lane", (300, 64), "pair"),
        ("K3 lane 300x64 pair inv TEST (lazy, ragged)", test, True, "lane", (300, 64), "pair"),
        ("K3 lane 300x64 w inv TEST (lazy, ragged)", test, True, "lane", (300, 64), "w"),
        ("K3 lane 300x64 solinas fwd Goldilocks (ragged)", gold, False, "lane", (300, 64),
         "solinas"),
        ("K3 lane 300x64 solinas inv Goldilocks (ragged)", gold, True, "lane", (300, 64),
         "solinas"),
        # off the main path: the m < 4 digit loads and a tiny ragged grid
        ("K1 lead 2x5 none fwd", flag, False, "lead", (2, 5), None),
        ("K2 mid 3x8x7 pair inv TEST (lazy)", test, True, "mid", (3, 8, 7), "pair"),
    ]
    if scheme != "s8":
        cases.append(("K1 lead 256x65536 pair fwd", flag, False, "lead", (256, 65536), "pair"))
    # the tensor-core kernel's geometry (ntt_mxu.tc_geometry): m from
    # one padded 32-step to m = 1024, batches that are not a multiple of
    # its 32 (16) columns, the 2^17 plan's launches with their row
    # split, A above the grid's 65535 slices
    cases += [
        ("K1 lead 2x100 pair fwd", flag, False, "lead", (2, 100), "pair"),
        ("K2 mid 5x8x77 w fwd TEST", test, False, "mid", (5, 8, 77), "w"),
        ("K1 lead 32x333 pair inv TEST (lazy)", test, True, "lead", (32, 333), "pair"),
        ("K2 mid 9x64x100 pair fwd", flag, False, "mid", (9, 64, 100), "pair"),
        ("K1 lead 256x512 w inv (2^17 shape, row split)", flag, True, "lead", (256, 512), "w"),
        ("K1 lead 512x256 pair inv (2^17 shape, row split)", flag, True, "lead", (512, 256),
         "pair"),
        ("K2 mid 70000x2x8 pair inv TEST (lazy, A > 65535)", test, True, "mid", (70000, 2, 8),
         "pair"),
        # K3: m from one padded 32-step to 1024, ragged rows, the
        # 2^17 root (256 rows of 512: the row split) and the 2^26 root
        # (131072 rows of 512, its table companion-free)
        ("K3 lane 37x2 pair fwd", flag, False, "lane", (37, 2), "pair"),
        ("K3 lane 5x2 w inv TEST (lazy)", test, True, "lane", (5, 2), "w"),
        ("K3 lane 300x8 w inv TEST (lazy)", test, True, "lane", (300, 8), "w"),
        ("K3 lane 100x32 pair inv", flag, True, "lane", (100, 32), "pair"),
        ("K3 lane 77x64 solinas inv", flag, True, "lane", (77, 64), "solinas"),
        ("K3 lane 256x512 pair fwd (2^17 root, row split)", flag, False, "lane", (256, 512),
         "pair"),
        ("K3 lane 256x512 pair inv (2^17 root, row split)", flag, True, "lane", (256, 512),
         "pair"),
        ("K3 lane 300x512 none fwd TEST (ragged)", test, False, "lane", (300, 512), None),
    ]
    if scheme != "s8b":  # s8b stops at m = 512, as in JAX
        cases += [
            ("K1 lead 1024x1000 w inv (ragged)", flag, True, "lead", (1024, 1000), "w"),
            ("K2 mid 3x1024x40 pair fwd TEST", test, False, "mid", (3, 1024, 40), "pair"),
            ("K3 lane 130x1024 w inv (ragged)", flag, True, "lane", (130, 1024), "w"),
            ("K3 lane 131072x512 w fwd (2^26 root)", flag, False, "lane", (131072, 512), "w"),
            ("K3 lane 131072x512 w inv (2^26 root)", flag, True, "lane", (131072, 512), "w"),
        ]
    worst = {"lead": 0, "mid": 0, "lane": 0}
    calls = {"lead": ntt_mxu.mxu_ntt, "mid": ntt_mxu.mxu_ntt_mid, "lane": ntt_mxu.mxu_ntt_lane}
    tag = "" if scheme == "s8" else f"{scheme} "
    for name, mod, inverse, orient, shape, mode in cases:
        fc = FieldConsts.from_modulus(mod, modmul="solinas" if mode == "solinas" else "montgomery")
        m = {"lead": shape[0], "mid": shape[1], "lane": shape[-1]}[orient]
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, scheme=scheme, device=device)
        x = rand_u64(rng, shape, device)
        tw = None
        if mode is not None:
            tw_shape = (shape[0], m) if orient == "mid" else shape
            tw = rand_twiddle(rng, tw_shape, mod, "w" if mode == "solinas" else mode, device)
        ntt_mxu.reset_counts()
        got = calls[orient](x, t, fc, tw)
        want = ntt_mxu.mxu_plain(x, t, fc, tw, mid=orient == "mid", lane=orient == "lane")
        sync(device)
        route = ntt_mxu.kernel_for(scheme, orient)
        check(ntt_mxu.KERNEL_LAUNCHES[route] == 1 and sum(ntt_mxu.KERNEL_LAUNCHES.values()) == 1,
              f"{tag}{name}: launched {ntt_mxu.KERNEL_LAUNCHES}, not the {route} kernel alone")
        err = mismatch(got, want)
        ab = ""
        if orient == "lane" or scheme == "u7":
            # the A/B points at the same call: __dp4a, and where the call
            # runs the staged epilogue (the lane inverse with the pair
            # twiddle) the stores from the fragment
            others = {"dp4a": lambda: ntt_mxu._launch_dp4a(
                x, t, fc, tw, mid=orient == "mid", lane=orient == "lane")}
            if orient == "lane" and ntt_mxu.tc_form(orient, inverse, tw, scheme) == "lane_staged":
                others["fragment"] = lambda: ntt_mxu._launch_lane_form(x, t, fc, "lane", tw)
            errs = {k: mismatch(f(), want) for k, f in others.items()}
            ab = "; A/B points " + ", ".join(f"{k} {v}" for k, v in errs.items())
            err = max([err, *errs.values()])
        worst[orient] = max(worst[orient], err)
        log(f"  {tag}{name}: max_abs_err {err} (lazy={fc.lazy}; {route}{ab})")
        check(err <= TOL, f"{tag}{name}: kernel != plain")
        del x, got, want, tw
    fc = FieldConsts.from_modulus(flag)
    if scheme == "s8":
        # m = 1024: the crafted input, kernel vs plain vs the golden model
        t = ntt_mxu.make_mxu_tables(flag, 1024, inverse=False, device=device)
        xc = crafted_1024(flag, t)
        what = "crafted plane minimizer"
    elif scheme == "u7":
        # m = 1024, 2^64 - 1 in every point: the 7-bit data planes 0-8 at
        # 127 (plane 9 at 1), so the 19 unsigned product planes at the
        # largest sums the tables allow (each < 2^27.4), the partial sums
        # on the tensor cores with them
        t = ntt_mxu.make_mxu_tables(flag, 1024, inverse=False, scheme="u7", device=device)
        xc = np.full(1024, (1 << 64) - 1, dtype=np.uint64)
        what = "all-ones 2^64-1"
    else:
        return worst
    x = from_numpy(np.repeat(xc.reshape(1024, 1), 8, axis=1), device)
    golden = GoldenNTT(1024, flag).forward([int(v) % flag.modulus for v in xc])
    for orient in ("lead", "lane"):  # K3: the same input as rows
        xo = x.t().contiguous() if orient == "lane" else x
        ntt_mxu.reset_counts()
        if orient == "lane":
            got, want = ntt_mxu.mxu_ntt_lane(xo, t, fc), ntt_mxu.mxu_plain(xo, t, fc, lane=True)
        else:
            got, want = ntt_mxu.mxu_ntt(xo, t, fc), ntt_mxu.mxu_plain(xo, t, fc)
        sync(device)
        route = ntt_mxu.kernel_for(scheme, orient)
        check(ntt_mxu.KERNEL_LAUNCHES[route] == 1, f"{tag}m=1024 {what} {orient}: not on {route}")
        err = mismatch(got, want)
        if scheme == "u7":  # the __dp4a A/B point on the same input
            err = max(err, mismatch(ntt_mxu._launch_dp4a(xo, t, fc, lane=orient == "lane"), want))
        worst[orient] = max(worst[orient], err)
        check(err <= TOL, f"{tag}m=1024 {what} {orient}: kernel != plain")
        got_h = to_numpy(got if orient == "lead" else got.t())
        check(all([int(v) for v in got_h[:, c]] == golden for c in range(8)),
              f"{tag}m=1024 {what} {orient}: != golden")
        shape = "1024x8" if orient == "lead" else "8x1024"
        log(f"  {tag}{'K1' if orient == 'lead' else 'K3'} {orient} {shape} {what}: max_abs_err "
            f"{err}, == golden (x mod N)")
    return worst


def fused_cases(device, rng):
    """K11 at its own shape, (128, 32768), and at a ragged (128, 300), vs
    its plain version, on the tensor cores and on the __dp4a A/B point;
    columns 0 and 7777 vs the golden model (as the JAX prototype checks
    them); returns the largest mismatch."""
    from sventt_tpu_torch.experimental import mxu_fused_kernel as fused
    from sventt_tpu_torch.field.golden import GoldenNTT
    from sventt_tpu_torch.field.limb import FieldConsts, to_numpy
    from sventt_tpu_torch.ops import ntt_mxu

    flag, _ = moduli()
    fc = FieldConsts.from_modulus(flag, lazy=False)
    stack = fused.make_fused_stack(flag, device=device)
    worst = 0
    for cols in (300, 1 << 15):
        x = rand_u64(rng, (128, cols), device, below=flag.modulus)
        ntt_mxu.reset_counts()
        got = fused.mxu_fused_ntt(x, stack, flag)
        route = dict(ntt_mxu.KERNEL_LAUNCHES)
        want = fused.mxu_fused_plain(x, stack, flag)
        err_ab = mismatch(ntt_mxu._launch_dp4a(x, fused._direction(stack, flag), fc), want)
        sync(device)
        err = mismatch(got, want)
        log(f"  K11 fused u7 128x{cols}: max_abs_err {err} ({route}); A/B point dp4a {err_ab}")
        check(route == {"tensor_core": 1, "dp4a": 0}, f"K11: launched {route}, not the tensor cores")
        check(max(err, err_ab) <= TOL, "K11: kernel != plain")
        worst = max(worst, err, err_ab)
    golden = GoldenNTT(128, flag)
    xh, gh = to_numpy(x), to_numpy(got)
    for col in (0, 7777):
        ok = [int(v) for v in gh[:, col]] == golden.forward([int(v) for v in xh[:, col]])
        log(f"  K11 golden col {col}: {ok}")
        check(ok, f"K11 column {col} != golden")
    return worst


def radix2_ab_point(x, t, fc, tw, orient: str, want) -> int:
    """K4 / K5 / K6's A/B point, the stage-by-stage kernel
    (``ntt_pallas._launch_stages``), against the plain version's ``want``:
    its mismatch; it launches once per stage range (the lane once) and
    nothing else."""
    from sventt_tpu_torch.ops import ntt_pallas as P

    before = dict(P.KERNEL_LAUNCHES)
    old = P._launch_stages(x, t, fc, tw, mid=orient != "leaf")
    sync(x.device)
    n = len(t.stage_ls)
    ranges = 1 if orient == "lane" else -(-n // (t.spc or n))
    check(P.KERNEL_LAUNCHES["radix2_stages"] == before["radix2_stages"] + ranges
          and P.KERNEL_LAUNCHES["radix2_registers"] == before["radix2_registers"],
          "the A/B point launched another kernel")
    return mismatch(old, want)


def pallas_kernel_cases(device, rng):
    """K4 / K5 / K6 (the register kernel, and the stage-by-stage A/B
    point) vs plain at the main path's shapes and the edge cases; each call
    must launch the register kernel once per stage range (K6 once).
    Returns the largest mismatch per orientation."""
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
        # the lane's geometry: the 2^17 and 2^26 roots (4-row and 32-row
        # tiles), one group (m <= 16: every point straight from device
        # memory), 4 + 1 (m = 32), three groups (m = 2048) and m = 4096 (one
        # row a tile), one row a tile by lane_rows
        ("K6 lane 2048x64 pair fwd (2^17)", flag, "montgomery", False, "lane", (2048, 64), "pair", {}),
        ("K6 lane 2048x64 pair inv (2^17)", flag, "montgomery", True, "lane", (2048, 64), "pair", {}),
        ("K6 lane 65536x128 pair fwd (2^26 tile)", flag, "montgomery", False, "lane", (65536, 128),
         "pair", {}),
        ("K6 lane 65536x128 pair inv (2^26 tile)", flag, "montgomery", True, "lane", (65536, 128),
         "pair", {}),
        ("K6 lane 333x16 pair fwd TEST", test, "montgomery", False, "lane", (333, 16), "pair", {}),
        ("K6 lane 77x8 w inv TEST shoup", test, "shoup", True, "lane", (77, 8), "w", {}),
        ("K6 lane 1000x32 pair inv", flag, "montgomery", True, "lane", (1000, 32), "pair", {}),
        ("K6 lane 1000x32 w fwd TEST shoup", test, "shoup", False, "lane", (1000, 32), "w", {}),
        ("K6 lane 50x2048 w inv", flag, "montgomery", True, "lane", (50, 2048), "w", {}),
        ("K6 lane 50x2048 pair fwd TEST mont", test, "montgomery", False, "lane", (50, 2048), "pair",
         {}),
        ("K6 lane 100x4096 pair fwd", flag, "montgomery", False, "lane", (100, 4096), "pair", {}),
        ("K6 lane 100x4096 pair inv TEST shoup", test, "shoup", True, "lane", (100, 4096), "pair", {}),
        ("K6 lane 99x256 none inv rows=1", flag, "montgomery", True, "lane", (99, 256), None,
         dict(rows=1)),
        # an inverse lane_rows tile whose twiddle does not fit beside it: read unstaged
        ("K6 lane 1000x256 pair inv rows=64", flag, "montgomery", True, "lane", (1000, 256), "pair",
         dict(rows=64)),
        # the register kernel's geometry: the fused twiddle in a split mid
        # (prologue in the first range, epilogue in the last), the 2^17
        # plan's small grids, a 2^26 plan's launches, m = 4096 (12 stages,
        # one column a tile), a tile wider than a block, A > 65535 slices
        ("K5 mid 5x256x100 pair fwd spc=3", flag, "montgomery", False, "mid", (5, 256, 100), "pair",
         dict(spc=3)),
        ("K5 mid 5x256x100 w inv spc=3 TEST shoup", test, "shoup", True, "mid", (5, 256, 100), "w",
         dict(spc=3)),
        ("K5 mid 32x64x64 pair fwd (2^17)", flag, "montgomery", False, "mid", (32, 64, 64), "pair", {}),
        ("K5 mid 32x64x64 pair inv (2^17)", flag, "montgomery", True, "mid", (32, 64, 64), "pair", {}),
        ("K4 leaf 64x65536 inv", flag, "montgomery", True, "leaf", (64, 65536), None, {}),
        ("K5 mid 4096x128x128 pair fwd (2^26)", flag, "montgomery", False, "mid", (4096, 128, 128),
         "pair", {}),
        ("K5 mid 4096x128x128 pair inv (2^26)", flag, "montgomery", True, "mid", (4096, 128, 128),
         "pair", {}),
        ("K4 leaf 4096x100 fwd", flag, "montgomery", False, "leaf", (4096, 100), None, {}),
        ("K4 leaf 4096x100 inv TEST mont", test, "montgomery", True, "leaf", (4096, 100), None, {}),
        ("K4 leaf 32x3000 inv TEST shoup block_b=512", test, "shoup", True, "leaf", (32, 3000), None,
         dict(block_b=512)),
        ("K5 mid 70000x2x8 pair inv TEST (A > 65535)", test, "montgomery", True, "mid", (70000, 2, 8),
         "pair", {}),
    ]
    worst = {"leaf": 0, "mid": 0, "lane": 0}
    for name, mod, modmul, inverse, orient, shape, mode, knobs in cases:
        fc = FieldConsts.from_modulus(mod, modmul=modmul)
        m = shape[-1] if orient == "lane" else shape[1] if orient == "mid" else shape[0]
        x = rand_u64(rng, shape, device, below=mod.modulus)
        tw = None
        if mode is not None:
            tw = rand_twiddle(rng, shape[:2] if orient == "mid" else shape, mod, mode, device)
        before = dict(P.KERNEL_LAUNCHES)
        if orient == "lane":
            t = P.make_lane_tables(mod, m, inverse=inverse, modmul=modmul, device=device, **knobs)
            got, want = P.fused_ntt_lane(x, t, fc, tw), P.lane_plain(x, t, fc, tw)
            launches = 1
        else:
            t = P.make_leaf_tables(mod, m, inverse=inverse, modmul=modmul, device=device, **knobs)
            if orient == "mid":
                got, want = P.fused_ntt_mid(x, t, fc, tw), P.mid_plain(x, t, fc, tw)
            else:
                got, want = P.fused_ntt(x, t, fc), P.leaf_plain(x, t, fc)
            launches = -(-len(t.stage_ls) // (t.spc or len(t.stage_ls)))
        sync(device)
        kernel = "radix2_registers"
        check(all(P.KERNEL_LAUNCHES[k] == before[k] + (launches if k == kernel else 0)
                  for k in before), f"{name}: launched {P.KERNEL_LAUNCHES}, not {kernel} alone")
        err = mismatch(got, want)
        err_old = radix2_ab_point(x, t, fc, tw, orient, want)
        worst[orient] = max(worst[orient], err)
        log(f"  {name}: max_abs_err {err} (lazy={fc.lazy}; {kernel}; stage-by-stage {err_old})")
        check(err <= TOL and err_old <= TOL, f"{name}: kernel != plain")
        del x, got, want
    # an (A, m, B) view with the batch axis outermost in memory, strides
    # (m, 1, A m), on the register kernel itself
    fc = FieldConsts.from_modulus(test, modmul="shoup")
    t = P.make_leaf_tables(test, 64, inverse=True, modmul="shoup", device=device)
    x = rand_u64(rng, (33, 5, 64), device, below=test.modulus).permute(1, 2, 0)
    got, want = P._launch_regs(x, t, fc, None, 0, 6), P._stages_plain(x.contiguous(), t, fc, False)
    sync(device)
    err = mismatch(got.contiguous(), want)
    worst["leaf"] = max(worst["leaf"], err)
    log(f"  K4 (A, m, B) 5x64x33 inv TEST shoup, strided: max_abs_err {err}")
    check(err <= TOL, "K4 strided: kernel != plain")
    return worst


def grouped_kernel_cases(device, rng):
    """K7/K8 (the register kernel) vs plain at the grouped plans' shapes
    and the edges of its geometry; each case must launch the register
    kernel and never the rank-by-rank one.  Returns the largest mismatch
    per orientation."""
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import ntt_pallas as P

    flag, test = moduli()
    # (name, modulus, modmul, max_r, inverse, orientation, data shape, twiddle);
    # a leaf shape of three axes is an (A, m, B) call of the kernel itself
    cases = [
        *[(f"K7 leaf 256x65536 r={r} {d}", flag, "montgomery", r, d == "inv", "leaf",
           (256, 65536), None) for r in (2, 3, 4) for d in ("fwd", "inv")],
        ("K8 lane 65536x256 r=3 pair fwd", flag, "montgomery", 3, False, "lane", (65536, 256), "pair"),
        ("K8 lane 65536x256 r=3 pair inv", flag, "montgomery", 3, True, "lane", (65536, 256), "pair"),
        # every max_r at m = 256 and 512, both directions and orientations
        *[(f"K7 leaf 512x4096 r={r} {d}", flag, "montgomery", r, d == "inv", "leaf",
           (512, 4096), None) for r in (2, 3, 4) for d in ("fwd", "inv")],
        *[(f"K8 lane 4096x{m} r={r} pair {d}", flag, "montgomery", r, d == "inv", "lane",
           (4096, m), "pair") for m in (256, 512) for r in (2, 3, 4) for d in ("fwd", "inv")],
        # the 2^17 plan's launches (the geometry's small tiles)
        ("K7 leaf 256x512 r=3 fwd (2^17)", flag, "montgomery", 3, False, "leaf", (256, 512), None),
        ("K7 leaf 256x512 r=3 inv (2^17)", flag, "montgomery", 3, True, "leaf", (256, 512), None),
        ("K8 lane 256x512 r=3 pair fwd (2^17)", flag, "montgomery", 3, False, "lane", (256, 512), "pair"),
        ("K8 lane 256x512 r=3 pair inv (2^17)", flag, "montgomery", 3, True, "lane", (256, 512), "pair"),
        ("K8 lane 4096x128 r=3 w fwd", flag, "montgomery", 3, False, "lane", (4096, 128), "w"),
        ("K8 lane 4096x128 r=3 w inv", flag, "montgomery", 3, True, "lane", (4096, 128), "w"),
        ("K8 lane 4096x256 r=4 none fwd", flag, "montgomery", 4, False, "lane", (4096, 256), None),
        # the lazy test modulus, Montgomery and Shoup stage multiplies
        ("K7 leaf 256x4096 r=3 fwd TEST mont", test, "montgomery", 3, False, "leaf", (256, 4096), None),
        ("K7 leaf 256x4096 r=3 inv TEST mont", test, "montgomery", 3, True, "leaf", (256, 4096), None),
        ("K7 leaf 256x4096 r=3 fwd TEST shoup", test, "shoup", 3, False, "leaf", (256, 4096), None),
        ("K7 leaf 256x4096 r=4 inv TEST shoup", test, "shoup", 4, True, "leaf", (256, 4096), None),
        ("K7 leaf 512x1024 r=2 inv TEST mont", test, "montgomery", 2, True, "leaf", (512, 1024), None),
        ("K8 lane 4096x256 r=3 pair fwd TEST shoup", test, "shoup", 3, False, "lane", (4096, 256), "pair"),
        ("K8 lane 4096x256 r=2 pair inv TEST shoup", test, "shoup", 2, True, "lane", (4096, 256), "pair"),
        ("K8 lane 4096x256 r=3 w fwd TEST mont", test, "montgomery", 3, False, "lane", (4096, 256), "w"),
        ("K8 lane 4096x256 r=4 w inv TEST mont", test, "montgomery", 4, True, "lane", (4096, 256), "w"),
        ("K8 lane 1000x512 r=4 pair inv TEST mont", test, "montgomery", 4, True, "lane", (1000, 512), "pair"),
        # ragged batches (not a multiple of a tile), m = 2, 4, 8 and 4096
        ("K7 leaf 64x300 r=3 inv (ragged)", flag, "montgomery", 3, True, "leaf", (64, 300), None),
        ("K7 leaf 256x1000 r=3 fwd (ragged)", flag, "montgomery", 3, False, "leaf", (256, 1000), None),
        ("K8 lane 1001x256 r=3 pair fwd (ragged)", flag, "montgomery", 3, False, "lane", (1001, 256), "pair"),
        ("K8 lane 300x64 r=3 pair fwd TEST shoup (ragged)", test, "shoup", 3, False, "lane",
         (300, 64), "pair"),
        ("K7 leaf 2x5 r=2 fwd", flag, "montgomery", 2, False, "leaf", (2, 5), None),
        ("K8 lane 5x2 r=2 pair inv TEST", test, "montgomery", 2, True, "lane", (5, 2), "pair"),
        ("K7 leaf 4x33 r=2 inv TEST shoup", test, "shoup", 2, True, "leaf", (4, 33), None),
        ("K8 lane 77x4 r=2 w fwd", flag, "montgomery", 2, False, "lane", (77, 4), "w"),
        ("K7 leaf 8x1000 r=4 inv TEST shoup", test, "shoup", 4, True, "leaf", (8, 1000), None),
        ("K8 lane 1000x8 r=3 w fwd", flag, "montgomery", 3, False, "lane", (1000, 8), "w"),
        ("K7 leaf 4096x100 r=3 fwd", flag, "montgomery", 3, False, "leaf", (4096, 100), None),
        ("K7 leaf 4096x100 r=2 inv TEST mont", test, "montgomery", 2, True, "leaf", (4096, 100), None),
        ("K8 lane 100x4096 r=4 pair fwd", flag, "montgomery", 4, False, "lane", (100, 4096), "pair"),
        ("K8 lane 100x4096 r=3 pair inv", flag, "montgomery", 3, True, "lane", (100, 4096), "pair"),
        # (A, m, B) calls with A > 1: contiguous, strided (the batch axis
        # outermost in memory), and A = 70000 > 65535 slices
        ("K7 (A, m, B) 3x256x100 r=3 fwd", flag, "montgomery", 3, False, "leaf", (3, 256, 100), None),
        ("K7 (A, m, B) 5x64x33 r=4 inv TEST shoup, strided", test, "shoup", 4, True, "leaf",
         (5, 64, 33), "strided"),
        ("K7 (A, m, B) 70000x8x3 r=2 inv", flag, "montgomery", 2, True, "leaf", (70000, 8, 3), None),
    ]
    worst = {"grouped": 0, "lane_grouped": 0}
    for name, mod, modmul, max_r, inverse, orient, shape, mode in cases:
        fc = FieldConsts.from_modulus(mod, modmul=modmul)
        kw = dict(inverse=inverse, modmul=modmul, max_r=max_r, device=device)
        before = dict(P.KERNEL_LAUNCHES)
        if orient == "lane":
            x = rand_u64(rng, shape, device, below=mod.modulus)
            t = P.make_lane_tables(mod, shape[1], **kw)
            tw = None if mode is None else rand_twiddle(rng, shape, mod, mode, device)
            got, want = P.fused_ntt_lane(x, t, fc, tw), P.lane_grouped_plain(x, t, fc, tw)
            key = "lane_grouped"
        elif len(shape) == 3:
            A, m, B = shape
            if mode == "strided":  # (A, m, B) with strides (m, 1, A m)
                x = rand_u64(rng, (B, A, m), device, below=mod.modulus).permute(1, 2, 0)
            else:
                x = rand_u64(rng, shape, device, below=mod.modulus)
            t = P.make_leaf_tables(mod, m, **kw)
            got, want = P._launch_grouped(x, t, fc, None, False), P._groups_plain(x, t, fc, False)
            key = "grouped"
        else:
            x = rand_u64(rng, shape, device, below=mod.modulus)
            t = P.make_leaf_tables(mod, shape[0], **kw)
            got, want = P.fused_ntt(x, t, fc), P.grouped_plain(x, t, fc)
            key = "grouped"
        check(isinstance(t, (P.GroupedDirection, P.GroupedLaneDirection)), f"{name}: not grouped")
        sync(device)
        err = mismatch(got, want)
        worst[key] = max(worst[key], err)
        groups = [spec.R for spec in t.specs]
        A_, B_ = (shape[0], shape[2]) if len(shape) == 3 else (1, x.numel() // t.m)
        tw_words = {"pair": 2, "w": 1}.get(mode, 0) if orient == "lane" else 0
        geo = P.grouped_geometry(t.m, t.specs, B_, orient == "lane", A_, tw_words)
        log(f"  {name}: max_abs_err {err} (groups {groups}, lazy={fc.lazy}; tile {geo.cols} x "
            f"{geo.tpc} threads, {geo.smem} bytes)")
        check(err <= TOL, f"{name}: kernel != plain")
        check(P.KERNEL_LAUNCHES["registers"] == before["registers"] + 1
              and P.KERNEL_LAUNCHES["ranks"] == before["ranks"], f"{name}: not the register kernel")
        del x, got, want
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


def pointwise_cases(device, rng):
    """The pointwise product kernel (``ops/pointwise.py``, ``csrc/pointwise.cu``)
    vs its plain composition, bitwise, for the flagship (canonical), TEST
    (lazy, inputs below 2N) and Goldilocks moduli: 2^24 words, an odd total,
    both operands a view offset by one word (the scalar head), only one so
    (the scalar path), a batch (n, 4); the edge values 0, 1, N - 1 first.
    Then one flagship 2^24 product through ``cyclic_convolve`` against the
    same transforms around the plain step, with one launch.  Returns
    (the largest mismatch, the product's launches)."""
    import numpy as np

    from sventt_tpu_torch.apps.convolve import cyclic_convolve
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy
    from sventt_tpu_torch.field.modulus import GOLDILOCKS_MODULUS, Modulus
    from sventt_tpu_torch.ops import pointwise
    from sventt_tpu_torch.plan import NTT, NttConfig

    flag, test = moduli()
    n24 = 1 << 24
    worst, calls = 0, 0
    pointwise.reset_counts()
    for mod in (flag, test, Modulus(GOLDILOCKS_MODULUS, 7)):
        fc = FieldConsts.from_modulus(mod)
        N, r2 = mod.modulus, mod.montgomery_r2
        top = 2 * N if fc.lazy else N
        edges = [0, 1, N - 1] + ([N, 2 * N - 1] if fc.lazy else [])
        ea = np.array([x for x in edges for _ in edges], dtype=np.uint64)
        eb = np.array([y for _ in edges for y in edges], dtype=np.uint64)
        a = rand_u64(rng, (n24 + 1,), device, below=top)
        b = rand_u64(rng, (n24 + 1,), device, below=top)
        a[: ea.size], b[: eb.size] = from_numpy(ea, device), from_numpy(eb, device)
        for label, x, y in (
            ("2^24", a[:n24], b[:n24]),
            ("2^24 - 3 (odd)", a[: n24 - 3], b[: n24 - 3]),
            ("2^24 both offset one word", a[1:], b[1:]),
            ("2^24 one offset one word", a[1:], b[:n24]),
            ("(2^22, 4)", a[:n24].view(1 << 22, 4), b[:n24].view(1 << 22, 4)),
            ("7 words", a[:7], b[:7]),
        ):
            got = pointwise.mont_product(fc, x, y, r2)
            calls += 1
            want = pointwise.mont_product_plain(fc, x, y, r2)
            sync(device)
            err = mismatch(got, want)
            worst = max(worst, err)
            log(f"  pointwise {label} N={N:#x}{' (lazy)' if fc.lazy else ''}: "
                f"{int((got != want).sum())} words differ")
            check(err <= TOL and got.shape == x.shape, f"pointwise {label} N={N:#x}: kernel != plain")
        del a, b, got, want
    check(pointwise.LAUNCHES["pointwise"] == calls and pointwise.PLAIN_CALLS["pointwise"] == 0,
          f"pointwise: {pointwise.LAUNCHES} launches, {pointwise.PLAIN_CALLS} plain calls "
          f"for {calls} calls")
    ntt = NTT(NttConfig(flag.modulus, flag.generator, n24), device=device)
    x = rand_u64(rng, (n24,), device, below=flag.modulus)
    y = rand_u64(rng, (n24,), device, below=flag.modulus)
    fc = ntt.fc
    want = ntt.compute_inverse(pointwise.mont_product_plain(
        fc, ntt.compute_forward(x), ntt.compute_forward(y), flag.montgomery_r2))
    pointwise.reset_counts()
    got = cyclic_convolve(ntt, x, y)
    sync(device)
    launches = pointwise.LAUNCHES["pointwise"]
    log(f"  cyclic_convolve 2^24 flagship: {launches} pointwise launch, "
        f"{int((got != want).sum())} words differ from the plain step's product")
    check(launches == 1 and mismatch(got, want) == 0, "cyclic_convolve: != the plain step's")
    return worst, launches


def rns_cases(device, rng):
    """Multi-modular (RNS) transforms, one launch a level for every limb:
    the 32 limbs of the benchmark's ``rns32-2p17`` configuration at 2^17
    (K1 leaf and the K3 lane root with the limb axis, and the pointwise
    kernel's), forward, inverse and ``cyclic_convolve`` against the plain
    composition of the same stacked tables on the card and against each
    limb's single-modulus ``NTT``, 0 words differing; the counts (one launch
    a level, ``LIMBS`` 32 a launch); the limb kernels against their plain
    versions at a batched mid shape and with two lazy limbs; then the
    graph-replay times of the limb-axis launches beside one limb's
    single-modulus launch and beside 32 of them, in this call."""
    import os

    import torch

    from sventt_tpu_torch.apps.convolve import cyclic_convolve
    from sventt_tpu_torch.field.modulus import Modulus
    from sventt_tpu_torch.ops import ntt_mxu, pointwise
    from sventt_tpu_torch.plan import NTT, NttConfig

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "bench_port", "configs", "rns32-2p17.json")) as f:
        cell = json.load(f)
    qs, gs, n = tuple(cell["moduli"]), tuple(cell["generators"]), cell["n"]
    L, m0, m1 = len(qs), 256, 512
    t0 = time.perf_counter()
    ntt = NTT(NttConfig(qs, gs, n), device=device)
    sync(device)
    log(f"  {L} limbs at 2^17: NTT(...) in {time.perf_counter() - t0:.3f} s; {ntt.describe()!r}")
    singles = [NTT(NttConfig(q, g, n, engine="mxu"), device=device) for q, g in zip(qs, gs)]
    x = torch.stack([rand_u64(rng, (n,), device, below=q) for q in qs])
    y = torch.stack([rand_u64(rng, (n,), device, below=q) for q in qs])
    x[:, n // 2:] = 0
    y[:, n // 2:] = 0
    fwd, inv = ntt._fwd_tables, ntt._inv_tables
    fc = ntt.fc

    def plain_forward(v):
        mat = ntt_mxu.mxu_plain(v.reshape(L, m0, m1), fwd.leaf[(m0, "mxu")], fc)
        return ntt_mxu.mxu_plain(mat, fwd.leaf[(m1, "mxu")], fc, fwd.split_tw[(m0, m1)],
                                 lane=True).reshape(L, n)

    def plain_inverse(v):
        mat = ntt_mxu.mxu_plain(v.reshape(L, m0, m1), inv.leaf[(m1, "mxu")], fc,
                                inv.split_tw[(m0, m1)], lane=True)
        return ntt_mxu.mxu_plain(mat, inv.leaf[(m0, "mxu")], fc).reshape(L, n)

    def plain_product(a, b):
        fa, fb = plain_forward(a), plain_forward(b)
        return plain_inverse(torch.stack([
            pointwise.mont_product_plain(f, u, w, pow(2, 128, f.modulus))
            for f, u, w in zip(fc.limbs, fa, fb)]))

    reset_counts()
    got_f = ntt.compute_forward(x)
    sync(device)
    c_f = (dict(ntt_mxu.KERNEL_LAUNCHES), dict(ntt_mxu.LIMBS), dict(ntt_mxu.LAUNCHES))
    reset_counts()
    got_p = cyclic_convolve(ntt, x, y)
    sync(device)
    c_p = (dict(ntt_mxu.KERNEL_LAUNCHES), dict(ntt_mxu.LIMBS), dict(pointwise.LAUNCHES),
           dict(pointwise.LIMBS))
    got_i = ntt.compute_inverse(got_f)
    for name, got, plain, single in (
        ("forward", got_f, plain_forward(x), lambda i: singles[i].compute_forward(x[i])),
        ("inverse", ntt.compute_inverse(y), plain_inverse(y),
         lambda i: singles[i].compute_inverse(y[i])),
        ("product", got_p, plain_product(x, y), lambda i: cyclic_convolve(singles[i], x[i], y[i])),
    ):
        per_limb = torch.stack([single(i) for i in range(L)])
        sync(device)
        d_plain, d_single = int((got != plain).sum()), int((got != per_limb).sum())
        log(f"  {L}-limb 2^17 {name}: {d_plain} words differ from the plain composition, "
            f"{d_single} from each limb's single-modulus NTT")
        check(d_plain == 0 and d_single == 0, f"rns {name}: != the plain path / the single limbs")
    check(torch.equal(got_i, x), "rns roundtrip not exact")
    log(f"  forward: launches {c_f[0]}, limbs {c_f[1]}, per orientation {c_f[2]}")
    log(f"  product: mxu launches {c_p[0]}, limbs {c_p[1]}; pointwise launches {c_p[2]}, "
        f"limbs {c_p[3]}")
    check(c_f[0]["tensor_core"] == 2 and c_f[1]["tensor_core"] == 2 * L
          and c_f[2] == {"lead": 1, "mid": 0, "lane": 1},
          "rns forward: not one launch a level carrying every limb")
    check(c_p[0]["tensor_core"] == 6 and c_p[1]["tensor_core"] == 6 * L
          and c_p[2] == {"pointwise": 1} and c_p[3] == {"pointwise": L},
          "rns product: not one launch a level and one pointwise launch for every limb")
    # the limb kernels vs their plain versions: a batched mid shape (K2 with
    # the limb axis), and two lazy limbs (the lane inverse without the
    # staged epilogue)
    lazy = ((0x3A00_0000_0000_0001, 3), (0x3FFF_C000_0000_0001, 11))
    for label, lg, nn, batch in (("4 limbs 2^12 batch 3 (mid)", list(zip(qs[:4], gs[:4])),
                                  1 << 12, (3,)),
                                 ("2 lazy limbs 2^17", list(lazy), 1 << 17, ())):
        cfg = NttConfig(tuple(q for q, _ in lg), tuple(g for _, g in lg), nn)
        card, cpu = NTT(cfg, device=device), NTT(cfg, device="cpu")
        v = torch.stack([rand_u64(rng, (nn,) + batch, device, below=q) for q, _ in lg])
        fv = card.compute_forward(v)
        iv = card.compute_inverse(v)
        d = int((fv.cpu() != cpu.compute_forward(v.cpu())).sum())
        d += int((iv.cpu() != cpu.compute_inverse(v.cpu())).sum())
        log(f"  {label}: {d} words differ from the plain versions ({card.describe(bool(batch))!r})")
        check(d == 0, f"rns {label}: kernel != plain")
    # graph replays: the limb axis beside one limb's launch and 32 of them
    k1, k3f, k3i = fwd.leaf[(m0, "mxu")], fwd.leaf[(m1, "mxu")], inv.leaf[(m1, "mxu")]
    s1 = [s._fwd_tables.leaf[(m0, "mxu")] for s in singles]
    s3f = [s._fwd_tables.leaf[(m1, "mxu")] for s in singles]
    s3i = [s._inv_tables.leaf[(m1, "mxu")] for s in singles]
    twf, twi = fwd.split_tw[(m0, m1)], inv.split_tw[(m0, m1)]
    stwf = [s._fwd_tables.split_tw[(m0, m1)] for s in singles]
    stwi = [s._inv_tables.split_tw[(m0, m1)] for s in singles]
    xs = x.reshape(L, m0, m1)
    fa, fb = ntt.compute_forward(x), ntt.compute_forward(y)
    cases = {
        "K1 leaf (256, 512)": (
            lambda: ntt_mxu.mxu_ntt(xs, k1, fc),
            lambda i: ntt_mxu.mxu_ntt(xs[i], s1[i], singles[i].fc)),
        "K3 lane root fwd (256 x 512)": (
            lambda: ntt_mxu.mxu_ntt_lane(xs, k3f, fc, twf),
            lambda i: ntt_mxu.mxu_ntt_lane(xs[i], s3f[i], singles[i].fc, stwf[i])),
        "K3 lane root inv (256 x 512)": (
            lambda: ntt_mxu.mxu_ntt_lane(xs, k3i, fc, twi),
            lambda i: ntt_mxu.mxu_ntt_lane(xs[i], s3i[i], singles[i].fc, stwi[i])),
        "pointwise 2^17": (
            lambda: pointwise.mont_product(fc, fa, fb, None),
            lambda i: pointwise.mont_product(singles[i].fc, fa[i], fb[i],
                                             singles[i].mod.montgomery_r2)),
        "product 2^17": (
            lambda: cyclic_convolve(ntt, x, y),
            lambda i: cyclic_convolve(singles[i], x[i], y[i])),
    }
    times = {}
    for name, (limbs, one) in cases.items():
        t_l = timed_graph(limbs, 3, 20)
        t_1 = timed_graph(lambda: one(0), 3, 20)
        t_32 = timed_graph(lambda: [one(i) for i in range(L)], 3, 20)
        times[name] = (t_l, t_1, t_32)
        log(f"  [rns A/B] {name}: {L} limbs in one launch {t_l:.4f} ms; one limb's "
            f"single-modulus launch {t_1:.4f} ms; {L} of those {t_32:.4f} ms (graph replays)")
    del ntt, singles, x, y, fa, fb, got_f, got_p, got_i
    return times


def corner_data(shape, mod, rng):
    """u64 data of ``shape`` whose leading rows cycle through JAX's corner
    values of the Solinas fold (0, 1, N - 1, N, 2^63, 2^64 - 1), the rest
    random full-range words, and (A, m) twiddle rows: N - 1 in the even
    rows, random below N in the odd ones (the last fold's carry and the
    min-subtract)."""
    import numpy as np

    N = mod.modulus
    corners = np.array([0, 1, N - 1, N, 1 << 63, (1 << 64) - 1], dtype=np.uint64)
    x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    k = min(flat.size, 6 * 4096)
    flat[:k] = np.resize(corners, k)
    tw = rng.integers(0, N, size=shape[:2], dtype=np.uint64)
    tw[::2] = N - 1
    return x, tw


def solinas_kernel_cases(device, rng):
    """Every kernel branch of the Solinas engine vs its plain version,
    bitwise, on the flagship and the Goldilocks modulus: K1 lead / K2 mid
    with the fused Solinas twiddle, K4 leaf, K5 mid with it, K6 lane with
    its prologue (epilogue on the inverse) -- K4-K6 each also on the
    stage-by-stage A/B point -- at the 2^24 plans' shapes, a
    ragged batch and m = 2, both directions, and the inter-step pass.  The
    forward prologues and the inter-step pass take ``corner_data``, any
    u64 (the Solinas multiply accepts it); the inverse inputs are below N.
    Returns the largest mismatch per kernel."""
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy
    from sventt_tpu_torch.field.modulus import GOLDILOCKS_MODULUS, Modulus
    from sventt_tpu_torch.ops import inter_step, ntt_mxu
    from sventt_tpu_torch.ops import ntt_pallas as P
    from sventt_tpu_torch.ops.twiddle import MontPair, inter_step_mul

    flag, _ = moduli()
    gold = Modulus(GOLDILOCKS_MODULUS, 7)
    worst = {k: 0 for k in ("lead", "mid", "leaf", "pallas mid", "lane", "inter_step")}
    # (kernel, orientation, data shape, on the flagship only); each forward
    # and inverse.  The 2^24 shapes run on the flagship modulus, the small
    # ones, which reach every branch, on both.
    shapes = [
        ("K1", "lead", (256, 1 << 16), True), ("K2", "mid", (256, 256, 256), True),
        ("K4", "leaf", (256, 1 << 16), True), ("K5", "pallas mid", (256, 256, 256), True),
        ("K6", "lane", (1 << 16, 256), True),
        ("K1", "lead", (64, 300), False), ("K2", "mid", (8, 64, 300), False),
        ("K1", "lead", (2, 5), False), ("K2", "mid", (3, 2, 5), False),
        ("K4", "leaf", (64, 300), False),
        ("K5", "pallas mid", (8, 64, 300), False), ("K6", "lane", (300, 64), False),
        ("K4", "leaf", (2, 5), False), ("K5", "pallas mid", (3, 2, 5), False),
        ("K6", "lane", (5, 2), False),
    ]
    for mod, tag in ((flag, "flagship"), (gold, "Goldilocks")):
        fc = FieldConsts.from_modulus(mod, modmul="solinas")
        check(not fc.lazy and fc.n_form == "high", f"{tag}: not a canonical sparse-high engine")
        for name, orient, shape, flag_only in shapes:
            if flag_only and mod is gold:
                continue
            m = shape[-1] if orient == "lane" else shape[1] if "mid" in orient else shape[0]
            for inverse in (False, True):
                # the twiddles in the data's layout, (A, m) rows for mid
                xh, twh = corner_data(shape, mod, rng)
                if inverse or orient == "leaf":  # no prologue: stages take [0, N)
                    xh %= mod.modulus
                x = from_numpy(xh, device)
                tw = None if orient == "leaf" else MontPair(from_numpy(twh, device), None)
                if orient in ("lead", "mid"):
                    t = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, device=device)
                    fn = ntt_mxu.mxu_ntt_mid if orient == "mid" else ntt_mxu.mxu_ntt
                    got = fn(x, t, fc, tw)
                    want = ntt_mxu.mxu_plain(x, t, fc, tw, mid=orient == "mid")
                else:
                    if orient == "lane":
                        t = P.make_lane_tables(mod, m, inverse=inverse, modmul="solinas",
                                               device=device)
                        got, want = P.fused_ntt_lane(x, t, fc, tw), P.lane_plain(x, t, fc, tw)
                    else:
                        t = P.make_leaf_tables(mod, m, inverse=inverse, modmul="solinas",
                                               device=device)
                        if orient == "leaf":
                            got, want = P.fused_ntt(x, t, fc), P.leaf_plain(x, t, fc)
                        else:
                            got, want = P.fused_ntt_mid(x, t, fc, tw), P.mid_plain(x, t, fc, tw)
                    err = radix2_ab_point(x, t, fc, tw, orient, want)
                    check(err <= TOL, f"{name} {orient} {shape} solinas: stage-by-stage != plain")
                if orient not in ("lead", "mid"):
                    check(t.wp is None and (t.scale is None or t.scale[1] is None),
                          f"{name}: Solinas stage tables carry a companion")
                sync(device)
                err = mismatch(got, want)
                worst[orient] = max(worst[orient], err)
                label = (f"{name} {orient} {'x'.join(map(str, shape))} solinas "
                         f"{'inv' if inverse else 'fwd'} {tag}")
                log(f"  {label}: max_abs_err {err}")
                check(err <= TOL, f"{label}: kernel != plain")
                del x, got, want
        for shape in ((256, 256, 256), (1 << 16, 256), (8, 16, 300)):
            xh, twh = corner_data(shape, mod, rng)
            x, w = from_numpy(xh, device), from_numpy(twh, device)
            got = inter_step.mont_mul_bcast(fc, x, MontPair(w, None))
            view = shape[:2] + (1,) * (len(shape) - 2)
            want = inter_step_mul(fc, x, MontPair(w.reshape(view), None))
            sync(device)
            err = mismatch(got, want)
            worst["inter_step"] = max(worst["inter_step"], err)
            log(f"  inter-step {'x'.join(map(str, shape))} solinas {tag}: max_abs_err {err}")
            check(err <= TOL, f"inter-step {shape} solinas {tag}: kernel != plain")
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


#: Calls of the planner's transpose (``plan/planner.py``'s ``transpose01``,
#: a torch copy), counted by ``count_planner_transposes``.
PLANNER_TRANSPOSES = {"transpose01": 0}


def count_planner_transposes() -> None:
    """Count every transpose a plan runs: wrap the planner's
    ``transpose01`` (the transpose fallback's) so that ``counts()`` can
    show that a path, the mxu root's step included, ran none."""
    from sventt_tpu_torch.plan import planner

    inner = planner.transpose01

    def counted(x):
        PLANNER_TRANSPOSES["transpose01"] += 1
        return inner(x)

    planner.transpose01 = counted


def _counted_modules() -> dict:
    from sventt_tpu_torch.experimental import mxu_fused_kernel
    from sventt_tpu_torch.ops import inter_step, ntt_mxu, ntt_pallas, pointwise, transpose
    from sventt_tpu_torch.parallel import ring

    return {"mxu": ntt_mxu, "pallas": ntt_pallas, "inter_step": inter_step,
            "transpose": transpose, "ring": ring, "fused": mxu_fused_kernel,
            "pointwise": pointwise}


def counts():
    from sventt_tpu_torch.ops import ntt_mxu

    mods = _counted_modules()
    return {
        "launches": {k: dict(v.LAUNCHES) for k, v in mods.items()},
        "plain": {k: dict(v.PLAIN_CALLS) for k, v in mods.items()},
        "mxu_kernels": dict(ntt_mxu.KERNEL_LAUNCHES),
        "pallas_kernels": dict(mods["pallas"].KERNEL_LAUNCHES),
        "planner_transposes": PLANNER_TRANSPOSES["transpose01"],
    }


def mxu_on_tensor_cores(c) -> bool:
    """Every s8 lead / mid / lane launch in the counts ``c`` ran the
    tensor-core kernel, and the __dp4a one never ran."""
    lm, k = c["launches"]["mxu"], c["mxu_kernels"]
    return k["tensor_core"] == lm["lead"] + lm["mid"] + lm["lane"] and k["dp4a"] == 0


def radix2_routed(c) -> bool:
    """Every radix-2 leaf / mid / lane launch in the counts ``c`` ran the
    register kernel, and the stage-by-stage one never ran."""
    lp, k = c["launches"]["pallas"], c["pallas_kernels"]
    return (k["radix2_registers"] == lp["leaf"] + lp["mid"] + lp["lane"]
            and k["radix2_stages"] == 0)


def reset_counts() -> None:
    for mod in _counted_modules().values():
        mod.reset_counts()
    PLANNER_TRANSPOSES["transpose01"] = 0


def no_plain(c) -> bool:
    """No plain version ran in the counts ``c``."""
    return all(v == 0 for d in c["plain"].values() for v in d.values())


def slice_run(device, configs, oracles: dict):
    """Each (label, modulus, generator, n, config keywords) against the
    native oracle, whose outputs are cached in ``oracles`` per (modulus, n).
    Returns the NTTs and the launch and plain-call counts of the run."""
    import numpy as np

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
        want_f, want_i = oracle(oracles, N, g, n)
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


def auto_route(device, oracles: dict) -> None:
    """``engine="auto"`` on the card: the flagship forward at 2^17 and 2^24
    runs the butterfly engine, one launch of the radix-2 register kernel a
    plan level (2 and 3) and none of the matrix kernel; a two-limb RNS
    forward at 2^17 (the first two primes of ``rns32-2p17``) runs the
    matrix engine, one tensor-core launch a level for both limbs.  Each
    forward against the native oracle (a limb's against its own)."""
    import os

    import numpy as np
    import torch

    from sventt_tpu_torch import native
    from sventt_tpu_torch.field.limb import from_numpy, to_numpy
    from sventt_tpu_torch.ops import ntt_mxu
    from sventt_tpu_torch.plan import NTT, NttConfig
    from sventt_tpu_torch.utils.fill import host_fill

    flag, _ = moduli()
    F, G = flag.modulus, flag.generator
    for log2n, levels in ((17, 2), (24, 3)):
        n = 1 << log2n
        ntt = NTT(NttConfig(F, G, n), enable_inverse=False, device=device)
        x = host_fill(n, F)
        reset_counts()
        got = ntt.compute_forward(from_numpy(x, device))
        sync(device)
        c = counts()
        bad = int(np.count_nonzero(to_numpy(ntt.normalize(got)) != oracle(oracles, F, G, n)[0]))
        log(f"  flagship 2^{log2n}: engine {ntt.engine}, plan {ntt.describe()!r}; forward "
            f"{bad} elements differ from the oracle; radix-2 kernels {c['pallas_kernels']}, "
            f"matrix kernels {c['mxu_kernels']}")
        check(ntt.engine == "pallas" and bad == 0, f"auto 2^{log2n}: not the butterfly engine, "
              "or a mismatch")
        check(c["pallas_kernels"]["radix2_registers"] == levels and radix2_routed(c)
              and c["mxu_kernels"]["tensor_core"] == 0 and no_plain(c),
              f"auto 2^{log2n}: not {levels} launches of the radix-2 register kernel alone")
        del ntt, got
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "bench_port", "configs", "rns32-2p17.json")) as f:
        cell = json.load(f)
    qs, gs, n = tuple(cell["moduli"][:2]), tuple(cell["generators"][:2]), cell["n"]
    ntt = NTT(NttConfig(qs, gs, n), enable_inverse=False, device=device)
    xs = [host_fill(n, q) for q in qs]
    reset_counts()
    got = ntt.compute_forward(torch.stack([from_numpy(v, device) for v in xs]))
    sync(device)
    c = counts()
    bad = sum(int(np.count_nonzero(to_numpy(got[i]) != native.golden_forward(v, q, g)))
              for i, (v, q, g) in enumerate(zip(xs, qs, gs)))
    log(f"  2 limbs at 2^17: engine {ntt.engine}; forward {bad} elements differ from each "
        f"limb's oracle; matrix kernels {c['mxu_kernels']}, limbs {dict(ntt_mxu.LIMBS)}, "
        f"radix-2 kernels {c['pallas_kernels']}")
    check(ntt.engine == "mxu" and bad == 0, "auto RNS: not the matrix engine, or a mismatch")
    check(c["mxu_kernels"]["tensor_core"] == 2 and mxu_on_tensor_cores(c)
          and c["pallas_kernels"]["radix2_registers"] == 0 and no_plain(c),
          "auto RNS: not 2 tensor-core launches")


def lane_path(device, rng):
    """``mxu_ntt_lane`` with the fused twiddle, the mxu root step: the
    (65536, 256) rows of the 2^24 root, both directions, with a pair table
    in the (m0, m1) layout, must equal the JAX package's root step on the
    card -- a transpose, the lead orientation with the transposed table, a
    transpose back.  Returns the launch and plain-call counts of the two
    K3 calls."""
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import ntt_mxu
    from sventt_tpu_torch.ops.transpose import transpose01
    from sventt_tpu_torch.ops.twiddle import montpair_map

    flag, _ = moduli()
    fc = FieldConsts.from_modulus(flag)
    tables = [ntt_mxu.make_mxu_tables(flag, 256, inverse=inv, device=device) for inv in (False, True)]
    x = rand_u64(rng, (1 << 16, 256), device, below=flag.modulus)
    tw = rand_twiddle(rng, (1 << 16, 256), flag, "pair", device)
    twt = montpair_map(lambda v: v.t().contiguous(), tw)
    reset_counts()
    got = [ntt_mxu.mxu_ntt_lane(x, t, fc, tw) for t in tables]
    c = counts()
    for t, g in zip(tables, got):
        want = transpose01(ntt_mxu.mxu_ntt(transpose01(x), t, fc, twt))
        sync(device)
        err = mismatch(g, want)
        log(f"  inverse={t.inverse}: max_abs_err {err} against transpose + K1 (tw^T) + transpose")
        check(err <= TOL, "mxu_ntt_lane(tw) != transpose + mxu_ntt(tw^T) + transpose")
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
        want_k = {"tensor_core": 3, "dp4a": 0}
        check(c["mxu_kernels"] == want_k, f"{scheme}: kernel launches {c['mxu_kernels']} != {want_k}")
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
        f"launches {c['launches']['fused']}, kernels {c['mxu_kernels']}, plain calls {c['plain']}")
    check(ok, "K11 path: != golden")
    check(c["launches"]["fused"]["fused"] > 0 and no_plain(c), "K11 did not launch, or a plain one ran")
    check(c["mxu_kernels"] == {"tensor_core": c["launches"]["fused"]["fused"], "dp4a": 0},
          f"K11: kernel launches {c['mxu_kernels']}, not the tensor cores alone")
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
    """Each (label, modulus, generator, n, config keywords, mesh, comm[,
    axis]) distributed path (axis: every mesh axis by default): forward and
    inverse of the ``host_fill`` input against the native oracle
    (``oracles`` per (modulus, n)), every replica group's output where the
    axis leaves mesh axes out, and an exact roundtrip, with the launch
    counts set to 0 before and read after.  Returns the counts per label."""
    import numpy as np
    import torch

    from sventt_tpu_torch.field.limb import from_numpy, to_numpy
    from sventt_tpu_torch.parallel import DistributedNTT, distributed_memory_budget
    from sventt_tpu_torch.plan import NttConfig
    from sventt_tpu_torch.utils.fill import host_fill

    out = {}
    for label, N, g, n, kw, mesh, comm, *axis in paths:
        t0 = time.perf_counter()
        axes = mesh.axis_names
        axis = axis[0] if axis else axes[0] if len(axes) == 1 else axes
        dntt = DistributedNTT(NttConfig(N, g, n, strategy="six_step", **kw), mesh,
                              axis=axis, comm=comm)
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
        D, R = dntt.D, len(dntt.replicas)
        want_f, want_i = oracles[(N, n)]
        bad = [sum(int(np.count_nonzero(to_numpy(torch.cat(dntt.normalize(v[r * D:(r + 1) * D])))
                                        != want)) for r in range(R))
               for v, want in ((fwd, want_f), (inv, want_i), (back, x))]
        del fwd, inv, back, shards
        log(f"  {label}: D={D} x {R} replica group(s), comm={comm} {dntt.fc.modmul} on "
            f"{len(set(dntt.devices))} card(s); forward {bad[0]} / inverse {bad[1]} elements "
            "differ from the oracle (all groups), "
            f"roundtrip {bad[2]} differ (tables {build:.2f} s; 3 transforms {secs * 1e3:.1f} ms "
            "incl. first-call set-up)")
        log(f"    launches {c['launches']}, plain calls {c['plain']}")
        check(bad == [0, 0, 0], f"{label}: mismatch")
        # the budget's table bytes against the CUDA tables built (one
        # direction, one card: every shard's tables are on it)
        dev = dntt.devices[0]
        built = table_bytes([getattr(tables, k) for tables in (dntt._forward.col[dev],
                                                                dntt._forward.row[dev])
                             for k in ("leaf", "lane", "split_tw")])
        want_b = distributed_memory_budget(dntt.config, dntt.D).leaf_tables
        log(f"    budget leaf_tables {want_b} bytes, built CUDA tables {built} bytes")
        check(built == want_b, f"{label}: the budget's table bytes != the built tables'")
        k10 = c["launches"]["ring"]["ring"]
        check(k10 > 0 if comm == "ring" else k10 == 0, f"{label}: K10 launches {k10}")
        check(c["launches"]["inter_step"]["inter_step"] > 0, f"{label}: no inter-step launch")
        check(no_plain(c), f"{label}: a plain version ran on the card")
        out[label] = c
        del dntt
        torch.cuda.empty_cache()
    return out


def table_bytes(obj) -> int:
    """Bytes of the tensors that a table object holds: its fields, its
    items, and what an mxu table derives on a CUDA device -- its
    tensor-core tile copy ``tc_planes``, and ``kernel_planes`` where it is
    not ``planes`` itself (s8b)."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        parts = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
        parts.append(getattr(obj, "tc_planes", None))
        kp = getattr(obj, "kernel_planes", None)
        parts.append(None if kp is getattr(obj, "planes", None) else kp)
    elif isinstance(obj, dict):
        parts = list(obj.values())
    elif isinstance(obj, (tuple, list)):
        parts = list(obj)
    else:
        return 0
    return sum(table_bytes(v) for v in parts)


def dist_2p28(device):
    """The 2^28 flagship transform, ``engine="pallas"``, on 8 logical
    shards with comm "ring" and with "overlap": each forward equals the
    single-device six-step transform of the same split on the card
    (``torch.equal`` after ``normalize``), each roundtrip is exact.  The
    memory budget: per comm, the card's allocation
    (``torch.cuda.memory_allocated`` held and ``max_memory_allocated`` at
    peak, above what was allocated before) read after the tables'
    construction and after each step of the forward and the inverse
    (``compute_forward(on_step=...)``), with the caller holding only the
    input of each direction.  Fails if the peak of the construction or of
    a step exceeds the budget's total for the 8 shards the card holds
    (making the input, ``device_fill``'s own temporaries included, is the
    caller's and is read but not held to it).  Returns the ring run's
    launch counts."""
    import torch

    from sventt_tpu_torch.parallel import DistributedNTT, distributed_memory_budget
    from sventt_tpu_torch.plan import NTT, NttConfig
    from sventt_tpu_torch.utils.fill import device_fill

    flag, _ = moduli()
    n, D = 1 << 28, 8
    cfg = NttConfig(flag.modulus, flag.generator, n, strategy="six_step", engine="pallas")
    b = distributed_memory_budget(cfg, D)
    card = b.card_total(D)
    log(f"  budget per shard {b}: card_total(8) {card} bytes (the JAX rule's part "
        f"{card - b.step_scratch}, the port's step_scratch {b.step_scratch})")

    def run(comm):
        sync(device)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        mem = []

        def reading(name):
            sync(device)
            mem.append((name, torch.cuda.memory_allocated() - base,
                        torch.cuda.max_memory_allocated() - base))
            torch.cuda.reset_peak_memory_stats()

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dntt = DistributedNTT(cfg, logical_mesh(device, D), comm=comm)
        reading("tables")
        shards = dntt.shard(device_fill(n, flag.modulus, device))
        reading("input shards")
        reset_counts()
        fwd = dntt.compute_forward(shards, on_step=lambda step: reading(f"forward {step}"))
        del shards
        reading("forward input dropped")
        back = dntt.compute_inverse(fwd, on_step=lambda step: reading(f"inverse {step}"))
        c = counts()
        secs = time.perf_counter() - t0
        ok_back = torch.equal(torch.cat(dntt.normalize(back)), device_fill(n, flag.modulus, device))
        del back
        got = torch.cat(dntt.normalize(fwd))
        del fwd, dntt
        peak = max(p for name, _, p in mem if name != "input shards")
        log(f"  2^28 D=8 {comm}: roundtrip exact {ok_back} (tables + 2 transforms {secs:.2f} s)")
        for name, held, top in mem:
            log(f"    memory {name}: held {held} bytes, peak {top} bytes")
        log(f"    measured peak {peak} bytes ({100 * peak / card:.1f}% of card_total(8))")
        log(f"    launches {c['launches']}, plain calls {c['plain']}")
        check(ok_back, f"2^28 {comm}: roundtrip mismatch")
        check(no_plain(c), f"2^28 {comm}: a plain version ran")
        check(peak <= card, f"2^28 {comm}: peak {peak} bytes exceeds the budget's {card} for 8 shards")
        return got, c

    got_ring, c = run("ring")
    check(c["launches"]["ring"]["ring"] > 0, "2^28: K10 did not run")
    got_overlap, _ = run("overlap")
    torch.cuda.empty_cache()
    single = NTT(cfg, enable_inverse=False, device=device)
    want = single.normalize(single.compute_forward(device_fill(n, flag.modulus, device)))
    ok = {comm: torch.equal(want, got) for comm, got in (("ring", got_ring), ("overlap", got_overlap))}
    sync(device)
    log(f"  2^28 D=8: forward == single-device six_step {ok}; plan {single.plan.m0} x {single.plan.m1}")
    check(all(ok.values()), "2^28: forward mismatch")
    del single, want, got_ring, got_overlap
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
# the magic-series applications, the portable engine and the step helpers
# ---------------------------------------------------------------------------


def pipeline_run(device, smi: str) -> dict:
    """``magic_series_count(m)`` mod TEST_MODULUS at m = 100 and 101 (a
    2^20-point convolution on the default engine, the butterfly one: K4,
    K5 and K6 on the radix-2 register kernel) and M(100) again through the
    chunked path (``chunk`` = 2^16, one 2^17-point NTT reused), each
    against the exact count mod N,
    with the launch counts set to 0 before and read after.  The native
    generators' seconds are timed apart.  Returns the seconds per item."""
    from sventt_tpu_torch.apps import make_convolver, magic_series_count, series
    from sventt_tpu_torch.field.modulus import TEST_GENERATOR, TEST_MODULUS

    N, G = TEST_MODULUS, TEST_GENERATOR
    secs = {}
    for m, exact, chunk in ((100, M100, None), (101, M101, None), (100, M100, 1 << 16)):
        r = m * m * (m - 1) // 2
        label = f"M({m})" + ("" if chunk is None else f" chunk={chunk}")
        t0 = time.perf_counter()
        series.restricted_partition_series(m, r, N)
        series._qbinom_numerator(m * m, m, r, N)
        host = time.perf_counter() - t0
        t0 = time.perf_counter()
        if chunk is None:
            size = 1 << (2 * r).bit_length()  # the linear convolution's length
        else:
            size = 1 << max(2, (2 * chunk - 1).bit_length())
        ntt = make_convolver(N, G, size, device=device)
        sync(device)
        tables = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        got = magic_series_count(m, N, G, ntt=ntt, chunk=chunk)
        sync(device)
        total = time.perf_counter() - t0
        c = counts()
        log(f"  {label}: mod N {got}, exact mod N {exact % N}: {'equal' if got == exact % N else 'DIFFER'}; "
            f"{size}-point NTT (tables {tables:.2f} s); {total:.3f} s in all, of which the native "
            f"generators alone take {host:.3f} s ({smi})")
        log(f"    launches {c['launches']['pallas']}, radix-2 kernels {c['pallas_kernels']}, "
            f"plain calls {c['plain']['pallas']}")
        check(got == exact % N, f"{label}: the pipeline's count != the exact count mod N")
        orients = ("leaf", "mid", "lane") if chunk is None else ("leaf", "lane")  # 2^17: 256 x 512
        check(all(c["launches"]["pallas"][k] > 0 for k in orients)
              and radix2_routed(c) and no_plain(c),
              f"{label}: not every butterfly orientation ran on the register kernel, or a plain "
              "version ran")
        check(c["launches"]["pointwise"]["pointwise"] > 0, f"{label}: no pointwise launch")
        secs[label] = (total, host)
    return secs


def kinnaes_run(device, smi: str) -> dict:
    """``kinnaes_magic_series_count`` at m = 100 and 101 on the card (n/2 =
    247,521 and 252,513 lanes, an m-step product loop) at the 64- and
    62-bit widths of ``kinnaes_parameters``, against the exact counts."""
    from sventt_tpu_torch.apps import kinnaes_magic_series_count, kinnaes_parameters

    secs = {}
    for m, exact in ((100, M100), (101, M101)):
        for bits in (64, 62):
            Np, g, n = kinnaes_parameters(m, bits=bits)
            t0 = time.perf_counter()
            got = kinnaes_magic_series_count(m, Np, g, n, device=device)
            dt = time.perf_counter() - t0
            log(f"  Kinnaes m={m} N={Np:#x} ({bits} bits) n={n}: "
                f"{'equal' if got == exact % Np else 'DIFFER'} to the exact count mod N "
                f"({dt:.3f} s, {smi})")
            check(got == exact % Np, f"Kinnaes m={m} {bits} bits: != the exact count mod N")
            secs[f"Kinnaes m={m} {bits} bits"] = dt
    return secs


def jnp_paths(device, oracles: dict) -> dict:
    """``engine="jnp"`` at 2^17 and 2^24 and two mixed ``plan_spec`` trees at
    2^24 against the native oracle (``slice_run``): jnp rows over K1 / K2
    with a K3 root, and over K4 / K5 with a K6 root.  Returns the NTTs."""
    flag, _ = moduli()
    F, G = flag.modulus, flag.generator
    jnp = dict(engine="jnp")
    ntts, c = slice_run(device, [(f"jnp 2^{k}", F, G, 1 << k, jnp) for k in (17, 24)], oracles)
    log(f"  launches {c['launches']}, plain calls {c['plain']}")
    check(not any(c["launches"][k][o] for k in ("mxu", "pallas") for o in c["launches"][k])
          and no_plain(c), "the jnp engine launched an NTT kernel, or a plain version ran")
    check(c["launches"]["inter_step"]["inter_step"] > 0,
          "the jnp rows' inter-step multiply never launched its kernel")
    for spec, engine in (("mxu:256,jnp:16,mxu:256,mxu", "mxu"),
                         ("pallas:256,jnp:16,pallas:256,pallas", "pallas")):
        tree, c = slice_run(device, [(f"plan_spec {spec} 2^24", F, G, 1 << 24,
                                      dict(plan_spec=spec))], oracles)
        ntts.update(tree)
        log(f"    launches {c['launches']}, plain calls {c['plain']}")
        orients = ("lead", "mid", "lane") if engine == "mxu" else ("leaf", "mid", "lane")
        check(all(c["launches"][engine][o] > 0 for o in orients) and no_plain(c),
              f"plan_spec {spec}: a kernel of the tree never ran, or a plain version ran")
        check(mxu_on_tensor_cores(c) if engine == "mxu" else radix2_routed(c),
              f"plan_spec {spec}: the launches ran the wrong kernels")
        check("mid-axis jnp m1=16" in next(iter(tree.values())).describe(),
              f"plan_spec {spec}: no jnp row")
    return ntts


def step_helpers(device, ntt_mxu17, dist_cfg, mesh, smi: str) -> dict:
    """``NTT.forward_step`` / ``inverse_step`` of the flagship 2^17 mxu plan
    captured once each in a ``torch.cuda.CUDAGraph`` and replayed on two
    inputs, bitwise against ``compute_forward`` / ``compute_inverse``, the
    replay timed beside the eager call; ``DistributedNTT.forward_step`` /
    ``inverse_step`` against the compute calls (eager)."""
    import torch

    from sventt_tpu_torch.field.modulus import FLAGSHIP_MODULUS
    from sventt_tpu_torch.parallel import DistributedNTT
    from sventt_tpu_torch.utils.fill import device_fill

    ms = {}
    n = ntt_mxu17.get_m()
    xs = [device_fill(n, FLAGSHIP_MODULUS, device), device_fill(2 * n, FLAGSHIP_MODULUS, device)[n:]]
    for name, helper, compute in (("forward", ntt_mxu17.forward_step, ntt_mxu17.compute_forward),
                                  ("inverse", ntt_mxu17.inverse_step, ntt_mxu17.compute_inverse)):
        step, tabs = helper()
        static_x = xs[0].clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(static_x, *tabs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        reset_counts()
        with torch.cuda.graph(graph):
            static_out = step(static_x, *tabs)
        c = counts()
        for x in xs:
            static_x.copy_(x)
            graph.replay()
            want = compute(x)
            sync(device)
            check(torch.equal(static_out, want), f"the captured {name}_step != compute_{name}")
        ms[f"mxu 2^17 {name} graph replay"] = timed(graph.replay, 3, 20)
        ms[f"mxu 2^17 {name} eager"] = timed(lambda: compute(xs[0]), 3, 20)
        log(f"  {name}_step captured ({c['mxu_kernels']['tensor_core']} tensor-core launches in "
            f"the capture): two replays equal compute_{name} bitwise; replay "
            f"{ms[f'mxu 2^17 {name} graph replay']:.4f} ms, eager "
            f"{ms[f'mxu 2^17 {name} eager']:.4f} ms by CUDA events ({smi})")
        check(c["mxu_kernels"]["tensor_core"] > 0 and c["mxu_kernels"]["dp4a"] == 0,
              f"the captured {name}_step ran no tensor-core kernel")
        del graph, static_out
    dntt = DistributedNTT(dist_cfg, mesh, comm="ring")
    shards = dntt.shard(device_fill(dist_cfg.n, dist_cfg.modulus, device))
    step, tabs = dntt.forward_step()
    fwd = dntt.compute_forward(shards)
    ok_f = all(torch.equal(a, b) for a, b in zip(step(shards, *tabs), fwd))
    step, tabs = dntt.inverse_step()
    ok_i = all(torch.equal(a, b) for a, b in zip(step(fwd, *tabs), dntt.compute_inverse(fwd)))
    sync(device)
    log(f"  DistributedNTT({dist_cfg.engine} 2^{dist_cfg.n.bit_length() - 1} D={dntt.D} ring) "
        f"forward_step == compute_forward {ok_f}, inverse_step == compute_inverse {ok_i}")
    check(ok_f and ok_i, "DistributedNTT's step helpers != its compute calls")
    return ms


# ---------------------------------------------------------------------------
# the autotuner, donation, profiling and the partial collective axis
# ---------------------------------------------------------------------------


def oracle(oracles: dict, N: int, g: int, n: int):
    """The native oracle's (forward, inverse) of ``host_fill(n, N)``, cached
    in ``oracles`` per (modulus, n)."""
    from sventt_tpu_torch import native
    from sventt_tpu_torch.utils.fill import host_fill

    if (N, n) not in oracles:
        x = host_fill(n, N)
        oracles[(N, n)] = (native.golden_forward(x, N, g), native.golden_inverse(x, N, g))
    return oracles[(N, n)]


def autotune_phase(device, smi: str, oracles: dict) -> dict:
    """The full race (``plan.autotune.tune``, the three engines, the
    playoff, the winner's elementwise check) of the flagship transform at
    2^17 and 2^24 into a temporary cache: no candidate may fail, a second
    ``tune`` must hit the cache without searching, and the winner is timed
    beside the untuned config (``engine="auto"``) in turns (untuned,
    winner, winner, untuned) by the same timer.  Then ``NTT(tune=True)`` at
    2^24 from the shipped cache (the race's cache where the shipped one has
    no entry for this card) against the native oracle.  Returns the ms."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from sventt_tpu_torch.plan import NttConfig, autotune

    flag, _ = moduli()
    F, G = flag.modulus, flag.generator
    ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "autotune_cache.json"
        for log2n in (17, 24):
            cfg = NttConfig(F, G, 1 << log2n)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            best = autotune.tune(cfg, device=device, cache_path=cache)
            secs = time.perf_counter() - t0
            entry = autotune._load_cache(cache)[autotune.cache_key(cfg, device)]
            failed = [k for k, v in entry["timings"].items() if v is None]
            log(f"  2^{log2n}: {len(entry['timings'])} timings, winner {autotune._tag(best)} "
                f"at {entry['best_ms']} ms (verified elementwise against the untuned config); "
                f"race {secs:.1f} s; peak {torch.cuda.max_memory_allocated()} bytes ({smi})")
            log("    " + "; ".join(f"{k} {v}" for k, v in entry["timings"].items()))
            check(not failed, f"2^{log2n}: candidates failed: {failed}")
            search = autotune.search

            def boom(*a, **k):
                raise AssertionError("search ran on a cache hit")

            autotune.search = boom
            try:
                again = autotune.tune(cfg, device=device, cache_path=cache)
            finally:
                autotune.search = search
            check(again == best, f"2^{log2n}: the cache hit returned another config")
            turns = []
            for c in (cfg, best, best, cfg):
                turns.append(autotune._time_candidate(c, autotune.CHAIN_SECONDS, device=device))
            untuned, won = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            ms[f"2^{log2n} untuned (auto)"], ms[f"2^{log2n} tuned"] = untuned, won
            log(f"    in turns untuned, winner, winner, untuned: "
                + ", ".join(f"{t:.4f}" for t in turns)
                + f" ms: the winner {untuned / won:.2f}x the untuned config ({smi})")
        shipped = autotune._load_cache(autotune._DEFAULT_CACHE)
        key = autotune.cache_key(NttConfig(F, G, 1 << 24), device)
        where = "the shipped cache"
        env = os.environ.get(autotune.CACHE_ENV)
        if key not in shipped:
            where = "the race's cache (the shipped one has no entry for this card)"
            os.environ[autotune.CACHE_ENV] = str(cache)
        try:
            log(f"  NTT(tune=True) 2^24 from {where}:")
            ntts, c = slice_run(device, [("tuned 2^24", F, G, 1 << 24, dict(tune=True))], oracles)
        finally:
            if env is None:
                os.environ.pop(autotune.CACHE_ENV, None)
            else:
                os.environ[autotune.CACHE_ENV] = env
        log(f"    {autotune._tag(ntts['tuned 2^24'].config)}; launches {c['launches']}, "
            f"plain calls {c['plain']}")
        check(no_plain(c), "the tuned NTT ran a plain version")
    torch.cuda.empty_cache()
    return ms


def donate_phase(device, smi: str, oracles: dict) -> None:
    """The flagship forward, the default engine's (``engine="auto"``) and
    the matrix engine's, with and without ``donate_input`` at 2^26 (both
    against the native oracle) and 2^28 (donated bitwise against the
    kept-input output): the call's peak allocation above the tables (the
    input included), by ``max_memory_allocated``, and the time of one
    forward of a fresh copy of the input by CUDA events."""
    import torch

    from sventt_tpu_torch.field.limb import to_numpy
    from sventt_tpu_torch.plan import NTT, NttConfig
    from sventt_tpu_torch.utils.fill import device_fill

    flag, _ = moduli()
    F, G = flag.modulus, flag.generator
    for engine, log2n in ((e, k) for e in ("auto", "mxu") for k in (26, 28)):
        n = 1 << log2n
        outs, peaks, times_ms = {}, {}, {}
        for donate in (False, True):
            torch.cuda.empty_cache()
            ntt = NTT(NttConfig(F, G, n, engine=engine), enable_inverse=False,
                      donate_input=donate, device=device)
            sync(device)
            before = torch.cuda.memory_allocated()
            x = device_fill(n, F, device)
            sync(device)
            torch.cuda.reset_peak_memory_stats()
            y = ntt.compute_forward(x)
            sync(device)
            peaks[donate] = torch.cuda.max_memory_allocated() - before
            check(x.untyped_storage().nbytes() == (0 if donate else 8 * n),
                  f"{engine} 2^{log2n}: the input was {'kept' if donate else 'released'}")
            del x
            outs[donate] = ntt.normalize(y) if log2n == 28 else to_numpy(ntt.normalize(y))
            del y
            src = device_fill(n, F, device)
            times_ms[donate] = timed(lambda: ntt.compute_forward(src.clone()), 1, 5)
            del src, ntt
        saving = peaks[False] - peaks[True]
        if log2n == 26:
            want = oracle(oracles, F, G, n)[0]
            ok = all(bool((outs[d] == want).all()) for d in outs)
            what = "both equal the native oracle"
        else:
            ok = torch.equal(outs[False], outs[True])
            what = "donated == kept, bitwise"
        log(f"  {engine} 2^{log2n} forward: {what}: {ok}; peak above the tables kept "
            f"{peaks[False]} / donated {peaks[True]} bytes: saving {saving} bytes = "
            f"{saving / (8 * n):.4f} n-word buffers; forward of a copy kept {times_ms[False]:.4f} / "
            f"donated {times_ms[True]:.4f} ms ({smi})")
        check(ok, f"{engine} 2^{log2n}: the donated forward differs")
        check(abs(saving - 8 * n) <= 0.05 * 8 * n,
              f"{engine} 2^{log2n}: donation saved {saving} bytes, not one n-word buffer")
        del outs
    torch.cuda.empty_cache()


def profiling_phase(device, smi: str, ntts: dict) -> None:
    """``phase_breakdown`` of the 2^24 mxu and pallas plans (CUDA-graph
    replays at the plan's shapes), and ``trace`` writing its Chrome trace."""
    import tempfile
    from pathlib import Path

    import torch

    from sventt_tpu_torch.utils import device_fill, phase_breakdown, trace

    for label in ("mxu 2^24", "pallas 2^24"):
        bd = phase_breakdown(ntts[label], seconds=0.05)
        log(f"  {label}: " + "; ".join(f"{k} {v:.4f}" for k, v in bd.items())
            + f" ms ({smi})")
        check(all(v > 0 for v in bd.values()) and "total" in bd, f"{label}: empty breakdown")
    ntt = ntts["mxu 2^24"]
    x = device_fill(ntt.get_m(), ntt.mod.modulus, device)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            ntt.compute_forward(x)
            torch.cuda.synchronize()
        files = list(Path(tmp).glob("*.pt.trace.json"))
        cuda_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        log(f"  trace: {[f.name for f in files]}, {sum(f.stat().st_size for f in files)} bytes; "
            f"device time in it {cuda_us / 1e3:.4f} ms")
        check(len(files) == 1 and files[0].stat().st_size > 0, "trace wrote no file")


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


def solinas_products(N: int) -> int:
    """32 x 32-bit products the Solinas multiply (``field.cuh`` solinas_mul)
    needs by its operands' widths, for N = 2^64 - eps: the 64 x 64 product
    in full (2 x 2 words), then each fold's high word times eps, the high
    word's bound after each fold setting its words: the least work, as the
    bound asks, and the products field.cuh's narrow form is written with
    (tools/solinas_fold.py counts the SASS).  The flagship: 4 + 2x2 + 2x2
    + 1x2 = 14."""
    eps = (1 << 64) - N

    def words(v: int) -> int:
        return max(1, -(-v.bit_length() // 32))

    total, hi = 4, (1 << 64) - 1
    for _ in range(3):
        total += words(hi) * words(eps)
        hi = (hi * eps + (1 << 64)) >> 64
    return total


#: 32-bit multiply-adds of one stage multiply per engine, on the flagship
#: modulus every timed kernel runs: Montgomery two high and one low 64-bit
#: products, Shoup one high and two low, Solinas ``solinas_products``.
STAGE_IMADS = {"montgomery": 2 * IMAD_HI + IMAD_LO, "shoup": IMAD_HI + 2 * IMAD_LO,
               "solinas": solinas_products(2**64 - 1827 * 2**31 + 1)}


def tw_cost(tw: str | None, tw_points: int) -> tuple[int, int]:
    """(32-bit multiply-adds a point, table bytes) of the fused or separate
    inter-step multiply: "pair" Montgomery with its companion (16 bytes an
    entry), "w" Montgomery computing it (one low product more, 8 bytes),
    "solinas" the Solinas multiply (8 bytes)."""
    if tw is None:
        return 0, 0
    if tw == "solinas":
        return STAGE_IMADS["solinas"], 8 * tw_points
    return 2 * IMAD_HI + IMAD_LO + (IMAD_LO if tw == "w" else 0), tw_points * (16 if tw == "pair" else 8)


def butterfly_bound(points: int, m: int, inverse: bool, modmul: str, tw: str | None,
                    tw_points: int) -> tuple[float, str]:
    """K4/K5/K6: per stage, one stage multiply per butterfly (two on the
    last inverse stage) at ``STAGE_IMADS[modmul]``; the inter-step
    multiply as ``tw_cost`` says.  Bytes: 8 a point in and 8 out, the
    (tw_points,) inter-step table and the (m-1,) stage tables read once
    (two of them, one under Solinas)."""
    stages = m.bit_length() - 1
    muls = stages * points // 2 + (points // 2 if inverse else 0)
    per_point, tw_bytes = tw_cost(tw, tw_points)
    imads = muls * STAGE_IMADS[modmul] + points * per_point
    tables = 8 * (m - 1) * (1 if modmul == "solinas" else 2)
    return bound(16 * points + tw_bytes + tables, imads / IMAD_PER_S)


def butterfly_products(m: int, inverse: bool, tw: bool) -> float:
    """Stage (and inter-step) multiplies a point of K4 / K5: half a
    multiply a stage, one more per butterfly of the scaled last inverse
    stage, one for the twiddle."""
    stages = m.bit_length() - 1
    return stages / 2 + (0.5 if inverse else 0) + (1 if tw else 0)


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
    per_point, tw_bytes = tw_cost(tw, tw_points)
    imads = per_col * (points // m) * STAGE_IMADS[modmul] + points * per_point
    return bound(16 * points + tw_bytes + 16 * m * len(t.specs), imads / IMAD_PER_S)


def inter_step_bound(points: int, tw_points: int, tw: str) -> tuple[float, str]:
    """The inter-step multiply (``tw_cost``): 8 bytes a point in, 8 out,
    the table once."""
    per_point, tw_bytes = tw_cost(tw, tw_points)
    return bound(16 * points + tw_bytes, points * per_point / IMAD_PER_S)


def pointwise_bound(points: int) -> tuple[float, str]:
    """The pointwise product: 8 bytes a point of each operand in, 8 out,
    against two Montgomery products a point at ``MONT_RATE``'s high end."""
    return bound(24 * points, 2 * points / MONT_RATE[1])


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


def u7_geometry_ab(device, flag, fc, xl, twl, xr, tw3, x128, out: dict, ab: dict) -> None:
    """The u7 block's two builds, 16 and 32 columns, as CUDA-graph replays
    in turns, the rule's (``ntt_mxu.tc_geometry``) against the other: at
    m = 256, the 2^24 K1 (pair) and K3 (no twiddle, and the pair inverse)
    shapes -- 32 columns take 117,760 bytes of shared memory, one block an
    SM, 16 take 104,960, two -- and at K11's m = 128, (128, 32768), where
    both fit two (76,800 and 84,480 bytes).  The other block runs on the
    same tables with their tile copy laid out for it
    (``MxuDirection.tc_nt``), through the same entry points; its results
    must equal the rule's first."""
    import dataclasses

    from sventt_tpu_torch.ops import ntt_mxu

    fc0 = type(fc).from_modulus(flag, lazy=False)
    calls = {
        "K1 lead 256x65536 pair": (256, False, lambda t: ntt_mxu.mxu_ntt(xl, t, fc, twl)),
        "K3 lane 65536x256": (256, False, lambda t: ntt_mxu.mxu_ntt_lane(xr, t, fc)),
        "K3 lane 65536x256 pair inv": (256, True, lambda t: ntt_mxu.mxu_ntt_lane(xr, t, fc, tw3)),
        "K11 lead 128x32768": (128, False, lambda t: ntt_mxu.mxu_ntt(x128, t, fc0)),
    }
    for key, (m, inv, call) in calls.items():
        rule = ntt_mxu.tc_geometry(m, 1 << 15, scheme="u7")
        other = 16 if rule.nt == 32 else 32
        geo = ntt_mxu.tc_geometry(m, 1 << 15, scheme="u7", nt=other)
        t_rule = ntt_mxu.make_mxu_tables(flag, m, inverse=inv, scheme="u7", device=device)
        t_other = dataclasses.replace(t_rule, tc_nt=other)

        def other_call(call=call, t=t_other):
            return call(t)

        check(mismatch(other_call(), call(t_rule)) == 0, f"u7 {key}: nt {other} != nt {rule.nt}")
        log(f"  u7 {key}: the rule nt {rule.nt} (rg {rule.rg}, {rule.smem} bytes) against nt "
            f"{geo.nt} (rg {geo.rg}, {geo.smem} bytes): equal")
        key = f"u7 {key} nt={rule.nt}"
        o1, n1, n2, o2 = (timed_graph(f, 3, 10) for f in
                          (other_call, lambda: call(t_rule), lambda: call(t_rule), other_call))
        out[key], out[f"{key} nt={other}"] = (n1 + n2) / 2, (o1 + o2) / 2
        ab[key] = (f"nt={other}", o1, n1, n2, o2)


def times(device, ntts, rng):
    """CUDA-event medians: transforms, and each kernel vs its plain
    version at the 2^24 plans' shapes; with each kernel's bound."""
    import torch

    from sventt_tpu_torch.experimental import mxu_fused_kernel as fused
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import inter_step, ntt_mxu, pointwise
    from sventt_tpu_torch.ops import ntt_pallas as P
    from sventt_tpu_torch.ops import transpose as T
    from sventt_tpu_torch.ops.transpose import transpose01
    from sventt_tpu_torch.ops.twiddle import MontPair, inter_step_mul
    from sventt_tpu_torch.utils.fill import device_fill

    out, bounds, own, ab, products = {}, {}, {}, {}, {}
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

    def kernel(key, fn, plain, bnd, own_ms=None, old=None, old_name="dp4a", graph=False):
        """``old``: the earlier kernel at the same call (``old_name``: the
        __dp4a matrix kernel, or the rank-by-rank grouped one), timed in
        turns with ``fn`` (old, new, new, old); each keeps the mean of its
        two.  ``graph``: time one CUDA-graph replay of each: the device time, without the tens of
        microseconds of the wrapper's Python work that an eager call's
        events also enclose (at the 2^17 shapes more than the kernel)."""

        def timer(f):
            if graph:
                try:
                    return timed_graph(f, 3, 10)
                except RuntimeError as e:  # a measurement only: the eager time stands in
                    log(f"  {key}: CUDA graph capture failed ({e!r}); eager time used")
            return timed(f, 3, 10)

        if old is None:
            out[key] = timer(fn)
        else:
            o1, n1, n2, o2 = (timer(f) for f in (old, fn, fn, old))
            out[key], out[f"{key} {old_name}"] = (n1 + n2) / 2, (o1 + o2) / 2
            ab[key] = (old_name, o1, n1, n2, o2)
        out[key + " plain"] = timed(plain, 1, 3)
        bounds[key] = bnd
        if own_ms is not None:
            own[key] = own_ms

    def turns(key, new, old, old_name):
        """CUDA-graph replays of ``old`` and ``new`` in turns (old, new,
        new, old); each keeps the mean of its two."""
        o1, n1, n2, o2 = (timed_graph(f, 3, 10) for f in (old, new, new, old))
        out[key], out[f"{key} {old_name}"] = (n1 + n2) / 2, (o1 + o2) / 2
        ab[key] = (old_name, o1, n1, n2, o2)

    # matrix engine: the 2^24 plan's leaf shape (lead), inner row step
    # (mid, (256, 256) twiddle rows) and root step (lane, the (65536, 256)
    # table in the data's layout); K1, K2 and K3 on the tensor cores, each
    # beside the __dp4a kernel
    dp4a = ntt_mxu._launch_dp4a
    t = ntt_mxu.make_mxu_tables(flag, 256, inverse=False, device=device)
    xl = rand_u64(rng, (256, 1 << 16), device, below=flag.modulus)
    twl = rand_twiddle(rng, (256, 1 << 16), flag, "pair", device)
    kernel("K1 lead 256x65536 pair", lambda: ntt_mxu.mxu_ntt(xl, t, fc, twl),
           lambda: ntt_mxu.mxu_plain(xl, t, fc, twl), mxu_bound(n24, 256, 16 * n24),
           old=lambda: dp4a(xl, t, fc, twl))
    xm = rand_u64(rng, (256, 256, 256), device, below=flag.modulus)
    twm = rand_twiddle(rng, (256, 256), flag, "pair", device)
    kernel("K2 mid 256x256x256 pair", lambda: ntt_mxu.mxu_ntt_mid(xm, t, fc, twm),
           lambda: ntt_mxu.mxu_plain(xm, t, fc, twm, mid=True), mxu_bound(n24, 256, 16 * 65536),
           old=lambda: dp4a(xm, t, fc, twm, mid=True))
    # the companion-free twiddles of the "w" and Solinas modes
    twls, twms = MontPair(twl.w, None), MontPair(twm.w, None)
    kernel("K1 lead 256x65536 w", lambda: ntt_mxu.mxu_ntt(xl, t, fc, twls),
           lambda: ntt_mxu.mxu_plain(xl, t, fc, twls), mxu_bound(n24, 256, 8 * n24),
           old=lambda: dp4a(xl, t, fc, twls))
    kernel("K2 mid 256x256x256 w", lambda: ntt_mxu.mxu_ntt_mid(xm, t, fc, twms),
           lambda: ntt_mxu.mxu_plain(xm, t, fc, twms, mid=True), mxu_bound(n24, 256, 8 * 65536),
           old=lambda: dp4a(xm, t, fc, twms, mid=True))
    # K3, the root step, as CUDA-graph replays in turns with the __dp4a
    # kernel, both directions with the pair twiddle
    xr = rand_u64(rng, (1 << 16, 256), device, below=flag.modulus)
    tw3 = rand_twiddle(rng, (1 << 16, 256), flag, "pair", device)
    ti = ntt_mxu.make_mxu_tables(flag, 256, inverse=True, device=device)
    for key, tk in (("K3 lane 65536x256 pair", t), ("K3 lane 65536x256 pair inv", ti)):
        kernel(key, lambda tk=tk: ntt_mxu.mxu_ntt_lane(xr, tk, fc, tw3),
               lambda tk=tk: ntt_mxu.mxu_plain(xr, tk, fc, tw3, lane=True),
               mxu_bound(n24, 256, 16 * n24),
               old=lambda tk=tk: dp4a(xr, tk, fc, tw3, lane=True), graph=True)
    # the root step: JAX's sandwich (transpose, K1 with the transposed
    # table, transpose back) against K3 with the table fused, CUDA-graph
    # replays in turns, at the 2^24 and 2^17 roots; then K3's two
    # epilogues on the inverse with the pair twiddle, the staged one (which
    # it runs) against the stores from the fragment, at the 2^24, 2^17 and
    # 2^26 root shapes
    for rows, m_, tag in ((1 << 16, 256, "2^24"), (256, 512, "2^17"), (1 << 17, 512, "2^26")):
        xs = xr if m_ == 256 else rand_u64(rng, (rows, m_), device, below=flag.modulus)
        tws = tw3 if m_ == 256 else rand_twiddle(rng, (rows, m_), flag, "pair", device)
        twt = MontPair(tws.w.t().contiguous(), tws.wp.t().contiguous())
        for inv in (False, True):
            tk = ntt_mxu.make_mxu_tables(flag, m_, inverse=inv, device=device)
            d = " inv" if inv else ""
            sandwich = lambda xs=xs, tk=tk, twt=twt: transpose01(
                ntt_mxu.mxu_ntt(transpose01(xs), tk, fc, twt))
            k3 = lambda xs=xs, tk=tk, tws=tws: ntt_mxu.mxu_ntt_lane(xs, tk, fc, tws)
            if tag != "2^26":
                turns(f"root step {rows}x{m_} pair{d} ({tag})", k3, sandwich, "sandwich")
            if inv:  # the path's staged epilogue against the fragment's stores
                frag = lambda xs=xs, tk=tk, tws=tws: ntt_mxu._launch_lane_form(
                    xs, tk, fc, "lane", tws)
                check(mismatch(frag(), k3()) == 0, f"{tag}: the fragment epilogue != K3")
                turns(f"K3 epilogue {rows}x{m_} pair inv ({tag})", k3, frag, "fragment")
        del xs, tws, twt
    # the Solinas twiddle of K1/K2 at the same shapes: the plain random
    # twiddles below N without their companion
    fcs = FieldConsts.from_modulus(flag, modmul="solinas")
    kernel("K1 lead 256x65536 solinas", lambda: ntt_mxu.mxu_ntt(xl, t, fcs, twls),
           lambda: ntt_mxu.mxu_plain(xl, t, fcs, twls), mxu_bound(n24, 256, 8 * n24),
           old=lambda: dp4a(xl, t, fcs, twls))
    kernel("K2 mid 256x256x256 solinas", lambda: ntt_mxu.mxu_ntt_mid(xm, t, fcs, twms),
           lambda: ntt_mxu.mxu_plain(xm, t, fcs, twms, mid=True), mxu_bound(n24, 256, 8 * 65536),
           old=lambda: dp4a(xm, t, fcs, twms, mid=True))
    # the 2^17 plan's two launches (the row split fills the card)
    for m17, shape in ((256, (256, 512)), (512, (512, 256))):
        t17 = ntt_mxu.make_mxu_tables(flag, m17, inverse=False, device=device)
        x17 = rand_u64(rng, shape, device, below=flag.modulus)
        kernel(f"K1 lead {shape[0]}x{shape[1]} (2^17)", lambda: ntt_mxu.mxu_ntt(x17, t17, fc),
               lambda: ntt_mxu.mxu_plain(x17, t17, fc), mxu_bound(1 << 17, m17, 0),
               old=lambda: dp4a(x17, t17, fc))
    # the other plane schemes at the same three shapes, u7 as CUDA-graph
    # replays in turns with the __dp4a kernel, and K11 at its own the same
    # way
    for scheme in ("u7", "s8b"):
        ts = ntt_mxu.make_mxu_tables(flag, 256, inverse=False, scheme=scheme, device=device)
        macs = SCHEME_MACS[scheme]
        u7 = scheme == "u7"
        kernel(f"K1 lead 256x65536 pair {scheme}", lambda: ntt_mxu.mxu_ntt(xl, ts, fc, twl),
               lambda: ntt_mxu.mxu_plain(xl, ts, fc, twl), mxu_bound(n24, 256, 16 * n24),
               mxu_bound(n24, 256, 16 * n24, macs)[0],
               old=(lambda: dp4a(xl, ts, fc, twl)) if u7 else None, graph=u7)
        kernel(f"K2 mid 256x256x256 pair {scheme}", lambda: ntt_mxu.mxu_ntt_mid(xm, ts, fc, twm),
               lambda: ntt_mxu.mxu_plain(xm, ts, fc, twm, mid=True),
               mxu_bound(n24, 256, 16 * 65536), mxu_bound(n24, 256, 16 * 65536, macs)[0],
               old=(lambda: dp4a(xm, ts, fc, twm, mid=True)) if u7 else None, graph=u7)
        kernel(f"K3 lane 65536x256 {scheme}", lambda: ntt_mxu.mxu_ntt_lane(xr, ts, fc),
               lambda: ntt_mxu.mxu_plain(xr, ts, fc, lane=True), mxu_bound(n24, 256, 0),
               mxu_bound(n24, 256, 0, macs)[0],
               old=(lambda: dp4a(xr, ts, fc, lane=True)) if u7 else None, graph=u7)
    stack = fused.make_fused_stack(flag, device=device)
    x128 = rand_u64(rng, (128, 1 << 15), device, below=flag.modulus)
    u7_geometry_ab(device, flag, fc, xl, twl, xr, tw3, x128, out, ab)
    t128 = fused._direction(stack, flag)
    kernel("K11 fused 128x32768", lambda: fused.mxu_fused_ntt(x128, stack, flag),
           lambda: fused.mxu_fused_plain(x128, stack, flag), mxu_bound(1 << 22, 128, 0),
           mxu_bound(1 << 22, 128, 0, SCHEME_MACS["u7"])[0],
           old=lambda: dp4a(x128, t128, fc), graph=True)
    del xl, twl, twls, xr, x128, tw3
    ab_level(device, fc, out, bounds, own)
    # butterfly engine: the 2^24 pallas plan's leaf, inner row step and root.
    # K4 / K5 / K6 on the register kernel in turns with the stage-by-stage
    # one (ntt_pallas._launch_stages), as CUDA-graph replays: both
    # directions, the Solinas forms and the test modulus's Shoup forms, then
    # the 2^17 plan's three launches and the 2^26 plan's inner row step and
    # root; K6's twiddle has the data's shape
    _, test = moduli()
    fct = FieldConsts.from_modulus(test, modmul="shoup")
    xt = rand_u64(rng, (256, 256, 256), device, below=test.modulus)
    twt = rand_twiddle(rng, (256, 256), test, "pair", device)
    twr = rand_twiddle(rng, (1 << 16, 256), flag, "pair", device)
    twrs = MontPair(twr.w, None)
    twrt = rand_twiddle(rng, (1 << 16, 256), test, "pair", device)
    stages = P._launch_stages
    for key, mod, fcx, inv, shape, tw_, modmul in (
        ("K4 leaf 256x65536", flag, fc, False, (256, 65536), None, "montgomery"),
        ("K4 leaf 256x65536 inv", flag, fc, True, (256, 65536), None, "montgomery"),
        ("K5 mid 256x256x256 pair", flag, fc, False, (256, 256, 256), twm, "montgomery"),
        ("K5 mid 256x256x256 pair inv", flag, fc, True, (256, 256, 256), twm, "montgomery"),
        ("K4 leaf 256x65536 solinas", flag, fcs, False, (256, 65536), None, "solinas"),
        ("K4 leaf 256x65536 inv solinas", flag, fcs, True, (256, 65536), None, "solinas"),
        ("K5 mid 256x256x256 solinas", flag, fcs, False, (256, 256, 256), twms, "solinas"),
        ("K5 mid 256x256x256 inv solinas", flag, fcs, True, (256, 256, 256), twms, "solinas"),
        ("K4 leaf 256x65536 TEST shoup", test, fct, False, (256, 65536), None, "shoup"),
        ("K5 mid 256x256x256 pair TEST shoup", test, fct, False, (256, 256, 256), twt, "shoup"),
        ("K4 leaf 32x4096 (2^17)", flag, fc, False, (32, 4096), None, "montgomery"),
        ("K5 mid 32x64x64 pair (2^17)", flag, fc, False, (32, 64, 64), "pair", "montgomery"),
        ("K5 mid 4096x128x128 pair (2^26)", flag, fc, False, (4096, 128, 128), "pair",
         "montgomery"),
        ("K6 lane 65536x256 pair", flag, fc, False, (1 << 16, 256), twr, "montgomery"),
        ("K6 lane 65536x256 pair inv", flag, fc, True, (1 << 16, 256), twr, "montgomery"),
        ("K6 lane 65536x256 solinas", flag, fcs, False, (1 << 16, 256), twrs, "solinas"),
        ("K6 lane 65536x256 inv solinas", flag, fcs, True, (1 << 16, 256), twrs, "solinas"),
        ("K6 lane 65536x256 pair TEST shoup", test, fct, False, (1 << 16, 256), twrt, "shoup"),
        ("K6 lane 2048x64 pair (2^17)", flag, fc, False, (2048, 64), "pair", "montgomery"),
        ("K6 lane 2048x64 pair inv (2^17)", flag, fc, True, (2048, 64), "pair", "montgomery"),
        ("K6 lane 524288x128 pair (2^26)", flag, fc, False, (1 << 19, 128), "pair", "montgomery"),
    ):
        lane, mid = key.startswith("K6"), len(shape) == 3
        m = shape[-1] if lane else shape[1] if mid else shape[0]
        points = shape[0] * shape[1] * (shape[2] if mid else 1)
        src = xt if mod is test else xm
        x = src.view(shape) if points == n24 else rand_u64(rng, shape, device, below=mod.modulus)
        if tw_ == "pair":
            tw_ = rand_twiddle(rng, shape if lane else shape[:2], mod, "pair", device)
        if lane:
            t = P.make_lane_tables(mod, m, inverse=inv, modmul=modmul, device=device)
            new = lambda x=x, t=t, fcx=fcx, tw_=tw_: P.fused_ntt_lane(x, t, fcx, tw_)
            plain = lambda x=x, t=t, fcx=fcx, tw_=tw_: P.lane_plain(x, t, fcx, tw_)
        else:
            t = P.make_leaf_tables(mod, m, inverse=inv, modmul=modmul, device=device)
            if mid:
                new = lambda x=x, t=t, fcx=fcx, tw_=tw_: P.fused_ntt_mid(x, t, fcx, tw_)
                plain = lambda x=x, t=t, fcx=fcx, tw_=tw_: P.mid_plain(x, t, fcx, tw_)
            else:
                new = lambda x=x, t=t, fcx=fcx: P.fused_ntt(x, t, fcx)
                plain = lambda x=x, t=t, fcx=fcx: P.leaf_plain(x, t, fcx)
        old = lambda x=x, t=t, fcx=fcx, tw_=tw_, mid=mid: stages(x, t, fcx, tw_, mid=mid)
        want = plain()
        check(max(mismatch(new(), want), mismatch(old(), want)) <= TOL,
              f"{key}: a radix-2 kernel != plain")
        tw_kind = None if tw_ is None else ("solinas" if modmul == "solinas" else "pair")
        tw_points = points if lane else shape[0] * m if mid else 0
        bnd = butterfly_bound(points, m, inv, modmul, tw_kind, tw_points)
        kernel(key, new, plain, bnd, old=old, old_name="stages", graph=True)
        products[key] = (butterfly_products(m, inv, tw_kind is not None)
                         if modmul == "montgomery" else None)
        del x, want, tw_
    xr = xm.view(1 << 16, 256)
    del xt, twt, twrt
    # grouped engine (max_r = 3): the 2^24 plan's leaves (the column leaf
    # and the inner row's leaf between transposes), the inter-step multiply
    # of that row, the root; each on the register kernel in turns with the
    # rank-by-rank one (ntt_pallas._launch_grouped_ranks), whose output is
    # first held to the plain version's; then max_r 2 and 4 at the leaf,
    # both directions, and the 2^17 plan's two launches
    ranks = P._launch_grouped_ranks
    for name, r, inv, lane, shape, tw_ in (
        ("K7 leaf 256x65536 r=3", 3, False, False, (256, 65536), None),
        ("K7 leaf 256x65536 r=3 inv", 3, True, False, (256, 65536), None),
        ("K7 leaf 256x65536 r=2", 2, False, False, (256, 65536), None),
        ("K7 leaf 256x65536 r=4", 4, False, False, (256, 65536), None),
        ("K8 lane 65536x256 r=3 pair", 3, False, True, (65536, 256), twr),
        ("K8 lane 65536x256 r=3 pair inv", 3, True, True, (65536, 256), twr),
        ("K7 leaf 256x512 r=3 (2^17)", 3, False, False, (256, 512), None),
        ("K7 leaf 256x512 r=3 inv (2^17)", 3, True, False, (256, 512), None),
        ("K8 lane 256x512 r=3 pair (2^17)", 3, False, True, (256, 512), "pair"),
        ("K8 lane 256x512 r=3 pair inv (2^17)", 3, True, True, (256, 512), "pair"),
    ):
        m, make = (shape[1], P.make_lane_tables) if lane else (shape[0], P.make_leaf_tables)
        gt = make(flag, m, inverse=inv, max_r=r, device=device)
        xg = xm.view(shape) if shape[0] * shape[1] == n24 else rand_u64(
            rng, shape, device, below=flag.modulus)
        if tw_ == "pair":
            tw_ = rand_twiddle(rng, shape, flag, "pair", device)
        if lane:
            new = lambda xg=xg, gt=gt, tw_=tw_: P.fused_ntt_lane(xg, gt, fc, tw_)
            plain = lambda xg=xg, gt=gt, tw_=tw_: P.lane_grouped_plain(xg, gt, fc, tw_)
        else:
            new = lambda xg=xg, gt=gt: P.fused_ntt(xg, gt, fc)
            plain = lambda xg=xg, gt=gt: P.grouped_plain(xg, gt, fc)
        old = lambda xg=xg, gt=gt, tw_=tw_: ranks(xg, gt, fc, tw_)
        want = plain()
        err = max(mismatch(new(), want), mismatch(old(), want))
        check(err <= TOL, f"{name}: a grouped kernel != plain")
        points = shape[0] * shape[1]
        bnd = grouped_bound(points, gt, "montgomery", "pair" if lane else None,
                            points if lane else 0, lane)
        kernel(name, new, plain, bnd, old=old, old_name="ranks", graph=True)
        del xg, want
    view = MontPair(twm.w.unsqueeze(2), twm.wp.unsqueeze(2))
    kernel("inter-step 256x256x256 pair", lambda: inter_step.mont_mul_bcast(fc, xm, twm),
           lambda: inter_step_mul(fc, xm, view), inter_step_bound(n24, 65536, "pair"))
    views = MontPair(twm.w.unsqueeze(2), None)
    kernel("inter-step 256x256x256 solinas", lambda: inter_step.mont_mul_bcast(fcs, xm, twms),
           lambda: inter_step_mul(fcs, xm, views), inter_step_bound(n24, 65536, "solinas"))
    # the pointwise product of cyclic_convolve at 2^24, as a CUDA-graph replay
    xa, xb = (rand_u64(rng, (n24,), device, below=flag.modulus) for _ in range(2))
    kernel("pointwise 2^24", lambda: pointwise.mont_product(fc, xa, xb, flag.montgomery_r2),
           lambda: pointwise.mont_product_plain(fc, xa, xb, flag.montgomery_r2),
           pointwise_bound(n24), graph=True)
    del xa, xb
    # the blocked transpose at the root-row shape: u64 (K9b), u32 plane (K9a)
    plane = xr.view(torch.int32)[:, :256].contiguous()
    for key, fn, x in (("K9b transpose_u64 65536x256 int64",
                        lambda v: T.transpose_u64(v, "pallas"), xr),
                       ("K9a transpose_pallas 65536x256 int32", T.transpose_pallas, plane)):
        kernel(key, lambda: fn(x), lambda: T.transpose_pallas_plain(x),
               bound(2 * x.numel() * x.element_size(), 0.0))
        out[key + " library"] = timed(lambda: x.t().contiguous(), 3, 10)
    del xm, xr, twm, twr, twms, twrs, views, plane
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
    return out, bounds, own, ab, products


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
        from sventt_tpu_torch.ops import ntt_mxu
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
    # the redesigned kernels: the tensor-core matrix kernel (87
    # instantiations: s8's 24 -- the strided form's 11: no twiddle, pair
    # and w in both directions, lazy or not, Solinas in both directions;
    # the lane form's 11; the staged lane epilogue's 2, the pair inverse,
    # lazy or not -- u7's 22 for each of its 16- and 32-column blocks,
    # no staged form, and the limb axis's 19: csrc/ntt_mxu_tc_limbs.cu,
    # s8's less Solinas and the lazy staged epilogue), the grouped register kernel (36 instantiations: INV x {Montgomery, lazy
    # Montgomery, Shoup} x {lane, leaf swizzled, leaf not} x groups of up to
    # 3 or 4 ranks) and the radix-2 register kernel (48: INV x {Montgomery,
    # lazy Montgomery, Shoup, Solinas} x {lane, leaf / mid swizzled, leaf /
    # mid not} x groups of up to 3 or 4 stages) must not spill
    entry, entries = None, {"mxu_tc_kernel": 0, "grouped_reg_kernel": 0, "radix2_reg_kernel": 0}
    for line in kernel_build["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")
        if "Compiling entry" in line:
            entry = line
            for k in entries:
                entries[k] += k in line
        elif "spill" in line and entry is not None and any(k in entry for k in entries):
            check("0 bytes spill stores, 0 bytes spill loads" in line,
                  f"a redesigned kernel spills: {entry.strip()}: {line.strip()}")
    cached = kernel_build["log"] == "(cached)"
    check(cached or entries["mxu_tc_kernel"] == 87,
          f"{entries['mxu_tc_kernel']} -Xptxas -v entries of the tensor-core kernel, not 87")
    check(cached or entries["grouped_reg_kernel"] == 36,
          f"{entries['grouped_reg_kernel']} -Xptxas -v entries of the grouped register kernel, "
          "not 36")
    check(cached or entries["radix2_reg_kernel"] == 48,
          f"{entries['radix2_reg_kernel']} -Xptxas -v entries of the radix-2 register kernel, not 48")

    count_planner_transposes()

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
    worst["pointwise"], pointwise_launches = pointwise_cases(device, rng)
    log("[rns] 32 limbs of 64-bit primes at 2^17, one launch a level for every limb")
    rns_cases(device, rng)
    worst["solinas"] = solinas_kernel_cases(device, rng)
    worst["ring"] = ring_cases(device, rng)
    torch.cuda.empty_cache()

    # 4. the slices, each with its own counts
    F, G = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR
    oracles: dict = {}
    log("[slice mxu] NTT(engine='mxu') vs the native oracle, elementwise")
    ntts_mxu, c_mxu = slice_run(
        device, [(f"mxu 2^{k}", F, G, 1 << k, dict(engine="mxu")) for k in (17, 24, 26)],
        oracles
    )
    log(f"  launches {c_mxu['launches']}, plain calls {c_mxu['plain']}")
    check(all(c_mxu["launches"]["mxu"][k] > 0 for k in ("lead", "mid", "lane")),
          "an mxu orientation of the path never ran")
    log(f"  mxu kernels: {c_mxu['mxu_kernels']} (tensor_core: csrc/ntt_mxu_tc.cu; dp4a: "
        f"csrc/ntt_mxu.cu); the planner's transposes: {c_mxu['planner_transposes']}")
    check(mxu_on_tensor_cores(c_mxu), "an mxu launch of the path ran the __dp4a kernel")
    check(c_mxu["launches"]["mxu"]["lane"] == 3 * 3 and c_mxu["planner_transposes"] == 0,
          "the mxu roots did not run on K3 alone, without transposes")
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
    log(f"  radix-2 kernels: {c_pal['pallas_kernels']} (radix2_registers: radix2_reg_kernel, "
        "csrc/ntt_radix2.cu; radix2_stages: butterfly_kernel, csrc/ntt_pallas.cu)")
    check(radix2_routed(c_pal), "a radix-2 launch ran the stage-by-stage kernel")
    del ntts_pal["pallas 2^26"], ntts_pal["pallas TEST 2^24"]
    torch.cuda.empty_cache()
    log("[route auto] NTT(engine='auto'): one modulus on the butterfly engine, one launch a "
        "level; an RNS configuration on the tensor cores; vs the native oracle")
    auto_route(device, oracles)
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
    log(f"  grouped kernels: {c_grp['pallas_kernels']} (registers: grouped_reg_kernel; ranks: "
        "grouped_ranks_kernel, csrc/ntt_grouped.cu)")
    check(c_grp["pallas_kernels"]["registers"] == lg["pallas"]["grouped"]
          + lg["pallas"]["lane_grouped"] and c_grp["pallas_kernels"]["ranks"] == 0,
          "the grouped path launched the rank-by-rank kernel")
    for c in (c_mxu, c_pal, c_grp):
        check(no_plain(c), "a plain version ran on the card")
    del ntts_grp["grouped 2^26"], ntts_grp["grouped TEST 2^24"]
    torch.cuda.empty_cache()
    log("[slice solinas] NTT(modmul='solinas') on the matrix and butterfly engines vs the "
        "native oracle, elementwise")
    sol = dict(modmul="solinas")
    ntts_sol, c_sol = slice_run(
        device,
        [(f"mxu solinas 2^{k}", F, G, 1 << k, dict(engine="mxu", **sol)) for k in (17, 24, 26)]
        + [(f"pallas solinas 2^{k}", F, G, 1 << k, dict(engine="pallas", **sol))
           for k in (17, 24, 26)],
        oracles,
    )
    log(f"  launches {c_sol['launches']}, plain calls {c_sol['plain']}")
    ls = c_sol["launches"]
    check(all(ntt.fc.modmul == "solinas" for ntt in ntts_sol.values()), "modmul != solinas")
    check(ls["mxu"]["lead"] > 0 and ls["mxu"]["mid"] > 0
          and all(ls["pallas"][k] > 0 for k in ("leaf", "mid", "lane")),
          "a kernel of the Solinas paths never ran")
    check(mxu_on_tensor_cores(c_sol) and ls["mxu"]["lane"] == 3 * 3
          and c_sol["planner_transposes"] == 0,
          "the mxu Solinas roots did not run on K3 on the tensor cores, without transposes")
    check(radix2_routed(c_sol), "the Solinas radix-2 path's launches ran the wrong kernels")
    del ntts_sol["mxu solinas 2^26"], ntts_sol["pallas solinas 2^26"]
    torch.cuda.empty_cache()
    log("[slice solinas max_r=3] NTT(engine='pallas', max_r=3, modmul='solinas'): radix-2, "
        "as in JAX")
    _, c_sr = slice_run(device, [("grouped solinas 2^24", F, G, 1 << 24,
                                  dict(engine="pallas", max_r=3, **sol))], oracles)
    log(f"  launches {c_sr['launches']}, plain calls {c_sr['plain']}")
    lr = c_sr["launches"]["pallas"]
    check(lr["grouped"] == 0 and lr["lane_grouped"] == 0, "Solinas max_r=3 launched K7/K8")
    check(all(lr[k] > 0 for k in ("leaf", "mid", "lane")), "Solinas max_r=3 ran no radix-2")
    check(radix2_routed(c_sr), "Solinas max_r=3: the radix-2 launches ran the wrong kernels")
    log("[slice solinas six_step] a row subtree (4096 = 16 x 256): the transpose fallback's "
        "inter-step pass under Solinas")
    ntts_ss, c_ss = slice_run(device, [("pallas solinas six_step 2^24", F, G, 1 << 24,
                                        dict(engine="pallas", strategy="six_step", **sol))],
                              oracles)
    log(f"  launches {c_ss['launches']}, plain calls {c_ss['plain']}")
    check(c_ss["launches"]["inter_step"]["inter_step"] > 0, "the Solinas inter-step pass never ran")
    check(radix2_routed(c_ss), "Solinas six_step: the radix-2 launches ran the wrong kernels")
    check("transposed row subtree" in ntts_ss["pallas solinas six_step 2^24"].describe(),
          "the six_step plan has no row subtree")
    for c in (c_sol, c_sr, c_ss):
        check(no_plain(c), "a plain version ran on the card")
    del ntts_ss
    torch.cuda.empty_cache()
    log("[path mxu_ntt_lane] K3 with the fused twiddle on the 2^24 root shape vs transpose + "
        "K1 (transposed twiddle) + transpose")
    c_lane = lane_path(device, rng)
    log(f"  launches {c_lane['launches']}, plain calls {c_lane['plain']}")
    check(c_lane["launches"]["mxu"]["lane"] > 0 and mxu_on_tensor_cores(c_lane),
          "mxu_ntt_lane never launched, or not on the tensor cores")
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
        ("mxu 2^24 D=4 ring", F, G, 1 << 24, dict(engine="mxu"), m4, "ring"),
        ("auto 2^24 D=4 ring", F, G, 1 << 24, {}, m4, "ring"),
        ("grouped 2^24 D=8 ring", F, G, 1 << 24, dict(engine="pallas", max_r=3), m8, "ring"),
        ("pallas TEST 2^24 D=4 ring", T, TG, 1 << 24, pal, m4, "ring"),
        ("pallas 2^26 D=8 ring", F, G, 1 << 26, pal, m8, "ring"),
        ("pallas 2^24 (2, 4) dcn x ici xla", F, G, 1 << 24, pal, logical_mesh(device, 8, (2, 4)),
         "xla"),
        # equal to the oracle, so to the single-device Solinas transform above
        ("pallas solinas 2^24 D=4 ring", F, G, 1 << 24, dict(engine="pallas", modmul="solinas"),
         m4, "ring"),
    ], oracles)
    check(c_dist["mxu 2^24 D=4 ring"]["launches"]["mxu"]["mid"] > 0, "the mxu path ran no K2")
    check(mxu_on_tensor_cores(c_dist["mxu 2^24 D=4 ring"]),
          "the distributed mxu path launched the __dp4a kernel")
    check(c_dist["grouped 2^24 D=8 ring"]["launches"]["pallas"]["grouped"] > 0,
          "the grouped path ran no K7")
    check(c_dist["grouped 2^24 D=8 ring"]["pallas_kernels"]["ranks"] == 0,
          "the distributed grouped path launched the rank-by-rank kernel")
    check(c_dist["auto 2^24 D=4 ring"]["mxu_kernels"]["tensor_core"] == 0,
          "the distributed default path launched the matrix kernel")
    for label, c in c_dist.items():
        if label.startswith(("pallas", "auto")):
            check(c["launches"]["pallas"]["leaf"] + c["launches"]["pallas"]["mid"] > 0
                  and radix2_routed(c), f"{label}: the radix-2 launches ran the wrong kernels")
    log("[distributed 2^28] 8 logical shards, ring and overlap, vs the single-device six_step "
        "transform")
    dist_2p28(device)
    multi_card(oracles)
    from sventt_tpu_torch.plan import NttConfig
    from sventt_tpu_torch.utils.fill import device_fill

    t_apps = time.perf_counter()
    log("[apps pipeline] magic_series_count(m) mod TEST_MODULUS at the reference's scale, "
        "native generators, the default convolver; against the exact counts mod N")
    app_secs = pipeline_run(device, smi)
    log("[apps kinnaes] kinnaes_magic_series_count on the card at m = 100 and 101, two widths; "
        "against the exact counts mod N")
    app_secs.update(kinnaes_run(device, smi))
    log("[slice jnp] NTT(engine='jnp') and mixed plan_spec trees vs the native oracle, "
        "elementwise")
    ntts_jnp = jnp_paths(device, oracles)
    log("[distributed jnp] DistributedNTT(engine='jnp'), 4 logical shards, comm ring, vs the "
        "native oracle: the row leaf along axis 1, no local transpose")
    dist_run(device, [("jnp 2^24 D=4 ring", F, G, 1 << 24, dict(engine="jnp"), m4, "ring")],
             oracles)
    log("[step helpers] forward_step / inverse_step captured in a CUDA graph; DistributedNTT's "
        "against its compute calls")
    step_ms = step_helpers(device, ntts_mxu["mxu 2^17"],
                           NttConfig(F, G, 1 << 24, strategy="six_step", engine="jnp"), m4, smi)
    for label in ("jnp 2^17", "jnp 2^24"):
        ntt = ntts_jnp[label]
        x = device_fill(ntt.get_m(), F, device)
        step_ms[f"{label} forward"] = timed(lambda: ntt.compute_forward(x), 1, 5)
        step_ms[f"{label} inverse"] = timed(lambda: ntt.compute_inverse(x), 1, 5)
    del ntts_jnp, x
    log(f"[apps times] {smi}; seconds (pipeline: in all, native generators alone): "
        + "; ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" if isinstance(v, tuple) else f"{k} {v:.3f}"
                    for k, v in app_secs.items()))
    log("  ms by CUDA events (median): "
        + "; ".join(f"{k} {v:.4f}" for k, v in step_ms.items()))
    log(f"  the phase took {time.perf_counter() - t_apps:.1f} s")
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    log("[autotune] the full race of the flagship transform at 2^17 and 2^24 (three engines, "
        "the playoff, the winner verified elementwise), the cache hit, the winner beside the "
        "untuned config; NTT(tune=True) from the shipped cache vs the native oracle")
    tune_ms = autotune_phase(device, smi, oracles)
    log("[donate] the default and the mxu forward with and without donate_input at 2^26 and "
        "2^28: outputs and peak allocations")
    donate_phase(device, smi, oracles)
    log("[profiling] phase_breakdown of the 2^24 mxu and pallas plans; trace")
    profiling_phase(device, smi, {**ntts_mxu, **ntts_pal})
    log("[distributed partial axis] the (2, 4) ('dcn', 'ici') logical mesh, axis 'ici' (the "
        "vector replicated over 'dcn'), 2^24, comm xla and overlap, vs the native oracle")
    m24 = logical_mesh(device, 8, (2, 4))
    dist_run(device, [(f"mxu 2^24 (2, 4) axis ici {comm}", F, G, 1 << 24, dict(engine="mxu"),
                       m24, comm, "ici")
                      for comm in ("xla", "overlap")], oracles)
    log(f"  the phases [autotune] to [distributed partial axis] took "
        f"{time.perf_counter() - t_new:.1f} s; autotune ms: "
        + "; ".join(f"{k} {v:.4f}" for k, v in tune_ms.items()))
    del oracles
    torch.cuda.empty_cache()

    # 5. times
    ms, bounds, own, ab, products = times(device, {**ntts_mxu, **ntts_pal, **ntts_grp, **ntts_sol},
                                          rng)
    log(f"[times] median ms by CUDA events on {smi} (distributed: logical shards of this "
        "card, the schedule's cost on one card's memory, not scaling):")
    for k, v in ms.items():
        extra = f"   (bound {bounds[k][0]:.4f} ms, {bounds[k][1]})" if k in bounds else ""
        if k in own:
            extra += f"   (the scheme's own products: {own[k]:.4f} ms)"
        log(f"  {k}: {v:.4f}{extra}")
    log("[A/B] the matrix NTT on the int8 tensor cores (csrc/mxu_tc.cuh: s8 "
        "csrc/ntt_mxu_tc.cu, u7 and K11 csrc/ntt_mxu_tc_u7.cu) against the __dp4a kernel "
        "(csrc/ntt_mxu.cu), timed in turns dp4a, tc, tc, dp4a; int8 TOP/s of the scheme's own "
        "products (s8 64, u7 100 multiply-adds a point per unit of m):")
    for k, (old_name, o1, n1, n2, o2) in ab.items():
        if old_name != "dp4a":
            continue
        m = 128 if k.startswith("K11") else 512 if k.startswith("K1 lead 512") else 256
        points = 1 << (22 if k.startswith("K11") else 17 if "(2^17)" in k else 24)
        macs = SCHEME_MACS["u7" if k.startswith("K11") or k.endswith("u7") else "s8"]
        tops = [2 * macs * m * points / (v * 1e-3) / 1e12 for v in (ms[k], ms[k + " dp4a"])]
        own_bound = f", {100 * own[k] / ms[k]:.1f}% of its own {own[k]:.4f} ms" if k in own else ""
        log(f"  {k}: dp4a {o1:.4f} / {o2:.4f} ms, tensor cores {n1:.4f} / {n2:.4f} ms: "
            f"{ms[k + ' dp4a'] / ms[k]:.2f}x; bound {bounds[k][0]:.4f} ms ({bounds[k][1]}); "
            f"int8 {tops[0]:.1f} TOP/s ({100 * bounds[k][0] / ms[k]:.1f}% of the bound{own_bound}) "
            f"against {tops[1]:.1f}")
    log("[A/B] the u7 block's geometry at m = 256 (the rule against the other) and its K3 "
        "pair-inverse epilogues, CUDA-graph replays in turns other, rule, rule, other:")
    for k, (old_name, o1, n1, n2, o2) in ab.items():
        if k.startswith("u7 "):
            log(f"  {k}: {old_name} {o1:.4f} / {o2:.4f} ms, the rule {n1:.4f} / {n2:.4f} ms: "
                f"{ms[f'{k} {old_name}'] / ms[k]:.3f}x")
    log("[A/B] the mxu root step: K3 with the twiddle fused (mxu_ntt_lane) against the "
        "sandwich of transpose, K1 (transposed twiddle) and transpose, CUDA-graph replays in "
        "turns sandwich, K3, K3, sandwich; and K3's staged epilogue (the pair inverse's) "
        "against the stores from the fragment (fragment, staged, staged, fragment):")
    for k, (old_name, o1, n1, n2, o2) in ab.items():
        if old_name not in ("sandwich", "fragment") or k.startswith("u7 "):
            continue
        new_name = "K3" if old_name == "sandwich" else "staged"
        log(f"  {k}: {old_name} {o1:.4f} / {o2:.4f} ms, {new_name} {n1:.4f} / {n2:.4f} ms: "
            f"{ms[f'{k} {old_name}'] / ms[k]:.3f}x")
    log("[A/B] the grouped kernel K7 / K8 (csrc/ntt_grouped.cu): the register kernel against "
        "the rank-by-rank one, CUDA-graph replays in turns ranks, registers, registers, ranks:")
    for k, (old_name, o1, n1, n2, o2) in ab.items():
        if old_name != "ranks":
            continue
        b_ms, b_by = bounds[k]
        log(f"  {k}: ranks {o1:.4f} / {o2:.4f} ms, registers {n1:.4f} / {n2:.4f} ms: "
            f"{ms[k + ' ranks'] / ms[k]:.2f}x; bound {b_ms:.4f} ms ({b_by}): registers "
            f"{100 * b_ms / ms[k]:.1f}% of it, ranks {100 * b_ms / ms[k + ' ranks']:.1f}%")
    log("[A/B] the radix-2 butterfly kernel K4 / K5 / K6: the register kernel (csrc/ntt_radix2.cu) "
        "against the stage-by-stage one (csrc/ntt_pallas.cu), CUDA-graph replays in turns stages, "
        "registers, registers, stages:")
    for k, (old_name, o1, n1, n2, o2) in ab.items():
        if old_name != "stages":
            continue
        b_ms, b_by = bounds[k]
        points = {"(2^17)": 1 << 17, "(2^26)": 1 << 26}.get(k.split()[-1], 1 << 24)
        floor = ("" if products[k] is None else
                 "; Montgomery product floor {:.4f}-{:.4f} ms ({:g} a point at {}-{} T/s)".format(
                     *(products[k] * points / r * 1e3 for r in MONT_RATE[::-1]), products[k],
                     *(r / 1e12 for r in MONT_RATE)))
        log(f"  {k}: stages {o1:.4f} / {o2:.4f} ms, registers {n1:.4f} / {n2:.4f} ms: "
            f"{ms[k + ' stages'] / ms[k]:.2f}x; bound {b_ms:.4f} ms ({b_by}): registers "
            f"{100 * b_ms / ms[k]:.1f}% of it, stages {100 * b_ms / ms[k + ' stages']:.1f}%{floor}")
    # across 8 cards each would send 7/8 of its 2^21-point shard over NVLink
    nvlink = 7 / 8 * (1 << 21) * 8 / 450e9 * 1e3
    log(f"  K10 2^24 D=8 across 8 cards: bound {nvlink:.4f} ms by NVLink bytes "
        "(450 GB/s each way per card); not measured")
    log("[breakdown] device time by kernel, torch.profiler")
    from sventt_tpu_torch.parallel import DistributedNTT
    from sventt_tpu_torch.plan import NttConfig
    from sventt_tpu_torch.utils.fill import device_fill

    runs = {}
    for label in ("mxu 2^24", "pallas 2^24", "pallas 2^17", "grouped 2^24", "grouped 2^17"):
        ntt = {**ntts_mxu, **ntts_pal, **ntts_grp}[label]
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
    for k in ("grouped", "lane_grouped"):
        lp[k] = c_grp["launches"]["pallas"][k]
    lt = c_tr["launches"]["transpose"]
    wm, wp, wt = worst["mxu"], worst["pallas"], worst["transpose"]
    k10_launches = c_dist["pallas 2^24 D=8 ring"]["launches"]["ring"]["ring"]
    record = {"kernels": [
        entry("K1 s8 matrix NTT, lead, int8 tensor cores (mxu_ntt)", "K1 lead 256x65536 pair",
              "ntt_mxu_tc.cu", "sventt_tpu/ops/ntt_mxu.py:680", lm["lead"], wm["lead"]),
        entry("K2 s8 matrix NTT, mid, int8 tensor cores (mxu_ntt_mid)", "K2 mid 256x256x256 pair",
              "ntt_mxu_tc.cu", "sventt_tpu/ops/ntt_mxu.py:680", lm["mid"], wm["mid"]),
        entry("K3 s8 matrix NTT, lane, int8 tensor cores, fused twiddle (mxu_ntt_lane; the mxu "
              "root, redesigned)", "K3 lane 65536x256 pair", "ntt_mxu_tc.cu",
              "sventt_tpu/ops/ntt_mxu.py:527", lm["lane"], wm["lane"]),
        entry("K4 radix-2 stages, leaf (fused_ntt; register kernel)", "K4 leaf 256x65536",
              "ntt_radix2.cu", "sventt_tpu/ops/ntt_pallas.py:1154", lp["leaf"], wp["leaf"]),
        entry("K5 radix-2 stages, mid (fused_ntt_mid; register kernel)", "K5 mid 256x256x256 pair",
              "ntt_radix2.cu", "sventt_tpu/ops/ntt_pallas.py:1188", lp["mid"], wp["mid"]),
        entry("K6 radix-2 stages, lane (fused_ntt_lane; register kernel)", "K6 lane 65536x256 pair",
              "ntt_radix2.cu", "sventt_tpu/ops/ntt_pallas.py:911", lp["lane"], wp["lane"]),
        entry("K7 radix-2^R groups, leaf (fused_ntt_grouped)", "K7 leaf 256x65536 r=3",
              "ntt_grouped.cu", "sventt_tpu/ops/ntt_pallas.py:688", lp["grouped"],
              wp["grouped"]),
        entry("K8 radix-2^R groups, lane (fused_ntt_lane, grouped)",
              "K8 lane 65536x256 r=3 pair", "ntt_grouped.cu",
              "sventt_tpu/ops/ntt_pallas.py:1124", lp["lane_grouped"], wp["lane_grouped"]),
        entry("K9a blocked transpose, one plane (transpose_pallas)",
              "K9a transpose_pallas 65536x256 int32", "transpose.cu",
              "sventt_tpu/ops/transpose.py:54", lt["plane"], wt["plane"]),
        entry("K9b blocked transpose, u64 (transpose_u64 / transpose01_u64)",
              "K9b transpose_u64 65536x256 int64", "transpose.cu",
              "sventt_tpu/ops/transpose.py:87", lt["pair"], wt["pair"]),
        entry("inter-step multiply of the transpose fallback (an XLA pass there, "
              "not a Pallas kernel)", "inter-step 256x256x256 pair", "inter_step.cu",
              "sventt_tpu/plan/planner.py:376", c_grp["launches"]["inter_step"]["inter_step"],
              worst["inter_step"]),
        entry("K10 ring all-to-all of slabs (ring_all_to_all / canonical_all_to_all)",
              "K10 ring 2^24 D=8 8x(512x4096) split 1", "ring.cu",
              "sventt_tpu/parallel/ring.py:113", k10_launches, worst["ring"]),
    ]}
    for scheme in ("u7", "s8b"):
        ls, ws = c_schemes[scheme]["launches"]["mxu"], worst[f"mxu {scheme}"]
        for k, orient, fn, key, line in (
            ("K1", "lead", "mxu_ntt", "K1 lead 256x65536 pair", 680),
            ("K2", "mid", "mxu_ntt_mid", "K2 mid 256x256x256 pair", 680),
            ("K3", "lane", "mxu_ntt_lane", "K3 lane 65536x256", 527),
        ):
            check(ntt_mxu.kernel_for(scheme, orient) == "tensor_core", f"{scheme} {orient} route")
            src = "ntt_mxu_tc_u7.cu" if scheme == "u7" else "ntt_mxu_tc.cu"
            record["kernels"].append(entry(
                f"{k} {scheme} matrix NTT, {orient}, int8 tensor cores ({fn}, "
                f"make_mxu_tables(scheme={scheme!r}))",
                f"{key} {scheme}", src, f"sventt_tpu/ops/ntt_mxu.py:{line}",
                ls[orient], ws[orient]))
    ws, lsol = worst["solinas"], c_sol["launches"]
    for name, key, src, line, launches, err in (
        ("K1 s8 matrix NTT, lead, Solinas twiddle (mxu_ntt, modmul='solinas')",
         "K1 lead 256x65536 solinas", "ntt_mxu_tc.cu", "ntt_mxu.py:680", lsol["mxu"]["lead"],
         ws["lead"]),
        ("K2 s8 matrix NTT, mid, Solinas twiddle (mxu_ntt_mid, modmul='solinas')",
         "K2 mid 256x256x256 solinas", "ntt_mxu_tc.cu", "ntt_mxu.py:680", lsol["mxu"]["mid"],
         ws["mid"]),
        ("K4 radix-2 stages, leaf, Solinas (fused_ntt, modmul='solinas')",
         "K4 leaf 256x65536 solinas", "ntt_radix2.cu", "ntt_pallas.py:1154", lsol["pallas"]["leaf"],
         ws["leaf"]),
        ("K5 radix-2 stages, mid, Solinas stages and twiddle (fused_ntt_mid, modmul='solinas')",
         "K5 mid 256x256x256 solinas", "ntt_radix2.cu", "ntt_pallas.py:1188", lsol["pallas"]["mid"],
         ws["pallas mid"]),
        ("K6 radix-2 stages, lane, Solinas stages and prologue (fused_ntt_lane, modmul='solinas')",
         "K6 lane 65536x256 solinas", "ntt_radix2.cu", "ntt_pallas.py:911", lsol["pallas"]["lane"],
         ws["lane"]),
    ):
        record["kernels"].append(entry(name, key, src, f"sventt_tpu/ops/{line}", launches, err))
    record["kernels"].append(entry(
        "inter-step multiply of the transpose fallback, Solinas (an XLA pass there, not a "
        "Pallas kernel)", "inter-step 256x256x256 solinas", "inter_step.cu",
        "sventt_tpu/plan/planner.py:376", c_ss["launches"]["inter_step"]["inter_step"],
        ws["inter_step"]))
    record["kernels"].append(entry(
        "pointwise product of cyclic_convolve (an XLA pass there, not a Pallas kernel)",
        "pointwise 2^24", "pointwise.cu", "sventt_tpu/apps/convolve.py:38", pointwise_launches,
        worst["pointwise"]))
    record["kernels"].append(entry(
        "K11 fused u7 prototype, 128 points (mxu_fused_ntt; the u7 lead form on the int8 "
        "tensor cores)", "K11 fused 128x32768", "ntt_mxu_tc_u7.cu", "experimental/mxu_fused_kernel.py:91",
        c_schemes["fused"]["launches"]["fused"]["fused"], worst["fused"]))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

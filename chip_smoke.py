#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the CUDA kernels and the native golden oracle, from this checkout;
3. kernel vs plain: the s8 matrix-NTT kernel (lead and mid orientations)
   against its plain PyTorch version on the same card tensors, bitwise, at
   the main path's shapes, with every twiddle mode, both directions, both
   moduli, a ragged batch and the m = 1024 crafted plane-minimizer input;
4. slice: the flagship NTT at n = 2^17, 2^24 and 2^26, forward and inverse,
   elementwise against the native oracle, with an exact roundtrip; the
   kernel launch counts of that run must be > 0 for both orientations and
   the plain-version counts 0;
5. times: CUDA-event medians of the transforms and of the kernels alone
   beside their plain versions.

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


def kernel_cases(device, rng):
    """Kernel vs plain at the main path's shapes; returns the largest
    mismatch per orientation."""
    import numpy as np

    from sventt_tpu_torch.field.golden import GoldenNTT
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
    from sventt_tpu_torch.field.modulus import (
        FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, TEST_GENERATOR, TEST_MODULUS, Modulus,
    )
    from sventt_tpu_torch.ops import ntt_mxu

    flag = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    test = Modulus(TEST_MODULUS, TEST_GENERATOR)
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
        # off the main path: the m < 4 digit loads and a tiny ragged grid
        ("K1 lead 2x5 none fwd", flag, False, "lead", (2, 5), None),
        ("K2 mid 3x8x7 pair inv TEST (lazy)", test, True, "mid", (3, 8, 7), "pair"),
    ]
    worst = {"lead": 0, "mid": 0}
    for name, mod, inverse, orient, shape, mode in cases:
        fc = FieldConsts.from_modulus(mod)
        mid = orient == "mid"
        m = shape[1] if mid else shape[0]
        t = ntt_mxu.make_mxu_tables(mod, m, inverse=inverse, device=device)
        x = rand_u64(rng, shape, device)
        tw = None
        if mode is not None:
            tw_shape = (shape[0], m) if mid else shape
            tw = rand_twiddle(rng, tw_shape, mod, mode, device)
        call = ntt_mxu.mxu_ntt_mid if mid else ntt_mxu.mxu_ntt
        got = call(x, t, fc, tw)
        want = ntt_mxu.mxu_plain(x, t, fc, tw, mid=mid)
        sync(device)
        err = mismatch(got, want)
        worst[orient] = max(worst[orient], err)
        log(f"  {name}: max_abs_err {err} (lazy={fc.lazy})")
        check(err <= TOL, f"{name}: kernel != plain")
    # m = 1024: the crafted input, kernel vs plain vs the golden model
    fc = FieldConsts.from_modulus(flag)
    t = ntt_mxu.make_mxu_tables(flag, 1024, inverse=False, device=device)
    xc = crafted_1024(flag, t)
    x = from_numpy(xc.reshape(1024, 1), device)
    got = ntt_mxu.mxu_ntt(x, t, fc)
    want = ntt_mxu.mxu_plain(x, t, fc)
    sync(device)
    err = mismatch(got, want)
    worst["lead"] = max(worst["lead"], err)
    golden = GoldenNTT(1024, flag).forward([int(v) % flag.modulus for v in xc])
    check(err <= TOL, "m=1024 crafted: kernel != plain")
    check([int(v) for v in to_numpy(got)[:, 0]] == golden, "m=1024 crafted: != golden")
    log(f"  K1 lead 1024x1 crafted plane minimizer: max_abs_err {err}, == golden")
    return worst


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def slice_run(device, sizes):
    """The flagship NTT at each size against the native oracle.  Returns
    the kernel-launch and plain-call counts of the whole run."""
    import numpy as np

    from sventt_tpu_torch import native
    from sventt_tpu_torch.field.limb import from_numpy, to_numpy
    from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS
    from sventt_tpu_torch.ops import ntt_mxu
    from sventt_tpu_torch.plan import NTT, NttConfig
    from sventt_tpu_torch.utils.fill import host_fill

    ntts = {}
    for n in sizes:
        t0 = time.perf_counter()
        ntts[n] = NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n), device=device)
        sync(device)
        log(f"  n=2^{n.bit_length() - 1}: tables built in {time.perf_counter() - t0:.2f} s; plan:")
        for line in ntts[n].describe().splitlines():
            log(f"    {line}")
    ntt_mxu.reset_counts()
    for n in sizes:
        ntt = ntts[n]
        x = host_fill(n, FLAGSHIP_MODULUS)
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
        want_f = native.golden_forward(x, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
        want_i = native.golden_inverse(x, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
        osecs = time.perf_counter() - t0
        bad_f = int(np.count_nonzero(fwd_h != want_f))
        bad_i = int(np.count_nonzero(inv_h != want_i))
        bad_r = int(np.count_nonzero(back_h != x))
        log(
            f"  n=2^{n.bit_length() - 1}: forward {bad_f} / inverse {bad_i} elements "
            f"differ from the oracle, roundtrip {bad_r} differ "
            f"(3 transforms {secs * 1e3:.1f} ms incl. first-call set-up; oracle {osecs:.1f} s)"
        )
        check(bad_f == 0 and bad_i == 0 and bad_r == 0, f"n={n}: mismatch")
    counts = {"launches": dict(ntt_mxu.LAUNCHES), "plain": dict(ntt_mxu.PLAIN_CALLS)}
    return ntts, counts


def times(device, ntts, rng):
    """CUDA-event medians: transforms, and each kernel vs its plain version."""
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, Modulus
    from sventt_tpu_torch.ops import ntt_mxu
    from sventt_tpu_torch.utils.fill import device_fill

    out = {}
    for n in sorted(ntts):
        if n > 1 << 24:
            continue
        ntt = ntts[n]
        x = device_fill(n, FLAGSHIP_MODULUS, device)
        f = ntt.compute_forward(x)
        out[f"fwd_2^{n.bit_length() - 1}"] = timed(lambda: ntt.compute_forward(x), 3, 10)
        out[f"inv_2^{n.bit_length() - 1}"] = timed(lambda: ntt.compute_inverse(f), 3, 10)
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    # the 2^24 plan's root row step (lead, transposed twiddle) and inner row
    # step (mid, (256, 256) twiddle rows over 256 columns)
    t = ntt_mxu.make_mxu_tables(mod, 256, inverse=False, device=device)
    xl = rand_u64(rng, (256, 1 << 16), device, below=mod.modulus)
    twl = rand_twiddle(rng, (256, 1 << 16), mod, "pair", device)
    xm = rand_u64(rng, (256, 256, 256), device, below=mod.modulus)
    twm = rand_twiddle(rng, (256, 256), mod, "pair", device)
    out["K1_lead_256x65536_pair"] = timed(lambda: ntt_mxu.mxu_ntt(xl, t, fc, twl), 3, 10)
    out["K1_lead_256x65536_pair_plain"] = timed(
        lambda: ntt_mxu.mxu_plain(xl, t, fc, twl), 1, 3
    )
    out["K2_mid_256x256x256_pair"] = timed(lambda: ntt_mxu.mxu_ntt_mid(xm, t, fc, twm), 3, 10)
    out["K2_mid_256x256x256_pair_plain"] = timed(
        lambda: ntt_mxu.mxu_plain(xm, t, fc, twm, mid=True), 1, 3
    )
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from sventt_tpu_torch import _build, native
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
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    kernel_build = dict(_build.LAST_BUILD)
    native.load()
    log(f"[build] kernels + oracle in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernel_build['seconds']:.1f} s)")
    for line in kernel_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    # 3. kernel vs plain
    rng = np.random.default_rng(20261016)
    log("[kernel vs plain] bitwise, tolerance 0")
    worst = kernel_cases(device, rng)
    torch.cuda.empty_cache()

    # 4. the slice
    log("[slice] flagship NTT vs the native oracle, elementwise")
    ntts, counts = slice_run(device, [1 << 17, 1 << 24, 1 << 26])
    log(f"  kernel launches {counts['launches']}, plain calls {counts['plain']}")
    check(all(v > 0 for v in counts["launches"].values()), "a kernel orientation never ran")
    check(all(v == 0 for v in counts["plain"].values()), "the plain version ran on the card")
    del ntts[1 << 26]
    torch.cuda.empty_cache()

    # 5. times
    ms = times(device, ntts, rng)
    log(f"[times] median ms by CUDA events on {smi}:")
    for k, v in ms.items():
        log(f"  {k}: {v:.4f}")

    record = {"kernels": [
        {"name": "K1 s8 matrix NTT, lead orientation (mxu_ntt)", "route": "cuda",
         "source": "sventt_tpu_torch/csrc/ntt_mxu.cu",
         "replaces": "sventt_tpu/ops/ntt_mxu.py:574",
         "launches": counts["launches"]["lead"], "max_abs_err": worst["lead"],
         "ms": ms["K1_lead_256x65536_pair"], "plain_ms": ms["K1_lead_256x65536_pair_plain"]},
        {"name": "K2 s8 matrix NTT, mid orientation (mxu_ntt_mid)", "route": "cuda",
         "source": "sventt_tpu_torch/csrc/ntt_mxu.cu",
         "replaces": "sventt_tpu/ops/ntt_mxu.py:634",
         "launches": counts["launches"]["mid"], "max_abs_err": worst["mid"],
         "ms": ms["K2_mid_256x256x256_pair"],
         "plain_ms": ms["K2_mid_256x256x256_pair_plain"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What bounds the butterfly kernels on one card: the grouped register
kernel (csrc/ntt_grouped.cu) and the radix-2 register kernel
(csrc/ntt_radix2.cu).

    python3 tools/grouped_ablation.py [--reps N]

Builds, besides the port's kernels, ablated copies of them and one
microbenchmark, each with nvcc into a temporary directory, and times them
at the 2^24 plans' shapes (K7 256 x 65536, K8 65536 rows of 256 with the
pair twiddle, max_r 3; K4 256 x 65536, K5 (256, 256, 256) with the pair
twiddle, K6 65536 rows of 256 with the pair twiddle, and without a
twiddle ("K6 bare"); forward, K6 also inverse) in one call:

* "as built": the kernel itself;
* "no products": every stage, constant and table multiply replaced by an
  XOR (field.cuh twiddle_mul), the rest unchanged -- the time of the
  butterflies' additions, the exchanges, the copies and the indexing (the
  inter-step twiddle of K5, K6 and K8 keeps its product);
* "no device memory": the data's reads from a fixed address and its
  stores never taken (a store the compiler cannot drop) -- the tile of K7
  / K8, the first group's points of K4 / K5, every read and write of x
  and out of K6 (its row-end tile copies included) -- the time without
  the data's HBM traffic (the inter-step twiddle is still read);
* K6's row end (the group of row unit 1) "end direct": each thread's 2^R
  neighbouring words straight from / to device memory, 8 bytes an access,
  instead of through the tile; "end vector": the same, 16 bytes an access;
  "twiddle direct": K6's inverse twiddle read straight from device memory
  into registers before the last group's writes, as the forward reads
  its own, instead of staged in shared memory (the forward as built);
* the Montgomery product alone (field.cuh mont_mul), 1, 4 and 8
  independent chains a thread, 8 blocks of 256 threads an SM: the card's
  rate of the product the kernels are made of.

The ablated kernels compute wrong results on purpose; only the unablated
kernels and the end variants, which compute the same function, are checked
(against the plain version).  CUDA-event medians of ``--reps`` CUDA-graph
replays (device time), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402

MULBENCH = r"""
#include <cuda_runtime.h>
#include "field.cuh"
template <int ILP>
__global__ void __launch_bounds__(256) chains(u64 *out, u64 N, u64 w, u64 wp, int iters) {
  u64 v[ILP];
  for (int i = 0; i < ILP; ++i) v[i] = threadIdx.x * 7919ull + blockIdx.x * 104729ull + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) v[i] = mont_mul(v[i], w, wp, N, false);
  }
  u64 s = 0;
  for (int i = 0; i < ILP; ++i) s ^= v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float mont_chains(int ilp, int blocks, int iters, unsigned long long N,
                             unsigned long long w, unsigned long long wp) {
  u64 *out;
  cudaMalloc(&out, (size_t)blocks * 256 * 8);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = 0;
  for (int rep = 0; rep < 2; ++rep) {  // the second run is timed
    cudaEventRecord(a);
    if (ilp == 1) chains<1><<<blocks, 256>>>(out, N, w, wp, iters);
    if (ilp == 4) chains<4><<<blocks, 256>>>(out, N, w, wp, iters);
    if (ilp == 8) chains<8><<<blocks, 256>>>(out, N, w, wp, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
  }
  cudaFree(out);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}
"""


#: Copies that change K6's row end or twiddle reads alone: they compute
#: the same function, so they are checked, and only K6 is timed on them.
K6_ONLY = ("end direct", "end vector", "twiddle direct")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"ablation anchor not found in the kernel source: {old[:60]!r}")
    return text.replace(old, new)


def _build_all(out_dir: str) -> dict:
    """nvcc of each ablated copy and the microbenchmark, all at once;
    returns {name: library path}."""
    from sventt_tpu_torch import _build

    grouped = open(os.path.join(_build.CSRC, "ntt_grouped.cu")).read()
    radix2 = open(os.path.join(_build.CSRC, "ntt_radix2.cu")).read()
    field = open(os.path.join(_build.CSRC, "field.cuh")).read()
    never = "if (v[k] == 0x123456789ull) "  # a store the compiler cannot drop
    lane_load = "for (int k = 0; k < K; ++k) v[k] = ok ? (u64)X[w0 + k * L] : 0ull;"
    lane_store = "for (int k = 0; k < K; ++k) O[w0 + k * L] = (long long)v[k];"
    copy_in = "cp_async8(T + slot<true>(i), X + (i < words ? i : 0), i < words);"
    copy_out = "O[i] = (long long)T[slot<true>(i)];"
    radix2_no_mem = radix2
    for old, new in (
        ("for (int k = 0; k < K; ++k) v[k] = ok ? (u64)src[k * Lsm] : 0ull;",
         "for (int k = 0; k < K; ++k) v[k] = ok ? (u64)__ldg(p.x + k) : 0ull;"),
        ("for (int k = 0; k < K; ++k) dst[k * Lsm] = (long long)v[k];",
         "for (int k = 0; k < K; ++k)\n          " + never + "dst[k * Lsm] = (long long)v[k];"),
        (lane_load, "for (int k = 0; k < K; ++k) v[k] = ok ? (u64)__ldg(p.x + k) : 0ull;"),
        (lane_store, "for (int k = 0; k < K; ++k)\n          " + never + "O[w0 + k * L] = (long long)v[k];"),
        (copy_in, "cp_async8(T + slot<true>(i), X, i < words);"),
        (copy_out, "{ const u64 v = T[slot<true>(i)]; if (v == 0x123456789ull) O[i] = (long long)v; }"),
    ):
        radix2_no_mem = _sub(radix2_no_mem, old, new)
    # K6's row end straight from registers: no group runs on the tile's copies
    direct = _sub(radix2, "const bool end = p.ngroups > 1 && log2L == 0;", "const bool end = false;")
    vector = _sub(_sub(direct, "#pragma unroll\n      " + lane_load, (
        "if (L == 1) {  // 2^R neighbouring words, 16-byte aligned\n"
        "        const ulonglong2 *s2 = reinterpret_cast<const ulonglong2 *>(X + (ok ? w0 : 0));\n"
        "#pragma unroll\n"
        "        for (int k = 0; k < K; k += 2) {\n"
        "          const ulonglong2 e = ok ? s2[k / 2] : make_ulonglong2(0, 0);\n"
        "          v[k] = e.x;\n"
        "          v[k + 1] = e.y;\n"
        "        }\n"
        "      } else {\n"
        "#pragma unroll\n"
        "        " + lane_load + "\n"
        "      }")), "#pragma unroll\n        " + lane_store, (
        "if (L == 1) {\n"
        "          longlong2 *d2 = reinterpret_cast<longlong2 *>(O + w0);\n"
        "#pragma unroll\n"
        "          for (int k = 0; k < K; k += 2) d2[k / 2] = make_longlong2(v[k], v[k + 1]);\n"
        "        } else {\n"
        "#pragma unroll\n"
        "          " + lane_store + "\n"
        "        }"))
    copies = {
        "no products": ({"grouped": grouped, "radix2": radix2},
                        _sub(field, "  return mont_mul(a, w, wp, N, lazy);\n}", "  return a ^ w;\n}")),
        "no device memory": ({
            "grouped": _sub(_sub(
                grouped, "cp_async8(D + s, p.x + (ok ? a * p.sa + j * p.sm + col * p.sb : 0), ok);",
                "cp_async8(D + s, p.x, ok);"),
                "for (int k = 0; k < K; ++k) dst[k * Lsm] = (long long)v[k];",
                "for (int k = 0; k < K; ++k)\n          " + never + "dst[k * Lsm] = (long long)v[k];"),
            "radix2": radix2_no_mem,
        }, field),
        "end direct": ({"radix2": direct}, field),
        "end vector": ({"radix2": vector}, field),
        "twiddle direct": ({"radix2": _sub(radix2, "const bool staged = INV && p.staged;",
                                           "const bool staged = false;")}, field),
        "mont chains": ({"bench": MULBENCH}, field),
    }
    procs, libs = {}, {}
    for name, (cus, cuh) in copies.items():
        d = os.path.join(out_dir, name.replace(" ", "_"))
        os.makedirs(d)
        with open(os.path.join(d, "field.cuh"), "w") as f:
            f.write(cuh)
        for k, cu in cus.items():
            with open(os.path.join(d, f"{k}.cu"), "w") as f:
                f.write(cu)
        libs[name] = os.path.join(d, "lib.so")
        # the copy's field.cuh first (a source's own directory), then the
        # port's other headers
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", d, "-I", _build.CSRC,
             *(os.path.join(d, f"{k}.cu") for k in cus), "-o", libs[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate(timeout=600)[0]
        if p.returncode != 0:
            raise RuntimeError(f"build of {name!r} failed:\n{log}")
    return libs


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20, help="timed calls per kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grouped_ablation: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from sventt_tpu_torch import _build
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import ntt_pallas as P

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    libs = {"as built": _build.load()}
    with tempfile.TemporaryDirectory() as tmp:
        paths = _build_all(tmp)
        for name in ("no products", "no device memory") + K6_ONLY:
            lib = ctypes.CDLL(paths[name])
            entries = (("sventt_grouped_ntt", P._GROUPED_REG_ARGTYPES),
                       ("sventt_radix2_ntt", P._RADIX2_ARGTYPES))
            for fname, argtypes in entries[1:2] if name in K6_ONLY else entries:
                fn = getattr(lib, fname)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            libs[name] = lib
        bench = ctypes.CDLL(paths["mont chains"])
        bench.mont_chains.restype = ctypes.c_float
        bench.mont_chains.argtypes = [ctypes.c_int] * 3 + [ctypes.c_ulonglong] * 3

        flag, _ = cs.moduli()
        fc = FieldConsts.from_modulus(flag)
        rng = np.random.default_rng(7)
        x = cs.rand_u64(rng, (256, 1 << 16), "cuda", below=flag.modulus)
        tw = cs.rand_twiddle(rng, (1 << 16, 256), flag, "pair", "cuda")
        t7 = P.make_leaf_tables(flag, 256, inverse=False, max_r=3, device="cuda")
        t8 = P.make_lane_tables(flag, 256, inverse=False, max_r=3, device="cuda")
        x7, x8 = x.view(1, 256, 1 << 16), x.view(1 << 16, 256, 1)
        tw8 = P._lane_tw(tw, x.view(1 << 16, 256), x.view(1 << 16, 256))
        t4 = P.make_leaf_tables(flag, 256, inverse=False, device="cuda")
        x5 = x.view(256, 256, 256)
        tw5 = P._mid_tw(cs.rand_twiddle(rng, (256, 256), flag, "pair", "cuda"), x5)
        t6, t6i = (P.make_lane_tables(flag, 256, inverse=i, device="cuda") for i in (False, True))
        x6 = x.view(1 << 16, 256)
        check = {"K7": P.grouped_plain(x, t7, fc).view(x7.shape),
                 "K8": P.lane_grouped_plain(x6, t8, fc, tw).view(x8.shape),
                 "K4": P._stages_plain(x7, t4, fc, False),
                 "K5": P._stages_plain(x5, t4, fc, False, tw5),
                 "K6": P.lane_plain(x6, t6, fc, tw).view(x8.shape),
                 "K6 inv": P.lane_plain(x6, t6i, fc, tw).view(x8.shape),
                 "K6 bare": P.lane_plain(x6, t6, fc).view(x8.shape),
                 "K6 bare inv": P.lane_plain(x6, t6i, fc).view(x8.shape)}
        calls = {"K7": lambda: P._launch_grouped(x7, t7, fc, None, False),
                 "K8": lambda: P._launch_grouped(x8, t8, fc, tw8, True),
                 "K4": lambda: P._launch_regs(x7, t4, fc, None, 0, 8),
                 "K5": lambda: P._launch_regs(x5, t4, fc, tw5, 0, 8),
                 "K6": lambda: P._launch_regs(x8, t6, fc, tw8, 0, 8, lane=True),
                 "K6 inv": lambda: P._launch_regs(x8, t6i, fc, tw8, 0, 8, lane=True),
                 "K6 bare": lambda: P._launch_regs(x8, t6, fc, None, 0, 8, lane=True),
                 "K6 bare inv": lambda: P._launch_regs(x8, t6i, fc, None, 0, 8, lane=True)}
        cs.log(f"[ablation] median ms of {args.reps} CUDA-graph replays at the 2^24 shapes, "
               "forward unless marked (K7 / K8 max_r 3; K4 / K5 / K6 the radix-2 register "
               "kernel)")
        build_load = _build.load
        for name, lib in libs.items():
            _build.load = (lambda lib=lib: lib)  # the launcher loads this library
            exact = name == "as built" or name in K6_ONLY
            try:
                for key, call in calls.items():
                    if name in K6_ONLY and key not in ("K6", "K6 inv"):
                        continue
                    ok = torch.equal(call(), check[key])
                    if exact:
                        cs.check(ok, f"{key} {name}: the kernel != plain")
                    ms = cs.timed_graph(call, 3, args.reps)
                    cs.log(f"  {key} {name}: {ms:.4f} ms"
                           + ("" if exact else " (ablated: results not checked)"))
            finally:
                _build.load = build_load
        w = 0x123456789ABCDEF % flag.modulus
        wp = w * fc.montgomery_inverse % (1 << 64)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for ilp in (1, 4, 8):
            iters = 2000
            ms = bench.mont_chains(ilp, 8 * sms, iters, flag.modulus, w, wp)
            rate = 8 * sms * 256 * ilp * iters / (ms * 1e-3)
            cs.log(f"  mont_mul, {ilp} chain(s) a thread: {ms:.4f} ms, {rate / 1e12:.3f} T "
                   "products/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

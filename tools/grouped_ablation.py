#!/usr/bin/env python3
"""What bounds the grouped register kernel (csrc/ntt_grouped.cu) on one card.

    python3 tools/grouped_ablation.py [--reps N]

Builds, besides the port's kernels, two ablated copies of the grouped
register kernel and one microbenchmark, each with nvcc into a temporary
directory, and times them at the 2^24 plan's shapes (K7 256 x 65536, K8
65536 rows of 256 with the pair twiddle, max_r 3, forward) in one call:

* "as built": the kernel itself;
* "no products": every stage, constant and table multiply replaced by an
  XOR (field.cuh twiddle_mul), the rest unchanged -- the time of the
  butterflies' additions, the exchanges, the copies and the indexing;
* "no device memory": the tile copied from a fixed address and the
  results not stored (a store the compiler cannot drop, never taken) --
  the time without HBM traffic;
* the Montgomery product alone (field.cuh mont_mul), 1, 4 and 8
  independent chains a thread, 8 blocks of 256 threads an SM: the card's
  rate of the product the kernel is made of.

The ablated kernels compute wrong results on purpose; only the unablated
kernel is checked (against the plain version).  CUDA-event medians of
``--reps`` CUDA-graph replays (device time), with the card's name and
power limit.
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


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"ablation anchor not found in the kernel source: {old[:60]!r}")
    return text.replace(old, new)


def _build_all(out_dir: str) -> dict:
    """nvcc of each ablated copy and the microbenchmark, all at once;
    returns {name: library path}."""
    from sventt_tpu_torch import _build

    src = open(os.path.join(_build.CSRC, "ntt_grouped.cu")).read()
    field = open(os.path.join(_build.CSRC, "field.cuh")).read()
    copies = {
        "no products": (src, _sub(field, "  return mont_mul(a, w, wp, N, lazy);\n}",
                                  "  return a ^ w;\n}")),
        "no device memory": (_sub(_sub(
            src, "cp_async8(D + s, p.x + (ok ? a * p.sa + j * p.sm + col * p.sb : 0), ok);",
            "cp_async8(D + s, p.x, ok);"),
            "for (int k = 0; k < K; ++k) dst[k * Lsm] = (long long)v[k];",
            "for (int k = 0; k < K; ++k)\n          if (v[k] == 0x123456789ull) "
            "dst[k * Lsm] = (long long)v[k];"), field),
        "mont chains": (MULBENCH, field),
    }
    procs, libs = {}, {}
    for name, (cu, cuh) in copies.items():
        d = os.path.join(out_dir, name.replace(" ", "_"))
        os.makedirs(d)
        with open(os.path.join(d, "field.cuh"), "w") as f:
            f.write(cuh)
        with open(os.path.join(d, "k.cu"), "w") as f:
            f.write(cu)
        libs[name] = os.path.join(d, "lib.so")
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", d, os.path.join(d, "k.cu"),
             "-o", libs[name]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
        for name in ("no products", "no device memory"):
            lib = ctypes.CDLL(paths[name])
            lib.sventt_grouped_ntt.restype = ctypes.c_int
            lib.sventt_grouped_ntt.argtypes = P._GROUPED_REG_ARGTYPES
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
        check = {"K7": P.grouped_plain(x, t7, fc).view(x7.shape),
                 "K8": P.lane_grouped_plain(x.view(1 << 16, 256), t8, fc, tw).view(x8.shape)}
        cs.log(f"[ablation] median ms of {args.reps} calls at the 2^24 shapes, max_r 3, forward")
        build_load = _build.load
        for name, lib in libs.items():
            _build.load = (lambda lib=lib: lib)  # the launcher loads this library
            try:
                for key, x3, t, tw3, lane in (("K7", x7, t7, None, False),
                                              ("K8", x8, t8, tw8, True)):
                    out = P._launch_grouped(x3, t, fc, tw3, lane)
                    ok = torch.equal(out, check[key])
                    if name == "as built":
                        cs.check(ok, f"{key}: the kernel != plain")
                    ms = cs.timed_graph(lambda: P._launch_grouped(x3, t, fc, tw3, lane), 3,
                                        args.reps)
                    cs.log(f"  {key} {name}: {ms:.4f} ms"
                           + ("" if name == "as built" else " (ablated: results not checked)"))
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

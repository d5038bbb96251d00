#!/usr/bin/env python3
"""The int8 mma.sync ceiling on one CUDA card, the yardstick of the
tensor-core matrix kernel (sventt_tpu_torch/csrc/ntt_mxu_tc.cu).

    python3 tools/mma_sync_ceiling.py

Times mma.sync.aligned.m16n8k32.s32.s8.s8.s32 with no memory traffic:

* "independent": each warp updates NACC independent accumulators from one
  A and one B fragment -- the instruction's own rate;
* "planes WN=1" / "planes WN=2": the kernel's plane-product pattern, each
  warp holding 8 digit-plane fragments and 8 byte-plane fragments in
  registers and adding A_a B_b into the accumulator of plane a + b, for a
  16 x 8 (WN=1, 15 x 4 accumulator registers, two blocks an SM) or a
  16 x 16 (WN=2, 15 x 8, one block an SM) warp tile -- the kernel's main
  loop without its loads, prologue and epilogue.

Prints TOP/s (a multiply-add is two operations) per case, with the card's
name and power limit, and the share of the published 1979 TOP/s.  Needs a
CUDA card; builds its kernel with nvcc into sventt_tpu_torch/build/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

SRC = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(int *c, const unsigned *a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NACC>
__global__ void __launch_bounds__(256) independent(int *out, int iters) {
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const unsigned b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  int acc[NACC][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma(acc[j], a, b0, b1);
  int s = 0;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <int WN>
__global__ void __launch_bounds__(256, WN == 1 ? 2 : 1) planes(int *out, int iters) {
  unsigned af[8][4], bf[8][2 * WN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) af[i][e] = threadIdx.x * (i + 3u) + e * 0x01010101u;
#pragma unroll
    for (int e = 0; e < 2 * WN; ++e) bf[i][e] = threadIdx.x ^ (i * 0x9E3779B9u + e);
  }
  int acc[15][WN][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int n = 0; n < WN; ++n) mma(acc[a + b][n], af[a], bf[b][2 * n], bf[b][2 * n + 1]);
  int s = 0;
#pragma unroll
  for (int t = 0; t < 15; ++t)
#pragma unroll
    for (int n = 0; n < WN; ++n) s += acc[t][n][0] + acc[t][n][1] + acc[t][n][2] + acc[t][n][3];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// kind: 0 independent (nacc 8, 16 or 32), 1 planes (wn 1 or 2)
extern "C" int run(int kind, int param, int *out, int blocks, int iters, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0 && param == 8) independent<8><<<blocks, 256, 0, st>>>(out, iters);
  else if (kind == 0 && param == 16) independent<16><<<blocks, 256, 0, st>>>(out, iters);
  else if (kind == 0 && param == 32) independent<32><<<blocks, 256, 0, st>>>(out, iters);
  else if (kind == 1 && param == 1) planes<1><<<blocks, 256, 0, st>>>(out, iters);
  else if (kind == 1 && param == 2) planes<2><<<blocks, 256, 0, st>>>(out, iters);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_sync_ceiling: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from sventt_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "mma_sync_ceiling.cu")
    with open(src, "w") as f:
        f.write(SRC)
    lib = ctypes.CDLL(_build.compile_shared(
        [_build.nvcc(), *_build.NVCC_FLAGS], [_build.nvcc(), *_build.NVCC_FLAGS[:2], "-shared"],
        [src], [], "mma_sync_ceiling"))
    for line in _build.LAST_BUILD["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    lib.run.restype = ctypes.c_int
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(8 * sms * 256, dtype=torch.int32, device="cuda")
    print(f"[mma.sync s8 m16n8k32] {smi.splitlines()[0]}; {sms} SMs; CUDA-event median of 5")
    # (label, kind, param, blocks an SM, iterations, mma a warp an iteration)
    cases = [(f"independent NACC={n}", 0, n, per_sm, 2000, n)
             for n in (8, 16, 32) for per_sm in (1, 8)]
    cases += [("planes WN=1 (16 x 8 warp tile)", 1, 1, 2, 200, 64),
              ("planes WN=1 (16 x 8 warp tile)", 1, 1, 8, 200, 64),
              ("planes WN=2 (16 x 16 warp tile)", 1, 2, 1, 200, 128),
              ("planes WN=2 (16 x 16 warp tile)", 1, 2, 4, 200, 128)]
    for label, kind, param, per_sm, iters, per_it in cases:
        blocks = sms * per_sm

        def call():
            rc = lib.run(kind, param, out.data_ptr(), blocks, iters,
                         torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        for _ in range(2):
            call()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[2]
        tops = 2 * 4096 * per_it * iters * blocks * 8 / (ms * 1e-3) / 1e12
        print(f"  {label}, grid of {per_sm} x {sms} blocks of 8 warps: {ms:.4f} ms, {tops:.1f} TOP/s "
              f"({100 * tops / 1979:.1f}% of 1979)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

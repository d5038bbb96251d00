// What the two register butterfly kernels share (csrc/ntt_grouped.cu
// grouped_reg_kernel, csrc/ntt_radix2.cu radix2_reg_kernel): a thread holds
// the 2^R points base + k L of one butterfly set of a group of R ranks in
// registers; the sets meet in a shared-memory tile (word slot() of point j,
// column c) once per group boundary; one wave of resident blocks walks the
// (slice, tile) work.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a Hopper block may use
// SWIZZLE nibble v: the XOR of 15, 10, 12, 8 over v's set bits 0-3
constexpr unsigned long long SWIZZLE = 0x1eb4d278963c5af0ull;

// The tile slot of word w: w, or (SWZ) w permuted inside its 16-word
// (128-byte) line by SWIZZLE[(w >> 4) & 15], which keeps a half-warp's
// 8-byte accesses on 16 distinct bank pairs where w's low bits alone would
// not (tests/test_torch_ntt_grouped_regs.py, _radix2_regs.py check it).
template <bool SWZ>
__device__ __forceinline__ int slot(int w) {
  return SWZ ? w ^ (int)((SWIZZLE >> (((w >> 4) & 15) << 2)) & 15) : w;
}

// The first point of butterfly set `set` of a group of R ranks with row
// unit 2^log2L: base = hi * 2^R L + lo, lo = set mod L (the set's points
// are base + k L, k < 2^R).
__device__ __forceinline__ int set_base(int set, int log2L, int R) {
  const int lo = set & ((1 << log2L) - 1);
  return ((set >> log2L) << (log2L + R)) + lo;
}

// Launch `kern` on one wave of resident blocks (the occupancy API's blocks
// an SM times the SMs, at most `work`), each looping over (slice, tile)
// work items itself.
template <class Kern, class Args>
cudaError_t launch_resident(Kern kern, const Args &p, int threads, int smem, long long work,
                            cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long blocks = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(work < blocks ? work : blocks);
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The pointwise product of two spectra, cyclic_convolve's middle step, as
// one elementwise pass, for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the JAX package leaves this step to XLA
// (sventt_tpu/apps/convolve.py::cyclic_convolve, its two mont_mul_full),
// which fuses it into one pass.  The plain PyTorch version is
// sventt_tpu_torch/ops/pointwise.py::mont_product_plain; the two agree bit
// for bit, for any words and in both modes.
//
// out[i] = mont_mul_full(a[i], mont_mul_full(b[i], r2)), then normalize
// when lazy: b moved into the Montgomery domain by R^2 mod N, then the
// Montgomery product with a, so out = a * b mod N.  r2 is a scalar.
// Bound on the H100: the bytes, 24 a point (two words in, one out), 0.120
// ms at 2^24 points against about 0.05 ms of 64-bit products (two
// Montgomery products a point).  So the design is that of a streaming
// pass: each thread moves two words a 16-byte access (longlong2), UNROLL
// accesses of each operand in flight before any product; a block takes
// THREADS * UNROLL consecutive pairs, and the grid covers the points once
// (16,384 blocks at 2^24).  On the card (H100 80GB HBM3, 700 W) that ran
// in 0.1336 ms at 2^24, 90% of the byte bound, lazy or not; a grid of 4
// blocks an SM striding over the points in 0.1468 ms, of 8 in 0.1408; one
// or four accesses a thread in 0.1331 / 0.1339.  A scalar head (a first
// word off 16-byte alignment) and tail (an odd word at the end) take one
// word a thread; pointers whose offsets from 16-byte alignment differ take
// every word so.
//
// Limbs (LIMBS, sventt_pointwise_mont_mul_limbs): the L limbs of a
// multi-modular product, `per_limb` words each, one after another, in one
// launch; the grid's second axis is the limb, whose N, N^-1 mod 2^64 and
// R^2 mod N a block reads from its row of the limb table
// (field/limb.py::LIMB_COLUMNS).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;

template <bool LAZY>
__device__ __forceinline__ u64 product(u64 a, u64 b, u64 N, u64 ninv, u64 r2) {
  const u64 p = mont_mul_full(a, mont_mul_full(b, r2, N, ninv, LAZY), N, ninv, LAZY);
  return LAZY ? normalize(p, N) : p;
}

// The pairs of words from `head` on, two words a thread, UNROLL pairs a
// thread in flight; then the `scalar` words [0, head) and
// [head + 2 * pairs, total), one a thread.
template <bool LAZY, bool LIMBS>
__global__ void __launch_bounds__(THREADS)
    pointwise_mont_mul_kernel(const long long *__restrict__ a, const long long *__restrict__ b,
                              long long *__restrict__ out, long long head, long long pairs,
                              long long scalar, u64 N, u64 ninv, u64 r2,
                              const unsigned long long *__restrict__ table, long long per_limb) {
  if constexpr (LIMBS) {
    const long long limb = blockIdx.y;
    a += limb * per_limb;
    b += limb * per_limb;
    out += limb * per_limb;
    N = table[8 * limb];
    ninv = table[8 * limb + 1];
    r2 = table[8 * limb + 6];
  }
  const auto *a2 = reinterpret_cast<const longlong2 *>(a + head);
  const auto *b2 = reinterpret_cast<const longlong2 *>(b + head);
  auto *o2 = reinterpret_cast<longlong2 *>(out + head);
  const long long base = (long long)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  longlong2 va[UNROLL], vb[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long p = base + u * THREADS;
    if (p < pairs) {
      va[u] = a2[p];
      vb[u] = b2[p];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long p = base + u * THREADS;
    if (p < pairs) {
      longlong2 r;
      r.x = (long long)product<LAZY>((u64)va[u].x, (u64)vb[u].x, N, ninv, r2);
      r.y = (long long)product<LAZY>((u64)va[u].y, (u64)vb[u].y, N, ninv, r2);
      o2[p] = r;
    }
  }
  const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (k < scalar) {
    const long long i = k < head ? k : k + 2 * pairs;
    out[i] = (long long)product<LAZY>((u64)a[i], (u64)b[i], N, ninv, r2);
  }
}

}  // namespace

extern "C" int sventt_pointwise_mont_mul(const void *a, const void *b, void *out,
                                         long long total, int lazy, unsigned long long N,
                                         unsigned long long ninv, unsigned long long r2,
                                         void *stream) {
  const auto pa = (uintptr_t)a, pb = (uintptr_t)b, po = (uintptr_t)out;
  if (total <= 0 || a == nullptr || b == nullptr || out == nullptr ||
      ((pa | pb | po) & 7) != 0 || N * ninv != 1)
    return (int)cudaErrorInvalidValue;
  // the vector body needs the three pointers at one offset from 16 bytes
  long long head = total, pairs = 0;
  if (((pa ^ pb) & 15) == 0 && ((pa ^ po) & 15) == 0) {
    head = (pa & 15) ? 1 : 0;
    pairs = (total - head) / 2;
  }
  const long long scalar = total - 2 * pairs;
  long long blocks = (pairs + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long scalar_blocks = (scalar + THREADS - 1) / THREADS;
  if (blocks < scalar_blocks) blocks = scalar_blocks;
  const auto *ap = (const long long *)a;
  const auto *bp = (const long long *)b;
  auto *op = (long long *)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (lazy)
    pointwise_mont_mul_kernel<true, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        ap, bp, op, head, pairs, scalar, N, ninv, r2, nullptr, 0);
  else
    pointwise_mont_mul_kernel<false, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        ap, bp, op, head, pairs, scalar, N, ninv, r2, nullptr, 0);
  return (int)cudaGetLastError();
}

// The product of L limbs of `per_limb` words each, limb l's words at
// [l * per_limb, (l + 1) * per_limb) of a, b and out, mod limb l's N:
// `table` is the (L, 8) limb table on the device.  The vector body takes
// the pairs of every limb where the three pointers share one offset from
// 16 bytes and per_limb is even (every limb then starts at that offset).
extern "C" int sventt_pointwise_mont_mul_limbs(const void *a, const void *b, void *out,
                                               long long per_limb, int limbs, int lazy,
                                               const void *table, void *stream) {
  const auto pa = (uintptr_t)a, pb = (uintptr_t)b, po = (uintptr_t)out;
  if (per_limb <= 0 || limbs <= 0 || limbs > 65535 || a == nullptr || b == nullptr ||
      out == nullptr || table == nullptr || ((pa | pb | po) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  long long head = per_limb, pairs = 0;
  if (((pa ^ pb) & 15) == 0 && ((pa ^ po) & 15) == 0 && per_limb % 2 == 0) {
    head = (pa & 15) ? 1 : 0;
    pairs = (per_limb - head) / 2;
  }
  const long long scalar = per_limb - 2 * pairs;
  long long blocks = (pairs + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long scalar_blocks = (scalar + THREADS - 1) / THREADS;
  if (blocks < scalar_blocks) blocks = scalar_blocks;
  const auto *ap = (const long long *)a;
  const auto *bp = (const long long *)b;
  auto *op = (long long *)out;
  const auto *tp = (const unsigned long long *)table;
  const dim3 grid((unsigned)blocks, (unsigned)limbs);
  cudaStream_t st = (cudaStream_t)stream;
  if (lazy)
    pointwise_mont_mul_kernel<true, true><<<grid, THREADS, 0, st>>>(
        ap, bp, op, head, pairs, scalar, 0, 0, 0, tp, per_limb);
  else
    pointwise_mont_mul_kernel<false, true><<<grid, THREADS, 0, st>>>(
        ap, bp, op, head, pairs, scalar, 0, 0, 0, tp, per_limb);
  return (int)cudaGetLastError();
}

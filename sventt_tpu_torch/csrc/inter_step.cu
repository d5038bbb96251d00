// The six-step inter-step twiddle multiply as one elementwise pass, for
// Hopper (sm_90a).
//
// Not a port of a TPU kernel: the JAX package multiplies the twiddle with
// XLA (sventt_tpu/plan/planner.py::_mont_mul_bcast) on its transpose
// fallback, the path a grouped (max_r > 1) inner row step or a row subtree
// takes.  The fused row kernels (csrc/ntt_radix2.cu, ntt_grouped.cu,
// mxu_tc.cuh) multiply it in their own prologue or epilogue instead.
// The plain PyTorch version is sventt_tpu_torch/ops/twiddle.py::
// inter_step_mul; the two agree bit for bit.
//
// out[r * B + b] = x[r * B + b] * tw[r] for the rows r of the (m0 * m1)
// twiddle matrix and the B batch entries of each, by the engine `mode`:
// Montgomery with the companion table (1, "pair") or computing it in
// flight (2, "w"), or Solinas on plain twiddles (3; _mont_mul_bcast's
// fc.solinas_mul branch, canonical only).  One thread a
// point, grid-stride: neighbouring threads read neighbouring points, and a
// row's twiddle is read once per B points (from L1/L2 after the first).
// Bound on the H100: the bytes -- 16 a point plus 8 or 16 a twiddle --
// against three or four 64-bit products a point (Solinas seven).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;

template <bool LAZY>
__global__ void __launch_bounds__(THREADS)
    inter_step_kernel(const long long *__restrict__ x, long long *__restrict__ out,
                      const long long *__restrict__ w, const long long *__restrict__ wp,
                      long long total, long long B, int log2b, int mode, u64 N,
                      u64 ninv) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const long long r = log2b >= 0 ? i >> log2b : i / B;
    out[i] = (long long)inter_step_mul((u64)x[i], w, wp, r, mode, N, ninv, LAZY);
  }
}

}  // namespace

extern "C" int sventt_inter_step_mul(const void *x, void *out, const void *w,
                                     const void *wp, long long rows, long long B,
                                     int mode, int lazy, unsigned long long N,
                                     unsigned long long ninv, void *stream) {
  if (rows <= 0 || B <= 0 || w == nullptr || mode < 1 || mode > 3 ||
      (mode == 1) != (wp != nullptr) || (mode == 3 && lazy))
    return (int)cudaErrorInvalidValue;
  const long long total = rows * B;
  const int log2b = (B & (B - 1)) == 0 ? 63 - __builtin_clzll((unsigned long long)B) : -1;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const auto *xp = (const long long *)x;
  auto *op = (long long *)out;
  const auto *wq = (const long long *)w;
  const auto *wpq = (const long long *)wp;
  cudaStream_t st = (cudaStream_t)stream;
  if (lazy)
    inter_step_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(xp, op, wq, wpq, total, B,
                                                                  log2b, mode, N, ninv);
  else
    inter_step_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(xp, op, wq, wpq, total,
                                                                   B, log2b, mode, N, ninv);
  return (int)cudaGetLastError();
}

// The matrix NTT for Hopper (sm_90a): one kernel for every orientation and
// every plane scheme.
//
// Replaces the Pallas kernel sventt_tpu/ops/ntt_mxu.py::_mxu_call (body
// _mxu_body) in its lead (mid=False) and mid (mid=True) forms, and
// _mxu_lane_call (the transform along the last axis of (B, m) rows), under
// the plane schemes "s8", "s8b" and "u7"; its u7 lead instantiation also
// replaces the round-4 prototype experimental/mxu_fused_kernel.py::mxu_ntt
// (K11; sventt_tpu_torch/experimental/mxu_fused_kernel.py).  The data is an
// (A, m, B) view with element strides (sa, sm, sb); the transform runs
// along the m axis.  Lead is A = 1; mid is A slices; lane is A = 1 with
// transform stride 1 and batch stride m, read in place.  The plain PyTorch
// version is sventt_tpu_torch/ops/ntt_mxu.py::_mxu_plain and the two agree
// bit for bit.
//
// s8 (and s8b): per output point (p, column) the kernel forms the 15 int32
// planes
//   P_t = sum_{a+b=t} sum_j D_a[p, j] * s_b[j]
// from the 8 balanced digit planes D_a (int8, from make_mxu_tables) and the
// 8 offset bytes s_b = byte_b - 128 of the data, then recombines them in
// registers: bias each plane by m << 17, accumulate 192 bits, add corr[p],
// fold the top word via 2^128 mod N, bring the high word below N (Barrett
// step or conditional subtracts), and finish with a Montgomery REDC.  u7:
// 10 unsigned 7-bit planes of the matrix times 10 of the data give 19
// unsigned planes at bit 7t, recombined the same way without bias or corr.
// The optional inter-step twiddle multiply is fused before the plane split
// on the forward and after the REDC on the inverse: Montgomery with the
// companion ("pair") or without it ("w"), or Solinas on plain twiddles
// (_tw_mul's fc.solinas_mul branch, canonical moduli only).  The planes
// and the REDC tail do not depend on the engine.
//
// What the TPU schemes were for, and why they buy nothing here.  u7 was the
// round-4 scheme; s8 replaced it because its recombination tail (15 byte-
// aligned planes against 19 bit-straddling ones) was the TPU's VPU cost.
// s8b stacked the 8 digit planes into a block-banded (15m, 8m) matrix so
// that the MXU, nearly idle, did the 49 plane-merge adds of s8's VPU tail
// (120 m^2 MACs against 64, sventt_tpu/ops/ntt_mxu.py:242-249).  This kernel
// merges in registers already: each __dp4a adds into the accumulator of its
// output plane, and the 64 (a, b) product planes are never materialized.
// So s8b runs here as s8 does, on the same instantiation: G's first block
// column, block (a, 0) = digit plane a, is the s8 digit stack, and the
// wrapper passes that (8m, m) slice; the zero blocks are skipped and the
// results are bitwise s8's.  u7 does 100 products a column
// and quad against s8's 64: on Hopper the products set the pace, so u7 is
// kept as the A/B point, not as a faster path.
//
// What bounds it on the H100: per point, 64 * m (u7: 100 * m) int8
// multiply-adds against 8 bytes of x (plus 8 or 16 of twiddle) in and 8
// bytes out -- at m = 256 about 1000 MACs per byte moved, above the ~300
// int8 MACs per byte at which even the tensor cores (1979 TOP/s against
// 3.35 TB/s) stop waiting on memory, so the products bound it, not the
// bytes.  This kernel is simple and right rather than fast: it computes
// the products with __dp4a (4 MACs per instruction on the CUDA cores), not
// the int8 tensor cores, and its block streams the whole plane matrix from
// L2 for every 8 columns.  A block loads its 8 columns once, splits them
// into byte (7-bit) planes in shared memory, and walks over all m output
// rows, so x and the twiddles are read once; each thread keeps 4 columns x
// 15 int32 plane sums in registers (u7: 2 x 19).  The ragged edge of the
// batch is masked here (the JAX wrapper pads B to 128 instead).
//
// Where it runs now.  The s8 (and s8b) lead and mid orientations, K1 and
// K2 on every plan's path, run on the int8 tensor cores in
// csrc/ntt_mxu_tc.cu; this kernel's s8 lead / mid instantiations are
// reached only by ops/ntt_mxu.py::_launch_dp4a_s8, the A/B point that
// chip_smoke.py times beside it.  The lane orientation (K3), the u7 plane
// format (K1-K3 u7) and K11 still run here.  The recombination tail and
// the twiddle multiply are csrc/mxu_tail.cuh, shared with that kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "mxu_tail.cuh"

namespace {

constexpr int TC = 8;        // batch columns per block
constexpr int THREADS = 256;

// The plane format (csrc/mxu_tail.cuh) and its thread layout: CPT columns
// a thread.  u7 keeps 2, since 4 x 19 accumulators need ~140 registers
// (one block per SM) or spill under a 128-register bound, and ran ~3%
// slower than 2 at the 2^24 shapes on the H100.
template <bool U7>
struct Planes : mxu::PlaneFormat<U7> {
  static constexpr int CPT = U7 ? 2 : 4;   // columns per thread
  static constexpr int COL_GROUPS = TC / CPT;
  static constexpr int ROWS_PER_PASS = THREADS / COL_GROUPS;
};

using mxu::Consts;
using mxu::data_plane;
using mxu::recombine;
using mxu::twiddle;

// Four consecutive int8 digits d[0..3] of one matrix row, packed for __dp4a;
// digits past the row's end (only when m < 4) read as 0.
__device__ __forceinline__ int load_digits(const signed char *d, int j, int m) {
  if ((m & 3) == 0) return __ldg(reinterpret_cast<const int *>(d + j));
  unsigned v = 0;
  for (int i = 0; i < 4; ++i)
    if (j + i < m) v |= (unsigned)(unsigned char)d[j + i] << (8 * i);
  return (int)v;
}

// U7: the plane format (the s8 digit stack, or u7).  TW: 0 none, 1 "pair"
// (mont_mul), 2 "w" (mont_mul_full), 3 Solinas "w" (solinas_mul).  Matrix
// plane a of row p starts at planes + (a * m + p) * m.
template <bool U7, int TW, bool INV, bool LAZY>
__global__ void __launch_bounds__(THREADS)
    mxu_ntt_kernel(const long long *__restrict__ x, long long *__restrict__ out,
                   const signed char *__restrict__ planes,
                   const long long *__restrict__ corr,
                   const long long *__restrict__ tw_w,
                   const long long *__restrict__ tw_wp, long long A, int m,
                   long long B, long long sa, long long sm, long long sb,
                   long long ta, long long tm, long long tb, Consts k) {
  using PL = Planes<U7>;
  extern __shared__ __align__(16) unsigned char smem[];
  // S[(b*TC + c)*row + j]: data plane b of column c at point j.  Rows are
  // padded to a multiple of 4 bytes, +4 so the 8 columns fall in 8 banks.
  signed char *S = reinterpret_cast<signed char *>(smem);
  const int mp = (m + 3) & ~3;
  const int row = mp + 4;
  const long long c0 = (long long)blockIdx.x * TC;
  const int cg = threadIdx.x % PL::COL_GROUPS;
  const int pr = threadIdx.x / PL::COL_GROUPS;
  const size_t plane_stride = (size_t)m * m;

  for (long long a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the previous slice is done reading S
    for (int idx = threadIdx.x; idx < TC * mp; idx += THREADS) {
      const int c = idx % TC, j = idx / TC;
      const long long col = c0 + c;
      // padding: every plane value is 0 (s8: offset bytes of 0x80)
      u64 v = U7 ? 0ull : 0x8080808080808080ull;
      if (j < m && col < B) {
        v = (u64)x[a * sa + j * sm + col * sb];
        if constexpr (TW != 0 && !INV) v = twiddle<TW, LAZY>(v, tw_w, tw_wp, a * ta + j * tm + col * tb, k);
      }
#pragma unroll
      for (int b = 0; b < PL::IN; ++b) S[(b * TC + c) * row + j] = data_plane<U7>(v, b);
    }
    __syncthreads();

    for (int p = pr; p < m; p += PL::ROWS_PER_PASS) {
      int acc[PL::CPT][PL::OUT];
#pragma unroll
      for (int cc = 0; cc < PL::CPT; ++cc)
#pragma unroll
        for (int t = 0; t < PL::OUT; ++t) acc[cc][t] = 0;
      const signed char *Drow = planes + (size_t)p * m;
      for (int j = 0; j < mp; j += 4) {
        int d[PL::IN];
#pragma unroll
        for (int da = 0; da < PL::IN; ++da) d[da] = load_digits(Drow + da * plane_stride, j, m);
#pragma unroll
        for (int cc = 0; cc < PL::CPT; ++cc) {
          const int c = cg * PL::CPT + cc;
#pragma unroll
          for (int b = 0; b < PL::IN; ++b) {
            const int s = *reinterpret_cast<const int *>(S + (b * TC + c) * row + j);
#pragma unroll
            for (int da = 0; da < PL::IN; ++da) acc[cc][da + b] = __dp4a(d[da], s, acc[cc][da + b]);
          }
        }
      }
      u64 cp = 0;
      if constexpr (!U7) cp = (u64)corr[p];
#pragma unroll
      for (int cc = 0; cc < PL::CPT; ++cc) {
        const long long col = c0 + cg * PL::CPT + cc;
        if (col < B) {
          u64 r = recombine<U7>(acc[cc], cp, m, k);
          if constexpr (TW != 0 && INV) r = twiddle<TW, LAZY>(r, tw_w, tw_wp, a * ta + p * tm + col * tb, k);
          out[a * sa + p * sm + col * sb] = (long long)r;
        }
      }
    }
  }
}

struct Args {
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  const long long *x;
  long long *out;
  const signed char *planes;
  const long long *corr, *tw_w, *tw_wp;
  long long A;
  int m;
  long long B, sa, sm, sb, ta, tm, tb;
  Consts k;
};

template <bool U7, int TW, bool INV, bool LAZY>
cudaError_t launch(const Args &g) {
  auto kern = mxu_ntt_kernel<U7, TW, INV, LAZY>;
  if (g.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<g.grid, THREADS, g.smem, g.stream>>>(g.x, g.out, g.planes, g.corr,
                                              g.tw_w, g.tw_wp, g.A, g.m, g.B, g.sa,
                                              g.sm, g.sb, g.ta, g.tm, g.tb, g.k);
  return cudaGetLastError();
}

template <bool U7>
cudaError_t dispatch(const Args &g, int tw_mode, int inverse, int lazy) {
  if (tw_mode == 0) return launch<U7, 0, false, false>(g);
  if (tw_mode == 1) {
    if (inverse)
      return lazy ? launch<U7, 1, true, true>(g) : launch<U7, 1, true, false>(g);
    return lazy ? launch<U7, 1, false, true>(g) : launch<U7, 1, false, false>(g);
  }
  if (tw_mode == 2) {
    if (inverse)
      return lazy ? launch<U7, 2, true, true>(g) : launch<U7, 2, true, false>(g);
    return lazy ? launch<U7, 2, false, true>(g) : launch<U7, 2, false, false>(g);
  }
  if (tw_mode == 3 && !lazy)  // Solinas: canonical only, no companion
    return inverse ? launch<U7, 3, true, false>(g) : launch<U7, 3, false, false>(g);
  return cudaErrorInvalidValue;
}

}  // namespace

// u7: 0 the s8 digit stack (8m, m) with corr (schemes "s8" and "s8b"), 1 the
// u7 planes (10m, m), corr may be null.
extern "C" int sventt_mxu_ntt(
    const void *x, void *out, const void *planes, const void *corr,
    const void *tw_w, const void *tw_wp, long long A, int m, long long B,
    long long sa, long long sm, long long sb, long long ta, long long tm,
    long long tb, int tw_mode, int inverse, int lazy, int u7,
    unsigned long long N, unsigned long long nprime, unsigned long long c128,
    unsigned long long mu, unsigned long long ninv, int nsub, int barrett,
    void *stream) {
  if (A <= 0 || B <= 0 || m < 2 || (!u7 && corr == nullptr) ||
      (tw_mode != 0 && tw_w == nullptr) || (tw_mode == 1) != (tw_wp != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long gy = A < 65535 ? A : 65535;
  const Args g{dim3((unsigned)((B + TC - 1) / TC), (unsigned)gy),
               (size_t)(u7 ? Planes<true>::IN : Planes<false>::IN) * TC * (((m + 3) & ~3) + 4),
               (cudaStream_t)stream,
               (const long long *)x, (long long *)out, (const signed char *)planes,
               (const long long *)corr, (const long long *)tw_w, (const long long *)tw_wp,
               A, m, B, sa, sm, sb, ta, tm, tb,
               Consts{N, nprime, c128, mu, ninv, nsub, barrett}};
  return (int)(u7 ? dispatch<true>(g, tw_mode, inverse, lazy)
                  : dispatch<false>(g, tw_mode, inverse, lazy));
}

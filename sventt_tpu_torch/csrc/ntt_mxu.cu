// The s8 matrix NTT for Hopper (sm_90a): one kernel for both orientations.
//
// Replaces the Pallas kernel sventt_tpu/ops/ntt_mxu.py::_mxu_call (body
// _mxu_body, scheme "s8") in its lead (mid=False) and mid (mid=True) forms,
// and _mxu_lane_call (the transform along the last axis of (B, m) rows).
// The data is an (A, m, B) view with element strides (sa, sm, sb); the
// transform runs along the m axis.  Lead is A = 1; mid is A slices; lane is
// A = 1 with transform stride 1 and batch stride m, read in place.  The
// plain PyTorch version is sventt_tpu_torch/ops/ntt_mxu.py::_mxu_plain and
// the two agree bit for bit.
//
// Per output point (p, column) the kernel forms the 15 int32 planes
//   P_t = sum_{a+b=t} sum_j D_a[p, j] * s_b[j]
// from the 8 balanced digit planes D_a (int8, from make_mxu_tables) and the
// 8 offset bytes s_b = byte_b - 128 of the data, then recombines them in
// registers: bias each plane by m << 17, accumulate 192 bits, add corr[p],
// fold the top word via 2^128 mod N, bring the high word below N (Barrett
// step or conditional subtracts), and finish with a Montgomery REDC.  The
// optional inter-step twiddle multiply is fused before the byte split on the
// forward and after the REDC on the inverse.
//
// What bounds it on the H100: per point, 64 * m int8 multiply-adds against
// 8 bytes of x (plus 8 or 16 of twiddle) in and 8 bytes out -- at m = 256
// about 1000 MACs per byte moved, above the ~300 int8 MACs per byte at
// which even the tensor cores (1979 TOP/s against 3.35 TB/s) stop waiting
// on memory, so the products bound it, not the bytes.  This first
// version is simple and right rather than fast: it computes the products
// with __dp4a (4 MACs per instruction on the CUDA cores), not the int8
// tensor cores, and its block streams the whole (8m, m) digit matrix from
// L2 for every 8 columns.  A block loads its 8 columns once, splits them
// into byte planes in shared memory, and walks over all m output rows, so
// x and the twiddles are read once; each thread keeps 4 columns x 15 int32
// plane sums in registers.  The ragged edge of the batch is masked here
// (the JAX wrapper pads B to 128 instead).  wgmma / mma.sync tiles, TMA and
// a digit-plane layout for them are the work of later changes.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int TC = 8;        // batch columns per block
constexpr int CPT = 4;       // columns per thread
constexpr int THREADS = 256;
constexpr int COL_GROUPS = TC / CPT;
constexpr int ROWS_PER_PASS = THREADS / COL_GROUPS;

struct Consts {
  u64 N, nprime, c128, mu, ninv;
  int nsub, barrett;
};

// Four consecutive int8 digits d[0..3] of one matrix row, packed for __dp4a;
// digits past the row's end (only when m < 4) read as 0.
__device__ __forceinline__ int load_digits(const signed char *d, int j, int m) {
  if ((m & 3) == 0) return __ldg(reinterpret_cast<const int *>(d + j));
  unsigned v = 0;
  for (int i = 0; i < 4; ++i)
    if (j + i < m) v |= (unsigned)(unsigned char)d[j + i] << (8 * i);
  return (int)v;
}

// 15 plane sums + corr -> canonical residue (ntt_mxu.py::_mxu_plain tail).
__device__ __forceinline__ u64 recombine(const int *P, u64 corr, int m,
                                         const Consts &k) {
  const long long bias = (long long)m << 17;  // == make_mxu_tables' bias
  u64 w[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < 15; ++t) {
    // biased plane < 2^28, shifted by <= 24: < 2^52, <= 4 per word < 2^54
    u64 v = (u64)((long long)P[t] + bias);
    w[(8 * t) >> 5] += v << ((8 * t) & 31);
  }
  w[0] += corr & 0xFFFFFFFFull;
  w[1] += corr >> 32;
  u64 L[6];
  u64 carry = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    u64 s = w[i] + carry;
    L[i] = s & 0xFFFFFFFFull;
    carry = s >> 32;
  }
  u64 T_lo = (L[1] << 32) | L[0];
  u64 T_hi = (L[3] << 32) | L[2];
  u64 top = (L[5] << 32) | L[4];
  // fold: value === top*2^128 + T_hi*2^64 + T_lo; a carry out of T_hi has
  // weight 2^128 === c128 and folds back at weight 1
  u64 c0, c1, c2, c3;
  u64 T_lo2 = add_carry(T_lo, top * k.c128, c0);
  u64 s1 = add_carry(T_hi, __umul64hi(top, k.c128), c1);
  u64 s2 = add_carry(s1, c0, c2);
  T_lo2 = add_carry(T_lo2, (c1 | c2) ? k.c128 : 0ull, c3);
  T_hi = s2 + c3;
  if (k.barrett) T_hi -= __umul64hi(T_hi, k.mu) * k.N;
  for (int i = 0; i < k.nsub; ++i) T_hi = T_hi < k.N ? T_hi : T_hi - k.N;
  // subtractive Montgomery REDC of T_hi*2^64 + T_lo2
  u64 qn1 = __umul64hi(T_lo2 * k.nprime, k.N);
  u64 d = T_hi - qn1;
  u64 res = T_hi < qn1 ? d + k.N : d;
  return res < k.N ? res : res - k.N;
}

template <int TW, bool LAZY>
__device__ __forceinline__ u64 twiddle(u64 v, const long long *tw_w,
                                       const long long *tw_wp, long long ti,
                                       const Consts &k) {
  if (TW == 1) return mont_mul(v, (u64)tw_w[ti], (u64)tw_wp[ti], k.N, LAZY);
  return mont_mul_full(v, (u64)tw_w[ti], k.N, k.ninv, LAZY);
}

// TW: 0 none, 1 "pair" (mont_mul), 2 "w" (mont_mul_full).
template <int TW, bool INV, bool LAZY>
__global__ void __launch_bounds__(THREADS)
    mxu_ntt_kernel(const long long *__restrict__ x, long long *__restrict__ out,
                   const signed char *__restrict__ planes,
                   const long long *__restrict__ corr,
                   const long long *__restrict__ tw_w,
                   const long long *__restrict__ tw_wp, long long A, int m,
                   long long B, long long sa, long long sm, long long sb,
                   long long ta, long long tm, long long tb, Consts k) {
  extern __shared__ __align__(16) unsigned char smem[];
  // S[(b*TC + c)*row + j]: offset byte b of column c at point j.  Rows are
  // padded to a multiple of 4 bytes, +4 so the 8 columns fall in 8 banks.
  signed char *S = reinterpret_cast<signed char *>(smem);
  const int mp = (m + 3) & ~3;
  const int row = mp + 4;
  const long long c0 = (long long)blockIdx.x * TC;
  const int cg = threadIdx.x % COL_GROUPS;
  const int pr = threadIdx.x / COL_GROUPS;
  const size_t plane_stride = (size_t)m * m;

  for (long long a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the previous slice is done reading S
    for (int idx = threadIdx.x; idx < TC * mp; idx += THREADS) {
      const int c = idx % TC, j = idx / TC;
      const long long col = c0 + c;
      u64 v = 0x8080808080808080ull;  // padding: every offset byte is 0
      if (j < m && col < B) {
        v = (u64)x[a * sa + j * sm + col * sb];
        if constexpr (TW != 0 && !INV) v = twiddle<TW, LAZY>(v, tw_w, tw_wp, a * ta + j * tm + col * tb, k);
      }
#pragma unroll
      for (int b = 0; b < 8; ++b)  // byte ^ 0x80 as int8 == byte - 128
        S[(b * TC + c) * row + j] = (signed char)(((v >> (8 * b)) & 0xFF) ^ 0x80);
    }
    __syncthreads();

    for (int p = pr; p < m; p += ROWS_PER_PASS) {
      int acc[CPT][15];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
        for (int t = 0; t < 15; ++t) acc[cc][t] = 0;
      const signed char *Drow = planes + (size_t)p * m;
      for (int j = 0; j < mp; j += 4) {
        int d[8];
#pragma unroll
        for (int da = 0; da < 8; ++da) d[da] = load_digits(Drow + da * plane_stride, j, m);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const int c = cg * CPT + cc;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int s = *reinterpret_cast<const int *>(S + (b * TC + c) * row + j);
#pragma unroll
            for (int da = 0; da < 8; ++da) acc[cc][da + b] = __dp4a(d[da], s, acc[cc][da + b]);
          }
        }
      }
      const u64 cp = (u64)corr[p];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const long long col = c0 + cg * CPT + cc;
        if (col < B) {
          u64 r = recombine(acc[cc], cp, m, k);
          if constexpr (TW != 0 && INV) r = twiddle<TW, LAZY>(r, tw_w, tw_wp, a * ta + p * tm + col * tb, k);
          out[a * sa + p * sm + col * sb] = (long long)r;
        }
      }
    }
  }
}

template <int TW, bool INV, bool LAZY>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const long long *x, long long *out, const signed char *planes,
                   const long long *corr, const long long *tw_w,
                   const long long *tw_wp, long long A, int m, long long B,
                   long long sa, long long sm, long long sb, long long ta,
                   long long tm, long long tb, const Consts &k) {
  auto kern = mxu_ntt_kernel<TW, INV, LAZY>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, THREADS, smem, stream>>>(x, out, planes, corr, tw_w, tw_wp, A,
                                        m, B, sa, sm, sb, ta, tm, tb, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sventt_mxu_ntt(
    const void *x, void *out, const void *planes, const void *corr,
    const void *tw_w, const void *tw_wp, long long A, int m, long long B,
    long long sa, long long sm, long long sb, long long ta, long long tm,
    long long tb, int tw_mode, int inverse, int lazy, unsigned long long N,
    unsigned long long nprime, unsigned long long c128, unsigned long long mu,
    unsigned long long ninv, int nsub, int barrett, void *stream) {
  if (A <= 0 || B <= 0 || m < 2) return (int)cudaErrorInvalidValue;
  const Consts k{N, nprime, c128, mu, ninv, nsub, barrett};
  const long long gy = A < 65535 ? A : 65535;
  const dim3 grid((unsigned)((B + TC - 1) / TC), (unsigned)gy);
  const size_t smem = (size_t)8 * TC * (((m + 3) & ~3) + 4);
  cudaStream_t s = (cudaStream_t)stream;
  const auto *xp = (const long long *)x;
  auto *op = (long long *)out;
  const auto *pp = (const signed char *)planes;
  const auto *cp = (const long long *)corr;
  const auto *wp = (const long long *)tw_w;
  const auto *wpp = (const long long *)tw_wp;
#define SVENTT_LAUNCH(TW, INV, LAZY)                                            \
  launch<TW, INV, LAZY>(grid, smem, s, xp, op, pp, cp, wp, wpp, A, m, B, sa, sm, \
                        sb, ta, tm, tb, k)
  cudaError_t e;
  if (tw_mode == 0) {
    e = SVENTT_LAUNCH(0, false, false);
  } else if (tw_mode == 1) {
    if (inverse)
      e = lazy ? SVENTT_LAUNCH(1, true, true) : SVENTT_LAUNCH(1, true, false);
    else
      e = lazy ? SVENTT_LAUNCH(1, false, true) : SVENTT_LAUNCH(1, false, false);
  } else if (tw_mode == 2) {
    if (inverse)
      e = lazy ? SVENTT_LAUNCH(2, true, true) : SVENTT_LAUNCH(2, true, false);
    else
      e = lazy ? SVENTT_LAUNCH(2, false, true) : SVENTT_LAUNCH(2, false, false);
  } else {
    e = cudaErrorInvalidValue;
  }
#undef SVENTT_LAUNCH
  return (int)e;
}

// The s8 matrix NTT on Hopper's int8 tensor cores (sm_90a), lead and mid
// orientations.
//
// Replaces the Pallas kernel sventt_tpu/ops/ntt_mxu.py::_mxu_call (body
// _mxu_body) in its lead (mid=False, K1) and mid (mid=True, K2) forms under
// the plane schemes "s8" and "s8b" (s8b's kernel planes are s8's digit
// stack, so it follows bit for bit).  The data is an (A, m, B) view with
// element strides (sa, sm, sb); the transform runs along the m axis (lead
// is A = 1).  The plain PyTorch version is
// sventt_tpu_torch/ops/ntt_mxu.py::_mxu_plain and the two agree bit for
// bit.  The lane orientation (K3), the u7 format and K11 stay on the
// __dp4a kernel of csrc/ntt_mxu.cu.
//
// The arithmetic is that kernel's: per output point (p, column) the 15
// int32 planes
//   P_t = sum_{a+b=t} sum_j D_a[p, j] * s_b[j]
// of the 8 balanced digit planes D_a of the matrix (int8, make_mxu_tables)
// and the 8 offset bytes s_b = byte_b - 128 of the data, recombined by
// csrc/mxu_tail.cuh (bias m << 17, corr[p], 192-bit accumulate, fold,
// Barrett / subtracts, Montgomery REDC); the inter-step twiddle multiply
// (pair, w or Solinas) fused before the plane split on the forward and
// after the REDC on the inverse.
//
// The bound: operations.  A point costs 64 * m int8 multiply-adds against
// 16 bytes in and out (plus the twiddle) -- at the 2^24 shapes (m = 256)
// 2.75e11 multiply-adds, 0.278 ms at the tensor cores' 1979 TOP/s, against
// 0.12 ms for the bytes.
//
// The design.  A block of 8 warps owns NT batch columns (32 at m <= 512,
// 16 above; ops/ntt_mxu.py::tc_geometry) and all m output rows, or a
// share of the row groups when the grid is small (the row split,
// gridDim.z).  Its prologue loads the columns once, applies the forward
// twiddle and writes the 8 offset-byte planes K-major into shared memory
// (S[plane][column][point], K padded to a multiple of 32 with plane value
// 0, rows 16 bytes longer than K so that ldmatrix is free of bank
// conflicts).  The products run on mma.sync.m16n8k32.s32.s8.s8.s32: A the
// digit-plane tile (16 rows x 32 points, ldmatrix.x4), B the byte-plane
// tile (32 points x 8 columns, two planes by one ldmatrix.x4).  Every
// (a, b) product accumulates straight into the fragment of plane a + b, so
// no product plane is ever materialized: a warp's 16 x 8 tile holds 15
// planes x 4 = 60 accumulator registers, 4 byte planes (8 registers) and
// one digit plane (4) at a time, within the 128 registers that let two
// blocks share an SM (at m <= 256, where their shared memory fits).  The
// digit planes of a row group (8 planes x RG rows x 32 points) stream
// from L2 through a 3-stage cp.async ring; the wrapper lays the stack out
// tile by tile when the tables are built (ops/ntt_mxu.py::tc_plane_tiles:
// zero past m, swizzled against bank conflicts), so a stage is one
// contiguous copy for every m; the whole matrix is read once per NT columns
// (1 GiB for a 2^24 K1 call, where the __dp4a kernel's 8-column blocks
// read 4 GiB).  The epilogue runs in registers, per element, on the C
// fragment's rows (lane >> 2, +8) and columns (2 (lane & 3), +1): the
// recombination tail, the inverse twiddle, a masked store (rows >= m and
// columns >= B are not written).
//
// Exactness without .satfinite: each partial sum of a plane is a sum of at
// most 8m products of two int8 values in [-128, 127], so it is bounded
// like the plane itself, |P| <= 8 * m * 2^14 = m << 17 < 2^28 at m = 1024,
// and int32 accumulation never wraps.
//
// Why mma.sync and not wgmma.  The 15 live planes per output element
// multiply a GEMM's accumulator registers by 15, capping a warpgroup's
// wgmma N near 16, where its advantage is mostly gone.  What limits this
// kernel on the H100 is latency, not the products' issue rate: all warps
// of a block run the prologue, the ring's barrier and the epilogue in
// step, so the tensor cores wait unless another block has work (PERF.md
// section 6: a 16 x 16 warp tile at 254 registers and one block an SM ran
// slower than this 16 x 8 tile at two blocks an SM).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "mxu_tail.cuh"

namespace {

using mxu::Consts;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NPL = 8;                       // digit planes = byte planes
constexpr int NOUT = 2 * NPL - 1;            // product planes
constexpr int WCOLS = 8;                     // columns per warp: one mma n-tile
constexpr int BG = 4;                        // byte planes held in registers at once
constexpr int KSTEP = 32;                    // points per mma
constexpr int STAGES = 3;                    // digit-plane ring depth
constexpr int MAX_SMEM = 232448;             // a block's shared memory on sm_90

// The block's geometry from (m, nt), as ops/ntt_mxu.py::tc_geometry
// computes it: K padded to 32, the byte-plane row stride, the column and
// row warps, the rows of a row group, the shared memory.
struct Geo {
  int kp, rs, cw, rg, n_rg;
  long long smem;
  __host__ __device__ Geo(int m, int nt) {
    kp = (m + KSTEP - 1) / KSTEP * KSTEP;
    rs = kp + 16;
    cw = nt / WCOLS;
    rg = 16 * (WARPS / cw);
    n_rg = (m + rg - 1) / rg;
    smem = (long long)NPL * nt * rs + (long long)STAGES * NPL * rg * KSTEP;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async16(unsigned dst, const void *src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned *r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 -> int32.
__device__ __forceinline__ void mma_s8(int *c, const unsigned *a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of (row r, 16-byte half h) in a 32-byte digit-plane row:
// rows 4-7 of every 8 swap their halves, so the 8 rows an ldmatrix reads
// fall in 8 different 16-byte bank groups.
__device__ __forceinline__ int a_slot(int r, int h) {
  return r * KSTEP + 16 * (h ^ ((r >> 2) & 1));
}

// Copy ring tile (row_group, ks) of the digit stack -- stored tile-major,
// swizzled and zero-padded by ops/ntt_mxu.py::tc_plane_tiles, so a tile
// is `bytes` contiguous bytes -- into `dst`, 16 bytes a thread at a time.
__device__ __forceinline__ void load_tile(unsigned char *dst, const signed char *tiles, int bytes,
                                          int ks_n, int row_group, int ks) {
  const signed char *src = tiles + (size_t)(row_group * ks_n + ks) * bytes;
  for (int off = 16 * threadIdx.x; off < bytes; off += 16 * THREADS)
    cp_async16(smem_addr(dst + off), src + off);
}

// TW: 0 none, 1 "pair", 2 "w", 3 Solinas.  `tiles`: the digit stack in
// the ring-tile layout of ops/ntt_mxu.py::tc_plane_tiles.
template <int TW, bool INV, bool LAZY>
__global__ void __launch_bounds__(THREADS, 2)
    mxu_tc_kernel(const long long *__restrict__ x, long long *__restrict__ out,
                  const signed char *__restrict__ tiles, const long long *__restrict__ corr,
                  const long long *__restrict__ tw_w, const long long *__restrict__ tw_wp,
                  long long A, int m, long long B, long long sa, long long sm, long long sb,
                  long long ta, long long tm, long long tb, int nt, int split, Consts k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo g(m, nt);
  const int ks_n = g.kp / KSTEP;
  const int per = (g.n_rg + split - 1) / split;
  const int rg0 = blockIdx.z * per;
  const int rg1 = min(g.n_rg, rg0 + per);
  if (rg0 >= rg1) return;  // the same for every thread of the block
  const int T = (rg1 - rg0) * ks_n;

  // S[(b * nt + c) * rs + j]: byte plane b of column c at point j
  signed char *S = reinterpret_cast<signed char *>(smem);
  unsigned char *ring = smem + (size_t)NPL * nt * g.rs;
  const int stage_bytes = NPL * g.rg * KSTEP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp % g.cw, wr = warp / g.cw;
  const long long c0 = (long long)blockIdx.x * nt;

  // Per-lane ldmatrix addresses.  B: matrices (plane b, points 0-15),
  // (b, 16-31), (b + 1, 0-15), (b + 1, 16-31) -> b0, b1 of planes b and
  // b + 1.  A: (rows 0-7, points 0-15), (rows 8-15, 0-15), (rows 0-7,
  // 16-31), (rows 8-15, 16-31) -> a0..a3.
  const unsigned s_lane =
      smem_addr(S) + (unsigned)(((lane >> 4) * nt + wc * WCOLS + (lane & 7)) * g.rs +
                                16 * ((lane >> 3) & 1));
  const int a_row = wr * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const unsigned a_lane = smem_addr(ring) + (unsigned)a_slot(a_row, lane >> 4);

  for (long long a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the previous slice is done with S and the ring
    // the digit planes do not depend on the data: start the ring first
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < T)
        load_tile(ring + s * stage_bytes, tiles, stage_bytes, ks_n, rg0 + s / ks_n, s % ks_n);
      cp_commit();
    }
    // Prologue: a warp item is 8 columns x 4 point quads, one (column,
    // quad) a lane, so the 32 lanes' 4-byte stores hit 32 banks.
    const int cgroups = nt / 8;
    const int items = cgroups * (g.kp / 16);
    for (int wi = warp; wi < items; wi += WARPS) {
      const int c = (wi % cgroups) * 8 + (lane & 7);
      const int q = (wi / cgroups) * 4 + (lane >> 3);
      const long long col = c0 + c;
      unsigned lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        u64 v = 0x8080808080808080ull;  // padding: every plane value 0
        if (j < m && col < B) {
          v = (u64)x[a * sa + j * sm + col * sb];
          if constexpr (TW != 0 && !INV)
            v = mxu::twiddle<TW, LAZY>(v, tw_w, tw_wp, a * ta + j * tm + col * tb, k);
        }
        lo[i] = (unsigned)v;
        hi[i] = (unsigned)(v >> 32);
      }
      // transpose 4 words x 8 bytes into 8 planes x 4 points, then offset
      // each byte by -128 (^ 0x80)
      unsigned w[NPL];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned *h = half ? hi : lo;
        const unsigned t01 = __byte_perm(h[0], h[1], 0x5140), u01 = __byte_perm(h[0], h[1], 0x7362);
        const unsigned t23 = __byte_perm(h[2], h[3], 0x5140), u23 = __byte_perm(h[2], h[3], 0x7362);
        w[4 * half + 0] = __byte_perm(t01, t23, 0x5410);
        w[4 * half + 1] = __byte_perm(t01, t23, 0x7632);
        w[4 * half + 2] = __byte_perm(u01, u23, 0x5410);
        w[4 * half + 3] = __byte_perm(u01, u23, 0x7632);
      }
#pragma unroll
      for (int b = 0; b < NPL; ++b)
        *reinterpret_cast<unsigned *>(S + (size_t)(b * nt + c) * g.rs + 4 * q) = w[b] ^ 0x80808080u;
    }

    int acc[NOUT][4];
#pragma unroll
    for (int t = 0; t < NOUT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0;

    for (int it = 0; it < T; ++it) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // tile `it` (and, at it = 0, S) is in; slot it-1 is free
      {
        const int nx = it + STAGES - 1;
        if (nx < T)
          load_tile(ring + (nx % STAGES) * stage_bytes, tiles, stage_bytes, ks_n, rg0 + nx / ks_n,
                    nx % ks_n);
        cp_commit();
      }
      const int row_group = rg0 + it / ks_n, ks = it % ks_n;
      const int p0 = row_group * g.rg + wr * 16;
      if (p0 < m) {  // a warp whose 16 rows all lie past m has nothing to add
        const unsigned a_base = a_lane + (unsigned)((it % STAGES) * stage_bytes);
#pragma unroll
        for (int b0 = 0; b0 < NPL; b0 += BG) {
          unsigned bf[BG][2];
#pragma unroll
          for (int bb = 0; bb < BG; bb += 2)
            ldsm_x4(s_lane + (unsigned)((b0 + bb) * nt * g.rs + ks * KSTEP), &bf[bb][0]);
#pragma unroll
          for (int da = 0; da < NPL; ++da) {
            unsigned af[4];
            ldsm_x4(a_base + (unsigned)(da * g.rg * KSTEP), af);
#pragma unroll
            for (int bb = 0; bb < BG; ++bb) mma_s8(acc[da + b0 + bb], af, bf[bb][0], bf[bb][1]);
          }
        }
      }
      if (ks == ks_n - 1) {
        // Epilogue of the row group: lane holds rows p0 + (lane >> 2) (+8)
        // and columns 2 (lane & 3) (+1).
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int p = p0 + (lane >> 2) + 8 * hr;
          if (p < m) {
            const u64 cp = (u64)corr[p];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const long long col = c0 + wc * WCOLS + 2 * (lane & 3) + e;
              if (col < B) {
                int P[NOUT];
#pragma unroll
                for (int t = 0; t < NOUT; ++t) P[t] = acc[t][2 * hr + e];
                u64 r = mxu::recombine<false>(P, cp, m, k);
                if constexpr (TW != 0 && INV)
                  r = mxu::twiddle<TW, LAZY>(r, tw_w, tw_wp, a * ta + p * tm + col * tb, k);
                out[a * sa + p * sm + col * sb] = (long long)r;
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < NOUT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0;
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
  const signed char *tiles;
  const long long *corr, *tw_w, *tw_wp;
  long long A;
  int m;
  long long B, sa, sm, sb, ta, tm, tb;
  int nt, split;
  Consts k;
};

template <int TW, bool INV, bool LAZY>
cudaError_t launch(const Args &g) {
  auto kern = mxu_tc_kernel<TW, INV, LAZY>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)g.smem);
  if (e != cudaSuccess) return e;
  kern<<<g.grid, THREADS, g.smem, g.stream>>>(g.x, g.out, g.tiles, g.corr, g.tw_w, g.tw_wp,
                                              g.A, g.m, g.B, g.sa, g.sm, g.sb, g.ta, g.tm, g.tb,
                                              g.nt, g.split, g.k);
  return cudaGetLastError();
}

}  // namespace

// The s8 digit stack (schemes "s8" and "s8b") in the ring-tile layout of
// ops/ntt_mxu.py::tc_plane_tiles, with corr; the arguments of
// sventt_mxu_ntt less u7, plus the launch geometry of
// ops/ntt_mxu.py::tc_geometry: nt columns a block (8, 16, 32 or 64), the
// row split (gridDim.z) and the dynamic shared memory, which must be the
// geometry's own.
extern "C" int sventt_mxu_ntt_tc(
    const void *x, void *out, const void *tiles, const void *corr, const void *tw_w,
    const void *tw_wp, long long A, int m, long long B, long long sa, long long sm,
    long long sb, long long ta, long long tm, long long tb, int tw_mode, int inverse,
    int lazy, unsigned long long N, unsigned long long nprime, unsigned long long c128,
    unsigned long long mu, unsigned long long ninv, int nsub, int barrett, int nt, int split,
    long long smem, void *stream) {
  if (A <= 0 || B <= 0 || m < 2 || m > 1024 || corr == nullptr ||
      (tw_mode != 0 && tw_w == nullptr) || (tw_mode == 1) != (tw_wp != nullptr))
    return (int)cudaErrorInvalidValue;
  if (nt < WCOLS || nt % WCOLS != 0 || WARPS % (nt / WCOLS) != 0 || split < 1 ||
      split > 65535)
    return (int)cudaErrorInvalidValue;
  const Geo geo(m, nt);
  if (smem != geo.smem || smem > MAX_SMEM || split > geo.n_rg) return (int)cudaErrorInvalidValue;
  const long long gy = A < 65535 ? A : 65535;
  const Args g{dim3((unsigned)((B + nt - 1) / nt), (unsigned)gy, (unsigned)split),
               (size_t)smem,
               (cudaStream_t)stream,
               (const long long *)x, (long long *)out, (const signed char *)tiles,
               (const long long *)corr, (const long long *)tw_w, (const long long *)tw_wp,
               A, m, B, sa, sm, sb, ta, tm, tb, nt, split,
               Consts{N, nprime, c128, mu, ninv, nsub, barrett}};
  if (tw_mode == 0) return (int)launch<0, false, false>(g);
  if (tw_mode == 1) {
    if (inverse) return (int)(lazy ? launch<1, true, true>(g) : launch<1, true, false>(g));
    return (int)(lazy ? launch<1, false, true>(g) : launch<1, false, false>(g));
  }
  if (tw_mode == 2) {
    if (inverse) return (int)(lazy ? launch<2, true, true>(g) : launch<2, true, false>(g));
    return (int)(lazy ? launch<2, false, true>(g) : launch<2, false, false>(g));
  }
  if (tw_mode == 3 && !lazy)  // Solinas: canonical only, no companion
    return (int)(inverse ? launch<3, true, false>(g) : launch<3, false, false>(g));
  return (int)cudaErrorInvalidValue;
}

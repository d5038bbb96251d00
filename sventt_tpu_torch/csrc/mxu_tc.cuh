// The matrix NTT on Hopper's int8 tensor cores (sm_90a), lead, mid and lane
// orientations, for both plane formats: the kernel body, its launch and its
// C entry's checks.  csrc/ntt_mxu_tc.cu instantiates it for the s8 digit
// stack (schemes "s8" and "s8b"), csrc/ntt_mxu_tc_u7.cu for the u7 planes
// (scheme "u7" and K11): one nvcc process per source, so the two sets
// build side by side.
//
// Replaces the Pallas kernels sventt_tpu/ops/ntt_mxu.py::_mxu_call (body
// _mxu_body) in its lead (mid=False, K1) and mid (mid=True, K2) forms and
// _mxu_lane_call (K3) under every plane scheme (s8b's kernel planes are
// s8's digit stack, so it follows bit for bit), and, as the u7 lead
// instantiation, experimental/mxu_fused_kernel.py::mxu_ntt (K11).  The data
// is an (A, m, B) view with element strides (sa, sm, sb); the transform
// runs along the m axis (lead is A = 1; the lane orientation is the (1, m,
// B) view of (B, m) rows, sm = 1 and sb = m, read in place).  The plain
// PyTorch version is sventt_tpu_torch/ops/ntt_mxu.py::_mxu_plain and the
// two agree bit for bit.
//
// The arithmetic, the plain version's: per output point (p, column) the
// NOUT int32 planes
//   P_t = sum_{a+b=t} sum_j D_a[p, j] * s_b[j]
// of the NPL matrix planes D_a and the NPL data planes s_b, recombined by
// csrc/mxu_tail.cuh (192-bit accumulate, fold, Barrett / subtracts,
// Montgomery REDC); the inter-step twiddle multiply (pair, w or Solinas)
// fused before the plane split on the forward and after the REDC on the
// inverse.  s8: 8 balanced digit planes (int8, make_mxu_tables) and the 8
// offset bytes s_b = byte_b - 128 give 15 planes at bit 8t, biased by
// m << 17 with corr[p].  u7: 10 unsigned 7-bit planes of the matrix and of
// the data (plane 9 holds bit 63 alone) give 19 unsigned planes at bit 7t,
// no bias and no corr.
//
// The bound: operations.  A point costs 64 * m int8 multiply-adds (u7: 100
// * m) against 16 bytes in and out (plus the twiddle) -- at the 2^24 shapes
// (m = 256) 2.75e11 multiply-adds, 0.278 ms at the tensor cores' 1979
// TOP/s (u7 0.434 ms), against 0.12 ms for the bytes.
//
// The design.  A block of 8 warps owns NT batch columns (ops/ntt_mxu.py::
// tc_geometry) and all m output rows, or a share of the row groups when
// the grid is small (the row split, gridDim.z).  Its prologue loads the
// columns once, applies the forward twiddle and writes the NPL data planes
// K-major into shared memory (S[plane][column][point], K padded to a
// multiple of 32 with plane value 0, rows 16 bytes longer than K so that
// ldmatrix is free of bank conflicts).  The products run on
// mma.sync.m16n8k32.s32.s8.s8.s32: A the matrix-plane tile (16 rows x 32
// points, ldmatrix.x4), B the data-plane tile (32 points x 8 columns,
// each pair of planes by one ldmatrix.x4).  Every (a, b) product
// accumulates straight into the fragment of plane a + b, so no product
// plane is ever materialized: a warp's 16 x 8 tile holds NOUT planes x 4
// accumulator registers (s8 60, u7 76), BG data planes (s8 4 in 8
// registers, two passes over its 8, each reading the matrix planes once;
// u7 all 10 in 20 registers, one pass) and one matrix plane (4) at a
// time.  The matrix planes of a
// row group (NPL planes x RG rows x 32 points) stream from L2 through a
// 3-stage cp.async ring; the wrapper lays the stack out tile by tile when
// the tables are built (ops/ntt_mxu.py::tc_plane_tiles: zero past m,
// swizzled against bank conflicts), so a stage is one contiguous copy for
// every m; the whole matrix is read once per NT columns (1 GiB for a 2^24
// s8 K1 call at NT = 32, 4 GiB at 8-column blocks).  The epilogue runs in registers, per element, on the C fragment's
// rows (lane >> 2, +8) and columns (2 (lane & 3), +1): the recombination
// tail, the inverse twiddle, a masked store (rows >= m and columns >= B
// are not written).  Both formats build under __launch_bounds__(256, 2),
// the 128 registers that let two blocks share an SM where their shared
// memory fits (u7 at m = 256: 16 columns, 104,960 bytes; 32 columns take
// 117,760, one block an SM).
//
// The lane orientation (LANE != 0) changes only the two ends.  A column's
// points are contiguous there, so the prologue reads each (column, point
// quad) as two 16-byte loads, the fused twiddle (in the data's own layout,
// tm = 1) the same way, where the strided form makes four 8-byte loads a
// quad.  Its epilogue comes in two forms (ops/ntt_mxu.py::tc_form picks
// one).  LANE = 1 stores from the C fragment as the strided form does (8
// rows of a column: 64-byte runs).  LANE = 2 stages the row group's
// results in a shared-memory region of its own (rg + 2 words a column, so
// that the fragment's 8-byte stores are free of bank conflicts), then the
// block applies the inverse twiddle and writes whole runs of rg words of
// each column with 16-byte stores, its twiddle read the same way: the
// faster form for the s8 inverse with the pair twiddle (PERF.md section
// 6), the only one for which it is built.  It was slower on the forward,
// no faster for the inverse's other twiddles, and its other s8
// instantiations spilled at the 128-register cap.  u7's pair inverse
// spills there too (2% faster all the same, PERF.md section 6), so u7 has
// no staged form.
//
// Limbs (LIMBS, csrc/ntt_mxu_tc_limbs.cu): a multi-modular call carries L
// limbs, one modulus each, in one launch.  Its A slices are the limbs'
// (slice a is limb a / apl: the lead form's L, the mid form's L * A', the
// lane forms' L, one a limb, at stride sa); the matrix planes are stacked a
// limb's tiles after another (tile_bytes apart), corr a limb's m words after
// another, and the constants a row of the limb table
// (field/limb.py::LIMB_COLUMNS) per limb.  At the top of each slice the
// block copies its limb's constants into shared memory; every use reads
// them there (after the barriers of the loop), where the single-modulus
// instantiations take them as kernel arguments.  The tensor-core tile never
// mixes moduli: a slice is one limb's.  L = 1 keeps the instantiations
// without LIMBS, and their launch geometry.
//
// Exactness without .satfinite: s8, each partial sum of a plane is a sum
// of at most 8m products of two int8 values in [-128, 127], so it is
// bounded like the plane itself, |P| <= 8 * m * 2^14 = m << 17 < 2^28 at
// m = 1024; u7, the 7-bit planes are int8 values in [0, 127], every
// product is non-negative and every partial sum at most the plane's 10 *
// m * 127^2 < 2^27.4.  int32 accumulation never wraps.
//
// Why mma.sync and not wgmma.  The NOUT live planes per output element
// multiply a GEMM's accumulator registers by 15 (u7 19), capping a
// warpgroup's wgmma N near 16, where its advantage is mostly gone.  What
// limits this kernel on the H100 is latency, not the products' issue
// rate: all warps of a block run the prologue, the ring's barrier and the
// epilogue in step, so the tensor cores wait unless another block has
// work (PERF.md section 6: a 16 x 16 warp tile at 254 registers and one
// block an SM ran slower than this 16 x 8 tile at two blocks an SM).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "field.cuh"
#include "mxu_tail.cuh"

namespace {

using mxu::Consts;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WCOLS = 8;                     // columns per warp: one mma n-tile
constexpr int KSTEP = 32;                    // points per mma
constexpr int STAGES = 3;                    // matrix-plane ring depth
constexpr int MAX_SMEM = 232448;             // a block's shared memory on sm_90

// The plane format's constants: NPL matrix planes = data planes, NOUT
// product planes, BG data planes held in registers at once, MIN_BLOCKS the
// blocks an SM its registers are bounded for (2: 128 registers a thread).
// u7 holds all 10 data planes (20 registers) beside its 76 accumulators,
// so a 32-point step reads each matrix plane once, and builds its block
// at a constant 16 or 32 columns (the kernel's NT): so built, its 44
// instantiations fit 128 registers without spills, where holding the data
// planes two at a time, or taking the block's columns as a kernel
// argument, spilled (tools/mxu_u7_variants.py builds and times patched
// copies: the data planes two at a time, one block an SM, the staged lane
// epilogue).
template <bool U7>
struct Tc {
  static constexpr int NPL = mxu::PlaneFormat<U7>::IN;
  static constexpr int NOUT = mxu::PlaneFormat<U7>::OUT;
  static constexpr int BG = U7 ? NPL : 4;
  static constexpr int MIN_BLOCKS = 2;
  static_assert(BG % 2 == 0 && NPL % BG == 0, "data planes are read two by one ldmatrix.x4");
};

// The block's geometry from (m, nt) and the form (0 strided, 1 lane, 2
// lane with the staged epilogue), as ops/ntt_mxu.py::tc_geometry computes
// it: K padded to 32, the data-plane row stride, the column and row warps,
// the rows of a row group, the staged epilogue's words a column, the
// shared memory.
template <bool U7>
struct Geo {
  int kp, rs, cw, rg, n_rg, sw;
  long long smem;
  __host__ __device__ Geo(int m, int nt, int lane) {
    constexpr int NPL = Tc<U7>::NPL;
    kp = (m + KSTEP - 1) / KSTEP * KSTEP;
    rs = kp + 16;
    cw = nt / WCOLS;
    rg = 16 * (WARPS / cw);
    n_rg = (m + rg - 1) / rg;
    sw = rg + 2;
    smem = (long long)NPL * nt * rs + (long long)STAGES * NPL * rg * KSTEP +
           (lane == 2 ? 8LL * nt * sw : 0);
  }
};

// A multi-modular call's limbs (unread without LIMBS): the limb table
// (field/limb.py::LIMB_COLUMNS: N, N^-1 mod 2^64, 2^128 mod N, floor(2^64 /
// N), nsub, barrett, R^2 mod N, 0 a limb), the slices a limb, and one limb's
// bytes of ring tiles.
struct Limbs {
  const unsigned long long *table;
  long long apl;
  long long tile_bytes;
};

// The block's limb and its constants, in shared memory.
struct LimbSlice {
  Consts k;
  long long limb;
};

__device__ __forceinline__ LimbSlice &limb_slice() {
  __shared__ LimbSlice s;
  return s;
}

// Thread 0 copies slice a's limb and its constants in (a barrier follows).
__device__ __forceinline__ void limb_load(const Limbs &lb, long long a) {
  LimbSlice &s = limb_slice();
  const long long limb = a / lb.apl;
  const unsigned long long *c = lb.table + 8 * limb;
  s.k = Consts{c[0], c[1], c[2], c[3], c[1], (int)c[4], (int)c[5]};
  s.limb = limb;
}

// The constants of the call (the kernel's argument) or of the block's limb.
template <bool LIMBS>
__device__ __forceinline__ const Consts &slice_consts(const Consts &k) {
  if constexpr (LIMBS) return limb_slice().k;
  return k;
}

// The matrix planes' tiles and corr of the block's limb.
template <bool LIMBS>
__device__ __forceinline__ const signed char *slice_tiles(const signed char *tiles,
                                                          const Limbs &lb) {
  if constexpr (LIMBS) return tiles + limb_slice().limb * lb.tile_bytes;
  return tiles;
}

template <bool LIMBS>
__device__ __forceinline__ const long long *slice_corr(const long long *corr, int m) {
  if constexpr (LIMBS) return corr + limb_slice().limb * m;
  return corr;
}

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

// v, as a value the compiler cannot see through: what is computed from it
// is computed where it is used, not hoisted out of the loop around it.
template <typename T>
__device__ __forceinline__ void opaque(T &v) {
  asm volatile("" : "+r"(v));
}

// Byte offset of (row r, 16-byte half h) in a 32-byte matrix-plane row:
// rows 4-7 of every 8 swap their halves, so the 8 rows an ldmatrix reads
// fall in 8 different 16-byte bank groups.
__device__ __forceinline__ int a_slot(int r, int h) {
  return r * KSTEP + 16 * (h ^ ((r >> 2) & 1));
}

// Copy ring tile (row_group, ks) of the matrix planes -- stored tile-major,
// swizzled and zero-padded by ops/ntt_mxu.py::tc_plane_tiles, so a tile is
// `bytes` contiguous bytes -- into `dst`, 16 bytes a thread at a time.
__device__ __forceinline__ void load_tile(unsigned char *dst, const signed char *tiles, int bytes,
                                          int ks_n, int row_group, int ks) {
  const signed char *src = tiles + (size_t)(row_group * ks_n + ks) * bytes;
  for (int off = 16 * threadIdx.x; off < bytes; off += 16 * THREADS)
    cp_async16(smem_addr(dst + off), src + off);
}

// Four consecutive words from 16-byte aligned `p`, as two 16-byte loads.
__device__ __forceinline__ void load4(u64 *v, const long long *p) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2 *>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2 *>(p) + 1);
  v[0] = (u64)a.x;
  v[1] = (u64)a.y;
  v[2] = (u64)b.x;
  v[3] = (u64)b.y;
}

// The residue of fragment element i (rows lane >> 2 (+8 for i >= 2),
// columns 2 (lane & 3) (+1 for odd i)).  u7: W holds every element's six
// words, made from its planes before any element's tail runs (u7_words), so
// that the 76 plane registers are dead by the time the tails' temporaries
// are live -- 128 registers without spills.  s8: straight from the planes.
template <bool U7, int NOUT>
__device__ __forceinline__ u64 element(int (&acc)[NOUT][4], u64 (&W)[4][6], int i, u64 cp, int m,
                                       const Consts &k) {
  if constexpr (U7) return mxu::reduce_words<true>(W[i], cp, k);
  int P[NOUT];
#pragma unroll
  for (int t = 0; t < NOUT; ++t) P[t] = acc[t][i];
  return mxu::recombine<false>(P, cp, m, k);
}

template <bool U7, int NOUT>
__device__ __forceinline__ void u7_words(int (&acc)[NOUT][4], u64 (&W)[4][6], int m) {
  if constexpr (U7) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int P[NOUT];
#pragma unroll
      for (int t = 0; t < NOUT; ++t) P[t] = acc[t][i];
      mxu::plane_words<true>(P, m, W[i]);
    }
  }
}

// U7: the plane format (the s8 digit stack, or u7).  TW: 0 none, 1 "pair",
// 2 "w", 3 Solinas.  LANE: 0 the strided (A, m, B) view; 1 the lane layout
// (A = 1, sm = tm = 1, 16-byte aligned), epilogue from the fragment; 2 the
// same with the staged epilogue.  `tiles`: the matrix planes in the
// ring-tile layout of ops/ntt_mxu.py::tc_plane_tiles.  `corr`: s8's, unread
// under u7.  LIMBS: the slices are stacked limbs' (`lb`; `k_arg` unread).
template <bool U7, int NT, int TW, bool INV, bool LAZY, int LANE, bool LIMBS>
__global__ void __launch_bounds__(THREADS, Tc<U7>::MIN_BLOCKS)
    mxu_tc_kernel(const long long *__restrict__ x, long long *__restrict__ out,
                  const signed char *__restrict__ tiles, const long long *__restrict__ corr,
                  const long long *__restrict__ tw_w, const long long *__restrict__ tw_wp,
                  long long A, int m, long long B, long long sa, long long sm, long long sb,
                  long long ta, long long tm, long long tb, int nt_arg, int split, Consts k_arg,
                  Limbs lb) {
  constexpr int NPL = Tc<U7>::NPL, NOUT = Tc<U7>::NOUT, BG = Tc<U7>::BG;
  const Consts &k = slice_consts<LIMBS>(k_arg);
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = NT != 0 ? NT : nt_arg;
  const Geo<U7> g(m, nt, LANE);
  const int ks_n = g.kp / KSTEP;
  const int per = (g.n_rg + split - 1) / split;
  const int rg0 = blockIdx.z * per;
  const int rg1 = min(g.n_rg, rg0 + per);
  if (rg0 >= rg1) return;  // the same for every thread of the block
  const int T = (rg1 - rg0) * ks_n;

  // S[(b * nt + c) * rs + j]: data plane b of column c at point j
  signed char *S = reinterpret_cast<signed char *>(smem);
  unsigned char *ring = smem + (size_t)NPL * nt * g.rs;
  const int stage_bytes = NPL * g.rg * KSTEP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp % g.cw, wr = warp / g.cw;
  const long long c0 = (long long)blockIdx.x * nt;

  // Per-lane ldmatrix addresses.  B: matrices (plane b, points 0-15),
  // (b, 16-31), (b + 1, 0-15), (b + 1, 16-31) -> b0, b1 of planes b and
  // b + 1.  A: (rows 0-7, points 0-15), (rows 8-15,
  // 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31) -> a0..a3.
  const unsigned s_lane =
      smem_addr(S) + (unsigned)(((lane >> 4) * nt + wc * WCOLS + (lane & 7)) * g.rs +
                                16 * ((lane >> 3) & 1));
  const int a_row = wr * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const unsigned a_lane = smem_addr(ring) + (unsigned)a_slot(a_row, lane >> 4);

  for (long long a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the previous slice is done with S and the ring
    if constexpr (LIMBS) {
      if (threadIdx.x == 0) limb_load(lb, a);
      __syncthreads();
    }
    // a lane form's slice offsets (only stacked limbs have more than one)
    const long long xa = LIMBS ? a * sa : 0, twa = LIMBS ? a * ta : 0;
    // the matrix planes do not depend on the data: start the ring first
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < T)
        load_tile(ring + s * stage_bytes, slice_tiles<LIMBS>(tiles, lb), stage_bytes, ks_n,
                  rg0 + s / ks_n, s % ks_n);
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
      // padding: every plane value 0 (s8: offset bytes of 0x80)
      constexpr u64 PAD = U7 ? 0ull : 0x8080808080808080ull;
      u64 v[4];
      if (LANE != 0 && m >= 4) {
        // the quad's 4 points are contiguous, and 4 | m puts all or none of
        // them below m
        if (4 * q < m && col < B) {
          load4(v, x + xa + col * sb + 4 * q);
          if constexpr (TW != 0 && !INV) {
            u64 w[4], wp[4] = {0, 0, 0, 0};
            load4(w, tw_w + twa + col * tb + 4 * q);
            if constexpr (TW == 1) load4(wp, tw_wp + twa + col * tb + 4 * q);
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] = mxu::twiddle_by<TW, LAZY>(v[i], w[i], wp[i], k);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = PAD;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * q + i;
          v[i] = PAD;
          if (j < m && col < B) {
            v[i] = (u64)x[a * sa + j * sm + col * sb];
            if constexpr (TW != 0 && !INV)
              v[i] = mxu::twiddle<TW, LAZY>(v[i], tw_w, tw_wp, a * ta + j * tm + col * tb, k);
          }
        }
      }
      unsigned w[NPL];
      mxu::quad_planes<U7>(v, w);
#pragma unroll
      for (int b = 0; b < NPL; ++b)
        *reinterpret_cast<unsigned *>(S + (size_t)(b * nt + c) * g.rs + 4 * q) = w[b];
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
          load_tile(ring + (nx % STAGES) * stage_bytes, slice_tiles<LIMBS>(tiles, lb),
                    stage_bytes, ks_n, rg0 + nx / ks_n, nx % ks_n);
        cp_commit();
      }
      const int row_group = rg0 + it / ks_n, ks = it % ks_n;
      const int p0 = row_group * g.rg + wr * 16;
      if (p0 < m) {  // a warp whose 16 rows all lie past m has nothing to add
        const unsigned a_base = a_lane + (unsigned)((it % STAGES) * stage_bytes);
        // The planes' strides in the ring and in S.  u7 re-reads them each
        // step, so that the planes' offsets are recomputed there instead of
        // held across the loop in 15 registers that its 76 accumulators
        // leave no room for.
        unsigned a_step = g.rg * KSTEP, b_step = nt * g.rs;
        if constexpr (U7) {
          opaque(a_step);
          opaque(b_step);
        }
#pragma unroll
        for (int b0 = 0; b0 < NPL; b0 += BG) {
          unsigned bf[BG][2];
#pragma unroll
          for (int bb = 0; bb < BG; bb += 2)
            ldsm_x4(U7 ? s_lane + ks * KSTEP + (b0 + bb) * b_step
                       : s_lane + (unsigned)((b0 + bb) * nt * g.rs + ks * KSTEP),
                    &bf[bb][0]);
#pragma unroll
          for (int da = 0; da < NPL; ++da) {
            unsigned af[4];
            ldsm_x4(U7 ? a_base + da * a_step : a_base + (unsigned)(da * g.rg * KSTEP), af);
#pragma unroll
            for (int bb = 0; bb < BG; ++bb) mma_s8(acc[da + b0 + bb], af, bf[bb][0], bf[bb][1]);
          }
        }
      }
      u64 W[4][6];
      // the fragment's coordinates; u7 computes what follows from them in
      // the epilogue (opaque), not before the loop
      std::conditional_t<U7, unsigned, int> ln = lane;
      if constexpr (U7) opaque(ln);
      if (ks == ks_n - 1 && LANE == 2) {
        // Staged epilogue of the row group: the results into the stage,
        // st[column * sw + row], then whole runs of each column out.
        u64 *st = reinterpret_cast<u64 *>(ring + STAGES * stage_bytes);
        u7_words<U7>(acc, W, m);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wr * 16 + (ln >> 2) + 8 * hr, p = p0 + (ln >> 2) + 8 * hr;
          if (p < m) {
            const u64 cp = U7 ? 0ull : (u64)slice_corr<LIMBS>(corr, m)[p];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = wc * WCOLS + 2 * (ln & 3) + e;
              if (c0 + c < B) st[c * g.sw + r] = element<U7>(acc, W, 2 * hr + e, cp, m, k);
            }
          }
        }
        __syncthreads();
        const int pairs = g.rg / 2, rg0p = row_group * g.rg;
        for (int i = threadIdx.x; i < nt * pairs; i += THREADS) {
          const int c = i / pairs, r = 2 * (i % pairs), p = rg0p + r;
          const long long col = c0 + c;
          if (p < m && col < B) {  // m is even: p + 1 < m too
            const ulonglong2 s = *reinterpret_cast<const ulonglong2 *>(st + c * g.sw + r);
            u64 v0 = s.x, v1 = s.y;
            if constexpr (TW != 0 && INV) {
              const longlong2 w =
                  __ldg(reinterpret_cast<const longlong2 *>(tw_w + twa + col * tb + p));
              longlong2 wp = make_longlong2(0, 0);
              if constexpr (TW == 1)
                wp = __ldg(reinterpret_cast<const longlong2 *>(tw_wp + twa + col * tb + p));
              v0 = mxu::twiddle_by<TW, LAZY>(v0, (u64)w.x, (u64)wp.x, k);
              v1 = mxu::twiddle_by<TW, LAZY>(v1, (u64)w.y, (u64)wp.y, k);
            }
            *reinterpret_cast<longlong2 *>(out + xa + col * sb + p) =
                make_longlong2((long long)v0, (long long)v1);
          }
        }
#pragma unroll
        for (int t = 0; t < NOUT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0;
      } else if (ks == ks_n - 1) {
        // Epilogue of the row group: lane holds rows p0 + (lane >> 2) (+8)
        // and columns 2 (lane & 3) (+1).
        u7_words<U7>(acc, W, m);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int p = p0 + (ln >> 2) + 8 * hr;
          if (p < m) {
            const u64 cp = U7 ? 0ull : (u64)slice_corr<LIMBS>(corr, m)[p];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const long long col = c0 + wc * WCOLS + 2 * (ln & 3) + e;
              if (col < B) {
                u64 r = element<U7>(acc, W, 2 * hr + e, cp, m, k);
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
  Limbs lb;
};

template <bool U7, int NT, int TW, bool INV, bool LAZY, int LANE, bool LIMBS>
cudaError_t launch(const Args &g) {
  auto kern = mxu_tc_kernel<U7, NT, TW, INV, LAZY, LANE, LIMBS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)g.smem);
  if (e != cudaSuccess) return e;
  kern<<<g.grid, THREADS, g.smem, g.stream>>>(g.x, g.out, g.tiles, g.corr, g.tw_w, g.tw_wp,
                                              g.A, g.m, g.B, g.sa, g.sm, g.sb, g.ta, g.tm, g.tb,
                                              g.nt, g.split, g.k, g.lb);
  return cudaGetLastError();
}

// The instantiation of one form for the twiddle mode, direction and lazy
// flag; the staged lane epilogue (LANE = 2) is built for the inverse with
// the pair twiddle only (with LIMBS not lazy: that one spilled 16 bytes),
// Solinas (tw_mode 3) without LIMBS only.
template <bool U7, int NT, int LANE, bool LIMBS>
cudaError_t dispatch(const Args &g, int tw_mode, int inverse, int lazy) {
  if constexpr (LANE == 2) {
    if (tw_mode != 1 || !inverse) return cudaErrorInvalidValue;
    if constexpr (LIMBS) {  // its lazy instantiation spilled
      return lazy ? cudaErrorInvalidValue : launch<U7, NT, 1, true, false, 2, true>(g);
    } else {
      return lazy ? launch<U7, NT, 1, true, true, 2, false>(g)
          : launch<U7, NT, 1, true, false, 2, false>(g);
    }
  } else {
    if (tw_mode == 0) return launch<U7, NT, 0, false, false, LANE, LIMBS>(g);
    if (tw_mode == 1) {
      if (inverse)
        return lazy ? launch<U7, NT, 1, true, true, LANE, LIMBS>(g)
            : launch<U7, NT, 1, true, false, LANE, LIMBS>(g);
      return lazy ? launch<U7, NT, 1, false, true, LANE, LIMBS>(g)
          : launch<U7, NT, 1, false, false, LANE, LIMBS>(g);
    }
    if (tw_mode == 2) {
      if (inverse)
        return lazy ? launch<U7, NT, 2, true, true, LANE, LIMBS>(g)
            : launch<U7, NT, 2, true, false, LANE, LIMBS>(g);
      return lazy ? launch<U7, NT, 2, false, true, LANE, LIMBS>(g)
          : launch<U7, NT, 2, false, false, LANE, LIMBS>(g);
    }
    if constexpr (!LIMBS) {
      if (tw_mode == 3 && !lazy)  // Solinas: canonical only, no companion
        return inverse ? launch<U7, NT, 3, true, false, LANE, false>(g)
            : launch<U7, NT, 3, false, false, LANE, false>(g);
    }
    return cudaErrorInvalidValue;
  }
}

// The instantiations of one form: s8 for any nt (NT = 0, the block's
// columns a kernel argument), u7 for the two blocks it builds, NT = 16 or
// 32 (a constant row group; see Tc).  LIMBS: s8 alone.
template <bool U7, int LANE, bool LIMBS = false>
cudaError_t dispatch_nt(const Args &g, int tw_mode, int inverse, int lazy) {
  if constexpr (!U7) {
    return dispatch<false, 0, LANE, LIMBS>(g, tw_mode, inverse, lazy);
  } else {
    static_assert(!LIMBS, "the limb instantiations are s8's");
    if (g.nt == 16) return dispatch<true, 16, LANE, false>(g, tw_mode, inverse, lazy);
    if (g.nt == 32) return dispatch<true, 32, LANE, false>(g, tw_mode, inverse, lazy);
    return cudaErrorInvalidValue;
  }
}

// The C entries' body (csrc/ntt_mxu_tc.cu, csrc/ntt_mxu_tc_u7.cu and, with
// LIMBS, csrc/ntt_mxu_tc_limbs.cu): check the call against the geometry it
// must have, then launch.  STAGED: the format builds the staged lane
// epilogue (lane = 2, the inverse with the pair twiddle only).  LIMBS: `lb`
// holds the limbs (a lane form's A slices are the limbs, one each, at an
// even stride sa); `k` is unread.
template <bool U7, bool STAGED, bool LIMBS = false>
int entry(const void *x, void *out, const void *tiles, const void *corr, const void *tw_w,
          const void *tw_wp, long long A, int m, long long B, long long sa, long long sm,
          long long sb, long long ta, long long tm, long long tb, int tw_mode, int inverse,
          int lazy, const Consts &k, const Limbs &lb, int lane, int nt, int split,
          long long smem, void *stream) {
  if (A <= 0 || B <= 0 || m < 2 || m > 1024 || (!U7 && corr == nullptr) ||
      (tw_mode != 0 && tw_w == nullptr) || (tw_mode == 1) != (tw_wp != nullptr))
    return (int)cudaErrorInvalidValue;
  if (nt < WCOLS || nt % WCOLS != 0 || WARPS % (nt / WCOLS) != 0 || split < 1 ||
      split > 65535 || lane < 0 || lane > (STAGED ? 2 : 1))
    return (int)cudaErrorInvalidValue;
  const Geo<U7> geo(m, nt, lane);
  if (LIMBS && (lb.table == nullptr || lb.apl < 1 || A % lb.apl != 0 ||
                lb.tile_bytes != (long long)Tc<U7>::NPL * geo.n_rg * geo.rg * geo.kp))
    return (int)cudaErrorInvalidValue;
  if (lane != 0) {
    const uintptr_t bits = (uintptr_t)x | (uintptr_t)out | (uintptr_t)tw_w | (uintptr_t)tw_wp;
    const bool slices = LIMBS ? lb.apl == 1 && sa % 2 == 0 && ta % 2 == 0 : A == 1;
    if (!slices || sm != 1 || sb != m || (tw_mode != 0 && (tm != 1 || tb != m)) || (bits & 15))
      return (int)cudaErrorInvalidValue;
  }
  if (smem != geo.smem || smem > MAX_SMEM || split > geo.n_rg) return (int)cudaErrorInvalidValue;
  const long long gy = A < 65535 ? A : 65535;
  const Args g{dim3((unsigned)((B + nt - 1) / nt), (unsigned)gy, (unsigned)split),
               (size_t)smem,
               (cudaStream_t)stream,
               (const long long *)x, (long long *)out, (const signed char *)tiles,
               (const long long *)corr, (const long long *)tw_w, (const long long *)tw_wp,
               A, m, B, sa, sm, sb, ta, tm, tb, nt, split, k, lb};
  if (lane == 1) return (int)dispatch_nt<U7, 1, LIMBS>(g, tw_mode, inverse, lazy);
  if constexpr (STAGED) {
    if (lane == 2) return (int)dispatch_nt<U7, 2, LIMBS>(g, tw_mode, inverse, lazy);
  }
  return (int)dispatch_nt<U7, 0, LIMBS>(g, tw_mode, inverse, lazy);
}

}  // namespace

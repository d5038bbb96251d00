// The matrix NTT's per-point arithmetic around the products, shared by the
// __dp4a kernel (csrc/ntt_mxu.cu) and the int8 tensor-core kernel
// (csrc/mxu_tc.cuh): the plane formats, the split of a data word into its
// planes (one word, or a point quad at once), the recombination of the product planes into a canonical
// residue (_mxu_plain's tail in sventt_tpu_torch/ops/ntt_mxu.py), and the
// fused inter-step twiddle multiply.  Both kernels run this code as it is,
// so their outputs agree with the plain version bit for bit whatever
// route computed the (exact) planes.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace mxu {

// The plane format: s8 and s8b take 8 signed digit / offset-byte planes and
// give 15 planes at bit 8t; u7 takes 10 unsigned 7-bit planes and gives 19
// at bit 7t.
template <bool U7>
struct PlaneFormat {
  static constexpr int IN = U7 ? 10 : 8;   // data planes = matrix planes
  static constexpr int OUT = 2 * IN - 1;   // product planes
  static constexpr int STEP = U7 ? 7 : 8;  // bits between product planes
};

struct Consts {
  u64 N, nprime, c128, mu, ninv;
  int nsub, barrett;
};

// Plane i of a data word: s8 the offset byte (byte ^ 0x80 as int8 == byte -
// 128), u7 the unsigned 7-bit field at bit 7i (i = 9 holds bit 63 alone).
template <bool U7>
__device__ __forceinline__ signed char data_plane(u64 v, int i) {
  if (U7) return (signed char)((v >> (7 * i)) & 0x7F);
  return (signed char)(((v >> (8 * i)) & 0xFF) ^ 0x80);
}

// The data planes of a point quad, four words at once, for the tensor-core
// kernel: w[i] holds plane i of v[0..3] in its bytes 0..3.  s8: a 4 x 8
// byte transpose, then each byte offset by -128 (^ 0x80).  u7: each word's
// 7-bit fields 0-7 (bits 0-55) spread into its 8 bytes by three masked
// shifts (28-bit halves into 32-bit lanes, 14-bit quarters into 16-bit
// lanes, 7-bit fields into bytes), transposed the same way; fields 8 (bits
// 56-62) and 9 (bit 63 alone) as a third half.
__device__ __forceinline__ void quad_transpose(const unsigned *h, unsigned *w) {
  const unsigned t01 = __byte_perm(h[0], h[1], 0x5140), u01 = __byte_perm(h[0], h[1], 0x7362);
  const unsigned t23 = __byte_perm(h[2], h[3], 0x5140), u23 = __byte_perm(h[2], h[3], 0x7362);
  w[0] = __byte_perm(t01, t23, 0x5410);
  w[1] = __byte_perm(t01, t23, 0x7632);
  w[2] = __byte_perm(u01, u23, 0x5410);
  w[3] = __byte_perm(u01, u23, 0x7632);
}

template <bool U7>
__device__ __forceinline__ void quad_planes(const u64 *v, unsigned *w) {
  unsigned lo[4], hi[4], top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u64 s = v[i];
    if constexpr (U7) {
      s &= 0x00FFFFFFFFFFFFFFull;
      s = (s & 0x000000000FFFFFFFull) | ((s & 0x00FFFFFFF0000000ull) << 4);
      s = (s & 0x00003FFF00003FFFull) | ((s & 0x0FFFC0000FFFC000ull) << 2);
      s = (s & 0x007F007F007F007Full) | ((s & 0x3F803F803F803F80ull) << 1);
      top[i] = (unsigned)((v[i] >> 56) & 0x7F) | (unsigned)(v[i] >> 63) << 8;
    }
    lo[i] = (unsigned)s;
    hi[i] = (unsigned)(s >> 32);
  }
  quad_transpose(lo, w);
  quad_transpose(hi, w + 4);
  if constexpr (U7) {
    unsigned t[4];
    quad_transpose(top, t);  // planes 8 and 9; bytes 2 and 3 of top are 0
    w[8] = t[0];
    w[9] = t[1];
  } else {
#pragma unroll
    for (int b = 0; b < 8; ++b) w[b] ^= 0x80808080u;
  }
}

// The product planes -> the six 32-bit words of their 192-bit sum, each
// held in a u64 with its carries (the first half of _mxu_plain's tail).
template <bool U7>
__device__ __forceinline__ void plane_words(const int *P, int m, u64 *w) {
  using PL = PlaneFormat<U7>;
  const int bias = U7 ? 0 : m << 17;  // == make_mxu_tables'
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = 0;
#pragma unroll
  for (int t = 0; t < PL::OUT; ++t) {
    // s8: a biased plane lies in [0, 2^28], so it is exact as a u32; times
    // 2^(<= 24) it is < 2^52, and at most 4 land in a word: < 2^54.  u7: a
    // plane is unsigned and at most 10 * m * 127^2 < 2^27.4 at m = 1024,
    // times 2^(<= 31) < 2^58.4, and at most 5 (bits 7t in a 32-bit window)
    // land in a word: < 2^61.  One 32 x 32 + 64 multiply-add a plane.
    const unsigned v = U7 ? (unsigned)P[t] : (unsigned)(P[t] + bias);
    u64 &acc = w[(PL::STEP * t) >> 5];
    asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc) : "r"(v), "r"(1u << ((PL::STEP * t) & 31)));
  }
}

// Those words (+ corr, s8's) -> canonical residue: carries, fold, Barrett
// or subtracts, Montgomery REDC (the second half).
template <bool U7>
__device__ __forceinline__ u64 reduce_words(u64 *w, u64 corr, const Consts &k) {
  if (!U7) {
    w[0] += corr & 0xFFFFFFFFull;
    w[1] += corr >> 32;
  }
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

// The product planes (+ corr) -> canonical residue (_mxu_plain's tail).
template <bool U7>
__device__ __forceinline__ u64 recombine(const int *P, u64 corr, int m,
                                         const Consts &k) {
  u64 w[6];
  plane_words<U7>(P, m, w);
  return reduce_words<U7>(w, corr, k);
}

// The inter-step twiddle multiply of v by the twiddle w (wp its companion,
// read by "pair" alone).  TW: 1 "pair" (mont_mul with the companion), 2
// "w" (mont_mul_full), 3 Solinas "w" (solinas_mul).
template <int TW, bool LAZY>
__device__ __forceinline__ u64 twiddle_by(u64 v, u64 w, u64 wp, const Consts &k) {
  if (TW == 3) return solinas_mul(v, w, k.N);
  if (TW == 1) return mont_mul(v, w, wp, k.N, LAZY);
  return mont_mul_full(v, w, k.N, k.ninv, LAZY);
}

// The same by entry ti of the twiddle table.
template <int TW, bool LAZY>
__device__ __forceinline__ u64 twiddle(u64 v, const long long *tw_w,
                                       const long long *tw_wp, long long ti,
                                       const Consts &k) {
  return twiddle_by<TW, LAZY>(v, (u64)tw_w[ti], TW == 1 ? (u64)tw_wp[ti] : 0ull, k);
}

}  // namespace mxu

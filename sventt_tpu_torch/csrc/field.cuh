// u64 prime-field device functions: the CUDA counterpart of
// sventt_tpu_torch/field/limb.py (and of sventt_tpu/field/limb.py, whose
// (hi, lo) u32 limb chains Hopper replaces with native 64-bit words and
// __umul64hi).  Every function gives the bit-identical result of its
// Python counterpart.
#pragma once

#include <cstdint>

typedef unsigned long long u64;

// a + b with the carry-out bit in `carry` (0 or 1).
__device__ __forceinline__ u64 add_carry(u64 a, u64 b, u64 &carry) {
  u64 s = a + b;
  carry = s < a;
  return s;
}

// ab1 - hi64(q*N): +N always when lazy ((0, 2N) result), else +N on borrow
// (canonical [0, N)) -- FieldConsts._redc_finish.
__device__ __forceinline__ u64 redc_finish(u64 ab1, u64 q, u64 N, bool lazy) {
  u64 qn1 = __umul64hi(q, N);
  u64 d = ab1 - qn1;
  if (lazy) return d + N;
  return ab1 < qn1 ? d + N : d;
}

// Montgomery multiply with a precomputed companion wp = w * N^-1 mod 2^64.
__device__ __forceinline__ u64 mont_mul(u64 a, u64 w, u64 wp, u64 N, bool lazy) {
  return redc_finish(__umul64hi(a, w), a * wp, N, lazy);
}

// Montgomery multiply computing the companion in flight (ninv = N^-1 mod 2^64).
__device__ __forceinline__ u64 mont_mul_full(u64 a, u64 b, u64 N, u64 ninv,
                                             bool lazy) {
  return redc_finish(__umul64hi(a, b), (a * b) * ninv, N, lazy);
}

// [0, 2N) -> [0, N) (identity for canonical values).
__device__ __forceinline__ u64 normalize(u64 a, u64 N) {
  return a < N ? a : a - N;
}

__device__ __forceinline__ u64 u64_min(u64 a, u64 b) { return a < b ? a : b; }

// a + b in range: lazy [0, 2N) by the min-trick (4N < 2^64), canonical
// [0, N) with a carry-aware wrap -- FieldConsts.add.
__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 N, bool lazy) {
  if (lazy) {
    const u64 s = a + b;
    return u64_min(s, s - 2 * N);
  }
  u64 carry;
  const u64 s = add_carry(a, b, carry);
  return (carry || s >= N) ? s - N : s;
}

// a - b in range: lazy a - b + 2N then the min-trick, canonical +N on
// borrow -- FieldConsts.sub.
__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 N, bool lazy) {
  if (lazy) {
    const u64 d = a - b + 2 * N;
    return u64_min(d, d - 2 * N);
  }
  const u64 d = a - b;
  return a < b ? d + N : d;
}

// Shoup multiply a*w - hi64(a*wp)*N in [0, 2N), w plain, wp =
// floor(w * 2^64 / N); canonical mode subtracts N once more --
// FieldConsts.shoup_mul.
__device__ __forceinline__ u64 shoup_mul(u64 a, u64 w, u64 wp, u64 N, bool lazy) {
  const u64 c = a * w - __umul64hi(a, wp) * N;
  return lazy ? c : u64_min(c, c - N);
}

// Solinas multiply a*w mod N, canonical [0, N), for a plain w, any a, and
// a sparse-high N = 2^64 - eps, eps = c*2^s - 1 of at most 42 bits
// (flagship: c = 1827, s = 31; Goldilocks: c = 1, s = 32) --
// FieldConsts.solinas_mul.  2^64 === eps (mod N) folds the high word of
// the 128-bit product: after fold 1 it is <= 2^42, after fold 2 <= 2^20,
// so fold 3's hi*eps < 2^62 fits one word, and its carry out, one more
// 2^64 === eps, adds without a new carry (the wrapped sum is < 2^62).
// Every fold is exact, so this is the bit-identical canonical result of
// the JAX package's limb chain whatever s is.  No companion: eps = -N.
// Each product is formed from 32 x 32 products at the widths its operands
// have (a * w 2 x 2 words, fold 1 2 x 2, fold 2 2 x 2 with a 32-bit top
// product since both high words are < 2^11, fold 3 1 x 2) in PTX: written
// in C the same arithmetic made the compiler take minutes on a kernel with
// a few dozen of them inlined, and ran slower.  tools/solinas_fold.py holds
// it to the full-word form (64-bit products in every fold) bitwise and
// counts both (12 against 16 32-bit multiplies a call in the SASS).
__device__ __forceinline__ u64 solinas_mul(u64 a, u64 w, u64 N) {
  u64 r;
  asm("{\n\t"
      ".reg .u32 a0, a1, w0, w1, e0, e1, h0, h1, t32;\n\t"
      ".reg .u64 eps, p, t, u, lo, hi, q, c, z;\n\t"
      ".reg .pred pc;\n\t"
      "mov.u64 z, 0;\n\t"
      "sub.u64 eps, z, %3;\n\t"
      "mov.b64 {e0, e1}, eps;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {w0, w1}, %2;\n\t"
      // a * w = hi:lo
      "mul.wide.u32 p, a0, w0;\n\t"
      "shr.u64 q, p, 32;\n\t"
      "mad.wide.u32 t, a1, w0, q;\n\t"
      "and.b64 q, t, 4294967295;\n\t"
      "mad.wide.u32 u, a0, w1, q;\n\t"
      "shl.b64 lo, u, 32;\n\t"
      "and.b64 q, p, 4294967295;\n\t"
      "or.b64 lo, lo, q;\n\t"
      "shr.u64 q, t, 32;\n\t"
      "mad.wide.u32 hi, a1, w1, q;\n\t"
      "shr.u64 q, u, 32;\n\t"
      "add.u64 hi, hi, q;\n\t"
      // fold 1: hi:lo = hi * eps + lo, hi of 64 bits
      "mov.b64 {h0, h1}, hi;\n\t"
      "mul.wide.u32 p, h0, e0;\n\t"
      "shr.u64 q, p, 32;\n\t"
      "mad.wide.u32 t, h1, e0, q;\n\t"
      "and.b64 q, t, 4294967295;\n\t"
      "mad.wide.u32 u, h0, e1, q;\n\t"
      "shl.b64 c, u, 32;\n\t"
      "and.b64 q, p, 4294967295;\n\t"
      "or.b64 c, c, q;\n\t"
      "shr.u64 q, t, 32;\n\t"
      "mad.wide.u32 hi, h1, e1, q;\n\t"
      "shr.u64 q, u, 32;\n\t"
      "add.u64 hi, hi, q;\n\t"
      "add.cc.u64 lo, lo, c;\n\t"
      "addc.u64 hi, hi, z;\n\t"
      // fold 2: hi <= 2^42
      "mov.b64 {h0, h1}, hi;\n\t"
      "mul.wide.u32 p, h0, e0;\n\t"
      "shr.u64 q, p, 32;\n\t"
      "mad.wide.u32 t, h0, e1, q;\n\t"
      "mad.wide.u32 t, h1, e0, t;\n\t"
      "shl.b64 c, t, 32;\n\t"
      "and.b64 q, p, 4294967295;\n\t"
      "or.b64 c, c, q;\n\t"
      "mul.lo.u32 t32, h1, e1;\n\t"
      "cvt.u64.u32 hi, t32;\n\t"
      "shr.u64 q, t, 32;\n\t"
      "add.u64 hi, hi, q;\n\t"
      "add.cc.u64 lo, lo, c;\n\t"
      "addc.u64 hi, hi, z;\n\t"
      // fold 3: hi <= 2^20, hi * eps < 2^62 in one word
      "cvt.u32.u64 h0, hi;\n\t"
      "mul.lo.u32 t32, h0, e1;\n\t"
      "cvt.u64.u32 q, t32;\n\t"
      "shl.b64 q, q, 32;\n\t"
      "mad.wide.u32 q, h0, e0, q;\n\t"
      "add.cc.u64 lo, lo, q;\n\t"
      // its carry out adds eps; then the min-subtract
      "addc.u64 c, z, z;\n\t"
      "setp.ne.u64 pc, c, 0;\n\t"
      "selp.u64 q, eps, z, pc;\n\t"
      "add.u64 lo, lo, q;\n\t"
      "sub.u64 q, lo, %3;\n\t"
      "min.u64 %0, lo, q;\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(w), "l"(N));
  return r;
}

// Stage-twiddle multiply by the configured engine (MM 0 Montgomery, 1
// Shoup, 2 Solinas: wp unread, never lazy) -- FieldConsts.twiddle_mul.
template <int MM>
__device__ __forceinline__ u64 twiddle_mul(u64 a, u64 w, u64 wp, u64 N, bool lazy) {
  if constexpr (MM == 2) return solinas_mul(a, w, N);
  if constexpr (MM == 1) return shoup_mul(a, w, wp, N, lazy);
  return mont_mul(a, w, wp, N, lazy);
}

// The six-step inter-step multiply of v by twiddle i by the engine `mode`:
// 1 Montgomery with the companion table wp ("pair"), 2 Montgomery
// computing it in flight ("w"), 3 Solinas on plain twiddles ("w", wp
// unread) -- ops/twiddle.py::inter_step_mul.
__device__ __forceinline__ u64 inter_step_mul(u64 v, const long long *w,
                                              const long long *wp, long long i, int mode,
                                              u64 N, u64 ninv, bool lazy) {
  if (mode == 3) return solinas_mul(v, (u64)w[i], N);
  if (mode == 1) return mont_mul(v, (u64)w[i], (u64)wp[i], N, lazy);
  return mont_mul_full(v, (u64)w[i], N, ninv, lazy);
}
